"""Block-sparse RTM support: the tile-occupancy index.

A copy of ``sartsolver_tpu/ops/sparse.py`` (host-only numpy; the port
imports nothing of the JAX package), with the same digests: on the same
fp32 matrix the index built here and the JAX package's have the same CRC32.

Tomography operators are highly compressible once small entries are
thresholded (arxiv 2003.12677, arxiv 1705.07497): a reflection-free RTM
couples each pixel only to the voxels its ray traverses, so whole
(pixel-block x voxel-panel) tiles of the matrix are exactly zero. This
module builds and carries the *index* of that structure:

- :class:`TileMaxStats` — a chunked accumulator the chunked ingest feeds
  (``parallel/multihost.py``, which takes each chunk's tile maxima on the
  card and folds them in with :meth:`TileMaxStats.add_grid`), recording
  the per-tile max |H| in a small ``[n_row_tiles, n_col_tiles]`` fp32
  grid. Max-accumulation is idempotent, so a chunk fed twice changes
  nothing.
- :class:`TileOccupancy` — the frozen, hashable index itself: a packed
  bitmask over the tile grid plus the threshold it was cut at
  (``|H_ij| <= eps * max|H|`` dropped; ``eps=0`` keeps every tile with
  any nonzero entry, so the default is lossless), CRC32-digested so a
  corrupted or stale index fails loudly instead of silently skipping
  live tiles.

The solver consumes the index in ``models/sart.py``: the card keeps only
the occupied tile columns of the matrix (:meth:`TileOccupancy.occupied_columns`)
and the sweep runs over those.

Tile geometry is the JAX package's fp32 register tile (8 sublanes x 128
lanes), so the two packages' indexes of one matrix are bit for bit the
same.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import numpy as np

# Default tile geometry: the fp32 register tile. Rows = sublane count,
# cols = lane count — the sweeps' alignment constraints (pixels % 8,
# voxels % 128) guarantee whole tiles on every eligible shape.
TILE_ROWS = 8
TILE_COLS = 128


def _grid_shape(rows: int, cols: int, tile_rows: int, tile_cols: int):
    return (-(-rows // tile_rows), -(-cols // tile_cols))


def _digest(rows, cols, tile_rows, tile_cols, threshold, packed: bytes) -> int:
    header = (
        f"{rows}:{cols}:{tile_rows}:{tile_cols}:"
        f"{float(threshold).hex()}:".encode()
    )
    return zlib.crc32(packed, zlib.crc32(header)) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True, eq=False)
class TileOccupancy:
    """Per-(pixel-block x voxel-panel) occupancy index of one stored RTM.

    ``packed`` is ``np.packbits`` of the row-major boolean tile grid;
    ``threshold`` is the ABSOLUTE |H| cut the index was built at
    (``epsilon * max|H|`` of the stored representation; 0.0 = exact-zero
    tiles only); ``digest`` is the CRC32 of header+bits — computed at
    build time and re-checked by :meth:`verify`, so the index that rides
    a journal/artifact covers the packed representation end to end.

    Hashable and value-comparable: solver cores take it as a jit-static
    argument, so one RTM's index produces exactly one compiled program.
    """

    rows: int
    cols: int
    tile_rows: int
    tile_cols: int
    packed: bytes
    threshold: float
    epsilon: float
    digest: int

    # -- identity (static-argument contract) ------------------------------

    def _key(self):
        return (self.rows, self.cols, self.tile_rows, self.tile_cols,
                self.packed, float(self.threshold), float(self.epsilon),
                self.digest)

    def __hash__(self) -> int:
        return hash(self._key())

    def __eq__(self, other) -> bool:
        return isinstance(other, TileOccupancy) and self._key() == other._key()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_mask(cls, mask: np.ndarray, *, rows: int, cols: int,
                  tile_rows: int = TILE_ROWS, tile_cols: int = TILE_COLS,
                  threshold: float = 0.0,
                  epsilon: float = 0.0) -> "TileOccupancy":
        mask = np.asarray(mask, bool)
        if mask.shape != _grid_shape(rows, cols, tile_rows, tile_cols):
            raise ValueError(
                f"occupancy mask shape {mask.shape} does not tile a "
                f"[{rows}, {cols}] matrix at {tile_rows}x{tile_cols} "
                f"(expected {_grid_shape(rows, cols, tile_rows, tile_cols)})."
            )
        packed = np.packbits(mask.ravel()).tobytes()
        return cls(
            rows=int(rows), cols=int(cols), tile_rows=int(tile_rows),
            tile_cols=int(tile_cols), packed=packed,
            threshold=float(threshold), epsilon=float(epsilon),
            digest=_digest(rows, cols, tile_rows, tile_cols, threshold,
                           packed),
        )

    # -- queries -----------------------------------------------------------

    @property
    def grid_shape(self) -> Tuple[int, int]:
        return _grid_shape(self.rows, self.cols, self.tile_rows,
                           self.tile_cols)

    @property
    def mask(self) -> np.ndarray:
        """The boolean ``[n_row_tiles, n_col_tiles]`` tile grid."""
        n_tr, n_tc = self.grid_shape
        bits = np.unpackbits(
            np.frombuffer(self.packed, np.uint8), count=n_tr * n_tc
        )
        return bits.astype(bool).reshape(n_tr, n_tc)

    def occupancy_fraction(self) -> float:
        """Fraction of tiles carrying data (1.0 = fully dense)."""
        return float(self.mask.mean()) if self.mask.size else 1.0

    def col_panel_occupied(self, panel_voxels: int) -> np.ndarray:
        """Boolean ``[n_panels]``: voxel panel ``j`` (columns
        ``[j*panel_voxels, (j+1)*panel_voxels)``) holds any occupied tile
        in ANY pixel-block row. This is the skip predicate of the panel
        sweeps — column-global, so it is SPMD-uniform across pixel
        shards (every shard of a row-sharded mesh skips the same
        panels)."""
        if panel_voxels % self.tile_cols:
            raise ValueError(
                f"panel width {panel_voxels} is not a multiple of the "
                f"tile width {self.tile_cols}."
            )
        if self.cols % panel_voxels:
            raise ValueError(
                f"panel width {panel_voxels} does not divide the indexed "
                f"voxel extent {self.cols}."
            )
        per_panel = panel_voxels // self.tile_cols
        col_any = self.mask.any(axis=0)
        return col_any.reshape(-1, per_panel).any(axis=1)

    def occupied_columns(self, nvoxel: int) -> np.ndarray:
        """The ascending voxel columns of ``[0, nvoxel)`` whose tile column
        holds any occupied tile: whole tile columns, the last one cut at
        ``nvoxel`` (the index may cover the 128-padded extent). int64."""
        col_any = self.mask.any(axis=0)
        tiles = np.flatnonzero(col_any).astype(np.int64)
        cols = (tiles[:, None] * self.tile_cols
                + np.arange(self.tile_cols, dtype=np.int64)[None, :]).ravel()
        return cols[cols < nvoxel]

    def verify(self) -> None:
        """Re-derive the CRC32 over the packed bits; raise on mismatch
        (a corrupted/hand-edited index must never silently skip live
        tiles)."""
        want = _digest(self.rows, self.cols, self.tile_rows,
                       self.tile_cols, self.threshold, self.packed)
        if want != self.digest:
            raise ValueError(
                f"tile-occupancy digest mismatch: stored {self.digest:#010x}"
                f" vs recomputed {want:#010x} — the index does not cover "
                "this packed representation."
            )

    # -- round-trip (docs/FORMATS.md §occupancy-index) ---------------------

    def to_payload(self) -> dict:
        """JSON-serializable record (journal/artifact round-trip)."""
        return {
            "rows": self.rows, "cols": self.cols,
            "tile_rows": self.tile_rows, "tile_cols": self.tile_cols,
            "threshold": self.threshold, "epsilon": self.epsilon,
            "packed_hex": self.packed.hex(), "digest": self.digest,
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "TileOccupancy":
        occ = cls(
            rows=int(payload["rows"]), cols=int(payload["cols"]),
            tile_rows=int(payload["tile_rows"]),
            tile_cols=int(payload["tile_cols"]),
            packed=bytes.fromhex(payload["packed_hex"]),
            threshold=float(payload["threshold"]),
            epsilon=float(payload["epsilon"]),
            digest=int(payload["digest"]),
        )
        occ.verify()
        return occ


class TileMaxStats:
    """Chunked per-tile max-|H| accumulator for the striped ingest.

    Fed every logical device-block piece of the chunked RTM read
    (``parallel/multihost.read_and_shard_rtm``) in the storage-rounded
    representation the device will hold — the same values the integrity
    layer's ``IngestStats`` accumulates, so the index covers the PACKED
    matrix, not the pre-quantization floats. Pieces may arrive at any
    offset/shape and may repeat (double-read verification, two-pass int8
    ingest): max is idempotent and order-free.
    """

    def __init__(self, rows: int, cols: int, *,
                 tile_rows: int = TILE_ROWS, tile_cols: int = TILE_COLS):
        self.rows, self.cols = int(rows), int(cols)
        self.tile_rows, self.tile_cols = int(tile_rows), int(tile_cols)
        self.tile_max = np.zeros(
            _grid_shape(rows, cols, tile_rows, tile_cols), np.float32
        )

    def add(self, block, row_offset: int, col_offset: int) -> None:
        """Fold one ``block`` at ``(row_offset, col_offset)`` into the
        per-tile maxima. Offsets need not be tile-aligned."""
        a = np.abs(np.asarray(block, np.float32))
        if a.ndim != 2 or a.size == 0:
            return
        tr, tc = self.tile_rows, self.tile_cols
        pre_r, pre_c = row_offset % tr, col_offset % tc
        post_r = (-(pre_r + a.shape[0])) % tr
        post_c = (-(pre_c + a.shape[1])) % tc
        a = np.pad(a, ((pre_r, post_r), (pre_c, post_c)))
        grid = a.reshape(
            a.shape[0] // tr, tr, a.shape[1] // tc, tc
        ).max(axis=(1, 3))
        r0 = (row_offset - pre_r) // tr
        c0 = (col_offset - pre_c) // tc
        view = self.tile_max[r0:r0 + grid.shape[0], c0:c0 + grid.shape[1]]
        np.maximum(view, grid[: view.shape[0], : view.shape[1]], out=view)

    def add_grid(self, grid, tile_row0: int) -> None:
        """Fold per-tile maxima already taken (``grid`` ``[k, n_col_tiles]``,
        tile rows ``tile_row0 ..``) into the accumulator: the chunked
        ingest's path, which reduces each chunk to its tiles on the card."""
        grid = np.asarray(grid, np.float32)
        view = self.tile_max[tile_row0:tile_row0 + grid.shape[0]]
        np.maximum(view, grid[: view.shape[0]], out=view)

    def occupancy(self, epsilon: float = 0.0) -> TileOccupancy:
        """Cut the accumulated maxima at ``epsilon * max|H|`` into an
        index. ``epsilon=0``: exact-zero tiles only (lossless)."""
        global_max = float(self.tile_max.max()) if self.tile_max.size else 0.0
        if not np.isfinite(global_max):
            # np.maximum propagates NaN, so ONE non-finite RTM entry
            # poisons the global max — and a NaN threshold would compare
            # False against every tile, silently skipping the whole
            # matrix. A corrupt operator must fail loudly instead.
            raise ValueError(
                "tile-occupancy pass found non-finite RTM entries; the "
                "operator is corrupt — refusing to build an index that "
                "would silently skip every tile."
            )
        threshold = float(epsilon) * global_max
        return TileOccupancy.from_mask(
            self.tile_max > threshold, rows=self.rows, cols=self.cols,
            tile_rows=self.tile_rows, tile_cols=self.tile_cols,
            threshold=threshold, epsilon=float(epsilon),
        )


def build_tile_occupancy(
    mat, *, epsilon: float = 0.0,
    tile_rows: int = TILE_ROWS, tile_cols: int = TILE_COLS,
) -> TileOccupancy:
    """One-shot index of a host matrix (the in-memory staging path; the
    chunked ingest uses :class:`TileMaxStats` instead)."""
    mat = np.asarray(mat)
    stats = TileMaxStats(mat.shape[0], mat.shape[1],
                         tile_rows=tile_rows, tile_cols=tile_cols)
    stats.add(mat, 0, 0)
    return stats.occupancy(epsilon)


def threshold_matrix(mat: np.ndarray, occ: TileOccupancy, *,
                     inplace: bool = False) -> np.ndarray:
    """Zero every dropped tile of a host matrix. The solve is then
    self-consistent by construction: rho/lambda and the Eq. 6 masks are
    computed from the matrix the sweeps actually multiply by — a voxel
    whose every tile was dropped has zero ray density and masks out
    exactly like a dark voxel.

    Memory: dropped tiles are zeroed by row-band slicing (no matrix-
    sized boolean mask is ever materialized — the RTM is the dominant
    host allocation). ``inplace=False`` (default) copies first; callers
    that own the buffer (the padded staging copy) pass ``inplace=True``
    for a zero-extra-allocation pass. Returns ``mat`` unchanged when
    nothing drops."""
    mat = np.asarray(mat)
    if mat.shape != (occ.rows, occ.cols):
        raise ValueError(
            f"matrix shape {mat.shape} does not match the occupancy "
            f"index's [{occ.rows}, {occ.cols}]."
        )
    mask = occ.mask
    if mask.all():
        return mat
    if not inplace:
        mat = mat.copy()
    tr, tc = occ.tile_rows, occ.tile_cols
    for i in np.flatnonzero(~mask.all(axis=1)):
        cols = np.repeat(~mask[i], tc)[: occ.cols]
        mat[i * tr:(i + 1) * tr, cols] = 0
    return mat


def static_decline_reason(opts, process_count: int = 1) -> Optional[str]:
    """Flag-only reasons the block-sparse mode cannot engage, knowable
    BEFORE any ingest (None = no static obstacle). ONE definition shared
    by the one-shot CLI and the serving engine, so `sartsolve solve` and
    `sartsolve serve` can never disagree on when an explicit threshold
    refuses vs when 'auto' declines (both print the same reason).
    ``opts`` is duck-typed (any object with the SolverOptions flags)."""
    if process_count > 1:
        return ("multi-process runs cannot accumulate a global tile "
                "index (each process sees only its own stripes)")
    if (getattr(opts, "logarithmic", False)
            and getattr(opts, "divergence_recovery", 0)
            and getattr(opts, "os_subsets", 1) == 1):
        return ("logarithmic + divergence_recovery cannot enter the "
                "sparse panel closures; use the linear solver or drop "
                "one of the two")
    return None


def accumulate_tile_max(stats: TileMaxStats, mat: np.ndarray,
                        band_rows: int = 0) -> TileMaxStats:
    """Fold a large host matrix into ``stats`` in bounded row bands, so
    the occupancy pass never allocates a matrix-sized fp32 transient —
    the RTM is the dominant host allocation on the staging paths
    (default band: ~64 MB of fp32, rounded to whole tile rows)."""
    rows = mat.shape[0]
    if not band_rows:
        band_rows = max(
            stats.tile_rows,
            (64 << 20) // max(mat.shape[1] * 4, 1)
            // stats.tile_rows * stats.tile_rows,
        )
    for r0 in range(0, rows, band_rows):
        stats.add(mat[r0:r0 + band_rows], r0, 0)
    return stats


def occupancy_matches(occ: Optional[TileOccupancy], nvoxel_local: int,
                      panel_voxels: int) -> bool:
    """Whether ``occ`` can drive a panel sweep over a block with
    ``nvoxel_local`` columns at ``panel_voxels``-wide panels."""
    return (
        occ is not None
        and occ.cols == nvoxel_local
        and panel_voxels % occ.tile_cols == 0
        and occ.cols % panel_voxels == 0
    )
