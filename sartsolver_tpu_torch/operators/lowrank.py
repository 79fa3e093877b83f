"""Low-rank + sparse RTM factorization (``H ~= S + U @ V^T``).

Counterpart of ``sartsolver_tpu/operators/lowrank.py``. A reflective RTM has
a weak dense fill (every pixel sees every voxel a little), so its tile-skip
floor is the dense sweep. Splitting it into a sparse direct-ray core ``S``
(the tile-thresholded matrix: tiles whose every entry satisfies ``|H_ij| <=
eps * max|H|`` are zeroed, ``ops/sparse.py``) plus the fixed-seed randomized
SVD of the dropped residual, two skinny factors ``U [P, r]`` and ``V
[Vx, r]``, keeps the fill at ``r * (P + Vx)`` MACs a projection.

The host part is numpy, the JAX module's code: :func:`split_sparse_core`,
:func:`randomized_svd` (fp64, seed 1705, so its factors are byte for byte
the JAX package's), the quality gate :func:`build_lowrank_operator`
(Frobenius residual, then :func:`solve_parity_gap` against the dense solve
of the original ``H`` by this package's own solver), and
:func:`lowrank_static_decline_reason`. On a CUDA device the gate's
arithmetic runs on the card: the residual (fp32, held once, widened to
fp64 a band of rows at a time), the same fp64 steps with the same seeded
test matrix (:func:`randomized_svd_tensor`), the Frobenius residuals and
the parity gate's measurement, so its factors equal the host's to fp64
rounding, not byte for byte. The split itself stays on the host, whose
``S`` is the JAX package's bytes either way.

The device part works on tensors: :func:`lowrank_forward`,
:func:`lowrank_back`, :func:`lowrank_ray_stats` and
:func:`lowrank_subset_density`. Their ``S`` term is a plain product over the
core's occupied columns only, the columns of the tile columns that kept a
tile (all others of ``S`` are exactly zero): ``rtm`` is either the whole
``[P, Vx]`` core (its occupied columns are taken from ``spec``'s panels) or
those columns alone, ``[P, V_occ]``, with ``cols`` naming them — what the
solver holds on the device. int8 codes come with per-voxel scales over the
same columns and are upcast exactly, a block at a time
(``ops/projection.py``), as the JAX panel dots widen them; the factor term
is two skinny matmuls against the unscaled operand.

The compile-audit registration of the JAX module has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from sartsolver_tpu_torch.config import SartInputError
from sartsolver_tpu_torch.operators.base import ProjectionOperator
from sartsolver_tpu_torch.operators.implicit import COL_ALIGN, padded_size, pick_implicit_panel
from sartsolver_tpu_torch.ops.projection import back_project, forward_project
from sartsolver_tpu_torch.ops.sparse import TileOccupancy, build_tile_occupancy

# Fixed factorization seed: a re-ingest reproduces byte-identical factors.
LOWRANK_SEED = 1705  # arxiv 1705.07497
# Default relative tile threshold of the S/R split.
DEFAULT_EPSILON = 0.05
# Default Frobenius gate.
DEFAULT_TOL = 1e-4
# 'auto' rank ladder: doubling candidates up to this cap.
AUTO_MAX_RANK = 64
# Randomized SVD shape knobs (Halko et al. defaults).
_OVERSAMPLE = 8
_POWER_ITERS = 2
# Fixed iteration count of the end-to-end solve-parity gate.
PARITY_ITERATIONS = 20
# The shared fused-parity tolerance (sartsolver_tpu/utils/fused_parity.py:23).
PARITY_RTOL = 2e-4


@dataclasses.dataclass(frozen=True)
class LowRankSpec:
    """The factored projection's static record (the JAX package's fields
    and checks). ``nvoxel`` is the voxel extent of ``f`` and of the whole
    core; ``occ_panels`` the per-voxel-panel occupancy of ``S``."""

    rank: int
    nvoxel: int
    panel_voxels: int
    occ_panels: Tuple[bool, ...]
    version: int = 1

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(
                f"LowRankSpec rank={self.rank} must be >= 1 (a rank-0 "
                "factorization is the tile-skip backend)."
            )
        if self.panel_voxels < 1 or self.nvoxel % self.panel_voxels:
            raise ValueError(
                f"LowRankSpec panel_voxels={self.panel_voxels} must "
                f"divide nvoxel={self.nvoxel}"
            )
        if len(self.occ_panels) != self.nvoxel // self.panel_voxels:
            raise ValueError(
                f"LowRankSpec occ_panels has {len(self.occ_panels)} "
                f"entries for {self.nvoxel // self.panel_voxels} panels"
            )

    @property
    def n_panels(self) -> int:
        return self.nvoxel // self.panel_voxels

    @property
    def occupied_panels(self) -> int:
        return sum(1 for live in self.occ_panels if live)

    def occupied_columns(self) -> Optional[np.ndarray]:
        """The columns of the occupied panels, ascending; None where every
        panel is occupied."""
        if all(self.occ_panels):
            return None
        bs = self.panel_voxels
        return np.concatenate([np.arange(j * bs, (j + 1) * bs) for j, live in
                               enumerate(self.occ_panels) if live] or
                              [np.zeros(0, np.int64)]).astype(np.int64)


# ---- device part ------------------------------------------------------------

def _core(rtm: Tensor, spec: Optional[LowRankSpec], cols, scale):
    """``(S block, its columns or None, its scales or None)``: ``rtm`` as
    given where ``cols`` names its columns (or it holds every column), else
    the occupied panels' columns of the whole core."""
    if cols is None and spec is not None and rtm.shape[1] == spec.nvoxel:
        occ = spec.occupied_columns()
        if occ is not None:
            cols = torch.as_tensor(occ, device=rtm.device)
            rtm = rtm.index_select(1, cols)
    if cols is not None and scale is not None and scale.shape[-1] != rtm.shape[1]:
        scale = scale.index_select(0, cols)
    return rtm, cols, scale


def _dt(x: Tensor, accum_dtype):
    return accum_dtype or torch.promote_types(x.dtype, torch.float32)


def lowrank_forward(rtm: Tensor, u: Tensor, v: Tensor, f: Tensor,
                    spec: Optional[LowRankSpec] = None, *, scale: Optional[Tensor] = None,
                    cols: Optional[Tensor] = None,
                    accum_dtype: Optional[torch.dtype] = None) -> Tensor:
    """``fitted = (S + U V^T) @ f``: ``f`` ``[Vx]`` or ``[B, Vx]`` ->
    ``[P]`` or ``[B, P]`` in ``accum_dtype`` (default ``f``'s, at least
    fp32). int8: ``codes @ (scale * f)``, exact."""
    dt = _dt(f, accum_dtype)
    x = f.to(dt)
    s, cols, scale = _core(rtm, spec, cols, scale)
    xs = x if cols is None else x.index_select(-1, cols)
    if scale is not None:
        xs = xs * scale.to(dt)
    out = forward_project(s, xs) if s.shape[1] else torch.zeros(
        x.shape[:-1] + (s.shape[0],), dtype=dt, device=x.device)
    return out + (x @ v.to(dt)) @ u.to(dt).T


def lowrank_back(rtm: Tensor, u: Tensor, v: Tensor, w: Tensor,
                 spec: Optional[LowRankSpec] = None, *, scale: Optional[Tensor] = None,
                 cols: Optional[Tensor] = None,
                 accum_dtype: Optional[torch.dtype] = None) -> Tensor:
    """``(S + U V^T)^T @ w``: ``w`` ``[P]`` or ``[B, P]`` -> ``[Vx]`` or
    ``[B, Vx]`` (``Vx = v.shape[0]``); the skipped columns of ``S`` add
    exact zeros. int8: the scales apply after the code-space product."""
    dt = _dt(w, accum_dtype)
    x = w.to(dt)
    s, cols, scale = _core(rtm, spec, cols, scale)
    bp = (x @ u.to(dt)) @ v.to(dt).T
    if s.shape[1]:
        part = back_project(s, x)
        if scale is not None:
            part = part * scale.to(dt)
        if cols is None:
            bp = bp + part
        else:
            bp = bp.index_add(-1, cols, part)
    return bp


def _core_stats(s: Tensor, scale: Optional[Tensor], dt) -> Tuple[Tensor, Tensor]:
    from sartsolver_tpu_torch.models.sart import compute_ray_stats, compute_ray_stats_int8

    if s.dtype == torch.int8:
        return compute_ray_stats_int8(s, scale, dtype=dt)
    return compute_ray_stats(s, dtype=dt)


def lowrank_ray_stats(rtm: Tensor, u: Tensor, v: Tensor,
                      spec: Optional[LowRankSpec] = None, *, scale: Optional[Tensor] = None,
                      cols: Optional[Tensor] = None,
                      dtype: torch.dtype = torch.float32) -> Tuple[Tensor, Tensor]:
    """``(ray_density [Vx], ray_length [P])`` of the composed operator:
    ``rho = colsum(S) + V @ colsum(U)``, ``lambda = rowsum(S) + U @
    colsum(V)``."""
    s, cols, scale = _core(rtm, spec, cols, scale)
    dens = v.to(dtype) @ u.to(dtype).sum(dim=0)
    length = u.to(dtype) @ v.to(dtype).sum(dim=0)
    if s.shape[1]:
        d_s, l_s = _core_stats(s, scale, dtype)
        dens = dens + d_s if cols is None else dens.index_add(0, cols, d_s)
        length = length + l_s
    return dens, length


def lowrank_subset_density(rtm: Tensor, u: Tensor, v: Tensor,
                           spec: Optional[LowRankSpec], n_subsets: int, *,
                           scale: Optional[Tensor] = None, cols: Optional[Tensor] = None,
                           dtype: torch.dtype = torch.float32) -> Tensor:
    """Per-subset ray density ``[n_subsets, Vx]`` for OS-SART: subset ``t``
    is pixel rows ``t::n_subsets`` of ``S`` and ``U`` alike."""
    from sartsolver_tpu_torch.models.sart import _subset_colsums

    npix = rtm.shape[0]
    if npix % n_subsets:
        raise ValueError(
            f"{npix} pixel rows not divisible into {n_subsets} subsets"
        )
    s, cols, scale = _core(rtm, spec, cols, scale)
    u_sub = u.to(dtype).reshape(npix // n_subsets, n_subsets, u.shape[1]).sum(dim=0)
    dens = u_sub @ v.to(dtype).T  # [os, Vx]
    if s.shape[1]:
        part = _subset_colsums(s, n_subsets, dtype,
                               None if scale is None else scale.to(dtype))
        dens = dens + part if cols is None else dens.index_add(1, cols, part)
    return dens


# ---- host part (ingest; numpy only) ----------------------------------------

def split_sparse_core(H: np.ndarray, *, epsilon: float = DEFAULT_EPSILON):
    """``(S, occupancy)``: the tile-thresholded sparse core of ``H`` and its
    index, cut at ``epsilon * max|H|`` — the JAX function's index and core
    (``build_tile_occupancy``, ``threshold_matrix``: the same tile maxima,
    digest and bytes), their passes run by torch's threads over the host
    matrix (the ingest's tile maxima, a band of tile rows at a time)."""
    from sartsolver_tpu_torch.ops.sparse import TileMaxStats
    from sartsolver_tpu_torch.parallel.multihost import _feed_tile_stats

    H = np.ascontiguousarray(np.asarray(H, np.float32))
    stats = TileMaxStats(*H.shape)
    _feed_tile_stats(stats, torch.from_numpy(H), 0)
    occ = stats.occupancy(float(epsilon))
    S = torch.from_numpy(H).clone()
    mask, tr, tc = occ.mask, occ.tile_rows, occ.tile_cols
    for i in np.flatnonzero(~mask.all(axis=1)):
        drop = torch.from_numpy(np.repeat(~mask[i], tc)[:occ.cols])
        S[i * tr:(i + 1) * tr, drop] = 0.0
    return S.numpy(), occ


def _sketch_width(rank: int, P: int, Vx: int, oversample: int) -> int:
    """The sketch's column count for a rank-``rank`` factorization of a
    ``[P, Vx]`` residual; a rank outside ``[1, min(P, Vx)]`` raises."""
    r = int(rank)
    if not (1 <= r <= min(P, Vx)):
        raise ValueError(
            f"factorization rank {r} must lie in [1, min(P, V) = "
            f"{min(P, Vx)}]"
        )
    return min(r + oversample, min(P, Vx))


def randomized_svd(residual: np.ndarray, rank: int, *,
                   seed: int = LOWRANK_SEED,
                   power_iters: int = _POWER_ITERS,
                   oversample: int = _OVERSAMPLE):
    """Fixed-seed randomized rank-``r`` factorization of the residual:
    ``(U [P, r], V [Vx, r])`` with ``residual ~= U @ V^T`` (singular values
    folded into ``U``), fp64 numpy: the JAX package's function, so the
    same factors byte for byte."""
    R = np.asarray(residual, np.float64)
    P, Vx = R.shape
    r = int(rank)
    k = _sketch_width(r, P, Vx, oversample)
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(R @ rng.standard_normal((Vx, k)))
    for _ in range(power_iters):
        Z, _ = np.linalg.qr(R.T @ Q)
        Q, _ = np.linalg.qr(R @ Z)
    Ub, s, Vt = np.linalg.svd(Q.T @ R, full_matrices=False)
    U = (Q @ Ub[:, :r]) * s[:r]
    return (np.ascontiguousarray(U.astype(np.float32)),
            np.ascontiguousarray(Vt[:r].T.astype(np.float32)))


def randomized_svd_tensor(R: Tensor, rank: int, *,
                          seed: int = LOWRANK_SEED,
                          power_iters: int = _POWER_ITERS,
                          oversample: int = _OVERSAMPLE,
                          band: int = 1024):
    """:func:`randomized_svd`'s steps on a tensor ``R`` ``[P, Vx]`` where it
    lies (the card, for the gate): the same seeded test matrix, QR power
    iterations and small SVD by torch, every product with ``R`` in fp64,
    ``band`` rows of ``R`` at a time (an fp32 ``R`` is widened a band at a
    time, never whole). Returns fp32 numpy ``(U, V)`` equal to the host
    function's to fp64 rounding (a singular vector's sign may differ;
    ``U V^T`` does not)."""
    P, Vx = R.shape
    r = int(rank)
    k = _sketch_width(r, P, Vx, oversample)
    bands = [slice(i, i + band) for i in range(0, P, band)]

    def times(X):  # R @ X
        return torch.cat([R[b].double() @ X for b in bands])

    def t_times(Y):  # R^T @ Y
        out = torch.zeros((Vx, Y.shape[1]), dtype=torch.float64, device=R.device)
        for b in bands:
            out += R[b].double().T @ Y[b]
        return out

    omega = torch.as_tensor(np.random.default_rng(seed).standard_normal((Vx, k)),
                            device=R.device)
    Q = torch.linalg.qr(times(omega)).Q
    for _ in range(power_iters):
        Z = torch.linalg.qr(t_times(Q)).Q
        Q = torch.linalg.qr(times(Z)).Q
    Ub, s, Vt = torch.linalg.svd(t_times(Q).T, full_matrices=False)
    U = (Q @ Ub[:, :r]) * s[:r]
    return (np.ascontiguousarray(U.float().cpu().numpy()),
            np.ascontiguousarray(Vt[:r].T.float().cpu().numpy()))


def _frobenius_residual(R: Tensor, U: np.ndarray, V: np.ndarray,
                        band: int = 1024) -> float:
    """``||R - U V^T||_F`` of the tensor ``R`` and the fp32 factors, in fp64
    where ``R`` lies, ``band`` rows at a time."""
    u = torch.as_tensor(U, device=R.device, dtype=torch.float64)
    vt = torch.as_tensor(V, device=R.device, dtype=torch.float64).T
    total = torch.zeros((), dtype=torch.float64, device=R.device)
    for i in range(0, R.shape[0], band):
        total += (R[i:i + band].double() - u[i:i + band] @ vt).square().sum()
    return float(total.sqrt())


def _card_residual(H: np.ndarray, S: np.ndarray, device, band: int = 1024):
    """``(H - S [P, Vx] fp32 on ``device``, ||H||_F)``: ``H`` uploaded, its
    norm taken (summed in fp64), then ``S`` subtracted in place a band of
    rows at a time, so the card holds the matrix's bytes once."""
    R = torch.tensor(H, device=device)  # a copy on every device: H stays as it is
    h_norm = float(torch.linalg.vector_norm(R, dtype=torch.float64))
    for i in range(0, R.shape[0], band):
        R[i:i + band] -= torch.as_tensor(S[i:i + band], device=device)
    return R, h_norm


class LowRankOperator(ProjectionOperator):
    """The factored operator: sparse core ``S`` (with its tile index) plus
    skinny factors ``U``/``V``. ``payload()`` is ``S``."""

    kind = "lowrank"

    def __init__(self, s_matrix: np.ndarray, u: np.ndarray,
                 v: np.ndarray, *, occupancy: TileOccupancy,
                 dtype=np.float32):
        s_matrix = np.ascontiguousarray(np.asarray(s_matrix, np.float32))
        u = np.ascontiguousarray(np.asarray(u, np.float32))
        v = np.ascontiguousarray(np.asarray(v, np.float32))
        if s_matrix.ndim != 2:
            raise ValueError(
                f"S must be [npixel, nvoxel], got shape {s_matrix.shape}"
            )
        P, Vx = s_matrix.shape
        if u.ndim != 2 or v.ndim != 2 or u.shape[1] != v.shape[1]:
            raise ValueError(
                f"factors must be [P, r] / [V, r], got {u.shape} / "
                f"{v.shape}"
            )
        if u.shape[0] != P or v.shape[0] != Vx:
            raise ValueError(
                f"factor shapes {u.shape} / {v.shape} do not match the "
                f"[{P}, {Vx}] sparse core"
            )
        if (occupancy.rows, occupancy.cols) != (P, Vx):
            raise ValueError(
                f"occupancy index covers [{occupancy.rows}, "
                f"{occupancy.cols}], sparse core is [{P}, {Vx}]"
            )
        self._s = s_matrix
        self._u = u
        self._v = v
        self.occupancy = occupancy
        self._dtype = np.dtype(dtype)

    @property
    def npixel(self) -> int:
        return self._s.shape[0]

    @property
    def nvoxel(self) -> int:
        return self._s.shape[1]

    @property
    def rank(self) -> int:
        return self._u.shape[1]

    def payload(self) -> np.ndarray:
        """The sparse core ``S``: the matrix block the solver stages."""
        return self._s

    def factors(self):
        """``(U [P, r], V [Vx, r])`` fp32 host factors."""
        return self._u, self._v

    def occupied_columns(self) -> np.ndarray:
        """The columns of ``S`` that can hold a nonzero (those of the tile
        columns with a kept tile), ascending: the columns the solver keeps
        on the device."""
        return self.occupancy.occupied_columns(self.nvoxel)

    def solver_spec(self) -> LowRankSpec:
        """The spec of the port's solver, over the unpadded voxels: the
        split's tile columns as panels (where they divide the voxel
        extent, else one panel), occupied where a tile was kept; read from
        the index, without a pass over S."""
        tc, V = self.occupancy.tile_cols, self.nvoxel
        if V % tc:
            return LowRankSpec(rank=self.rank, nvoxel=V, panel_voxels=V,
                               occ_panels=(bool(self.occupancy.mask.any()),))
        col_any = self.occupancy.mask.any(axis=0)[:V // tc]
        return LowRankSpec(rank=self.rank, nvoxel=V, panel_voxels=tc,
                           occ_panels=tuple(bool(x) for x in col_any))

    def spec(self, *, padded_nvoxel: Optional[int] = None,
             panel_voxels: Optional[int] = None) -> LowRankSpec:
        if padded_nvoxel is None:
            padded_nvoxel = padded_size(self.nvoxel, COL_ALIGN)
        if panel_voxels is None:
            panel_voxels = pick_implicit_panel(padded_nvoxel)
            while panel_voxels > 256 and panel_voxels % 256 == 0:
                panel_voxels //= 2
        # the skip predicate of the padded block, from a zero-padded copy
        # of S at eps = 0
        s_pad = self._s
        if int(padded_nvoxel) != self.nvoxel:
            s_pad = np.zeros((self.npixel, int(padded_nvoxel)), np.float32)
            s_pad[:, :self.nvoxel] = self._s
        occ_pad = build_tile_occupancy(s_pad, epsilon=0.0)
        return LowRankSpec(
            rank=self.rank,
            nvoxel=int(padded_nvoxel),
            panel_voxels=int(panel_voxels),
            occ_panels=tuple(
                bool(x) for x in occ_pad.col_panel_occupied(
                    int(panel_voxels))
            ),
        )

    def tile_occupancy(self) -> TileOccupancy:
        return self.occupancy

    def resident_nbytes(self) -> int:
        """Bytes of ``S + U + V`` at the staged dtype, ``S`` whole (the JAX
        package's accounting; the port's solver holds only the occupied
        columns of ``S``)."""
        P, Vx, r = self.npixel, self.nvoxel, self.rank
        return (P * Vx + (P + Vx) * r) * self._dtype.itemsize

    def cache_key(self) -> str:
        digest = hashlib.sha1()
        digest.update(
            f"{self.npixel}:{self.nvoxel}:{self.rank}:"
            f"{self.occupancy.digest:#010x}:".encode()
        )
        digest.update(self._s.tobytes())
        digest.update(self._u.tobytes())
        digest.update(self._v.tobytes())
        return (
            f"lowrank:{self.npixel}x{self.nvoxel}:{self._dtype.name}:"
            f"{self.rank}:{digest.hexdigest()[:12]}"
        )

    def materialize(self) -> np.ndarray:
        return np.asarray(
            self._s + self._u @ self._v.T, self._dtype
        )


def solve_parity_gap(H: np.ndarray, operator: LowRankOperator, *,
                     iterations: int = PARITY_ITERATIONS, device="cuda") -> float:
    """End-to-end solve parity of the factored operator against the dense
    solve of the original ``H`` on ``device``, by this package's solver:
    both run a fixed iteration count with the stall test off on a
    deterministic consistent measurement; the gap is ``max|d| /
    max(|solution|, 1)``, gated at ``PARITY_RTOL``."""
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

    H = np.asarray(H, np.float32)
    x = np.random.default_rng(LOWRANK_SEED).uniform(0.5, 1.5, H.shape[1])
    # g = H @ x in fp64, a band of rows at a time (no fp64 copy of H), on
    # the card where the solves run
    step = max(1, (1 << 24) // max(H.shape[1], 1))
    if torch.device(device).type == "cuda":
        Hd, xd = torch.as_tensor(H, device=device), torch.as_tensor(x, device=device)
        g = torch.cat([Hd[r:r + step].double() @ xd
                       for r in range(0, H.shape[0], step)]).cpu().numpy()
        del Hd
    else:
        g = np.concatenate([H[r:r + step].astype(np.float64) @ x
                            for r in range(0, H.shape[0], step)])
    opts = SolverOptions(max_iterations=int(iterations),
                         conv_tolerance=0.0, fused_sweep="off")
    with DistributedSARTSolver(operator=operator, opts=opts, device=device) as factored:
        a = factored.solve(g).solution[:H.shape[1]]
    with DistributedSARTSolver(H, opts=opts, device=device) as dense:
        b = dense.solve(g).solution[:H.shape[1]]
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1.0))


def build_lowrank_operator(
    H: np.ndarray,
    *,
    rank,  # positive int (explicit) or "auto"
    epsilon: float = DEFAULT_EPSILON,
    tol: float = DEFAULT_TOL,
    seed: int = LOWRANK_SEED,
    dtype=np.float32,
    check_parity: bool = True,
    device="cuda",
    timings: Optional[dict] = None,
):
    """Factorize ``H`` behind the quality gate (the JAX function; on a
    CUDA ``device`` the residual, the rSVD and the Frobenius test run on
    the card, and the parity gate's solves run on ``device``).

    Returns ``(operator, None)`` on success or ``(None, reason)`` when
    ``rank='auto'`` declines. An explicit integer rank that fails the
    Frobenius or solve-parity gate raises :class:`SartInputError` before
    anything is staged. ``timings``, where given, receives the seconds of
    the split, the rSVD and the parity gate.
    """
    import time

    clock = {} if timings is None else timings
    H = np.ascontiguousarray(np.asarray(H, np.float32))
    if H.ndim != 2:
        raise SartInputError(
            f"lowrank factorization needs a [npixel, nvoxel] matrix, "
            f"got shape {H.shape}"
        )
    P, Vx = H.shape
    explicit = rank != "auto"
    if explicit:
        try:
            r0 = int(rank)
        except (TypeError, ValueError):
            raise SartInputError(
                f"lowrank rank must be 'auto' or a positive integer, "
                f"{rank!r} given"
            ) from None
        if not (1 <= r0 <= min(P, Vx)):
            raise SartInputError(
                f"lowrank rank {r0} must lie in [1, min(npixel, nvoxel) "
                f"= {min(P, Vx)}]"
            )
        ranks = [r0]
    else:
        ranks = [r for r in (4, 8, 16, 32, AUTO_MAX_RANK)
                 if r <= min(P, Vx)]
        if not ranks:
            return None, (
                f"matrix [{P}, {Vx}] too small for the candidate rank "
                "ladder"
            )
    t0 = time.perf_counter()
    S, occ = split_sparse_core(H, epsilon=epsilon)
    clock["split_s"] = time.perf_counter() - t0
    if occ.mask.all() and not explicit:
        return None, (
            f"no tile fell below eps={epsilon:g} * max|H| — there is no "
            "sub-threshold residual to factor (the matrix has no "
            "separable low-amplitude fill)"
        )
    # the residual (once, not once a rank): elementwise, the same values on
    # the card as by torch's threads on the host; on the card fp32, made
    # again after a parity gate (which stages the dense matrix) let it go
    on_card = torch.device(device).type == "cuda"
    card_residual = None
    if not on_card:
        residual_t = torch.from_numpy(H) - torch.from_numpy(S)
        residual, residual64 = residual_t.numpy(), residual_t.double().numpy()
        h_norm = float(np.linalg.norm(H))
    reason = None
    clock.setdefault("rsvd_s", 0.0)
    clock.setdefault("parity_s", 0.0)
    for r in ranks:
        t0 = time.perf_counter()
        if on_card:
            if card_residual is None:
                card_residual, h_norm = _card_residual(H, S, device)
            U, V = randomized_svd_tensor(card_residual, r, seed=seed)
            frob = _frobenius_residual(card_residual, U, V)
        else:
            U, V = randomized_svd(residual64, r, seed=seed)
            frob = float(np.linalg.norm(residual - U @ V.T))
        rel = frob / max(h_norm, 1e-30)
        clock["rsvd_s"] += time.perf_counter() - t0
        if rel > tol:
            reason = (
                f"rank {r}: Frobenius residual {rel:.3e} exceeds "
                f"tol {tol:g}"
            )
            if explicit:
                raise SartInputError(
                    f"lowrank rank {r} fails the factorization gate: "
                    f"||H - (S + U V^T)||_F / ||H||_F = {rel:.3e} > "
                    f"tol {tol:g} — raise the rank or use 'auto'."
                )
            continue
        op = LowRankOperator(S, U, V, occupancy=occ, dtype=dtype)
        if check_parity:
            card_residual = None
            t0 = time.perf_counter()
            gap = solve_parity_gap(H, op, device=device)
            clock["parity_s"] += time.perf_counter() - t0
            if gap > PARITY_RTOL:
                reason = (
                    f"rank {r}: solve-parity gap {gap:.3e} exceeds "
                    f"{PARITY_RTOL:g}"
                )
                if explicit:
                    raise SartInputError(
                        f"lowrank rank {r} fails the solve-parity gate: "
                        f"factored-vs-dense solution gap {gap:.3e} > "
                        f"{PARITY_RTOL:g} — raise the rank or use "
                        "'auto'."
                    )
                continue
        return op, None
    return None, reason or "no candidate rank passed the quality gate"


def lowrank_static_decline_reason(opts, process_count: int = 1,
                                  n_voxel_shards: int = 1,
                                  has_laplacian: bool = False):
    """Flag-only reasons the factored path cannot engage, knowable before
    the whole-matrix read and the rSVD (None = no static obstacle): the
    JAX function, its messages word for word."""
    if process_count > 1:
        return ("multi-process runs cannot factorize host-side — each "
                "process sees only its own row stripes of H, and the "
                "randomized SVD needs the whole residual")
    if n_voxel_shards != 1:
        return ("the factored back-projection psums over the one pixel "
                "axis; voxel-sharded meshes are ineligible")
    if getattr(opts, "integrity", False):
        return ("the in-solve checksum tolerance model certifies a "
                "single stored-matrix contraction, not the composed "
                "S + U V^T products")
    if has_laplacian:
        return ("beta_laplace smoothing contracts the materialized "
                "operator; drop the Laplacian or run dense")
    return None


__all__ = [
    "AUTO_MAX_RANK", "DEFAULT_EPSILON", "DEFAULT_TOL", "LOWRANK_SEED",
    "LowRankOperator", "LowRankSpec", "PARITY_ITERATIONS", "PARITY_RTOL",
    "build_lowrank_operator", "lowrank_back", "lowrank_forward",
    "lowrank_ray_stats", "lowrank_static_decline_reason",
    "lowrank_subset_density", "randomized_svd", "solve_parity_gap",
    "split_sparse_core",
]


# ---- launch-audit registration (analysis/registry.py) -----------------------
from sartsolver_tpu_torch.analysis.registry import register_audit_entry  # noqa: E402


@register_audit_entry(
    "lowrank_sweep",
    description="low-rank + sparse factored loop (S at 50% tile-column "
                "occupancy, rank-8 fill, fp32): a matrix-sized copy or convert "
                "in the loop would densify what the factorization removed",
)
def _audit_lowrank_sweep(ctx):
    from sartsolver_tpu_torch.config import SolverOptions

    return ctx.batch_runner(SolverOptions(fused_sweep="off"), operator="lowrank")
