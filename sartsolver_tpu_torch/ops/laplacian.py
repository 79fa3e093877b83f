"""Sparse Laplacian regularizer, applied in a fixed order.

Counterpart of ``sartsolver_tpu/ops/laplacian.py``. The JAX package applies
the COO triplets with a scatter-add; on CUDA ``index_add_`` is an atomic
scatter whose summation order changes from run to run. Here the triplets are
grouped by row once, when the Laplacian is built (the reference sorts them by
``i*nvoxel + j``, laplacian.cpp:67-82), into a row-padded table: row ``i``
holds its ``k_max`` column indices and values, padded with ``(0, 0.0)``.
``L @ x`` is then ``k_max`` gather-multiply-adds over the table's columns:
row ``i`` accumulates its triplets one by one in their stored order, as the
JAX package's scatter does on the CPU, and in the same order on every run.

The table costs ``nvoxel * k_max`` entries; the Laplacians users supply are
local stencils (a handful of neighbours per voxel).

On a grid whose voxel axis is sharded (``parallel/mesh.py``), each rank
holds one voxel block and applies its rows of ``L`` in the same table form,
split in two (:func:`shard_laplacian_halo`, the JAX package's halo
partition): a local table of the triplets whose column lies in the block,
and a halo table of the rest, which read a compact export table gathered
over the voxel axis once a call (:func:`sharded_penalty`). A row adds its
local triplets, then its halo triplets, each in stored order: the split
changes a row's order of summation, and nothing else.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor


class LaplacianCOO(NamedTuple):
    """Row-grouped COO Laplacian on the device.

    ``cols``/``vals`` are ``[nvoxel, k_max]``: row ``i``'s triplets in their
    stored order, padded with column 0 and value 0. ``triplets`` keeps the
    host triplets ``(rows, cols, vals)`` in that order, for the partition
    over a grid's voxel blocks (:func:`shard_laplacian_halo`)."""

    cols: Tensor  # [V, k_max] int64
    vals: Tensor  # [V, k_max] float
    nnz: int  # stored triplets before padding
    triplets: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


def _row_table(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int):
    """``(cols [n_rows, k], vals [n_rows, k])``: each row's entries
    (``rows`` sorted, a row's entries in their stored order) padded with
    ``(0, 0.0)``; ``k`` at least 1."""
    counts = np.bincount(rows, minlength=n_rows)
    k_max = max(int(counts.max(initial=0)), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(rows.size) - starts[rows]  # position within its row
    tab_cols = np.zeros((n_rows, k_max), np.int64)
    tab_vals = np.zeros((n_rows, k_max), np.float64)
    tab_cols[rows, slot] = cols
    tab_vals[rows, slot] = vals
    return tab_cols, tab_vals


def make_laplacian(rows, cols, vals, *, nvoxel: int, dtype=torch.float32,
                   device="cpu") -> LaplacianCOO:
    """Build the row-padded table from host triplets (any order; triplets of
    one row keep their relative order)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if rows.size and (rows.min() < 0 or rows.max() >= nvoxel
                      or cols.min() < 0 or cols.max() >= nvoxel):
        raise ValueError(f"Laplacian indices must lie in [0, {nvoxel}).")
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    tab_cols, tab_vals = _row_table(rows, cols, vals, nvoxel)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return LaplacianCOO(
        torch.as_tensor(tab_cols, device=device),
        torch.as_tensor(tab_vals, dtype=dtype, device=device),
        int(rows.size),
        (rows, cols, vals),
    )


def coo_matvec(lap: Optional[LaplacianCOO], x: Tensor) -> Tensor:
    """``L @ x`` for ``x`` of shape [V] or [B, V]; zeros when no
    regularizer is set. For every stored triplet ``(i, j, v)``,
    ``v * x[j]`` is accumulated into row ``i`` (sartsolver.cpp:184-189)."""
    if lap is None:
        return torch.zeros_like(x)
    vals = lap.vals.to(x.dtype)
    out = torch.zeros_like(x)
    for k in range(vals.shape[1]):
        out = out + vals[:, k] * x[..., lap.cols[:, k]]
    return out


# ---- the halo partition over a grid's voxel blocks ---------------------------


class ShardedLaplacian(NamedTuple):
    """One voxel block's share of the Laplacian on a voxel-sharded grid
    (``sartsolver_tpu/ops/laplacian.py:ShardedLaplacian``, for one rank).

    ``loc_cols``/``loc_vals`` ``[block, k_loc]``: the triplets whose row and
    column both lie in the block, block-local, row-grouped as
    :class:`LaplacianCOO`'s table. ``halo_gidx``/``halo_vals`` ``[block,
    k_halo]``: the triplets whose column lies in another block, their
    columns as indices into the export table (``owner * n_export +
    position``). ``export_idx`` ``[n_export]``: the block-local values this
    block publishes, the union of what every other block reads from it
    (padded with index 0). ``n_export`` is the largest export set of any
    block, so every rank agrees whether the table is gathered at all."""

    loc_cols: Tensor
    loc_vals: Tensor
    halo_gidx: Tensor
    halo_vals: Tensor
    export_idx: Tensor
    n_export: int


def halo_partition(rows, cols, vals, n_shards: int, block: int):
    """The host partition of triplets (global indices in ``[0, n_shards *
    block)``) into block-local and halo sets, the arithmetic of the JAX
    ``shard_laplacian_halo``: ``(parts, n_export)``, ``parts[s]`` a dict of
    ``loc`` ``(rows, cols, vals)`` (block-local rows and columns), ``halo``
    ``(rows, gidx, vals)`` and ``export`` (block-local indices, ascending),
    each set in the triplets' stored order."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    own_r, own_c = rows // block, cols // block
    is_loc = own_r == own_c
    exports = [np.unique(cols[(~is_loc) & (own_c == t)] - t * block)
               for t in range(n_shards)]
    n_export = max((len(e) for e in exports), default=0)
    parts = []
    for s in range(n_shards):
        sel = is_loc & (own_r == s)
        loc = (rows[sel] - s * block, cols[sel] - s * block, vals[sel])
        sel = (~is_loc) & (own_r == s)
        t = own_c[sel]
        c_loc = cols[sel] - t * block
        pos = np.zeros(len(t), np.int64)
        for ti in np.unique(t):
            m = t == ti
            pos[m] = np.searchsorted(exports[ti], c_loc[m])
        halo = (rows[sel] - s * block, t * n_export + pos, vals[sel])
        parts.append({"loc": loc, "halo": halo, "export": exports[s]})
    return parts, n_export


def shard_laplacian_halo(lap: LaplacianCOO, n_shards: int, block: int, shard: int, *,
                         dtype=torch.float32, device="cpu") -> ShardedLaplacian:
    """Voxel block ``shard``'s :class:`ShardedLaplacian` of ``lap`` (built
    with :func:`make_laplacian`, which keeps its triplets) over ``n_shards``
    blocks of ``block`` voxels, on ``device``. Each row's triplets keep
    their stored order within the local and within the halo table."""
    if lap.triplets is None:
        raise ValueError("shard_laplacian_halo needs the Laplacian's triplets; build it "
                         "with make_laplacian.")
    parts, n_export = halo_partition(*lap.triplets, n_shards, block)
    part = parts[shard]
    loc_cols, loc_vals = _row_table(*part["loc"], block)
    halo_r, halo_g, halo_v = part["halo"]
    if halo_r.size:
        halo_gidx, halo_vals = _row_table(halo_r, halo_g, halo_v, block)
    else:
        halo_gidx, halo_vals = np.zeros((block, 0), np.int64), np.zeros((block, 0))
    export = np.zeros(n_export, np.int64)
    export[:len(part["export"])] = part["export"]
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def dev(x, dt=None):
        return torch.as_tensor(x, dtype=dt, device=device)
    return ShardedLaplacian(dev(loc_cols), dev(loc_vals, dtype), dev(halo_gidx),
                            dev(halo_vals, dtype), dev(export), int(n_export))


def sharded_penalty(slap: ShardedLaplacian, x: Tensor, grid) -> Tensor:
    """``(L @ x_global)`` on this rank's voxel block, ``x`` its ``[B,
    block]`` values: the local triplets read the block, then (where any
    block has a halo) one all-gather of every block's export values over
    the grid's voxel axis, ``[B, n_shards * n_export]``, feeds the halo
    triplets. Row ``i`` adds its local triplets, then its halo triplets,
    each in stored order."""
    from sartsolver_tpu_torch.parallel import comm
    from sartsolver_tpu_torch.parallel.mesh import VOXEL_AXIS

    out = torch.zeros_like(x)
    vals = slap.loc_vals.to(x.dtype)
    for k in range(vals.shape[1]):
        out = out + vals[:, k] * x[..., slap.loc_cols[:, k]]
    if slap.n_export == 0:
        return out
    table = comm.all_gather(x[..., slap.export_idx], VOXEL_AXIS, grid, dim=-1)
    vals = slap.halo_vals.to(x.dtype)
    for k in range(vals.shape[1]):
        out = out + vals[:, k] * table[..., slap.halo_gidx[:, k]]
    return out
