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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor


class LaplacianCOO(NamedTuple):
    """Row-grouped COO Laplacian on the device.

    ``cols``/``vals`` are ``[nvoxel, k_max]``: row ``i``'s triplets in their
    stored order, padded with column 0 and value 0."""

    cols: Tensor  # [V, k_max] int64
    vals: Tensor  # [V, k_max] float
    nnz: int  # stored triplets before padding


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
    counts = np.bincount(rows, minlength=nvoxel)
    k_max = max(int(counts.max(initial=0)), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(rows.size) - starts[rows]  # position within its row
    tab_cols = np.zeros((nvoxel, k_max), np.int64)
    tab_vals = np.zeros((nvoxel, k_max), np.float64)
    tab_cols[rows, slot] = cols
    tab_vals[rows, slot] = vals
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return LaplacianCOO(
        torch.as_tensor(tab_cols, device=device),
        torch.as_tensor(tab_vals, dtype=dtype, device=device),
        int(rows.size),
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
