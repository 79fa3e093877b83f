"""Laplacian regularizer reader (a copy of ``sartsolver_tpu/io/laplacian_io.py``).

Reference layout (laplacian.cpp:34-91): group ``laplacian`` with attr
``nvoxel`` and COO datasets ``i``, ``j``, ``value``; entries are sorted by
flattened index ``i*nvoxel + j`` on load (the reference needs this for its
``lower_bound`` random access; we keep it for deterministic scatter order).
"""

from __future__ import annotations

from typing import Tuple

from sartsolver_tpu_torch.io import h5
import numpy as np

from sartsolver_tpu_torch.config import SartInputError


def read_laplacian(filename: str, nvoxel: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns sorted COO triplets (rows, cols, vals)."""
    with h5.File(filename, "r") as f:
        group = f["laplacian"]
        nvoxel_data = int(group.attrs["nvoxel"])
        if nvoxel_data != nvoxel:
            raise SartInputError(
                "Laplacian and ray-transfer matrices have different number of voxels."
            )
        rows = np.asarray(group["i"], np.int64)
        cols = np.asarray(group["j"], np.int64)
        vals = np.asarray(group["value"], np.float32)

    flat = rows * nvoxel + cols
    order = np.argsort(flat, kind="stable")
    return rows[order], cols[order], vals[order]
