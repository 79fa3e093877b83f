"""The materialized dense-H operator — the default backend. A copy of
``sartsolver_tpu/operators/dense.py``.

Wraps the existing staged RTM path without changing it: ``payload()`` is
the matrix itself, ``spec()`` is ``None`` (the solver's dense
contraction, traced exactly as before the operator layer existed), and
resident-bytes is the full ``npixel x nvoxel x itemsize`` footprint the
session-cache budget has always implicitly assumed.

A shape-only descriptor form (``DenseOperator(npixel=..., nvoxel=...,
dtype=...)`` with no host matrix) exists for accounting: a resident
serving session does not keep the host-side H after staging, but the
cache still needs its byte footprint and key.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sartsolver_tpu_torch.operators.base import ProjectionOperator


class DenseOperator(ProjectionOperator):
    """Materialized ``H`` (optionally shape-only for accounting)."""

    kind = "dense"

    def __init__(self, rtm: Optional[np.ndarray] = None, *,
                 npixel: Optional[int] = None,
                 nvoxel: Optional[int] = None, dtype=None):
        if rtm is not None:
            rtm = np.asarray(rtm)
            if rtm.ndim != 2:
                raise ValueError(
                    f"dense RTM must be 2-D, got shape {rtm.shape}"
                )
            npixel = rtm.shape[0] if npixel is None else npixel
            nvoxel = rtm.shape[1] if nvoxel is None else nvoxel
            dtype = rtm.dtype if dtype is None else dtype
        if npixel is None or nvoxel is None:
            raise ValueError(
                "DenseOperator needs either a matrix or explicit "
                "npixel/nvoxel"
            )
        self._rtm = rtm
        self._npixel = int(npixel)
        self._nvoxel = int(nvoxel)
        self._dtype = np.dtype(dtype if dtype is not None else np.float32)

    @property
    def npixel(self) -> int:
        return self._npixel

    @property
    def nvoxel(self) -> int:
        return self._nvoxel

    def payload(self) -> np.ndarray:
        if self._rtm is None:
            raise ValueError(
                "shape-only DenseOperator has no matrix to stage"
            )
        return self._rtm

    def resident_nbytes(self) -> int:
        return self._npixel * self._nvoxel * self._dtype.itemsize

    def cache_key(self) -> str:
        return f"dense:{self._npixel}x{self._nvoxel}:{self._dtype.name}"

    def materialize(self) -> np.ndarray:
        return np.asarray(self.payload(), np.float32)


__all__ = ["DenseOperator"]
