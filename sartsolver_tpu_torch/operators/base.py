"""The :class:`ProjectionOperator` contract: a copy of
``sartsolver_tpu/operators/base.py`` (host-only, numpy).

An operator answers five questions the solver and the serving engine
used to answer by assuming a materialized dense RTM:

- ``payload()`` — the per-device array the solver stages and threads
  through the solve as ``SARTProblem.rtm``: the matrix block itself for
  the dense/tile-skip operators, the packed ``[npixel, 6]`` ray table
  (origin xyz + unit direction xyz per detector pixel) for the implicit
  one. The pytree STRUCTURE of the problem is identical either way —
  only the leaf's shape differs — which is what lets one
  ``shard_map``/jit program family serve every backend.
- ``spec()`` — the hashable trace-time record that selects the
  projection code path inside the compiled solver (``None`` = dense
  contraction; an :class:`~sartsolver_tpu_torch.operators.implicit
  .ImplicitSpec` = the matrix-free panel projector). Passed as a static
  argument (the ``tile_occupancy`` precedent), so the dense default
  traces byte-identically to a build without the operator layer.
- ``ray_stats`` — how rho (per-voxel ray density) and lambda (per-pixel
  ray length) for the Eq. 6 masks are obtained.
- ``resident_nbytes()`` — the accelerator-memory footprint a warm
  session holds; the :class:`~sartsolver_tpu.engine.session
  .SessionCache` byte budget charges THIS, so a geometry-backed session
  costs its ray table (~KB/MB), never a phantom RTM.
- ``cache_key()`` — the operator's contribution to the session-cache /
  one-compiled-program key.
"""

from __future__ import annotations

import abc
from typing import Optional, Tuple

import numpy as np


class ProjectionOperator(abc.ABC):
    """Abstract forward/back-projection operator ``H``."""

    #: short machine-readable backend name ("dense" | "tileskip" |
    #: "implicit") — the CLI provenance line and cache keys use it
    kind: str = "abstract"

    # ---- identity --------------------------------------------------------

    @property
    @abc.abstractmethod
    def npixel(self) -> int:
        """Logical pixel (row) extent of ``H``."""

    @property
    @abc.abstractmethod
    def nvoxel(self) -> int:
        """Logical voxel (column) extent of ``H``."""

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.npixel, self.nvoxel)

    # ---- staging ---------------------------------------------------------

    @abc.abstractmethod
    def payload(self) -> np.ndarray:
        """The host array the solver stages as ``SARTProblem.rtm`` —
        ``[npixel, nvoxel]`` matrix entries for materialized operators,
        ``[npixel, 6]`` packed rays for the implicit one. Pixel rows are
        the sharded axis on every backend."""

    def spec(self, *, padded_nvoxel: Optional[int] = None,
             panel_voxels: Optional[int] = None):
        """Hashable static spec selecting the traced projection path;
        ``None`` means the dense contraction (the default). Materialized
        operators ignore the padding arguments — the staged matrix block
        already carries its padded shape."""
        return None

    def tile_occupancy(self):
        """The block-sparse tile index riding the operator, or None."""
        return None

    # ---- accounting ------------------------------------------------------

    @abc.abstractmethod
    def resident_nbytes(self) -> int:
        """Bytes of accelerator memory the staged operator occupies."""

    @abc.abstractmethod
    def cache_key(self) -> str:
        """Stable identity fragment for session-cache keys: two sessions
        may share compiled programs only if shapes/dtype/backend agree,
        so the key must pin all three."""

    # ---- host-side reference projections ---------------------------------

    @abc.abstractmethod
    def materialize(self) -> np.ndarray:
        """The dense ``[npixel, nvoxel]`` matrix this operator applies —
        tests and parity gates compare the matrix-free path against a
        solve over this. May be large; never called on hot paths."""

    def forward(self, f: np.ndarray) -> np.ndarray:
        """Host-side reference ``H f`` (parity/debug only)."""
        return self.materialize() @ np.asarray(f)

    def back(self, w: np.ndarray) -> np.ndarray:
        """Host-side reference ``H^T w`` (parity/debug only)."""
        return self.materialize().T @ np.asarray(w)


__all__ = ["ProjectionOperator"]
