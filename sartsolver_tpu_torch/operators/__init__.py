"""Pluggable projection operators: the counterpart of ``sartsolver_tpu/operators/``.

The solver consumes a projection operator — forward ``H f``,
back-projection ``H^T w``, the ray statistics behind the Eq. 6 masks,
resident-bytes accounting and a cache key — instead of assuming a stored
dense RTM:

- :class:`DenseOperator` and :class:`TileSkipOperator`: the stored matrix
  (with its block-sparse tile index), host-only copies of the JAX classes;
- :class:`ImplicitOperator`: the matrix-free backend over a versioned
  geometry record; each entry of ``H`` is a ray's segment length in a voxel,
  recomputed on the fly, on the card by the hand-written projector
  ``ops/csrc/implicit.cu``;
- :class:`LowRankOperator`: the factored ``H ~= S + U V^T``, a
  tile-thresholded sparse core plus two skinny randomized-SVD factors.
"""

from sartsolver_tpu_torch.operators.base import ProjectionOperator
from sartsolver_tpu_torch.operators.dense import DenseOperator
from sartsolver_tpu_torch.operators.geometry import (
    Camera, GeometryRecord, GeometryVoxelGrid, load_geometry,
    save_geometry,
)
from sartsolver_tpu_torch.operators.implicit import (
    ImplicitOperator, ImplicitSpec, implicit_back, implicit_forward,
    implicit_ray_stats, implicit_subset_density, materialize_rtm,
    pick_implicit_panel,
)
from sartsolver_tpu_torch.operators.lowrank import (
    LowRankOperator, LowRankSpec, build_lowrank_operator, lowrank_back,
    lowrank_forward, lowrank_ray_stats, lowrank_static_decline_reason,
    lowrank_subset_density, randomized_svd,
)
from sartsolver_tpu_torch.operators.tileskip import TileSkipOperator

__all__ = [
    "ProjectionOperator", "DenseOperator", "TileSkipOperator",
    "ImplicitOperator", "ImplicitSpec",
    "LowRankOperator", "LowRankSpec", "build_lowrank_operator",
    "lowrank_forward", "lowrank_back", "lowrank_ray_stats",
    "lowrank_subset_density", "lowrank_static_decline_reason",
    "randomized_svd",
    "Camera", "GeometryRecord", "GeometryVoxelGrid",
    "load_geometry", "save_geometry",
    "implicit_forward", "implicit_back", "implicit_ray_stats",
    "implicit_subset_density", "materialize_rtm", "pick_implicit_panel",
]
