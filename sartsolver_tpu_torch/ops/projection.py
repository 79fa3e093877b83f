"""Forward and back projection outside the iteration loop.

Counterparts of ``sartsolver_tpu/ops/projection.py``. They serve the Eq. 4
initial guess, the log variant's ``obs`` and the setup ``H f0``, plus the
two-matmul sweep (``fused_sweep="off"`` and the fp64 profile); inside the
fused loop the sweep kernel does both products. Plain products, left to
``torch.matmul`` as the JAX package leaves them to XLA. ``f @ rtm.T`` is a
strided view of the stored matrix, not a copy.

``rtm`` is ``[P, V]``; pixel-axis vectors are ``[P]`` or ``[B, P]``,
voxel-axis vectors ``[V]`` or ``[B, V]``.
"""

from __future__ import annotations

from torch import Tensor


def forward_project(rtm: Tensor, solution: Tensor) -> Tensor:
    """``fitted = H @ f``: [V] or [B, V] -> [P] or [B, P]."""
    return solution @ rtm.T


def back_project(rtm: Tensor, pixel_values: Tensor) -> Tensor:
    """``H^T @ w``: [P] or [B, P] -> [V] or [B, V]."""
    return pixel_values @ rtm
