"""Ordered-subsets (OS-SART) subset products.

Counterparts of the subset primitives of ``sartsolver_tpu/ops/fused_sweep.py``
(``os_subset_rows``, ``os_subset_pixels``, ``os_subset_forward``,
``os_subset_back``). The OS cycle updates against one pixel-row subset at a
time; subset t is the interleaved row set ``t::n_subsets``, so every subset
samples the whole measurement geometry (contiguous stripes of a spatially
coherent matrix do not accelerate).

A subset of the stored matrix is a strided view, never a copy: rows
``t::n`` of a row-major ``[P, V]`` matrix are a row-major ``[P/n, V]``
matrix with leading dimension ``n * V``, which ``torch.matmul`` hands to the
BLAS as it is. The products are plain, as the JAX package leaves them to
XLA, and go through :mod:`~sartsolver_tpu_torch.ops.projection`'s
``forward_project`` / ``back_project``: fp32 storage multiplies the view
directly; bf16 storage and int8 codes are upcast exactly to fp32 one block
at a time (``projection.PANEL_ELEMENTS``), so no subset-sized fp32 copy is
ever held. The vector operand stays fp32, as the JAX cycle's arithmetic is:
int8 codes are never quantized against it here (the JAX cycle's products
are exact against the fp32 operand), and their per-voxel scales fold into
the forward operand and apply after the back contraction.

Both products return fp32, as the JAX helpers' ``preferred_element_type``
makes theirs: in the fp64 profile a subset product is taken in fp64 and
rounded to fp32 (what XLA does with that dot on fp64 operands), and the
update around it promotes back to fp64. In the fp32 profile the rounding
is no op.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from sartsolver_tpu_torch.ops.projection import back_project, forward_project


def os_subset_rows(rtm: Tensor, t: int, n_subsets: int) -> Tensor:
    """Interleaved pixel-row subset ``t``: rows ``t::n_subsets`` of ``rtm``
    ``[P, V]`` as a ``[P/n, V]`` view in the stored dtype."""
    return rtm[t::n_subsets]


def os_subset_pixels(x: Tensor, t: int, n_subsets: int) -> Tensor:
    """Entries ``t::n_subsets`` of a per-pixel vector or batch: ``[P] ->
    [P/n]`` or ``[B, P] -> [B, P/n]``."""
    return x[..., t::n_subsets]


def os_subset_forward(panel: Tensor, f: Tensor, scale: Optional[Tensor] = None) -> Tensor:
    """``H_t f`` for one subset: ``[B, V] -> [B, P/n]`` in fp32.
    ``scale`` [V]: the per-voxel scales of int8 codes (``H = scale *
    codes``), folded into the operand so the contraction is exact."""
    fwd = f if scale is None else f * scale[None, :]
    return forward_project(panel, fwd).to(torch.float32)


def os_subset_back(panel: Tensor, w: Tensor, scale: Optional[Tensor] = None) -> Tensor:
    """``H_t^T w`` for one subset: ``[B, P/n] -> [B, V]`` in fp32.
    int8: the reduction runs over the codes; the scales apply once, after
    it."""
    bp = back_project(panel, w).to(torch.float32)
    if scale is not None:
        bp = bp * scale[None, :]
    return bp
