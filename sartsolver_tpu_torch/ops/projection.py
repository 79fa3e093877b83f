"""Forward and back projection outside the iteration loop.

Counterparts of ``sartsolver_tpu/ops/projection.py`` and of the int8
projections of ``sartsolver_tpu/models/sart.py``. They serve the Eq. 4
initial guess, the log variant's ``obs`` and the setup ``H f0``, plus the
two-matmul sweep (``fused_sweep="off"`` and the fp64 profile); inside the
fused loop the sweep kernel does both products. Plain products, left to
``torch.matmul`` as the JAX package leaves them to XLA.

``rtm`` is ``[P, V]``; pixel-axis vectors are ``[P]`` or ``[B, P]``,
voxel-axis vectors ``[V]`` or ``[B, V]``.

A matrix stored in the vector's dtype is multiplied as it is (``f @ rtm.T``
is a strided view, not a copy). A matrix stored in another float dtype
(bf16 storage under fp32 compute, say) is upcast exactly, one block at a
time, so no whole upcast copy of it is ever held: the back projection takes
one voxel panel at a time and the forward projection one block of pixel
rows, so neither splits its contraction.

int8 codes (``H = scale * codes``) are never dequantized here. The vector
operand is quantized per batch row with :func:`_quantize_sym`, the integer
contraction is exact, and the result is rescaled, as the JAX package does
with an int32 dot. ``torch.matmul`` takes no int8 on CUDA, so the exact
contraction is a sum of fp32 products over at most ``EXACT_TERMS`` terms:
each such partial sum is an integer below 2**24 and so exact in fp32 (or
TF32), and the partials are added in int32.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

# fp32 elements of one upcast block (64 MiB)
PANEL_ELEMENTS = 1 << 24
# terms of one exact fp32 partial sum of int8 products: 127**2 * 1024 < 2**24
EXACT_TERMS = 1024


def forward_project(rtm: Tensor, solution: Tensor) -> Tensor:
    """``fitted = H @ f``: [V] or [B, V] -> [P] or [B, P], in ``f``'s dtype."""
    if rtm.dtype == solution.dtype:
        return solution @ rtm.T
    ct = torch.promote_types(rtm.dtype, solution.dtype)
    x = solution.to(ct)
    P, V = rtm.shape
    out = torch.empty(solution.shape[:-1] + (P,), dtype=ct, device=solution.device)
    rows = max(1, PANEL_ELEMENTS // V)
    for p0 in range(0, P, rows):
        out[..., p0:p0 + rows] = x @ rtm[p0:p0 + rows].to(ct).T
    return out.to(solution.dtype)


def back_project(rtm: Tensor, pixel_values: Tensor) -> Tensor:
    """``H^T @ w``: [P] or [B, P] -> [V] or [B, V], in ``w``'s dtype."""
    if rtm.dtype == pixel_values.dtype:
        return pixel_values @ rtm
    ct = torch.promote_types(rtm.dtype, pixel_values.dtype)
    x = pixel_values.to(ct)
    P, V = rtm.shape
    out = torch.empty(pixel_values.shape[:-1] + (V,), dtype=ct,
                      device=pixel_values.device)
    cols = max(1, PANEL_ELEMENTS // P)
    for v0 in range(0, V, cols):
        out[..., v0:v0 + cols] = x @ rtm[:, v0:v0 + cols].to(ct)
    return out.to(pixel_values.dtype)


def _sym_scale(amax: Tensor) -> Tensor:
    """``amax / 127`` in fp32 (true division), 1 where ``amax`` is 0."""
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                       torch.ones_like(amax))


def _sym_codes(x: Tensor, scale: Tensor) -> Tensor:
    """``clip(round_half_even(x / scale), -127, 127)`` as int8."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _quantize_sym(x: Tensor, dim: int) -> Tuple[Tensor, Tensor]:
    """Symmetric int8 quantization along ``dim``: ``x ~= scale * codes``
    with ``|codes| <= 127``; all-zero slices get scale 1 (codes stay 0).
    The recipe of the JAX package's ``models/sart.py:_quantize_sym``."""
    scale = _sym_scale(x.abs().amax(dim=dim, keepdim=True))
    return _sym_codes(x, scale), scale


def _exact_int8_matmul(a: Tensor, codes: Tensor, *, transpose: bool) -> Tensor:
    """``a @ codes`` (``transpose=False``, codes ``[K, N]``) or ``a @
    codes.T`` (codes ``[N, K]``) for int8 ``a [B, K]``: exact, int32."""
    N = codes.shape[0] if transpose else codes.shape[1]
    K = a.shape[1]
    out = torch.zeros((a.shape[0], N), dtype=torch.int32, device=a.device)
    width = max(1, PANEL_ELEMENTS // EXACT_TERMS)
    for n0 in range(0, N, width):
        n1 = min(n0 + width, N)
        for k0 in range(0, K, EXACT_TERMS):
            k1 = min(k0 + EXACT_TERMS, K)
            if transpose:
                panel = codes[n0:n1, k0:k1].float().T
            else:
                panel = codes[k0:k1, n0:n1].float()
            out[:, n0:n1] += (a[:, k0:k1].float() @ panel).to(torch.int32)
    return out


def int8_back_project(codes: Tensor, scale: Tensor, w: Tensor) -> Tensor:
    """``H^T w`` for ``H = scale * codes`` (``scale`` [V]), without
    dequantizing: ``w`` [B, P] is quantized per row, the contraction is
    exact, and the result is ``acc * (ws * scale)`` in ``w``'s dtype."""
    wq, ws = _quantize_sym(w, dim=-1)
    acc = _exact_int8_matmul(wq, codes, transpose=False)
    return acc.to(w.dtype) * (ws * scale[None, :]).to(w.dtype)


def int8_forward_project(codes: Tensor, scale: Tensor, f: Tensor) -> Tensor:
    """``H f`` for ``H = scale * codes``: ``f * scale`` [B, V] is quantized
    per row, the contraction is exact, and the result is ``acc * ys``."""
    yq, ys = _quantize_sym(f * scale[None, :], dim=-1)
    acc = _exact_int8_matmul(yq, codes, transpose=True)
    return acc.to(f.dtype) * ys.to(f.dtype)
