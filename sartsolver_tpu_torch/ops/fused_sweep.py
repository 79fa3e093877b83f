"""The fused SART sweep: wrapper, plain PyTorch version and launch counts.

Counterpart of ``sartsolver_tpu/ops/fused_sweep.py:fused_sweep``. One call
returns ``(f_new [B, V], fitted [B, P])`` for

    bp     = w @ H            (times ``scale`` for int8 codes)
    f_new  = update(f, bp, aux...)
    fitted = f_new @ H^T      (f_new times ``scale`` for int8 codes)

where ``update`` is one of the two SART rules of ``models/sart.py``:

- linear (``logarithmic=False``): ``max(f + invd * bp - pen, 0)``, with
  ``aux = [invd]`` or ``[invd, pen]``;
- logarithmic: ``f * ((obs + eps) / (bp * vm + eps)) ** alpha * exp(-pen)``
  (the power skipped when ``alpha == 1``), with ``aux = [vm, obs]`` or
  ``[vm, obs, pen]``.

Each aux panel is ``[1, V]`` (broadcast over the batch) or ``[B, V]``.

``H`` is stored as fp32, bf16 or int8 codes; each element is upcast
exactly and all arithmetic is fp32. int8 codes come with ``scale`` ``[1, V]``
(``H = scale * codes``, the JAX kernel's ``fwd_scale`` aux panel): ``bp`` is
summed over the codes and rounded times ``scale`` before the update, and
the forward operand is ``f_new * scale`` rounded, as the JAX update closures
round them.

On CUDA tensors :func:`fused_sweep` launches the hand-written kernel
(``csrc/fused_sweep.cu``) or raises; on CPU tensors it runs
:func:`fused_sweep_reference`, the same function in plain PyTorch. It never
falls back from the kernel to the plain version. Either way its operands
are fp32; the plain version itself takes any float dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

# storage dtype -> the kernel's storage code
STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]  # H, storage, scale
    + [ctypes.c_void_p] * 5        # w, f, aux0, aux1, aux2
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]  # aux_rows, n_aux
    + [ctypes.c_void_p] * 2        # f_new, fitted
    + [ctypes.c_longlong] * 3      # P, V, B
    + [ctypes.c_int, ctypes.c_float, ctypes.c_float]  # mode, alpha, eps
    + [ctypes.c_void_p]            # stream
)


def _update_reference(f: Tensor, bp: Tensor, aux: Sequence[Tensor], *,
                      logarithmic: bool, alpha: float, eps: float) -> Tensor:
    """The update rules of ``models/sart.py:_lin_update/_log_update``."""
    if logarithmic:
        vm, obs, *pen = aux
        ratio = (obs + eps) / (bp * vm + eps)
        if alpha != 1.0:
            ratio = ratio ** alpha
        out = f * ratio
        return out * torch.exp(-pen[0]) if pen else out
    invd, *pen = aux
    upd = f + invd * bp
    if pen:
        upd = upd - pen[0]
    return torch.clamp_min(upd, 0)


def fused_sweep_reference(rtm: Tensor, w: Tensor, f: Tensor,
                          aux: Sequence[Tensor], *, logarithmic: bool,
                          alpha: float = 1.0, eps: float = 0.0,
                          scale: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the sweep: two matrix products around the
    update. Any device, any float dtype of the operands; a matrix stored in
    another dtype is upcast whole first (exact for bf16 and int8 codes)."""
    H = rtm.to(w.dtype)
    bp = w @ H
    if scale is not None:
        bp = bp * scale
    f_new = _update_reference(f, bp, aux, logarithmic=logarithmic,
                              alpha=alpha, eps=eps)
    fwd = f_new if scale is None else f_new * scale
    return f_new, fwd @ H.T


def _check(rtm: Tensor, w: Tensor, f: Tensor, aux: Sequence[Tensor],
           logarithmic: bool, scale: Optional[Tensor]) -> None:
    if rtm.ndim != 2 or w.ndim != 2 or f.ndim != 2:
        raise ValueError("fused_sweep: rtm [P, V], w [B, P] and f [B, V] expected.")
    P, V = rtm.shape
    B = w.shape[0]
    if B < 1 or w.shape != (B, P) or f.shape != (B, V):
        raise ValueError(
            f"fused_sweep: shapes rtm {tuple(rtm.shape)}, w {tuple(w.shape)}, "
            f"f {tuple(f.shape)} do not agree."
        )
    want = 2 if logarithmic else 1
    if len(aux) not in (want, want + 1):
        raise ValueError(
            f"fused_sweep: {want} aux panel(s) plus an optional penalty "
            f"expected, {len(aux)} given."
        )
    for a in aux:
        if a.ndim != 2 or a.shape[1] != V or a.shape[0] not in (1, B):
            raise ValueError(
                f"fused_sweep: aux panel of shape {tuple(a.shape)}; "
                f"[1, {V}] or [{B}, {V}] expected."
            )
    if (scale is not None) != (rtm.dtype == torch.int8):
        raise ValueError(
            "fused_sweep: int8 codes need their scale, and only int8 codes "
            f"take one (rtm {rtm.dtype}, scale "
            f"{'given' if scale is not None else 'missing'})."
        )
    if scale is not None and scale.shape != (1, V):
        raise ValueError(
            f"fused_sweep: scale of shape {tuple(scale.shape)}; [1, {V}] expected."
        )
    tensors = (rtm, w, f, *aux) + (() if scale is None else (scale,))
    if any(t.device != rtm.device for t in tensors):
        raise ValueError("fused_sweep: all tensors must be on one device.")
    if rtm.dtype not in STORAGE or any(t.dtype != torch.float32 for t in tensors[1:]):
        raise ValueError(
            "fused_sweep: fp32, bf16 or int8 storage and fp32 operands only, "
            f"got {[str(t.dtype) for t in tensors]}."
        )


def fused_sweep(rtm: Tensor, w: Tensor, f: Tensor, aux: Sequence[Tensor], *,
                logarithmic: bool, alpha: float = 1.0, eps: float = 0.0,
                scale: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """One fused sweep; see the module docstring. ``fused_sweep.launches``
    counts the kernel launches, ``fused_sweep.launches_by_storage`` the same
    launches by the matrix's dtype (CPU calls of the plain version do not
    count)."""
    _check(rtm, w, f, aux, logarithmic, scale)
    if rtm.device.type == "cpu":
        return fused_sweep_reference(rtm, w, f, aux, logarithmic=logarithmic,
                                     alpha=alpha, eps=eps, scale=scale)
    if rtm.device.type != "cuda":
        raise ValueError(f"fused_sweep: unsupported device {rtm.device}.")
    tensors = (rtm, w, f, *aux) + (() if scale is None else (scale,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_sweep: the CUDA kernel needs contiguous tensors.")
    from sartsolver_tpu_torch.ops import _build

    lib = _build.load("fused_sweep")
    fn = lib.sart_fused_sweep
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    P, V = rtm.shape
    B = w.shape[0]
    f_new = torch.empty((B, V), dtype=torch.float32, device=rtm.device)
    fitted = torch.empty((B, P), dtype=torch.float32, device=rtm.device)
    ptrs = [a.data_ptr() for a in aux] + [None] * (3 - len(aux))
    rows = (ctypes.c_longlong * 3)(*([a.shape[0] for a in aux] + [1] * (3 - len(aux))))
    with torch.cuda.device(rtm.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rtm.data_ptr(), STORAGE[rtm.dtype],
                 None if scale is None else scale.data_ptr(),
                 w.data_ptr(), f.data_ptr(), *ptrs, rows,
                 len(aux), f_new.data_ptr(), fitted.data_ptr(), P, V, B,
                 1 if logarithmic else 0, float(alpha), float(eps), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_sweep: CUDA kernel launch failed with cudaError_t {err}."
        )
    fused_sweep.launches += 1
    fused_sweep.launches_by_storage[str(rtm.dtype).removeprefix("torch.")] += 1
    return f_new, fitted


def reset_launch_counts() -> None:
    """Set every launch count of :func:`fused_sweep` to 0."""
    fused_sweep.launches = 0
    fused_sweep.launches_by_storage = {
        str(dt).removeprefix("torch."): 0 for dt in STORAGE
    }


reset_launch_counts()
