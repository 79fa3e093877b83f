"""The fused SART sweep: wrapper, plain PyTorch version and launch count.

Counterpart of ``sartsolver_tpu/ops/fused_sweep.py:fused_sweep``. One call
returns ``(f_new [B, V], fitted [B, P])`` for

    bp     = w @ H
    f_new  = update(f, bp, aux...)
    fitted = f_new @ H^T

where ``update`` is one of the two SART rules of ``models/sart.py``:

- linear (``logarithmic=False``): ``max(f + invd * bp - pen, 0)``, with
  ``aux = [invd]`` or ``[invd, pen]``;
- logarithmic: ``f * ((obs + eps) / (bp * vm + eps)) ** alpha * exp(-pen)``
  (the power skipped when ``alpha == 1``), with ``aux = [vm, obs]`` or
  ``[vm, obs, pen]``.

Each aux panel is ``[1, V]`` (broadcast over the batch) or ``[B, V]``.

On CUDA tensors :func:`fused_sweep` launches the hand-written kernel
(``csrc/fused_sweep.cu``) or raises; on CPU tensors it runs
:func:`fused_sweep_reference`, the same function in plain PyTorch. It never
falls back from the kernel to the plain version. Either way it takes fp32
tensors only; the plain version itself takes any float dtype.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
from torch import Tensor

_ARGTYPES = (
    [ctypes.c_void_p] * 6          # H, w, f, aux0, aux1, aux2
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
                          alpha: float = 1.0, eps: float = 0.0
                          ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the sweep: two matrix products around the
    update. Any device, any float dtype."""
    bp = w @ rtm
    f_new = _update_reference(f, bp, aux, logarithmic=logarithmic,
                              alpha=alpha, eps=eps)
    return f_new, f_new @ rtm.T


def _check(rtm: Tensor, w: Tensor, f: Tensor, aux: Sequence[Tensor],
           logarithmic: bool) -> None:
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
    tensors = (rtm, w, f, *aux)
    if any(t.device != rtm.device for t in tensors):
        raise ValueError("fused_sweep: all tensors must be on one device.")


def fused_sweep(rtm: Tensor, w: Tensor, f: Tensor, aux: Sequence[Tensor], *,
                logarithmic: bool, alpha: float = 1.0, eps: float = 0.0
                ) -> Tuple[Tensor, Tensor]:
    """One fused sweep; see the module docstring. ``fused_sweep.launches``
    counts the kernel launches (CPU calls of the plain version do not
    count)."""
    _check(rtm, w, f, aux, logarithmic)
    tensors = (rtm, w, f, *aux)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(
            "fused_sweep: fp32 storage and fp32 operands only, got "
            f"{[str(t.dtype) for t in tensors]}."
        )
    if rtm.device.type == "cpu":
        return fused_sweep_reference(rtm, w, f, aux, logarithmic=logarithmic,
                                     alpha=alpha, eps=eps)
    if rtm.device.type != "cuda":
        raise ValueError(f"fused_sweep: unsupported device {rtm.device}.")
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
        err = fn(rtm.data_ptr(), w.data_ptr(), f.data_ptr(), *ptrs, rows,
                 len(aux), f_new.data_ptr(), fitted.data_ptr(), P, V, B,
                 1 if logarithmic else 0, float(alpha), float(eps), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_sweep: CUDA kernel launch failed with cudaError_t {err}."
        )
    fused_sweep.launches += 1
    return f_new, fitted


fused_sweep.launches = 0
