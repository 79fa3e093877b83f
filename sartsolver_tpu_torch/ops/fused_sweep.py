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

Each call on the card runs the plan :func:`plan_sweep` gives its shape and
storage, a fixed rule of arithmetic:

- ``"one_read"``: fp32 storage at ``B <= ONE_READ_MAX_B``,
  ``ONE_READ_MIN_P <= P <= ONE_READ_MAX_P`` and ``V`` a multiple of 16 (H
  read once, a panel split over a thread-block cluster);
- ``"tensor_core"``: int8 codes at ``B >= TENSOR_CORE_MIN_B`` and ``V`` a
  multiple of 16 (the bf16 tensor cores with the fp32 vectors split exactly
  into three bf16 pieces);
- ``"two_read"``: everything else (two launches, H read twice).

A plan runs wherever its preconditions (:func:`plan_refusal`) hold; the
rule takes a new plan only where it was measured faster than ``two_read``.
A plan whose preconditions fail is refused, never replaced by another.
:func:`_sweep` forces a plan (tests and ``chip_smoke.py`` time the old path
beside the new one with it).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

# storage dtype -> the kernel's storage code
STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# plan -> the kernel's plan code
PLANS = {"two_read": 0, "one_read": 1, "tensor_core": 2}

# one_read: a 16-column panel split over a cluster of 8 blocks, at most 1024
# rows a block (the slabs' shared memory), at most 4 batch rows (registers).
# Its fixed cost per panel loses to two_read's second read of H at small P:
# on the H100 at V = 65536 it wins at every B <= 4 from P = 7168 and loses at
# B >= 2 from P = 5120 down (PERF.md, the crossover table)
ONE_READ_MAX_P = 8 * 1024
ONE_READ_MAX_B = 4
ONE_READ_MIN_P = 7 * 1024
# tensor_core: from this batch size on it beats two_read at 8192 x 65536 on
# the H100 (PERF.md, the crossover table)
TENSOR_CORE_MIN_B = 4
# both: V in whole 16-column runs (aligned 16-byte loads of a row)
V_MULTIPLE = 16

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]  # H, storage, scale
    + [ctypes.c_void_p] * 5        # w, f, aux0, aux1, aux2
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]  # aux_rows, n_aux
    + [ctypes.c_void_p] * 2        # f_new, fitted
    + [ctypes.c_longlong] * 3      # P, V, B
    + [ctypes.c_int, ctypes.c_float, ctypes.c_float]  # mode, alpha, eps
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]  # plan, scratch, its bytes
    + [ctypes.c_void_p]            # stream
)


def _storage_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def plan_refusal(plan: str, P: int, V: int, B: int, storage: str) -> Optional[str]:
    """Why ``plan`` cannot run this shape and storage (``storage`` is
    ``"float32"``, ``"bfloat16"`` or ``"int8"``); None where it can."""
    if plan not in PLANS:
        return f"unknown plan {plan!r}; one of {sorted(PLANS)}"
    if plan == "one_read":
        if storage != "float32":
            return f"one_read takes fp32 storage, not {storage}"
        if B > ONE_READ_MAX_B or P > ONE_READ_MAX_P or V % V_MULTIPLE:
            return (f"one_read needs B <= {ONE_READ_MAX_B}, P <= {ONE_READ_MAX_P} "
                    f"and V a multiple of {V_MULTIPLE} (B={B}, P={P}, V={V})")
    elif plan == "tensor_core":
        if storage != "int8":
            return f"{plan} takes int8 codes, not {storage}"
        if V % V_MULTIPLE:
            return f"{plan} needs V a multiple of {V_MULTIPLE} (V={V})"
    return None


def plan_sweep(P: int, V: int, B: int, storage: str) -> str:
    """The plan a call of this shape and storage runs on the card."""
    if storage == "int8" and B >= TENSOR_CORE_MIN_B and V % V_MULTIPLE == 0:
        return "tensor_core"
    if P >= ONE_READ_MIN_P and plan_refusal("one_read", P, V, B, storage) is None:
        return "one_read"
    return "two_read"


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
    """One fused sweep; see the module docstring. On the card it runs the
    plan :func:`plan_sweep` gives. ``fused_sweep.launches`` counts the
    kernel launches, ``fused_sweep.launches_by_storage`` the same launches by
    the matrix's dtype and ``fused_sweep.launches_by_plan`` by plan (CPU
    calls of the plain version do not count)."""
    return _sweep(rtm, w, f, aux, logarithmic=logarithmic, alpha=alpha, eps=eps,
                  scale=scale)


def _sweep(rtm: Tensor, w: Tensor, f: Tensor, aux: Sequence[Tensor], *,
           logarithmic: bool, alpha: float = 1.0, eps: float = 0.0,
           scale: Optional[Tensor] = None, plan: Optional[str] = None
           ) -> Tuple[Tensor, Tensor]:
    """:func:`fused_sweep` with the plan forced (None: :func:`plan_sweep`'s);
    raises ValueError where the plan's preconditions fail (on any device)
    and RuntimeError where the kernel refuses or fails."""
    _check(rtm, w, f, aux, logarithmic, scale)
    P, V = rtm.shape
    B = w.shape[0]
    storage = _storage_name(rtm.dtype)
    if plan is None:
        plan = plan_sweep(P, V, B, storage)
    else:
        why = plan_refusal(plan, P, V, B, storage)
        if why:
            raise ValueError(f"fused_sweep: {why}.")
    if rtm.device.type == "cpu":
        return fused_sweep_reference(rtm, w, f, aux, logarithmic=logarithmic,
                                     alpha=alpha, eps=eps, scale=scale)
    if rtm.device.type != "cuda":
        raise ValueError(f"fused_sweep: unsupported device {rtm.device}.")
    err, f_new, fitted = _kernel_call(rtm, w, f, aux, logarithmic=logarithmic,
                                      alpha=alpha, eps=eps, scale=scale,
                                      plan_code=PLANS[plan])
    if err != 0:
        raise RuntimeError(
            f"fused_sweep: CUDA kernel (plan {plan}) failed with cudaError_t {err}."
        )
    fused_sweep.launches += 1
    fused_sweep.launches_by_storage[storage] += 1
    fused_sweep.launches_by_plan[plan] += 1
    return f_new, fitted


def _kernel_call(rtm: Tensor, w: Tensor, f: Tensor, aux: Sequence[Tensor], *,
                 logarithmic: bool, alpha: float, eps: float,
                 scale: Optional[Tensor], plan_code: int
                 ) -> Tuple[int, Tensor, Tensor]:
    """One call of the C entry point with CUDA tensors; returns its
    cudaError_t beside the outputs. The C side checks the plan itself."""
    tensors = (rtm, w, f, *aux) + (() if scale is None else (scale,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_sweep: the CUDA kernel needs contiguous tensors.")
    from sartsolver_tpu_torch.ops import _build

    lib = _build.load("fused_sweep")
    fn, size_fn = lib.sart_fused_sweep, lib.sart_fused_sweep_scratch_bytes
    if fn.argtypes is None:  # once per loaded library
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        size_fn.argtypes = [ctypes.c_int] + [ctypes.c_longlong] * 3
        size_fn.restype = ctypes.c_longlong
    P, V = rtm.shape
    B = w.shape[0]
    f_new = torch.empty((B, V), dtype=torch.float32, device=rtm.device)
    fitted = torch.empty((B, P), dtype=torch.float32, device=rtm.device)
    # two_read needs no scratch
    nbytes = 0 if plan_code == PLANS["two_read"] else max(int(size_fn(plan_code, P, V, B)), 0)
    # the caching allocator hands out 512-byte aligned blocks
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=rtm.device) if nbytes else None
    ptrs = [a.data_ptr() for a in aux] + [None] * (3 - len(aux))
    rows = (ctypes.c_longlong * 3)(*([a.shape[0] for a in aux] + [1] * (3 - len(aux))))
    with torch.cuda.device(rtm.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rtm.data_ptr(), STORAGE[rtm.dtype],
                 None if scale is None else scale.data_ptr(),
                 w.data_ptr(), f.data_ptr(), *ptrs, rows,
                 len(aux), f_new.data_ptr(), fitted.data_ptr(), P, V, B,
                 1 if logarithmic else 0, float(alpha), float(eps), plan_code,
                 None if scratch is None else scratch.data_ptr(), nbytes, stream)
    return err, f_new, fitted


def reset_launch_counts() -> None:
    """Set every launch count of :func:`fused_sweep` to 0."""
    fused_sweep.launches = 0
    fused_sweep.launches_by_storage = {_storage_name(dt): 0 for dt in STORAGE}
    fused_sweep.launches_by_plan = {plan: 0 for plan in PLANS}


reset_launch_counts()
