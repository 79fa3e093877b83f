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

The scheduled log update (``relaxation_decay != 1``) takes its exponent per
batch row: ``alpha_lane`` ``[1, 1]`` or ``[B, 1]`` in place of ``alpha``, and
then the power is taken for every exponent, 1 included, as the JAX
scheduled closure takes it (``models/sart.py:_log_update`` with its
``[1|B, V]`` α panel). The kernel reads one value per row.

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

- ``"one_read"``: ``B <= ONE_READ_MAX_B[storage]`` (fp32 8, bf16 and int8
  4), ``ONE_READ_MIN_P[storage] <= P <= ONE_READ_MAX_P`` and ``V`` a multiple
  of ``ONE_READ_V_MULTIPLE[storage]`` (16 fp32, 32 bf16 or 64 int8 columns:
  a panel 64 bytes wide; H read once, the panel split over a thread-block
  cluster);
- ``"tensor_core"``: bf16 or int8 storage at ``B >=
  TENSOR_CORE_MIN_B[storage]`` (past ``one_read``'s B, so the two never
  compete) and ``V`` a multiple of ``TENSOR_CORE_V_MULTIPLE`` (the bf16
  tensor cores with the fp32 vectors split exactly into three bf16 pieces);
- ``"two_read"``: everything else (two passes, each reading H once for up
  to 32 batch rows: a tile of H in shared memory serves every batch row in
  the bp pass, and the forward pass keeps the operand in shared memory; the
  splits of P and V, so every row's order of summation, follow from the
  shape alone, never from B).

A plan runs wherever its preconditions (:func:`plan_refusal`) hold; the
rule takes a new plan only where it was measured faster than ``two_read``.
A plan whose preconditions fail is refused, never replaced by another.
:func:`_sweep` forces a plan (tests and ``chip_smoke.py`` time the old path
beside the new one with it).

A rank of a pixel-sharded grid runs the sweep split at its all-reduce
(:func:`sharded_sweep_bp`, then :func:`sharded_sweep_finish`), on the
route :func:`split_route` gives: ``"cluster"`` (one kernel a call, the
splits' sums met in a thread-block cluster) where ``B <= SPLIT_MAX_B``,
H's rows are whole 16 bytes and two_read's splits of P number at most
``SPLIT_MAX_ROW_SPLITS``; ``"two_read"``'s kernels (three a call)
elsewhere. Both sum in two_read's order: at one rank the pair gives
``two_read``'s bytes.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from sartsolver_tpu_torch.analysis.registry import opaque as _audit_opaque

# storage dtype -> the kernel's storage code
STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# plan -> the kernel's plan code
PLANS = {"two_read": 0, "one_read": 1, "tensor_core": 2}

# one_read: a panel of 64-byte row segments split over a cluster of 8 blocks,
# at most 1024 rows a block (the slabs' shared memory); at most 8 batch rows
# for fp32 (its slabs and weights in shared memory) and 4 for bf16 and int8
# (their larger B goes to tensor_core); V in whole panels. The rule takes it
# from the smallest P at which it beat two_read at every B of its range in
# every call on the H100 at V = 65536 (PERF.md, the crossover tables)
ONE_READ_MAX_P = 8 * 1024
ONE_READ_MAX_B = {"float32": 8, "bfloat16": 4, "int8": 4}
ONE_READ_V_MULTIPLE = {"float32": 16, "bfloat16": 32, "int8": 64}
ONE_READ_MIN_P = {"float32": 4 * 1024, "bfloat16": 4 * 1024, "int8": 2 * 1024}
# tensor_core: from this batch size on it beats two_read at 8192 x 65536 on
# the H100 (PERF.md, the crossover tables); V in whole 16-element runs
# (aligned 16-byte loads of a row)
TENSOR_CORE_MIN_B = {"bfloat16": 5, "int8": 5}
TENSOR_CORE_V_MULTIPLE = 16

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]  # H, storage, scale
    + [ctypes.c_void_p] * 5        # w, f, aux0, aux1, aux2
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]  # aux_rows, n_aux
    + [ctypes.c_void_p] * 2        # f_new, fitted
    + [ctypes.c_longlong] * 3      # P, V, B
    + [ctypes.c_int, ctypes.c_float, ctypes.c_float]  # mode, alpha, eps
    + [ctypes.c_void_p, ctypes.c_longlong]  # alpha_lane, its rows
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
        multiple, most = ONE_READ_V_MULTIPLE[storage], ONE_READ_MAX_B[storage]
        if B > most or P > ONE_READ_MAX_P or V % multiple:
            return (f"one_read needs B <= {most}, P <= {ONE_READ_MAX_P} "
                    f"and V a multiple of {multiple} for {storage} "
                    f"(B={B}, P={P}, V={V})")
    elif plan == "tensor_core":
        if storage not in TENSOR_CORE_MIN_B:
            return f"{plan} takes bf16 or int8 storage, not {storage}"
        if V % TENSOR_CORE_V_MULTIPLE:
            return f"{plan} needs V a multiple of {TENSOR_CORE_V_MULTIPLE} (V={V})"
    return None


def plan_sweep(P: int, V: int, B: int, storage: str) -> str:
    """The plan a call of this shape and storage runs on the card."""
    if P >= ONE_READ_MIN_P[storage] and plan_refusal("one_read", P, V, B, storage) is None:
        return "one_read"
    if (B >= TENSOR_CORE_MIN_B.get(storage, B + 1)
            and plan_refusal("tensor_core", P, V, B, storage) is None):
        return "tensor_core"
    return "two_read"


def _update_reference(f: Tensor, bp: Tensor, aux: Sequence[Tensor], *,
                      logarithmic: bool, alpha: float, eps: float,
                      alpha_lane: Optional[Tensor] = None) -> Tensor:
    """The update rules of ``models/sart.py:_lin_update/_log_update``."""
    if logarithmic:
        vm, obs, *pen = aux
        ratio = (obs + eps) / (bp * vm + eps)
        if alpha_lane is not None:
            ratio = ratio ** alpha_lane
        elif alpha != 1.0:
            ratio = ratio ** alpha
        out = f * ratio
        return out * torch.exp(-pen[0]) if pen else out
    invd, *pen = aux
    upd = f + invd * bp
    if pen:
        upd = upd - pen[0]
    return torch.clamp_min(upd, 0)


# rows and columns of H a block of the plain version's products
REFERENCE_BLOCK = 8192


def _blocks(n: int):
    return [slice(s, min(s + REFERENCE_BLOCK, n)) for s in range(0, n, REFERENCE_BLOCK)]


def fused_sweep_reference(rtm: Tensor, w: Tensor, f: Tensor,
                          aux: Sequence[Tensor], *, logarithmic: bool,
                          alpha: float = 1.0, eps: float = 0.0,
                          scale: Optional[Tensor] = None,
                          alpha_lane: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the sweep, over panels of at most
    ``REFERENCE_BLOCK`` voxel columns as the TPU kernel walks its panels:
    each panel's bp (its products summed over blocks of ``REFERENCE_BLOCK``
    pixel rows, in order), update and forward product, the panels' forward
    products summed in order. No sum a matrix product takes is longer than
    one block (a library's single long fp32 chain drifts from the exact sum
    as it grows), and a matrix stored in another dtype is upcast a panel at a
    time (exact for bf16 and int8 codes). A matrix of one block in each
    direction takes one product each way. Any device, any float dtype of the
    operands."""
    P, V = rtm.shape
    f_new = torch.empty(f.shape, dtype=w.dtype, device=w.device)
    fitted = None
    for c in _blocks(V):
        Hc = rtm[:, c].to(w.dtype)
        bp = None
        for r in _blocks(P):
            part = w[:, r] @ Hc[r]
            bp = part if bp is None else bp + part
        if scale is not None:
            bp = bp * scale[:, c]
        fc = _update_reference(f[:, c], bp, [a[:, c] for a in aux], logarithmic=logarithmic,
                               alpha=alpha, eps=eps, alpha_lane=alpha_lane)
        f_new[:, c] = fc
        part = (fc if scale is None else fc * scale[:, c]) @ Hc.T
        fitted = part if fitted is None else fitted + part
    return f_new, fitted


def _check(rtm: Tensor, w: Optional[Tensor], f: Tensor, aux: Sequence[Tensor],
           logarithmic: bool, scale: Optional[Tensor],
           alpha_lane: Optional[Tensor] = None) -> None:
    if rtm.ndim != 2 or (w is not None and w.ndim != 2) or f.ndim != 2:
        raise ValueError("fused_sweep: rtm [P, V], w [B, P] and f [B, V] expected.")
    P, V = rtm.shape
    B = f.shape[0]
    if B < 1 or (w is not None and w.shape != (B, P)) or f.shape != (B, V):
        raise ValueError(
            f"fused_sweep: shapes rtm {tuple(rtm.shape)}, w "
            f"{None if w is None else tuple(w.shape)}, f {tuple(f.shape)} do not agree."
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
    if alpha_lane is not None:
        if not logarithmic:
            raise ValueError("fused_sweep: alpha_lane is the log update's exponent; "
                             "the linear update folds its step into w.")
        if alpha_lane.shape not in ((1, 1), (B, 1)):
            raise ValueError(f"fused_sweep: alpha_lane of shape {tuple(alpha_lane.shape)}; "
                             f"[1, 1] or [{B}, 1] expected.")
    tensors = ((rtm, f, *aux) + (() if w is None else (w,))
               + (() if scale is None else (scale,))
               + (() if alpha_lane is None else (alpha_lane,)))
    if any(t.device != rtm.device for t in tensors):
        raise ValueError("fused_sweep: all tensors must be on one device.")
    if rtm.dtype not in STORAGE or any(t.dtype != torch.float32 for t in tensors[1:]):
        raise ValueError(
            "fused_sweep: fp32, bf16 or int8 storage and fp32 operands only, "
            f"got {[str(t.dtype) for t in tensors]}."
        )


@_audit_opaque("fused_sweep")
def fused_sweep(rtm: Tensor, w: Tensor, f: Tensor, aux: Sequence[Tensor], *,
                logarithmic: bool, alpha: float = 1.0, eps: float = 0.0,
                scale: Optional[Tensor] = None, alpha_lane: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """One fused sweep; see the module docstring. On the card it runs the
    plan :func:`plan_sweep` gives (the exponent ``alpha_lane`` changes no
    plan). ``fused_sweep.launches`` counts the kernel launches,
    ``fused_sweep.launches_by_storage`` the same launches by the matrix's
    dtype, ``fused_sweep.launches_by_plan`` by plan and
    ``fused_sweep.scheduled_by_plan`` the launches with ``alpha_lane`` by
    plan (CPU calls of the plain version do not count)."""
    return _sweep(rtm, w, f, aux, logarithmic=logarithmic, alpha=alpha, eps=eps,
                  scale=scale, alpha_lane=alpha_lane)


def _sweep(rtm: Tensor, w: Tensor, f: Tensor, aux: Sequence[Tensor], *,
           logarithmic: bool, alpha: float = 1.0, eps: float = 0.0,
           scale: Optional[Tensor] = None, plan: Optional[str] = None,
           alpha_lane: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """:func:`fused_sweep` with the plan forced (None: :func:`plan_sweep`'s);
    raises ValueError where the plan's preconditions fail (on any device)
    and RuntimeError where the kernel refuses or fails."""
    _check(rtm, w, f, aux, logarithmic, scale, alpha_lane)
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
                                     alpha=alpha, eps=eps, scale=scale,
                                     alpha_lane=alpha_lane)
    if rtm.device.type != "cuda":
        raise ValueError(f"fused_sweep: unsupported device {rtm.device}.")
    err, f_new, fitted = _kernel_call(rtm, w, f, aux, logarithmic=logarithmic,
                                      alpha=alpha, eps=eps, scale=scale,
                                      plan_code=PLANS[plan], alpha_lane=alpha_lane)
    if err != 0:
        raise RuntimeError(
            f"fused_sweep: CUDA kernel (plan {plan}) failed with cudaError_t {err}."
        )
    fused_sweep.launches += 1
    fused_sweep.launches_by_storage[storage] += 1
    fused_sweep.launches_by_plan[plan] += 1
    if alpha_lane is not None:
        fused_sweep.scheduled_by_plan[plan] += 1
    return f_new, fitted


def _kernel_call(rtm: Tensor, w: Tensor, f: Tensor, aux: Sequence[Tensor], *,
                 logarithmic: bool, alpha: float, eps: float,
                 scale: Optional[Tensor], plan_code: int,
                 alpha_lane: Optional[Tensor] = None) -> Tuple[int, Tensor, Tensor]:
    """One call of the C entry point with CUDA tensors; returns its
    cudaError_t beside the outputs. The C side checks the plan itself."""
    tensors = ((rtm, w, f, *aux) + (() if scale is None else (scale,))
               + (() if alpha_lane is None else (alpha_lane,)))
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
    nbytes = max(int(size_fn(plan_code, P, V, B)), 0)
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
                 1 if logarithmic else 0, float(alpha), float(eps),
                 None if alpha_lane is None else alpha_lane.data_ptr(),
                 1 if alpha_lane is None else alpha_lane.shape[0], plan_code,
                 None if scratch is None else scratch.data_ptr(), nbytes, stream)
    return err, f_new, fitted


def reset_launch_counts() -> None:
    """Set every launch count of :func:`fused_sweep` to 0."""
    fused_sweep.launches = 0
    fused_sweep.launches_by_storage = {_storage_name(dt): 0 for dt in STORAGE}
    fused_sweep.launches_by_plan = {plan: 0 for plan in PLANS}
    fused_sweep.scheduled_by_plan = {plan: 0 for plan in PLANS}


reset_launch_counts()


# ---- the pixel-sharded sweep, split at the all-reduce ------------------------

# The split sweep's routes: two_read's kernels (three CUDA kernels a call:
# bp: the transpose of w, bp, the sum of its splits; finish: the update,
# the forward pass, the sum of its splits) or the cluster route (one kernel
# a call each). Both sum in two_read's order and give the same bytes.
SPLIT_ROUTES = {"two_read": 0, "cluster": 1}
SPLIT_KERNELS_PER_CALL = {"two_read": 3, "cluster": 1}
# the cluster route: at most 4 batch rows, H's rows 16-byte aligned (its
# tensor maps' row stride) and two_read's splits of P no more than a thread-block
# cluster holds (they meet through its distributed shared memory)
SPLIT_MAX_B = 4
SPLIT_MAX_ROW_SPLITS = 8
# two_read's splits of P (csrc/fused_sweep.cu:tr_shape): blocks of 256
# columns on the H100's 132 SMs, 256 to 4096 rows a split in steps of 64
_SMS = 132
_SPLIT_COLS, _MIN_SPLIT_ROWS, _MAX_SPLIT_ROWS = 256, 256, 4096


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pick_splits(units: int, most: int) -> int:
    """csrc/fused_sweep.cu:pick_splits: the split count for ``units`` blocks
    a split, at most ``most``: the smallest that fills the SMs at least 1.5
    blocks deep with at most a tenth of them idle in the last round, else
    the one that idles the fewest."""
    best, best_use = 1, 0.0
    for s in range(1, min(most, 64) + 1):
        rounds = units * s / _SMS
        use = rounds / math.ceil(rounds)
        if rounds >= 1.5 and use >= 0.9:
            return s
        if use > best_use:
            best, best_use = s, use
    return best


def split_row_splits(P: int, V: int) -> int:
    """two_read's splits of P at this shape (``tr_shape``'s S): the sums of
    bp meet in their order whatever the route."""
    want = max(_pick_splits(_ceil_div(V, _SPLIT_COLS), _ceil_div(P, _MIN_SPLIT_ROWS)),
               _ceil_div(P, _MAX_SPLIT_ROWS))
    rows = min(_ceil_div(_ceil_div(P, want), 64) * 64, P)
    return _ceil_div(P, rows)


def split_route(P: int, V: int, B: int, storage: str) -> str:
    """The route a call of the split sweep takes on the card at this shape
    and storage (``"float32"``, ``"bfloat16"`` or ``"int8"``), a fixed rule:
    ``"cluster"`` where ``B <= SPLIT_MAX_B``, a row of H is a multiple of 16
    bytes and two_read's splits of P number at most
    ``SPLIT_MAX_ROW_SPLITS``; ``"two_read"`` elsewhere. The kernel refuses
    the cluster route where these fail (and where H itself is not 16-byte
    aligned); it never takes the other in its place."""
    itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[storage]
    if (B <= SPLIT_MAX_B and V * itemsize % 16 == 0
            and split_row_splits(P, V) <= SPLIT_MAX_ROW_SPLITS):
        return "cluster"
    return "two_read"


def sharded_sweep_bp_reference(rtm: Tensor, w: Tensor) -> Tensor:
    """Plain version of :func:`sharded_sweep_bp`: ``w @ H`` ``[B, V]`` over
    the panels and row blocks :func:`fused_sweep_reference` takes, unscaled
    (for int8 codes the codes' sums)."""
    P, V = rtm.shape
    bp = torch.empty((w.shape[0], V), dtype=w.dtype, device=w.device)
    for c in _blocks(V):
        Hc = rtm[:, c].to(w.dtype)
        acc = None
        for r in _blocks(P):
            part = w[:, r] @ Hc[r]
            acc = part if acc is None else acc + part
        bp[:, c] = acc
    return bp


def sharded_sweep_finish_reference(rtm: Tensor, f: Tensor, bp: Tensor,
                                   aux: Sequence[Tensor], *, logarithmic: bool,
                                   alpha: float = 1.0, eps: float = 0.0,
                                   scale: Optional[Tensor] = None,
                                   alpha_lane: Optional[Tensor] = None
                                   ) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`sharded_sweep_finish`: per panel, the reduced
    ``bp`` (times ``scale`` for int8 codes), the update and the forward
    product of the rank's rows, the panels' products summed in order. With
    :func:`sharded_sweep_bp_reference` before it and nothing between, it
    is :func:`fused_sweep_reference` op for op."""
    V = rtm.shape[1]
    f_new = torch.empty(f.shape, dtype=f.dtype, device=f.device)
    fitted = None
    for c in _blocks(V):
        Hc = rtm[:, c].to(f.dtype)
        bpc = bp[:, c] if scale is None else bp[:, c] * scale[:, c]
        fc = _update_reference(f[:, c], bpc, [a[:, c] for a in aux], logarithmic=logarithmic,
                               alpha=alpha, eps=eps, alpha_lane=alpha_lane)
        f_new[:, c] = fc
        part = (fc if scale is None else fc * scale[:, c]) @ Hc.T
        fitted = part if fitted is None else fitted + part
    return f_new, fitted


def _sharded_lib():
    from sartsolver_tpu_torch.ops import _build

    lib = _build.load("fused_sweep")
    if lib.sart_sharded_bp.argtypes is None:  # once per loaded library
        lib.sart_sharded_scratch_bytes.argtypes = [ctypes.c_int] * 2 + [ctypes.c_longlong] * 3
        lib.sart_sharded_scratch_bytes.restype = ctypes.c_longlong
        lib.sart_split_route_ok.argtypes = [ctypes.c_int] + [ctypes.c_longlong] * 3
        lib.sart_split_route_ok.restype = ctypes.c_int
        lib.sart_split_counters.argtypes = [ctypes.c_longlong]
        lib.sart_split_counters.restype = ctypes.c_longlong
        lib.sart_sharded_bp.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_longlong] * 3
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
        lib.sart_sharded_bp.restype = ctypes.c_int
        lib.sart_sharded_finish.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int] + [ctypes.c_void_p] * 2
            + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_float]
            + [ctypes.c_void_p, ctypes.c_longlong]        # alpha_lane, its rows
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]  # route, counters, count
            + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
        lib.sart_sharded_finish.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _split_plan(P: int, V: int, B: int, storage: str) -> Tuple[str, int, int, int]:
    """A shape's route, the bp and finish calls' bytes of scratch on it
    (each a multiple of 256) and the finish's row-block counters: fixed by
    the shape, so asked of the library once."""
    route = split_route(P, V, B, storage)
    lib, code = _sharded_lib(), SPLIT_ROUTES[route]
    return (route, max(int(lib.sart_sharded_scratch_bytes(0, code, P, V, B)), 0),
            max(int(lib.sart_sharded_scratch_bytes(1, code, P, V, B)), 0),
            int(lib.sart_split_counters(P)) if route == "cluster" else 0)


def _raw_stream(device) -> int:
    """The device's current CUDA stream as the handle the C entry points
    take (PyTorch's raw accessor where its build has one)."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(torch.cuda.current_device() if device.index is None else device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _on_device(device):
    """The device's context, entered only where it is not current already."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


# the cluster route's row-block counters, zero between calls (each call
# leaves them zero), per device and stream: calls on one stream run in turn
_split_counters: dict = {}


def _counters(need: int, device, stream: int) -> Tensor:
    buf = _split_counters.get((device, stream))
    if buf is None or buf.numel() < need:
        buf = torch.zeros(max(need, 1024), dtype=torch.int32, device=device)
        _split_counters[(device, stream)] = buf
    return buf


@_audit_opaque("sharded_sweep_bp")
def sharded_sweep_bp(rtm: Tensor, w: Tensor) -> Tensor:
    """The first call of the pixel-sharded sweep: this rank's partial back
    projection ``w @ H`` ``[B, V]`` of its block ``H`` ``[P, V]`` (fp32,
    bf16 or int8 codes, unscaled: the codes' sums). The caller sums it over
    the grid's pixel axis (``parallel/comm.py:all_reduce_sum``) and hands
    the sum to :func:`sharded_sweep_finish`.

    On CUDA tensors it launches ``csrc/fused_sweep.cu:sart_sharded_bp`` on
    the route :func:`split_route` gives (``"cluster"``: one kernel, the
    block streamed once in TMA boxes and the splits' sums met in a
    thread-block cluster; ``"two_read"``: two_read's bp pass, the block read
    once for up to 32 batch rows) or raises; on CPU tensors it runs
    :func:`sharded_sweep_bp_reference`. ``sharded_sweep_bp.launches`` counts
    the launches, ``launches_by_route`` by route.

    Where the JAX panel scan (``sartsolver_tpu/ops/fused_sweep.py:270``)
    all-reduces each voxel panel's bp inside one read of the block, this
    sweep reduces once an iteration and reads the block twice (here and in
    the finish): one collective an iteration, none overlapped with the
    products."""
    if rtm.ndim != 2 or w.ndim != 2 or w.shape[1] != rtm.shape[0] or w.shape[0] < 1:
        raise ValueError(f"sharded_sweep_bp: shapes rtm {tuple(rtm.shape)} and w "
                         f"{tuple(w.shape)} do not agree.")
    if rtm.dtype not in STORAGE or w.dtype != torch.float32 or w.device != rtm.device:
        raise ValueError("sharded_sweep_bp: fp32, bf16 or int8 storage and an fp32 w on "
                         f"its device, got {rtm.dtype} / {w.dtype} on {w.device}.")
    if rtm.device.type == "cpu":
        return sharded_sweep_bp_reference(rtm, w)
    if rtm.device.type != "cuda":
        raise ValueError(f"sharded_sweep_bp: unsupported device {rtm.device}.")
    if not (rtm.is_contiguous() and w.is_contiguous()):
        raise ValueError("sharded_sweep_bp: the CUDA kernel needs contiguous tensors.")
    P, V = rtm.shape
    B = w.shape[0]
    route, nbytes, _, _ = _split_plan(P, V, B, _storage_name(rtm.dtype))
    lib = _sharded_lib()
    bp = torch.empty((B, V), dtype=torch.float32, device=rtm.device)
    # the caching allocator hands out 512-byte aligned blocks
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=rtm.device) if nbytes else None
    with _on_device(rtm.device):
        err = lib.sart_sharded_bp(rtm.data_ptr(), STORAGE[rtm.dtype], w.data_ptr(),
                                  bp.data_ptr(), P, V, B, SPLIT_ROUTES[route],
                                  None if scratch is None else scratch.data_ptr(), nbytes,
                                  _raw_stream(rtm.device))
    if err != 0:
        raise RuntimeError(f"sharded_sweep_bp: CUDA kernel ({route}) failed with "
                           f"cudaError_t {err}.")
    sharded_sweep_bp.launches += 1
    sharded_sweep_bp.launches_by_route[route] += 1
    return bp


@_audit_opaque("sharded_sweep_finish")
def sharded_sweep_finish(rtm: Tensor, f: Tensor, bp: Tensor, aux: Sequence[Tensor], *,
                         logarithmic: bool, alpha: float = 1.0, eps: float = 0.0,
                         scale: Optional[Tensor] = None,
                         alpha_lane: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The second call of the pixel-sharded sweep: from the back projection
    ``bp`` ``[B, V]`` reduced over the pixel axis, ``(f_new [B, V], fitted
    [B, P])`` — the update of :func:`fused_sweep` (``bp`` rounded times
    ``scale`` first for int8 codes) and the forward product of this rank's
    rows, complete for them (a voxel-sharded grid still sums it over the
    voxel axis).

    On CUDA tensors it launches ``csrc/fused_sweep.cu:sart_sharded_finish``
    on the route :func:`split_route` gives (``"cluster"``: one kernel, the
    update shared through a thread-block cluster's shared memory and the
    forward pass; ``"two_read"``: two_read's finish and forward pass) or
    raises; on CPU tensors it runs :func:`sharded_sweep_finish_reference`.
    ``sharded_sweep_finish.launches`` counts the launches,
    ``launches_by_route`` by route."""
    B = f.shape[0]
    if bp.shape != f.shape:
        raise ValueError(f"sharded_sweep_finish: bp {tuple(bp.shape)} and f "
                         f"{tuple(f.shape)} must agree.")
    _check(rtm, None, f, aux, logarithmic, scale, alpha_lane)
    if bp.dtype != torch.float32 or bp.device != rtm.device:
        raise ValueError("sharded_sweep_finish: bp must be fp32 on the matrix's device.")
    if rtm.device.type == "cpu":
        return sharded_sweep_finish_reference(rtm, f, bp, aux, logarithmic=logarithmic,
                                              alpha=alpha, eps=eps, scale=scale,
                                              alpha_lane=alpha_lane)
    if rtm.device.type != "cuda":
        raise ValueError(f"sharded_sweep_finish: unsupported device {rtm.device}.")
    tensors = ((rtm, f, bp, *aux) + (() if scale is None else (scale,))
               + (() if alpha_lane is None else (alpha_lane,)))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sharded_sweep_finish: the CUDA kernel needs contiguous tensors.")
    P, V = rtm.shape
    route, _, nbytes, n_counters = _split_plan(P, V, B, _storage_name(rtm.dtype))
    lib = _sharded_lib()
    # one block: the scratch (256-byte aligned at the start of a 512-byte
    # aligned block), then f_new and fitted
    block = torch.empty(nbytes // 4 + B * (V + P), dtype=torch.float32, device=rtm.device)
    scratch = block[:nbytes // 4] if nbytes else None
    f_new = block[nbytes // 4:nbytes // 4 + B * V].view(B, V)
    fitted = block[nbytes // 4 + B * V:].view(B, P)
    ptrs = [a.data_ptr() for a in aux] + [None] * (3 - len(aux))
    rows = (ctypes.c_longlong * 3)(*([a.shape[0] for a in aux] + [1] * (3 - len(aux))))
    with _on_device(rtm.device):
        stream = _raw_stream(rtm.device)
        counters = _counters(n_counters, rtm.device, stream) if n_counters else None
        err = lib.sart_sharded_finish(
            rtm.data_ptr(), STORAGE[rtm.dtype], None if scale is None else scale.data_ptr(),
            f.data_ptr(), bp.data_ptr(), *ptrs, rows, len(aux), f_new.data_ptr(),
            fitted.data_ptr(), P, V, B, 1 if logarithmic else 0, float(alpha), float(eps),
            None if alpha_lane is None else alpha_lane.data_ptr(),
            1 if alpha_lane is None else alpha_lane.shape[0], SPLIT_ROUTES[route],
            None if counters is None else counters.data_ptr(),
            0 if counters is None else counters.numel(),
            None if scratch is None else scratch.data_ptr(), nbytes, stream)
    if err != 0:
        raise RuntimeError(f"sharded_sweep_finish: CUDA kernel ({route}) failed with "
                           f"cudaError_t {err}.")
    sharded_sweep_finish.launches += 1
    sharded_sweep_finish.launches_by_route[route] += 1
    return f_new, fitted


def reset_sharded_launch_counts() -> None:
    """Set the split sweep's launch counts to 0."""
    for wrapper in (sharded_sweep_bp, sharded_sweep_finish):
        wrapper.launches = 0
        wrapper.launches_by_route = dict.fromkeys(SPLIT_ROUTES, 0)


reset_sharded_launch_counts()


# ---- launch-audit registration (analysis/registry.py) -----------------------
# The JAX package's fused entries (sartsolver_tpu/ops/fused_sweep.py:925-1010):
# the loop with every iteration one call of the fused sweep.

from sartsolver_tpu_torch.analysis.registry import (  # noqa: E402
    register_audit_entry as _register_audit_entry,
)


@_register_audit_entry(
    "fused_sweep",
    description="the loop through the fused sweep, one call an iteration (the "
                "context's storage: fp32 by default)",
    hand_launches={"fused_sweep": 1},
)
def _audit_fused_sweep(ctx):
    from sartsolver_tpu_torch.config import SolverOptions

    return ctx.batch_runner(SolverOptions(fused_sweep="on"), storage=ctx.storage)


@_register_audit_entry(
    "sparse_panel_sweep",
    description="block-sparse loop at 50% tile-column occupancy: the fused sweep "
                "on the compacted matrix, fp32",
    hand_launches={"fused_sweep": 1},
)
def _audit_sparse_panel_sweep(ctx):
    from sartsolver_tpu_torch.config import SolverOptions

    return ctx.batch_runner(SolverOptions(sparse_rtm="auto"), sparse=True)


@_register_audit_entry(
    "int8_fused_sweep",
    description="int8-quantized fused sweep (per-voxel-scaled codes), one call an "
                "iteration",
    # the codes are dequantized inside the kernel; only a copy of the
    # matrix would erase the 4x bandwidth win, so converts go unbudgeted
    # (as the JAX entry's)
    loop_convert_threshold=None,
    hand_launches={"fused_sweep": 1},
)
def _audit_int8_fused_sweep(ctx):
    from sartsolver_tpu_torch.config import SolverOptions

    return ctx.batch_runner(SolverOptions(fused_sweep="on"), storage="int8")
