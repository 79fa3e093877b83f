"""Constrained SART on one device, in PyTorch.

Counterpart of ``sartsolver_tpu/models/sart.py`` for the one-device dense
solve: the linear (Eq. 2) and logarithmic (Eq. 3) solvers with the optional
Laplacian penalty, the Eq. 4 initial guess, the Eq. 5 stop test and the
Eq. 6 masks. Frames of a batch are independent: each has its own masks,
convergence metric and status, and a converged frame freezes while the rest
go on.

Each loop iteration runs one sweep. With ``fused_sweep`` engaged (fp32
compute, ``"auto"`` or ``"on"``) the sweep is one call of
:func:`~sartsolver_tpu_torch.ops.fused_sweep.fused_sweep` — the hand-written
kernel on CUDA tensors, its plain version on CPU tensors. Otherwise it is the
two-matmul path (the fp64 profile and ``fused_sweep="off"``).

The matrix is stored as fp32, fp64, bf16 or int8 codes with per-voxel
scales (``opts.rtm_dtype``). The fused sweep takes fp32, bf16 and int8; int8
needs it. Outside the loop every projection goes through the context's
``bp_any``/``fp_any`` seams: plain products (upcast block by block for
reduced-precision floats), or the quantized-vector integer projections for
int8, as in the JAX package.

The JAX ``lax.while_loop`` is a Python loop here; the stop test reads one
flag from the device per iteration. So is the JAX ``lax.scan`` of the
warm-start chain (:func:`solve_chain_normalized`). The continuous-batching
stride (:func:`sched_step_normalized`) runs the batched loop's body over
lanes that each start, stop and refill on their own.

Three solver variants ride the same body, each off by default and then
adding no op to it:

- ``relaxation_decay``: iteration k steps by ``relaxation * decay**k``. The
  linear update folds the factor into the pixel weights; the log update
  takes it as its exponent, per frame (the kernel's ``alpha_lane``).
- ``momentum="nesterov"``: the sweep runs at an extrapolated point (FISTA
  with gradient restart); the linear solver extrapolates ``H f`` too, the
  log solver projects the extrapolated point once per iteration.
- ``divergence_recovery``: the in-solve guard. A frame whose iteration goes
  non-finite or explodes is rolled back and its step halved, up to R times,
  then stops ``DIVERGED``; a frame whose input is not finite stops
  ``DIVERGED`` at iteration 0 with a zero solution.

``os_subsets > 1`` replaces the sweep by the ordered-subsets cycle
(:meth:`_SweepContext.run_os_sweep`): each iteration updates against the
interleaved pixel-row subsets ``t::os`` in turn, each with a fresh residual,
then projects the final iterate once in full. Its products are the plain
ones of :mod:`~sartsolver_tpu_torch.ops.os_subsets` on every storage (int8
included, whose codes are upcast exactly a block at a time), and it composes
with the three variants above as the sweep does.

With ``debug_nans=True`` every path checks the values it keeps for NaN at
its step boundaries and raises ``FloatingPointError``
(:mod:`~sartsolver_tpu_torch.debug_nans`).

``opts.integrity`` adds the in-solve ABFT check
(``sartsolver_tpu/models/sart.py:1672-1708``): every iteration holds
``sum(H f)`` — on the fused sweep, the kernel's own ``fitted`` output;
after an OS cycle, its exact full projection — against ``rho . f`` per
frame, and on the two-matmul path ``sum(H^T w)`` against ``lambda . w``,
within :func:`~sartsolver_tpu_torch.resilience.integrity.abft_tolerance`.
A frame that trips freezes on its entering iterate and stops with status
``SDC_DETECTED``; a finite mismatch outranks the divergence guard's
rollback. The tripped frames join ``done``, so the loops still read one
device flag per iteration. Where a record is asked for
(:func:`record_abft_worst`), :func:`abft_worst_ratio` reports the largest
residual over its band the checks saw.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from sartsolver_tpu_torch import debug_nans as nanchk
from sartsolver_tpu_torch.config import (
    DIVERGED,
    MAX_ITERATIONS_EXCEEDED,
    SUCCESS,
    SolverOptions,
)
from sartsolver_tpu_torch.device import check_on, resolve_device
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep
from sartsolver_tpu_torch.ops.laplacian import LaplacianCOO, coo_matvec
from sartsolver_tpu_torch.ops.os_subsets import (
    os_subset_back,
    os_subset_forward,
    os_subset_pixels,
    os_subset_rows,
)
from sartsolver_tpu_torch.ops.projection import (
    _sym_codes,
    _sym_scale,
    back_project,
    forward_project,
    int8_back_project,
    int8_forward_project,
)
from sartsolver_tpu_torch.resilience.failures import SDC_DETECTED

# The JAX package's smallest positive constant (its TPU build emulates fp64
# with fp32 range). Kept although this card has real fp64: the log floors
# and epsilons below must clamp exactly as the reference solver does.
MIN_POSITIVE = 1.2e-37

# The sweep path the most recently built solver loop runs, in the JAX
# package's vocabulary (``sartsolver_tpu/models/sart.py:FUSED_ENGAGEMENT``):
# "compiled" for the CUDA kernel, "plain" for the kernel's plain version
# (CPU tensors, where the JAX package would run its Pallas interpreter),
# "off" for the two-matmul sweep, "os-subset" for the ordered-subsets
# cycle; None before any solve. Observability only: ``--timing`` prints it.
FUSED_ENGAGEMENT = {"last": None}

SweepFn = Callable[..., Tuple[Tensor, Tensor]]

# The largest ABFT residual over its band, per device, over every solve
# with the integrity check built while a record is kept: a device scalar,
# read by abft_worst_ratio (one copy, on demand). Off by default, so the
# check computes its trip bits and nothing else.
_ABFT_WORST: dict = {}
_ABFT_RECORD = {"on": False}


def record_abft_worst(on: bool = True) -> None:
    """Start a new record of the largest ABFT residual over its band
    (``on``), or stop keeping one (the record stays readable). A measure of
    the band's margin for the smoke run and the tests, not part of the
    check."""
    if on:
        _ABFT_WORST.clear()
    _ABFT_RECORD["on"] = bool(on)


def abft_worst_ratio() -> float:
    """The largest ``|s_a - s_b| / (tol * (max(|s_a|, |s_b|) + 1))`` an
    integrity check met on a live frame (a trip is > 1) since
    :func:`record_abft_worst` started the record; 0.0 where none ran."""
    return max((float(t) for t in _ABFT_WORST.values()), default=0.0)


def _note_abft(kit) -> None:
    if kit.integrity and kit.abft_worst is not None:
        dev = kit.abft_worst.device
        prev = _ABFT_WORST.get(dev)
        _ABFT_WORST[dev] = (kit.abft_worst if prev is None
                            else torch.maximum(prev, kit.abft_worst))


class SARTProblem(NamedTuple):
    """Device-resident problem state."""

    rtm: Tensor  # [P, V], opts.rtm_dtype or opts.dtype
    ray_density: Tensor  # [V], per-voxel column sums
    ray_length: Tensor  # [P], per-pixel row sums
    laplacian: Optional[LaplacianCOO]
    # per-voxel dequantization scales of int8 codes (H_ij = rtm_scale[j] *
    # rtm[i, j]); None for float storage
    rtm_scale: Optional[Tensor] = None  # [V], fp32


class SolveResult(NamedTuple):
    solution: Tensor  # [B, V] (or [V] from solve)
    status: Tensor  # int32: SUCCESS / MAX_ITERATIONS_EXCEEDED / DIVERGED
    iterations: Tensor  # int32: completed iterations
    convergence: Tensor  # final Eq. 5 metric C^k


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16, "int8": torch.int8}[name]


def storage_dtype(opts: SolverOptions) -> torch.dtype:
    """The stored matrix's dtype: ``opts.rtm_dtype``, else the compute dtype."""
    return torch_dtype(opts.rtm_dtype or opts.dtype)


def _tiny(value: float) -> float:
    return MIN_POSITIVE if 0.0 < value < MIN_POSITIVE else value


def compute_ray_stats(rtm: Tensor, *, dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """Per-voxel ray density and per-pixel ray length (sartsolver.cpp:38-56)."""
    return rtm.sum(dim=0, dtype=dtype), rtm.sum(dim=1, dtype=dtype)


# int8 x int8 contractions accumulate in int32: |codes| <= 127 on both sides
# bounds the contraction extent at 2^31 / 127^2 (~133k); enforced in
# make_problem.
INT8_MAX_CONTRACTION = (2**31 - 1) // (127 * 127)

# elements of a matrix quantized or reduced at once: its fp32 or int32
# temporaries stay at 64 MiB (a whole-matrix int32 cast of the e2e world's
# codes would be 2 GiB beside their 0.5 GiB)
_CHUNK_ELEMENTS = 1 << 24


def _row_chunks(n_rows: int, n_cols: int):
    step = max(1, _CHUNK_ELEMENTS // max(n_cols, 1))
    return [(r0, min(r0 + step, n_rows)) for r0 in range(0, n_rows, step)]


def quantize_rtm(rtm) -> Tuple[Tensor, Tensor]:
    """Per-voxel (column) symmetric int8 quantization of an RTM, where it
    lies: ``(codes int8 [P, V], scale fp32 [V])`` with ``H ~= scale[None, :]
    * codes`` and ``|codes| <= 127`` — the JAX package's ``quantize_rtm``,
    code for code. Taken a block of rows at a time (the recipe is
    elementwise once the column maxima are known)."""
    x = torch.as_tensor(rtm)
    P, V = x.shape
    amax = torch.zeros(V, dtype=torch.float32, device=x.device)
    for r0, r1 in _row_chunks(P, V):
        amax = torch.maximum(amax, x[r0:r1].float().abs().amax(dim=0))
    scale = _sym_scale(amax)
    codes = torch.empty((P, V), dtype=torch.int8, device=x.device)
    for r0, r1 in _row_chunks(P, V):
        codes[r0:r1] = _sym_codes(x[r0:r1].float(), scale)
    return codes, scale


def compute_ray_stats_int8(codes: Tensor, scale: Tensor, *,
                           dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """Ray stats of ``H = scale * codes``: column sums of the codes in
    int32, times the scale; row sums as the codes against the scales. Both
    a block of rows at a time (the int32 sums are exact in any order)."""
    s = scale.to(dtype)
    colsum = torch.zeros(codes.shape[1], dtype=torch.int32, device=codes.device)
    length = torch.empty(codes.shape[0], dtype=dtype, device=codes.device)
    for r0, r1 in _row_chunks(*codes.shape):
        colsum += codes[r0:r1].sum(dim=0, dtype=torch.int32)
        length[r0:r1] = codes[r0:r1].to(dtype) @ s
    return s * colsum.to(dtype), length


def _subset_colsums(rtm: Tensor, n: int, dtype: torch.dtype,
                    scale: Optional[Tensor]) -> Tensor:
    """``[n, V]`` column sums of the interleaved row subsets ``t::n`` (the
    OS cycle's per-subset ray densities), a block of rows at a time; int8
    codes sum in int32 (exact) and are scaled after."""
    P, V = rtm.shape
    step = max(n, _CHUNK_ELEMENTS // max(V, 1) // n * n)
    acc = torch.zeros((n, V), dtype=torch.int32 if scale is not None else dtype,
                      device=rtm.device)
    for r0 in range(0, P, step):
        acc += rtm[r0:r0 + step].reshape(-1, n, V).sum(dim=0, dtype=acc.dtype)
    return scale[None, :] * acc.to(dtype) if scale is not None else acc


def _span(name: str):
    """A ``torch.profiler`` range around one part of the OS cycle while a
    profiler records (it splits an iteration's device time by part), else
    nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def make_problem(rtm, laplacian: Optional[LaplacianCOO] = None, *,
                 opts: SolverOptions, device="cuda",
                 rtm_scale=None) -> SARTProblem:
    """Upload the RTM (a host array or a tensor) in the storage dtype and
    compute its ray stats in the compute dtype. ``laplacian`` must already
    live on ``device``.

    Float storage: the stats are taken from ``rtm`` as given, before any
    cast, where it lies; a host matrix stored in another dtype is cast on
    the host, so only the stored matrix is uploaded. (The CLI hands over an
    already-rounded bf16 matrix, so its stats are those of the stored
    matrix, as the JAX CLI's are.)

    int8 storage: ``rtm`` is quantized where it lies (a host array on the
    host, so the card only ever holds the 1-byte codes), or it is already
    int8 codes and ``rtm_scale`` [V] their scales. The stats are those of
    the quantized matrix.
    """
    dev = resolve_device(device)
    dtype = torch_dtype(opts.dtype)
    sdt = storage_dtype(opts)
    if laplacian is not None:
        check_on(dev, laplacian=laplacian.vals)
    if np.ndim(rtm) != 2:
        raise ValueError(f"rtm must be [P, V], got shape {np.shape(rtm)}.")
    if sdt == torch.int8:
        if max(np.shape(rtm)) > INT8_MAX_CONTRACTION:
            raise ValueError(
                f"rtm_dtype='int8': RTM extent {max(np.shape(rtm))} exceeds "
                f"the int32-accumulation bound {INT8_MAX_CONTRACTION} of the "
                "integer projections (int8_back_project); use fp32/bfloat16 "
                "storage."
            )
        if rtm_scale is None:
            codes, scale = quantize_rtm(rtm)
        else:
            codes = torch.as_tensor(rtm)
            scale = torch.as_tensor(rtm_scale)
            if codes.dtype != torch.int8:
                raise ValueError(
                    "rtm_scale implies pre-quantized int8 codes; got a "
                    f"{codes.dtype} matrix."
                )
            if scale.shape != (codes.shape[1],):
                raise ValueError(
                    f"rtm_scale of shape {tuple(scale.shape)} does not fit "
                    f"rtm {tuple(codes.shape)}: [{codes.shape[1]}] expected."
                )
        codes = codes.to(dev).contiguous()
        scale = scale.to(dev, torch.float32)
        dens, length = compute_ray_stats_int8(codes, scale, dtype=dtype)
        return SARTProblem(codes, dens, length, laplacian, scale)
    if rtm_scale is not None:
        raise ValueError("rtm_scale is only valid with rtm_dtype='int8'.")
    rtm = torch.as_tensor(rtm)
    if rtm.dtype == sdt or rtm.device.type == dev.type:
        rtm = rtm.to(dev)  # stored as given, or already there
    dens, length = compute_ray_stats(rtm, dtype=dtype)
    return SARTProblem(rtm.to(dev, sdt).contiguous(), dens.to(dev),
                       length.to(dev), laplacian)


def resolve_fused(opts: SolverOptions) -> bool:
    """Whether the loop runs through the fused sweep: fp32 compute over
    fp32, bf16 or int8 storage, with ``"auto"`` or ``"on"``. The fp64
    profile and fp64 storage decline — quietly for ``"auto"``, with a
    ValueError for ``"on"``. The ordered-subsets cycle (``os_subsets > 1``)
    replaces the fused sweep under ``"auto"`` (``SolverOptions`` refuses it
    with ``"on"``). So does the log solver with
    ``divergence_recovery``, as in the JAX package
    (``sartsolver_tpu/models/sart.py:_resolve_fused``): the guard's per-frame
    step scale enters the log update as its exponent, which the JAX kernel's
    literal-constant closure cannot carry."""
    if opts.fused_sweep == "off" or opts.os_subsets > 1:
        return False
    if opts.divergence_recovery and opts.logarithmic:
        if opts.fused_sweep == "on":
            raise ValueError(
                "fused_sweep='on' requested but divergence_recovery is enabled "
                "on the logarithmic solver; the per-frame relaxation scale "
                "cannot enter the fused kernel's literal exponent. Use "
                "fused_sweep='auto'/'off' or the linear solver."
            )
        return False
    storage = opts.rtm_dtype or opts.dtype
    if opts.dtype != "float32" or storage not in ("float32", "bfloat16", "int8"):
        if opts.fused_sweep == "on":
            raise ValueError(
                f"fused_sweep='on' requested but dtype={opts.dtype} / rtm "
                f"dtype={storage}; the fused sweep computes in fp32 (fp32, "
                "bfloat16 or quantized int8 RTM storage)."
            )
        return False
    return True


class _SweepContext:
    """Masks, inverse ray stats, the penalty and one iteration's sweep."""

    def __init__(self, problem: SARTProblem, opts: SolverOptions,
                 sweep_fn: SweepFn, debug_nans: bool = False):
        self.opts = opts
        self.debug_nans = debug_nans
        self.dtype = torch_dtype(opts.dtype)
        self.rtm = problem.rtm
        self.lap = problem.laplacian
        self.beta = opts.beta_laplace
        self.eps = _tiny(opts.log_epsilon)
        self.fused = resolve_fused(opts)
        self.sweep_fn = sweep_fn
        self.os = int(opts.os_subsets)
        FUSED_ENGAGEMENT["last"] = (
            "os-subset" if self.os > 1 else "off" if not self.fused
            else "compiled" if self.rtm.is_cuda and sweep_fn is fused_sweep
            else "plain")
        # int8 codes: the loop's kernel (or the OS cycle's products)
        # dequantizes them exactly; the projections outside it quantize
        # their vector operand
        self.scale = None
        if problem.rtm.dtype == torch.int8:
            if problem.rtm_scale is None:
                raise ValueError(
                    "int8 RTM needs SARTProblem.rtm_scale; build the problem "
                    "with make_problem(..., opts with rtm_dtype='int8')."
                )
            if not self.fused and self.os == 1:
                raise ValueError(
                    "rtm_dtype='int8' requires the fused sweep, but it "
                    f"resolved off (fused_sweep='{opts.fused_sweep}'). Use "
                    "fused_sweep='auto'/'on', or fp32/bfloat16 storage."
                )
            self.scale = problem.rtm_scale.to(self.dtype)

        dens, length = problem.ray_density, problem.ray_length
        self.vmask = dens > opts.ray_density_threshold  # [V]
        self.safe_dens = torch.where(self.vmask, dens, torch.ones_like(dens))
        self.inv_density = torch.where(
            self.vmask, opts.relaxation / self.safe_dens,
            torch.zeros_like(dens),
        ).to(self.dtype)
        lmask = length > opts.ray_length_threshold  # [P]
        self.inv_length = torch.where(
            lmask, 1 / torch.where(lmask, length, torch.ones_like(length)),
            torch.zeros_like(length),
        ).to(self.dtype)
        self.vm = self.vmask.to(self.dtype)[None, :]
        if self.os > 1:
            # per-subset ray densities and masks: a sub-step normalizes by
            # its own subset's column sums and never updates a voxel that
            # its subset barely sees or that is masked globally
            P = problem.rtm.shape[0]
            if P % self.os:
                raise ValueError(
                    f"os_subsets={self.os} must divide the (per-shard, "
                    f"padded) pixel extent {P}."
                )
            dens_sub = _subset_colsums(problem.rtm, self.os, self.dtype, self.scale)
            self.vmask_sub = (dens_sub > opts.ray_density_threshold) & self.vmask[None, :]
            self.inv_density_sub = torch.where(
                self.vmask_sub,
                opts.relaxation / torch.where(self.vmask_sub, dens_sub, torch.ones_like(dens_sub)),
                torch.zeros_like(dens_sub),
            ).to(self.dtype)
        self.os_nan_rows = None  # [os, B] with debug_nans: NaN rows after each sub-step

        dev = dens.device
        self.scheduled = opts.relaxation_decay != 1.0
        self.decay = torch.tensor(opts.relaxation_decay, dtype=self.dtype, device=dev)
        self.relax = torch.tensor(opts.relaxation, dtype=self.dtype, device=dev)
        self.momentum = opts.momentum != "off"
        # only the linear classic sweep extrapolates H f by linearity (the
        # OS cycle recomputes every subset residual)
        self.carry_fit = self.momentum and not opts.logarithmic and self.os == 1
        self.mom_floor = torch.tensor(_tiny(max(opts.log_epsilon, 1e-30)),
                                      dtype=self.dtype, device=dev)
        self.recovery = int(opts.divergence_recovery)
        # the in-solve ABFT check: the band over the matrix as held (the
        # padded rows included, as the JAX solver's padded extent is)
        self.integrity = bool(opts.integrity)
        self.bp_chk = None  # the two-matmul sweep's back-projection checksums
        if self.integrity:
            from sartsolver_tpu_torch.resilience.integrity import abft_tolerance

            self.abft_tol = abft_tolerance(opts.dtype, opts.rtm_dtype,
                                           problem.rtm.shape[0], problem.rtm.shape[1])
            self.dens = dens.to(self.dtype)
            self.length_row = length.to(self.dtype)[None, :]
            self.abft_worst = (torch.zeros((), dtype=self.dtype, device=dev)
                               if _ABFT_RECORD["on"] else None)

    def decay_factor(self, it: Tensor) -> Tensor:
        """``decay ** it`` [B] for the iterations ``it`` [B] each frame has
        completed: one op, the same for the batched loop (every frame at the
        loop's count) and the stride (each lane at its own), so the two
        agree byte for byte."""
        return torch.pow(self.decay, it.to(self.dtype))

    def bp_any(self, w: Tensor) -> Tensor:
        """``H^T w`` on whatever the problem stores: the one back-projection
        seam of every path outside the fused loop."""
        if self.scale is not None:
            return int8_back_project(self.rtm, self.scale, w)
        return back_project(self.rtm, w)

    def fp_any(self, f: Tensor) -> Tensor:
        """``H f`` on whatever the problem stores: the forward seam."""
        if self.scale is not None:
            return int8_forward_project(self.rtm, self.scale, f)
        return forward_project(self.rtm, f)

    def compute_penalty(self, x: Tensor) -> Tensor:
        """``beta * L @ x`` per frame (zeros without a Laplacian)."""
        return self.beta * coo_matvec(self.lap, x)

    def initial_guess(self, g: Tensor) -> Tensor:
        """Eq. 4: ``H^T g / rho`` on unmasked voxels; the fp32 profile
        excludes negative measurements (sart_kernels.cu:34)."""
        if self.opts.mask_negative_guess:
            g = torch.where(g > 0, g, torch.zeros_like(g))
        accum = self.bp_any(g)
        return torch.where(self.vmask[None, :], accum / self.safe_dens[None, :],
                           torch.zeros_like(accum))

    def make_obs(self, g: Tensor, meas_mask: Tensor) -> Tensor:
        """Log variant's observation back-projection, once per measurement."""
        zero = torch.zeros_like(g)
        obs = self.bp_any(torch.where(meas_mask, g, zero) * self.inv_length)
        return torch.where(self.vmask[None, :], obs, torch.zeros_like(obs))

    def make_obs_sub(self, g: Tensor, meas_mask: Tensor) -> Tensor:
        """The OS cycle's per-subset observations ``[B, os, V]``: subset t's
        back-projection of the measurement, masked by its own voxel mask;
        once per measurement, as :meth:`make_obs`."""
        outs = []
        for t in range(self.os):
            g_t = os_subset_pixels(g, t, self.os)
            w_t = (torch.where(os_subset_pixels(meas_mask, t, self.os), g_t,
                               torch.zeros_like(g_t))
                   * os_subset_pixels(self.inv_length, t, self.os)[None, :])
            obs_t = os_subset_back(os_subset_rows(self.rtm, t, self.os), w_t, self.scale)
            outs.append(torch.where(self.vmask_sub[t][None, :], obs_t, torch.zeros_like(obs_t)))
        return torch.stack(outs, dim=1)

    def log_exponent(self, B: int, dk: Optional[Tensor], ascale: Optional[Tensor]):
        """The log update's exponent ``relaxation * dk * ascale``: ``[B, 1]``,
        or the plain float when neither factor is on."""
        if dk is None and ascale is None:
            return self.opts.relaxation
        exponent = self.relax.expand(B)
        if dk is not None:
            exponent = exponent * dk
        if ascale is not None:
            exponent = exponent * ascale
        return exponent[:, None]

    def run_os_sweep(self, f: Tensor, dk: Optional[Tensor], ascale: Optional[Tensor],
                     g: Tensor, meas_mask: Tensor, obs_sub: Optional[Tensor]
                     ) -> Tuple[Tensor, Tensor]:
        """``(f_upd, fitted_upd)``: one outer iteration of the ordered-subsets
        cycle (``sartsolver_tpu/models/sart.py:run_os_sweep``). Sub-step t
        updates against the rows ``t::os`` with a fresh residual at the
        iterate the sub-steps before it left, its own inverse density (or
        observation) and mask; ``dk`` and ``ascale`` compose as in
        :meth:`run_sweep`; the Laplacian penalty is taken at the current
        iterate and scaled by ``1/os``, so a cycle applies the classic
        iteration's strength. Then one exact full forward projection of the
        final iterate: for int8 the subset products interleaved back, never
        the quantized-vector projection."""
        n = self.os
        pen_scale = 1.0 / n
        exponent = eps = None
        if self.opts.logarithmic:
            exponent = self.log_exponent(f.shape[0], dk, ascale)
            eps = torch.tensor(self.eps, dtype=self.dtype, device=f.device)
        nan_rows = []
        for t in range(n):
            panel = os_subset_rows(self.rtm, t, n)
            m_t = os_subset_pixels(meas_mask, t, n)
            il_t = os_subset_pixels(self.inv_length, t, n)[None, :]
            with _span("os_subset_forward"):
                fitted_t = os_subset_forward(panel, f, self.scale)
            if self.opts.logarithmic:
                w = torch.where(m_t, fitted_t, torch.zeros_like(fitted_t)) * il_t
                with _span("os_subset_back"):
                    fit = os_subset_back(panel, w, self.scale)
                # the fp32 products widen to the compute dtype before the
                # ratio, as the JAX cycle's fp64 epsilon widens them
                fit = torch.where(self.vmask_sub[t][None, :], fit,
                                  torch.zeros_like(fit)).to(self.dtype)
                obs_t = obs_sub[:, t].to(self.dtype)
                f_new = f * ((obs_t + eps) / (fit + eps)) ** exponent
                if self.lap is not None:
                    f_new = f_new * torch.exp(-(self.compute_penalty(torch.log(f)) * pen_scale))
            else:
                g_t = os_subset_pixels(g, t, n)
                w = torch.where(m_t, g_t - fitted_t, torch.zeros_like(g_t)) * il_t
                if dk is not None:
                    w = w * dk[:, None]
                if ascale is not None:
                    w = w * ascale[:, None]
                with _span("os_subset_back"):
                    bp = os_subset_back(panel, w, self.scale)
                upd = f + self.inv_density_sub[t][None, :] * bp
                if self.lap is not None:
                    upd = upd - self.compute_penalty(f) * pen_scale
                f_new = torch.clamp_min(upd, 0)
            f = f_new
            if self.debug_nans:
                nan_rows.append(nanchk.row_flags(f))
        if self.debug_nans:
            self.os_nan_rows = torch.stack(nan_rows)
        with _span("os_full_forward"):
            if self.scale is not None:
                parts = [os_subset_forward(os_subset_rows(self.rtm, t, n), f, self.scale)
                         for t in range(n)]
                fitted = torch.stack(parts, dim=2).reshape(f.shape[0], self.rtm.shape[0])
            else:
                fitted = self.fp_any(f)
        return f, fitted

    def check_kept(self, where: str, f: Tensor, fitted: Tensor, conv: Tensor) -> None:
        """``debug_nans`` on an iteration's kept iterate, projection and
        Eq. 5 metric (nothing when off); an OS iterate names the first
        sub-step whose result held the NaN."""
        if not self.debug_nans:
            return
        what = nanchk.first_nan(("the iterate", f), ("the forward projection", fitted),
                                ("the Eq. 5 metric", conv))
        if what is None:
            return
        if what == "the iterate":
            step = "the sweep"
            if self.os > 1:
                step = "the OS cycle"
                hit = (self.os_nan_rows & torch.isnan(f).any(dim=1)[None, :]).any(dim=1)
                if bool(hit.any()):
                    step = f"OS sub-step {int(hit.to(torch.int8).argmax())}"
            what = f"the iterate after {step}"
        nanchk.fail(what, where)

    def run_fused(self, w: Tensor, f: Tensor, aux, **kw):
        """One call of the fused sweep; int8 codes carry their scale."""
        if self.scale is not None:
            kw["scale"] = self.scale[None, :]
        return self.sweep_fn(self.rtm, w, f, aux, **kw)

    def run_sweep(self, f: Tensor, fitted: Tensor, penalty: Tensor,
                  g: Tensor, meas_mask: Tensor, obs: Optional[Tensor],
                  dk: Optional[Tensor] = None, ascale: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Optional[Tensor]]:
        """``(f_upd, fitted_upd or None)``: one iteration's update; the
        fused sweep also returns ``H f_upd``. ``dk`` [B] is the schedule's
        ``decay**k`` and ``ascale`` [B] the guard's step scale, each None
        when its variant is off (``sartsolver_tpu/models/sart.py:1705-1780``):
        the linear update folds both into ``w``; the log update takes
        ``relaxation * dk * ascale`` as its exponent, through the kernel's
        ``alpha_lane`` when fused (the guard keeps the log solver off the
        fused sweep, see :func:`resolve_fused`)."""
        opts = self.opts
        pen = [penalty] if self.lap is not None else []
        if opts.logarithmic:
            w = torch.where(meas_mask, fitted, torch.zeros_like(fitted)) * self.inv_length
            if self.fused:
                kw = {}
                if dk is not None:
                    kw["alpha_lane"] = (self.relax * dk)[:, None]
                return self.run_fused(
                    w, f, [self.vm, obs] + pen, logarithmic=True,
                    alpha=float(opts.relaxation), eps=self.eps, **kw,
                )
            fit = self.bp_any(w)
            if self.integrity:  # the raw product: the identity holds for all of H^T w
                self.bp_chk = (fit.sum(dim=1), (self.length_row * w).sum(dim=1))
            fit = torch.where(self.vmask[None, :], fit, torch.zeros_like(fit))
            eps = torch.tensor(self.eps, dtype=self.dtype, device=f.device)
            ratio = ((obs + eps) / (fit + eps)) ** self.log_exponent(f.shape[0], dk, ascale)
            return f * ratio * torch.exp(-penalty), None
        w = torch.where(meas_mask, g - fitted, torch.zeros_like(g)) * self.inv_length
        if dk is not None:
            # linear in w: the step factor folds into the pixel weights
            # (inv_density keeps the base relaxation)
            w = w * dk[:, None]
        if ascale is not None:
            w = w * ascale[:, None]
        if self.fused:
            return self.run_fused(
                w, f, [self.inv_density[None, :]] + pen, logarithmic=False,
            )
        bp = self.bp_any(w)
        if self.integrity:
            self.bp_chk = (bp.sum(dim=1), (self.length_row * w).sum(dim=1))
        return torch.clamp_min(f + self.inv_density[None, :] * bp - penalty, 0), None

    def abft_residual(self, s_a: Tensor, s_b: Tensor) -> Tuple[Tensor, Tensor]:
        """``(tripped [B], ratio [B])``: ``ratio`` is ``|s_a - s_b|`` over the
        band ``tol * (max(|s_a|, |s_b|) + 1)``, and a frame trips where it is
        above 1 or not a number. So an infinite residual trips too (the JAX
        check's ``err <= band`` holds for inf against an infinite band,
        which lets an overflowed product pass; its contract is that a
        non-finite residual trips)."""
        band = torch.maximum(s_a.abs(), s_b.abs()).add_(1.0).mul_(self.abft_tol)
        ratio = (s_a - s_b).abs_().div_(band)
        return ~(ratio <= 1.0), ratio

    def abft_check(self, f_new: Tensor, fitted_new: Tensor, done: Tensor) -> Tensor:
        """[B] live frames whose iteration broke an ABFT identity
        (``sartsolver_tpu/models/sart.py:abft_check``): the forward check
        on every path, the back-projection check after a two-matmul
        sweep. Where a record is kept (``abft_worst``), also folds the
        largest residual ratio of the live frames into it."""
        tripped, ratio = self.abft_residual(fitted_new.sum(dim=1), f_new @ self.dens)
        if self.bp_chk is not None:
            t_bp, r_bp = self.abft_residual(*self.bp_chk)
            tripped, ratio = tripped | t_bp, torch.maximum(ratio, r_bp)
            self.bp_chk = None
        live = ~done
        if self.abft_worst is not None:
            # fmax: a ratio that is not a number (a trip) leaves the record as is
            self.abft_worst = torch.fmax(
                self.abft_worst, torch.where(live, ratio, torch.zeros_like(ratio)).amax())
        return live & tripped

    def extrapolate(self, f: Tensor, f_prev: Tensor, tk: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor]:
        """``(y, beta [B, 1], t_next [B])``: the Nesterov/FISTA point —
        additive for the linear solver, multiplicative (log space, floored)
        for the log solver (``sartsolver_tpu/models/sart.py:1590-1606``)."""
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        beta = ((tk - 1.0) / t_next).to(self.dtype)[:, None]
        if self.opts.logarithmic:
            floor = self.mom_floor
            y = torch.clamp_min(
                f * (torch.clamp_min(f, floor) / torch.clamp_min(f_prev, floor)) ** beta,
                floor)
        else:
            y = f + beta * (f - f_prev)
        return y, beta, t_next

    def momentum_tk(self, y: Tensor, f_new: Tensor, f: Tensor, t_next: Tensor,
                    reset: Optional[Tensor]) -> Tensor:
        """The next t_k: 1 where the update moved against the extrapolation
        (gradient restart) or where ``reset`` (a rollback), else ``t_next``.
        A restart never touches the step scale."""
        rs = ((y - f_new) * (f_new - f)).sum(dim=1) > 0
        if reset is not None:
            rs = rs | reset
        return torch.where(rs, torch.ones_like(t_next), t_next).to(self.dtype)

    def iterate(self, f: Tensor, fitted: Tensor, done: Tensor, g: Tensor,
                meas_mask: Tensor, obs: Optional[Tensor], msq: Tensor,
                dk: Optional[Tensor] = None, ascale: Optional[Tensor] = None,
                mom: Optional[tuple] = None) -> "_Step":
        """One iteration of every frame, done frames frozen, with the Eq. 5
        metric ``C^k`` of the new iterate. The one loop body of the batched
        solve and the scheduler's stride. ``mom`` is the momentum state
        ``(f_prev, fitted_prev or None, tk)``: the sweep then runs at the
        extrapolated point ``y`` (the penalty taken there too), while the
        frozen frames keep ``f``. With ``os_subsets > 1`` the OS cycle
        replaces the sweep (``obs`` is then ``[B, os, V]``); it computes
        every subset residual at ``y`` itself, so no projection of ``y``."""
        opts = self.opts
        base, fitted_base, y, t_next = f, fitted, None, None
        if mom is not None:
            f_prev, fitted_prev, tk = mom
            y, beta, t_next = self.extrapolate(f, f_prev, tk)
            base = y
        if self.os > 1:
            f_upd, fitted_upd = self.run_os_sweep(base, dk, ascale, g, meas_mask, obs)
        else:
            if mom is not None and opts.logarithmic:
                fitted_base = self.fp_any(y)  # no linearity: one projection
            elif mom is not None:
                fitted_base = fitted + beta * (fitted - fitted_prev)  # H y, exactly
            penalty = self.compute_penalty(torch.log(base) if opts.logarithmic else base)
            f_upd, fitted_upd = self.run_sweep(base, fitted_base, penalty, g, meas_mask, obs,
                                               dk, ascale)
        frozen = done[:, None]
        f_new = torch.where(frozen, f, f_upd)  # converged frames freeze
        if fitted_upd is None:
            fitted_new = self.fp_any(f_new)
        else:
            fitted_new = torch.where(frozen, fitted, fitted_upd)
        fsq = _sumsq(fitted_new, self.dtype, opts.precise_convergence)
        conv = (msq - fsq) / msq
        tripped = None
        if self.integrity:
            tripped = self.abft_check(f_new, fitted_new, done)
            if self.recovery:
                # a non-finite checksum is the divergence guard's to classify
                tripped = tripped & (torch.isfinite(fsq) & torch.isfinite(conv))
            # a tripped frame freezes on its entering state, the last
            # iterate whose checksums held
            rows = tripped[:, None]
            f_new = torch.where(rows, f, f_new)
            fitted_new = torch.where(rows, fitted, fitted_new)
        return _Step(f_new, fitted_new, fsq, conv, y, t_next, tripped)

    def guard(self, step: "_Step", f: Tensor, fitted: Tensor, conv_prev: Tensor,
              done: Tensor, msq: Tensor, ascale: Tensor, recov: Tensor):
        """The divergence guard on one iteration
        (``sartsolver_tpu/models/sart.py:1991-2010``): the candidate is judged
        before it is kept. Returns ``(f_new, fitted_new, conv, ascale,
        recov, bad, exhausted)``: a bad frame keeps its entering state and,
        unless its R recoveries are spent (``exhausted``), halves its step."""
        opts = self.opts
        fsq, conv = step.fsq, step.conv
        bad = ~done & (~(torch.isfinite(fsq) & torch.isfinite(conv))
                       | (fsq > opts.divergence_threshold * torch.clamp_min(msq, 1.0)))
        if step.tripped is not None:
            bad = bad & ~step.tripped  # a finite SDC mismatch outranks the rollback
        exhausted = bad & (recov >= self.recovery)
        rows = bad[:, None]
        f_new = torch.where(rows, f, step.f)
        fitted_new = torch.where(rows, fitted, step.fitted)
        conv = torch.where(bad, conv_prev, conv)
        if step.tripped is not None:
            conv = torch.where(step.tripped, conv_prev, conv)
        ascale = torch.where(bad & ~exhausted, ascale * 0.5, ascale)
        return f_new, fitted_new, conv, ascale, recov + bad.to(torch.int32), bad, exhausted

    def input_bad(self, g: Tensor, f: Tensor, msq: Tensor) -> Tensor:
        """[B] frames whose measurement, start or ``||g||^2`` is not finite:
        no iterate of theirs can be rolled back to."""
        return ((~torch.isfinite(g)).any(dim=1) | (~torch.isfinite(f)).any(dim=1)
                | ~torch.isfinite(msq))


class _Step(NamedTuple):
    """One iteration's candidate: the new iterate and its projection, its
    ``||Hf||^2`` and metric, and (momentum) the extrapolated point and the
    next FISTA t."""

    f: Tensor
    fitted: Tensor
    fsq: Tensor
    conv: Tensor
    y: Optional[Tensor]
    t_next: Optional[Tensor]
    tripped: Optional[Tensor] = None  # [B] the ABFT check's trips (integrity on)


def _floor_start(f0: Tensor, opts: SolverOptions) -> Tensor:
    """The floors of a start that is not the solver's own loop exit: the
    guess floor, and for the log variant a positive iterate (a zero voxel
    is log(0) in the penalty and never recovers)."""
    if opts.guess_floor > 0:
        f0 = torch.clamp_min(f0, _tiny(opts.guess_floor))
    if opts.logarithmic:
        f0 = torch.clamp_min(f0, _tiny(max(opts.guess_floor, opts.log_epsilon)))
    return f0


def _sumsq(x: Tensor, dtype: torch.dtype, precise: bool) -> Tensor:
    """``sum(x**2, axis=1)`` in ``dtype``. ``precise``: accumulated in fp64
    and rounded — the Eq. 5 stall test flips on one-ulp changes of
    ``||Hf||^2``, so its sum must not drift with the summation order (the
    JAX package's x64 branch); otherwise the reference CUDA path's plain
    dot (sartsolver_cuda.cpp:253)."""
    if not precise:
        return (x * x).sum(dim=1)
    x64 = x.to(torch.float64)
    return (x64 * x64).sum(dim=1).to(dtype)


def solve_normalized_batch(
    problem: SARTProblem,
    g: Tensor,  # [B, P]
    msq: Tensor,  # [B]
    f0: Tensor,  # [B, V]
    *,
    opts: SolverOptions,
    use_guess: bool,
    fitted0: Optional[Tensor] = None,
    return_fitted: bool = False,
    device="cuda",
    sweep_fn: SweepFn = fused_sweep,
    debug_nans: bool = False,
) -> "SolveResult | Tuple[SolveResult, Tensor]":
    """Solver core on pre-normalized measurements: B independent frames in
    one loop.

    ``g``/``f0`` are divided by each frame's norm; ``msq`` is the normalized
    ``||g||^2`` with non-positive measurements excluded. ``fitted0`` (only
    with ``use_guess=False``) is a carried ``H @ f0`` — a warm start's
    loop-exit projection — which replaces the setup forward projection.
    ``return_fitted=True`` also returns the loop-exit ``fitted == H @
    solution`` ``[B, P]``. ``sweep_fn`` is the fused sweep's implementation;
    only tests and the chip smoke run set it, to the plain version.
    ``debug_nans=True`` raises ``FloatingPointError`` at the first NaN the
    solve keeps (``sartsolver_tpu_torch/debug_nans.py``).

    The variants (``sartsolver_tpu/models/sart.py:1894-2066``, without the
    integrity check): the OS cycle in place of the sweep, with the log
    variant's per-subset observations; the schedule factor of the loop's
    count; the momentum state ``(f_prev, fitted_prev, t_k)``, started at
    ``(f0, fitted0, 1)``; the divergence guard's per-frame step scale,
    recovery count and DIVERGED latch, a rolled-back frame never passing
    the stall test on its unchanged metric, and a restart OR'd with a
    rollback; and the guard's pre-flight check, which stops a frame with a
    non-finite measurement, start or ``||g||^2`` as DIVERGED at iteration
    0 with a zero solution.
    """
    dev = resolve_device(device)
    check_on(dev, rtm=problem.rtm, rtm_scale=problem.rtm_scale, g=g, msq=msq,
             f0=f0, fitted0=fitted0)
    dtype = torch_dtype(opts.dtype)
    B = g.shape[0]
    kit = _SweepContext(problem, opts, sweep_fn, debug_nans)
    g = g.to(dtype)
    meas_mask = g >= 0  # [B, P]

    if fitted0 is not None and use_guess:
        raise ValueError(
            "fitted0 carries a warm start's forward projection; it cannot "
            "be combined with use_guess=True."
        )
    if use_guess:
        f0 = kit.initial_guess(g)
    if fitted0 is None or opts.logarithmic:
        # A linear carried warm start skips the guess floor: it is this
        # solver's own loop-exit solution, and flooring it would break the
        # exact fitted0 == H @ f0 pair. The log variant floors every start.
        f0 = _floor_start(f0, opts)
    f = f0.to(dtype)
    fitted = kit.fp_any(f) if fitted0 is None else fitted0.to(dtype)

    tol = torch.tensor(opts.conv_tolerance, dtype=dtype, device=dev)
    msq = msq.to(dtype)
    obs = None
    if opts.logarithmic:
        obs = kit.make_obs_sub(g, meas_mask) if kit.os > 1 else kit.make_obs(g, meas_mask)

    conv_prev = torch.zeros(B, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), opts.max_iterations, dtype=torch.int32, device=dev)
    ascale = recov = diverged = mom = None
    if kit.recovery:
        # pre-flight: a frame with a non-finite input has no good iterate
        bad_in = kit.input_bad(g, f, msq)
        rows = bad_in[:, None]
        f = torch.where(rows, torch.zeros_like(f), f)
        fitted = torch.where(rows, torch.zeros_like(fitted), fitted)
        done, diverged = bad_in, bad_in
        iters = torch.where(bad_in, torch.zeros_like(iters), iters)
        ascale = torch.ones(B, dtype=dtype, device=dev)
        recov = torch.zeros(B, dtype=torch.int32, device=dev)
    if debug_nans:
        nanchk.check("the start of the solve",
                     ("the guess" if use_guess else "the warm start", f),
                     ("the set-up projection", fitted), ("the observation back-projection", obs))
    if kit.momentum:  # t_1 = 1: the first iteration extrapolates nothing
        mom = (f, fitted if kit.carry_fit else None, torch.ones(B, dtype=dtype, device=dev))
    sdc = torch.zeros_like(done) if kit.integrity else None
    it = 0
    while it < opts.max_iterations and not bool(done.all()):
        dk = (kit.decay_factor(torch.full((B,), it, dtype=torch.int32, device=dev))
              if kit.scheduled else None)
        step = kit.iterate(f, fitted, done, g, meas_mask, obs, msq, dk, ascale, mom)
        f_new, fitted_new, conv, tripped = step.f, step.fitted, step.conv, step.tripped
        if tripped is not None:
            conv = torch.where(tripped, conv_prev, conv)
        bad = None
        if kit.recovery:
            f_new, fitted_new, conv, ascale, recov, bad, exhausted = kit.guard(
                step, f, fitted, conv_prev, done, msq, ascale, recov)
        kit.check_kept(f"iteration {it + 1}", f_new, fitted_new, conv)
        if it >= 1:  # Eq. 5 stall test, from the second iteration on
            newly = ~done & (torch.abs(conv - conv_prev) < tol)
            if bad is not None:  # a rolled-back metric is not a stall
                newly &= ~bad
        else:
            newly = torch.zeros_like(done)
        if tripped is not None:  # a frozen SDC frame's metric is not a stall
            newly = newly & ~tripped
        ended = newly
        if kit.recovery:
            ended = newly | exhausted
            diverged = diverged | exhausted
        if tripped is not None:
            ended = ended | tripped
            sdc = sdc | tripped
        iters = torch.where(ended, torch.full_like(iters, it + 1), iters)
        if kit.momentum:
            reset = bad if tripped is None else (tripped if bad is None else bad | tripped)
            mom = (f, fitted if kit.carry_fit else None,
                   kit.momentum_tk(step.y, f_new, f, step.t_next, reset))
        f, fitted, conv_prev, done = f_new, fitted_new, conv, done | ended
        it += 1
    status = torch.where(
        done, torch.full_like(iters, SUCCESS),
        torch.full_like(iters, MAX_ITERATIONS_EXCEEDED),
    )
    if diverged is not None:
        status = torch.where(diverged, torch.full_like(iters, DIVERGED), status)
    if sdc is not None:
        status = torch.where(sdc, torch.full_like(iters, SDC_DETECTED), status)
        _note_abft(kit)
    res = SolveResult(f, status, iters, conv_prev)
    return (res, fitted) if return_fitted else res


def solve_chain_normalized(
    problem: SARTProblem,
    g: Tensor,  # [K, P]
    msq: Tensor,  # [K]
    f0: Tensor,  # [1, V] seed of frame 0 (ignored when guessing)
    rescale: Tensor,  # [K] warm-start renormalization factors
    *,
    opts: SolverOptions,
    use_guess_first: bool,
    fitted0: Optional[Tensor] = None,
    device="cuda",
    debug_nans: bool = False,
) -> Tuple[SolveResult, Tensor]:
    """K warm-chained frames, each a B = 1 solve of
    :func:`solve_normalized_batch`: frame 0 from the Eq. 4 guess (or the
    seed ``f0``), each next frame from the previous frame's solution and
    loop-exit ``fitted``, both times ``rescale[k]`` (``norm_{k-1} /
    norm_k``; ``rescale[0]`` rescales the seed and ``fitted0``). The ops of
    the CLI's serial warm start, so the frames equal K serial solves.

    Returns ``(SolveResult with a leading K axis, fitted [1, P] of the last
    frame)``: ``solution[-1]`` and that ``fitted`` seed a following chain.
    """
    if use_guess_first and fitted0 is not None:
        raise ValueError(
            "fitted0 carries a warm start's forward projection; it cannot "
            "be combined with use_guess_first=True."
        )
    rescale = rescale.to(torch_dtype(opts.dtype))

    def one(k, f_start, fit_start, use_guess):
        return solve_normalized_batch(
            problem, g[k:k + 1], msq[k:k + 1], f_start, opts=opts,
            use_guess=use_guess, fitted0=fit_start, return_fitted=True,
            device=device, debug_nans=debug_nans,
        )

    if use_guess_first:
        res, fit = one(0, torch.zeros_like(f0), None, True)
    else:
        res, fit = one(0, f0 * rescale[0],
                       None if fitted0 is None else fitted0 * rescale[0], False)
    parts = [res]
    for k in range(1, g.shape[0]):
        res, fit = one(k, res.solution * rescale[k], fit * rescale[k], False)
        parts.append(res)
    return SolveResult(*(torch.cat(field) for field in zip(*parts))), fit


class SchedState(NamedTuple):
    """Lane state carried across scheduler strides, on the device.

    Every leading dimension is the fixed lane count B. Inert lanes (never
    filled, or retired and awaiting backfill) hold ``done=True`` with
    placeholder data (``g=-1``: every pixel masked; ``f=1``: log-safe;
    ``msq=1``): their sweeps still run (fixed shape) and the ``done``
    freeze discards every result, as the batched loop does for converged
    frames. The variants' per-lane state is None while its variant is off.
    """

    g: Tensor  # [B, P] normalized measurement (-1 rows: inert)
    msq: Tensor  # [B] normalized ||g||^2 (1 for inert lanes)
    f: Tensor  # [B, V] current iterate
    fitted: Tensor  # [B, P] H @ f
    conv: Tensor  # [B] previous convergence metric C^k
    it: Tensor  # [B] int32, iterations completed by the current occupant
    done: Tensor  # [B] bool, frozen (converged, capped, diverged or inert)
    status: Tensor  # [B] int32, SUCCESS / MAX_ITERATIONS_EXCEEDED / DIVERGED
    iters: Tensor  # [B] int32, iteration count latched at retirement
    obs: Optional[Tensor]  # [B, V] log variant's observation ([B, os, V] with OS); None linear
    ascale: Optional[Tensor] = None  # [B] the guard's step scale
    recov: Optional[Tensor] = None  # [B] int32, the guard's recoveries spent
    f_prev: Optional[Tensor] = None  # [B, V] momentum: the previous iterate
    fitted_prev: Optional[Tensor] = None  # [B, P] its projection (linear)
    tk: Optional[Tensor] = None  # [B] momentum: FISTA t_k


def sched_step_normalized(
    problem: SARTProblem,
    state: SchedState,
    g_new: Optional[Tensor],  # [B, P] normalized rows for refilled lanes
    msq_new: Optional[Tensor],  # [B]
    refill,  # [B] host bools: lanes to (re)load before stepping
    *,
    opts: SolverOptions,
    device="cuda",
    debug_nans: bool = False,
) -> SchedState:
    """One scheduler stride: load the ``refill`` lanes, then run at most
    ``opts.schedule_stride`` iterations of every lane that is not done.

    A refilled lane starts as a frame of the batched ``use_guess`` path
    does, with the same ops: the Eq. 4 guess, its floors, its forward
    projection and, for the log variant, ``obs`` (taken for every lane and
    kept for the refilled ones); its momentum and guard state start over,
    and the guard's pre-flight check runs on the refilled lanes only (with
    ``os_subsets > 1`` ``obs`` holds the per-subset observations ``[B, os,
    V]``). The host knows ``refill``, so a stride with no refill
    (``g_new``/``msq_new`` may be None) skips that part.

    Each lane runs its own stall test from its own second iteration, its own
    schedule factor and guard, and stops at ``max_iterations``; ``iters``
    and ``status`` are latched once, after the loop, for the lanes that
    stopped in it. The loop ends early once every lane is done. The
    returned state is built from new tensors: ``state`` itself is never
    written.
    """
    dev = resolve_device(device)
    dtype = torch_dtype(opts.dtype)
    kit = _SweepContext(problem, opts, fused_sweep, debug_nans)
    refill = np.asarray(refill, bool)
    if refill.any():
        check_on(dev, g_new=g_new, msq_new=msq_new)
        lanes = torch.as_tensor(refill, device=dev)
        rows = lanes[:, None]
        g = torch.where(rows, g_new.to(dtype), state.g)
        msq = torch.where(lanes, msq_new.to(dtype), state.msq)
        f0 = _floor_start(kit.initial_guess(g), opts).to(dtype)
        fitted0 = kit.fp_any(f0)
        obs = state.obs
        if opts.logarithmic and kit.os > 1:
            obs = torch.where(lanes[:, None, None], kit.make_obs_sub(g, g >= 0), state.obs)
        elif opts.logarithmic:
            obs = torch.where(rows, kit.make_obs(g, g >= 0), state.obs)
        f = torch.where(rows, f0, state.f)
        fitted = torch.where(rows, fitted0, state.fitted)
        done = state.done & ~lanes
        status = torch.where(lanes, torch.full_like(state.status, MAX_ITERATIONS_EXCEEDED),
                             state.status)
        iters = torch.where(lanes, torch.full_like(state.iters, opts.max_iterations),
                            state.iters)
        extra = {}
        if kit.recovery:
            extra["ascale"] = torch.where(lanes, torch.ones_like(state.ascale), state.ascale)
            extra["recov"] = torch.where(lanes, torch.zeros_like(state.recov), state.recov)
            bad_in = lanes & kit.input_bad(g, f, msq)
            f = torch.where(bad_in[:, None], torch.zeros_like(f), f)
            fitted = torch.where(bad_in[:, None], torch.zeros_like(fitted), fitted)
            done = done | bad_in
            status = torch.where(bad_in, torch.full_like(status, DIVERGED), status)
            iters = torch.where(bad_in, torch.zeros_like(iters), iters)
        if kit.momentum:  # the lane's FISTA sequence starts over at its guess
            extra["f_prev"] = torch.where(rows, f0, state.f_prev)
            if kit.carry_fit:
                extra["fitted_prev"] = torch.where(rows, fitted0, state.fitted_prev)
            extra["tk"] = torch.where(lanes, torch.ones_like(state.tk), state.tk)
        state = state._replace(
            g=g, msq=msq, f=f, fitted=fitted,
            conv=torch.where(lanes, torch.zeros_like(state.conv), state.conv),
            it=torch.where(lanes, torch.zeros_like(state.it), state.it),
            done=done, status=status, iters=iters, obs=obs, **extra,
        )
        if debug_nans:  # the lanes' state is the stride's result, measurements too
            nanchk.check("the refill of a scheduler stride", ("the lanes' measurements", g),
                         ("the guess", state.f), ("the set-up projection", state.fitted),
                         ("the observation back-projection", obs))

    g, msq, obs = state.g, state.msq, state.obs
    meas_mask = g >= 0
    tol = torch.tensor(opts.conv_tolerance, dtype=dtype, device=dev)
    f, fitted, conv_prev, itl, done = state.f, state.fitted, state.conv, state.it, state.done
    ascale, recov = state.ascale, state.recov
    mom = (state.f_prev, state.fitted_prev, state.tk) if kit.momentum else None
    # A lane that is live at step s has run it + s iterations, so its stall
    # test is armed from step 1 on (at step 0 only if it >= 1) and it hits
    # the batched loop's `it < max_iterations` exit at step cap_step. Each
    # step then launches few more small ops than the batched loop's.
    armed = state.it >= 1
    cap_step = opts.max_iterations - 1 - state.it
    converged = torch.zeros_like(done)
    diverged = torch.zeros_like(done) if kit.recovery else None
    sdc = torch.zeros_like(done) if kit.integrity else None
    step = 0
    while step < opts.schedule_stride and not bool(done.all()):
        dk = kit.decay_factor(itl) if kit.scheduled else None
        out = kit.iterate(f, fitted, done, g, meas_mask, obs, msq, dk, ascale, mom)
        f_new, fitted_new, conv, tripped = out.f, out.fitted, out.conv, out.tripped
        if tripped is not None:
            conv = torch.where(tripped, conv_prev, conv)
        live = ~done
        bad = None
        if kit.recovery:
            f_new, fitted_new, conv, ascale, recov, bad, exhausted = kit.guard(
                out, f, fitted, conv_prev, done, msq, ascale, recov)
            live_ok = live & ~bad  # a rolled-back metric is not a stall
        else:
            live_ok = live
        if tripped is not None:  # nor is a frozen SDC lane's
            live_ok = live_ok & ~tripped
        kit.check_kept(f"step {step + 1} of a scheduler stride", f_new, fitted_new, conv)
        newly = live_ok & (torch.abs(conv - conv_prev) < tol)
        if step == 0:
            newly &= armed
        converged |= newly
        ended = newly
        if kit.recovery:
            diverged |= exhausted
            ended = newly | exhausted
        if tripped is not None:
            sdc |= tripped
            ended = ended | tripped
        if kit.momentum:
            reset = bad if tripped is None else (tripped if bad is None else bad | tripped)
            mom = (f, fitted if kit.carry_fit else None,
                   kit.momentum_tk(out.y, f_new, f, out.t_next, reset))
        itl = itl + live
        f, fitted = f_new, fitted_new
        conv_prev, done = conv, done | ended | (cap_step <= step)
        step += 1
    stopped = done & ~state.done
    status = torch.where(converged, torch.full_like(state.status, SUCCESS), state.status)
    if kit.recovery:
        status = torch.where(diverged, torch.full_like(status, DIVERGED), status)
    if sdc is not None:
        status = torch.where(sdc, torch.full_like(status, SDC_DETECTED), status)
        _note_abft(kit)
    iters = torch.where(stopped, itl, state.iters)
    if mom is not None:
        state = state._replace(f_prev=mom[0], fitted_prev=mom[1], tk=mom[2])
    return state._replace(f=f, fitted=fitted, conv=conv_prev, it=itl, done=done,
                          status=status, iters=iters, ascale=ascale, recov=recov)


def prepare_measurement(measurement, opts: SolverOptions):
    """Host fp64 pre-step (sartsolver_cuda.cpp:138-194): returns
    ``(g64_normalized, msq, norm)``.

    ``norm`` is the measurement's max (1.0 when normalization is off or the
    frame is dark); ``msq`` the normalized ``||g||^2`` over positive
    measurements, remapped to 1.0 for a dark frame so the stop test still
    terminates. Non-finite pixels are excluded from ``norm`` (a NaN-poisoned
    frame still denormalizes by a finite factor) and, as non-positive
    measurements, from the solve's mask, with a warning; each call counts
    them into the ``nonfinite_pixels_total`` counter. They stay
    non-finite in ``g`` (and a +inf pixel makes ``msq`` infinite), so the
    divergence guard's pre-flight check sees them
    (``sartsolver_tpu/models/sart.py:2742-2752``).
    """
    g64 = np.asarray(measurement, dtype=np.float64)
    n_bad = int(np.count_nonzero(~np.isfinite(g64)))
    if n_bad:
        obs_metrics.get_registry().counter("nonfinite_pixels_total").inc(n_bad)
        warnings.warn(
            f"measurement frames contain {n_bad} non-finite pixel(s); they "
            "are excluded from normalization, ||g||^2 and the solve",
            RuntimeWarning, stacklevel=2,
        )
    if opts.normalize:
        norm = float(np.max(g64[np.isfinite(g64)], initial=0.0))
        if norm <= 0:
            norm = 1.0
    else:
        norm = 1.0
    msq = float(np.sum(np.where(g64 > 0, g64, 0.0) ** 2)) / (norm * norm)
    if msq <= 0:
        msq = 1.0
    return g64 / norm, msq, norm


def solve(problem: SARTProblem, measurement, f0=None, *, opts: SolverOptions,
          device="cuda", sweep_fn: SweepFn = fused_sweep) -> SolveResult:
    """Solve one frame on a full problem. ``measurement`` [P] and ``f0``
    [V] are host arrays in physical units; the result is on ``device``."""
    dev = resolve_device(device)
    dtype = torch_dtype(opts.dtype)
    g64, msq, norm = prepare_measurement(measurement, opts)
    g = torch.as_tensor(g64, device=dev).to(dtype)
    nvoxel = problem.rtm.shape[1]
    use_guess = f0 is None
    if use_guess:
        f0 = torch.zeros(nvoxel, dtype=dtype, device=dev)
    else:
        f0 = torch.as_tensor(np.asarray(f0, np.float64) / norm, device=dev).to(dtype)
    res = solve_normalized_batch(
        problem, g[None, :], torch.tensor([msq], dtype=dtype, device=dev),
        f0[None, :], opts=opts, use_guess=use_guess, device=dev,
        sweep_fn=sweep_fn,
    )
    scale = torch.tensor(norm, dtype=dtype, device=dev)
    return SolveResult(res.solution[0] * scale, res.status[0],
                       res.iterations[0], res.convergence[0])
