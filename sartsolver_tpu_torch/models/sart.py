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

The JAX ``lax.while_loop`` is a Python loop here; the stop test reads one
flag from the device per iteration.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from sartsolver_tpu_torch.config import (
    MAX_ITERATIONS_EXCEEDED,
    SUCCESS,
    SolverOptions,
)
from sartsolver_tpu_torch.device import check_on, resolve_device
from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep
from sartsolver_tpu_torch.ops.laplacian import LaplacianCOO, coo_matvec
from sartsolver_tpu_torch.ops.projection import back_project, forward_project

# The JAX package's smallest positive constant (its TPU build emulates fp64
# with fp32 range). Kept although this card has real fp64: the log floors
# and epsilons below must clamp exactly as the reference solver does.
MIN_POSITIVE = 1.2e-37

SweepFn = Callable[..., Tuple[Tensor, Tensor]]


class SARTProblem(NamedTuple):
    """Device-resident problem state."""

    rtm: Tensor  # [P, V], opts.dtype
    ray_density: Tensor  # [V], per-voxel column sums
    ray_length: Tensor  # [P], per-pixel row sums
    laplacian: Optional[LaplacianCOO]


class SolveResult(NamedTuple):
    solution: Tensor  # [B, V] (or [V] from solve)
    status: Tensor  # int32: SUCCESS / MAX_ITERATIONS_EXCEEDED
    iterations: Tensor  # int32: completed iterations
    convergence: Tensor  # final Eq. 5 metric C^k


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


def _tiny(value: float) -> float:
    return MIN_POSITIVE if 0.0 < value < MIN_POSITIVE else value


def compute_ray_stats(rtm: Tensor, *, dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """Per-voxel ray density and per-pixel ray length (sartsolver.cpp:38-56)."""
    return rtm.sum(dim=0, dtype=dtype), rtm.sum(dim=1, dtype=dtype)


def make_problem(rtm, laplacian: Optional[LaplacianCOO] = None, *,
                 opts: SolverOptions, device="cuda") -> SARTProblem:
    """Upload the RTM (a host array or a tensor) and compute its ray stats
    in the compute dtype. ``laplacian`` must already live on ``device``."""
    dev = resolve_device(device)
    dtype = torch_dtype(opts.dtype)
    rtm = torch.as_tensor(rtm, device=dev)
    if rtm.ndim != 2:
        raise ValueError(f"rtm must be [P, V], got shape {tuple(rtm.shape)}.")
    if laplacian is not None:
        check_on(dev, laplacian=laplacian.vals)
    dens, length = compute_ray_stats(rtm, dtype=dtype)
    return SARTProblem(rtm.to(dtype).contiguous(), dens, length, laplacian)


def resolve_fused(opts: SolverOptions) -> bool:
    """Whether the loop runs through the fused sweep: fp32 compute with
    ``"auto"`` or ``"on"``. The fp64 profile declines — quietly for
    ``"auto"``, with a ValueError for ``"on"``."""
    if opts.fused_sweep == "off":
        return False
    if opts.dtype != "float32":
        if opts.fused_sweep == "on":
            raise ValueError(
                f"fused_sweep='on' requested but dtype={opts.dtype}; the "
                "fused sweep computes in fp32 with fp32 storage."
            )
        return False
    return True


class _SweepContext:
    """Masks, inverse ray stats, the penalty and one iteration's sweep."""

    def __init__(self, problem: SARTProblem, opts: SolverOptions,
                 sweep_fn: SweepFn):
        self.opts = opts
        self.dtype = torch_dtype(opts.dtype)
        self.rtm = problem.rtm
        self.lap = problem.laplacian
        self.beta = opts.beta_laplace
        self.eps = _tiny(opts.log_epsilon)
        self.fused = resolve_fused(opts)
        self.sweep_fn = sweep_fn

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

    def compute_penalty(self, x: Tensor) -> Tensor:
        """``beta * L @ x`` per frame (zeros without a Laplacian)."""
        return self.beta * coo_matvec(self.lap, x)

    def make_obs(self, g: Tensor, meas_mask: Tensor) -> Tensor:
        """Log variant's observation back-projection, once per measurement."""
        zero = torch.zeros_like(g)
        obs = back_project(self.rtm, torch.where(meas_mask, g, zero) * self.inv_length)
        return torch.where(self.vmask[None, :], obs, torch.zeros_like(obs))

    def run_sweep(self, f: Tensor, fitted: Tensor, penalty: Tensor,
                  g: Tensor, meas_mask: Tensor, obs: Optional[Tensor]
                  ) -> Tuple[Tensor, Optional[Tensor]]:
        """``(f_upd, fitted_upd or None)``: one iteration's update; the
        fused sweep also returns ``H f_upd``."""
        opts = self.opts
        pen = [penalty] if self.lap is not None else []
        if opts.logarithmic:
            w = torch.where(meas_mask, fitted, torch.zeros_like(fitted)) * self.inv_length
            if self.fused:
                return self.sweep_fn(
                    self.rtm, w, f, [self.vm, obs] + pen, logarithmic=True,
                    alpha=float(opts.relaxation), eps=self.eps,
                )
            fit = back_project(self.rtm, w)
            fit = torch.where(self.vmask[None, :], fit, torch.zeros_like(fit))
            eps = torch.tensor(self.eps, dtype=self.dtype, device=f.device)
            ratio = ((obs + eps) / (fit + eps)) ** opts.relaxation
            return f * ratio * torch.exp(-penalty), None
        w = torch.where(meas_mask, g - fitted, torch.zeros_like(g)) * self.inv_length
        if self.fused:
            return self.sweep_fn(
                self.rtm, w, f, [self.inv_density[None, :]] + pen,
                logarithmic=False,
            )
        bp = back_project(self.rtm, w)
        return torch.clamp_min(f + self.inv_density[None, :] * bp - penalty, 0), None


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
    """
    dev = resolve_device(device)
    check_on(dev, rtm=problem.rtm, g=g, msq=msq, f0=f0, fitted0=fitted0)
    dtype = torch_dtype(opts.dtype)
    B = g.shape[0]
    kit = _SweepContext(problem, opts, sweep_fn)
    rtm = problem.rtm
    g = g.to(dtype)
    meas_mask = g >= 0  # [B, P]

    if fitted0 is not None and use_guess:
        raise ValueError(
            "fitted0 carries a warm start's forward projection; it cannot "
            "be combined with use_guess=True."
        )
    if use_guess:
        # Eq. 4: f0 = H^T g / rho on unmasked voxels; the fp32 profile
        # excludes negative measurements (sart_kernels.cu:34)
        g_guess = torch.where(g > 0, g, torch.zeros_like(g)) if opts.mask_negative_guess else g
        accum = back_project(rtm, g_guess)
        f0 = torch.where(kit.vmask[None, :], accum / kit.safe_dens[None, :],
                         torch.zeros_like(accum))
    if fitted0 is None or opts.logarithmic:
        # A linear carried warm start skips the guess floor: it is this
        # solver's own loop-exit solution, and flooring it would break the
        # exact fitted0 == H @ f0 pair. The log variant floors every start:
        # a zero voxel is log(0) in the penalty and never recovers.
        if opts.guess_floor > 0:
            f0 = torch.clamp_min(f0, _tiny(opts.guess_floor))
        if opts.logarithmic:
            f0 = torch.clamp_min(f0, _tiny(max(opts.guess_floor, opts.log_epsilon)))
    f = f0.to(dtype)
    fitted = forward_project(rtm, f) if fitted0 is None else fitted0.to(dtype)

    tol = torch.tensor(opts.conv_tolerance, dtype=dtype, device=dev)
    msq = msq.to(dtype)
    obs = kit.make_obs(g, meas_mask) if opts.logarithmic else None

    conv_prev = torch.zeros(B, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), opts.max_iterations, dtype=torch.int32, device=dev)
    it = 0
    while it < opts.max_iterations and not bool(done.all()):
        penalty = kit.compute_penalty(torch.log(f) if opts.logarithmic else f)
        f_upd, fitted_upd = kit.run_sweep(f, fitted, penalty, g, meas_mask, obs)
        frozen = done[:, None]
        f_new = torch.where(frozen, f, f_upd)  # converged frames freeze
        if fitted_upd is None:
            fitted_new = forward_project(rtm, f_new)
        else:
            fitted_new = torch.where(frozen, fitted, fitted_upd)
        fsq = _sumsq(fitted_new, dtype, opts.precise_convergence)
        conv = (msq - fsq) / msq
        if it >= 1:  # Eq. 5 stall test, from the second iteration on
            newly = ~done & (torch.abs(conv - conv_prev) < tol)
        else:
            newly = torch.zeros_like(done)
        iters = torch.where(newly, torch.full_like(iters, it + 1), iters)
        f, fitted, conv_prev, done = f_new, fitted_new, conv, done | newly
        it += 1
    status = torch.where(
        done, torch.full_like(iters, SUCCESS),
        torch.full_like(iters, MAX_ITERATIONS_EXCEEDED),
    )
    res = SolveResult(f, status, iters, conv_prev)
    return (res, fitted) if return_fitted else res


def prepare_measurement(measurement, opts: SolverOptions):
    """Host fp64 pre-step (sartsolver_cuda.cpp:138-194): returns
    ``(g64_normalized, msq, norm)``.

    ``norm`` is the measurement's max (1.0 when normalization is off or the
    frame is dark); ``msq`` the normalized ``||g||^2`` over positive
    measurements, remapped to 1.0 for a dark frame so the stop test still
    terminates. Non-finite pixels are excluded from both, with a warning.
    """
    g64 = np.asarray(measurement, dtype=np.float64)
    n_bad = int(np.count_nonzero(~np.isfinite(g64)))
    if n_bad:
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
