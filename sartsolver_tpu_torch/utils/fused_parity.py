"""The kernel path against the plain path on the same grid, timed and held.

Counterpart of ``sartsolver_tpu/utils/fused_parity.py``, adapted: where the
JAX protocol times the fused sweep against the unfused two-matmul path on
one mesh, this one runs a solver's frames through the hand-written kernels
(on a pixel-sharded grid the sweep split at the all-reduce,
``ops/fused_sweep.py:sharded_sweep_bp`` / ``sharded_sweep_finish``; else
``fused_sweep``) and through their plain PyTorch versions, on the same
solver and grid, at a fixed number of iterations. The kernel path must have
launched its kernels (on the card) and the two solutions must agree within
``PARITY_RTOL`` of the larger of their scale and 1. Every rank of the grid
calls it, with the same frames. Given an fp64 solver of the same problem,
it also measures how far each fp32 path is from the fp64 solution (the
witness that tells reassociation from a kernel fault: the two paths sit at
like distances from fp64, ``FP64_RATIO``).
"""

from __future__ import annotations

import time

import numpy as np

# fp32 reassociation bound: the kernel and its plain version sum the same
# products in other orders, so anything past this is a regression
PARITY_RTOL = 2e-4
# the fp64 witness's bar: the kernel path's distance to the fp64 solution
# at most this many times the plain path's. On an H100 the kernel path was
# 0.85-0.95 times as far as the plain path (each 0.7e-4 to 1.5e-4 of the
# solution's scale after 15-20 iterations; tests/test_torch_grid_gpu.py's
# banded and random cases and the 2x1 grid's), so the gap between the two
# fp32 paths is their own rounding, not a kernel fault; twice the plain
# path's distance leaves room for other data and still catches a kernel
# that is wrong.
FP64_RATIO = 2.0


def _launches() -> int:
    from sartsolver_tpu_torch.ops import fused_sweep as fs

    return fs.fused_sweep.launches + fs.sharded_sweep_bp.launches + \
        fs.sharded_sweep_finish.launches


def solve_kernel_and_plain(solver, measurements, *, reps: int = 3) -> tuple:
    """Solve ``measurements`` ``[B, npixel]`` (physical units) with
    ``solver`` (a ``DistributedSARTSolver`` whose options fix the iteration
    count, e.g. ``conv_tolerance=0``) through the kernel path, then the
    plain path, each best of ``reps`` timed solves after one warm one.
    Returns ``(record, solutions)``: a flat dict (iterations per second, the
    sweep path each engaged, the kernel launches of one kernel solve) and
    ``{"kernel": x, "plain": x}``, each ``[B, nvoxel]``."""
    import torch

    from sartsolver_tpu_torch.models.sart import FUSED_ENGAGEMENT
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, fused_sweep_reference

    out: dict = {"rtm_dtype": solver.opts.rtm_dtype or solver.opts.dtype}
    sols = {}
    saved = solver.sweep_fn
    try:
        for key, fn in (("kernel", fused_sweep), ("plain", fused_sweep_reference)):
            solver.sweep_fn = fn
            before = _launches()
            res = solver.solve_batch(measurements)  # the warm solve
            out[f"{key}_launches"] = _launches() - before
            out[f"{key}_engaged"] = FUSED_ENGAGEMENT["last"]
            iters = int(np.max(res.iterations))
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                res = solver.solve_batch(measurements)
                if solver.device.type == "cuda":
                    # a timed repetition ends when the device's work does
                    torch.cuda.synchronize(solver.device)  # sart-lint: disable=SL002
                best = min(best, time.perf_counter() - t0)
            out[f"{key}_iter_s"] = iters / best
            sols[key] = res.fetch_solutions()
    finally:
        solver.sweep_fn = saved
    return out, sols


def fp64_distances(reference, measurements, sols) -> dict:
    """The fp64 witness: ``reference`` (the same problem's solver at
    ``dtype="float64"``, the plain path, the same iteration count) solves
    ``measurements``; returns each of ``sols``' largest distance to its
    solution over that solution's largest magnitude (``kernel_to_fp64``,
    ``plain_to_fp64``) and the same for the two fp32 solutions
    (``kernel_to_plain``). fp32 reassociation puts the kernel and the plain
    path at like distances from fp64; a kernel much farther is a fault."""
    x64 = reference.solve_batch(measurements).fetch_solutions()
    scale = max(float(np.max(np.abs(x64))), 1e-300)
    return dict(kernel_to_fp64=float(np.max(np.abs(sols["kernel"] - x64))) / scale,
                plain_to_fp64=float(np.max(np.abs(sols["plain"] - x64))) / scale,
                kernel_to_plain=float(np.max(np.abs(sols["kernel"] - sols["plain"]))) / scale)


def measure_kernel_vs_plain(solver, measurements, *, reps: int = 3, reference=None) -> dict:
    """:func:`solve_kernel_and_plain`, then the checks: returns its record
    with the largest difference (``parity_max_abs_diff``) and, given
    ``reference`` (:func:`fp64_distances`), the fp64 witness's distances.
    Raises ValueError where the kernel path launched no kernel on the card,
    is more than ``FP64_RATIO`` times as far from fp64 as the plain path, or
    the solutions disagree past ``PARITY_RTOL``."""
    out, sols = solve_kernel_and_plain(solver, measurements, reps=reps)
    if reference is not None:
        out.update(fp64_distances(reference, measurements, sols))
    if solver.device.type == "cuda" and out["kernel_launches"] <= 0:
        raise ValueError(f"the kernel path launched no kernel ({out['kernel_engaged']}).")
    if reference is not None and not (
            out["kernel_to_fp64"] <= FP64_RATIO * out["plain_to_fp64"]):
        raise ValueError(f"the kernel path is {out['kernel_to_fp64']:.3e} from fp64, the plain "
                         f"path {out['plain_to_fp64']:.3e} (bar {FP64_RATIO}x)")
    d = float(np.max(np.abs(sols["kernel"] - sols["plain"])))
    scale = float(np.max(np.abs(sols["plain"])))
    out["parity_max_abs_diff"] = d
    if not d <= PARITY_RTOL * max(scale, 1.0):
        raise ValueError(f"kernel-vs-plain parity failed on the {solver.grid_shape} grid: "
                         f"max|d|={d:.3e} vs scale {scale:.3e}")
    out["kernel_vs_plain"] = out["kernel_iter_s"] / max(out["plain_iter_s"], 1e-9)
    return out
