"""``sartsolve`` for one CUDA device (or the CPU), in PyTorch.

Counterpart of ``sartsolver_tpu/cli.py``'s one-shot solve
(main.cpp:25-151): parse and validate the reference flags, classify and
cross-check the input files, build the composite measurement stream, read
the RTM whole on the host and upload it once, then solve the frames in order
— each warm-started from the previous frame's solution unless
``--no_guess`` — and write the solution file and the voxel map.

The warm start stays on the device: the previous solution and its loop-exit
``fitted == H @ f`` are rescaled by ``norm_prev / norm_new`` and seed the
next frame, which then skips its setup forward projection.

Three loops carry the stream:

- the warm-start chain (``--chain_frames K``, default 8): K frames per
  dispatch, the warm carry crossing group boundaries on the device;
  ``--chain_frames 1`` is the serial loop, and every K gives the same
  frames byte for byte;
- with ``--no_guess --batch_frames K`` the continuous-batching scheduler
  (``sched/``): K lanes, converged lanes retired and backfilled every
  ``--schedule_stride`` iterations;
- with ``--no_continuous_batching`` (and ``--no_guess`` at K = 1) the
  classic grouped loop: K frames per dispatch, run to the slowest, the tail
  padded with dark frames so every dispatch runs at B = K. The scheduler's
  frames equal its frames byte for byte.

A device out-of-memory in the scheduler or the grouped loop halves the
group size (``resilience/degrade.py``) and re-solves the same frames.

``--device cuda`` (the default) runs the fp32 profile on the card through the
fused-sweep kernel; ``--device cpu`` runs the same profile on the CPU with
the kernel's plain version. ``--use_cpu`` is the fp64 parity profile on the
CPU, as in the JAX package.

``--rtm_dtype`` picks the stored matrix's dtype. The matrix is read whole as
fp32 on the host, rounded to bf16 or quantized to int8 codes there, and only
the stored matrix is uploaded.

The solver variants of the JAX CLI: ``--relaxation_decay`` (iteration k
steps by ``relaxation * decay**k``), ``--momentum nesterov``,
``--divergence_recovery N`` (a frame that diverges is rolled back with a
halved step up to N times, then written with status DIVERGED, -2, as is a
frame with non-finite pixels; the run goes on and exits 2) and
``--os_subsets N`` (ordered subsets: the subset cycle replaces the fused
sweep, on every storage). Each works in every frame loop. ``--fused_sweep``
as in the JAX CLI, without its ``interpret`` mode.

``--debug_nans`` aborts the run with ``FloatingPointError`` (a traceback,
no row written for it) at the first NaN the solver keeps, where the JAX
CLI's ``jax_debug_nans`` aborts (``sartsolver_tpu_torch/debug_nans.py``).

Observability as in the JAX CLI (``obs/``): ``--timing`` prints the phase
summary (``validate + index inputs``, ``ingest RTM + upload``, ``frame loop
(solve + prefetch + flush)``, ``write voxel map``, with the per-frame and
per-group solve rows), the sweep path the solver engaged and the run's
summary; ``--metrics_out FILE`` writes the JSONL run artifact,
``SART_METRICS_PROM`` a Prometheus textfile and ``SART_TRACE_EVENTS`` a
Chrome trace of the host spans; ``--profile_dir DIR`` a ``torch.profiler``
trace of the frame loop. With no sink and no ``--timing`` stdout and the
solution file are what they are without the layer. ``sartsolve metrics``
validates, summarizes and diffs artifacts of either package.

Usage: ``python -m sartsolver_tpu_torch.cli -o solution.h5 RTM... IMAGE...``,
``python -m sartsolver_tpu_torch.cli metrics [--check | --diff] FILE...``
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import os
import sys
import time as _time
from typing import List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sartsolve",
        description="Impurity flux reconstruction for ITER: emissivity "
                    "(PyTorch, one device).",
        epilog="exit codes: 0 success; 1 input/flag error; 2 run completed "
               "with DIVERGED frames.",
    )
    p.add_argument("-o", "--output_file", default="solution.h5",
                   help="Filename to save the solution.")
    p.add_argument("-t", "--time_range", default="",
                   help="Time intervals in s to process in a form: "
                        "start:stop:(step):(synch_threshold), e.g. "
                        "'20.5:40.1, 45.2:51:1.5:0.05'. The step and the "
                        "synchronization threshold are optional.")
    p.add_argument("-w", "--wavelength_threshold", type=float, default=50.0,
                   help="An RTM is considered valid if its wavelength is within "
                        "this threshold of the image wavelength (in nm).")
    p.add_argument("-d", "--ray_density_threshold", type=float, default=1.0e-6,
                   help="Voxels with ray density lesser than this threshold are ignored.")
    p.add_argument("-r", "--ray_length_threshold", type=float, default=1.0e-6,
                   help="Pixels with ray length lesser than this threshold are ignored.")
    p.add_argument("-m", "--max_iterations", type=int, default=2000,
                   help="Maximum number of SART iterations.")
    p.add_argument("-c", "--conv_tolerance", type=float, default=1.0e-5,
                   help="SART convolution relative tolerance.")
    p.add_argument("-l", "--laplacian_file", default="",
                   help="File with laplacian regularization matrix.")
    p.add_argument("-b", "--beta_laplace", type=float, default=2.0e-2,
                   help="Weight of the regularization factor.")
    p.add_argument("-R", "--relaxation", type=float, default=1.0,
                   help="Relaxation parameter.")
    p.add_argument("--relaxation_decay", type=float, default=1.0,
                   help="Geometric relaxation schedule: iteration k uses "
                        "relaxation * decay^k. Default 1.0 (fixed "
                        "relaxation, reference behavior).")
    p.add_argument("--os_subsets", type=int, default=1,
                   help="Ordered-subsets SART: cycle each iteration's "
                        "update over N interleaved pixel-row subsets; must "
                        "divide the pixel extent padded to a multiple of 8. "
                        "Default 1 (classic sweep, byte-identical).")
    p.add_argument("--momentum", default="off", choices=["off", "nesterov"],
                   help="Nesterov/FISTA momentum over the SART update "
                        "with gradient-based restart; resets on every "
                        "divergence-recovery rollback. Default off.")
    p.add_argument("--divergence_recovery", type=int, default=0,
                   help="In-solve divergence guard: a frame whose "
                        "residual metric goes non-finite or exploding "
                        "rolls back to its last good iterate and "
                        "retries with halved relaxation, up to N "
                        "escalations; exhaustion (or non-finite input "
                        "data) marks the frame DIVERGED (status -2) "
                        "and the run continues, exiting 2. 0 (default) "
                        "disables the guard.")
    p.add_argument("--fused_sweep", default="auto",
                   choices=["auto", "on", "off", "interpret"],
                   help="Fused iteration sweep (one call of the hand-written "
                        "kernel per iteration): auto engages it wherever it "
                        "can (fp32 compute), on requires it, off runs the "
                        "two-matmul sweep. interpret (the JAX package's "
                        "Pallas interpreter) does not exist here.")
    p.add_argument("-n", "--raytransfer_name", default="with_reflections",
                   help="Ray transfer matrix dataset name.")
    p.add_argument("-L", "--logarithmic", action="store_true",
                   help="Use logarithmic SART solver.")
    p.add_argument("--max_cached_frames", type=int, default=100,
                   help="Maximum number of cached image frames.")
    p.add_argument("--max_cached_solutions", type=int, default=100,
                   help="Maximum number of cached solutions.")
    p.add_argument("--no_guess", action="store_true",
                   help="Do not use solution found on previous time moment as "
                        "initial guess for the next one.")
    p.add_argument("--use_cpu", action="store_true",
                   help="Perform all calculations on CPUs (fp64 parity profile).")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device of the fp32 profile (default cuda). Without a "
                        "CUDA device the run stops; --device cpu runs the "
                        "same profile on the CPU.")
    p.add_argument("--rtm_dtype", default=None,
                   choices=["float32", "bfloat16", "float64", "int8"],
                   help="On-device RTM storage dtype. bfloat16 halves the "
                        "memory traffic of the two dominant sweeps; int8 "
                        "quarters it via per-voxel-scaled quantized codes "
                        "(opt-in: solves the quantized system; needs the "
                        "fused sweep).")
    p.add_argument("--batch_frames", type=int, default=1,
                   help="Solve N composite frames per device program "
                        "(the sweep runs at batch N; the RTM is read once "
                        "per iteration for the whole batch). Requires "
                        "--no_guess, since batched frames carry no "
                        "warm-start dependency. Uses N continuously-batched "
                        "lanes by default (see --no_continuous_batching).")
    p.add_argument("--schedule_stride", type=int, default=None,
                   help="Continuous batching: iterations between scheduler "
                        "control returns — converged lanes retire and "
                        "backfill from the frame queue every N iterations "
                        "(larger strides amortize the per-stride host sync, "
                        "smaller strides track convergence tighter). "
                        "Default: SART_SCHEDULE_STRIDE env, else 16.")
    p.add_argument("--no_continuous_batching", action="store_true",
                   help="Disable the convergence-aware lane scheduler for "
                        "--batch_frames > 1 and run the classic "
                        "run-to-slowest group loop (each batch waits for its "
                        "slowest frame; converged lanes pad the device until "
                        "the batch drains).")
    p.add_argument("--chain_frames", type=int, default=8,
                   help="Warm-started frames dispatched per group (the "
                        "previous solution carried on the device): one "
                        "result fetch per N frames instead of per frame, "
                        "with per-frame results identical to serial "
                        "dispatch. 1 disables. Applies to the default "
                        "warm-start loop; ignored with "
                        "--no_guess/--batch_frames.")
    p.add_argument("--debug_nans", action="store_true",
                   help="Abort with a traceback at the first NaN the solver "
                        "keeps (an iterate, a projection, a metric, a "
                        "scheduler lane's state) instead of propagating it "
                        "into the solution (one host sync a step; debugging "
                        "only).")
    p.add_argument("--profile_dir", default=None,
                   help="Write a torch.profiler trace of the frame loop "
                        "here. Each frame group (serial and chain paths) / "
                        "scheduler stride (batched path) is one profiler "
                        "step, so the device trace aligns with obs spans "
                        "and frame serials instead of one undifferentiated "
                        "blob.")
    p.add_argument("--timing", action="store_true",
                   help="Print a per-phase wall-clock summary (validation, "
                        "RTM ingest and upload, the frame loop with its "
                        "per-frame and per-group solve rows — the first "
                        "includes the kernel's first load — and the "
                        "voxel-map write) at the end of the run.")
    o11y = p.add_argument_group(
        "observability options",
        "structured telemetry: host-side only, zero-cost when disabled. "
        "Environment sinks: SART_METRICS_PROM writes a Prometheus textfile "
        "at end of run, SART_TRACE_EVENTS writes Chrome trace-event JSON "
        "(Perfetto) of the pipeline's host phases alongside --profile_dir's "
        "torch.profiler trace.")
    o11y.add_argument("--metrics_out", default=None, metavar="FILE",
                      help="Write the run's telemetry artifact here as "
                           "JSONL (meta, per-frame solve records, "
                           "availability events, end-of-run metrics, "
                           "summary); validate/summarize/diff it with "
                           "`sartsolve metrics`.")
    p.add_argument("input_files", nargs="*",
                   help="List of ray transfer matrix and camera image hdf5 files.")
    return p


def _validate(args) -> None:
    """Range validation mirroring arguments.cpp:184-236."""
    def fail(msg: str) -> None:
        print(msg, file=sys.stderr)
        raise SystemExit(1)

    if args.ray_density_threshold < 0:
        fail(f"Argument ray_density_threshold must be >= 0, {args.ray_density_threshold} given.")
    if args.ray_length_threshold < 0:
        fail(f"Argument ray_length_threshold must be >= 0, {args.ray_length_threshold} given.")
    if args.max_iterations < 1:
        fail(f"Argument max_iterations must be >= 1, {args.max_iterations} given.")
    if args.max_iterations > 2**24:
        fail(f"Argument max_iterations must be <= {2**24}, "
             f"{args.max_iterations} given.")
    if args.conv_tolerance <= 0:
        fail(f"Argument conv_tolerance must be > 0, {args.conv_tolerance} given.")
    if not (0 < args.relaxation <= 1.0):
        fail(f"Argument relaxation must be within (0, 1] interval, {args.relaxation} given.")
    if not (0 < args.relaxation_decay <= 1.0):
        fail("Argument relaxation_decay must be within (0, 1] interval, "
             f"{args.relaxation_decay} given.")
    if args.divergence_recovery < 0:
        fail("Argument divergence_recovery must be >= 0, "
             f"{args.divergence_recovery} given.")
    if args.os_subsets < 1:
        fail(f"Argument os_subsets must be >= 1, {args.os_subsets} given.")
    if args.os_subsets > 1 and args.fused_sweep in ("on", "interpret"):
        fail(f"Argument os_subsets > 1 runs the subset-cycle sweep; "
             f"--fused_sweep {args.fused_sweep} cannot be honored there — "
             "use auto or off.")
    if args.fused_sweep == "interpret":
        fail("Argument fused_sweep='interpret' runs the JAX package's Pallas "
             "interpreter, which this package does not have; use auto, on or "
             "off (--device cpu runs the kernel's plain version).")
    if args.beta_laplace < 0:
        fail("Argument beta_laplace must be positive.")
    if args.rtm_dtype == "int8" and args.use_cpu:
        fail("Argument rtm_dtype='int8' needs the fp32 device profile; "
             "it cannot be combined with --use_cpu.")
    if args.batch_frames < 1:
        fail(f"Argument batch_frames must be >= 1, {args.batch_frames} given.")
    if args.batch_frames > 1 and not args.no_guess:
        fail("Argument batch_frames > 1 requires --no_guess (batched frames "
             "have no warm-start dependency).")
    if args.chain_frames < 1:
        fail(f"Argument chain_frames must be >= 1, {args.chain_frames} given.")
    if args.schedule_stride is not None and args.schedule_stride < 1:
        fail(f"Argument schedule_stride must be >= 1, "
             f"{args.schedule_stride} given.")
    if args.max_cached_frames <= 0:
        fail("Argument max_cached_frames must be positive.")
    if args.max_cached_solutions <= 0:
        fail("Argument max_cached_solutions must be positive.")
    if len(args.input_files) < 2:
        fail("At least two input file, one with RTM and one with image, are "
             f"required, {len(args.input_files)} given.")


class _FrameLoopProfile:
    """``--profile_dir``: ``torch.profiler`` over the frame loop, one
    profiler step per frame group or scheduler stride (the JAX CLI's
    ``StepTraceAnnotation``), its Chrome trace written into the directory
    as ``PROFILE_TRACE`` when the loop ends. On the card it records CUDA
    activity too. A trace that cannot be taken or written fails the run."""

    def __init__(self, directory: str, device):
        from torch.profiler import ProfilerAction, ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, PROFILE_TRACE)
        # a schedule that records every step: with one, the profiler marks
        # each step as a ProfilerStep#N range
        self._prof = profile(activities=activities,
                             schedule=lambda _step: ProfilerAction.RECORD,
                             on_trace_ready=lambda prof: prof.export_chrome_trace(path))
        self._opened = False

    def __enter__(self) -> "_FrameLoopProfile":
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._prof.__exit__(*exc)

    def step(self) -> None:
        """Called as each group or stride begins: the step the profiler
        opened at its start is the first one's, each later call closes the
        previous step and opens the next."""
        if self._opened:
            self._prof.step()
        self._opened = True


# the file --profile_dir writes
PROFILE_TRACE = "sartsolve.pt.trace.json"


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "metrics":
        # artifact tooling: validate, summarize and diff --metrics_out
        # artifacts; dispatched before the solver parser, which would read
        # "metrics" as an input file
        from sartsolver_tpu_torch.obs.cli import metrics_main

        return metrics_main(argv[1:])
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as err:
        # argparse exits 2 on a malformed flag; the reference's contract is 1
        raise SystemExit(1 if err.code else 0) from None
    _validate(args)

    from sartsolver_tpu_torch.obs.run import RunTelemetry
    from sartsolver_tpu_torch.resilience.failures import RunSummary

    # a fresh per-run metrics registry (--timing's PhaseTimer is a view
    # over it) and the sinks --metrics_out, SART_METRICS_PROM and
    # SART_TRACE_EVENTS ask for; with none, nothing more is written or
    # printed
    telem = RunTelemetry.from_cli(args.metrics_out)
    summary = RunSummary()
    try:
        return _run(args, telem, summary)
    finally:
        # an error exit's artifact, marked partial: a no-op after the
        # completed run's finalize, or with no sink
        telem.finalize_local(summary)


def _run(args, telem, summary) -> int:
    """The solve of :func:`main` after its flags are validated: per-frame
    and per-event accounting goes to ``telem`` (``obs/run.py``) and
    ``summary`` (``resilience/failures.py``)."""
    import torch

    from sartsolver_tpu_torch.config import (
        DIVERGED, SartInputError, SolverOptions, parse_time_intervals,
    )
    from sartsolver_tpu_torch.device import resolve_device
    from sartsolver_tpu_torch.io import hdf5files as hf
    from sartsolver_tpu_torch.io.image import CompositeImage
    from sartsolver_tpu_torch.io.laplacian_io import read_laplacian
    from sartsolver_tpu_torch.io.raytransfer import read_rtm_block
    from sartsolver_tpu_torch.io.solution import SolutionWriter
    from sartsolver_tpu_torch.io.voxelgrid import make_voxel_grid
    from sartsolver_tpu_torch.models.sart import (
        FUSED_ENGAGEMENT, INT8_MAX_CONTRACTION, resolve_fused, torch_dtype,
    )
    from sartsolver_tpu_torch.obs import trace as obs_trace
    from sartsolver_tpu_torch.ops.laplacian import make_laplacian
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver, os_padded_rows
    from sartsolver_tpu_torch.resilience.degrade import GroupSizeLadder, dispatch_guarded
    from sartsolver_tpu_torch.sched import ContinuousBatcher
    from sartsolver_tpu_torch.utils.timing import PhaseTimer

    timer = PhaseTimer(registry=telem.registry)
    t_phase = _time.perf_counter()
    try:
        device = resolve_device("cpu" if args.use_cpu else args.device)
    except RuntimeError as err:
        print(err, file=sys.stderr)
        return 1

    def mark(phase: str) -> None:
        """End a --timing phase. The device finishes the phase's work first
        (an upload or the ray stats may still run when the host returns),
        so each phase holds its own device time: a handful of syncs a run."""
        nonlocal t_phase
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = _time.perf_counter()
        timer.add(phase, now - t_phase)
        t_phase = now

    FUSED_ENGAGEMENT["last"] = None
    try:
        time_intervals = parse_time_intervals(args.time_range)

        # ---- pre-flight validation gate (main.cpp:30-59) -----------------
        matrix_files, image_files = hf.categorize_input_files(args.input_files)
        rtm_name = args.raytransfer_name
        hf.check_group_attribute_consistency(matrix_files, f"rtm/{rtm_name}", ["wavelength"])
        hf.check_group_attribute_consistency(matrix_files, "rtm/voxel_map", ["nx", "ny", "nz"])
        sorted_matrix_files = hf.sort_rtm_files(matrix_files)
        hf.check_rtm_frame_consistency(sorted_matrix_files)
        hf.check_rtm_voxel_consistency(sorted_matrix_files)
        hf.check_group_attribute_consistency(image_files, "image", ["wavelength"])
        sorted_image_files = hf.sort_image_files(image_files)
        camera_names = list(sorted_image_files)
        hf.check_rtm_image_consistency(
            sorted_matrix_files, sorted_image_files, rtm_name, args.wavelength_threshold
        )
        npixel, nvoxel = hf.get_total_rtm_size(sorted_matrix_files)
        rtm_frame_masks = hf.read_rtm_frame_masks(sorted_matrix_files)
        mark("validate + index inputs")

        # continuous-batching stride: the flag, else SART_SCHEDULE_STRIDE,
        # else the SolverOptions default (16); a malformed value fails
        # loudly, as the flag would
        if args.schedule_stride is not None:
            schedule_stride = args.schedule_stride
        else:
            stride_env = os.environ.get("SART_SCHEDULE_STRIDE", "16")
            try:
                schedule_stride = int(stride_env)
            except ValueError:
                raise SartInputError(
                    f"SART_SCHEDULE_STRIDE must be an integer >= 1, "
                    f"{stride_env!r} given."
                ) from None
        if schedule_stride < 1:
            raise SartInputError(
                f"SART_SCHEDULE_STRIDE must be >= 1, {schedule_stride} given."
            )

        common = dict(
            schedule_stride=schedule_stride,
            logarithmic=args.logarithmic,
            ray_density_threshold=args.ray_density_threshold,
            ray_length_threshold=args.ray_length_threshold,
            conv_tolerance=args.conv_tolerance,
            beta_laplace=args.beta_laplace,
            relaxation=args.relaxation,
            max_iterations=args.max_iterations,
            rtm_dtype=args.rtm_dtype,
            relaxation_decay=args.relaxation_decay,
            momentum=args.momentum,
            divergence_recovery=args.divergence_recovery,
            os_subsets=args.os_subsets,
            fused_sweep=args.fused_sweep,
        )
        opts = (SolverOptions.cpu_parity(**common) if args.use_cpu
                else SolverOptions(**common))
        dtype = torch_dtype(opts.dtype)
        storage = opts.rtm_dtype or opts.dtype
        try:
            fused = resolve_fused(opts)
        except ValueError as err:  # fused_sweep='on' where it cannot engage
            raise SartInputError(str(err)) from None
        try:
            os_padded_rows(npixel, opts.os_subsets)
        except ValueError as err:  # --os_subsets divides no extent the solver pads to
            raise SartInputError(str(err)) from None
        # the OS cycle's products upcast int8 codes themselves: int8 needs
        # the fused sweep only on the classic sweep
        if storage == "int8" and not fused and opts.os_subsets == 1:
            why = (" (divergence_recovery keeps the logarithmic solver off it)"
                   if opts.divergence_recovery and opts.logarithmic else "")
            raise SartInputError(
                "Argument rtm_dtype='int8' requires the fused sweep, but it "
                f"resolved off{why}. Use --fused_sweep auto/on, float32 or "
                "bfloat16 storage, or the linear solver."
            )
        if storage == "int8" and max(npixel, nvoxel) > INT8_MAX_CONTRACTION:
            raise SartInputError(
                f"Argument rtm_dtype='int8': RTM extent {max(npixel, nvoxel)} "
                f"exceeds the int32-accumulation bound {INT8_MAX_CONTRACTION}; "
                "use fp32/bfloat16 storage."
            )
        # artifact provenance, the JAX CLI's meta fields; the variant fields
        # also ride every frame record (obs/run.py)
        telem.set_run_info(
            backend=device.type, mesh="1x1", processes=1, rtm_dtype=str(storage),
            compute_dtype=str(opts.dtype), fused_sweep=str(opts.fused_sweep),
            logarithmic=bool(args.logarithmic), os_subsets=int(opts.os_subsets),
            momentum=str(opts.momentum), operator="dense",
        )
        telem.registry.gauge("solver_os_subsets").set(float(opts.os_subsets))
        telem.registry.gauge("solver_momentum_on").set(
            1.0 if opts.momentum != "off" else 0.0)

        lap = None
        if args.laplacian_file:
            rows, cols, vals = read_laplacian(args.laplacian_file, nvoxel)
            lap = make_laplacian(rows, cols, vals, nvoxel=nvoxel, dtype=dtype,
                                 device=device)

        composite_image = CompositeImage(
            sorted_image_files, rtm_frame_masks, time_intervals, npixel,
            max_cache_size=args.max_cached_frames,
        )
        # the whole matrix on the host, stored there as the card will hold
        # it (make_problem quantizes a host matrix to int8 on the host), and
        # uploaded once. bf16 is rounded first, so the ray stats are those
        # of the stored matrix, as the JAX CLI's are.
        with obs_trace.span("ingest.rtm", npixel=npixel, nvoxel=nvoxel):
            rtm = read_rtm_block(sorted_matrix_files, rtm_name, npixel, nvoxel,
                                 dtype=np.float64 if storage == "float64" else np.float32)
            if storage == "bfloat16":
                rtm = torch.from_numpy(rtm).to(torch.bfloat16)
            solver = DistributedSARTSolver(rtm, lap, opts=opts, device=device,
                                           debug_nans=args.debug_nans)
            del rtm
        grid = make_voxel_grid(next(iter(sorted_matrix_files.values())), "rtm/voxel_map")
        sweep = ("os-subset" if opts.os_subsets > 1 else "fused" if fused
                 else "two-matmul")
        print(f"solver: device={device} rtm_dtype={storage} compute={opts.dtype} "
              f"sweep={sweep} rtm=[{npixel}, {nvoxel}]"
              + (f" os_subsets={opts.os_subsets}" if opts.os_subsets > 1 else ""))
        mark("ingest RTM + upload")

        # one stream of (frame, time, camera times), shared by the loops
        frames = ((composite_image.frame(i), composite_image.frame_time(i),
                   composite_image.camera_frame_time(i))
                  for i in range(len(composite_image)))

        def note_event(message: str) -> None:
            """An availability event (an OOM halving, the scheduler's
            hand-back): stderr, the end-of-run summary and the telemetry."""
            print(message, file=sys.stderr)
            summary.record_event(message)
            telem.record_event(message)

        # ---- frame loops (main.cpp:131-140) ------------------------------
        profile = (_FrameLoopProfile(args.profile_dir, device) if args.profile_dir
                   else None)
        step = profile.step if profile is not None else (lambda: None)

        with solver, SolutionWriter(args.output_file, camera_names, nvoxel,
                                    max_cache_size=args.max_cached_solutions) as writer, \
                profile if profile is not None else contextlib.nullcontext():

            def write(solution, status, ftime, cam_times, iterations, convergence,
                      ms, group):
                """One row: the file, the run summary and the telemetry."""
                writer.add(solution, status, ftime, cam_times, iterations=iterations)
                summary.record_status(status, ftime)
                telem.record_frame(ftime, status, iterations, convergence, ms, group)

            def run_grouped(K, batch, solve_group, items):
                """The frame-group protocol of the batch and chain loops:
                collect K frames, solve them as one dispatch, write one row
                per frame. The batch loop (``batch``) pads a short last
                group to K with dark frames, so every dispatch runs at the
                same B (the same kernel plan and product shapes as the
                scheduler's K lanes), and a device OOM halves its group and
                re-solves the same frames (GroupSizeLadder). The chain loop
                does neither: a padded frame would cost its own iterations,
                and a chain solves its frames one at a time at B = 1, so a
                smaller group would need no less memory. The JAX loop's
                one-deep pipelining is left out: each solve reads a done
                flag every iteration, so a dispatch returns only when its
                group is done and there is nothing to overlap.

                A group's time per frame runs from the end of the previous
                group (reading and writing frames included), as the
                scheduler's runs from its previous retirement. At K = 1 (the
                serial loop) the telemetry names each frame's group
                ``frame`` and its --timing row ``solve frame``, as the JAX
                CLI's serial loop does."""
                label = "batch" if batch else "chain"
                group_label = label if K > 1 else "frame"
                timer_row = f"solve {label} (pipelined wall)" if K > 1 else "solve frame"
                ladder = GroupSizeLadder(K, on_event=note_event) if batch else None
                pending = []
                t_last = _time.perf_counter()

                def flush(final: bool) -> None:
                    nonlocal t_last
                    size = ladder.size if ladder else K
                    while pending and (final or len(pending) >= size):
                        group = pending[:size]
                        stack = np.stack([fr for fr, _, _ in group])
                        if batch and len(group) < size:
                            dark = np.zeros((size - len(group), stack.shape[1]))
                            stack = np.concatenate([stack, dark])
                        step()
                        result, _ = dispatch_guarded(lambda: solve_group(stack),
                                                     ladder=ladder)
                        if result is None:  # OOM: the same frames, halved
                            size = ladder.size
                            continue
                        statuses, iterations = result.status, result.iterations
                        solutions = result.fetch_solutions()
                        now = _time.perf_counter()
                        # inside the frame-loop phase: a detail row, kept
                        # out of the total
                        timer.add(timer_row, now - t_last, detail=True)
                        per_frame_ms = (now - t_last) * 1e3 / len(group)
                        t_last = now
                        for b, (_, ftime, cam_times) in enumerate(group):
                            write(solutions[b], int(statuses[b]), ftime, cam_times,
                                  int(iterations[b]), float(result.convergence[b]),
                                  per_frame_ms, group_label)
                            print(f"Processed in: {per_frame_ms} ms (average over "
                                  f"{label} of {len(group)}; {int(iterations[b])} "
                                  "iterations)")
                        del pending[:len(group)]

                for item in items:
                    pending.append(item)
                    if len(pending) >= (ladder.size if ladder else K):
                        flush(final=False)
                flush(final=True)
                line = ladder.summary() if ladder else None
                if line:
                    print(line)

            def run_scheduled(K):
                """K lanes, retired and backfilled every schedule_stride
                iterations. After a device OOM the grouped loop finishes the
                run at half the size, on the frames the scheduler handed
                back chained with the same frame iterator."""
                def on_result(ftime, cam_times, status, iterations, convergence, fetcher,
                              per_frame_ms):
                    write(fetcher(), status, ftime, cam_times, iterations, convergence,
                          per_frame_ms, "sched")
                    timer.add("solve sched (pipelined wall)", per_frame_ms / 1e3,
                              detail=True)
                    print(f"Processed in: {per_frame_ms} ms (continuous batch of {K} "
                          f"lanes; {iterations} iterations)")

                batcher = ContinuousBatcher(solver, lanes=K, on_result=on_result,
                                            on_event=note_event, on_stride=step)
                stats = batcher.run(frames)
                print(f"continuous batching: lanes={K} strides={stats.strides} "
                      f"loop_steps={stats.loop_steps} occupancy={stats.occupancy}")
                if stats.leftover is not None:
                    run_grouped(max(K // 2, 1), True, solver.solve_batch,
                                itertools.chain(stats.leftover, frames))

            if args.no_guess:
                if args.batch_frames > 1 and not args.no_continuous_batching:
                    run_scheduled(args.batch_frames)
                else:
                    run_grouped(args.batch_frames, True, solver.solve_batch, frames)
            else:
                # the warm carry (the last result, on the device) crosses
                # group boundaries
                chain = {"warm": None}

                def solve_chain_group(stack):
                    chain["warm"] = solver.solve_chain(stack, warm=chain["warm"])
                    return chain["warm"]

                run_grouped(args.chain_frames, False, solve_chain_group, frames)

        mark("frame loop (solve + prefetch + flush)")
        with obs_trace.span("flush.voxel_map"):
            grid.write_hdf5(args.output_file, "voxel_map")
        mark("write voxel map")
        if args.timing:
            print(timer.summary())
            print(f"fused sweep: requested={args.fused_sweep} "
                  f"resolved={opts.fused_sweep} "
                  f"engaged={FUSED_ENGAGEMENT['last'] or 'not traced'}")
            print(summary.format())
        diverged = summary.failed_times  # the port writes no FAILED or SDC rows
        if diverged:
            shown = ", ".join(f"{t:g}" for t in diverged[:8])
            print(f"{len(diverged)} frame(s) DIVERGED (status {DIVERGED}) at time(s) "
                  f"{shown}{' ...' if len(diverged) > 8 else ''}", file=sys.stderr)
        telem.finalize(summary)
        return 2 if summary.n_failed else 0
    except KeyError as err:
        # a missing dataset or attribute raises KeyError
        print(f"Missing dataset or attribute in input files: {err}", file=sys.stderr)
        return 1
    except (SartInputError, OSError) as err:
        # only input problems get the reference's message + exit(1); any
        # other exception is a bug and tracebacks
        print(err, file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
