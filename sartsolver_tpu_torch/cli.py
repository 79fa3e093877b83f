"""``sartsolve`` for one CUDA device (or the CPU), in PyTorch.

Counterpart of ``sartsolver_tpu/cli.py``'s one-shot solve
(main.cpp:25-151): parse and validate the reference flags, classify and
cross-check the input files, build the composite measurement stream, stream
the RTM into a device buffer once, then solve the frames in order
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

``--rtm_dtype`` picks the stored matrix's dtype. The matrix is streamed in
row chunks (``SART_INGEST_CHUNK_ROWS``) through pinned host buffers into a
device buffer of that dtype (``parallel/multihost.py``): the host never
holds the matrix, bf16 is rounded and int8 quantized (two passes over the
file) on the device.

The read / solve / write pipeline of the JAX CLI: a reader thread
prefetches the frames (``utils/prefetch.py``) and a writer thread writes
the solution file (``utils/asyncwriter.py``, ``SART_WRITER_QUEUE`` frames
queued, default 16). The RTM's row chunks and the frames are read under a
bounded retry policy (``SART_RETRY_*``). A frame whose read fails past its
retries, or whose staging or solve dispatch fails with a recoverable error
(``resilience/failures.py:RECOVERABLE_FRAME_ERRORS``), is written as a
FAILED row (status -3, zeros) and the run goes on, exiting 2; the warm start
carries over the dead frame. ``--fail_fast`` turns that isolation off. An
RTM ingest that exhausts its retries, or a failed flush of the solution
file, exits 3. ``SART_FAULT`` arms the named fault sites
(``resilience/faults.py``) for drills.

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

The resilience of a run, as in the JAX CLI (``sartsolver_tpu/cli.py:41-57``):

- ``--resume`` skips the frames the output file already holds (a frame
  time within 1e-12), warm-starts the chain from its last row and appends;
  a torn last flush is truncated first, a corrupt row or another voxel
  count or camera set refuses the resume (exit 1). FAILED rows are not
  retried.
- SIGTERM or SIGINT stops the run at the next frame-group boundary (a
  scheduler stride): the group in flight drains, the file is flushed and
  the run exits 4, resumable; a second signal aborts at once
  (``resilience/shutdown.py``).
- ``SART_WATCHDOG_TIMEOUT`` arms the hang watchdog
  (``resilience/watchdog.py``): a frame whose staging or dispatch hangs is
  interrupted and written FAILED (exit 2), or with ``--fail_fast`` (or a
  hang outside the frame loop) the run exits 3; past the grace it exits 3
  by ``os._exit``. ``SART_HEARTBEAT_FILE`` is rewritten on every frame.
  The CUDA extension's first build beacons only before and after ``nvcc``:
  a cold build longer than the timeout aborts the run.
- The flight recorder (``obs/flight.py``): SIGUSR1 writes the status
  snapshot to ``<output>.status.json`` (and a line on stderr), and every
  abnormal exit writes ``<output>.crash.json``; ``sartsolve top FILE``
  renders either, a heartbeat file or a Prometheus textfile.
- ``--integrity`` (or ``SART_INTEGRITY=1``): the in-solve ABFT check on the
  fused sweep's output, the RTM chunks read twice and digested, the ray
  stats held against the ingest's sums after the upload and re-audited
  every ``SART_INTEGRITY_REAUDIT`` frames (default 64). A frame that trips
  is re-solved once through the same kernel and plan; a frame that trips
  again is written FAILED, and ``SART_SDC_ABORT_THRESHOLD`` such frames
  (default 2), or a resident mismatch, quarantine the run (exit 3). The
  ingest's sums run where the stored rows lie (fp64 on the card).

``--sparse_rtm auto|off|EPS`` (or ``SART_SPARSE_RTM``) runs the block-sparse
RTM: the ingest takes the matrix's 8 x 128 tile maxima on the device, the
index (``ops/sparse.py``) is cut at ``EPS * max|H|`` (0 for ``auto``: exact
zeros only), and the solver keeps only the occupied tile columns, the
dropped tiles zeroed, so every sweep reads the occupied columns alone
(``models/sart.py``). ``auto`` declines where it cannot engage; an explicit
EPS exits 1 there.

``--lowrank_rtm auto|off|RANK`` (or ``SART_LOWRANK_RTM``) runs the factored
RTM, ``H ~= S + U V^T``: the whole matrix is read on the host, split at 5%
of max|H| into a tile-thresholded sparse core S and the residual's
randomized-SVD factors, behind the quality gate (the Frobenius residual,
then a 20-iteration solve against the dense solve on the card); ``auto``
declines loudly to the dense path where no rank passes, an explicit RANK
exits 1 there. The solver keeps S's occupied columns and the factors on
the device (``operators/lowrank.py``). ``--geometry FILE`` runs the
matrix-free operator on a versioned geometry record (``operators/
geometry.py``): image files only as inputs, the device holds the ``[P, 6]``
ray table, every projection the hand-written projector
(``ops/csrc/implicit.cu``). Both print the JAX CLI's lines and refuse what
it refuses (the Laplacian, ``--integrity``, an explicit ``--fused_sweep
on``; int8 for the geometry), with its words.

``--solve_ckpt_stride N`` (the scheduler only, ``--no_guess --batch_frames
K``): every N strides the scheduler's whole state is appended to
``<output>.solveckpt`` (``SART_SOLVE_CKPT_FILE`` names another file;
``resilience/podckpt.py``); ``--resume`` restores the newest checkpoint
whose lane count is K and that the output file's rows cover, and goes on
mid-frame instead of re-solving every frame in flight from its guess.

A grid of ranks (``--multihost``, launched by ``torchrun``, or ``python
-m torch.distributed.run --nproc_per_node N -m sartsolver_tpu_torch.cli
--multihost ...``): ``--pixel_shards`` and ``--voxel_shards`` shape it, else
the JAX CLI's choice (voxel-major where the fused sweep runs the per-rank
block, the reference's row blocks otherwise); ``--voxel_shards`` alone means
voxel-major for int8. The process group comes from the launcher's
environment, over NCCL where every rank of a host has a card of its own and
gloo otherwise (the CPU, ranks sharing a card); the ``solver:`` line names
the mesh, its layout and the backend. Each rank reads its own block of the
RTM (in turns, rank by rank, unless ``--parallel_read``), only rank 0
prints to stdout and writes files, a failing frame aborts the run (no
FAILED rows: a rank that skipped a frame alone would leave its peers in a
collective), OOM halving is off, ``--no_guess --batch_frames K`` runs the
classic grouped loop, and a stop signal is agreed at a group boundary by
every rank. ``--resume`` reads the file on rank 0, whose view every rank
takes (``parallel/multihost.py:broadcast_resume_state``; a failed read
exits 1 on every rank). ``--sparse_rtm``, ``--lowrank_rtm``, ``--geometry``,
``--os_subsets > 1``, ``--solve_ckpt_stride``, ``--integrity``,
``--debug_nans`` and int8 on a pixel-sharded grid are refused there (exit
1); a grid larger or smaller than the world exits 1, and so does a world
above 1 without ``--multihost``. A failed start of the process group is
retried (fault site ``multihost.init``); when the retries run out, exit 3.

A pod (docs/RESILIENCE.md §11 of the JAX package): the ranks of a grid,
or N one-process workers over the same frames (``SART_POD_PROCESS=k/N``,
``SART_POD_BARRIER_DIR`` a fresh directory each incarnation shares, and
one ``SART_SOLVE_CKPT_FILE`` base, each host's records in
``<base>.h<k>ofN.jsonl``). Every rendezvous — the ingest's turns, the stop
agreement, the scheduler's strides and the end of the run in a file-mode
pod, the resume's pick, the end-of-run telemetry — is bounded by
``SART_POD_BARRIER_TIMEOUT`` seconds (default 300): a peer that died or
wedged ends its survivors' runs with exit 3, "Aborted at a pod barrier:
... missing host(s): h<k>", ``pod_barrier_timeouts_total`` and a crash
bundle naming the host. A pod's ``--resume`` restores the newest
checkpoint serial every host's file holds, the minimum the hosts agree on.

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
``python -m sartsolver_tpu_torch.cli metrics [--check | --diff] FILE...``,
``python -m sartsolver_tpu_torch.cli top [--once] FILE``
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import math
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
               "with FAILED/DIVERGED frames; 3 aborted on an unrecoverable "
               "infrastructure failure after retries (the RTM ingest), a "
               "failed write of the solution file, a watchdog hard abort or "
               "an integrity quarantine; 4 stopped by SIGTERM/SIGINT after "
               "draining the in-flight frame group (resumable with "
               "--resume). Subcommands: `metrics` (run artifacts), `top` "
               "(live view of a run's status snapshot, heartbeat or "
               "Prometheus textfile).",
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
    p.add_argument("--sparse_rtm", default=None, metavar="auto|off|EPS",
                   help="Block-sparse RTM mode: 'auto' builds a lossless "
                        "tile-occupancy index at ingest and keeps only the "
                        "occupied (8 x 128 tile) voxel columns of the matrix "
                        "on the device, so every sweep reads them alone — the "
                        "same solve, bytes and FLOPs scaling with occupancy. "
                        "A numeric EPS in [0, 1) drops tiles whose entries are "
                        "all <= EPS*max|H| (lossy; rho/lambda and the Eq. 6 "
                        "masks come from the thresholded operator). 'auto' "
                        "declines where the sparse sweep cannot engage; an "
                        "explicit EPS fails loudly there. Also via "
                        "SART_SPARSE_RTM.")
    p.add_argument("--lowrank_rtm", default=None, metavar="auto|off|RANK",
                   help="Factored RTM mode: approximate H ~= S + U V^T at "
                        "ingest — a tile-thresholded sparse core S plus a "
                        "rank-RANK randomized-SVD factorization of the "
                        "sub-threshold residual — behind a Frobenius and "
                        "solve-parity quality gate. 'auto' picks the rank "
                        "and declines loudly to dense where none passes; an "
                        "explicit RANK fails loudly there. Also via "
                        "SART_LOWRANK_RTM.")
    p.add_argument("--geometry", default=None, metavar="FILE",
                   help="Matrix-free implicit operator: derive the "
                        "projections H f / H^T w on the fly from the "
                        "versioned geometry record FILE instead of reading "
                        "ray-transfer matrix files — inputs are image files "
                        "only, and device memory holds the ray table instead "
                        "of the RTM. Incompatible with --laplacian_file and "
                        "rtm_dtype=int8.")
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
    p.add_argument("--resume", action="store_true",
                   help="Resume an interrupted run: skip frames already "
                        "present in the output file, warm-start from its "
                        "last solution and append (requires the same inputs "
                        "and flags as the original run).")
    p.add_argument("--use_cpu", action="store_true",
                   help="Perform all calculations on CPUs (fp64 parity profile).")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device of the fp32 profile (default cuda). Without a "
                        "CUDA device the run stops; --device cpu runs the "
                        "same profile on the CPU.")
    p.add_argument("--pixel_shards", type=int, default=None,
                   help="Ranks along the grid's pixel axis (row blocks of the "
                        "RTM; default: auto — every rank, unless the fused "
                        "sweep prefers a voxel-major grid).")
    p.add_argument("--voxel_shards", type=int, default=None,
                   help="Ranks along the grid's voxel axis (column blocks of "
                        "the RTM). Default: auto — every rank on the voxel "
                        "axis where the fused sweep runs the per-rank block; "
                        "--voxel_shards alone means a voxel-major grid for "
                        "int8.")
    p.add_argument("--multihost", action="store_true",
                   help="Multi-process run over torch.distributed, one rank a "
                        "process, launched by torchrun (python -m "
                        "torch.distributed.run --nproc_per_node N ...): each "
                        "rank reads and holds only its block of the RTM, rank 0 "
                        "prints the frame lines and writes the output. NCCL "
                        "where every rank of a host has a card of its own, gloo "
                        "on the CPU and where ranks share a card.")
    p.add_argument("--parallel_read", action="store_true",
                   help="All ranks read their RTM blocks at once (multi-process "
                        "runs read rank by rank by default, matching the "
                        "reference's HDD-friendly round robin).")
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
    p.add_argument("--integrity", action="store_true",
                   help="End-to-end numerical-integrity layer (also "
                        "SART_INTEGRITY=1): per-iteration ABFT checksums "
                        "(sum(Hf)=rho.f on the fused sweep's output, "
                        "sum(H^T w)=lambda.w on the two-matmul sweep), RTM "
                        "chunks read twice and digested with a re-read on "
                        "mismatch, post-upload rho/lambda verification, and "
                        "a resident re-audit every SART_INTEGRITY_REAUDIT "
                        "frames. A detected frame is re-solved once, then "
                        "FAILED; SART_SDC_ABORT_THRESHOLD terminal frames "
                        "(or a resident mismatch) quarantine the run with "
                        "exit 3. Off, the run is what it is without it.")
    p.add_argument("--fail_fast", action="store_true",
                   help="Disable per-frame failure isolation: the first "
                        "frame whose ingest or solve fails aborts the "
                        "run (the reference's behavior) instead of "
                        "being recorded as a FAILED status row (-3) "
                        "while the run continues.")
    p.add_argument("--solve_ckpt_stride", type=int, default=0, metavar="N",
                   help="In-solve checkpointing (continuous-batching path "
                        "only): every N scheduler strides, append a "
                        "CRC-checksummed snapshot of the full lane state — "
                        "iterates, momentum carries, divergence-ladder "
                        "level, iteration counters, reorder buffer — to "
                        "<output>.solveckpt (SART_SOLVE_CKPT_FILE "
                        "overrides). --resume then restores the run "
                        "mid-frame at the newest consistent checkpoint "
                        "instead of re-running the initial guess and every "
                        "prior sweep. 0 (default) disables: the run is "
                        "byte-identical to one without the layer.")
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


def _operator_solver(solver_cls, operator, opts, device, debug_nans):
    """The solver of the factored or the matrix-free operator; a refusal of
    the solver core (a ValueError) is an input error, as the JAX CLI's."""
    from sartsolver_tpu_torch.config import SartInputError

    try:
        return solver_cls(operator=operator, opts=opts, device=device,
                          debug_nans=debug_nans)
    except SartInputError:
        raise
    except ValueError as err:
        raise SartInputError(str(err)) from None


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
    if args.solve_ckpt_stride < 0:
        fail(f"Argument solve_ckpt_stride must be >= 0, "
             f"{args.solve_ckpt_stride} given.")
    if args.solve_ckpt_stride and args.multihost:
        fail("Argument solve_ckpt_stride snapshots the continuous-batching "
             "scheduler's lane state; it needs --batch_frames > 1 without "
             "--no_continuous_batching (multihost runs use the classic "
             "grouped loop and cannot checkpoint mid-frame).")
    if args.pixel_shards is not None and args.pixel_shards < 1:
        fail(f"Argument pixel_shards must be >= 1, {args.pixel_shards} given.")
    if args.voxel_shards is not None and args.voxel_shards < 1:
        fail(f"Argument voxel_shards must be >= 1, {args.voxel_shards} given.")
    if args.solve_ckpt_stride and (args.batch_frames <= 1
                                   or args.no_continuous_batching):
        fail("Argument solve_ckpt_stride snapshots the continuous-batching "
             "scheduler's lane state; it needs --batch_frames > 1 without "
             "--no_continuous_batching.")
    if args.sparse_rtm is None:
        # flag > SART_SPARSE_RTM > off (the schedule_stride pattern)
        args.sparse_rtm = os.environ.get("SART_SPARSE_RTM", "off")
    if args.sparse_rtm not in ("auto", "off"):
        try:
            eps = float(args.sparse_rtm)
            ok = 0.0 <= eps < 1.0 and math.isfinite(eps)
        except ValueError:
            ok = False
        if not ok:
            fail("Argument sparse_rtm must be 'auto', 'off' or a relative "
                 f"threshold in [0, 1), {args.sparse_rtm!r} given.")
        if args.use_cpu:
            fail("Argument sparse_rtm needs the fp32 device profile; an "
                 "explicit threshold cannot be combined with --use_cpu "
                 "(use 'auto', which declines there).")
    if args.sparse_rtm != "off" and args.fused_sweep in ("on", "interpret"):
        fail("Argument sparse_rtm engages the block-sparse panel sweep; "
             f"--fused_sweep {args.fused_sweep} cannot be honored there — "
             "use auto or off.")
    if args.lowrank_rtm is None:
        # flag > SART_LOWRANK_RTM > off (the sparse_rtm pattern)
        args.lowrank_rtm = os.environ.get("SART_LOWRANK_RTM", "off")
    if args.lowrank_rtm not in ("auto", "off"):
        try:
            ok = int(args.lowrank_rtm) >= 1
        except ValueError:
            ok = False
        if not ok:
            fail("Argument lowrank_rtm must be 'auto', 'off' or a "
                 f"positive integer factorization rank, "
                 f"{args.lowrank_rtm!r} given.")
        if args.use_cpu:
            fail("Argument lowrank_rtm needs the fp32 device profile; an "
                 "explicit rank cannot be combined with --use_cpu "
                 "(use 'auto', which declines there).")
    if args.lowrank_rtm != "off":
        if args.fused_sweep in ("on", "interpret"):
            fail("Argument lowrank_rtm runs the factored (S + U V^T) "
                 f"sweep; --fused_sweep {args.fused_sweep} cannot be "
                 "honored there — use auto or off.")
        if args.geometry:
            fail("Argument lowrank_rtm factorizes a stored matrix; "
                 "--geometry has none to factorize.")
        if args.sparse_rtm not in ("auto", "off"):
            fail("Arguments lowrank_rtm and an explicit sparse_rtm "
                 "threshold both claim the stored matrix; the factored "
                 "core already thresholds it — drop one.")
    if args.max_cached_frames <= 0:
        fail("Argument max_cached_frames must be positive.")
    if args.max_cached_solutions <= 0:
        fail("Argument max_cached_solutions must be positive.")
    if args.geometry:
        # the geometry record replaces the RTM files: one image file is a
        # complete input set
        if len(args.input_files) < 1:
            fail("At least one image input file is required with "
                 "--geometry, 0 given.")
        if args.multihost:
            fail("Argument geometry is single-process: the implicit "
                 "operator's rays are staged whole per host; drop "
                 "--multihost or materialize the matrix.")
        if args.laplacian_file:
            fail("Argument geometry cannot be combined with "
                 "--laplacian_file: beta_laplace smoothing needs the "
                 "materialized operator.")
    elif len(args.input_files) < 2:
        fail("At least two input file, one with RTM and one with image, are "
             f"required, {len(args.input_files)} given.")


class _NullWriter:
    """The solution writer of a grid's other ranks: it takes every row and
    writes none (the primary rank writes the file)."""

    def add(self, *args, **kwargs) -> None:
        pass

    def __enter__(self) -> "_NullWriter":
        return self

    def __exit__(self, *exc) -> None:
        pass


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



@dataclasses.dataclass
class SolveInputs:
    """What the pre-flight gate learned of the input files
    (:func:`index_inputs`)."""

    geometry_record: Optional[object]
    rtm_name: str
    sorted_matrix_files: dict
    sorted_image_files: dict
    camera_names: List[str]
    npixel: int
    nvoxel: int
    rtm_frame_masks: dict


def index_inputs(args, geometry_record=None) -> SolveInputs:
    """The pre-flight validation gate (main.cpp:30-59) over
    ``args.input_files``: the files sorted and checked against each other,
    the problem's size and the RTM frame masks. ``geometry_record`` (a
    validated record) replaces the matrix files with the matrix-free
    operator, as ``--geometry`` does. Shared by the CLI's run and the serving
    engine's resident session, so the two cannot drift."""
    from sartsolver_tpu_torch.config import SartInputError
    from sartsolver_tpu_torch.io import hdf5files as hf

    # ---- pre-flight validation gate (main.cpp:30-59) -----------------
    if geometry_record is None and args.geometry:
        from sartsolver_tpu_torch.operators.geometry import load_geometry

        geometry_record = load_geometry(args.geometry)
    matrix_files, image_files = hf.categorize_input_files(args.input_files)
    rtm_name = args.raytransfer_name
    if geometry_record is not None:
        # matrix-free: image files only, their cameras the record's
        if matrix_files:
            raise SartInputError(
                "--geometry replaces the ray-transfer matrix files; "
                f"drop {', '.join(matrix_files)} from the inputs "
                "(image files only).")
        hf.check_group_attribute_consistency(image_files, "image", ["wavelength"])
        sorted_image_files = hf.sort_image_files(image_files)
        camera_names = list(sorted_image_files)
        cams = set(geometry_record.camera_names)
        if cams != set(camera_names):
            raise SartInputError(
                "Geometry/image mismatch: geometry cameras "
                f"{sorted(cams)} vs image files {camera_names}.")
        sorted_matrix_files = {}
        npixel, nvoxel = geometry_record.npixel, geometry_record.nvoxel
        rtm_frame_masks = geometry_record.frame_masks()
    else:
        hf.check_group_attribute_consistency(matrix_files, f"rtm/{rtm_name}",
                                             ["wavelength"])
        hf.check_group_attribute_consistency(matrix_files, "rtm/voxel_map",
                                             ["nx", "ny", "nz"])
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
    return SolveInputs(geometry_record, rtm_name, sorted_matrix_files,
                       sorted_image_files, camera_names, npixel, nvoxel,
                       rtm_frame_masks)


@dataclasses.dataclass
class SolveSetup:
    """The solver a run or a resident session solves with
    (:func:`build_solver`)."""

    opts: object
    storage: str
    sdc_policy: Optional[object]
    ranks: object
    solver: object
    grid: object
    tile_occupancy: Optional[object]


def build_solver(args, inputs: SolveInputs, device, *, telem=None,
                 on_event=None, summary=None) -> SolveSetup:
    """The solver options from the flags, the grid of ranks (the process
    group's under ``--multihost``, else one), the Laplacian, the operator's ingest onto ``device`` and the
    solver over it, with the voxel grid the output carries; prints the
    provenance lines. ``telem`` takes the run's provenance (None: a build
    outside a run); ``on_event`` and ``summary`` are the integrity layer's
    event sink and run summary. Shared by the CLI's run and the serving
    engine's resident session: both build the same solver, plan and
    reduction order from the same flags, which keeps a served request's
    output byte-identical to the CLI's over the same frames."""
    from sartsolver_tpu_torch.config import SartInputError, SolverOptions
    from sartsolver_tpu_torch.io.laplacian_io import read_laplacian
    from sartsolver_tpu_torch.io.voxelgrid import make_voxel_grid
    from sartsolver_tpu_torch.models.sart import (
        INT8_MAX_CONTRACTION, resolve_fused, torch_dtype,
    )
    from sartsolver_tpu_torch.obs import trace as obs_trace
    from sartsolver_tpu_torch.ops.laplacian import make_laplacian
    from sartsolver_tpu_torch.parallel.mesh import choose_mesh_shape, make_grid
    from sartsolver_tpu_torch.parallel.multihost import (
        lowrank_operator_or_decline, read_and_quantize_rtm, read_and_shard_rtm,
        sparse_tile_stats_or_decline,
    )
    from sartsolver_tpu_torch.parallel.sharded import (
        DistributedSARTSolver, grid_refusal, os_padded_rows,
    )
    from sartsolver_tpu_torch.resilience import integrity as integ_mod

    geometry_record = inputs.geometry_record
    rtm_name = inputs.rtm_name
    sorted_matrix_files = inputs.sorted_matrix_files
    npixel, nvoxel = inputs.npixel, inputs.nvoxel
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

    # the integrity layer: the flag or SART_INTEGRITY; configure() turns
    # the ingest's double reads on, the in-solve check rides the options
    integrity_on = bool(args.integrity) or integ_mod.env_enabled()
    integ_mod.configure(integrity_on)
    sdc_policy = (integ_mod.SdcEscalation(on_event=on_event, summary=summary)
                  if integrity_on else None)
    common = dict(
        integrity=integrity_on,
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
        sparse_rtm=args.sparse_rtm,
        lowrank_rtm=args.lowrank_rtm,
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
        held_rows = os_padded_rows(npixel, opts.os_subsets)
    except ValueError as err:  # --os_subsets divides no extent the solver pads to
        raise SartInputError(str(err)) from None
    if storage == "int8" and max(npixel, nvoxel) > INT8_MAX_CONTRACTION:
        raise SartInputError(
            f"Argument rtm_dtype='int8': RTM extent {max(npixel, nvoxel)} "
            f"exceeds the int32-accumulation bound {INT8_MAX_CONTRACTION}; "
            "use fp32/bfloat16 storage."
        )
    # the grid of ranks (sartsolver_tpu/cli.py:866-978): the flags', or
    # the auto choice over the world; --voxel_shards alone means a
    # voxel-major grid for int8. One rank is the one-device path.
    world = 1
    if args.multihost:
        import torch.distributed as dist

        world = dist.get_world_size()
    if args.pixel_shards is None and args.voxel_shards is None:
        n_pix, n_vox = choose_mesh_shape(world, npixel, nvoxel, opts, args.batch_frames,
                                         device_type=device.type)
    else:
        n_vox = args.voxel_shards or 1
        if args.pixel_shards is not None:
            n_pix = args.pixel_shards
        elif storage == "int8":
            n_pix = 1
        else:
            n_pix = max(world // n_vox, 1)
    ranks = make_grid(n_pix, n_vox)
    multi = ranks.world > 1
    refusal = grid_refusal(opts, ranks, geometry=bool(args.geometry),
                           debug_nans=args.debug_nans)
    if refusal:
        raise SartInputError(refusal)
    # artifact provenance, the JAX CLI's meta fields; the variant fields
    # also ride every frame record (obs/run.py)
    if telem is None:  # a build outside a run: provenance kept, no sink
        from sartsolver_tpu_torch.obs.run import RunTelemetry

        telem = RunTelemetry()
    telem.set_run_info(
        backend=device.type, mesh=f"{n_pix}x{n_vox}", processes=ranks.world,
        rtm_dtype=str(storage),
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

    # the operator: the factored one, the matrix-free one, or the stored
    # matrix (dense or block-sparse)
    ingest_stats = None
    tile_occ = lowrank_op = None
    if geometry_record is None and opts.lowrank_rank() is not None:
        # the whole matrix read on the host, split and factored behind
        # the quality gate: 'auto' declines loudly to the dense path,
        # an explicit rank exits 1 before anything is staged
        with obs_trace.span("ingest.lowrank_factorize", npixel=npixel, nvoxel=nvoxel):
            lowrank_op = lowrank_operator_or_decline(
                opts, sorted_matrix_files, rtm_name, npixel, nvoxel, laplacian=lap,
                device=device, process_count=ranks.world, n_voxel_shards=ranks.n_vox)
    if geometry_record is not None:
        # no RTM ingest: the operator's device state is the ray table
        from sartsolver_tpu_torch.operators.implicit import ImplicitOperator

        operator = ImplicitOperator(geometry_record)
        with obs_trace.span("ingest.geometry", npixel=npixel, nvoxel=nvoxel):
            solver = _operator_solver(DistributedSARTSolver, operator, opts, device,
                                      args.debug_nans)
        print(f"implicit: ray table resident ({operator.resident_nbytes()} bytes; "
              f"a materialized RTM would stage {npixel * nvoxel * 4})")
    elif lowrank_op is not None:
        with obs_trace.span("ingest.lowrank", npixel=npixel, nvoxel=nvoxel,
                            rank=lowrank_op.rank):
            solver = _operator_solver(DistributedSARTSolver, lowrank_op, opts, device,
                                      args.debug_nans)
        occ = lowrank_op.tile_occupancy()
        print(f"lowrank: factored operator H ~= S + U V^T rank={lowrank_op.rank} "
              f"(core occupancy {occ.occupancy_fraction():.3f}, eps {occ.epsilon:g}, "
              f"digest {occ.digest:#010x}; the residual fill costs "
              f"{lowrank_op.rank}*(npixel+nvoxel) MACs per projection instead of "
              "npixel*nvoxel)")
        lowrank_op = None  # the host's S and factors: the device holds its own
    else:
        # the OS cycle's products upcast int8 codes themselves: int8
        # needs the fused sweep only on the classic sweep
        if storage == "int8" and not fused and opts.os_subsets == 1:
            why = (" (divergence_recovery keeps the logarithmic solver off it)"
                   if opts.divergence_recovery and opts.logarithmic else "")
            raise SartInputError(
                "Argument rtm_dtype='int8' requires the fused sweep, but it "
                f"resolved off{why}. Use --fused_sweep auto/on, float32 or "
                "bfloat16 storage, or the linear solver."
            )
        # the matrix streamed in row chunks into a device buffer of the
        # stored dtype (int8: two passes), with the ordered-subsets
        # padding rows; the ray stats are those of the stored matrix,
        # taken on the device, as the JAX CLI's are. With integrity on,
        # the ingest also sums the stored values for the ray stats'
        # check after the upload
        ingest_stats = integ_mod.IngestStats(npixel, nvoxel) if integrity_on else None
        # the block-sparse index's tile maxima, taken by the ingest where
        # the stored rows lie ('auto' declines here on a flag, with a
        # warning)
        tile_stats = sparse_tile_stats_or_decline(opts, npixel, nvoxel,
                                                  process_count=ranks.world)
        with obs_trace.span("ingest.rtm", npixel=npixel, nvoxel=nvoxel):
            rtm_scale = None
            # on a grid each rank reads its own block, in turns unless
            # --parallel_read
            stripes = dict(grid=ranks, serialize=multi and not args.parallel_read)
            if storage == "int8":
                rtm, rtm_scale = read_and_quantize_rtm(
                    sorted_matrix_files, rtm_name, npixel, nvoxel, device,
                    rows=held_rows, ingest_stats=ingest_stats, tile_stats=tile_stats,
                    **stripes)
            else:
                rtm = read_and_shard_rtm(sorted_matrix_files, rtm_name, npixel, nvoxel,
                                         device, dtype=storage, rows=held_rows,
                                         ingest_stats=ingest_stats,
                                         tile_stats=tile_stats, **stripes)
            try:
                tile_occ = (tile_stats.occupancy(opts.sparse_epsilon())
                            if tile_stats is not None else None)
                # the solver keeps the occupied columns, in place in the
                # ingest's buffer
                solver = DistributedSARTSolver(rtm, lap, opts=opts, device=device,
                                               debug_nans=args.debug_nans,
                                               rtm_scale=rtm_scale, npixel=npixel,
                                               tile_occupancy=tile_occ, grid=ranks,
                                               nvoxel=nvoxel)
            except ValueError as err:  # a non-finite entry, or EPS that cannot engage
                raise SartInputError(str(err)) from None
            del rtm, rtm_scale
    if tile_occ is not None:
        # the index, known at ingest; whether the sweep engaged it is
        # --timing's engaged= line
        print(f"sparse: tile occupancy {tile_occ.occupancy_fraction():.3f} "
              f"(threshold {tile_occ.threshold:g}, eps {tile_occ.epsilon:g}, "
              f"digest {tile_occ.digest:#010x}; engagement in --timing)")
    if ingest_stats is not None:
        if (opts.sparse_epsilon() or 0) > 0 and tile_occ is not None \
                and not tile_occ.mask.all():
            # the threshold zeroed tiles on the device after the ingest
            # summed them: the sums cannot match the device's rho/lambda
            print("Warning: post-upload ray-stats verification skipped: "
                  "sparse_rtm threshold zeroed tiles after the host sums "
                  "were accumulated (stripe digests, in-solve ABFT and the "
                  "resident re-audit still cover the matrix).", file=sys.stderr)
        else:
            # the staging or the layout on the device corrupted the
            # matrix: every solve it would serve is poisoned, quarantine
            issues = solver.verify_ray_stats(ingest_stats)
            if issues:
                sdc_policy.resident_failure(
                    "post-upload ray-stats verification: " + "; ".join(issues))
    telem.set_run_info(operator=solver.operator_kind if solver.operator_kind != "dense"
                       else "tileskip" if tile_occ is not None else "dense")
    if geometry_record is not None:
        from sartsolver_tpu_torch.operators.geometry import GeometryVoxelGrid

        grid = GeometryVoxelGrid(geometry_record)
    else:
        grid = make_voxel_grid(next(iter(sorted_matrix_files.values())),
                               "rtm/voxel_map")
    sparse_on = solver.tile_occupancy is not None
    sweep = ("os-subset" if opts.os_subsets > 1 else "fused" if fused or sparse_on
             else "two-matmul") + ("-sparse" if sparse_on else "")
    if fused and ranks.n_pix > 1:
        sweep = "fused-split"  # split at the pixel axis's all-reduce
    if solver.operator_kind != "dense":
        sweep = solver.operator_kind + ("-os-subset" if opts.os_subsets > 1 else "")
    print(f"solver: mesh={n_pix}x{n_vox} (pixels x voxels, {ranks.layout()}) "
          f"device={device} collectives={ranks.backend or 'none'} "
          f"rtm_dtype={storage} compute={opts.dtype} "
          f"sweep={sweep} rtm=[{npixel}, {nvoxel}]"
          + (f" os_subsets={opts.os_subsets}" if opts.os_subsets > 1 else "")
          + (f" sparse_rtm={opts.sparse_rtm} voxels_held="
             f"{solver.problem.rtm.shape[1]}" if sparse_on else "")
          + f" processes={ranks.world}")
    return SolveSetup(opts, storage, sdc_policy, ranks, solver, grid, tile_occ)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "lint":
        # static analysis: the AST lint, the launch audit of the hot entry
        # points and the crash-point model checker; dispatched before the
        # solver parser, which would read "lint" as an input file
        from sartsolver_tpu_torch.analysis.cli import lint_main

        return lint_main(argv[1:])
    if argv and argv[0] == "metrics":
        # artifact tooling: validate, summarize and diff --metrics_out
        # artifacts; dispatched before the solver parser, which would read
        # "metrics" as an input file
        from sartsolver_tpu_torch.obs.cli import metrics_main

        return metrics_main(argv[1:])
    if argv and argv[0] == "top":
        # the live view of a run, from the files it publishes
        from sartsolver_tpu_torch.obs.cli import top_main

        return top_main(argv[1:])
    if argv and argv[0] == "serve":
        # the resident serving engine: the session held on the device,
        # requests from an ingest dir or a local socket, a crash-recoverable
        # request journal; dispatched before the solver parser
        from sartsolver_tpu_torch.engine.cli import serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "submit":
        # the serving engine's client
        from sartsolver_tpu_torch.engine.cli import submit_main

        return submit_main(argv[1:])
    if argv and argv[0] == "fleet":
        # the fleet controller: M supervised serve workers, the
        # tenant-affinity routing table, journal-backed failover
        from sartsolver_tpu_torch.engine.cli import fleet_cli_main

        return fleet_cli_main(argv[1:])
    if argv and argv[0] == "chaos":
        # the chaos campaign harness: seeded fault schedules and SIGKILLs
        # against a real supervised serve, judged on the exactly-once,
        # byte-identity, restart-budget and state-continuity invariants
        from sartsolver_tpu_torch.resilience.chaos import chaos_main

        return chaos_main(argv[1:])
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as err:
        # argparse exits 2 on a malformed flag; the reference's contract is 1
        raise SystemExit(1 if err.code else 0) from None
    _validate(args)

    # per-run scope of the once-per-run non-finite-pixel warning: repeated
    # runs in one interpreter each warn
    from sartsolver_tpu_torch.models.sart import reset_nonfinite_warning

    reset_nonfinite_warning()

    from sartsolver_tpu_torch.obs.run import RunTelemetry
    from sartsolver_tpu_torch.resilience.failures import RunSummary

    # a fresh per-run metrics registry (--timing's PhaseTimer is a view
    # over it) and the sinks --metrics_out, SART_METRICS_PROM and
    # SART_TRACE_EVENTS ask for; with none, nothing more is written or
    # printed
    telem = RunTelemetry.from_cli(args.metrics_out)
    summary = RunSummary()
    rank = {"primary": True, "owns_group": False}
    try:
        with contextlib.ExitStack() as quiet:
            return _run(args, telem, summary, rank, quiet)
    finally:
        # an error exit's artifact, marked partial: a no-op after the
        # completed run's finalize, or with no sink (a grid's other ranks
        # write none: the sinks are the primary's paths)
        if rank["primary"]:
            telem.finalize_local(summary)
        if rank["owns_group"]:  # the group this run started, not a caller's
            from sartsolver_tpu_torch.parallel import comm

            comm.shutdown()


def _run(args, telem, summary, rank, quiet) -> int:
    """The solve of :func:`main` after its flags are validated: per-frame
    and per-event accounting goes to ``telem`` (``obs/run.py``) and
    ``summary`` (``resilience/failures.py``). ``rank["primary"]`` is set
    False on a grid's other ranks, whose standard output goes into
    ``quiet`` (an exit stack closed when the run ends)."""
    import torch

    from sartsolver_tpu_torch.config import DIVERGED, SartInputError, parse_time_intervals
    from sartsolver_tpu_torch.device import resolve_device
    from sartsolver_tpu_torch.io.image import CompositeImage
    from sartsolver_tpu_torch.io.solution import SolutionWriter
    from sartsolver_tpu_torch.models.sart import FUSED_ENGAGEMENT
    from sartsolver_tpu_torch.obs import metrics as obs_metrics
    from sartsolver_tpu_torch.obs import trace as obs_trace
    from sartsolver_tpu_torch.parallel import multihost as mh
    from sartsolver_tpu_torch.io.solution import read_resume_state
    from sartsolver_tpu_torch.obs import flight as obs_flight
    from sartsolver_tpu_torch.resilience import integrity as integ_mod
    from sartsolver_tpu_torch.resilience import shutdown, watchdog
    from sartsolver_tpu_torch.resilience.degrade import GroupSizeLadder, dispatch_guarded
    from sartsolver_tpu_torch.resilience.failures import (
        EXIT_INFRASTRUCTURE, EXIT_INTERRUPTED, FRAME_FAILED, RECOVERABLE_FRAME_ERRORS,
        SDC_DETECTED, FrameFailure, IntegrityError, OutputWriteError,
        PersistentCorruptionError, WatchdogTimeout, failed_row,
    )
    from sartsolver_tpu_torch.resilience.retry import RetriesExhausted, reset_retry_stats
    from sartsolver_tpu_torch.resilience import podckpt
    from sartsolver_tpu_torch.sched import ContinuousBatcher
    from sartsolver_tpu_torch.sched.scheduler import sched_held_ftimes
    from sartsolver_tpu_torch.utils.asyncwriter import AsyncSolutionWriter, DeferredWriteError
    from sartsolver_tpu_torch.utils.prefetch import FramePrefetcher
    from sartsolver_tpu_torch.utils.timing import PhaseTimer

    # per-run accounting: the retry counters feed this run's summary and
    # artifact, not a process-lifetime total
    reset_retry_stats()
    # the hand kernels' launch counters at the start: the run's artifact
    # counts its own launches in kernel_launches_total{kernel,plan}
    launches0 = obs_metrics.kernel_launches()
    timer = PhaseTimer(registry=telem.registry)
    t_phase = _time.perf_counter()
    try:
        device = resolve_device("cpu" if args.use_cpu else args.device)
    except RuntimeError as err:
        print(err, file=sys.stderr)
        return 1
    # a run over a grid of ranks: the process group first, from the
    # launcher's environment; only rank 0 prints to stdout and writes files
    launched = int(os.environ.get("WORLD_SIZE", "1"))
    if args.multihost:
        import torch.distributed as dist

        rank["owns_group"] = not dist.is_initialized()
        try:
            mh.initialize(device.type)
        except SartInputError as err:
            print(err, file=sys.stderr)
            return 1
        except RetriesExhausted as err:
            # the rendezvous never came up within the retry budget: the
            # infrastructure's, not the flags' (a scheduler requeues it)
            print(f"Unrecoverable after retries: {err}", file=sys.stderr)
            return EXIT_INFRASTRUCTURE

        if not mh.is_primary():
            rank["primary"] = False
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
    elif launched > 1:
        print(f"WORLD_SIZE={launched}: a run launched over {launched} ranks needs "
              "--multihost (each rank would otherwise solve the whole problem "
              "alone and write the same file).", file=sys.stderr)
        return 1
    primary = rank["primary"]
    # the pod's identity (k/n) for the modules that read the environment
    # (the heartbeat's and the crash bundle's host, the site@i fault
    # qualifier) and this host's liveness beacon for its peers' barriers;
    # both no-ops on a lone process
    mh.export_pod_identity()
    mh.install_pod_liveness()
    # a pod whose hosts meet over a shared directory (the fake pod, or a
    # grid given one): its resume, strides and end are rendezvous too
    file_pod = bool(os.environ.get("SART_POD_BARRIER_DIR")) and mh.pod_identity()[1] > 1

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

    def note_event(message: str) -> None:
        """An availability event (an OOM halving, the scheduler's
        hand-back, a watchdog fire, a quarantine): stderr, the end-of-run
        summary, the telemetry and the flight ring."""
        print(message, file=sys.stderr)
        summary.record_event(message)
        telem.record_event(message)
        obs_flight.record_event("event", message)

    # the graceful stop (SIGTERM/SIGINT: drain, flush, exit 4), installed
    # before the ingest so a stop during it is remembered; the flight ring
    # on the beacon stream, SIGUSR1's status snapshot and the crash bundle
    # of every abnormal exit (the watchdog's os._exit through its hook); the
    # hang watchdog over the whole run (SART_WATCHDOG_TIMEOUT)
    shutdown.install()
    obs_flight.install()
    bundle_path = obs_flight.default_bundle_path(args.output_file)
    prev_usr1 = obs_flight.install_status_handler(
        obs_flight.default_status_path(args.output_file))
    abort = {"reason": None}
    watchdog.set_crash_hook(
        lambda reason: obs_flight.write_crash_bundle(bundle_path, reason, summary))
    wd = watchdog.Watchdog.from_env(on_event=note_event)
    if wd is not None:
        wd.start()
    stop_state = {"interrupted": False}

    def stop_now() -> bool:
        """The group-boundary stop poll: a flag the signal handler set; on a
        grid or a fake pod (``SART_POD_PROCESS=k/n``), agreed by every host
        at the same boundary: a worker that drained alone would leave its
        peers at a barrier, and a graceful stop must never look like a dead
        peer."""
        if mh.pod_identity()[1] > 1:
            return mh.agree_stop(shutdown.stop_requested())
        return shutdown.stop_requested()

    try:
        time_intervals = parse_time_intervals(args.time_range)

        inputs = index_inputs(args)
        camera_names = inputs.camera_names
        npixel, nvoxel = inputs.npixel, inputs.nvoxel
        # a resume is checked from the file's metadata before the ingest; on
        # a grid only rank 0 reads the file (it may lie where only rank 0
        # sees it) and every rank takes its view, a failed read first, so
        # every rank skips the same frames or exits 1 together
        resume_state = None
        if args.resume:
            resume_error = None
            if not args.multihost or mh.is_primary():
                try:
                    resume_state = read_resume_state(args.output_file, camera_names, nvoxel)
                except (SartInputError, OSError, KeyError) as err:
                    if not args.multihost:
                        raise
                    resume_error = str(err) or type(err).__name__
            if args.multihost:
                with obs_trace.span("resume.broadcast"):
                    resume_state = mh.broadcast_resume_state(resume_state, nvoxel,
                                                             error=resume_error)
            if file_pod:
                # a file-mode pod resumes from the rows every host's file
                # holds: hosts whose writers flushed different tails would
                # skip different frames, and their strides and stop polls
                # would no longer meet. The rows past that prefix are
                # solved again (the same bytes) and rewritten.
                held = 0 if resume_state is None else len(resume_state.times)
                rows = min((0 if r is None else int(r)
                            for r in mh.pod_barrier("resume_rows", payload=held)), default=0)
                if rows < held:
                    resume_state = read_resume_state(args.output_file, camera_names, nvoxel,
                                                     rows=rows)
        mark("validate + index inputs")

        setup = build_solver(args, inputs, device, telem=telem,
                             on_event=note_event, summary=summary)
        opts, solver, grid = setup.opts, setup.solver, setup.grid
        sdc_policy = setup.sdc_policy
        ranks = setup.ranks
        multi = ranks.world > 1
        composite_image = CompositeImage(
            inputs.sorted_image_files, inputs.rtm_frame_masks, time_intervals, npixel,
            max_cache_size=args.max_cached_frames,
        )
        mark("ingest RTM + upload")

        # per-frame failure isolation: a frame whose read fails past its
        # retries arrives as a FrameFailure item, and a group whose staging
        # or dispatch fails with a recoverable error is caught in the loops;
        # either way its frames are FAILED rows and the run goes on
        # a grid fails fast: a rank that skipped a frame alone would leave its
        # peers in a collective (the JAX CLI's multihost rule)
        isolate = not (args.fail_fast or multi)
        writer_queue = max(1, int(os.environ.get("SART_WRITER_QUEUE", "16")))
        diverged_times = []
        written_times = (resume_state.times if resume_state is not None
                         else np.empty(0))

        def already_written(t: float) -> bool:
            return bool(np.any(np.abs(written_times - t) <= 1e-12))

        # the resident re-audit, every SART_INTEGRITY_REAUDIT frames
        reaudit_every = int(os.environ.get("SART_INTEGRITY_REAUDIT", "64"))
        audit_state = {"since": 0}

        def integ_tick(n_frames: int) -> None:
            if sdc_policy is None or reaudit_every <= 0:
                return
            audit_state["since"] += n_frames
            if audit_state["since"] < reaudit_every:
                return
            audit_state["since"] = 0
            issues = solver.reaudit_ray_stats()
            if issues:
                sdc_policy.resident_failure("resident re-audit: " + "; ".join(issues))

        def sdc_guarded(solve_fn, restore=None):
            """Re-solve a group once whose statuses carry SDC_DETECTED, by
            the same kernel and plan (``restore`` resets a warm carry the
            first attempt moved on); frames still SDC are written FAILED.
            The statuses are read right after each dispatch anyway."""
            if sdc_policy is None:
                return solve_fn

            def guarded(stack):
                result = solve_fn(stack)
                sdc = np.asarray(result.status) == SDC_DETECTED
                if sdc.any():
                    sdc_policy.detected(int(sdc.sum()))
                    sdc_policy.note_recompute(int(sdc.sum()))
                    if restore is not None:
                        restore()
                    result = solve_fn(stack)
                    repeat = np.asarray(result.status) == SDC_DETECTED
                    if repeat.any():
                        sdc_policy.detected(int(repeat.sum()))
                return result

            return guarded

        # ---- frame loops (main.cpp:131-140) ------------------------------
        profile = (_FrameLoopProfile(args.profile_dir, device) if args.profile_dir
                   else None)
        step = profile.step if profile is not None else (lambda: None)

        # the writer thread holds at most SART_WRITER_QUEUE rows (or their
        # device fetches); 1 runs the loop in lockstep with the writer. One
        # stream of (frame, time, camera times) items, shared by the loops.
        # a grid's ranks measure their own rows where each holds some
        # (sartsolver_tpu/cli.py:1030); the frames arrive whole on every rank
        stage_kw, local_rows = {}, (lambda stack: stack)
        if multi and mh.all_processes_local_capable(ranks, npixel):
            off, cnt = mh.process_pixel_range(ranks, npixel)
            stage_kw = {"local": True}

            def local_rows(stack):
                return stack[:, off:off + cnt]

        def solve_batch(stack):
            return solver.solve_batch(local_rows(stack), **stage_kw)

        # only the primary rank writes the file
        with solver, (AsyncSolutionWriter(
                SolutionWriter(args.output_file, camera_names, nvoxel,
                               max_cache_size=args.max_cached_solutions,
                               resume=resume_state if resume_state is not None else False),
                max_pending=writer_queue) if primary else _NullWriter()) as writer, \
                FramePrefetcher(composite_image, isolate_failures=isolate) as prefetched, \
                profile if profile is not None else contextlib.nullcontext():
            # a resumed run skips the frames the file holds (FAILED rows too)
            frames = (prefetched if resume_state is None else
                      (item for item in prefetched if not already_written(item[1])))

            def write(solution, status, ftime, cam_times, iterations, convergence,
                      ms, group):
                """One row: the file (``solution`` an array or a device
                fetch the writer thread resolves), the run summary and the
                telemetry."""
                writer.add(solution, status, ftime, cam_times, iterations=iterations)
                summary.record_status(status, ftime)
                if status == DIVERGED:
                    diverged_times.append(ftime)
                telem.record_frame(ftime, status, iterations, convergence, ms, group)
                watchdog.beacon(watchdog.PHASE_FRAME_DONE)

            def record_failed(ftime, cam_times, err):
                """A FAILED row (-3, zeros, -1 iterations) for a frame that
                produced nothing; the telemetry keys its counter by the
                error's class."""
                writer.add(failed_row(nvoxel), FRAME_FAILED, ftime, cam_times,
                           iterations=-1)
                summary.record_status(FRAME_FAILED, ftime)
                telem.record_frame(ftime, FRAME_FAILED, -1, None, None, "failed",
                                   error=type(err).__name__)
                watchdog.beacon(watchdog.PHASE_FRAME_DONE)
                print(f"Frame at t={ftime}: FAILED ({type(err).__name__}: {err})",
                      file=sys.stderr)

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

                A FrameFailure item dispatches what is pending, then writes
                its FAILED row; a dispatch that fails with a recoverable
                error (a hang the watchdog interrupted included) writes its
                group's frames as FAILED rows (the warm carry is left as it
                was: the next group starts from the last good frame).
                Without isolation that error raises. A frame still
                SDC_DETECTED after ``solve_group``'s recompute
                (``sdc_guarded``) is a FAILED row too. A stop request is
                honored where no frame is pending: nothing new is
                dispatched, and the run exits 4.

                A group's time per frame runs from the end of the previous
                group (reading and writing frames included), as the
                scheduler's runs from its previous retirement. At K = 1 (the
                serial loop) the telemetry names each frame's group
                ``frame`` and its --timing row ``solve frame``, as the JAX
                CLI's serial loop does."""
                label = "batch" if batch else "chain"
                group_label = label if K > 1 else "frame"
                timer_row = f"solve {label} (pipelined wall)" if K > 1 else "solve frame"
                # the halving is a per-rank decision: off on a grid, where an
                # OOM aborts the run as any other device error
                ladder = (GroupSizeLadder(K, on_event=note_event) if batch and not multi
                          else None)
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
                        try:
                            result, _ = dispatch_guarded(lambda: solve_group(stack),
                                                         ladder=ladder)
                        except RECOVERABLE_FRAME_ERRORS as err:
                            if not isolate:
                                raise
                            for _, ftime, cam_times in group:
                                record_failed(ftime, cam_times, err)
                            del pending[:len(group)]
                            t_last = _time.perf_counter()
                            continue
                        if result is None:  # OOM: the same frames, halved
                            size = ladder.size
                            continue
                        statuses, iterations = result.status, result.iterations
                        now = _time.perf_counter()
                        # inside the frame-loop phase: a detail row, kept
                        # out of the total
                        timer.add(timer_row, now - t_last, detail=True)
                        per_frame_ms = (now - t_last) * 1e3 / len(group)
                        t_last = now
                        for b, (_, ftime, cam_times) in enumerate(group):
                            if sdc_policy is not None and int(statuses[b]) == SDC_DETECTED:
                                # the recompute reproduced the trip: a FAILED
                                # row (the policy may quarantine the run)
                                sdc_policy.record_terminal(ftime)
                                record_failed(ftime, cam_times, IntegrityError(
                                    integ_mod.SDC_REPRODUCED))
                                continue
                            # the rows come off the device on the writer's
                            # thread, in one copy for the group
                            write(lambda b=b, result=result: result.fetch_solutions()[b],
                                  int(statuses[b]), ftime, cam_times,
                                  int(iterations[b]), float(result.convergence[b]),
                                  per_frame_ms, group_label)
                            print(f"Processed in: {per_frame_ms} ms (average over "
                                  f"{label} of {len(group)}; {int(iterations[b])} "
                                  "iterations)")
                        del pending[:len(group)]
                        integ_tick(len(group))

                for item in items:
                    if not pending and stop_now():
                        stop_state["interrupted"] = True
                        break
                    if isinstance(item, FrameFailure):
                        # rows stay in frame order: what is pending first
                        flush(final=True)
                        record_failed(item.time, item.camera_times, item.error)
                        continue
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
                    write(fetcher, status, ftime, cam_times, iterations, convergence,
                          per_frame_ms, "sched")
                    integ_tick(1)
                    timer.add("solve sched (pipelined wall)", per_frame_ms / 1e3,
                              detail=True)
                    print(f"Processed in: {per_frame_ms} ms (continuous batch of {K} "
                          f"lanes; {iterations} iterations)")

                # in-solve checkpoints, one file a pod host
                # (resilience/podckpt.py), and a file-mode pod's rendezvous
                # at every stride: the fake pod's lockstep, and where its
                # survivors see a dead peer
                pod_idx, pod_count = mh.pod_identity()
                markers = bool(os.environ.get("SART_TEST_POD_MARKERS"))
                # the drills' hold: at this stride serial the host stops after
                # its marker, short of the barrier, until the drill's kill
                # lands (a minute at most), so its peers meet that barrier
                # without it whatever the machine's load
                hold = int(os.environ.get("SART_TEST_POD_HOLD") or 0)
                ckpt_base = (os.environ.get("SART_SOLVE_CKPT_FILE")
                             or f"{args.output_file}.solveckpt")
                store = restore = restore_serial = stride_barrier = None
                if args.solve_ckpt_stride:
                    store = podckpt.SolveCheckpointStore(ckpt_base, pod_idx, pod_count)
                if file_pod:
                    def stride_barrier(serial: int) -> None:
                        if markers:  # the drills' kill window: mid-stride
                            sys.stderr.write(f"SART_POD_POINT stride serial={serial}\n")
                            sys.stderr.flush()
                            if serial == hold:
                                _time.sleep(60)
                        mh.pod_barrier(f"stride.{serial}")

                # on --resume the newest record valid on every host of the
                # pod, whose lane count is K and whose emitted rows the file
                # holds (the killed run's writer may not have flushed the
                # snapshot's rows: fall back a stride); none usable is the
                # plain resume
                W = 0 if resume_state is None else len(resume_state.times)
                if args.resume and store is not None:
                    newest = podckpt.newest_consistent_serial(ckpt_base, pod_count)
                    for serial in reversed(store.serials()):
                        if newest is None or serial > newest:
                            continue
                        snap = store.load(serial)
                        if (snap is None or int(snap.get("lanes", -1)) != K
                                or int(snap["next_emit"]) > W):
                            continue
                        restore, restore_serial = snap, serial
                        break
                    if file_pod:
                        # the pod agrees on the pick, not only on the files: a
                        # host whose writer lost its unflushed tail picks an
                        # older serial, and different picks would put every
                        # later stride barrier out of step. The minimum holds
                        # on every host (next_emit grows with the serial); a
                        # host with none (-1) takes the pod to the plain resume
                        picks = mh.pod_barrier(
                            "resume_pick",
                            payload=-1 if restore_serial is None else int(restore_serial))
                        agreed = min((-1 if row is None else int(row) for row in picks),
                                     default=-1)
                        if agreed < 0:
                            restore = restore_serial = None
                        elif agreed != restore_serial:
                            restore = store.load(agreed)
                            restore_serial = None if restore is None else agreed
                    if restore is not None:
                        if restore["solver"].get("sig") != solver._sched_ckpt_sig():
                            raise SartInputError(
                                f"Solve checkpoint serial {restore_serial} in {store.path} "
                                "does not match this solver configuration (checkpoint "
                                f"{restore['solver'].get('sig')!r}, solver "
                                f"{solver._sched_ckpt_sig()!r}); resume with the flags "
                                "of the run that wrote it.")
                        telem.registry.counter("solve_ckpt_resumed_total").inc()
                        note_event(f"resumed from solve checkpoint serial {restore_serial} "
                                   f"({W} row(s) already written)")
                        if markers:
                            sys.stderr.write(f"SART_POD_POINT resume serial={restore_serial}\n")
                            sys.stderr.flush()
                batcher = ContinuousBatcher(solver, lanes=K, on_result=on_result,
                                            on_failed=record_failed, isolate=isolate,
                                            on_event=note_event, on_stride=step,
                                            stop_check=stop_now,
                                            integrity_policy=sdc_policy,
                                            ckpt_stride=args.solve_ckpt_stride or None,
                                            ckpt_sink=None if store is None else store.save,
                                            stride_barrier=stride_barrier,
                                            restore=restore,
                                            restore_emitted=W if restore is not None else 0)
                # one iterator for both: a second iterator over the
                # prefetcher would wait for an end marker already taken;
                # frames a restored checkpoint holds in flight do not enter
                # again
                stream = iter(frames)
                if restore is not None:
                    held = np.asarray(sched_held_ftimes(restore, W), np.float64)
                    stream = (item for item in stream
                              if not (held.size and np.any(np.abs(held - item[1]) <= 1e-12)))
                stats = batcher.run(stream)
                stop_state["interrupted"] |= stats.interrupted
                print(f"continuous batching: lanes={K} strides={stats.strides} "
                      f"loop_steps={stats.loop_steps} occupancy={stats.occupancy}")
                if stats.leftover is not None:
                    run_grouped(max(K // 2, 1), True, sdc_guarded(solve_batch),
                                itertools.chain(stats.leftover, stream))

            if args.no_guess:
                # a grid keeps the classic grouped loop: the scheduler's
                # per-stride retire and backfill decisions would have to be
                # replicated on every rank in lockstep
                if args.batch_frames > 1 and not args.no_continuous_batching and not multi:
                    run_scheduled(args.batch_frames)
                else:
                    run_grouped(args.batch_frames, True, sdc_guarded(solve_batch), frames)
            else:
                # the warm carry (the last result, on the device) crosses
                # group boundaries; a resumed run seeds its first group
                # from the file's last row, on the host
                chain = {"warm": None, "f0": (resume_state.last_solution
                                              if resume_state is not None else None)}
                snap = {}

                def solve_chain_group(stack):
                    # the carry the group starts from, for sdc_guarded's
                    # recompute (the first attempt moves it on)
                    snap.update(chain)
                    chain["warm"] = solver.solve_chain(local_rows(stack), f0=chain["f0"],
                                                       warm=chain["warm"], **stage_kw)
                    chain["f0"] = None
                    return chain["warm"]

                run_grouped(args.chain_frames, False,
                            sdc_guarded(solve_chain_group,
                                        restore=lambda: chain.update(snap)),
                            frames)

        mark("frame loop (solve + prefetch + flush)")
        # its own watchdog budget, not the silence before it
        watchdog.beacon(watchdog.PHASE_FLUSH)
        with obs_trace.span("flush.voxel_map"):
            from sartsolver_tpu_torch.io import h5

            has_grid = not primary  # only the primary rank writes the file
            if primary and os.path.exists(args.output_file):
                with h5.File(args.output_file, "r") as f:
                    has_grid = "voxel_map" in f
            if not has_grid:  # a resumed run's file has it already
                grid.write_hdf5(args.output_file, "voxel_map")
        mark("write voxel map")
        if args.timing:
            print(timer.summary())
            print(f"fused sweep: requested={args.fused_sweep} "
                  f"resolved={opts.fused_sweep} "
                  f"engaged={FUSED_ENGAGEMENT['last'] or 'not traced'}")
        # the run's resilience accounting whenever anything failed, was
        # retried, degraded or stopped (always under --timing). Only a stop
        # that cut the run exits 4: a signal after the last boundary means
        # every frame completed.
        interrupted = stop_state["interrupted"]
        if (summary.n_failed or summary.had_retries() or summary.events
                or summary.sdc_detected or interrupted or args.timing):
            print(summary.format())
        if diverged_times:
            shown = ", ".join(f"{t:g}" for t in diverged_times[:8])
            print(f"{len(diverged_times)} frame(s) DIVERGED (status {DIVERGED}) at "
                  f"time(s) {shown}{' ...' if len(diverged_times) > 8 else ''}",
                  file=sys.stderr)
        # the end-of-run rendezvous of a file-mode pod: a worker that died
        # after its last frame is named here, not left unaccounted
        if file_pod:
            mh.pod_barrier("finalize")
        obs_metrics.count_kernel_launches(telem.registry, launches0)
        telem.finalize(summary, multihost=multi, primary=primary,
                       allgather=mh.deadline_allgather(ranks) if multi else None)
        if interrupted:
            # the group in flight drained, the writer flushed, the voxel
            # map in place: the file is a consistent prefix of the run
            sig = shutdown.stop_signal() or "a stop request"
            abort["reason"] = f"interrupted by {sig} (exit {EXIT_INTERRUPTED})"
            print(f"Interrupted by {sig}: {summary.n_frames} frame(s) written; the "
                  "output file is resumable (--resume).", file=sys.stderr)
            return EXIT_INTERRUPTED
        return summary.exit_code()
    except RetriesExhausted as err:
        # a retried site (the RTM ingest, a frame read under --fail_fast)
        # failed for good: infrastructure, not input
        abort["reason"] = f"retries exhausted: {err}"
        print(f"Unrecoverable after retries: {err}", file=sys.stderr)
        return EXIT_INFRASTRUCTURE
    except WatchdogTimeout as err:
        # a hang the watchdog interrupted that isolation could not absorb
        # (--fail_fast, or outside the frame loop): the file is resumable
        abort["reason"] = f"watchdog abort: {err}"
        print(f"Aborted by the hang watchdog: {err}", file=sys.stderr)
        return EXIT_INFRASTRUCTURE
    except mh.PodBarrierTimeout as err:
        # a pod rendezvous gave up on a dead or wedged peer: every survivor
        # ends here within the deadline, and the crash bundle's reason
        # names the missing host
        abort["reason"] = f"pod barrier failure: {err}"
        print(f"Aborted at a pod barrier: {err}", file=sys.stderr)
        return EXIT_INFRASTRUCTURE
    except PersistentCorruptionError as err:
        # the integrity layer quarantined the run: corruption no recompute
        # clears; the file is resumable up to its last committed flush
        abort["reason"] = f"SDC quarantine: {err}"
        print(f"Quarantined: {err}", file=sys.stderr)
        return EXIT_INFRASTRUCTURE
    except OutputWriteError as err:
        # a flush of the solution file failed; the file keeps its last
        # committed flush
        abort["reason"] = f"output write failure: {err}"
        print(err, file=sys.stderr)
        return EXIT_INFRASTRUCTURE
    except DeferredWriteError as err:
        # the writer thread latched a recoverable failure (a device fetch
        # that ran out of memory or hung, an I/O error outside the flush);
        # a bug as the cause still tracebacks
        if isinstance(err.__cause__, RECOVERABLE_FRAME_ERRORS):
            abort["reason"] = f"async writer failure: {err}"
            print(f"Asynchronous writer failed: {err}", file=sys.stderr)
            return EXIT_INFRASTRUCTURE
        abort["reason"] = f"unhandled {type(err).__name__}: {err}"
        raise
    except KeyError as err:
        # a missing dataset or attribute raises KeyError
        print(f"Missing dataset or attribute in input files: {err}", file=sys.stderr)
        return 1
    except (SartInputError, OSError) as err:
        # only input problems get the reference's message + exit(1); any
        # other exception is a bug and tracebacks
        print(err, file=sys.stderr)
        return 1
    except BaseException as err:
        # a bug, or a second signal's abort: it tracebacks, after the
        # crash bundle
        abort["reason"] = f"unhandled {type(err).__name__}: {err}"
        raise
    finally:
        # the crash bundle of an abnormal exit (the watchdog's os._exit
        # wrote its own through the crash hook), then every handler back
        if abort["reason"] is not None and primary:
            obs_flight.write_crash_bundle(bundle_path, abort["reason"], summary)
        watchdog.set_crash_hook(None)
        watchdog.remove_beacon_tap("pod.liveness")
        obs_flight.uninstall_status_handler(prev_usr1)
        obs_flight.uninstall()
        if wd is not None:
            wd.stop()
        shutdown.uninstall()


if __name__ == "__main__":
    sys.exit(main())
