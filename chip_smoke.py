#!/usr/bin/env python3
"""Drive sartsolver_tpu_torch on one CUDA card and check what comes out.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the checkout itself (it imports the package beside
it), and exits non-zero without them. Phases, each printing one JSON line:

1. ``env``: torch and CUDA versions, the card's name and power limit.
2. ``build``: every ``csrc/*.cu`` of the package built with ``nvcc``, in
   parallel, into ``build/sartsolver_tpu_torch/``, while the host writes
   the ``solve`` phase's world and the ``operators`` phase's reflective
   world. Then ``audit`` (4b' below), the first phase to use the profiler,
   and right after it the split kernels of phase ``grid`` (4c'), whose
   kernels a call also come from the profiler.
3. ``kernels``: the fused-sweep kernel against its plain PyTorch version on
   the card, for each storage type (B1/B2 fp32, B3 bf16, B4 int8 codes with
   their scales), linear and log, with and without the penalty, at the main
   path's shape (B = 1, 8192 x 65536) and at a ragged one (B = 3,
   1000 x 3001), each through the plan ``plan_sweep`` gives it; then every
   plan at the shapes that select it or that the GPU tests force it at
   (``one_read`` for each storage at 8192 x 65536, 8191 x 4096, the rule's
   lower edge and 1000 x 3008, B = 1, 3 and 4, fp32 also 5 and 8;
   ``tensor_core`` for int8 at B = 8, 16, 19, 32, for bf16 also at B = 5,
   and for both at ragged 1000 x 3008 x 19) and ``two_read`` forced where
   the new plans took over (B = 1 and 8, and 1000 x 3001 x 8): max error
   within ``KERNEL_TOL`` of the output's max,
   two launches byte-identical, the plan's launch count advanced. Then B4 at
   the configuration of the three int8 Pallas probes under ``benchmarks/``
   (8192 x 65536, B = 32, linear, no penalty; the direct-dot probe with
   scale 1 and ``invd = 1e-6``), checked the same way through
   ``tensor_core`` and forced ``two_read``. Then each row's kernel,
   plain-version and library times beside its bound, and the CUDA kernels
   one call launches with their device times (``torch.profiler``); each
   storage's plan at B = 1 timed in turns with forced ``two_read`` (old,
   new, new, old); the ``two_read`` / ``tensor_core`` crossover over B at
   8192 x 65536 for int8 and bf16, the ``two_read`` / ``one_read``
   crossover over P, V and B for each storage (B up to ``ONE_READ_MAX_B``:
   fp32 8; ``tensor_core`` beside for bf16 and int8 from B = 2), the
   ``one_read`` edge each table gives and the clusters ``one_read`` runs.
   Each storage's plan at the batch loops' B = 8 (fp32 ``one_read``, bf16
   and int8 ``tensor_core``) is checked and timed in turns with forced
   ``two_read`` too, linear with the penalty and log, as are fp32 at B = 5
   and bf16 at B = 32; fp32 at B = 16 (``two_read``) is timed alone.
   ``two_read``'s own rows (``TWO_READ_ROWS``: fp32 at B = 32, the tall
   world's 16384 x 65536 for each storage, a tall and narrow 65536 x 16384,
   the capacity demo's bf16 49152 x 131072 and int8 65536 x 131072 shapes),
   their inputs made on the card and freed before the next row, are checked
   and timed beside the bound, the two-read floor (H read twice) and the
   library, with each call's CUDA kernels and their device ms; a call
   launches the same kernels at B = 1, 16 and 32, and ``two_read`` is also
   checked at ragged 9000 x 3001 x 3 and at B = 40 (two passes of 32). The
   scheduled log update (``alpha_lane``, one exponent per row, distinct) is
   checked on each storage's plan at B = 1, 4 and 8, log with the penalty,
   and timed in turns with the fixed-exponent log sweep (α = 0.9) and, off
   ``two_read``, with forced ``two_read``. The crossover tables print the
   edges they measure (``one_read_edge_measured``,
   ``tensor_core_min_b_measured``) beside the rule's.
4. ``solve``: the realistic-scale world of ``benchmarks/e2e_world.py``
   (2 cameras of 64 x 64, a 256 x 256 x 1 grid, a 2 GiB fp32 RTM, 32
   frames, 1% noise, a chain Laplacian) written to HDF5 by this script's own
   numpy code and the package's HDF5 writer, then the port's ``sartsolve``
   run in-process on the card for each ``--rtm_dtype`` (float32, bfloat16,
   int8): linear with the Laplacian over 8 frames, logarithmic over 4, at
   ``--chain_frames 1`` (every frame its own group, so its own time: the
   guess frame apart from the warm ones). Launch counts are zeroed just before and read just after; every frame's
   status must be 0 or the ``-m`` cap, its fitted-space error against the
   noiseless measurement within ``FIT_BOUND``, and each storage type's
   launches equal to its runs' iterations, by storage and by plan (each
   storage through the plan ``plan_sweep`` gives it at B = 1). Each run's
   peak device memory and its fitted-space distance to the fp32 run are
   printed.
4a. ``frames``: the CLI's frame-group loops over the world's 32 frames,
   linear with the Laplacian (:func:`frames_phase`): per storage
   ``--no_guess --batch_frames 8`` through the continuous-batching scheduler
   and through the classic grouped loop, one run each (the two files equal,
   byte for byte;
   every launch on ``plan_sweep(8192, 65536, 8, storage)``, the
   scheduler's launches equal to the loop steps it printed, the classic
   loop's to the sum of its groups' loop counts); int8 at
   ``--batch_frames 4``; fp32 at ``--batch_frames 16`` and 32 (``two_read``,
   one pass over H for every batch row), scheduler and classic loop, equal
   files; ``--chain_frames 4`` against
   ``--chain_frames 1`` for fp32 and int8 (equal files, launches equal to
   the iterations). Counts are zeroed just before each run and read just
   after; ms per frame, loop iterations, occupancy, launches by plan and
   peak device memory per run.
4b. ``variants``: the solver variants through the CLI on the world, per
   storage (:func:`variants_phase`), beside the same runs without them:
   ``-L --relaxation_decay 0.98`` warm started and through the batch loops
   (scheduler = classic, byte for byte), ``--momentum nesterov`` linear and
   log, ``--divergence_recovery 2`` byte-equal to the unguarded run and, on
   a copy of the world with a NaN pixel in frame 3, that frame DIVERGED with
   a zero row and exit 2; every scheduled-log launch counted, on the plan of
   its run's B; each frame's ms.
4b'. ``os``: ordered subsets through the CLI on the world at
   ``--os_subsets OS_SUBSETS``, per storage (:func:`os_phase`): linear with
   the Laplacian and log with ``--momentum nesterov``, each warm started
   over 4 frames at ``--chain_frames 1`` and through ``--no_guess
   --batch_frames 8`` in the scheduler and the classic loop (equal files);
   statuses, fitted errors within ``FIT_BOUND``, no fused-sweep launch;
   iterations, ms per frame and peak device bytes beside the fused path's
   runs of the same flags (warm started, and in the scheduler) and the
   stored matrix's bytes. Then ``debug_nans``
   (:func:`debug_nans_phase`): a NaN pixel exits 0 from the chain and
   raises from the scheduler, as on the CPU, and the flag changes no byte
   of a healthy scheduler run or OS chain (ms per frame with and without).
4b'. ``audit`` (run right after ``build``): the launch audit
   (``analysis/audit.py``) of every single-rank entry of the registry on
   the world's matrix at full width
   (:func:`audit_phase`): each through ``solve_batch`` for K and 2K
   iterations, fp32 at B = 1, the fused entries also bf16 and int8 at B = 1
   and 8 (``tensor_core``) and fp32 at B = 16 (``two_read``); one line per
   entry with its per-iteration hand launches by plan, the CUDA kernels the
   profiler saw by name (which must agree with the launches), host syncs,
   matrix-sized copies and converts, the largest fp64 tensor, collectives,
   aten ops and elements converted. Any violation fails the run. The grid
   entries are audited in phase ``grid``'s 2x1 group (``--audit``).
4b''. ``obs``: the observability layer through the CLI on the world
   (:func:`obs_phase`), per storage the chain loop over 8 frames and
   ``--no_guess --batch_frames 8`` over the 32, each without sinks and then
   with ``--timing``, ``--metrics_out``, ``SART_METRICS_PROM`` and
   ``SART_TRACE_EVENTS``: the artifact passes ``metrics --check``, its
   frame records are the file's rows, the file is the same bytes as
   without sinks, ``frames_total`` and ``sched_strides_total`` are what
   stdout printed; emitted: the phase split (validate, ingest and upload,
   frame loop, voxel map; in the ingest, the ``ingest.rtm`` span with its
   passes over the file and its first ``device.put``, the solver's
   construction) beside the wall time, ms per frame with sinks on and
   off. Then the fp32 scheduler under ``--profile_dir``: one profiler
   step per stride, ``one_read``'s kernels inside the steps equal to its
   launches; ``device_peaks`` of the card (the H100 row) and the roofline
   utilization of that loop (``hbm_util`` at most 1.05).
4b'''. ``ingest``: the chunked RTM ingest (``parallel/multihost.py``) on
   the world per storage (:func:`ingest_phase`): each pass's seconds, its
   read and upload seconds and the read's GB/s, the ray stats' seconds,
   the peak device bytes (at most the stored matrix, two fp32 chunks and
   the ray stats); the stored matrix bit for bit against the host recipe
   (``read_rtm_block``, bf16 rounded and int8 quantized on the host), on the
   files as written and on a copy with matrices chunked 256 rows a chunk;
   the CLI's host memory growth in a child process per storage, the
   three at once (at most two fp32
   chunks and a stated margin); the CLI with ``--timing`` on the chain over
   8 frames and the scheduler over the 32, at the defaults and with one
   chunk, prefetch off and a writer queue of one: the same bytes and
   launches. Then the fault drill: ``SART_FAULT=hdf5.rtm_ingest:io:1:1``
   on the chain recovers with the healthy file, and
   ``SART_FAULT=solve.dispatch:error:1:1`` writes one FAILED row, the
   others equal to a healthy run's; a healthy run with a FAILED row fails
   the phase.
4b''''. ``resilience``: the resilience of a run on the world
   (:func:`resilience_phase`). Per storage, ``--resume`` after a half run
   (``-t``) for the chain (8 frames, ``--chain_frames 1``) and for the
   scheduler (``--no_guess --batch_frames 8``, the 32 frames): the
   ``Processed in`` count, the rows before the cut the uninterrupted run's
   bytes, the rows after it its statuses and within ``RESUME_FIT_TOL`` in
   fitted space; each uninterrupted run again with ``--integrity``
   (``one_read`` at B = 1 and fp32 B = 8, ``tensor_core`` for bf16 and int8
   at B = 8) and fp32 at ``--batch_frames 16`` (``two_read``; the tall
   world's runs in ``tall_world``): the same bytes, no trip, the largest
   residual over its band, every launch on the run's plan, ms per frame on
   and off. On the fp32 chain, one flush a frame, in subprocesses (run at
   once with the in-solve checkpoints' killed run below, then followed up
   in turn): SIGKILL inside the ``torn`` and ``pre-counter`` windows, then
   ``--resume``; SIGUSR1 (the status snapshot, rendered by ``top --once``)
   then SIGTERM (exit 4), then ``--resume``. The hang watchdog
   (``SART_WATCHDOG_TIMEOUT=2``, ``solve.dispatch:hang:1:1``): a FAILED row
   and exit 2; under ``--fail_fast`` exit 3 and a crash bundle. The
   resident matrix corrupted (``device.buffer:corrupt``): the solver API's
   status and trip iteration, the re-audit, and the CLI's quarantine (exit
   3) after re-solving on the same plan; the JAX package's recipe
   (``x * 256 + 1``), the forward check's detection limit at this size,
   and the CLI's quarantine by the re-audit. The ingest with the integrity
   layer's sums on the card and off, in turns, the same sums on the host,
   and the CLI's ``ingest RTM + upload`` with and without
   ``--integrity``; ms per frame with it on and off, ``INTEGRITY_TURNS``
   runs each way over the 32 frames, fp32 scheduler and chain. Then the
   flush timed alone (:func:`flush_timing`): appends of ``FLUSH_ROWS`` rows
   at V = 65,536 after ``FLUSH_AT`` rows, and ``write voxel map`` after
   ``VOXEL_MAP_AT`` rows.
   The phase ends with the in-solve checkpoints (:func:`solve_ckpt_drill`,
   fp32 ``--no_guess --batch_frames 8`` over the 32 frames): SIGKILL inside
   the held-open append of serial 2 (a subprocess), ``--resume`` from
   serial 1 to the uninterrupted run's bytes; ms per frame at
   ``--solve_ckpt_stride`` 1, 4 and 16 against off, one run each (each run
   the same bytes), and the bytes a record takes.
4b5. ``sparse``: the block-sparse RTM (:func:`sparse_phase`) on a copy
   of the world whose grid's top and bottom 64 rows no camera sees (voxels
   [0, 16384) and [49152, 65536): 256 of the 512 tile columns empty, the
   2% floor kept on the rest). Per storage the ingest and the solver's
   construction dense and with the tile index (the sparse peak device
   bytes no higher than the dense one's; the resident bytes), then linear
   (8 frames) and log (4) at ``--sparse_rtm auto`` beside ``off``: equal
   statuses, fitted distance within ``SPARSE_FIT_TOL``, every sparse
   launch on ``plan_sweep(8192, 32768, 1, storage)``, one per iteration;
   fp32 once at ``--sparse_rtm 0.05`` (the same columns held, the
   thresholded operator's fit recorded), ``--no_guess --batch_frames 8``
   (launches on the compacted B = 8 plan, equal to the loop steps) and
   ``--os_subsets 4`` (no fused-sweep launch), each beside ``off``; ms per
   frame sparse and dense. The compacted call (8192 x 32768, each storage
   at B = 1, fp32 at B = 8) checked against its plain version through the
   runs' plan and timed beside its bound, the plain version and the
   library (two ``torch.matmul`` on the compacted fp32 matrix).
4b6. ``operators``: the operator backends (:func:`operators_phase`). The
   reflective world (:func:`write_reflective_world`: the e2e layout, the
   vessel columns [16384, 49152) banded with a 10% floor, a rank-4
   wall-reflection term on every column below 5% of max|H|): the factored
   RTM's gate once, timed by its parts (read, split, rSVD, the parity
   gate's two solves), the factored solver's held matrix and factor bytes
   per storage; per storage ``--lowrank_rtm auto`` against ``off``, linear
   over 8 frames (the chain) and log over 4, fp32 also ``--lowrank_rtm 4``,
   ``--no_guess --batch_frames 8`` and ``--os_subsets 4``: rank 4 in every
   run, statuses equal to the dense run's, fitted distance within
   ``OPERATOR_FIT_TOL``, ms per frame, the wall's split from ``--timing``,
   peak device bytes; ``--lowrank_rtm 2`` exits 1; ``auto`` declines
   loudly on the e2e world. The geometry world
   (:func:`write_geometry_world`: a 64 x 64 x 16 grid, two 64 x 64 pinhole
   cameras; its materialized matrix as the dense twin's files):
   ``--geometry`` linear, log, ``--no_guess --batch_frames 8`` and
   ``--os_subsets 4`` against the dense twin (statuses, fitted distance,
   the projector's launches above 0), ``--rtm_dtype int8 --geometry`` exits
   1; the projector's kernel table: every entry (5.4e8) bit for bit
   against the dense twin's matrix, forward and back at B = 1 and 8
   against the plain version within ``KERNEL_TOL``, timed beside the bound
   (the nonzero entries' operations against the bytes), the pairs the
   kernel evaluates (counted by its plain mirror), the plain version and
   ``torch.matmul`` on the materialized matrix. The wide geometry world
   (``IMPLICIT_WIDE``: 128 x 128 x 64 voxels, two 256 x 256 cameras),
   kernel only (:func:`_implicit_wide`): rows and columns bit for bit,
   restricted sums within ``KERNEL_TOL``, forward and back at B = 1 and 8
   timed beside the bound and the pairs evaluated, the seconds it adds.
4b7. ``serve``: the resident serving engine (:func:`serve_phase`): ``python
   -m sartsolver_tpu_torch.cli serve --lanes 2 --socket ... --http_port 0``
   on the world, linear with the Laplacian; two tenants' requests through
   ``submit`` and the ingest dir, through the socket, and a pair published
   at once whose tight deadline sheds frames as -5 while the co-batched
   request completes; meanwhile a second server at ``--lanes 4`` sent
   SIGTERM inside its request's dispatched journal window (exit 4), whose
   restart replays the journal; a third serves the geometry world's images
   through the implicit operator and takes ``submit --geometry``; with the
   restart, two more at ``--lanes 2`` serve a request each from the matrix
   stored as ``--rtm_dtype bfloat16`` and ``int8``. Every served row equals,
   byte for byte, the one-shot CLI's over the same frames at the server's
   lanes and storage, and is within ``FIT_BOUND`` of the truth; each
   server's metrics artifact carries its kernels' launches by plan;
   recorded: request latency and queue wait (p50, p95), the first request
   apart from the later ones (the server runs a warm-up stride before it is
   ready), ms per frame served against the CLI's, the fused sweep at B = 2
   and 4 against its plain version, its bound and the library.
4b8. ``selfheal``: the self-healing serve (:func:`selfheal_phase`), three
   parts at once. ``serve --supervised --lanes 2 --http_port 0`` on the
   world, linear with the Laplacian: its worker SIGKILLed inside a 4-frame
   request's dispatched journal window, restarted by the supervisor, the
   journal replayed: one ``completed`` marker, rows byte-equal to the CLI's
   ``--no_guess --batch_frames 2`` over the same frames,
   ``engine_restarts_total{reason="signal:SIGKILL"}`` 1, SIGTERM forwarded
   once, exit 4; the kill to the restarted worker's ready by part, each
   incarnation's launches. Beside it ``chaos`` (one seed, a SIGKILL in a
   journal window) and ``chaos --fleet 2`` (one seed, a worker SIGKILL),
   on the world's matrix with images of its first 4 frames, each judged
   ``ok``. The supervised worker's launches join the B = 2 row of the
   kernel table.
4b9. ``pod``: the pod's fault tolerance (:func:`pod_phase`) on the world's
   matrix with images of its first 16 frames, every worker the scheduler
   at ``--no_guess --batch_frames 4 --solve_ckpt_stride 2`` (``one_read``
   fp32 at B = 4), every pass on a fresh barrier directory at
   ``SART_POD_BARRIER_TIMEOUT=10``: (a) a solo run alone, then two
   fake-pod workers (``SART_POD_PROCESS=k/2``: the campaign's reference
   pass), the three files the same bytes; each worker's ms per frame
   against the solo run's and its ``kernel_launches_total`` (the loop steps
   it printed, on the plan); (b) ``chaos --pod 2 --seeds 0,3`` judged
   ``ok``, each survivor's exit within the deadline plus 15 s of the kill,
   the agreed resume serials; (c) beside its seeds, once the reference pass
   has ended, a 2x1 grid under torchrun, the ranks sharing the
   card over gloo: a ``-t`` run over the first half, then ``--resume``,
   the file an uninterrupted 2x1 run's, statuses the solo run's; the resume
   view's broadcast seconds; then rank 1 of two SIGKILLed in its ingest turn,
   rank 0's exit 3 within the deadline plus 15 s.
4c. ``batch``: the 32 frames of the world solved at once through the solver
   API (``solve_normalized_batch``, B = 32) with int8 storage and the
   Laplacian, so through ``tensor_core``: counts zeroed before and read
   after (one launch per loop iteration), statuses and fitted-space errors
   as above; then through the plain version: the same statuses, and over
   ``BATCH_CROSS_ITERATIONS`` iterations without the stall test each
   frame's fitted space within ``CROSS_TOL`` of the kernel's.
4d. ``tall_world``: the world with cameras of 128 x 64 (P = 16384, past
   ``one_read``'s P; 4 GiB fp32) through the CLI for each ``--rtm_dtype``,
   linear with the Laplacian over 4 frames at ``--chain_frames 1``
   (:func:`tall_world_phase`): statuses, fitted errors within
   ``FIT_BOUND``, every launch on ``two_read``, one per iteration; ms per
   frame; each run again with ``--integrity`` (:func:`integrity_pair`). It
   runs last, after the e2e world's RTM files are deleted.
4c'. ``grid``: the solve over a grid of ranks (:func:`grid_phase`). The
   split sweep at the 2x1 grid's block (4096 x 65536, B = 1) per storage
   (:func:`split_kernels`): ``sharded_sweep_bp`` and
   ``sharded_sweep_finish`` against their plain versions (linear with the
   penalty and log), the pair at one rank bit for bit against ``two_read``,
   each timed beside its bound, its plain version and one ``torch.matmul``
   on the fp32 block, each call's CUDA kernels and device ms from the
   profiler's trace (the route's kernels a call: one on the cluster route,
   ``split_route``; the library's device ms beside fp32's); the
   kernel-vs-plain parity on a 2x1 grid by the first
   run's ranks (``utils/fused_parity.py``, ``GRID_PARITY``), each path also
   against the fp64 solve of that grid (``FP64_RATIO``); the CLI under
   ``python -m torch.distributed.run`` (this script as each rank,
   ``--grid-rank``: the CLI's main, then the rank's launch counts and
   collectives; one launch for the runs of each world size, run one after
   another in its process group) over the world's first ``GRID_FRAMES``
   frames for each of ``GRID_RUNS`` (2x1, 1x2, 2x2, 1x2 int8 over gloo,
   the ranks sharing the card; 1x1 over NCCL), each against the solve phase's
   one-rank run: statuses equal, fitted distance within ``GRID_FIT_TOL``,
   only rank 0's frame lines, the solver line's mesh and backend, every
   rank's launches one an iteration (the split pair on pixel-sharded
   grids, the fused sweep's plan on the column block otherwise), the
   collectives' ms an iteration.
5. ``plain_crosscheck``: frame 0 solved through the kernel and through the
   plain version (the solver core's ``sweep_fn``): equal statuses,
   iteration counts at most 1 apart, fitted-space agreement within
   ``CROSS_TOL``.
6. ``profile``: under ``torch.profiler`` for each storage type, frame 0
   once more, and the first 8 frames as one group of the classic loop
   (``solve_batch``) and through 8 scheduler lanes: device time by kernel,
   the wall time and the device's idle share; and frame 0 from the guess
   at ``--os_subsets OS_SUBSETS`` (``os_frame0``), its device ms split into
   the subset forwards, the subset back projections and the full forward
   (the OS cycle's ``record_function`` ranges), the rest of the device's
   ms and the host's.

Then the kernel table as one JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import gc
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# fp32 sums of up to 65536 terms taken in another order than cuBLAS's
KERNEL_TOL = 1e-5
# 1% measurement noise bounds how close a solution's projection can come to
# the noiseless data; the Laplacian's bias adds a little (the JAX package's
# own check, tests/test_cli.py, holds H @ solution to 5% of H @ f_true)
FIT_BOUND = 0.05
# kernel against plain version in fitted space: frame 0 of the main path,
# and the batched int8 solve
CROSS_TOL = 1e-3
# iterations of the batched solve's fixed-count comparison with the plain
# version (about where its frames converge)
BATCH_CROSS_ITERATIONS = 100
# (P, V) of the one_read / two_read crossover, each at B = 1 .. ONE_READ_MAX_B
ONE_READ_CROSSOVER_PV = ((1024, 65536), (2048, 65536), (4096, 65536), (5120, 65536),
                         (6144, 65536), (7168, 65536), (8192, 65536), (8192, 4096),
                         (8192, 1024), (1000, 3008))
MAX_ITERATIONS = 500  # -m cap of the main path's runs
# the frames phase: --batch_frames of the scheduler and classic loops (the
# lane count whose plan each storage's row of the kernel table is timed at),
# the int8 run on one_read, and --chain_frames against the serial loop
FRAME_LANES = 8
FOUR_LANES = 4
SIXTEEN_LANES = 16  # fp32 beyond one_read's B = 8: two_read, one pass over H
THIRTY_TWO_LANES = 32  # fp32 at the JAX package's reported batch: two_read
CHAIN_FRAMES = 4
# the tall world: the e2e grid seen by 2 cameras of 128 x 64 (P = 16384, past
# one_read's 8192, so every storage runs two_read); 4 frames each
TALL_CAM = (128, 64)
TALL_FRAMES = 4

# card -> (memory rate in B/s, fp32 rate outside the tensor cores in FLOP/s,
# bf16 dense tensor-core rate in FLOP/s); NVIDIA's data sheets, dense rates
# at the full power limit
PEAKS = {"PCIe": (2.0e12, 51e12, 756e12), "SXM": (3.35e12, 67e12, 989e12)}


_T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started
    (``t``): where the run's time goes."""
    print(json.dumps({"phase": phase, "t": time.perf_counter() - _T_START, **fields}),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---- the e2e world (benchmarks/e2e_world.py, same seed and construction) --

def _write_voxel_map(group, nx, ny, cells, values):
    vm = group.create_group("voxel_map")
    for name, n in (("nx", nx), ("ny", ny), ("nz", 1)):
        vm.attrs.create(name, n, dtype=np.uint64)
    for name, val in (("xmin", 0.0), ("xmax", 4.0), ("ymin", 0.0),
                      ("ymax", 4.0), ("zmin", 0.0), ("zmax", 1.0)):
        vm.attrs.create(name, val, dtype=np.float64)
    vm.create_dataset("i", data=(cells // ny).astype(np.uint64))
    vm.create_dataset("j", data=(cells % ny).astype(np.uint64))
    vm.create_dataset("k", data=np.zeros_like(cells, np.uint64))
    vm.create_dataset("value", data=values.astype(np.int64))


def _write_rtm(path, camera, mask, block, nx, ny, cells, values):
    from sartsolver_tpu_torch.io import h5

    with h5.File(path, "w") as f:
        rtm = f.create_group("rtm")
        rtm.attrs["camera_name"] = camera
        rtm.attrs.create("npixel", block.shape[0], dtype=np.uint64)
        rtm.attrs.create("nvoxel", block.shape[1], dtype=np.uint64)
        rtm.create_dataset("frame_mask", data=mask)
        g = rtm.create_group("with_reflections")
        g.attrs.create("wavelength", 500.0, dtype=np.float64)
        g.attrs.create("is_sparse", 0, dtype=np.int64)
        g.create_dataset("value", data=block)
        _write_voxel_map(rtm, nx, ny, cells, values)


def _write_image(path, camera, frames, times):
    from sartsolver_tpu_torch.io import h5

    with h5.File(path, "w") as f:
        img = f.create_group("image")
        img.attrs["camera_name"] = camera
        img.attrs.create("wavelength", 500.0, dtype=np.float64)
        img.create_dataset("frame", data=np.asarray(frames, np.float64))
        img.create_dataset("time", data=np.asarray(times, np.float64))


def _write_laplacian(path, nvoxel, scale=0.1):
    from sartsolver_tpu_torch.io import h5

    # per voxel i: (i, i, 2s), then (i, i-1, -s) and (i, i+1, -s) where
    # they exist — the triplet order of tests/fixtures.py:write_laplacian_file
    i = np.arange(nvoxel)[:, None]
    rows, cols = np.broadcast_to(i, (nvoxel, 3)), i + np.array([0, -1, 1])
    vals = np.broadcast_to(np.array([2 * scale, -scale, -scale]), (nvoxel, 3))
    keep = (cols >= 0) & (cols < nvoxel)
    with h5.File(path, "w") as f:
        g = f.create_group("laplacian")
        g.attrs.create("nvoxel", nvoxel, dtype=np.uint64)
        g.create_dataset("i", data=rows[keep].astype(np.uint64))
        g.create_dataset("j", data=cols[keep].astype(np.uint64))
        g.create_dataset("value", data=vals[keep].astype(np.float32))


def write_world(outdir: str, nx: int = 256, ny: int = 256, cam=(64, 64),
                n_frames: int = 32) -> dict:
    """Write the e2e world; returns the file paths plus ``H`` [P, V] fp32,
    ``f_true`` [V] and ``scales`` [T]. The defaults are the realistic scale;
    tests call it smaller."""
    V = nx * ny
    npix_cam = cam[0] * cam[1]
    rng = np.random.default_rng(0)
    # banded response + diffuse reflection floor (reflections make the
    # matrix dense)
    ii = np.arange(2 * npix_cam, dtype=np.float32)[:, None] / (2 * npix_cam)
    jj = np.arange(V, dtype=np.float32)[None, :] / V
    H = rng.random((2 * npix_cam, V), dtype=np.float32) * 0.9 + 0.1
    H *= np.exp(-((ii - jj) ** 2) * 200.0) + 0.02
    f_true = rng.random(V, dtype=np.float32) * 1.5 + 0.5
    return _write_world_files(outdir, H, f_true, nx, ny, cam, n_frames, rng)


def _write_world_files(outdir, H, f_true, nx, ny, cam, n_frames, rng) -> dict:
    """The world's files for ``H`` and ``f_true``: the RTM (camera A in two
    voxel segments, the stitching path, camera B whole), ``n_frames``
    frames of ``H @ (f_true * scale)`` with 1% noise from ``rng``, and the
    chain Laplacian."""
    P, V = H.shape
    npix_cam = P // 2
    mask = np.ones(cam, np.int64)
    cells = np.arange(V)
    half = V // 2
    paths = {k: os.path.join(outdir, f"{k}.h5") for k in (
        "rtm_a_seg1", "rtm_a_seg2", "rtm_b", "img_a", "img_b", "laplacian")}
    _write_rtm(paths["rtm_a_seg1"], "camA", mask, H[:npix_cam, :half], nx, ny,
               cells[:half], np.arange(half))
    _write_rtm(paths["rtm_a_seg2"], "camA", mask, H[:npix_cam, half:], nx, ny,
               cells[half:], np.arange(half))
    _write_rtm(paths["rtm_b"], "camB", mask, H[npix_cam:], nx, ny, cells, np.arange(V))

    times = np.arange(n_frames) * 0.1
    scales = 1.0 + 0.3 * np.sin(np.linspace(0, 2 * np.pi, n_frames))
    F = (f_true[:, None] * scales[None, :]).astype(np.float32)  # [V, T]
    G = H @ F
    G *= 1.0 + 0.01 * rng.standard_normal(G.shape).astype(np.float32)
    _write_image(paths["img_a"], "camA", G[:npix_cam].T.reshape(n_frames, *cam), times)
    _write_image(paths["img_b"], "camB", G[npix_cam:].T.reshape(n_frames, *cam), times)
    _write_laplacian(paths["laplacian"], V)
    return {"paths": paths, "H": H, "f_true": f_true, "scales": scales,
            "G": G, "times": times, "cam": cam, "grid": (nx, ny)}


def write_dark_world(world, outdir: str, dark_rows: int) -> dict:
    """The world with the grid's first and last ``dark_rows`` rows seen by
    no camera: their voxels' columns zero in every file (the voxels outside
    the vessel that a rectangular grid carries), the 2% reflection floor
    kept on the rest; the frames made anew (1% noise, seed 1)."""
    nx, ny = world["grid"]
    H = world["H"].copy()
    H[:, :dark_rows * ny] = 0.0
    H[:, (nx - dark_rows) * ny:] = 0.0
    os.makedirs(outdir, exist_ok=True)
    return _write_world_files(outdir, H, world["f_true"], nx, ny, world["cam"],
                              world["G"].shape[1], np.random.default_rng(1))


def write_reflective_world(outdir: str, nx: int = 256, ny: int = 256, cam=(64, 64),
                           n_frames: int = 32) -> dict:
    """The reflective world of the factored RTM: the e2e world's layout
    and frames, the vessel columns [V/4, 3V/4) holding the banded response
    with a 10% floor, ``(0.1 + 0.9u)(exp(-200(i-j)^2) + 0.1)``, and every
    column a smooth positive rank-4 wall-reflection term ``R = sum_k a_k
    b_k^T`` (cosine modes over pixel and voxel index) scaled to at most
    0.035 max|H|; the whole scaled so that the median row sum is 1. Every
    8 x 128 tile of the vessel columns holds an entry above 5% of max|H|,
    none outside them does: after the 5% tile split the residual is R on
    the outer columns, exactly rank 4."""
    V = nx * ny
    P = 2 * cam[0] * cam[1]
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(0)
    H = np.zeros((P, V), np.float32)
    v0, v1 = V // 4, 3 * V // 4
    ii = np.arange(P, dtype=np.float32)[:, None] / P
    jj = np.arange(v0, v1, dtype=np.float32)[None, :] / V
    H[:, v0:v1] = ((rng.random((P, v1 - v0), dtype=np.float32) * 0.9 + 0.1)
                   * (np.exp(-((ii - jj) ** 2) * 200.0) + 0.1))
    i = np.arange(P, dtype=np.float64) / P
    j = np.arange(V, dtype=np.float64) / V
    a = np.stack([1.0 + 0.5 * np.cos(2 * np.pi * (k + 1) * i) for k in range(4)], axis=1)
    b = np.stack([1.0 + 0.5 * np.cos(2 * np.pi * (k + 1) * j + k) for k in range(4)], axis=1)
    R = a @ b.T
    H += (R * (0.035 * float(H.max()) / R.max())).astype(np.float32)
    # a ray's whole response (the median row sum) one: at the e2e world's
    # scale (row sums near 4000) the Eq. 4 guess overshoots by that factor
    # and the fp32 solve's first iterations cancel, 3e-4 of fp64 after 20
    # iterations at 8192 x 65536 on the H100, above the factored RTM's
    # parity gate (2e-4); scaled, 3e-6 (the split is relative to max|H|)
    H *= np.float32(1.0 / np.median(H.sum(axis=1, dtype=np.float64)))
    f_true = rng.random(V, dtype=np.float32) * 1.5 + 0.5
    return _write_world_files(outdir, H, f_true, nx, ny, cam, n_frames, rng)


GEOMETRY_PITCH = 1.0  # the detectors' pitch in voxels for cameras as wide as the grid


def geometry_record(nx: int = 64, ny: int = 64, nz: int = 16, cam=(64, 64)):
    """The geometry world's record: an ``nx x ny x nz`` grid of unit
    voxels and two pinhole cameras of ``cam`` pixels, ``camA`` looking at
    the grid's centre along +x from its side and ``camB`` down along -z
    from above, each at a distance of twice the grid's width, the pitch
    one voxel (each detector spans the grid at the centre's plane)."""
    from sartsolver_tpu_torch.operators.geometry import parse_geometry

    c = [nx / 2.0, ny / 2.0, nz / 2.0]
    rows, cols = cam
    pitch = GEOMETRY_PITCH * nx / cols
    return parse_geometry({
        "format": "sart-geometry", "version": 1,
        "grid": {"shape": [nx, ny, nz], "origin": [0.0, 0.0, 0.0],
                 "spacing": [1.0, 1.0, 1.0]},
        "cameras": [
            {"name": "camA", "rows": rows, "cols": cols, "position": [-2.0 * nx, c[1], c[2]],
             "target": c, "up": [0.0, 0.0, 1.0], "pitch": pitch},
            {"name": "camB", "rows": rows, "cols": cols, "position": [c[0], c[1], 2.0 * nx],
             "target": c, "up": [0.0, 1.0, 0.0], "pitch": pitch},
        ],
    })


def write_geometry_world(outdir: str, nx: int = 64, ny: int = 64, nz: int = 16, cam=(64, 64),
                         n_frames: int = 32, device: str = "cuda") -> dict:
    """The geometry world: the record of :func:`geometry_record` saved as
    ``geometry.json``, its materialized matrix (the plain version's entries,
    built on ``device``) as the dense twin's RTM files in the e2e layout,
    and ``n_frames`` frames of ``H @ (f_true * scale)`` with 1% noise as the
    two cameras' image files. ``inputs``: the dense twin's input files."""
    from sartsolver_tpu_torch.operators.geometry import save_geometry
    from sartsolver_tpu_torch.operators.implicit import (
        ImplicitOperator, divisor_panel, materialize_rtm,
    )

    rec = geometry_record(nx, ny, nz, cam)
    os.makedirs(outdir, exist_ok=True)
    op = ImplicitOperator(rec)
    spec = op.spec(padded_nvoxel=rec.nvoxel, panel_voxels=divisor_panel(rec.nvoxel))
    H = materialize_rtm(op.payload(), spec, device=device)
    rng = np.random.default_rng(2)
    f_true = rng.random(rec.nvoxel, dtype=np.float32) * 1.5 + 0.5
    world = _write_world_files(outdir, H, f_true, nx, ny * nz, cam, n_frames, rng)
    world["geometry"] = os.path.join(outdir, "geometry.json")
    save_geometry(rec, world["geometry"])
    p = world["paths"]
    world["inputs"] = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    return world


def run_cli(argv, device: str = "cuda"):
    """The port's CLI in-process; returns (exit code, per-frame ms, what it
    printed)."""
    from sartsolver_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*argv, "--device", device])
    text = buf.getvalue()
    ms = [float(m) for m in re.findall(r"Processed in: ([0-9.eE+-]+) ms", text)]
    return rc, ms, text


def check_solution(path, world, n_frames: int, cap: int, device, skip=(),
                   fit_bound: Optional[float] = FIT_BOUND):
    """Schema, statuses and fitted-space errors of one solution file; the
    frames in ``skip`` are left to the caller (their errors come back 0).
    ``fit_bound`` None: the errors are returned, not held to a bound."""
    from sartsolver_tpu_torch.io import h5
    import torch

    with h5.File(path, "r") as f:
        sol = {k: f["solution"][k][:] for k in f["solution"]}
        has_map = "voxel_map" in f and f["voxel_map/value"].shape[0] == world["H"].shape[1]
    want = {"value", "time", "status", "iterations", "checksum", "time_camA", "time_camB"}
    if set(sol) != want or not has_map:
        raise AssertionError(f"solution schema {sorted(sol)}, voxel_map {has_map}")
    V = world["H"].shape[1]
    if sol["value"].shape != (n_frames, V) or not np.isfinite(sol["value"]).all():
        raise AssertionError(f"solution/value {sol['value'].shape} or not finite")
    ok = (sol["status"] == 0) | ((sol["status"] == -1) & (sol["iterations"] == cap))
    ok[list(skip)] = True
    if not ok.all():
        raise AssertionError(f"statuses {sol['status']} iterations {sol['iterations']}")
    H = torch.as_tensor(world["H"], device=device)
    truth = torch.as_tensor(world["f_true"][:, None] * world["scales"][None, :n_frames],
                            dtype=torch.float32, device=device)
    fit = H @ torch.as_tensor(sol["value"].T, dtype=torch.float32, device=device)
    ref = H @ truth
    err = ((fit - ref).norm(dim=0) / ref.norm(dim=0)).cpu().numpy()
    err[list(skip)] = 0.0
    if fit_bound is not None and not (err <= fit_bound).all():
        raise AssertionError(f"fitted-space errors {err} above {fit_bound}")
    return sol, err


def group_loops(iterations, K: int) -> int:
    """Loop iterations of the classic grouped loop over whole groups of K:
    each group runs to its slowest frame."""
    return sum(int(max(iterations[s:s + K])) for s in range(0, len(iterations), K))


def frames_phase(world, outdir: str, device: str = "cuda") -> dict:
    """The CLI's frame-group loops over every frame of the world, linear
    with the Laplacian. Per storage: ``--no_guess --batch_frames 8`` through
    the scheduler and through the classic loop (equal solution files, byte
    for byte); for int8 also ``--batch_frames 4``; for fp32 and int8
    ``--chain_frames 4`` against ``--chain_frames 1`` on the warm-started
    stream (equal files). Every frame's status 0 or the cap and its fitted
    error within ``FIT_BOUND``. On the card, counts are zeroed just before
    each run and read just after: every launch on the plan ``plan_sweep``
    gives the run's batch, the scheduler's launches equal the loop steps it
    printed, the classic loop's the sum of its groups' loop counts (whole
    groups only), the chain's the frames' iterations."""
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, plan_sweep, reset_launch_counts

    p = world["paths"]
    base = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"],
            "-m", str(MAX_ITERATIONS), "-l", p["laplacian"]]
    P, V = world["H"].shape
    T = world["G"].shape[1]
    on_card = device == "cuda"
    if on_card:
        import torch

    def run(name, flags):
        out = os.path.join(outdir, f"frames_{name}.h5")
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
        reset_launch_counts()
        t0 = time.perf_counter()
        rc, ms, text = run_cli(["-o", out, *base, *flags], device=device)
        wall = time.perf_counter() - t0
        rec = dict(wall_ms_per_frame=wall * 1e3 / T, launches_by_plan=dict(fused_sweep.launches_by_plan))
        if on_card:  # the run's own peak, before the check uploads H
            rec["peak_device_bytes"] = torch.cuda.max_memory_allocated() - mem0
        if rc != 0 or len(ms) != T:
            raise AssertionError(f"frames {name} run: exit {rc}, {len(ms)} of {T} frames")
        sol, err = check_solution(out, world, T, MAX_ITERATIONS, device)
        rec.update(cli_ms_per_frame=statistics.mean(ms),
                   frame_iterations=int(sol["iterations"].sum()), fit_err_max=float(err.max()))
        m = re.search(r"continuous batching: lanes=\d+ strides=(\d+) loop_steps=(\d+) "
                      r"occupancy=([0-9.eE+-]+)", text)
        if m:
            rec.update(strides=int(m[1]), loop_steps=int(m[2]), occupancy=float(m[3]))
        return sol, rec

    def same(a, b, what):
        for key in ("value", "status", "iterations"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"{what}: solution/{key} differ")

    def launched(rec, plan, count, what):
        want = dict.fromkeys(rec["launches_by_plan"], 0)
        want[plan] = count
        if on_card and rec["launches_by_plan"] != want:
            raise AssertionError(f"{what}: {rec['launches_by_plan']} launches, "
                                 f"{count} on {plan} expected")

    record = {}
    for storage in STORAGES:
        flags = ["--rtm_dtype", storage, "--no_guess", "--batch_frames", str(FRAME_LANES)]
        plan = plan_sweep(P, V, FRAME_LANES, storage)
        # one run each: the smoke run's length leaves no second turn (the
        # two loops differ only on the host, whose speed drifts in a call)
        first, in_turns = {}, {"scheduled": [], "classic": []}
        for kind in ("scheduled", "classic"):
            sol, rec = run(f"{storage}_{kind}", flags if kind == "scheduled"
                           else [*flags, "--no_continuous_batching"])
            if kind == "scheduled":
                launched(rec, plan, rec["loop_steps"], f"{storage} scheduler")
            else:
                loops = group_loops(sol["iterations"], FRAME_LANES)
                rec.update(loop_iterations=loops,
                           occupancy=rec["frame_iterations"] / (loops * FRAME_LANES))
                if T % FRAME_LANES == 0:  # no dark tail, whose loop counts the file lacks
                    launched(rec, plan, loops, f"{storage} classic loop")
            same(sol, first.setdefault("solution", sol),
                 f"{storage}: {kind} against the first scheduled run")
            first.setdefault(kind, rec)
            in_turns[kind].append(rec["cli_ms_per_frame"])
        sched, classic = first["scheduled"], first["classic"]
        for kind, rec in (("scheduled", sched), ("classic", classic)):
            rec["cli_ms_per_frame_in_turns"] = in_turns[kind]
        entry = dict(plan=plan, lanes=FRAME_LANES, scheduled=sched, classic=classic)
        if storage == "float32":  # past one_read's B = 8: two_read, one pass over H
            for lanes, name in ((SIXTEEN_LANES, "sixteen_lanes"),
                                (THIRTY_TWO_LANES, "thirty_two_lanes")):
                wide_plan = plan_sweep(P, V, lanes, storage)
                wide_flags = ["--rtm_dtype", storage, "--no_guess", "--batch_frames", str(lanes)]
                wide_sol, wide = run(f"float32_{lanes}", wide_flags)
                launched(wide, wide_plan, wide["loop_steps"], f"fp32 scheduler, {lanes} lanes")
                classic_sol, classic = run(f"float32_{lanes}_classic",
                                           [*wide_flags, "--no_continuous_batching"])
                loops = group_loops(classic_sol["iterations"], lanes)
                classic.update(loop_iterations=loops)
                if T % lanes == 0:
                    launched(classic, wide_plan, loops, f"fp32 classic loop, {lanes} lanes")
                same(wide_sol, classic_sol, f"fp32 at {lanes} lanes: scheduler against classic")
                entry[name] = dict(wide, plan=wide_plan, lanes=lanes, classic=classic)
        if storage == "int8":
            four_plan = plan_sweep(P, V, FOUR_LANES, storage)
            _, four = run("int8_four", ["--rtm_dtype", storage, "--no_guess",
                                        "--batch_frames", str(FOUR_LANES)])
            launched(four, four_plan, four["loop_steps"], "int8 scheduler, 4 lanes")
            entry["four_lanes"] = dict(four, plan=four_plan, lanes=FOUR_LANES)
        if storage in ("float32", "int8"):
            one = plan_sweep(P, V, 1, storage)
            chain_sol, chain = run(f"{storage}_chain", ["--rtm_dtype", storage,
                                                         "--chain_frames", str(CHAIN_FRAMES)])
            serial_sol, serial = run(f"{storage}_serial", ["--rtm_dtype", storage,
                                                            "--chain_frames", "1"])
            same(chain_sol, serial_sol, f"{storage}: --chain_frames {CHAIN_FRAMES} against 1")
            for rec, what in ((chain, "chain"), (serial, "serial")):
                launched(rec, one, rec["frame_iterations"], f"{storage} {what} loop")
            entry["chain"] = dict(plan=one, chain_frames=CHAIN_FRAMES, chained=chain,
                                  serial=serial)
        record[storage] = entry
    return record


def _write_poisoned_images(world, outdir: str, frame: int) -> dict:
    """The world's paths with camera A's images replaced by a copy whose
    frame ``frame`` holds a NaN pixel."""
    G = world["G"].copy()  # [P, T]
    G[0, frame] = np.nan
    paths = dict(world["paths"])
    paths["img_a"] = os.path.join(outdir, "img_a_nan.h5")
    cam = world["cam"]
    _write_image(paths["img_a"], "camA", G[:cam[0] * cam[1]].T.reshape(G.shape[1], *cam),
                 world["times"])
    return paths


def variants_phase(world, outdir: str, device: str = "cuda") -> dict:
    """The solver variants through the CLI on the world, per storage, each
    run's launch counts zeroed just before it and read just after; every
    frame's status 0 or the cap and its fitted error within ``FIT_BOUND``.
    The B = 1 runs are warm-started at ``--chain_frames 1`` (each frame its
    own time), beside the same runs without a variant (``plain_linear``:
    with the Laplacian over 8 frames; ``plain_log``: over 4):

    - ``-L --relaxation_decay 0.98`` over 4 frames (``one_read``), and
      ``--no_guess --batch_frames 8`` over the 32 frames through the
      scheduler and the classic loop (equal files; fp32 ``one_read``, bf16
      and int8 ``tensor_core``), int8 also at ``--batch_frames 4``
      (``one_read``): every launch the scheduled log update's, on the run's
      plan;
    - ``--momentum nesterov``, linear and log;
    - ``--divergence_recovery 2``, linear: equal, byte for byte, to
      ``plain_linear``; on a copy of the world whose frame 3 has a NaN pixel,
      that frame DIVERGED (-2) with a zero row and no iteration, the others
      within the bound, exit 2; log (fp32 and bf16: the guard keeps the log
      solver off the fused sweep, so no launch), int8 log refused (exit 1).
    """
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, plan_sweep, reset_launch_counts

    p = world["paths"]
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    nan_frame = 3
    nan_paths = _write_poisoned_images(world, outdir, nan_frame)
    nan_inputs = inputs[:3] + [nan_paths["img_a"], p["img_b"]]
    P, V = world["H"].shape
    T = world["G"].shape[1]
    on_card = device == "cuda"
    serial = ["--chain_frames", "1"]
    lin = ["-l", p["laplacian"], "-t", "0:0.75", *serial]  # 8 frames
    log = ["-L", "-t", "0:0.35", *serial]  # 4 frames

    def run(name, flags, n_frames, files=None, expect=0):
        out = os.path.join(outdir, f"variant_{name}.h5")
        reset_launch_counts()
        t0 = time.perf_counter()
        rc, ms, text = run_cli(["-o", out, *(files or inputs), "-m", str(MAX_ITERATIONS),
                                *flags], device=device)
        wall = time.perf_counter() - t0
        rec = dict(wall_s=wall, launches_by_plan=dict(fused_sweep.launches_by_plan),
                   scheduled_by_plan=dict(fused_sweep.scheduled_by_plan))
        if rc != expect or (expect != 1 and len(ms) != n_frames):
            raise AssertionError(f"variant {name}: exit {rc} (want {expect}), {len(ms)} of "
                                 f"{n_frames} frames")
        if expect == 1:
            return None, rec
        rec["cli_ms_per_frame"] = statistics.mean(ms)
        if n_frames <= 8:
            rec["frame_ms"] = ms
        m = re.search(r"continuous batching: lanes=\d+ strides=(\d+) loop_steps=(\d+) ", text)
        if m:
            rec.update(strides=int(m[1]), loop_steps=int(m[2]))
        return out, rec

    def checked(name, flags, n_frames, files=None, expect=0, skip=()):
        out, rec = run(name, flags, n_frames, files, expect)
        sol, err = check_solution(out, world, n_frames, MAX_ITERATIONS, device, skip=skip)
        its = sol["iterations"]
        rec.update(iterations=its.tolist() if n_frames <= 8 else int(its.sum()),
                   status=sol["status"].tolist() if n_frames <= 8 else None,
                   fit_err_max=float(err.max()))
        if n_frames <= 8 and its[0] > 0:  # the guess frame's ms per iteration
            rec["guess_ms_per_iteration"] = rec["frame_ms"][0] / int(its[0])
        return sol, rec

    def on_plan(rec, plan, count, scheduled, what):
        want = dict.fromkeys(rec["launches_by_plan"], 0)
        want[plan] = count
        got = rec["scheduled_by_plan"] if scheduled else rec["launches_by_plan"]
        if on_card and (rec["launches_by_plan"] != want or got != want):
            raise AssertionError(f"{what}: {rec['launches_by_plan']} launches "
                                 f"({rec['scheduled_by_plan']} scheduled), {count} on "
                                 f"{plan} expected")

    def same(a, b, what):
        for key in ("value", "status", "iterations"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"{what}: solution/{key} differ")

    record = {}
    for storage in STORAGES:
        st = ["--rtm_dtype", storage]
        decay = ["-L", "--relaxation_decay", "0.98"]
        one = plan_sweep(P, V, 1, storage)
        entry = {}
        plain_lin, entry["plain_linear"] = checked(f"{storage}_plain_linear", [*st, *lin], 8)
        _, entry["plain_log"] = checked(f"{storage}_plain_log", [*st, *log], 4)
        # the scheduled log update: warm started (B = 1) ...
        sol, rec = checked(f"{storage}_decay_serial", [*st, *log, "--relaxation_decay", "0.98"],
                           4)
        on_plan(rec, one, int(sol["iterations"].sum()), True, f"{storage} decay, B = 1")
        entry["decay_serial"] = rec
        # ... and the batch loops (B = 8): scheduler and classic, equal files
        batch = [*st, *decay, "--no_guess", "--batch_frames", str(FRAME_LANES)]
        plan8 = plan_sweep(P, V, FRAME_LANES, storage)
        sched_sol, sched = checked(f"{storage}_decay_sched", batch, T)
        on_plan(sched, plan8, sched["loop_steps"], True, f"{storage} decay scheduler")
        classic_sol, classic = checked(f"{storage}_decay_classic",
                                       [*batch, "--no_continuous_batching"], T)
        loops = group_loops(classic_sol["iterations"], FRAME_LANES)
        on_plan(classic, plan8, loops, True, f"{storage} decay classic loop")
        same(sched_sol, classic_sol, f"{storage} decay: scheduler against classic loop")
        entry.update(decay_scheduled=dict(sched, plan=plan8),
                     decay_classic=dict(classic, plan=plan8, loop_iterations=loops))
        if storage == "int8":
            plan4 = plan_sweep(P, V, FOUR_LANES, storage)
            _, rec = checked("int8_decay_four", [*st, *decay, "--no_guess", "--batch_frames",
                                                 str(FOUR_LANES)], T)
            on_plan(rec, plan4, rec["loop_steps"], True, "int8 decay scheduler, 4 lanes")
            entry["decay_four_lanes"] = dict(rec, plan=plan4)
        # momentum, linear and log (B = 1)
        for mode, flags, n in (("linear", lin, 8), ("log", log, 4)):
            sol, rec = checked(f"{storage}_momentum_{mode}",
                               [*st, "--momentum", "nesterov", *flags], n)
            on_plan(rec, one, int(sol["iterations"].sum()), False, f"{storage} momentum {mode}")
            entry[f"momentum_{mode}"] = rec
        # the guard, linear: the unguarded run's file; a NaN frame DIVERGED
        guard = [*st, "--divergence_recovery", "2", *lin]
        sol, rec = checked(f"{storage}_guard", guard, 8)
        same(sol, plain_lin, f"{storage}: the armed guard against no guard")
        on_plan(rec, one, int(sol["iterations"].sum()), False, f"{storage} guard")
        entry["guard_linear"] = dict(rec, byte_equal_to_unguarded=True)
        bad, rec = checked(f"{storage}_guard_nan", guard, 8, files=nan_inputs, expect=2,
                           skip=(nan_frame,))
        if (bad["status"][nan_frame] != -2 or bad["iterations"][nan_frame] != 0
                or bad["value"][nan_frame].any()):
            raise AssertionError(f"{storage} NaN frame: statuses {bad['status']}, "
                                 f"iterations {bad['iterations']}")
        entry["guard_nan_frame"] = rec
        guard_log = [*st, "--divergence_recovery", "2", *log]
        if storage == "int8":
            run("int8_guard_log", guard_log, 4, expect=1)
            entry["guard_log"] = "refused (exit 1): int8 needs the fused sweep"
        else:
            _, rec = checked(f"{storage}_guard_log", guard_log, 4)
            if on_card and any(rec["launches_by_plan"].values()):
                raise AssertionError(f"{storage} log guard launched the fused sweep")
            entry["guard_log"] = rec
        record[storage] = entry
    return record


def tall_world_phase(outdir: str, device: str = "cuda", **world_kw) -> dict:
    """The tall world through the CLI per storage: 2 cameras of ``TALL_CAM``
    on the e2e grid (P = 16384, past one_read's P, so every storage runs
    two_read), linear with the Laplacian over ``TALL_FRAMES`` frames at
    ``--chain_frames 1``; every status 0 or the cap, fitted errors within
    ``FIT_BOUND``, and on the card every launch on ``plan_sweep``'s plan for
    the shape (two_read), one per iteration, counted from 0 just before the
    run. ``world_kw`` sizes the world down for the CPU tests."""
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, plan_sweep, reset_launch_counts

    world = write_world(outdir, **{"cam": TALL_CAM, **world_kw})
    p = world["paths"]
    P, V = world["H"].shape
    on_card = device == "cuda"
    record = dict(shape=[P, V], frames=TALL_FRAMES)
    for storage in STORAGES:
        plan = plan_sweep(P, V, 1, storage)
        if on_card and plan != "two_read":
            raise AssertionError(f"tall world {storage}: plan {plan}, two_read expected")
        out = os.path.join(outdir, f"tall_{storage}.h5")
        if on_card:
            import torch

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
        reset_launch_counts()
        t0 = time.perf_counter()
        rc, ms, _ = run_cli(["-o", out, p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"],
                             p["img_b"], "-m", str(MAX_ITERATIONS), "-l", p["laplacian"],
                             "-t", f"0:{0.1 * TALL_FRAMES - 0.05:.2f}", "--chain_frames", "1",
                             "--rtm_dtype", storage], device=device)
        wall = time.perf_counter() - t0
        by_plan = dict(fused_sweep.launches_by_plan)
        if rc != 0 or len(ms) != TALL_FRAMES:
            raise AssertionError(f"tall world {storage}: exit {rc}, {len(ms)} frames")
        sol, err = check_solution(out, world, TALL_FRAMES, MAX_ITERATIONS, device)
        its = int(sol["iterations"].sum())
        want = dict.fromkeys(by_plan, 0)
        want[plan] = its
        if on_card and by_plan != want:
            raise AssertionError(f"tall world {storage}: {by_plan} launches for {its} iterations")
        rec = dict(plan=plan, wall_s=wall, frame_ms=ms, ms_per_frame=statistics.mean(ms),
                   warm_ms_per_frame=statistics.mean(ms[1:]), iterations=sol["iterations"].tolist(),
                   status=sol["status"].tolist(), fit_err=err.tolist(), launches_by_plan=by_plan)
        if on_card:
            rec["peak_device_bytes"] = torch.cuda.max_memory_allocated() - mem0
        # the same run with --integrity: the ABFT check on two_read's output
        # trips nothing and changes no byte of the file
        rec["integrity"] = integrity_pair(
            out, ["-o", out, p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"],
                  p["img_b"], "-m", str(MAX_ITERATIONS), "-l", p["laplacian"],
                  "-t", f"0:{0.1 * TALL_FRAMES - 0.05:.2f}", "--chain_frames", "1",
                  "--rtm_dtype", storage], plan, device, plain_ms=ms)
        record[storage] = rec
    return record


OS_SUBSETS = 4  # the os phase's --os_subsets
# the os phase's runs: linear with the Laplacian, and the log solver with
# momentum (the JAX package's headline OS configuration)
OS_MODES = (("linear", lambda p: ["-l", p["laplacian"]]),
            ("log_momentum", lambda p: ["-L", "--momentum", "nesterov"]))
# the OS cycle's profiler ranges (models/sart.py:_span)
OS_RANGES = ("os_subset_forward", "os_subset_back", "os_full_forward")


def os_phase(world, outdir: str, device: str = "cuda") -> dict:
    """Ordered subsets through the CLI on the world, per storage, at
    ``--os_subsets OS_SUBSETS`` beside the fused path at the same flags:
    linear with the Laplacian and log with Nesterov momentum, each warm
    started over 4 frames at ``--chain_frames 1`` (the fused run first,
    then the OS run) and through ``--no_guess --batch_frames FRAME_LANES``
    (OS in the scheduler and the classic loop, equal files byte for byte;
    the fused path in the scheduler). Every frame's status 0 or the cap and
    its fitted error within ``FIT_BOUND``; on the card no fused-sweep launch
    in an OS run (counts zeroed just before, read just after) and each
    run's peak device bytes beside the stored matrix's."""
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, reset_launch_counts

    p = world["paths"]
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    P, V = world["H"].shape
    T = world["G"].shape[1]
    on_card = device == "cuda"
    if on_card:
        import torch
    os_flags = ["--os_subsets", str(OS_SUBSETS)]
    stored_bytes = {"float32": 4 * P * V, "bfloat16": 2 * P * V, "int8": P * V + 4 * V}

    def run(name, flags, n_frames, os_on):
        out = os.path.join(outdir, f"os_{name}.h5")
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
        reset_launch_counts()
        t0 = time.perf_counter()
        rc, ms, text = run_cli(["-o", out, *inputs, "-m", str(MAX_ITERATIONS),
                                *(os_flags if os_on else []), *flags], device=device)
        rec = dict(wall_s=time.perf_counter() - t0, fused_sweep_launches=fused_sweep.launches)
        if on_card:  # the run's own peak, before the check uploads H
            rec["peak_device_bytes"] = torch.cuda.max_memory_allocated() - mem0
        if rc != 0 or len(ms) != n_frames:
            raise AssertionError(f"os {name}: exit {rc}, {len(ms)} of {n_frames} frames")
        if os_on and "sweep=os-subset" not in text:
            raise AssertionError(f"os {name}: the run's header names no subset cycle")
        if os_on and on_card and fused_sweep.launches:
            raise AssertionError(f"os {name}: {dict(fused_sweep.launches_by_plan)} fused-sweep "
                                 "launches in an OS run")
        sol, err = check_solution(out, world, n_frames, MAX_ITERATIONS, device)
        rec.update(cli_ms_per_frame=statistics.mean(ms), fit_err_max=float(err.max()))
        if n_frames <= 8:
            rec.update(frame_ms=ms, iterations=sol["iterations"].tolist(),
                       status=sol["status"].tolist())
        else:
            rec["frame_iterations"] = int(sol["iterations"].sum())
        m = re.search(r"continuous batching: lanes=\d+ strides=(\d+) loop_steps=(\d+) ", text)
        if m:
            rec.update(strides=int(m[1]), loop_steps=int(m[2]))
        return sol, rec

    record = {"os_subsets": OS_SUBSETS}
    for storage in STORAGES:
        st = ["--rtm_dtype", storage]
        entry = {"stored_matrix_bytes": stored_bytes[storage]}
        for mode, mode_flags in OS_MODES:
            chain_flags = [*st, *mode_flags(p), "-t", "0:0.35", "--chain_frames", "1"]
            _, fused_chain = run(f"{storage}_{mode}_fused_chain", chain_flags, 4, False)
            _, chain = run(f"{storage}_{mode}_chain", chain_flags, 4, True)
            chain.update(
                guess_frame_ms_over_fused=chain["frame_ms"][0] / fused_chain["frame_ms"][0],
                warm_ms_per_frame_over_fused=(statistics.mean(chain["frame_ms"][1:])
                                              / statistics.mean(fused_chain["frame_ms"][1:])))
            batch = [*st, *mode_flags(p), "--no_guess", "--batch_frames", str(FRAME_LANES)]
            sched_sol, sched = run(f"{storage}_{mode}_sched", batch, T, True)
            classic_sol, classic = run(f"{storage}_{mode}_classic",
                                       [*batch, "--no_continuous_batching"], T, True)
            for key in ("value", "status", "iterations"):
                if not np.array_equal(sched_sol[key], classic_sol[key]):
                    raise AssertionError(f"os {storage} {mode}: scheduler and classic loop "
                                         f"differ in solution/{key}")
            classic["loop_iterations"] = group_loops(classic_sol["iterations"], FRAME_LANES)
            _, fused_sched = run(f"{storage}_{mode}_fused_sched", batch, T, False)
            sched["ms_per_frame_over_fused"] = (sched["cli_ms_per_frame"]
                                                / fused_sched["cli_ms_per_frame"])
            entry[mode] = dict(chain=chain, fused_chain=fused_chain, scheduled=sched,
                               classic=classic, fused_scheduled=fused_sched)
        record[storage] = entry
    return record


def debug_nans_phase(world, outdir: str, device: str = "cuda") -> dict:
    """``--debug_nans`` on the world, fp32: on a copy whose frame 3 has a NaN
    pixel the warm-started chain exits 0 (the masks leave the pixel out of
    the solve, as the JAX CLI's run shows) and the scheduler raises
    ``FloatingPointError`` (its lanes keep their measurements, as the JAX
    scheduler's do); on the healthy world the flag changes no byte of the
    scheduler's file or of an OS chain's, beside each run's ms per frame
    with and without it."""
    p = world["paths"]
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    nan_paths = _write_poisoned_images(world, outdir, 3)
    nan_inputs = inputs[:3] + [nan_paths["img_a"], p["img_b"]]
    T = world["G"].shape[1]
    base = ["-m", str(MAX_ITERATIONS), "-l", p["laplacian"]]
    sched = ["--no_guess", "--batch_frames", str(FRAME_LANES)]
    record = {}
    rc, ms, _ = run_cli(["-o", os.path.join(outdir, "dn_nan_chain.h5"), *nan_inputs, *base,
                         "-t", "0:0.35", "--chain_frames", "1", "--debug_nans"], device=device)
    if rc != 0 or len(ms) != 4:
        raise AssertionError(f"debug_nans, NaN pixel, chain: exit {rc}, {len(ms)} frames")
    record["nan_pixel_chain"] = "exit 0"
    try:
        run_cli(["-o", os.path.join(outdir, "dn_nan_sched.h5"), *nan_inputs, *base, *sched,
                 "--debug_nans"], device=device)
    except FloatingPointError as err:
        record["nan_pixel_scheduler"] = f"FloatingPointError: {err}"
    else:
        raise AssertionError("debug_nans, NaN pixel, scheduler: no FloatingPointError")
    for name, flags, n_frames in (
            ("scheduler", sched, T),
            ("os_chain", ["--os_subsets", str(OS_SUBSETS), "-t", "0:0.35", "--chain_frames", "1"],
             4)):
        sols, timing = [], {}
        for extra in ([], ["--debug_nans"]):
            out = os.path.join(outdir, f"dn_{name}{len(extra)}.h5")
            rc, ms, _ = run_cli(["-o", out, *inputs, *base, *flags, *extra], device=device)
            if rc != 0 or len(ms) != n_frames:
                raise AssertionError(f"debug_nans {name}: exit {rc}, {len(ms)} frames")
            sol, _ = check_solution(out, world, n_frames, MAX_ITERATIONS, device)
            sols.append(sol)
            timing["with_flag" if extra else "without"] = statistics.mean(ms)
        for key in sols[0]:
            if not np.array_equal(sols[0][key], sols[1][key]):
                raise AssertionError(f"debug_nans {name}: solution/{key} differs with the flag")
        record[name] = dict(byte_equal=True, cli_ms_per_frame=timing)
    return record


# the fused entries' extra cases on the card: (entry, storage, B), each
# where it changes the plan (bf16 and int8 at B = 8: tensor_core; fp32 at
# B = 16: two_read); every other single-rank entry runs fp32 at B = 1
AUDIT_CASES = (("fused_sweep", "bfloat16", 1), ("fused_sweep", "bfloat16", 8),
               ("fused_sweep", "float32", 16), ("int8_fused_sweep", "int8", 8))
AUDIT_BUDGET_S = 60.0


def _audit_line(rep, **extra) -> dict:
    """One entry's record: its status and per-iteration counts."""
    it = rep.per_iteration
    keys = ("launches", "launches_by_plan", "cuda_kernels", "host_syncs", "matrix_copies",
            "matrix_converts", "f64_max_elems", "collectives", "aten_ops",
            "elements_converted", "ops_inside_launches", "syncs_inside_collectives")
    return dict(entry=rep.name, status=rep.status, detail=rep.detail,
                violations=rep.violations, shape=rep.shape,
                **{k: it[k] for k in keys if k in it}, **extra)


def audit_phase(world, device: str = "cuda", geometry=None) -> dict:
    """Phase ``audit`` (module docstring): every single-rank entry of the
    launch audit on the world's matrix, the fused entries at each case of
    ``AUDIT_CASES`` too, each emitted as one line; the refused entries by
    their words. An entry that is not ``ok`` or ``refused``, a fused entry
    whose launches are not the plan ``plan_sweep`` gives its shape, or a
    phase over ``AUDIT_BUDGET_S`` on the card fails the run."""
    from sartsolver_tpu_torch.analysis import audit, registry
    from sartsolver_tpu_torch.ops.fused_sweep import plan_sweep

    t0 = time.perf_counter()
    reg = registry.load_registered_entries()
    card = device == "cuda"
    cases = [(n, "int8" if n == "int8_fused_sweep" else "float32", 1) for n in sorted(reg)
             if reg[n].min_ranks == 1] + list(AUDIT_CASES)
    ctx = audit.AuditContext(device, world["H"],
                             geometry=geometry if geometry is not None else geometry_record())
    lines, bad = [], []
    try:
        for name, storage, B in cases:
            ctx.B, ctx.storage = B, storage
            t1 = time.perf_counter()
            rep = audit.run_entry(reg[name], ctx, profile=card)
            line = _audit_line(rep, storage=storage, seconds=time.perf_counter() - t1)
            if card and rep.status == "ok" and set(rep.per_iteration["launches"]) == {
                    "fused_sweep"}:
                P, V = world["H"].shape
                plan = plan_sweep(P, V // 2 if name == "sparse_panel_sweep" else V, B, storage)
                by_plan = {k: n for k, n in rep.per_iteration["launches_by_plan"].items() if n}
                if by_plan != {f"fused_sweep:{plan}": 1}:
                    rep.violations.append(f"launches by plan {by_plan}, {plan} expected")
                    line.update(status="violation", violations=rep.violations)
            emit("audit", **line)
            lines.append(line)
            if line["status"] != "ok":
                bad.append(line)
    finally:
        ctx.close()
        del ctx
        gc.collect()
        if card:
            import torch

            torch.cuda.empty_cache()
    refused = [_audit_line(audit.run_entry(reg[n], None)) for n in sorted(reg)
               if reg[n].refusal is not None]
    seconds = time.perf_counter() - t0
    if bad or any(r["status"] != "refused" for r in refused):
        raise AssertionError(f"launch audit: {bad or refused}")
    if card and seconds > AUDIT_BUDGET_S:
        raise AssertionError(f"launch audit took {seconds:.1f} s (budget {AUDIT_BUDGET_S} s)")
    return dict(seconds=seconds, budget_s=AUDIT_BUDGET_S, entries=len(lines),
                refused={r["entry"]: r["detail"] for r in refused},
                grid_entries="phase grid (2x1 group)")


OBS_LOOPS = (("chain", ["-t", "0:0.75"], 8),  # (name, flags, frames) of the obs phase
             ("scheduler", ["--no_guess", "--batch_frames", str(FRAME_LANES)], None))
OBS_PHASES = (("validate_ms", "validate + index inputs"),
              ("ingest_upload_ms", "ingest RTM + upload"),
              ("frame_loop_ms", "frame loop (solve + prefetch + flush)"),
              ("voxel_map_ms", "write voxel map"))
# the fused sweep's kernel of one_read, one per call
ONE_READ_KERNEL = "sweep_kernel<"


# ---- resilience: --resume, the kill drills, SIGTERM, the watchdog, integrity ----

# the rows after a resume's cut against the uninterrupted run's, in fitted
# space (ROADMAP §C items 2-4: the fp32 stall crossing moves with a warm
# start's path)
RESUME_FIT_TOL = 5e-3
# the flush timing: rows a flush appends, and the rows already in the file
# at the flushes timed; the voxel map's write after these many rows
FLUSH_ROWS = 100
FLUSH_AT = (100, 400, 1600)
VOXEL_MAP_AT = (8, 32, 1600)
RESILIENCE_TIMEOUT = 300  # seconds, each subprocess of the drills
INTEGRITY_TURNS = 1  # runs with --integrity on, and as many off, in turns
REAUDIT_EVERY = 2  # SART_INTEGRITY_REAUDIT of the JAX recipe's CLI run


def _read_rows(path):
    from sartsolver_tpu_torch.io import h5

    with h5.File(path, "r") as f:
        out = {k: f["solution"][k][:] for k in f["solution"]}
        out["completed"] = int(f["solution"].attrs["completed"])
    return out


def _fitted_distance(world, a, b, device):
    """Per row ``||H (a - b)|| / ||H b||``."""
    import torch

    H = torch.as_tensor(world["H"], device=device)
    fa = H @ torch.as_tensor(a.T, dtype=torch.float32, device=device)
    fb = H @ torch.as_tensor(b.T, dtype=torch.float32, device=device)
    return ((fa - fb).norm(dim=0) / fb.norm(dim=0).clamp_min(1e-30)).cpu().numpy()


def check_resumed(path, ref_path, world, cut, device, what):
    """A resumed file against the uninterrupted run's: complete, every
    row's checksum its own, the rows before ``cut`` the same bytes, the
    rest the same statuses and within ``RESUME_FIT_TOL`` in fitted space."""
    from sartsolver_tpu_torch.io.solution import row_checksum

    got, want = _read_rows(path), _read_rows(ref_path)
    n = len(want["time"])
    if got["completed"] != n or any(got[k].shape[0] != n for k in want if k != "completed"):
        raise AssertionError(f"{what}: {got['completed']} of {n} rows")
    if [int(c) for c in got["checksum"]] != [int(row_checksum(r)) for r in got["value"]]:
        raise AssertionError(f"{what}: a row fails its checksum")
    for key in ("value", "status", "iterations"):
        if not np.array_equal(got[key][:cut], want[key][:cut]):
            raise AssertionError(f"{what}: rows before the cut differ in {key}")
    # a frame's time is taken from the -t window's grid: an ulp apart
    if not np.allclose(got["time"], want["time"], rtol=1e-12, atol=0):
        raise AssertionError(f"{what}: times {got['time']} against {want['time']}")
    if not np.array_equal(got["status"], want["status"]):
        raise AssertionError(f"{what}: statuses {got['status']} against {want['status']}")
    dist = _fitted_distance(world, got["value"][cut:], want["value"][cut:], device)
    if not (dist <= RESUME_FIT_TOL).all():
        raise AssertionError(f"{what}: fitted distance {dist} above {RESUME_FIT_TOL}")
    return dict(rows=n, cut=cut, rows_after_cut_bytes_equal=bool(
                    np.array_equal(got["value"][cut:], want["value"][cut:])),
                iterations_after_cut=got["iterations"][cut:].tolist(),
                reference_iterations_after_cut=want["iterations"][cut:].tolist(),
                fitted_distance_after_cut_max=float(dist.max()) if dist.size else 0.0)


def integrity_pair(plain_out, argv, plan, device, plain_ms):
    """``argv`` (the run that wrote ``plain_out``) again with
    ``--integrity`` into a file beside it: exit 0, no trip, the same bytes;
    on the card every launch on ``plan``. Returns ms per frame on and off,
    the largest residual over its band, the launches."""
    from sartsolver_tpu_torch.models.sart import abft_worst_ratio, record_abft_worst
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, reset_launch_counts

    out = plain_out + ".integrity.h5"
    argv = list(argv)
    argv[argv.index("-o") + 1] = out
    reset_launch_counts()
    record_abft_worst(True)
    try:
        rc, ms, text = run_cli([*argv, "--integrity"], device=device)
    finally:
        record_abft_worst(False)
    ratio = abft_worst_ratio()
    by_plan = dict(fused_sweep.launches_by_plan)
    if rc != 0 or len(ms) != len(plain_ms) or "SDC" in text:
        raise AssertionError(f"--integrity run {out}: exit {rc}, {len(ms)} frames")
    with open(plain_out, "rb") as a, open(out, "rb") as b:
        if a.read() != b.read():
            raise AssertionError(f"--integrity run {out}: not the same bytes as without")
    if not 0 <= ratio < 1:
        raise AssertionError(f"--integrity run {out}: largest residual / band {ratio}")
    if device == "cuda" and (by_plan.get(plan, 0) <= 0
                             or any(n for k, n in by_plan.items() if k != plan)):
        raise AssertionError(f"--integrity run {out}: launches {by_plan}, on {plan} expected")
    return dict(byte_equal=True, worst_residual_over_band=ratio, launches_by_plan=by_plan,
                ms_per_frame_on=statistics.mean(ms), ms_per_frame_off=statistics.mean(plain_ms))


def _signal_run(argv, env, steps):
    """The CLI in a subprocess; ``steps`` is a list of (marker, occurrence,
    signal): at the ``occurrence``-th ``SART_FLUSH_POINT marker`` line send
    the signal. Returns (exit code, stderr after the last step, seconds)."""
    import signal as _signal
    import threading

    cmd = [sys.executable, "-m", "sartsolver_tpu_torch.cli", *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    timer = threading.Timer(RESILIENCE_TIMEOUT, proc.kill)
    timer.start()
    try:
        seen, pending = {}, list(steps)
        for line in proc.stderr:
            if not pending:
                break
            marker, occurrence, sig = pending[0]
            if line.strip() == f"SART_FLUSH_POINT {marker}":
                seen[marker] = seen.get(marker, 0) + 1
                if seen[marker] >= occurrence:
                    proc.send_signal(sig)
                    pending.pop(0)
                    if sig == _signal.SIGKILL:
                        break
        if pending:
            raise AssertionError(f"{argv}: the run ended before {pending[0][:2]}")
        rest = proc.stderr.read()
        proc.wait(timeout=RESILIENCE_TIMEOUT)
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
    return proc.returncode, rest, time.perf_counter() - t0


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for an in-process CLI run (and the fault
    registry's reading of SART_FAULT), then restore them."""
    from sartsolver_tpu_torch.resilience import faults

    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    faults.reset()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset()


def flush_timing(outdir: str, world, rows: int = FLUSH_ROWS, flush_at=FLUSH_AT,
                 voxel_map_at=VOXEL_MAP_AT) -> dict:
    """The solution writer's flush timed alone at the world's V: appends of
    ``rows`` rows in place, each timed, until the file holds the largest of
    ``flush_at`` plus ``rows``; the voxel map's write into files of
    ``voxel_map_at`` rows (the largest: the growing file itself)."""
    from sartsolver_tpu_torch.io.solution import SolutionWriter
    from sartsolver_tpu_torch.io.voxelgrid import make_voxel_grid

    V = world["H"].shape[1]
    grid = make_voxel_grid([world["paths"]["rtm_b"]], "rtm/voxel_map")
    block = np.random.default_rng(11).random((rows, V))

    def fill(writer, n, t0):
        for i in range(n):
            t = float(t0 + i)
            writer.add(block[i % rows], 0, t, [t, t], iterations=1)

    voxel_map = {}
    for n in voxel_map_at[:-1]:
        path = os.path.join(outdir, f"flush_{n}.h5")
        with SolutionWriter(path, ["camA", "camB"], V, max_cache_size=10**9) as w:
            fill(w, n, 0)
        t0 = time.perf_counter()
        grid.write_hdf5(path, "voxel_map")
        voxel_map[str(n)] = (time.perf_counter() - t0) * 1e3
        os.remove(path)
    path = os.path.join(outdir, "flush_series.h5")
    flush_ms = {}
    w = SolutionWriter(path, ["camA", "camB"], V, max_cache_size=10**9)
    T = 0
    while T <= max(flush_at):
        if T == voxel_map_at[-1]:
            t0 = time.perf_counter()
            grid.write_hdf5(path, "voxel_map")
            voxel_map[str(T)] = (time.perf_counter() - t0) * 1e3
        fill(w, rows, T)
        t0 = time.perf_counter()
        w.flush()
        dt = (time.perf_counter() - t0) * 1e3
        if T in flush_at or T == 0:
            flush_ms[str(T)] = dt
        T += rows
    size = os.path.getsize(path)
    got = _read_rows(path)
    if got["completed"] != T or got["value"].shape != (T, V):
        raise AssertionError(f"flush series: {got['completed']} rows, {T} written")
    os.remove(path)
    lo, hi = flush_ms[str(min(flush_at))], flush_ms[str(max(flush_at))]
    return dict(rows_per_flush=rows, nvoxel=V, flush_ms_at_rows=flush_ms,
                flush_ratio_last_to_first=hi / lo, voxel_map_ms_at_rows=voxel_map,
                file_bytes=size, rows_written=T)


def host_ingest_sums(files, P: int, V: int, stored) -> dict:
    """The ingest's ray-stat sums on the host instead of the card, timed:
    the fp32 row chunks read as the ingest reads them, and
    ``IngestStats.add`` on the numpy rows; held against the column and row
    sums of ``stored`` (the matrix on the device)."""
    import torch

    from sartsolver_tpu_torch.io.raytransfer import read_rtm_block
    from sartsolver_tpu_torch.parallel.multihost import default_chunk_rows
    from sartsolver_tpu_torch.resilience import integrity

    chunk = min(default_chunk_rows(V), P)
    stats = integrity.IngestStats(P, V)
    read_s = 0.0
    t0 = time.perf_counter()
    for r0 in range(0, P, chunk):
        n = min(chunk, P - r0)
        t1 = time.perf_counter()
        rows = read_rtm_block(files, "with_reflections", n, V, r0, dtype=np.float32)
        read_s += time.perf_counter() - t1
        stats.add(integrity.storage_round(rows, "float32"), r0, 0)
    secs = time.perf_counter() - t0
    issues = integrity.verify_ray_stats(
        stats, stored.sum(dim=0, dtype=torch.float32).cpu().numpy(),
        stored.sum(dim=1, dtype=torch.float32).cpu().numpy())
    if issues:
        raise AssertionError(f"ingest stats on the host: {issues}")
    return dict(seconds=secs, read_seconds=read_s, sums_seconds=secs - read_s)


def jax_recipe_drill(world, outdir: str, device: str, cli, frames: str) -> dict:
    """The JAX package's ``device.buffer`` recipe, ``x * 256 + 1`` on element
    [0, 0] of the fp32 matrix (the port flips an exponent bit instead), on
    the card. The forward check sees a change ``d`` of element [i, j] where
    ``d * f_j > tol * (|rho . f| + 1)``: from a clean solve of frame 0 (its
    normalized iterate ``f``), the smallest such ``d`` for element [0, 0]
    and for the most sensitive column, beside the recipe's ``d``. Then the
    recipe through the solver (the largest residual over its band the
    check met, the status, the re-audit) and through the CLI with
    ``SART_INTEGRITY_REAUDIT`` at REAUDIT_EVERY: the re-audit quarantines
    (exit 3)."""
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.models.sart import abft_worst_ratio, record_abft_worst
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
    from sartsolver_tpu_torch.resilience import faults, integrity

    H = world["H"]
    P, V = H.shape
    g0 = world["G"][:, :1].T.astype(np.float64)

    def jax_recipe(self):
        if faults.take_corrupt(faults.SITE_DEVICE_BUFFER):
            rtm = self._live_problem().rtm
            rtm[0, 0] = rtm[0, 0] * 256 + 1

    opts = SolverOptions(max_iterations=MAX_ITERATIONS, integrity=True)
    tol = integrity.abft_tolerance(opts.dtype, "float32", P, V)
    original = DistributedSARTSolver._maybe_corrupt_resident
    DistributedSARTSolver._maybe_corrupt_resident = jax_recipe
    try:
        with DistributedSARTSolver(H, opts=opts, device=device) as solver:
            f = solver.solve_batch(g0).solution_norm[0].double().cpu().numpy()
            band = tol * (abs(float(H.sum(axis=0, dtype=np.float64) @ f)) + 1.0)
            h00 = float(solver._live_problem().rtm[0, 0])
            record_abft_worst(True)
            faults.inject(faults.SITE_DEVICE_BUFFER, "corrupt", count=1)
            try:
                res = solver.solve_batch(g0)
            finally:
                faults.clear_faults()
                record_abft_worst(False)
            api = dict(status=int(res.status[0]), iterations=int(res.iterations[0]),
                       worst_residual_over_band=abft_worst_ratio(),
                       reaudit=solver.reaudit_ray_stats())
        if not api["reaudit"]:
            raise AssertionError(f"the JAX recipe: the re-audit saw nothing, {api}")
        out = os.path.join(outdir, "corrupt_jax_recipe.h5")
        with _env(SART_FAULT="device.buffer:corrupt:1:1", SART_INTEGRITY_REAUDIT=REAUDIT_EVERY):
            with contextlib.redirect_stderr(io.StringIO()) as err:
                rc, ms, text, _ = cli(out, "-t", frames, "--chain_frames", "1", "--integrity")
    finally:
        DistributedSARTSolver._maybe_corrupt_resident = original
    if rc != 3 or "Quarantined" not in err.getvalue():
        raise AssertionError(f"the JAX recipe through the CLI: exit {rc}\n"
                             f"{err.getvalue()[-2000:]}")
    fmax = float(f.max())
    return dict(
        element_change=h00 * 255 + 1, element=h00, band=band, abft_tolerance=tol,
        smallest_change_seen_at_0_0=band / f[0] if f[0] > 0 else None,
        smallest_change_seen_any_element=band / fmax if fmax > 0 else None,
        solver_api=api, cli_exit=rc, cli_frames_written=len(ms),
        cli_quarantined_by=("resident re-audit" if "resident re-audit" in err.getvalue()
                            else "ABFT check"), reaudit_every=REAUDIT_EVERY)


def resilience_phase(world, outdir: str, device: str = "cuda",
                     flush_kw: Optional[dict] = None, turns: int = INTEGRITY_TURNS) -> dict:
    """The resilience of a run on the world (:func:`flush_timing` for the
    flush alone). Per storage, ``--resume`` after a half run (``-t``) for
    the chain (linear with the Laplacian over 8 frames at ``--chain_frames
    1``) and for the scheduler (``--no_guess --batch_frames 8`` over all the
    frames), held by :func:`check_resumed`; each uninterrupted run again
    with ``--integrity`` (:func:`integrity_pair`: ``one_read`` at B = 1,
    ``tensor_core`` at bf16 and int8 B = 8, ``one_read`` fp32 B = 8), and
    fp32 at ``--batch_frames 16`` (``two_read``). Then on the fp32 chain,
    one flush a frame, the subprocesses at once with
    :func:`solve_ckpt_kill`'s: SIGKILL inside ``torn`` and ``pre-counter``
    and a ``--resume``; SIGUSR1 then SIGTERM (exit 4; ``top --once``
    renders the snapshot), and a ``--resume``; the hang watchdog
    (``SART_WATCHDOG_TIMEOUT=2``, ``solve.dispatch:hang:1:1``): a FAILED row
    and exit 2, exit 3 and a crash bundle under ``--fail_fast``. Then the
    resident matrix corrupted (``device.buffer:corrupt``): the check trips
    (the solver API gives the iteration), the re-audit sees it, and the CLI run
    quarantines (exit 3) after re-solving through the same plan; the JAX
    package's recipe (:func:`jax_recipe_drill`). Then the ingest with the
    integrity layer's sums on the card and off, the same sums on the host
    (:func:`host_ingest_sums`), the CLI's ``ingest RTM + upload`` with and
    without ``--integrity``, and its ms per frame in ``turns`` turns each
    way."""
    import signal as _signal

    import torch

    from sartsolver_tpu_torch.obs.cli import top_main
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, plan_sweep, reset_launch_counts
    from sartsolver_tpu_torch.parallel.multihost import read_and_shard_rtm
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.resilience import faults, integrity
    from sartsolver_tpu_torch.resilience.failures import SDC_DETECTED

    p = world["paths"]
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    base = [*inputs, "-m", str(MAX_ITERATIONS), "-l", p["laplacian"]]
    P, V = world["H"].shape
    T = world["G"].shape[1]
    chain_t, chain_half = "0:0.75", "0:0.35"  # 8 frames, cut after 4
    sched_half = f"0:{0.1 * (T // 2) - 0.05:.2f}"
    record = {}

    def cli(out, *flags):
        reset_launch_counts()
        rc, ms, text = run_cli(["-o", out, *base, *flags], device=device)
        return rc, ms, text, dict(fused_sweep.launches_by_plan)

    # --resume per storage and loop, and the uninterrupted run with --integrity
    for storage in STORAGES:
        entry = {}
        for loop, flags, n, half, cut in (
                ("chain", ["-t", chain_t, "--chain_frames", "1"], 8, chain_half, 4),
                ("scheduler", ["--no_guess", "--batch_frames", str(FRAME_LANES)], T,
                 sched_half, T // 2)):
            flags = [*flags, "--rtm_dtype", storage]
            ref = os.path.join(outdir, f"res_{storage}_{loop}_ref.h5")
            rc, ms, _, by_plan = cli(ref, *flags)
            if rc != 0 or len(ms) != n:
                raise AssertionError(f"{storage} {loop}: exit {rc}, {len(ms)} frames")
            out = os.path.join(outdir, f"res_{storage}_{loop}.h5")
            half_flags = [f if f != chain_t else half for f in flags]
            if loop == "scheduler":
                half_flags = [*flags, "-t", half]
            rc, ms_half, _, _ = cli(out, *half_flags)
            rc2, ms_res, _, _ = cli(out, *flags, "--resume")
            if rc or rc2 or len(ms_half) != cut or len(ms_res) != n - cut:
                raise AssertionError(f"{storage} {loop} resume: exits {rc}, {rc2}; "
                                     f"{len(ms_half)} + {len(ms_res)} frames")
            rec = check_resumed(out, ref, world, cut, device, f"{storage} {loop} resume")
            rec["processed_in_resume"] = len(ms_res)
            plan = plan_sweep(P, V, 1 if loop == "chain" else FRAME_LANES, storage)
            args = ["-o", ref, *base, *flags]
            rec["integrity"] = integrity_pair(ref, args, plan, device, ms)
            entry[loop] = rec
        record[storage] = entry
    sixteen = os.path.join(outdir, "res_float32_16.h5")
    flags16 = ["--no_guess", "--batch_frames", str(SIXTEEN_LANES)]
    rc, ms, _, _ = cli(sixteen, *flags16)
    if rc != 0:
        raise AssertionError(f"fp32 at {SIXTEEN_LANES} lanes: exit {rc}")
    record["float32_two_read_integrity"] = integrity_pair(
        sixteen, ["-o", sixteen, *base, *flags16], plan_sweep(P, V, SIXTEEN_LANES, "float32"),
        device, ms)

    # the drills on the fp32 chain, one flush a frame; their subprocesses
    # (and the in-solve checkpoints' killed run) all at once, each
    # followed up in turn
    drill = [*base, "-t", chain_t, "--chain_frames", "1", "--max_cached_solutions", "1",
             "--rtm_dtype", "float32", "--device", device]
    ref = os.path.join(outdir, "res_float32_chain_ref.h5")
    env = dict(os.environ, PYTHONPATH=REPO, SART_TEST_FLUSH_DELAY="0.5", SART_WRITER_QUEUE="1")
    signals = {marker: [(marker, 2, _signal.SIGKILL)] for marker in ("torn", "pre-counter")}
    signals["sigterm"] = [("torn", 1, _signal.SIGUSR1), ("torn", 2, _signal.SIGTERM)]
    outs = {name: os.path.join(outdir, "sigterm.h5" if name == "sigterm" else
                               f"kill_{name}.h5") for name in signals}
    with concurrent.futures.ThreadPoolExecutor(len(signals) + 1) as pool:
        ckpt_killed = pool.submit(solve_ckpt_kill, world, outdir, device)
        signalled = {name: pool.submit(_signal_run, ["-o", outs[name], *drill], env, steps)
                     for name, steps in signals.items()}
        signalled = {name: job.result() for name, job in signalled.items()}
        ckpt_killed = ckpt_killed.result()
    kills = {}
    for marker in ("torn", "pre-counter"):
        out = outs[marker]
        rc, _, secs = signalled[marker]
        if rc != -_signal.SIGKILL:
            raise AssertionError(f"kill at {marker}: exit {rc}")
        before = _read_rows(out)["completed"]
        rc, ms, _, _ = cli(out, "-t", chain_t, "--chain_frames", "1", "--rtm_dtype",
                           "float32", "--resume")
        if rc != 0 or before + len(ms) != 8:
            raise AssertionError(f"resume after the kill at {marker}: exit {rc}, "
                                 f"{before} + {len(ms)} rows")
        kills[marker] = dict(rows_at_kill=before, seconds=secs,
                             **check_resumed(out, ref, world, before, device,
                                             f"kill at {marker}"))
    record["kill"] = kills

    out = outs["sigterm"]
    rc, rest, secs = signalled["sigterm"]
    status_path = out + ".status.json"
    if rc != 4 or "Interrupted by SIGTERM" not in rest or not os.path.exists(status_path):
        raise AssertionError(f"SIGTERM: exit {rc}, status file {os.path.exists(status_path)}"
                             f"\n{rest[-2000:]}")
    with open(status_path) as f:
        snapshot = json.load(f)
    screen = io.StringIO()
    with contextlib.redirect_stdout(screen):
        top_rc = top_main([status_path, "--once"])
    if top_rc != 0 or "frames_done" not in screen.getvalue():
        raise AssertionError(f"top --once: exit {top_rc}\n{screen.getvalue()}")
    stopped = _read_rows(out)["completed"]
    rc, ms, _, _ = cli(out, "-t", chain_t, "--chain_frames", "1", "--rtm_dtype", "float32",
                       "--resume")
    if rc != 0 or stopped + len(ms) != 8:
        raise AssertionError(f"resume after SIGTERM: exit {rc}, {stopped} + {len(ms)} rows")
    record["sigterm"] = dict(exit=4, rows_at_stop=stopped, seconds=secs,
                             status_frames_done=snapshot["frames_done"],
                             top_lines=screen.getvalue().count("\n"),
                             **check_resumed(out, ref, world, stopped, device, "SIGTERM"))

    hang = {}
    for name, extra, want in (("isolated", [], 2), ("fail_fast", ["--fail_fast"], 3)):
        out = os.path.join(outdir, f"hang_{name}.h5")
        with _env(SART_WATCHDOG_TIMEOUT=2, SART_WATCHDOG_GRACE=60, SART_HANG_RELEASE=120,
                  SART_FAULT="solve.dispatch:hang:1:1"):
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()) as err:
                rc, ms, text, _ = cli(out, "-t", chain_half, "--chain_frames", "1", *extra)
            secs = time.perf_counter() - t0
        if rc != want:
            raise AssertionError(f"hang {name}: exit {rc}, {want} expected\n"
                                 f"{err.getvalue()[-2000:]}")
        rec = dict(exit=rc, seconds=secs)
        if name == "isolated":
            rows = _read_rows(out)
            if list(rows["status"][:1]) != [-3] or len(rows["status"]) != 4:
                raise AssertionError(f"hang isolated: statuses {rows['status']}")
            rec["status"] = rows["status"].tolist()
        else:
            with open(out + ".crash.json") as f:
                bundle = json.load(f)
            if not bundle["reason"].startswith("watchdog abort"):
                raise AssertionError(f"hang fail_fast: crash bundle {bundle['reason']}")
            rec["crash_bundle_reason"] = bundle["reason"]
            rec["crash_bundle_ring_events"] = len(bundle["ring"])
        hang[name] = rec
    record["watchdog"] = hang

    # the resident matrix corrupted: the solver API shows the iteration of
    # the trip, the CLI the recompute through the same plan and the quarantine
    opts = SolverOptions(max_iterations=MAX_ITERATIONS, integrity=True)
    with DistributedSARTSolver(world["H"], opts=opts, device=device) as solver:
        faults.inject(faults.SITE_DEVICE_BUFFER, "corrupt", count=1)
        try:
            res = solver.solve_batch(world["G"][:, :1].T.astype(np.float64))
        finally:
            faults.clear_faults()
        tripped = dict(status=int(res.status[0]), iterations=int(res.iterations[0]),
                       reaudit=solver.reaudit_ray_stats())
    if tripped["status"] != SDC_DETECTED or not tripped["reaudit"]:
        raise AssertionError(f"resident corruption: {tripped}")
    out = os.path.join(outdir, "corrupt.h5")
    with _env(SART_FAULT="device.buffer:corrupt:1:1"):
        with contextlib.redirect_stderr(io.StringIO()) as err:
            rc, ms, text, by_plan = cli(out, "-t", chain_half, "--chain_frames", "1",
                                        "--integrity")
    one = plan_sweep(P, V, 1, "float32")
    if rc != 3 or "Quarantined" not in err.getvalue() or (
            device == "cuda" and (by_plan.get(one, 0) < 2 or sum(by_plan.values()) != by_plan[one])):
        raise AssertionError(f"corrupt: exit {rc}, launches {by_plan}\n{err.getvalue()[-2000:]}")
    record["corrupt"] = dict(solver_api=tripped, cli_exit=rc, launches_by_plan=by_plan,
                             recompute_plan=one)
    record["corrupt_jax_recipe"] = jax_recipe_drill(world, outdir, device, cli, chain_half)

    # the ingest with the integrity layer's parts, in turns: nothing; the
    # sums on the card; the double read with the sums on the card (what
    # --integrity runs)
    from sartsolver_tpu_torch.io import hdf5files as hf

    files = hf.sort_rtm_files(hf.categorize_input_files(inputs)[0])
    ingest = {}
    for name, sums, double in (("off", False, False), ("sums_device", True, False),
                               ("double_read_sums_device", True, True),
                               ("off", False, False)):
        integrity.configure(double)
        stats = integrity.IngestStats(P, V) if sums else None
        timings = {}
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf = read_and_shard_rtm(files, "with_reflections", P, V, device, dtype="float32",
                                 ingest_stats=stats, timings=timings)
        if stats is not None:
            stats.finish()
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if stats is not None:
            dens = buf.sum(dim=0, dtype=torch.float32).cpu().numpy()
            length = buf.sum(dim=1, dtype=torch.float32).cpu().numpy()
            issues = integrity.verify_ray_stats(stats, dens, length)
            if issues:
                raise AssertionError(f"ingest stats ({name}): {issues}")
        ingest.setdefault(name, []).append(dict(seconds=secs,
                                                read_seconds=timings["store"]["read_seconds"]))
        if name == "sums_device":
            ingest["sums_host"] = [host_ingest_sums(files, P, V, buf)]
        del buf
    integrity.configure(False)
    cli_ingest = {}
    for name, extra in (("off", []), ("integrity", ["--integrity"]), ("off", [])):
        out = os.path.join(outdir, f"ingest_{name}.h5")
        rc, ms, text, _ = cli(out, "-t", chain_half, "--chain_frames", "1", "--timing", *extra)
        m = re.search(r"ingest RTM \+ upload\s+([0-9.]+) ms", text)
        if rc != 0 or not m:
            raise AssertionError(f"ingest {name}: exit {rc}")
        cli_ingest.setdefault(name, []).append(float(m[1]))
    record["ingest"] = dict(read_and_shard_rtm_seconds=ingest,
                            cli_ingest_upload_ms=cli_ingest)

    # ms per frame with --integrity on and off, ``turns`` turns each way
    # over all the frames, on the fp32 scheduler (B = 8, one_read) and
    # chain (B = 1): each run's mean, their median and spread per setting
    in_turns = {}
    for loop, flags in (("scheduler", ["--no_guess", "--batch_frames", str(FRAME_LANES)]),
                        ("chain", ["--chain_frames", "1"])):
        runs = {"off": [], "on": []}
        for kind in ("off", "on") * turns:
            out = os.path.join(outdir, f"turns_{loop}_{kind}.h5")
            rc, ms, _, _ = cli(out, *flags, *(["--integrity"] if kind == "on" else []))
            if rc != 0 or len(ms) != T:
                raise AssertionError(f"integrity in turns, {loop} {kind}: exit {rc}, "
                                     f"{len(ms)} frames")
            runs[kind].append(statistics.mean(ms))
        med = {k: statistics.median(v) for k, v in runs.items()}
        in_turns[loop] = dict(ms_per_frame=runs, median=med,
                              spread={k: max(v) / min(v) - 1 for k, v in runs.items()},
                              overhead_of_medians=med["on"] / med["off"] - 1)
    record["integrity_ms_per_frame_in_turns"] = in_turns
    record["flush"] = flush_timing(outdir, world, **(flush_kw or {}))
    record["solve_ckpt"] = solve_ckpt_drill(
        world, outdir, device, os.path.join(outdir, "res_float32_scheduler_ref.h5"),
        ckpt_killed)
    return record


CKPT_STRIDES = (1, 4, 16)  # the --solve_ckpt_stride values timed against off


def _ckpt_argv(world) -> list:
    """The in-solve checkpoints' runs: the fp32 scheduler (``--no_guess
    --batch_frames 8`` over every frame, linear with the Laplacian)."""
    p = world["paths"]
    return [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"],
            "-m", str(MAX_ITERATIONS), "-l", p["laplacian"], "--rtm_dtype", "float32",
            "--no_guess", "--batch_frames", str(FRAME_LANES)]


def solve_ckpt_kill(world, outdir: str, device: str) -> tuple:
    """In a subprocess with ``--solve_ckpt_stride 1``, SIGKILL inside the
    held-open append of serial 2 (``SART_TEST_SOLVE_CKPT_DELAY``): ``(exit
    code, seconds)``; the run's file is ``ckpt_killed.h5`` in ``outdir``."""
    import signal as _signal
    import threading

    out = os.path.join(outdir, "ckpt_killed.h5")
    env = dict(os.environ, PYTHONPATH=REPO, SART_TEST_SOLVE_CKPT_DELAY="0.5")
    argv = _ckpt_argv(world)
    cmd = [sys.executable, "-m", "sartsolver_tpu_torch.cli", "-o", out, *argv,
           "--solve_ckpt_stride", "1", "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    timer = threading.Timer(RESILIENCE_TIMEOUT, proc.kill)
    timer.start()
    try:
        for line in proc.stderr:
            if line.strip() == "SART_SOLVE_CKPT_POINT pre-append serial=2":
                proc.send_signal(_signal.SIGKILL)
                break
        else:
            raise AssertionError("solve checkpoints: the run ended before serial 2")
        proc.stderr.read()
    finally:
        timer.cancel()
        proc.wait(timeout=60)
    return proc.returncode, time.perf_counter() - t0


def solve_ckpt_drill(world, outdir: str, device: str, ref: str, killed: tuple) -> dict:
    """In-solve checkpoints on the runs of :func:`_ckpt_argv`, whose
    uninterrupted run wrote ``ref``, after :func:`solve_ckpt_kill` returned
    ``killed``: the killed run kept serial 1 alone; ``--resume`` restores
    serial 1 and ends with ``ref``'s bytes. Then ms per frame at each of
    ``CKPT_STRIDES`` against off, one run each (off, 1, 4, 16), each run's
    file ``ref``'s bytes, and the bytes a record takes."""
    import signal as _signal

    from sartsolver_tpu_torch.resilience.podckpt import SolveCheckpointStore

    T = world["G"].shape[1]
    argv = _ckpt_argv(world)
    want = _read_rows(ref)

    def same_bytes(path, what):
        got = _read_rows(path)
        if set(got) != set(want) or any(not np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"solve checkpoints, {what}: not the uninterrupted bytes")

    out = os.path.join(outdir, "ckpt_killed.h5")
    rc, killed_s = killed
    serials = SolveCheckpointStore(out + ".solveckpt").serials()
    if rc != -_signal.SIGKILL or serials != [1]:
        raise AssertionError(f"solve checkpoints: exit {rc}, serials {serials}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, ms, _ = run_cli(["-o", out, *argv, "--solve_ckpt_stride", "1", "--resume"],
                            device=device)
    m = re.search(r"resumed from solve checkpoint serial (\d+)", err.getvalue())
    if rc != 0 or not m or int(m[1]) != 1:
        raise AssertionError(f"solve checkpoints resume: exit {rc}, {err.getvalue()[-500:]}")
    same_bytes(out, "the resumed run")
    record = dict(killed_at_serial=2, killed_after_s=killed_s, resumed_from_serial=int(m[1]),
                  resumed_rows=len(ms), resumed_bytes_equal=True)

    runs = {k: [] for k in ("off", *CKPT_STRIDES)}
    bytes_per_record = {}
    for stride in ("off", *CKPT_STRIDES):
        out = os.path.join(outdir, f"ckpt_{stride}.h5")
        side = out + ".solveckpt"
        if os.path.exists(side):
            os.remove(side)
        flags = [] if stride == "off" else ["--solve_ckpt_stride", str(stride)]
        t0 = time.perf_counter()
        rc, ms, _ = run_cli(["-o", out, *argv, *flags], device=device)
        wall = time.perf_counter() - t0
        if rc != 0 or len(ms) != T:
            raise AssertionError(f"solve checkpoints at {stride}: exit {rc}, {len(ms)} frames")
        same_bytes(out, f"--solve_ckpt_stride {stride}")
        runs[stride].append(dict(cli_ms_per_frame=statistics.mean(ms),
                                 wall_ms_per_frame=wall * 1e3 / T))
        if stride != "off" and os.path.exists(side):  # a short run may write none
            n = len(SolveCheckpointStore(side).serials())
            bytes_per_record[stride] = os.path.getsize(side) / max(n, 1)
    wall = {str(k): statistics.mean(r["wall_ms_per_frame"] for r in v) for k, v in runs.items()}
    record.update(ms_per_frame_in_turns={str(k): v for k, v in runs.items()},
                  wall_ms_per_frame=wall,
                  overhead_of_wall={k: v / wall["off"] - 1 for k, v in wall.items()},
                  bytes_per_record={str(k): v for k, v in bytes_per_record.items()})
    return record


def _trace_steps(path: str, kernel: str) -> dict:
    """From a ``--profile_dir`` trace: the ProfilerStep ranges on the host,
    and for each the CUDA kernels named ``kernel`` whose launches (joined by
    their correlation ids) lie inside it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("ProfilerStep#"))
    # the host side of each launch: the CUDA API call carrying its correlation id
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat", "").startswith("cuda_")
                   and "correlation" in e.get("args", {})}
    per_step, outside = [0] * len(steps), 0
    for e in events:
        if e.get("cat") != "kernel" or kernel not in e.get("name", ""):
            continue
        ts = launched_at.get(e.get("args", {}).get("correlation"))
        hit = [i for i, (t0, t1) in enumerate(steps) if ts is not None and t0 <= ts <= t1]
        if hit:
            per_step[hit[0]] += 1
        else:
            outside += 1
    return dict(steps=len(steps), kernels_in_steps=sum(per_step), kernels_outside=outside,
                min_kernels_a_step=min(per_step, default=0))


def obs_phase(world, outdir: str, device: str = "cuda", card: str = "") -> dict:
    """The observability layer through the CLI on the world, per storage: the
    chain loop over 8 frames and ``--no_guess --batch_frames 8`` (the
    scheduler, every frame), each run without sinks and then with
    ``--timing``, ``--metrics_out``, ``SART_METRICS_PROM`` and
    ``SART_TRACE_EVENTS``. Each sinks run's artifact passes the port's
    ``metrics --check``, its frame records are the solution file's rows
    (count, status, iterations), the file is the same bytes as the run
    without sinks, ``frames_total`` counts the frames printed and
    ``sched_strides_total`` the strides. Emitted, not gated: the phase split
    of the run's wall time (validate, ingest and upload, frame loop,
    voxel-map write) from the artifact, with the trace's ``ingest.rtm`` span
    and its first ``device.put`` (the upload), the wall ms per frame and the
    CLI's ms per frame with sinks on and off. Then once, fp32 scheduler with
    ``--profile_dir``: one profiler step per stride, and on the card the
    fused sweep's kernels in those steps equal its launches in the run. On
    the card also ``device_peaks`` for the card (the H100 row) and the
    roofline utilization of the fp32 scheduler's loop steps (``hbm_util``
    at most 1.05)."""
    from sartsolver_tpu_torch.cli import PROFILE_TRACE
    from sartsolver_tpu_torch.io import h5
    from sartsolver_tpu_torch.obs import roofline
    from sartsolver_tpu_torch.obs.cli import metrics_main
    from sartsolver_tpu_torch.obs.schema import load_jsonl
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, reset_launch_counts

    p = world["paths"]
    base = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"],
            "-m", str(MAX_ITERATIONS), "-l", p["laplacian"]]
    P, V = world["H"].shape
    T = world["G"].shape[1]
    on_card = device == "cuda"

    def run(name, flags, n_frames, sinks):
        out = os.path.join(outdir, f"obs_{name}.h5")
        art = os.path.join(outdir, f"obs_{name}.jsonl")
        extra = ["--timing", "--metrics_out", art] if sinks else []
        if sinks:
            os.environ["SART_METRICS_PROM"] = os.path.join(outdir, f"obs_{name}.prom")
            os.environ["SART_TRACE_EVENTS"] = os.path.join(outdir, f"obs_{name}.trace.json")
        try:
            t0 = time.perf_counter()
            rc, ms, text = run_cli(["-o", out, *base, *flags, *extra], device=device)
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop("SART_METRICS_PROM", None)
            os.environ.pop("SART_TRACE_EVENTS", None)
        if rc != 0 or len(ms) != n_frames:
            raise AssertionError(f"obs {name}: exit {rc}, {len(ms)} of {n_frames} frames")
        check_solution(out, world, n_frames, MAX_ITERATIONS, device)
        with open(out, "rb") as f:
            data = f.read()
        return data, text, dict(wall_ms=wall * 1e3, wall_ms_per_frame=wall * 1e3 / n_frames,
                                cli_ms_per_frame=statistics.mean(ms)), art

    def check_artifact(name, art, out, text, n_frames):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = metrics_main(["--check", art])
        if rc != 0:
            raise AssertionError(f"obs {name}: metrics --check exit {rc}: {buf.getvalue()}")
        records = [r for _, r in load_jsonl(art)[0]]
        frames = [r for r in records if r["type"] == "frame"]
        with h5.File(out, "r") as f:
            status, iters = f["solution/status"][:], f["solution/iterations"][:]
        if (len(frames) != n_frames or [r["status"] for r in frames] != status.tolist()
                or [r["iterations"] for r in frames] != iters.tolist()):
            raise AssertionError(f"obs {name}: frame records differ from the solution rows")
        metric = {(r["name"], tuple(sorted(r["labels"].items()))): r for r in records
                  if r["type"] == "metric"}
        frames_total = sum(r["value"] for (n, _), r in metric.items() if n == "frames_total")
        if frames_total != text.count("Processed in:"):
            raise AssertionError(f"obs {name}: frames_total {frames_total} against "
                                 f"{text.count('Processed in:')} frames printed")
        m = re.search(r"continuous batching: lanes=\d+ strides=(\d+) loop_steps=(\d+)", text)
        if m and metric[("sched_strides_total", ())]["value"] != int(m[1]):
            raise AssertionError(f"obs {name}: sched_strides_total against {m[1]} strides")
        split = {key: metric[("phase_seconds", (("phase", phase),))]["sum"] * 1e3
                 for key, phase in OBS_PHASES}
        # the ingest phase's spans: the chunked read and upload and the
        # solver's construction (ingest.rtm); inside it the passes over the
        # file (ingest.pass: the store, or int8's colmax and quantize) and
        # the first device.put (the solver's construction: the ray stats on
        # the device and the extension's load). The rest of the phase is
        # the Laplacian, the frame index and the voxel grid.
        with open(art[:-len(".jsonl")] + ".trace.json") as f:
            spans = json.load(f)["traceEvents"]
        first, passes = {}, {}
        for e in sorted(spans, key=lambda e: e["ts"]):
            if e.get("cat") == "beacon":  # the watchdog beacons' phase spans
                continue
            first.setdefault(e["name"], e["dur"] / 1e3)
            if e["name"] == "ingest.pass":
                passes[f"pass_{e['args']['what']}_ms"] = e["dur"] / 1e3
        split["ingest_rtm_span_ms"] = first["ingest.rtm"]
        split["first_device_put_span_ms"] = first["device.put"]
        ingest = dict(passes, solver_construction_ms=first["device.put"])
        ingest["rest_of_ingest_rtm_ms"] = first["ingest.rtm"] - sum(ingest.values())
        ingest["outside_ingest_rtm_ms"] = split["ingest_upload_ms"] - first["ingest.rtm"]
        return split, ingest, (int(m[1]), int(m[2])) if m else None

    record = {}
    for storage in STORAGES:
        entry = {}
        for loop, flags, n_frames in OBS_LOOPS:
            n_frames = n_frames or T
            flags = [*flags, "--rtm_dtype", storage]
            name = f"{storage}_{loop}"
            plain, _, off, _ = run(name + "_plain", flags, n_frames, sinks=False)
            data, text, on, art = run(name + "_sinks", flags, n_frames, sinks=True)
            if data != plain:
                raise AssertionError(f"obs {name}: the sinks changed the solution file")
            split, ingest, sched = check_artifact(
                name, art, os.path.join(outdir, f"obs_{name}_sinks.h5"), text, n_frames)
            entry[loop] = dict(frames=n_frames, phase_split_ms=split, ingest_split_ms=ingest,
                               split_sum_ms=sum(split[key] for key, _ in OBS_PHASES),
                               sinks_on=on, sinks_off=off, byte_equal=True)
            if sched:
                entry[loop].update(strides=sched[0], loop_steps=sched[1])
        record[storage] = entry

    # fp32 scheduler under --profile_dir: one step per stride, the sweep's
    # kernels inside them
    prof_dir = os.path.join(outdir, "obs_profile")
    reset_launch_counts()
    rc, ms, text = run_cli(["-o", os.path.join(outdir, "obs_profile.h5"), *base,
                            *OBS_LOOPS[1][1], "--profile_dir", prof_dir], device=device)
    launches = dict(fused_sweep.launches_by_plan)
    strides = int(re.search(r"strides=(\d+)", text)[1])
    steps = _trace_steps(os.path.join(prof_dir, PROFILE_TRACE), ONE_READ_KERNEL)
    if rc != 0 or len(ms) != T or steps["steps"] != strides:
        raise AssertionError(f"obs profile: exit {rc}, {len(ms)} frames, {steps} "
                             f"for {strides} strides")
    if on_card and (steps["kernels_in_steps"] != launches["one_read"] or steps["kernels_outside"]
                    or sum(launches.values()) != launches["one_read"]):
        raise AssertionError(f"obs profile: {steps} against launches {launches}")
    record["profile"] = dict(steps, strides=strides, launches_by_plan=launches,
                             trace_bytes=os.path.getsize(os.path.join(prof_dir, PROFILE_TRACE)))
    if on_card:
        peaks = roofline.device_peaks("gpu", card)
        if not peaks["source"].startswith("table:h100"):
            raise AssertionError(f"device_peaks for {card!r}: {peaks['source']}")
        fp32 = record["float32"]["scheduler"]
        iter_s = fp32["loop_steps"] / (fp32["phase_split_ms"]["frame_loop_ms"] / 1e3)
        util = roofline.utilization(*roofline.sweep_cost_model(P, V, FRAME_LANES, 4, 1),
                                    iter_s, peaks)
        if util["hbm_util"] > 1.05:
            raise AssertionError(f"roofline of the fp32 scheduler: {util}")
        record["roofline"] = dict(util, loop_steps_per_s=iter_s, device_peaks=peaks)
    return record


# ---- the ingest phase -----------------------------------------------------

INGEST_CHUNK_ROWS = 256  # the row-chunked copy's chunk height
# what the CLI process may add to its resident memory during a run besides
# its two pinned staging chunks: the frames, the solution rows, the writer's
# and prefetcher's queues, torch's host allocations
INGEST_RSS_MARGIN = 256 << 20
RTM_KEYS = ("rtm_a_seg1", "rtm_a_seg2", "rtm_b")

# a CLI run in a child process that reports its resident memory: the same
# flags run first on a small world (the CUDA context, the libraries' code
# pages, the extension), then a thread samples VmRSS every 2 ms while the
# CLI runs on the world; the largest sample less the resident size before
# the run is the run's growth. (Sampling, because a container may expose
# no VmHWM, refuse /proc/self/clear_refs, and report ru_maxrss for all its
# processes together.)
_RSS_CHILD = r"""
import contextlib, io, json, os, sys, tempfile, threading, time
sys.path.insert(0, os.environ["CHIP_SMOKE_REPO"])
import chip_smoke
from sartsolver_tpu_torch import cli

argv = sys.argv[1:]
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
    small = chip_smoke.write_world(d, nx=16, ny=16, cam=(8, 4), n_frames=12)["paths"]
    files = [small[k] for k in ("rtm_a_seg1", "rtm_a_seg2", "rtm_b", "img_a", "img_b")]
    flags = argv[argv.index("-m"):]
    del flags[flags.index("-l"):flags.index("-l") + 2]
    assert cli.main(["-o", os.path.join(d, "warm.h5"), *files, *flags,
                     "-l", small["laplacian"]]) == 0


def rss():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024


rss0 = rss()
peak, done = [rss0], threading.Event()


def sample():
    while not done.is_set():
        peak[0] = max(peak[0], rss())
        time.sleep(0.002)


sampler = threading.Thread(target=sample, daemon=True)
sampler.start()
rc = cli.main(argv)
done.set()
sampler.join()
print(json.dumps({"rc": rc, "rss_before": rss0, "rss_peak": max(peak[0], rss()),
                  "rss_after": rss()}))
"""


def write_chunked_copy(paths: dict, outdir: str, rows: int = INGEST_CHUNK_ROWS) -> dict:
    """The world's RTM files copied with their ``value`` matrices chunked
    ``rows`` rows a chunk (the port's writer: unfiltered chunks, a chunk
    B-tree), everything else as it was; returns the copies' paths."""
    from sartsolver_tpu_torch.io import h5

    def copy(src, dst):
        for k, v in src.attrs.items():
            dst.attrs[k] = v
        for name in src:
            obj = src[name]
            if isinstance(obj, h5.Group):
                copy(obj, dst.create_group(name))
                continue
            data = np.asarray(obj)
            chunked = name == "value" and data.ndim == 2 and data.shape[0] > rows
            ds = dst.create_dataset(name, data=data,
                                    chunks=(rows, data.shape[1]) if chunked else None)
            for k, v in obj.attrs.items():
                ds.attrs[k] = v

    out = {}
    for key in RTM_KEYS:
        out[key] = os.path.join(outdir, os.path.basename(paths[key]))
        with h5.File(paths[key], "r") as fin, h5.File(out[key], "w") as fout:
            copy(fin, fout)
    return out


def _ingest_once(files, P, V, storage, device, chunk_rows=None) -> dict:
    """One ingest through ``parallel/multihost.py``: the stored matrix (and
    int8 scales), each pass's seconds, read and upload seconds, the read's
    GB/s, the peak device bytes above what was allocated before, and the
    ray stats' seconds and peak."""
    import torch

    from sartsolver_tpu_torch.models.sart import compute_ray_stats, compute_ray_stats_int8
    from sartsolver_tpu_torch.parallel.multihost import (
        read_and_quantize_rtm, read_and_shard_rtm,
    )

    sorted_files = {"camA": [files["rtm_a_seg1"], files["rtm_a_seg2"]],
                    "camB": [files["rtm_b"]]}
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    timings = {}
    t0 = time.perf_counter()
    if storage == "int8":
        stored, scale = read_and_quantize_rtm(sorted_files, "with_reflections", P, V, device,
                                              chunk_rows=chunk_rows, timings=timings)
    else:
        stored = read_and_shard_rtm(sorted_files, "with_reflections", P, V, device,
                                    dtype=storage, chunk_rows=chunk_rows, timings=timings)
        scale = None
    rec = dict(seconds=time.perf_counter() - t0, passes=timings,
               read_gb_per_s={k: v["bytes"] / v["read_seconds"] / 1e9
                              for k, v in timings.items()})
    if on_card:
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated() - mem0
        rec["stored_bytes"] = stored.numel() * stored.element_size()
        torch.cuda.reset_peak_memory_stats()
        mem1 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if scale is None:
        stats = compute_ray_stats(stored, dtype=torch.float32)
    else:
        stats = compute_ray_stats_int8(stored, scale, dtype=torch.float32)
    if on_card:
        torch.cuda.synchronize()
        rec["ray_stats_peak_device_bytes"] = torch.cuda.max_memory_allocated() - mem1
    rec["ray_stats_seconds"] = time.perf_counter() - t0
    del stats
    return rec, stored, scale


def ingest_phase(world, outdir: str, device: str = "cuda") -> dict:
    """The chunked RTM ingest on the world (:func:`_ingest_once`), per
    storage: the stored matrix bit for bit against the host recipe
    (``read_rtm_block`` whole on the host; bf16 rounded there, int8 through
    ``quantize_rtm`` on the CPU), on the files as written and on a copy with
    row-chunked matrices (``write_chunked_copy``); the seconds, GB/s and
    peaks, the device peak at most the stored matrix plus two fp32 chunks
    and the ray stats' vectors. Then, on the card, the CLI's resident
    memory in a child process per storage, the three at once (the chain
    over 8 frames): its growth at most
    two fp32 chunks plus ``INGEST_RSS_MARGIN``. Then the CLI with
    ``--timing`` per storage on the chain over 8 frames and the scheduler
    over the world's frames, at the defaults with ``SART_INGEST_PREFETCH=1``
    and with one chunk, ``SART_INGEST_PREFETCH=0`` and
    ``SART_WRITER_QUEUE=1``: the same bytes and launches, the phase split
    and the ingest's spans. Then the fault drill on the fp32 chain:
    ``hdf5.rtm_ingest:io:1:1`` recovers with the same file, and
    ``solve.dispatch:error:1:1`` at ``--chain_frames 1`` writes frame 0
    FAILED and frames 1-7 as a healthy run over them writes them; a healthy
    run with a FAILED row fails the phase."""
    import torch

    from sartsolver_tpu_torch.io import h5
    from sartsolver_tpu_torch.io.raytransfer import read_rtm_block
    from sartsolver_tpu_torch.models.sart import quantize_rtm
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, reset_launch_counts
    from sartsolver_tpu_torch.parallel.multihost import default_chunk_rows
    from sartsolver_tpu_torch.resilience import faults

    p = world["paths"]
    P, V = world["H"].shape
    T = world["G"].shape[1]
    on_card = device == "cuda"
    chunk = min(default_chunk_rows(V), P)
    record = dict(shape=[P, V], chunk_rows=chunk, chunked_copy_rows=INGEST_CHUNK_ROWS)

    # the host recipe
    t0 = time.perf_counter()
    sorted_files = {"camA": [p["rtm_a_seg1"], p["rtm_a_seg2"]], "camB": [p["rtm_b"]]}
    host = torch.from_numpy(read_rtm_block(sorted_files, "with_reflections", P, V))
    record["host_read_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = {"float32": (host, None), "bfloat16": (host.to(torch.bfloat16), None),
            "int8": quantize_rtm(host)}
    record["host_recipe_seconds"] = time.perf_counter() - t0
    del host

    t0 = time.perf_counter()
    chunked_dir = os.path.join(outdir, "chunked")
    os.makedirs(chunked_dir, exist_ok=True)
    chunked = write_chunked_copy(p, chunked_dir)
    record["chunked_copy_write_seconds"] = time.perf_counter() - t0
    for storage in STORAGES:
        entry = {}
        for layout, files in (("contiguous", p), ("chunked", chunked)):
            rec, stored, scale = _ingest_once(files, P, V, storage, device)
            ref, ref_scale = want[storage]
            same = torch.equal(stored.cpu(), ref) and (
                scale is None or torch.equal(scale.cpu(), ref_scale))
            if not same:
                raise AssertionError(f"ingest {storage} {layout}: the stored matrix differs "
                                     "from the host recipe's")
            rec["bit_equal_to_host_recipe"] = True
            if on_card:
                limit = rec["stored_bytes"] + 2 * chunk * V * 4 + (P + V) * 4 + (4 << 20)
                rec["peak_device_limit_bytes"] = limit
                if rec["peak_device_bytes"] > limit:
                    raise AssertionError(f"ingest {storage} {layout}: peak device bytes "
                                         f"{rec['peak_device_bytes']} above {limit}")
            del stored, scale
            entry[layout] = rec
        record[storage] = entry
    for key in RTM_KEYS:  # the copy's 2 GiB on disk
        os.remove(chunked[key])
    del want

    base = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"],
            "-m", str(MAX_ITERATIONS), "-l", p["laplacian"]]
    if on_card:  # the CLI's resident memory, a child process per storage, all at once
        env = {**os.environ, "CHIP_SMOKE_REPO": REPO}

        def child(storage):
            return subprocess.run(
                [sys.executable, "-c", _RSS_CHILD, "-o",
                 os.path.join(outdir, f"ingest_rss_{storage}.h5"), *base, *OBS_LOOPS[0][1],
                 "--rtm_dtype", storage], env=env, capture_output=True, text=True,
                timeout=300)

        with concurrent.futures.ThreadPoolExecutor(len(STORAGES)) as pool:
            runs = dict(zip(STORAGES, pool.map(child, STORAGES)))
        for storage, run in runs.items():
            if run.returncode != 0:
                raise AssertionError(f"ingest rss {storage}: exit {run.returncode}: "
                                     f"{run.stderr[-2000:]}")
            rss = json.loads(run.stdout.strip().splitlines()[-1])
            rss["growth_bytes"] = rss["rss_peak"] - rss["rss_before"]
            rss["limit_bytes"] = 2 * chunk * V * 4 + INGEST_RSS_MARGIN
            if rss["rc"] != 0 or rss["growth_bytes"] > rss["limit_bytes"]:
                raise AssertionError(f"ingest rss {storage}: {rss}")
            record[storage]["cli_host_rss"] = rss

    def cli_run(name, flags, n_frames, env, expect=0, failed=0, check=True):
        out = os.path.join(outdir, f"ingest_{name}.h5")
        art = os.path.join(outdir, f"ingest_{name}.jsonl")
        trace = os.path.join(outdir, f"ingest_{name}.trace.json")
        saved = {k: os.environ.get(k) for k in (*env, "SART_TRACE_EVENTS")}
        os.environ.update(env)
        os.environ["SART_TRACE_EVENTS"] = trace
        faults.reset()
        reset_launch_counts()
        try:
            t0 = time.perf_counter()
            rc, ms, text = run_cli(["-o", out, *base, *flags, "--timing", "--metrics_out", art],
                                   device=device)
            wall = time.perf_counter() - t0
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            faults.reset()
        if rc != expect or len(ms) != n_frames - failed:  # a FAILED frame prints no time
            raise AssertionError(f"ingest {name}: exit {rc}, {len(ms)} of {n_frames} frames")
        with h5.File(out, "r") as f:
            status = f["solution/status"][:]
        if expect == 0:
            if (status == -3).any():
                raise AssertionError(f"ingest {name}: a healthy run wrote FAILED rows")
            if check:  # the window starts at frame 0
                check_solution(out, world, n_frames, MAX_ITERATIONS, device)
        metric = {(r["name"], tuple(sorted(r["labels"].items()))): r
                  for _, r in load_jsonl(art)[0] if r["type"] == "metric"}
        split = {key: metric[("phase_seconds", (("phase", phase),))]["sum"] * 1e3
                 for key, phase in OBS_PHASES}
        with open(trace) as f:
            spans = json.load(f)["traceEvents"]
        for e in spans:
            if e["name"] == "ingest.pass":
                split[f"pass_{e['args']['what']}_ms"] = e["dur"] / 1e3
            elif e["name"] in ("ingest.rtm", "device.put") and \
                    f"{e['name']}_first_ms" not in split:
                split[f"{e['name']}_first_ms"] = e["dur"] / 1e3
        with open(out, "rb") as f:
            data = f.read()
        return data, text, dict(wall_ms=wall * 1e3, cli_ms_per_frame=statistics.mean(ms),
                                phase_split_ms=split, status=status.tolist(),
                                launches_by_plan=dict(fused_sweep.launches_by_plan))

    from sartsolver_tpu_torch.obs.schema import load_jsonl

    configs = (("default", {"SART_INGEST_PREFETCH": "1"}),
               ("one_chunk", {"SART_INGEST_CHUNK_ROWS": str(P), "SART_INGEST_PREFETCH": "0",
                              "SART_WRITER_QUEUE": "1"}))
    healthy = {}
    for storage in STORAGES:
        for loop, flags, n_frames in OBS_LOOPS:
            n_frames = n_frames or T
            runs = {}
            for cfg, env in configs:
                data, _, rec = cli_run(f"{storage}_{loop}_{cfg}",
                                       [*flags, "--rtm_dtype", storage], n_frames, env)
                runs[cfg] = (data, rec)
            (a, ra), (b, rb) = runs["default"], runs["one_chunk"]
            if a != b or ra["launches_by_plan"] != rb["launches_by_plan"]:
                raise AssertionError(f"ingest {storage} {loop}: the pipeline's settings changed "
                                     "the file or the launches")
            healthy[storage, loop] = a
            record[storage][f"cli_{loop}"] = dict(frames=n_frames, byte_equal=True,
                                                  **{cfg: r for cfg, (_, r) in runs.items()})

    # the fault drill, fp32 chain over 8 frames
    chain = [*OBS_LOOPS[0][1], "--rtm_dtype", "float32"]
    data, text, rec = cli_run("fault_rtm_ingest", chain, 8,
                              {"SART_FAULT": "hdf5.rtm_ingest:io:1:1"})
    if data != healthy["float32", "chain"] or \
            "retries at hdf5.rtm_ingest: " not in text or "1 recovered" not in text:
        raise AssertionError("fault drill hdf5.rtm_ingest: not recovered to the healthy file")
    drill = dict(rtm_ingest=dict(rec, recovered=True, byte_equal_to_healthy=True))
    _, _, rec = cli_run("fault_solve", ["-t", "0:0.75", "--chain_frames", "1",
                                        "--rtm_dtype", "float32"], 8,
                        {"SART_FAULT": "solve.dispatch:error:1:1"}, expect=2, failed=1)
    _, _, ref = cli_run("fault_solve_reference", ["-t", "0.05:0.75", "--chain_frames", "1",
                                                  "--rtm_dtype", "float32"], 7, {},
                          check=False)
    with h5.File(os.path.join(outdir, "ingest_fault_solve.h5"), "r") as f:
        got = {k: f["solution"][k][:] for k in ("value", "status", "iterations")}
    with h5.File(os.path.join(outdir, "ingest_fault_solve_reference.h5"), "r") as f:
        want_rows = {k: f["solution"][k][:] for k in ("value", "status", "iterations")}
    if got["status"][0] != -3 or got["iterations"][0] != -1 or (got["value"][0] != 0).any() \
            or (got["status"][1:] == -3).any() or any(
                not np.array_equal(got[k][1:], want_rows[k]) for k in got):
        raise AssertionError(f"fault drill solve.dispatch: statuses {got['status']}")
    drill["solve_dispatch"] = dict(rec, failed_rows=1, rest_equal_to_healthy=True)
    record["fault_drill"] = drill
    return record


# ---- kernel checks and timing ---------------------------------------------

# ---- the block-sparse RTM (--sparse_rtm) -----------------------------------

SPARSE_DARK_ROWS = 64  # the grid rows at the top and at the bottom no camera sees
SPARSE_EPS = "0.05"  # the explicit threshold's run
SPARSE_FIT_TOL = RESUME_FIT_TOL  # sparse against dense in fitted space (fp32)


def _ingest_peak(world, storage, device, sparse: bool) -> dict:
    """The ingest and the solver's construction of ``world`` at ``storage``,
    dense or with the tile index (``--sparse_rtm auto``): the peak device
    bytes above what was allocated before, the bytes allocated after (the
    resident), the held matrix's shape and bytes, the index's occupancy."""
    import torch

    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.parallel.multihost import (
        make_tile_stats, read_and_quantize_rtm, read_and_shard_rtm,
    )
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

    p = world["paths"]
    files = {"camA": [p["rtm_a_seg1"], p["rtm_a_seg2"]], "camB": [p["rtm_b"]]}
    P, V = world["H"].shape
    on_card = device == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    opts = SolverOptions(rtm_dtype=None if storage == "float32" else storage,
                         sparse_rtm="auto" if sparse else "off")
    stats = make_tile_stats(P, V) if sparse else None
    t0 = time.perf_counter()
    if storage == "int8":
        rtm, scale = read_and_quantize_rtm(files, "with_reflections", P, V, device,
                                           tile_stats=stats)
    else:
        rtm = read_and_shard_rtm(files, "with_reflections", P, V, device, dtype=storage,
                                 tile_stats=stats)
        scale = None
    occ = stats.occupancy(0.0) if sparse else None
    solver = DistributedSARTSolver(rtm, opts=opts, device=device, rtm_scale=scale,
                                   tile_occupancy=occ)
    del rtm, scale
    held = solver.problem.rtm
    rec = dict(seconds=time.perf_counter() - t0, held_shape=list(held.shape),
               held_bytes=held.numel() * held.element_size(),
               occupancy=None if occ is None else occ.occupancy_fraction())
    if on_card:
        torch.cuda.synchronize()
        rec.update(peak_device_bytes=torch.cuda.max_memory_allocated() - mem0,
                   resident_device_bytes=torch.cuda.memory_allocated() - mem0)
    solver.close()
    del solver, held
    return rec


def sparse_phase(world, outdir: str, device: str = "cuda", dark_rows: int = SPARSE_DARK_ROWS,
                 rates=None) -> dict:
    """The block-sparse RTM on the world with the grid's top and bottom
    ``dark_rows`` rows dark (:func:`write_dark_world`; at the defaults
    voxels [0, 16384) and [49152, 65536), 256 of the 512 tile columns).
    Its frames' fitted errors against the noiseless measurement are
    recorded, not held to ``FIT_BOUND``: the pixels whose band lay in the
    dark rows see the floor alone, and the guess frame's error is above the
    e2e world's (5.5% in fp32); the sparse run is held to the dense one's.
    Per storage, the ingest and the solver's construction dense and
    sparse: the peak device bytes (the sparse one's no higher), the
    resident bytes, the held matrix. Per storage, linear with the Laplacian
    over 8 frames and log over 4 (``--chain_frames 1``) with ``--sparse_rtm
    auto`` beside ``off``: the statuses equal, the fitted distance to the
    dense run within ``SPARSE_FIT_TOL``, the largest fitted error at most the
    dense run's plus that; on the card every launch of the sparse run on
    ``plan_sweep(P, V_occ, 1, storage)`` and as many as its iterations; ms
    per frame of each. Once at ``--sparse_rtm 0.05`` (fp32 linear): the
    same columns held, the thresholded operator's fit to the measurement
    within ``FIT_BOUND``. fp32 ``--no_guess --batch_frames 8`` (the
    scheduler's launches on ``plan_sweep(P, V_occ, 8, ...)`` equal to its
    loop steps) and ``--os_subsets 4`` (no fused-sweep launch), each beside
    ``off``. On the card, with ``rates``: the compacted call checked
    against its plain version and timed (each storage at B = 1, fp32 at
    B = 8) beside its bound, the plain version and the library."""
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, plan_sweep, reset_launch_counts

    t_world = time.perf_counter()
    sw = write_dark_world(world, os.path.join(outdir, "sparse_world"), dark_rows)
    p = sw["paths"]
    P, V = sw["H"].shape
    T = sw["G"].shape[1]
    on_card = device == "cuda"
    record = dict(world_seconds=time.perf_counter() - t_world, dark_rows=dark_rows,
                  dark_voxels=int(2 * dark_rows * sw["grid"][1]), ingest={})
    base = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"],
            "-m", str(MAX_ITERATIONS)]
    V_occ = None

    for storage in STORAGES:
        dense = _ingest_peak(sw, storage, device, sparse=False)
        sparse = _ingest_peak(sw, storage, device, sparse=True)
        V_occ = sparse["held_shape"][1]
        if sparse["held_shape"] != [P, V - 2 * dark_rows * sw["grid"][1]]:
            raise AssertionError(f"sparse {storage}: holds {sparse['held_shape']}")
        record["ingest"][storage] = dict(dense=dense, sparse=sparse)
        if on_card and sparse["peak_device_bytes"] > dense["peak_device_bytes"]:
            raise AssertionError(f"sparse {storage} ingest peak above the dense one's: "
                                 f"{record['ingest']}")

    def run(name, flags, n, plan_shape=None, fit_bound=None):
        out = os.path.join(outdir, f"sparse_{name}.h5")
        reset_launch_counts()
        rc, ms, text = run_cli(["-o", out, *base, *flags], device=device)
        if rc != 0 or len(ms) != n:
            raise AssertionError(f"sparse {name}: exit {rc}, {len(ms)} of {n} frames")
        sol, err = check_solution(out, sw, n, MAX_ITERATIONS, device, fit_bound=fit_bound)
        rec = dict(cli_ms_per_frame=statistics.mean(ms), frame_ms=ms,
                   iterations=sol["iterations"].tolist(), status=sol["status"].tolist(),
                   fit_err_max=float(err.max()),
                   launches_by_plan=dict(fused_sweep.launches_by_plan))
        m = re.search(r"continuous batching: lanes=\d+ strides=(\d+) loop_steps=(\d+)", text)
        if m:
            rec.update(strides=int(m[1]), loop_steps=int(m[2]))
        m = re.search(r"sparse: tile occupancy ([0-9.]+) \(threshold ([^,]+), eps ([^,]+), "
                      r"digest (0x[0-9a-f]+)", text)
        if m:
            rec.update(occupancy=float(m[1]), threshold=float(m[2]), digest=m[4])
        m = re.search(r"voxels_held=(\d+)", text)
        rec["voxels_held"] = int(m[1]) if m else V
        if on_card and plan_shape is not None:
            want = dict.fromkeys(rec["launches_by_plan"], 0)
            want[plan_sweep(*plan_shape)] = (rec.get("loop_steps") if plan_shape[2] > 1
                                             else int(sol["iterations"].sum()))
            if rec["launches_by_plan"] != want:
                raise AssertionError(f"sparse {name}: launches {rec['launches_by_plan']}, "
                                     f"{want} expected")
        return sol, rec

    def pair(name, flags, n, B, fused=True):
        """``flags`` with ``--sparse_rtm auto`` and ``off``, held together."""
        s_sol, s_rec = run(f"{name}_auto", [*flags, "--sparse_rtm", "auto"], n,
                           plan_shape=(P, V_occ, B, _storage_of(flags)) if fused else None)
        d_sol, d_rec = run(f"{name}_off", [*flags, "--sparse_rtm", "off"], n,
                           plan_shape=(P, V, B, _storage_of(flags)) if fused else None)
        if on_card and not fused and (sum(s_rec["launches_by_plan"].values())
                                      or sum(d_rec["launches_by_plan"].values())):
            raise AssertionError(f"sparse {name}: a fused-sweep launch in the OS cycle")
        if not np.array_equal(s_sol["status"], d_sol["status"]):
            raise AssertionError(f"sparse {name}: statuses {s_sol['status']} against "
                                 f"{d_sol['status']}")
        if s_rec["fit_err_max"] > d_rec["fit_err_max"] + SPARSE_FIT_TOL:
            raise AssertionError(f"sparse {name}: fitted error {s_rec['fit_err_max']} against "
                                 f"the dense run's {d_rec['fit_err_max']}")
        dist = _fitted_distance(sw, s_sol["value"], d_sol["value"], device)
        if not (dist <= SPARSE_FIT_TOL).all():
            raise AssertionError(f"sparse {name}: fitted distance {dist} to the dense run")
        return dict(sparse=s_rec, dense=d_rec, fitted_distance_max=float(dist.max()),
                    ms_per_frame_ratio=s_rec["cli_ms_per_frame"] / d_rec["cli_ms_per_frame"])

    lap = ["-l", p["laplacian"]]
    record["runs"] = {}
    for storage in STORAGES:
        # the compacted shape's first solve on this storage (its library
        # handles and first launches) in a run of its own, kept out of the
        # times below: the dense shape is warm from the phases before
        run(f"{storage}_warm_up", ["--rtm_dtype", storage, "-t", "0:0.05",
                                   "--sparse_rtm", "auto"], 1)
    for storage in STORAGES:
        st = ["--rtm_dtype", storage]
        record["runs"][storage] = dict(
            linear=pair(f"{storage}_linear", [*st, *lap, "-t", "0:0.75", "--chain_frames", "1"],
                        8, 1),
            log=pair(f"{storage}_log", [*st, "-L", "-t", "0:0.35", "--chain_frames", "1"], 4, 1))
    fp32 = ["--rtm_dtype", "float32"]
    record["runs"]["float32_batch"] = pair(
        "float32_batch", [*fp32, *lap, "--no_guess", "--batch_frames", str(FRAME_LANES)], T,
        FRAME_LANES)
    record["runs"]["float32_os"] = pair(
        "float32_os", [*fp32, *lap, "-t", "0:0.35", "--chain_frames", "1", "--os_subsets",
                       str(OS_SUBSETS)], 4, 1, fused=False)
    # the threshold: the floor's off-band tiles inside the kept columns
    # dropped, no further column (a lossy solve: its fit is recorded, the
    # statuses held); the thresholded operator's fit beside the full one's
    eps_sol, eps_rec = run("float32_eps", [*fp32, *lap, "-t", "0:0.75", "--chain_frames", "1",
                                           "--sparse_rtm", SPARSE_EPS], 8,
                           plan_shape=(P, V_occ, 1, "float32"))
    auto = record["runs"]["float32"]["linear"]["sparse"]
    if eps_rec["voxels_held"] != V_occ or not (
            eps_rec["threshold"] > 0 and eps_rec["occupancy"] < auto["occupancy"]):
        raise AssertionError(f"sparse {SPARSE_EPS}: holds {eps_rec['voxels_held']} voxels, "
                             f"occupancy {eps_rec['occupancy']} against {auto['occupancy']}")
    eps_rec["thresholded_fit_err"] = _thresholded_fit(sw, eps_sol["value"], float(SPARSE_EPS),
                                                      device).tolist()
    eps_rec["full_fit_err_max"] = eps_rec.pop("fit_err_max")
    record["runs"]["float32_eps"] = eps_rec
    record["voxels_held"] = V_occ
    record["launches"] = {
        key: sum((r if kind is None else r[kind])["launches_by_plan"][plan_sweep(P, V_occ, B, st)]
                 for r, kind in runs)
        for key, B, st, runs in _sparse_launch_keys(record["runs"])}
    if on_card and rates is not None:
        record["kernels"] = _sparse_kernels(P, V_occ, rates)
    for name in ("rtm_a_seg1", "rtm_a_seg2", "rtm_b"):
        os.remove(p[name])
    return record


def _storage_of(flags) -> str:
    return flags[flags.index("--rtm_dtype") + 1]


def _sparse_launch_keys(runs):
    """(kernel table key, B, storage, the runs that launched it) of the
    compacted calls."""
    for storage in STORAGES:
        yield (storage, 1, storage,
               [(runs[storage]["linear"], "sparse"), (runs[storage]["log"], "sparse")]
               + ([(runs["float32_eps"], None)] if storage == "float32" else []))
    yield (f"float32@B{FRAME_LANES}", FRAME_LANES, "float32",
           [(runs["float32_batch"], "sparse")])


def _thresholded_fit(sw, value, eps, device):
    """Per frame ``||H_t value - H f_true s|| / ||H f_true s||``, ``H_t`` the
    world's matrix with the tiles ``eps`` drops zeroed (on the device)."""
    import torch

    from sartsolver_tpu_torch.models.sart import zero_dropped_tiles_
    from sartsolver_tpu_torch.ops.sparse import build_tile_occupancy

    occ = build_tile_occupancy(sw["H"], epsilon=eps)
    H = torch.as_tensor(sw["H"], device=device)
    truth = torch.as_tensor(sw["f_true"][:, None] * sw["scales"][None, :value.shape[0]],
                            dtype=torch.float32, device=device)
    ref = H @ truth
    zero_dropped_tiles_(H, occ.mask, occ.tile_rows, occ.tile_cols)
    fit = H @ torch.as_tensor(value.T, dtype=torch.float32, device=device)
    return ((fit - ref).norm(dim=0) / ref.norm(dim=0)).cpu().numpy()


def _sparse_kernels(P, V_occ, rates) -> dict:
    """The compacted call (``[P, V_occ]``) on the card: each storage at
    B = 1 and fp32 at B = 8, linear with the penalty (log checked too),
    checked against the plain version through the plan the runs took and
    timed beside the bound, the plain version and the library (two
    ``torch.matmul`` on the compacted fp32 matrix)."""
    from sartsolver_tpu_torch.ops.fused_sweep import plan_sweep

    out = {}
    for key, B, storage in [(st, 1, st) for st in STORAGES] + [
            (f"float32@B{FRAME_LANES}", FRAME_LANES, "float32")]:
        plan = plan_sweep(P, V_occ, B, storage)
        errs = []
        for logarithmic in (False, True):
            H, w, f, aux, scale = _sweep_inputs(P, V_occ, B, logarithmic, True,
                                                seed=P + V_occ + B + logarithmic,
                                                storage=storage)
            kw = dict(logarithmic=logarithmic, alpha=0.7, eps=1e-7)
            record, err = _check_kernel(H, w, f, aux, scale, kw, storage, plan=plan)
            errs.append(err)
            if not logarithmic:
                timing = _timing(H, w, f, aux, scale, kw, rates, plan)
            del H, w, f, aux, scale
        out[key] = dict(timing, max_abs_err=max(errs))
    return out


STORAGES = ("float32", "bfloat16", "int8")
TC_STORAGES = ("bfloat16", "int8")  # the storage types tensor_core takes
VARIANT = {"float32": "B1/B2", "bfloat16": "B3", "int8": "B4"}
# the batch sizes each plan is checked at in the kernels phase: one_read's
# instances (fp32 up to 8) and tensor_core's batch tiles (bf16 from B = 5,
# where its one_read ends)
ONE_READ_CHECK_B = {"float32": (1, 3, 4, 5, 8), "bfloat16": (1, 3, 4), "int8": (1, 3, 4)}
TENSOR_CORE_CHECK_B = {"bfloat16": (5, 8, 16, 19, 32), "int8": (8, 16, 19, 32)}
# the batch sizes of the tensor_core / two_read crossover tables
TC_CROSSOVER_B = (2, 3, 4, 5, 6, 7, 8, 16, 32)
REPLACES = "sartsolver_tpu/ops/fused_sweep.py:829"
SOURCE = "sartsolver_tpu_torch/ops/csrc/fused_sweep.cu"
# two_read's own rows (storage, P, V, B), linear with the penalty: fp32 past
# one_read's B = 8 on the e2e shape; the tall world's shape for each storage;
# a tall and narrow matrix; the capacity demo's bf16 and int8 shapes
# (benchmarks/capacity_demo.py), each at B = 1 and at the largest B that
# two_read takes for it
TWO_READ_ROWS = (("float32", 8192, 65536, THIRTY_TWO_LANES),
                 ("float32", 16384, 65536, 1), ("float32", 16384, 65536, FRAME_LANES),
                 ("bfloat16", 16384, 65536, 1), ("int8", 16384, 65536, 1),
                 ("float32", 65536, 16384, 1),
                 ("bfloat16", 49152, 131072, 1), ("bfloat16", 49152, 131072, 2),
                 ("int8", 65536, 131072, 1), ("int8", 65536, 131072, 3))
# the int8 Pallas probes: (name, TPU kernel, direct dot)
PROBES = (
    ("int8_dequant_probe", "benchmarks/int8_dequant_probe.py:17", False),
    ("int8_scratch_probe", "benchmarks/int8_scratch_probe.py:54", False),
    ("int8_direct_dot_probe", "benchmarks/int8_direct_dot_probe.py:30", True),
)


def _rand(g):
    import torch

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, generator=g, device="cuda") * (hi - lo) + lo
    return rand


def _sweep_inputs(P, V, B, logarithmic, with_pen, seed, storage="float32"):
    """Random sweep inputs on the card: ``(H, w, f, aux, scale)``, ``H`` in
    the storage dtype (int8 codes quantized from an fp32 draw, with their
    ``scale`` [1, V]; None for float storage)."""
    import torch

    from sartsolver_tpu_torch.models.sart import quantize_rtm

    rand = _rand(torch.Generator(device="cuda").manual_seed(seed))
    H = rand(P, V)
    scale = None
    if storage == "bfloat16":
        H = H.to(torch.bfloat16)
    elif storage == "int8":
        H, s = quantize_rtm(H)
        scale = s[None, :]
    w = rand(B, P, lo=0.0 if logarithmic else -0.5) / P
    f = rand(B, V, lo=0.1, hi=2.0)
    if logarithmic:  # obs is zero where the voxel mask is, as make_obs leaves it
        vm = (rand(1, V) > 0.1).float()
        aux = [vm, rand(B, V, lo=0.1) * vm]
    else:
        aux = [rand(1, V, hi=2.0)]
    if with_pen:
        aux.append(rand(B, V, lo=-0.01, hi=0.01))
    return H, w, f, aux, scale


def _probe_inputs(direct: bool, seed: int):
    """B4 at the int8 probes' configuration (8192 x 65536, B = 32, linear,
    no penalty). The dequant and scratch probes quantize ``0.1 + 0.9 U`` per
    voxel and take ``invd`` from the quantized column sums; the direct-dot
    probe feeds codes in [0, 127) with no scale (scale 1) and ``invd =
    1e-6``, from ``f = 0``."""
    import torch

    from sartsolver_tpu_torch.models.sart import quantize_rtm

    P, V, B = 8192, 65536, 32
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = _rand(g)
    if direct:
        H = torch.randint(0, 127, (P, V), generator=g, device="cuda", dtype=torch.int8)
        scale = torch.ones((1, V), device="cuda")
        invd = torch.full((1, V), 1e-6, device="cuda")
        f = torch.zeros((B, V), device="cuda")
    else:
        H, s = quantize_rtm(rand(P, V, lo=0.1, hi=1.0))
        scale = s[None, :]
        invd = 1.0 / (scale * H.sum(dim=0, dtype=torch.int32).float()[None, :])
        f = rand(B, V, lo=0.0, hi=2.0)
    w = rand(B, P, lo=-0.5, hi=1.0) / P
    return H, w, f, [invd], scale


def _check_kernel(H, w, f, aux, scale, kw, storage, plan=None, enforce=True):
    """Kernel against plain version through ``plan`` (None: the shape's
    own): (record, max_abs_err); raises on a failed check unless not
    ``enforce`` (a measurement-only variant)."""
    import torch

    from sartsolver_tpu_torch.ops.fused_sweep import (
        _sweep, fused_sweep, fused_sweep_reference, plan_sweep,
    )

    if plan is None:
        plan = plan_sweep(*H.shape, w.shape[0], storage)
    before = fused_sweep.launches_by_plan[plan]
    out1 = _sweep(H, w, f, aux, scale=scale, plan=plan, **kw)
    out2 = _sweep(H, w, f, aux, scale=scale, plan=plan, **kw)
    ref = fused_sweep_reference(H, w, f, aux, scale=scale, **kw)
    torch.cuda.synchronize()
    counted = fused_sweep.launches_by_plan[plan] - before
    identical = all(torch.equal(a, b) for a, b in zip(out1, out2))
    abs_err = max(float((a - r).abs().max()) for a, r in zip(out1, ref))
    rel = max(float((a - r).abs().max()) / float(r.abs().max())
              for a, r in zip(out1, ref))
    finite = all(bool(torch.isfinite(r).all()) for r in ref)
    passed = identical and counted == 2 and finite and rel <= KERNEL_TOL
    logarithmic = kw["logarithmic"]
    record = dict(storage=storage, plan=plan, shape=[*H.shape, w.shape[0]],
                  mode="log" if logarithmic else "linear",
                  pen=len(aux) > (2 if logarithmic else 1),
                  max_rel_err=rel, max_abs_err=abs_err, byte_identical=identical,
                  launches_counted=counted, ok=passed)
    if enforce and not passed:
        raise AssertionError(f"fused_sweep check failed: {record}")
    return record, abs_err


def _median_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _in_turns(old, new) -> tuple:
    """Median ms of two callables timed in turns, old, new, new, old:
    ``(old_ms, new_ms, turns)``, each the mean of its two medians."""
    turns = [_median_ms(old), _median_ms(new), _median_ms(new), _median_ms(old)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


def _device_profile(fn, calls: int = 5) -> dict:
    """From ``torch.profiler`` over ``calls`` calls of ``fn`` after one
    warm-up: the device time per call of each CUDA kernel it launches, and
    how many distinct kernels that is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return dict(ms_by_kernel=out, kernels_per_call=len(out))


def _trace_profile(fn, calls: int = 5, attempts: int = 3) -> dict:
    """From ``torch.profiler``'s exported trace over ``calls`` calls of
    ``fn`` after one warm-up (the trace keeps every kernel record, where the
    event tree can drop one it cannot tie to its launch): the CUDA kernels a
    call (records over calls), and the device ms a call, by kernel and in
    all. A session whose kernel records are not whole calls (none at all,
    or a part of one call's: the profiler now and then drops records,
    PERF.md §7) is taken again, ``attempts`` in all; a call's kernels are
    the same every call, so a kernel that launches more than its count
    still shows it."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        n = sum(e.get("cat") == "kernel" for e in events)
        if n and n % calls == 0:
            break
    by_kernel, records = {}, 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e.get("name", "").removeprefix("void ").replace("(anonymous namespace)::", "")
        name = name.split("(")[0][:60]
        by_kernel[name] = by_kernel.get(name, 0.0) + float(e.get("dur", 0.0)) / 1e3 / calls
        records += 1
    return dict(ms_by_kernel=by_kernel, kernels_per_call=records / calls,
                device_ms=sum(by_kernel.values()))


def _bound(H, w, aux, scale, plan, rates) -> dict:
    """The least time of one sweep at this shape: its bytes (each input
    read once, each output written once) at the memory rate against its
    operations at the rate of their type (fp32 FMAs, or three bf16
    tensor-core products for ``tensor_core``)."""
    mem_rate, fp32_rate, bf16_rate = rates
    P, V = H.shape
    B = w.shape[0]
    vectors = B * P + B * V + sum(a.numel() for a in aux) + B * V + B * P
    if scale is not None:
        vectors += scale.numel()
    nbytes = H.element_size() * P * V + 4 * vectors
    flops = 4 * B * P * V
    if plan == "tensor_core":
        flops, rate, rate_name = 3 * flops, bf16_rate, "bf16 dense tensor cores, 3 products"
    else:
        rate, rate_name = fp32_rate, "fp32 outside the tensor cores"
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, flops / rate * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_rate=rate_name, bytes=nbytes, flops=flops,
                two_read_floor_ms=2 * bytes_ms)


def _timing(H, w, f, aux, scale, kw, rates, plan, versus=None) -> dict:
    """Kernel, plain-version and library times beside the bound. With
    ``versus`` (another plan) the two are timed in turns, old, new, new,
    old, and each reported as the mean of its two medians. The library
    yardstick is two ``torch.matmul`` around the update on an fp32 copy of
    the (dequantized) matrix made outside the timed window, so it reads 4
    bytes per element whatever the storage."""
    import torch

    from sartsolver_tpu_torch.ops.fused_sweep import _sweep, fused_sweep_reference

    P, V = H.shape
    B = w.shape[0]
    logarithmic, eps = kw["logarithmic"], kw.get("eps", 0.0)

    def library():
        bp = torch.matmul(w, Hd)
        if logarithmic:
            f_new = f * ((aux[1] + eps) / (bp * aux[0] + eps))
        else:
            f_new = f + aux[0] * bp
            f_new = torch.clamp_min(f_new - aux[1] if len(aux) > 1 else f_new, 0)
        return torch.matmul(f_new, Hd.T)

    def kernel(name):
        return lambda: _sweep(H, w, f, aux, scale=scale, plan=name, **kw)

    if versus is None:
        ms, other = _median_ms(kernel(plan)), None
    else:
        old_ms, ms, turns = _in_turns(kernel(versus), kernel(plan))
        other = dict(plan=versus, ms=old_ms, turns_ms=turns,
                     device=_device_profile(kernel(versus)))
    out = dict(
        plan=plan, ms=ms, device=_device_profile(kernel(plan)),
        plain_ms=_median_ms(lambda: fused_sweep_reference(H, w, f, aux, scale=scale, **kw)),
        **_bound(H, w, aux, scale, plan, rates),
        shape=[P, V, B], storage=str(H.dtype)[6:],
        mode="log" if logarithmic else "linear", pen=len(aux) > (2 if logarithmic else 1),
    )
    # the fp32 copy after the plain version's run, scaled in place: the
    # capacity shapes' copy is 26-34 GB
    torch.cuda.empty_cache()
    Hd = H.float() if scale is None else H.float().mul_(scale)
    out["library_ms"] = _median_ms(library)
    del Hd
    torch.cuda.empty_cache()
    if other is not None:
        out["versus"] = dict(other, **_bound(H, w, aux, scale, versus, rates))
    return out


def _kernel_names(profile: dict) -> list:
    """The CUDA kernels of a profiled call by name, template arguments
    dropped."""
    return sorted({name.split("<")[0] for name in profile["ms_by_kernel"]})


def _lanes(B: int):
    """Distinct exponents per row for the scheduled log update (relaxation
    0.9 times decay 0.98**k at k = 0, 3, 6, ...): ``[B, 1]`` on the card."""
    import torch

    k = 3 * torch.arange(B, device="cuda", dtype=torch.float32)
    return (0.9 * 0.98 ** k)[:, None].contiguous()


def _sched_timing(H, w, f, aux, scale, lanes, eps, rates, plan) -> dict:
    """The scheduled log update (``alpha_lane``) timed in turns with the
    fixed-exponent log sweep (α = 0.9, which takes the power too): fixed,
    scheduled, scheduled, fixed, each the mean of its two medians; where the
    plan is not ``two_read``, the scheduled update through forced
    ``two_read`` in turns with it too; the plain version's and the library's
    times (two ``torch.matmul`` around the update on an fp32 copy of the
    dequantized matrix) beside the bound of the same bytes (the exponents add
    4 B bytes)."""
    import torch

    from sartsolver_tpu_torch.ops.fused_sweep import _sweep, fused_sweep_reference

    Hd = H.float() if scale is None else H.float() * scale

    def library():
        bp = torch.matmul(w, Hd)
        f_new = f * ((aux[1] + eps) / (bp * aux[0] + eps)) ** lanes * torch.exp(-aux[2])
        return torch.matmul(f_new, Hd.T)

    def fixed():
        return _sweep(H, w, f, aux, scale=scale, plan=plan, logarithmic=True, alpha=0.9, eps=eps)

    def scheduled(name=plan):
        return _sweep(H, w, f, aux, scale=scale, plan=name, logarithmic=True, eps=eps,
                      alpha_lane=lanes)

    fixed_ms, ms, turns = _in_turns(fixed, scheduled)
    versus = {}
    if plan != "two_read":
        old_ms, _, old_turns = _in_turns(lambda: scheduled("two_read"), scheduled)
        versus = dict(versus=dict(plan="two_read", ms=old_ms, turns_ms=old_turns,
                                  **_bound(H, w, aux + [lanes], scale, "two_read", rates)))
    out = dict(plan=plan, ms=ms, fixed_alpha_ms=fixed_ms, turns_ms=turns, **versus,
               device=_device_profile(scheduled),
               plain_ms=_median_ms(lambda: fused_sweep_reference(
                   H, w, f, aux, scale=scale, logarithmic=True, eps=eps, alpha_lane=lanes)),
               library_ms=_median_ms(library),
               **_bound(H, w, aux + [lanes], scale, plan, rates),
               shape=[*H.shape, w.shape[0]], storage=str(H.dtype)[6:], mode="log", pen=True)
    del Hd
    return out


# the scheduled log update's cases in the kernels phase: (storage, B) at
# 8192 x 65536, log with the penalty, each through plan_sweep's plan; the
# variants phase's paths run the B = 1 ones, int8's B = 4 and every B = 8
SCHED_CASES = tuple((st, B) for B in (1, 4, 8) for st in ("float32", "bfloat16", "int8"))


def kernel_phase(card: str):
    """Every check and timing of the fused sweep; returns ``(max_abs_err by
    row of the kernel table, timing by row)``."""
    import torch

    from sartsolver_tpu_torch.ops.fused_sweep import (
        ONE_READ_MAX_B, ONE_READ_MIN_P, STORAGE, TENSOR_CORE_MIN_B, _sweep, plan_sweep,
    )

    alpha, eps = 0.7, 1e-7
    rates = PEAKS["PCIe" if "PCIe" in card else "SXM"]
    checks, errors = [], {}

    def check(P, V, B, logarithmic, with_pen, storage, key=None, plan=None):
        H, w, f, aux, scale = _sweep_inputs(P, V, B, logarithmic, with_pen, storage=storage,
                                            seed=P + V + B + 2 * logarithmic + with_pen)
        kw = dict(logarithmic=logarithmic, alpha=alpha, eps=eps)
        record, err = _check_kernel(H, w, f, aux, scale, kw, storage, plan=plan)
        checks.append(record)
        if key is not None:
            errors[key] = max(errors.get(key, 0.0), err)

    # each storage type through its own plan at the main and a ragged shape
    for storage in STORAGES:
        for P, V, B in ((8192, 65536, 1), (1000, 3001, 3)):
            for logarithmic in (False, True):
                for with_pen in (False, True):
                    check(P, V, B, logarithmic, with_pen, storage,
                          key=storage if P == 8192 else None)
    # one_read for every storage at the GPU tests' shapes: the main shape, a
    # ragged P just under the limit, the rule's lower edge and a small shape
    # (forced where the rule leaves it to two_read); two_read forced where the
    # new plans took over; tensor_core at the shapes that select it
    for logarithmic in (False, True):
        for with_pen in (False, True):
            for storage in STORAGES:
                for P, V in ((8192, 65536), (8191, 4096), (ONE_READ_MIN_P[storage], 4096),
                             (1000, 3008)):
                    for B in ONE_READ_CHECK_B[storage]:
                        check(P, V, B, logarithmic, with_pen, storage, plan="one_read")
        # two_read forced where the other plans took over (B = 1 one_read,
        # B = 8), and at ragged shapes: B = 8, a tall P with V odd, and B = 40
        # (two passes of 32 batch rows)
        for storage in STORAGES:
            for P, V, B in ((8192, 65536, 1), (8192, 65536, FRAME_LANES), (1000, 3001, 8),
                            (9000, 3001, 3), (1000, 3001, 40)):
                check(P, V, B, logarithmic, True, storage, plan="two_read")
        # tensor_core for bf16 and int8 at the shapes that select it
        for storage in TC_STORAGES:
            for B in TENSOR_CORE_CHECK_B[storage]:
                check(8192, 65536, B, logarithmic, True, storage,
                      key=f"{storage}@B{B}" if B == FRAME_LANES else None)
            check(1000, 3008, 19, logarithmic, True, storage)
        # the frames phase's batches through each storage's plan, both
        # penalties (fp32 also its 16-lane run, two_read)
        for storage in STORAGES:
            for with_pen in (False, True):
                check(8192, 65536, FRAME_LANES, logarithmic, with_pen, storage,
                      key=f"{storage}@B{FRAME_LANES}")
        check(8192, 65536, SIXTEEN_LANES, logarithmic, True, "float32",
              key=f"float32@B{SIXTEEN_LANES}")
    torch.cuda.empty_cache()

    # timing at the main path's shape and mode: B = 1, linear with the
    # Laplacian penalty (the 8-frame runs); fp32's log mode beside it; each
    # in turns with forced two_read
    timing = {}
    for storage, logarithmic, with_pen in (("float32", False, True), ("float32", True, False),
                                           ("bfloat16", False, True), ("int8", False, True)):
        H, w, f, aux, scale = _sweep_inputs(8192, 65536, 1, logarithmic, with_pen, seed=7,
                                            storage=storage)
        kw = dict(logarithmic=logarithmic, alpha=1.0, eps=eps)
        key = storage if not logarithmic else "float32_log"
        timing[key] = _timing(H, w, f, aux, scale, kw, rates,
                              plan_sweep(8192, 65536, 1, storage), versus="two_read")
        del H, w, f, aux, scale
        torch.cuda.empty_cache()

    # each storage's plan at the frames phase's batch, linear with the
    # penalty (the batch loops' runs) and log, in turns with forced two_read;
    # fp32 at B = 5 (one_read's smallest new instance) and bf16 at B = 32
    # (tensor_core) beside two_read too, fp32 at B = 16 (two_read, two tiles
    # of 8: the frames phase's 16-lane run) alone
    for storage, B, logarithmic in ([(st, FRAME_LANES, lg) for st in STORAGES
                                     for lg in (False, True)]
                                    + [("float32", 5, False), ("bfloat16", 32, False),
                                       ("float32", SIXTEEN_LANES, False)]):
        H, w, f, aux, scale = _sweep_inputs(8192, 65536, B, logarithmic,
                                            not logarithmic, seed=9, storage=storage)
        kw = dict(logarithmic=logarithmic, alpha=1.0, eps=eps)
        key = f"{storage}@B{B}" + ("_log" if logarithmic else "")
        plan = plan_sweep(8192, 65536, B, storage)
        timing[key] = _timing(H, w, f, aux, scale, kw, rates, plan,
                              versus=None if plan == "two_read" else "two_read")
        del H, w, f, aux, scale
        torch.cuda.empty_cache()

    # two_read's own rows, linear with the penalty: checked and timed beside
    # the bound, the two-read floor and the library; the inputs are made on
    # the card and freed before the next row
    for storage, P, V, B in TWO_READ_ROWS:
        key = f"{storage}@{P}x{V}xB{B}"
        H, w, f, aux, scale = _sweep_inputs(P, V, B, False, True, seed=40 + B, storage=storage)
        kw = dict(logarithmic=False, alpha=1.0, eps=eps)
        record, err = _check_kernel(H, w, f, aux, scale, kw, storage, plan="two_read")
        checks.append(record)
        errors[key] = err
        torch.cuda.empty_cache()
        timing[key] = _timing(H, w, f, aux, scale, kw, rates, "two_read")
        del H, w, f, aux, scale
        gc.collect()
        torch.cuda.empty_cache()
    # one pass over H for every batch row: a call launches the same CUDA
    # kernels at B = 1, 16 and 32
    names = {1: _kernel_names(timing["float32"]["versus"]["device"]),  # forced beside one_read
             SIXTEEN_LANES: _kernel_names(timing[f"float32@B{SIXTEEN_LANES}"]["device"]),
             THIRTY_TWO_LANES: _kernel_names(
                 timing[f"float32@8192x65536xB{THIRTY_TWO_LANES}"]["device"])}
    if len({tuple(n) for n in names.values()}) != 1:
        raise AssertionError(f"two_read launches other kernels at other B: {names}")
    two_read_kernels = names[1]

    # the scheduled log update (one exponent per row, each row's distinct)
    # on each plan against the plain version, then timed in turns with the
    # fixed-exponent log sweep
    for storage, B in SCHED_CASES:
        plan = plan_sweep(8192, 65536, B, storage)
        H, w, f, aux, scale = _sweep_inputs(8192, 65536, B, True, True, seed=30 + B,
                                            storage=storage)
        lanes = _lanes(B)
        kw = dict(logarithmic=True, alpha=alpha, eps=eps, alpha_lane=lanes)
        record, err = _check_kernel(H, w, f, aux, scale, kw, storage, plan=plan)
        checks.append(dict(record, alpha_lane=B))
        key = f"sched_{storage}@B{B}"
        errors[key] = err
        timing[key] = _sched_timing(H, w, f, aux, scale, lanes, eps, rates, plan)
        del H, w, f, aux, scale, lanes
        torch.cuda.empty_cache()

    # B4 at the three int8 probes' configuration: checked through
    # tensor_core and forced two_read, then timed in turns
    for k, (name, _, direct) in enumerate(PROBES):
        H, w, f, aux, scale = _probe_inputs(direct, seed=11 + k)
        kw = dict(logarithmic=False)
        record, err = _check_kernel(H, w, f, aux, scale, kw, "int8")
        old, _ = _check_kernel(H, w, f, aux, scale, kw, "int8", plan="two_read")
        checks += [dict(record, probe=name), dict(old, probe=name)]
        timing[name] = dict(_timing(H, w, f, aux, scale, kw, rates, "tensor_core",
                                    versus="two_read"),
                            max_abs_err=err,
                            max_rel_err=dict(tensor_core=record["max_rel_err"],
                                             two_read=old["max_rel_err"]))
        del H, w, f, aux, scale
        torch.cuda.empty_cache()

    def crossover(points, storage, with_pen, plans):
        """The plans timed in turns at each (P, V, B), linear: in order,
        then in reverse, each reported as the mean of its two medians;
        ``plans(B)`` names them at batch size B."""
        out = []
        for P, V, B in points:
            H, w, f, aux, scale = _sweep_inputs(P, V, B, False, with_pen, seed=20 + B,
                                                storage=storage)

            def run(plan):
                return lambda: _sweep(H, w, f, aux, scale=scale, plan=plan,
                                      logarithmic=False)
            names = plans(B)
            order = list(names) + list(reversed(names))
            ms = [_median_ms(run(plan)) for plan in order]
            point = {"P": P, "V": V, "B": B}
            for plan in names:
                point[f"{plan}_ms"] = statistics.mean(
                    m for m, name in zip(ms, order) if name == plan)
            out.append(point)
            del H, w, f, aux, scale
            torch.cuda.empty_cache()
        return out

    # two_read against tensor_core over B, 8192 x 65536, int8 and bf16, no
    # penalty (the probes' mode); two_read against one_read over P, V and B
    # for each storage with the penalty (the main path's mode; fp32 B = 1..8,
    # the others 1..4), with tensor_core beside for bf16 and int8 from B = 2
    def one_read_plans(storage):
        def plans(B):
            extra = ("tensor_core",) if storage in TC_STORAGES and B >= 2 else ()
            return ("two_read", "one_read") + extra
        return plans

    crossovers = dict(tensor_core=crossover([(8192, 65536, B) for B in TC_CROSSOVER_B],
                                            "int8", False,
                                            lambda B: ("two_read", "tensor_core")),
                      tensor_core_bfloat16=crossover(
                          [(8192, 65536, B) for B in TC_CROSSOVER_B], "bfloat16",
                          False, lambda B: ("two_read", "tensor_core")))
    for storage in STORAGES:
        crossovers[f"one_read_{storage}"] = crossover(
            [(P, V, B) for P, V in ONE_READ_CROSSOVER_PV
             for B in range(1, ONE_READ_MAX_B[storage] + 1)],
            storage, True, one_read_plans(storage))
    edges = {storage: one_read_edge(crossovers[f"one_read_{storage}"])
             for storage in STORAGES}
    tc_edges = {storage: tensor_core_edge(crossovers[name]) for storage, name in
                (("int8", "tensor_core"), ("bfloat16", "tensor_core_bfloat16"))}

    from sartsolver_tpu_torch.ops import _build

    clusters = _build.load("fused_sweep").sart_one_read_clusters
    clusters.argtypes, clusters.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    emit("kernels", list=[{"name": "fused_sweep", "status": "ok", "checks": checks,
                              "tolerance": KERNEL_TOL, "timing": timing,
                              "launches_per_iteration": 1}],
         crossover=crossovers, one_read_edge_measured=edges,
         tensor_core_min_b_measured=tc_edges,
         one_read_rule=dict(min_p=ONE_READ_MIN_P, max_b=ONE_READ_MAX_B,
                            tensor_core_min_b=TENSOR_CORE_MIN_B),
         one_read_clusters={storage: {B: clusters(STORAGE[getattr(torch, storage)], B)
                                      for B in range(1, ONE_READ_MAX_B[storage] + 1)}
                            for storage in STORAGES},
         two_read_kernels_at_b1_16_32=two_read_kernels,
         peak_mem_rate=rates[0], peak_fp32_rate=rates[1],
         peak_bf16_tensor_rate=rates[2],
         library_note="two torch.matmul on an fp32 copy of the dequantized "
                      "matrix: 4 bytes per element for every storage")
    return errors, timing


def tensor_core_edge(table):
    """From a tensor_core crossover table over B: the smallest B from which
    tensor_core beat two_read at every larger B of the table (None where it
    lost at the largest)."""
    lowest = None
    for r in sorted(table, key=lambda r: -r["B"]):
        if not r["tensor_core_ms"] < r["two_read_ms"]:
            break
        lowest = r["B"]
    return lowest


def one_read_edge(table) -> dict:
    """From one storage's one_read crossover table at V = 65536: the
    smallest P from which one_read beat two_read at every B and every larger
    P of the table (None where it lost at the largest), and where
    tensor_core was timed beside it, the same edge against tensor_core for
    each B."""
    rows = [r for r in table if r["V"] == 65536]

    def edge(beats):
        lowest = None
        for P in sorted({r["P"] for r in rows}, reverse=True):
            if not all(beats(r) for r in rows if r["P"] == P):
                break
            lowest = P
        return lowest

    out = {"min_p": edge(lambda r: r["one_read_ms"] < r["two_read_ms"])}
    timed = sorted({r["B"] for r in rows if "tensor_core_ms" in r})
    if timed:
        out["over_tensor_core_min_p"] = {
            B: edge(lambda r, B=B: r["B"] != B or r["one_read_ms"] < r["tensor_core_ms"])
            for B in timed}
    return out


# ---- phase operators: the factored RTM and the matrix-free operator ------

OPERATOR_FIT_TOL = 5e-3  # an operator run against its dense twin, fitted space
LOWRANK_RANK = 4  # the rank the reflective world's residual has
IMPLICIT_SOURCE = "sartsolver_tpu_torch/ops/csrc/implicit.cu"
IMPLICIT_REPLACES = ("none: sartsolver_tpu/operators/implicit.py:117-227 rebuilds H in "
                     "plain XLA (no pallas_call)")
# fp32 arithmetic an entry costs in seg_length (ops/csrc/implicit.cu),
# counted from the source: per axis two __fsub_rn, two __fmul_rn, fminf and
# fmaxf (18); the folds of near and far over the axes (4); the clamp of the
# entry at 0, the segment's __fsub_rn and its clamp (3). The bound counts it
# for the nonzero entries only, the work the inputs need, with a multiply
# and an add a batch row: (IMPLICIT_OPS_PER_ENTRY + 2 B) nnz
IMPLICIT_OPS_PER_ENTRY = 25
IMPLICIT_ENTRY_BLOCK = 512  # columns a one-hot forward holds (every entry checked)
# the wide geometry world, kernel only: 128 x 128 x 64 voxels, two 256 x 256
# cameras (P = 131,072, V = 1,048,576; its fp32 matrix would be 512 GiB)
IMPLICIT_WIDE = dict(nx=128, ny=128, nz=64, cam=(256, 256))
IMPLICIT_WIDE_CHECK = 64  # columns, and rays of the restricted forward
IMPLICIT_WIDE_ROWS = 8  # rows held bit for bit


def _timing_rows(text: str) -> dict:
    """``--timing``'s phase rows, ms by name."""
    return {m.group(1).strip(): float(m.group(2))
            for m in re.finditer(r"^  (\S.*?)\s+([0-9.]+) ms", text, re.M)}


def _operator_run(argv, world, n_frames, device, launches=None) -> tuple:
    """One CLI run of the phase: ``(record, solution)`` — exit code, ms per
    frame, iterations, statuses, fitted errors, the wall's split from
    ``--timing``, peak device bytes; ``launches`` a callable returning the
    implicit kernel's counts, zeroed before and read after."""
    import torch

    from sartsolver_tpu_torch.operators import implicit as im

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    im.reset_launch_counts()
    t0 = time.perf_counter()
    rc, ms, text = run_cli([*argv, "--timing"], device)
    wall = time.perf_counter() - t0
    rec = dict(exit=rc, wall_s=wall, frame_ms=ms, timing_ms=_timing_rows(text),
               implicit_launches={"forward": im.implicit_forward.launches,
                                  "back": im.implicit_back.launches})
    if device == "cuda":
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated() - base
    line = [ln for ln in text.splitlines() if ln.startswith(("lowrank:", "implicit:"))]
    rec["operator_line"] = line[0] if line else None
    if rc != 0:
        return rec, None
    out = argv[argv.index("-o") + 1]
    sol, err = check_solution(out, world, n_frames, MAX_ITERATIONS, device, fit_bound=None)
    rec.update(iterations=sol["iterations"].tolist(), status=sol["status"].tolist(),
               fit_err=err.tolist(), ms_per_frame=sum(ms) / max(len(ms), 1))
    return rec, sol


def _pair(world, a, b, device) -> dict:
    """An operator run against its dense twin: statuses equal, fitted
    distance (relative, per frame) within ``OPERATOR_FIT_TOL``."""
    d = _fitted_distance(world, a["value"], b["value"], device)
    if a["status"].tolist() != b["status"].tolist() or not (np.asarray(d) <= OPERATOR_FIT_TOL).all():
        raise AssertionError(f"operator run against its dense twin: statuses "
                             f"{a['status'].tolist()} / {b['status'].tolist()}, fitted "
                             f"distance {d}")
    return dict(fitted_distance=[float(x) for x in np.atleast_1d(d)])


def _resident(op, storage, device) -> dict:
    """The factored solver's device bytes at ``storage``: the held matrix (S's
    occupied columns), the factors, the allocation after construction."""
    import torch

    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
    opts = SolverOptions(rtm_dtype=None if storage == "float32" else storage)
    with DistributedSARTSolver(operator=op, opts=opts, device=device) as solver:
        pr = solver.problem
        rec = dict(held_shape=list(pr.rtm.shape),
                   matrix_bytes=pr.rtm.numel() * pr.rtm.element_size(),
                   factor_bytes=sum(t.numel() * t.element_size() for t in (
                       pr.factor_u, pr.factor_v, pr.factor_scale) if t is not None))
        if device == "cuda":
            torch.cuda.synchronize()
            rec["resident_device_bytes"] = torch.cuda.memory_allocated() - mem0
    P, V = op.shape
    rec["dense_matrix_bytes"] = P * V * {"float32": 4, "bfloat16": 2, "int8": 1}[storage]
    rec["matrix_fraction_of_dense"] = rec["matrix_bytes"] / rec["dense_matrix_bytes"]
    return rec


def _implicit_work(rays, spec) -> dict:
    """What the projector's kernel does on these rays, counted by its plain
    mirror (``operators/implicit.py:candidate_cells``, ``tile_survivors``)
    on the card: the pairs each entry point evaluates, the back's cull
    tests, and the nonzero entries (the candidates' entries through
    ``pair_lengths``, the plain version's arithmetic)."""
    import torch

    from sartsolver_tpu_torch.operators import implicit as im

    rows = im.candidate_cells(rays, spec)
    forward = int((rows[:, 4] - rows[:, 3] + 1).sum())
    nnz = 0
    for r0 in range(0, len(rows), 1 << 18):
        ray, vox = im.candidate_pairs(rows[r0:r0 + (1 << 18)], spec)
        nnz += int((im.pair_lengths(rays, ray, vox, spec) != 0).sum())
    tiles = im.tile_survivors(rays, spec)
    back = int((tiles["survivors"] * tiles["cells"]).sum())
    torch.cuda.synchronize()
    return dict(nnz=nnz, forward_pairs=forward, back_pairs=back, brick=list(tiles["brick"]),
                chunk_tests=tiles["chunk_tests"], ray_tests=tiles["ray_tests"],
                rays_with_candidates=int(len(torch.unique(rows[:, 0]))))


def _implicit_bound(which, P, V, B, nnz, rates) -> dict:
    """The least time of one projection: its bytes (the [P, 6] rays, the
    operand and the output once) at the memory rate against the operations
    its nonzero entries need at the fp32 rate."""
    mem_rate, fp32_rate, _ = rates
    n_in, n_out = (V, P) if which == "forward" else (P, V)
    ops = (IMPLICIT_OPS_PER_ENTRY + 2 * B) * nnz
    nbytes = 4 * (6 * P + B * n_in + B * n_out)
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, ops / fp32_rate * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", ops=ops, bytes=nbytes)


def _implicit_kernels(gw, rates, launches) -> dict:
    """The projector's entry points at the geometry world's shape, B = 1 and
    8: every entry (5.4e8) bit for bit through one-hot forwards of
    ``IMPLICIT_ENTRY_BLOCK`` columns against the dense twin's matrix (the
    plain version's entries), the sums within ``KERNEL_TOL`` of the
    output's max against the plain version on the card, two calls
    byte-identical; ms, the bound (:func:`_implicit_bound`), the pairs
    evaluated (:func:`_implicit_work`), the plain version's ms and the
    library's (``torch.matmul`` on the materialized fp32 matrix)."""
    import torch

    from sartsolver_tpu_torch.operators import implicit as im
    from sartsolver_tpu_torch.operators.geometry import load_geometry

    rec = load_geometry(gw["geometry"])
    op = im.ImplicitOperator(rec)
    spec = op.spec(padded_nvoxel=rec.nvoxel, panel_voxels=im.divisor_panel(rec.nvoxel))
    rays = torch.as_tensor(op.payload()).cuda()
    P, V = rec.npixel, rec.nvoxel
    H = torch.as_tensor(gw["H"], device="cuda")
    t0 = time.perf_counter()
    for c0 in range(0, V, IMPLICIT_ENTRY_BLOCK):
        n = min(IMPLICIT_ENTRY_BLOCK, V - c0)
        f = torch.zeros((n, V), device="cuda")
        f[torch.arange(n), c0 + torch.arange(n)] = 1.0
        if not torch.equal(im.implicit_forward(rays, f, spec), H[:, c0:c0 + n].T):
            raise AssertionError(f"implicit entries of columns [{c0}, {c0 + n}) differ from "
                                 "the plain version's")
    work = _implicit_work(rays, spec)
    nnz = int((H != 0).sum())
    if work["nnz"] != nnz:
        raise AssertionError(f"the mirror's nonzero entries {work['nnz']} != the matrix's {nnz}")
    out = {"entries_checked": P * V, "entries_seconds": time.perf_counter() - t0,
           "nnz_fraction": nnz / (P * V), "work": work}
    g = torch.Generator(device="cuda").manual_seed(14)
    for which in ("forward", "back"):
        for B in (1, 8):
            n_in = V if which == "forward" else P
            x = torch.rand((B, n_in), generator=g, device="cuda")
            fn = im.implicit_forward if which == "forward" else im.implicit_back
            ref = im._forward_reference if which == "forward" else im._back_reference
            got = fn(rays, x, spec)
            again = fn(rays, x, spec)
            plain = ref(rays, x, spec, torch.float32)
            torch.cuda.synchronize()
            scale = float(plain.abs().max())
            err = float((got - plain).abs().max()) / max(scale, 1e-30)
            if not torch.equal(got, again) or err > KERNEL_TOL:
                raise AssertionError(f"implicit_{which} B={B}: error {err} or two calls differ")
            lib = (lambda: x @ H.T) if which == "forward" else (lambda: x @ H)
            out[f"{which}@B{B}"] = dict(
                shape=[P, V, B], max_abs_err=err * scale, rel_err=err,
                ms=_median_ms(lambda: fn(rays, x, spec)),
                plain_ms=_median_ms(lambda: ref(rays, x, spec, torch.float32), reps=3),
                library_ms=_median_ms(lib), launches=launches[which],
                pairs_evaluated=work[f"{which}_pairs"], nnz=nnz,
                **_implicit_bound(which, P, V, B, nnz, rates))
    del H
    return out


def _implicit_wide(rates) -> dict:
    """The projector on the wide geometry world (``IMPLICIT_WIDE``), kernel
    only: no CLI run, no plain-version timing (a plain projection would take
    minutes) and no library call (the fp32 matrix would be 512 GiB).
    ``IMPLICIT_WIDE_ROWS`` rows bit-equal to the plain version's on the CPU
    (one-hot back projections against ``panel_lengths`` of those rays),
    ``IMPLICIT_WIDE_CHECK`` columns bit-equal (one-hot forwards), the
    forward of a random operand on ``IMPLICIT_WIDE_CHECK`` rays and its
    back projection on as many voxels within ``KERNEL_TOL`` of the plain
    version on the card; forward and back at B = 1 and 8: ms, the bound, the
    pairs evaluated, two calls byte-identical."""
    import torch

    from sartsolver_tpu_torch.operators import implicit as im

    t_start = time.perf_counter()
    rec = geometry_record(IMPLICIT_WIDE["nx"], IMPLICIT_WIDE["ny"], IMPLICIT_WIDE["nz"],
                          cam=IMPLICIT_WIDE["cam"])
    op = im.ImplicitOperator(rec)
    spec = op.spec(padded_nvoxel=rec.nvoxel, panel_voxels=im.divisor_panel(rec.nvoxel))
    rays_h = torch.as_tensor(op.payload())
    rays = rays_h.cuda()
    P, V = rec.npixel, rec.nvoxel
    t0 = time.perf_counter()
    work = _implicit_work(rays, spec)
    out = {"shape": [P, V], "work": work, "mirror_seconds": time.perf_counter() - t0,
           "nnz_fraction": work["nnz"] / (P * V),
           "library": "none: the fp32 matrix would be 512 GiB",
           "plain": "not run at this size"}
    rng = np.random.default_rng(15)
    seen = torch.unique(im.candidate_cells(rays, spec)[:, 0]).cpu()
    rows = seen[torch.as_tensor(np.linspace(0, len(seen) - 1, IMPLICIT_WIDE_ROWS).astype(np.int64))]
    w = torch.zeros((len(rows), P), device="cuda")
    w[torch.arange(len(rows)), rows.cuda()] = 1.0
    want = im.panel_lengths(rays_h[rows], 0, spec, V)  # [rows, V] on the CPU
    if not torch.equal(im.implicit_back(rays, w, spec).cpu(), want):
        raise AssertionError(f"wide world: the entries of rows {rows.tolist()} differ")
    cols = torch.as_tensor(np.sort(rng.choice(rec.nvoxel, IMPLICIT_WIDE_CHECK, replace=False)))
    f = torch.zeros((len(cols), V), device="cuda")
    f[torch.arange(len(cols)), cols.cuda()] = 1.0
    want = torch.cat([im.panel_lengths(rays_h, int(c), spec, 1) for c in cols], dim=1)
    if not torch.equal(im.implicit_forward(rays, f, spec).cpu(), want.T.contiguous()):
        raise AssertionError(f"wide world: the entries of columns {cols.tolist()} differ")
    out.update(rows_checked=rows.tolist(), columns_checked=cols.tolist())
    # the sums on a few rays (forward) and a few voxels (back) against the plain version
    pick = rows.new_tensor(np.sort(rng.choice(seen.numpy(), IMPLICIT_WIDE_CHECK, replace=False)))
    x = torch.as_tensor(rng.random((1, V), dtype=np.float32), device="cuda")
    got = im.implicit_forward(rays, x, spec)[:, pick.cuda()]
    plain = im._forward_reference(rays[pick.cuda()], x, spec, torch.float32)
    y = torch.as_tensor(rng.random((1, P), dtype=np.float32), device="cuda")
    got_b = im.implicit_back(rays, y, spec)[:, cols.cuda()]
    plain_b = y @ torch.cat([im.panel_lengths(rays, int(c), spec, 1) for c in cols], dim=1)
    errs = []
    for a, b in ((got, plain), (got_b, plain_b)):
        scale = float(b.abs().max())
        errs.append(float((a - b).abs().max()) / max(scale, 1e-30))
    if max(errs) > KERNEL_TOL:
        raise AssertionError(f"wide world: restricted forward / back errors {errs}")
    out["restricted_rel_err"] = {"forward": errs[0], "back": errs[1]}
    g = torch.Generator(device="cuda").manual_seed(15)
    for which in ("forward", "back"):
        fn = im.implicit_forward if which == "forward" else im.implicit_back
        for B in (1, 8):
            x = torch.rand((B, V if which == "forward" else P), generator=g, device="cuda")
            if not torch.equal(fn(rays, x, spec), fn(rays, x, spec)):
                raise AssertionError(f"wide world: implicit_{which} B={B}: two calls differ")
            out[f"{which}@B{B}"] = dict(
                shape=[P, V, B], ms=_median_ms(lambda: fn(rays, x, spec)),
                pairs_evaluated=work[f"{which}_pairs"], nnz=work["nnz"],
                **_implicit_bound(which, P, V, B, work["nnz"], rates))
    out["seconds"] = time.perf_counter() - t_start
    return out


def operators_phase(outdir: str, world=None, device: str = "cuda", rates=None,
                    reflective_kw=None, geometry_kw=None, reflective=None,
                    keep_geometry: Optional[dict] = None) -> dict:
    """The operator backends through the CLI (phase ``operators``).

    The reflective world (:func:`write_reflective_world`; the e2e world's
    size at the defaults), per storage: ``--lowrank_rtm auto`` against
    ``off`` on the same files, linear over 8 frames (the chain) and log over
    4; fp32 also ``--lowrank_rtm 4``, ``--no_guess --batch_frames 8`` and
    ``--os_subsets 4`` against ``off``; ``auto`` takes rank 4 in every run,
    the statuses equal the dense twin's and the fitted distance is within
    ``OPERATOR_FIT_TOL``; ``--lowrank_rtm 2`` exits 1 with the gate's words.
    The factorization once through the gate with its seconds (read, split,
    rSVD, the parity gate's two solves), and per storage the factored
    solver's held matrix and factor bytes against the dense matrix's (fp32
    at most 0.55 of it). With ``world`` (the e2e world), ``auto`` declines
    loudly on it once.

    The geometry world (:func:`write_geometry_world`): ``--geometry`` fp32
    linear (8 frames) and log (4), ``--no_guess --batch_frames 8`` and
    ``--os_subsets 4``, each against the dense CLI on the materialized
    matrix's files: statuses equal, fitted distance within
    ``OPERATOR_FIT_TOL``, on the card the projector's launches above 0 in
    every run; ``--rtm_dtype int8 --geometry`` exits 1. On the card with
    ``rates``, the projector's kernel table (:func:`_implicit_kernels`) and
    the wide geometry world, kernel only (:func:`_implicit_wide`). Each
    world's files are deleted at its end (the geometry world's kept, and put
    into ``keep_geometry["world"]``, where that dict is given: the ``serve``
    phase serves it). ``reflective``: the reflective
    world already written under ``outdir/reflective`` with its
    ``world_seconds`` (the script writes it during the build), else it is
    written here."""
    import shutil

    import torch

    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.parallel.multihost import lowrank_operator_or_decline

    out = {"reflective": {}, "geometry": {}}
    rdir = os.path.join(outdir, "reflective")
    rw = reflective
    if rw is None:
        t0 = time.perf_counter()
        rw = write_reflective_world(rdir, **(reflective_kw or {}))
        rw["world_seconds"] = time.perf_counter() - t0
    p = rw["paths"]
    P, V = rw["H"].shape
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    files = {"camA": [p["rtm_a_seg1"], p["rtm_a_seg2"]], "camB": [p["rtm_b"]]}
    rec = out["reflective"]
    rec["world_seconds"] = rw["world_seconds"]
    rec["shape"] = [P, V]
    # the gate once, timed by its parts
    clock = {}
    t0 = time.perf_counter()
    op = lowrank_operator_or_decline(SolverOptions(lowrank_rtm="auto"), files,
                                     "with_reflections", P, V, device=device, timings=clock)
    clock["total_s"] = time.perf_counter() - t0
    if op is None or op.rank != LOWRANK_RANK:
        raise AssertionError(f"lowrank 'auto' on the reflective world: {op}")
    occ = op.tile_occupancy()
    rec["factorization"] = dict(clock, rank=op.rank, core_occupancy=occ.occupancy_fraction(),
                                held_columns=int(len(op.occupied_columns())))
    rec["resident"] = {st: _resident(op, st, device) for st in STORAGES}
    if rec["resident"]["float32"]["matrix_fraction_of_dense"] > 0.55:
        raise AssertionError(f"factored fp32 holds {rec['resident']['float32']}")
    del op
    base = ["-m", str(MAX_ITERATIONS)]
    runs = [(st, name, flags, n) for st in STORAGES for name, flags, n in (
        ("linear", ["-t", "0:0.75"], 8), ("log", ["-L", "-t", "0:0.35"], 4))]
    runs += [("float32", "batch", ["--no_guess", "--batch_frames", str(FRAME_LANES)],
              rw["G"].shape[1]),
             ("float32", "os", ["--os_subsets", str(OS_SUBSETS), "-t", "0:0.75"], 8)]
    for st, name, flags, n in runs:
        sols, pair = {}, {}
        for mode in ("auto", "off"):
            o = os.path.join(rdir, f"{st}_{name}_{mode}.h5")
            pair[mode], sols[mode] = _operator_run(
                ["-o", o, *inputs, *base, *flags, "--rtm_dtype", st, "--lowrank_rtm", mode],
                rw, n, device)
            if pair[mode]["exit"] != 0:
                raise AssertionError(f"reflective {st} {name} {mode}: {pair[mode]}")
        if f"rank={LOWRANK_RANK} " not in (pair["auto"]["operator_line"] or ""):
            raise AssertionError(f"reflective {st} {name}: {pair['auto']['operator_line']}")
        rec[f"{st}_{name}"] = dict(factored=pair["auto"], dense=pair["off"],
                                   **_pair(rw, sols["auto"], sols["off"], device))
    o = os.path.join(rdir, "rank4.h5")
    r4, s4 = _operator_run(["-o", o, *inputs, *base, "-t", "0:0.75", "--lowrank_rtm",
                            str(LOWRANK_RANK)], rw, 8, device)
    rec["float32_rank4"] = dict(factored=r4, **_pair(rw, s4, _read_rows_sol(
        os.path.join(rdir, "float32_linear_off.h5")), device))
    rc, _ms, text = run_cli(["-o", os.path.join(rdir, "rank2.h5"), *inputs, "--lowrank_rtm",
                             "2"], device)
    rec["rank2_exit"] = rc
    if rc != 1:
        raise AssertionError(f"--lowrank_rtm 2 exited {rc}")
    shutil.rmtree(rdir)
    if world is not None:
        wp = world["paths"]
        t0 = time.perf_counter()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, _ms, _text = run_cli(["-o", os.path.join(outdir, "decline.h5"), wp["rtm_a_seg1"],
                                      wp["rtm_a_seg2"], wp["rtm_b"], wp["img_a"], wp["img_b"],
                                      "-t", "0:0.05", "--lowrank_rtm", "auto"], device)
        warn = [ln for ln in err.getvalue().splitlines() if "lowrank_rtm declines" in ln]
        if rc != 0 or not warn:
            raise AssertionError(f"'auto' on the e2e world: exit {rc}, {err.getvalue()[-400:]}")
        rec["e2e_auto_declines"] = dict(seconds=time.perf_counter() - t0, warning=warn[0])

    # the geometry world
    gdir = os.path.join(outdir, "geometry")
    t0 = time.perf_counter()
    gw = write_geometry_world(gdir, device=device, **(geometry_kw or {}))
    g = out["geometry"]
    g["world_seconds"] = time.perf_counter() - t0
    g["shape"] = list(gw["H"].shape)
    gp = gw["paths"]
    launches = {"forward": 0, "back": 0}
    for name, flags, n in (("linear", ["-t", "0:0.75"], 8), ("log", ["-L", "-t", "0:0.35"], 4),
                           ("batch", ["--no_guess", "--batch_frames", str(FRAME_LANES)],
                            gw["G"].shape[1]),
                           ("os", ["--os_subsets", str(OS_SUBSETS), "-t", "0:0.75"], 8)):
        imp, s_imp = _operator_run(["-o", os.path.join(gdir, f"{name}_implicit.h5"),
                                    "--geometry", gw["geometry"], gp["img_a"], gp["img_b"],
                                    *base, *flags], gw, n, device)
        dense, s_dense = _operator_run(["-o", os.path.join(gdir, f"{name}_dense.h5"),
                                        *gw["inputs"], *base, *flags], gw, n, device)
        if imp["exit"] != 0 or dense["exit"] != 0:
            raise AssertionError(f"geometry {name}: {imp} / {dense}")
        if device == "cuda" and min(imp["implicit_launches"].values()) <= 0:
            raise AssertionError(f"geometry {name}: no projector launch {imp}")
        for k in launches:
            launches[k] += imp["implicit_launches"][k]
        g[name] = dict(implicit=imp, dense=dense, **_pair(gw, s_imp, s_dense, device))
    rc, _ms, _text = run_cli(["-o", os.path.join(gdir, "int8.h5"), "--geometry",
                              gw["geometry"], gp["img_a"], gp["img_b"], "--rtm_dtype", "int8"],
                             device)
    g["int8_exit"] = rc
    if rc != 1:
        raise AssertionError(f"--rtm_dtype int8 --geometry exited {rc}")
    g["launches"] = launches
    if device == "cuda" and rates is not None:
        out["kernels"] = _implicit_kernels(gw, rates, launches)
    if keep_geometry is None:
        shutil.rmtree(gdir)
    else:
        keep_geometry["world"] = gw
    if device == "cuda" and rates is not None:
        del gw
        gc.collect()
        torch.cuda.empty_cache()
        out["wide"] = _implicit_wide(rates)
    return out


def _read_rows_sol(path):
    from sartsolver_tpu_torch.io import h5

    with h5.File(path, "r") as f:
        return {k: f["solution"][k][:] for k in f["solution"]}


def batch_phase(world, lap, device="cuda") -> dict:
    """The world's 32 frames at once through the solver API with int8
    storage (B = 32, so the tensor_core plan), then through the plain
    version; returns the phase record."""
    import torch

    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.models.sart import (
        make_problem, prepare_measurement, solve_normalized_batch,
    )
    from sartsolver_tpu_torch.ops.fused_sweep import (
        fused_sweep, fused_sweep_reference, reset_launch_counts,
    )

    opts = SolverOptions(max_iterations=MAX_ITERATIONS, rtm_dtype="int8")
    problem = make_problem(world["H"], lap, opts=opts, device=device)
    G = world["G"]  # [P, T]
    T = G.shape[1]
    gs, msqs, norms = zip(*(prepare_measurement(G[:, t].astype(np.float64), opts)
                            for t in range(T)))
    g = torch.as_tensor(np.stack(gs), device=device).float()
    msq = torch.tensor(msqs, device=device).float()
    f0 = torch.zeros((T, world["H"].shape[1]), device=device)
    H = torch.as_tensor(world["H"], device=device)
    norm = torch.tensor(norms, device=device).float()[:, None]

    def run(fn, run_opts):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve_normalized_batch(problem, g, msq, f0, opts=run_opts, use_guess=True,
                                     device=device, sweep_fn=fn)
        torch.cuda.synchronize()
        return dict(wall_s=time.perf_counter() - t0,
                    by_plan=dict(fused_sweep.launches_by_plan),
                    iters=res.iterations.cpu().numpy(), status=res.status.cpu().numpy(),
                    fitted=H @ (res.solution * norm).T)

    def rel(a, b):
        return ((a - b).norm(dim=0) / b.norm(dim=0)).cpu().numpy()

    k, q = run(fused_sweep, opts), run(fused_sweep_reference, opts)
    by_plan, iters, status = k["by_plan"], k["iters"], k["status"]
    loops = int(iters.max())
    if by_plan["tensor_core"] != loops or sum(by_plan.values()) != loops:
        raise AssertionError(f"batch solve made {by_plan} launches for {loops} loop iterations")
    truth = torch.as_tensor(world["f_true"][:, None] * world["scales"][None, :T],
                            dtype=torch.float32, device=device)
    ref = H @ truth
    for name, r in (("kernel", k), ("plain", q)):
        ok = (r["status"] == 0) | ((r["status"] == -1) & (r["iters"] == MAX_ITERATIONS))
        err = rel(r["fitted"], ref)
        if not ok.all() or not bool(torch.isfinite(r["fitted"]).all()) \
                or not (err <= FIT_BOUND).all():
            raise AssertionError(f"batch {name} solve: statuses {r['status']} iterations "
                                 f"{r['iters']}, fitted-space errors {err} (bound {FIT_BOUND})")
        r["err"] = err
    if (status != q["status"]).any():
        raise AssertionError(f"batch kernel vs plain: statuses {status}/{q['status']}")
    # The stall test stops fp32 solves up to a few iterations apart when
    # their sums are taken in another order, so the kernel is held to the
    # plain version over a fixed count of iterations (no stall test)
    fixed = SolverOptions(max_iterations=BATCH_CROSS_ITERATIONS, rtm_dtype="int8",
                          conv_tolerance=0.0)
    kf, qf = run(fused_sweep, fixed), run(fused_sweep_reference, fixed)
    diff = rel(kf["fitted"], qf["fitted"])
    if (kf["iters"] != qf["iters"]).any() or not (diff <= CROSS_TOL).all():
        raise AssertionError(f"batch kernel vs plain over {BATCH_CROSS_ITERATIONS} "
                             f"iterations: {kf['iters']}/{qf['iters']}, fitted {diff}")
    apart = np.abs(iters.astype(np.int64) - q["iters"].astype(np.int64))
    record = dict(frames=T, storage="int8", loop_iterations=loops,
                  launches_by_plan=by_plan, wall_s=k["wall_s"],
                  ms_per_iteration=k["wall_s"] * 1e3 / loops,
                  iterations=iters.tolist(), status=status.tolist(),
                  fit_err_max=float(k["err"].max()), fit_err_min=float(k["err"].min()),
                  plain=dict(wall_s=q["wall_s"], iterations=q["iters"].tolist(),
                             iterations_apart_max=int(apart.max()),
                             fitted_rel_diff_max=float(rel(k["fitted"], q["fitted"]).max())),
                  fixed_iterations=dict(iterations=BATCH_CROSS_ITERATIONS, tolerance=CROSS_TOL,
                                        fitted_rel_diff_max=float(diff.max())))
    del problem, H
    torch.cuda.empty_cache()
    return record


def _range_device_ms(prof, ranges) -> dict:
    """Device ms of the CUDA kernels launched inside each named
    ``record_function`` range (the kernels linked to the range's ops, summed
    down its tree), summed over the range's occurrences."""
    import torch

    def device_us(ev):
        return (sum(k.duration for k in ev.kernels)
                + sum(device_us(c) for c in ev.cpu_children))

    out = dict.fromkeys(ranges, 0.0)
    for e in prof.events():
        if e.name in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name] += device_us(e) / 1e3
    return out


def profile_run(fn, ranges=()) -> tuple:
    """``fn()`` once under ``torch.profiler``: device time by kernel against
    the wall time of the call, so the device's idle share; with ``ranges``
    (``record_function`` names) also the device ms inside each; returns
    ``(record, fn's result)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a record_function range may show on the device's
    # timeline too, spanning the gaps between its kernels
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in ranges]
    by_kernel, spans = {}, []
    for e in events:
        spans.append((e.time_range.start, e.time_range.end))
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_us, end = 0.0, None  # union of the device intervals
    for start, stop in sorted(spans):
        if end is None or start > end:
            busy_us += stop - start
            end = stop
        elif stop > end:
            busy_us += stop - end
            end = stop
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    busy_ms = busy_us / 1e3
    record = dict(wall_ms=wall_ms, device_events=len(events), device_busy_ms=busy_ms,
                  idle_share=(1.0 - busy_ms / wall_ms) if events else None,
                  top_device_ms={k[:90]: v for k, v in top})
    if ranges:
        record["range_device_ms"] = _range_device_ms(prof, ranges)
    return record, out


# ---- grid: the solve over a grid of ranks ------------------------------------

GRID_FIT_TOL = 5e-3  # a grid run against the one-rank run, fitted space
GRID_FRAMES = 4  # the frames of each grid run (-t 0:0.35), linear with the Laplacian
GRID_TIMEOUT = 300  # seconds, each torchrun
# a later torchrun's ranks start with the first and wait for their turn: the
# file named by this variable (with the script's PID), at most GRID_GO_TIMEOUT s
GRID_GO_ENV = "CHIP_SMOKE_GRID_GO"
GRID_GO_TIMEOUT = 900
# (name, the grid's flags, ranks, storage): ranks share the one card over
# gloo; 1x1 is one rank over NCCL
GRID_RUNS = (("2x1", ["--pixel_shards", "2"], 2, "float32"),
             ("1x2", ["--voxel_shards", "2"], 2, "float32"),
             ("2x2", ["--pixel_shards", "2", "--voxel_shards", "2"], 4, "float32"),
             ("1x2_int8", ["--voxel_shards", "2"], 2, "int8"),
             ("1x1_nccl", [], 1, "float32"))
GRID_REPLACES = ("none: sartsolver_tpu/ops/fused_sweep.py:270 sharded_panel_sweep is plain "
                 "XLA (no pallas_call)")
GRID_PARITY = (2048, 16384, 20)  # the parity check's P, V and iterations


def grid_rank_main(argv) -> int:
    """``python chip_smoke.py --grid-rank OUT [--parity] [--audit] -- ARGS
    [--grid-rank OUT2 [--parity] -- ARGS2 ...]`` (one rank under torchrun): the rank's
    process group from the launcher's environment, then for each run in
    turn the port's CLI on its ARGS in that group, what it printed echoed,
    and the rank's record written to ``OUT.r<RANK>.json``: the exit code,
    the printed text, the CLI's seconds, the kernel launches and the
    collectives of that run alone; with ``--parity``, then
    :func:`~sartsolver_tpu_torch.utils.fused_parity.measure_kernel_vs_plain`
    on a ``GRID_PARITY`` problem over a grid of the world's ranks along the
    pixel axis; with ``--audit``, then the grid entries' launch audit
    (:func:`_grid_audit`). A run that fails ends the rank."""
    sys.path.insert(0, REPO)
    from sartsolver_tpu_torch import cli
    from sartsolver_tpu_torch.ops import fused_sweep as fs
    from sartsolver_tpu_torch.parallel import comm

    runs = grid_runs_of(argv)
    first = runs[0][2]
    device = first[first.index("--device") + 1] if "--device" in first else "cuda"
    if not _wait_for_go():
        return 3
    comm.initialize(device)
    rc = 0
    for out, extra, rest in runs:
        fs.reset_launch_counts()
        fs.reset_sharded_launch_counts()
        comm.reset_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(rest)
        rec = {"rank": int(os.environ.get("RANK", "0")), "rc": rc, "stdout": buf.getvalue(),
               "seconds": time.perf_counter() - t0}
        print(rec["stdout"], end="", flush=True)
        rec.update(fused_sweep=fs.fused_sweep.launches,
                   fused_sweep_by_plan=dict(fs.fused_sweep.launches_by_plan),
                   sharded_sweep_bp=fs.sharded_sweep_bp.launches,
                   sharded_sweep_finish=fs.sharded_sweep_finish.launches,
                   collectives=dict(comm.stats))
        if "--parity" in extra and rc == 0:
            import torch.distributed as dist

            rec.update(_grid_parity(dist.get_world_size(), 1, device))
        if "--audit" in extra and rc == 0:
            rec["audit"] = _grid_audit(device)
        with open(f"{out}.r{rec['rank']}.json", "w") as f:
            json.dump(rec, f)
        if rc:
            break
    comm.shutdown()
    return rc


def _grid_audit(device: str) -> list:
    """One rank of the grid entries' launch audit (``analysis/audit.py:
    run_grid_entries``) over a grid of the world's ranks along the pixel
    axis, on the ``GRID_PARITY`` problem: their per-iteration counts."""
    import dataclasses

    import torch.distributed as dist

    from sartsolver_tpu_torch.analysis import audit
    from sartsolver_tpu_torch.parallel.mesh import make_grid

    P, V, _ = GRID_PARITY
    H, _G = parity_problem(P, V)
    grid = make_grid(dist.get_world_size(), 1)
    reports = audit.run_grid_entries(grid, audit.AuditContext(device, H),
                                     profile=device == "cuda")
    return [dataclasses.asdict(r) for r in reports]


def grid_runs_of(argv) -> list:
    """The runs of a ``--grid-rank`` command line: ``(OUT, [options], ARGS)``
    for each ``--grid-rank OUT [options] -- ARGS``, in order."""
    runs, i = [], 0
    while i < len(argv):  # argv[i] is --grid-rank
        sep = argv.index("--", i)
        end = next((j for j in range(sep, len(argv)) if argv[j] == "--grid-rank"), len(argv))
        runs.append((argv[i + 1], argv[i + 2:sep], argv[sep + 1:end]))
        i = end
    return runs


def _grid_parity(n_pix: int, n_vox: int, device: str) -> dict:
    """One rank of the parity check: a seeded banded problem, fp32, its
    block on the card, two frames at a fixed iteration count, kernel path
    against plain path (``utils/fused_parity.py``), each against the fp64
    solve of the same grid (the plain path)."""
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.parallel.mesh import make_grid
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
    from sartsolver_tpu_torch.utils.fused_parity import (
        FP64_RATIO, PARITY_RTOL, measure_kernel_vs_plain,
    )

    P, V, iters = GRID_PARITY
    grid = make_grid(n_pix, n_vox)
    H, G = parity_problem(P, V)
    opts = SolverOptions(max_iterations=iters, conv_tolerance=0.0)
    solver = DistributedSARTSolver(H, opts=opts, device=device, grid=grid)
    reference = DistributedSARTSolver(
        H.astype(np.float64), opts=SolverOptions(max_iterations=iters, conv_tolerance=0.0,
                                                 dtype="float64"), device=device, grid=grid)
    return dict(parity=measure_kernel_vs_plain(solver, G, reference=reference),
                rtol=PARITY_RTOL, fp64_ratio=FP64_RATIO, grid=[n_pix, n_vox])


def parity_problem(P: int, V: int):
    """``(H [P, V] fp32, G [2, P])``: the e2e world's banded response with
    its reflection floor (:func:`write_world`) at ``P x V``, and two frames
    of it, the second a tenth brighter."""
    rng = np.random.default_rng(1)
    ii = np.arange(P, dtype=np.float32)[:, None] / P
    jj = np.arange(V, dtype=np.float32)[None, :] / V
    H = rng.random((P, V), dtype=np.float32) * 0.9 + 0.1
    H *= np.exp(-((ii - jj) ** 2) * 200.0) + 0.02
    f_true = rng.random(V, dtype=np.float32) * 1.5 + 0.5
    return H, np.stack([H @ f_true, H @ (1.1 * f_true)]).astype(np.float64)


def _torchrun_start(n: int, args, go: Optional[str] = None):
    """Start ``python -m torch.distributed.run --standalone`` over ``n``
    ranks of this script with ``args``, its output into temporary files;
    with ``go``, each rank imports its modules, then waits for the file
    ``go`` to exist before it starts its process group (GRID_GO_ENV)."""
    env = dict(os.environ, **({GRID_GO_ENV: f"{go}:{os.getpid()}"} if go else {}))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node", str(n), os.path.join(REPO, "chip_smoke.py"),
                             *args], cwd=REPO, env=env, stdout=out, stderr=err, text=True)
    return proc, out, err


def _torchrun_wait(launch, timeout: int = GRID_TIMEOUT) -> tuple:
    """(exit code, stdout, stderr) of a launch of :func:`_torchrun_start`;
    a launch past ``timeout`` seconds is stopped and raises."""
    proc, out, err = launch
    try:
        proc.wait(timeout=timeout)
    finally:
        _torchrun_stop(launch)
    out.seek(0)
    err.seek(0)
    text = out.read(), err.read()
    out.close()
    err.close()
    return (proc.returncode, *text)


def _torchrun_stop(launch) -> None:
    """Stop a launch that still runs (SIGTERM, which the launcher passes to
    its ranks; SIGKILL after 30 s)."""
    proc = launch[0]
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _torchrun(n: int, args, timeout: int = GRID_TIMEOUT):
    """``python -m torch.distributed.run --standalone`` over ``n`` ranks of
    this script with ``args``: (exit code, stdout, stderr, seconds)."""
    t0 = time.perf_counter()
    rc, out, err = _torchrun_wait(_torchrun_start(n, args), timeout)
    return rc, out, err, time.perf_counter() - t0


def _wait_for_go() -> bool:
    """A rank's wait for its launch's turn (GRID_GO_ENV, ``PATH:PID``):
    True once the file exists; False if the script whose PID it names is
    gone, or after ``GRID_GO_TIMEOUT`` seconds."""
    spec = os.environ.get(GRID_GO_ENV)
    if not spec:
        return True
    path, pid = spec.rsplit(":", 1)
    deadline = time.monotonic() + GRID_GO_TIMEOUT
    while not os.path.exists(path):
        try:
            os.kill(int(pid), 0)
        except OSError:
            return False
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def _rank_records(prefix: str, n: int) -> list:
    out = []
    for r in range(n):
        with open(f"{prefix}.r{r}.json") as f:
            out.append(json.load(f))
    return out


def _split_inputs(P, V, B, logarithmic, seed, storage):
    """The split sweep's inputs: the fused sweep's (with the penalty), and
    the reduced bp the finish takes (the plain bp of these inputs)."""
    from sartsolver_tpu_torch.ops.fused_sweep import sharded_sweep_bp_reference

    H, w, f, aux, scale = _sweep_inputs(P, V, B, logarithmic, True, seed, storage)
    return H, w, f, aux, scale, sharded_sweep_bp_reference(H, w)


def _split_bound(nbytes: int, flops: int, rates) -> dict:
    mem_rate, fp32_rate, _ = rates
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, flops / fp32_rate * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_rate="fp32 outside the tensor cores", bytes=nbytes, flops=flops)


def split_kernels(rates, P: int = 4096, V: int = 65536) -> dict:
    """The split sweep on the card at the 2x1 grid's block (``P x V``, B =
    1), per storage: ``sharded_sweep_bp`` and ``sharded_sweep_finish``
    against their plain versions (linear with the penalty and log; within
    ``KERNEL_TOL`` of the output's max, two launches byte-identical), the
    pair at one rank bit for bit against ``two_read`` (the sum of one
    rank's partials is the whole bp), each kernel timed beside its bound,
    its plain version and its library call (one ``torch.matmul`` on an fp32
    copy of the block), and each call's CUDA kernels from ``torch.profiler``
    (``kernels_per_call``, with their device ms): the route's
    (``split_route``: one kernel a call on the cluster route), else the
    phase fails."""
    import torch

    from sartsolver_tpu_torch.ops.fused_sweep import (
        SPLIT_KERNELS_PER_CALL, _sweep, sharded_sweep_bp, sharded_sweep_bp_reference,
        sharded_sweep_finish, sharded_sweep_finish_reference, split_route,
    )

    out = {}
    for storage in STORAGES:
        errs = {"bp": 0.0, "finish": 0.0}
        for logarithmic in (False, True):
            H, w, f, aux, scale, bp_ref = _split_inputs(P, V, 1, logarithmic,
                                                        seed=P + V + logarithmic,
                                                        storage=storage)
            kw = dict(logarithmic=logarithmic, alpha=0.7, eps=1e-7, scale=scale)
            b0 = sharded_sweep_bp.launches
            bp1, bp2 = sharded_sweep_bp(H, w), sharded_sweep_bp(H, w)
            outs1 = sharded_sweep_finish(H, f, bp_ref, aux, **kw)
            outs2 = sharded_sweep_finish(H, f, bp_ref, aux, **kw)
            ref = sharded_sweep_finish_reference(H, f, bp_ref, aux, **kw)
            whole = sharded_sweep_finish(H, f, bp1, aux, **kw)
            two = _sweep(H, w, f, aux, plan="two_read", **kw)
            torch.cuda.synchronize()
            if (sharded_sweep_bp.launches - b0 != 2 or not torch.equal(bp1, bp2)
                    or not all(torch.equal(a, b) for a, b in zip(outs1, outs2))
                    or not all(torch.equal(a, b) for a, b in zip(whole, two))):
                raise AssertionError(f"split sweep {storage} log={logarithmic}: counts, "
                                     "repeat bytes or the one-rank pair against two_read")
            rel_bp = float((bp1 - bp_ref).abs().max() / bp_ref.abs().max())
            rel_fin = max(float((a - r).abs().max() / r.abs().max())
                          for a, r in zip(outs1, ref))
            if max(rel_bp, rel_fin) > KERNEL_TOL:
                raise AssertionError(f"split sweep {storage} log={logarithmic}: bp "
                                     f"{rel_bp}, finish {rel_fin} above {KERNEL_TOL}")
            errs["bp"] = max(errs["bp"], float((bp1 - bp_ref).abs().max()))
            errs["finish"] = max(errs["finish"], max(float((a - r).abs().max())
                                                     for a, r in zip(outs1, ref)))
            if logarithmic:
                continue
            Hbytes = H.element_size() * P * V
            vec = 4 * (w.numel() + 2 * f.numel() + sum(a.numel() for a in aux)
                       + (0 if scale is None else scale.numel()))
            bp_t = dict(ms=_median_ms(lambda: sharded_sweep_bp(H, w)),
                        plain_ms=_median_ms(lambda: sharded_sweep_bp_reference(H, w)),
                        **_split_bound(Hbytes + 4 * (w.numel() + f.numel()), 2 * P * V, rates))
            fin_t = dict(ms=_median_ms(lambda: sharded_sweep_finish(H, f, bp_ref, aux, **kw)),
                         plain_ms=_median_ms(lambda: sharded_sweep_finish_reference(
                             H, f, bp_ref, aux, **kw)),
                         **_split_bound(Hbytes + vec + 4 * P, 2 * P * V, rates))
            torch.cuda.empty_cache()
            Hd = H.float() if scale is None else H.float().mul_(scale)
            bp_t["library_ms"] = _median_ms(lambda: torch.matmul(w, Hd))
            fin_t["library_ms"] = _median_ms(lambda: torch.matmul(f, Hd.T))
            if storage == "float32":  # the library's device time beside the kernels'
                bp_t["library_device_ms"] = _trace_profile(
                    lambda: torch.matmul(w, Hd))["device_ms"]
                fin_t["library_device_ms"] = _trace_profile(
                    lambda: torch.matmul(f, Hd.T))["device_ms"]
            del Hd
            fin_t["pair_ms"] = bp_t["ms"] + fin_t["ms"]
            fin_t["two_read_ms"] = _median_ms(
                lambda: _sweep(H, w, f, aux, plan="two_read", **kw))
            route = split_route(P, V, 1, storage)
            for t, call in ((bp_t, lambda: sharded_sweep_bp(H, w)),
                            (fin_t, lambda: sharded_sweep_finish(H, f, bp_ref, aux, **kw))):
                prof = _trace_profile(call)
                t.update(route=route, kernels_per_call=prof["kernels_per_call"],
                         device_ms=prof["device_ms"], device_ms_by_kernel=prof["ms_by_kernel"])
                if prof["kernels_per_call"] != SPLIT_KERNELS_PER_CALL[route]:
                    raise AssertionError(f"split sweep {storage}: {prof} on the {route} "
                                         "route")
            out[storage] = dict(bp=bp_t, finish=fin_t, shape=[P, V, 1])
            del H, w, f, aux, scale, bp_ref
            torch.cuda.empty_cache()
        out[storage].update(max_abs_err_bp=errs["bp"], max_abs_err_finish=errs["finish"])
    return out


def grid_phase(world, outdir: str, kernels=None, kernels_s: float = 0.0,
               device: str = "cuda") -> dict:
    """The solve over a grid of ranks (module docstring, phase ``grid``):
    the split kernels' record (:func:`split_kernels`, taken by ``main``
    right after the audit, while the profiler still records every kernel,
    and reported here with its seconds), then the CLI under torchrun
    for each of ``GRID_RUNS`` on the world's first ``GRID_FRAMES`` frames
    against the one-rank runs of the solve phase, the first run's ranks
    then holding the kernel path against the plain one and both against
    fp64 (``--parity``). The runs of one world size share one torchrun,
    one after another in the same process group; the launches start at
    once and take turns (a run's ``seconds`` are its CLI's on the primary
    rank; ``torchruns`` has each launch's from its turn). On the CPU (a
    rehearsal) the kernels and the launch counts are left out."""
    from sartsolver_tpu_torch.ops.fused_sweep import plan_sweep

    card = device == "cuda"
    kernels = kernels if card else {}
    p = world["paths"]
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    P, V = world["H"].shape
    # one torchrun for the runs of each world size, in GRID_RUNS' order;
    # the first run also holds the kernel path against the plain one
    launches = {}
    for i, (name, flags, n, storage) in enumerate(GRID_RUNS):
        launches.setdefault(n, []).extend([
            "--grid-rank", os.path.join(outdir, f"grid_{name}"),
            *(["--parity", "--audit"] if i == 0 else []),
            "--", "-o", os.path.join(outdir, f"grid_{name}.h5"), *inputs,
            "-m", str(MAX_ITERATIONS), "-l", p["laplacian"], "-t", "0:0.35",
            "--chain_frames", "1", "--rtm_dtype", storage, "--device", device, "--multihost",
            "--parallel_read", *flags])
    # every launch started at once, each after the first waiting for the one
    # before it to end: their processes start together, their runs take
    # turns on the card
    torchruns, started = {}, []
    try:
        for i, (n, argv) in enumerate(launches.items()):
            go = os.path.join(outdir, f"grid_go_{n}") if i else None
            started.append((n, go, _torchrun_start(n, argv, go)))
        for n, go, launch in started:
            t0 = time.perf_counter()
            if go:
                open(go, "w").close()
            rc, so, se = _torchrun_wait(launch)
            if rc != 0:
                raise AssertionError(f"grid runs over {n} ranks: exit {rc}\n{so[-2000:]}\n"
                                     f"{se[-3000:]}")
            torchruns[str(n)] = dict(seconds_from_its_turn=time.perf_counter() - t0,
                                     runs=[r[0] for r in GRID_RUNS if r[2] == n])
    finally:
        for _n, _go, launch in started:
            _torchrun_stop(launch)
    runs, parity, audited = {}, None, None
    for name, flags, n, storage in GRID_RUNS:
        out = os.path.join(outdir, f"grid_{name}.h5")
        recs = _rank_records(os.path.join(outdir, f"grid_{name}"), n)
        if audited is None:
            # the grid entries' launch audit, from the first run's group
            from sartsolver_tpu_torch.analysis.audit import EntryReport

            audited = []
            for r in recs[0]["audit"]:
                rep = EntryReport(**r)
                line = _audit_line(rep, storage="float32", from_phase="grid")
                emit("audit", **line)
                audited.append(line)
            if not audited or any(a["status"] != "ok" for a in audited):
                raise AssertionError(f"grid launch audit: {audited}")
        if parity is None:
            parity = [r["parity"] for r in recs]
            if not parity[0]["kernel_engaged"].startswith("split") or (
                    card and (parity[0]["kernel_engaged"] != "split"
                              or parity[0]["kernel_launches"] <= 0)):
                raise AssertionError(f"grid parity: {parity[0]}")
        so, secs = recs[0]["stdout"], recs[0]["seconds"]
        ms = [float(m) for m in re.findall(r"Processed in: ([0-9.eE+-]+) ms", so)]
        line = next((ln for ln in so.splitlines() if ln.startswith("solver: ")), "")
        sol, err = check_solution(out, world, GRID_FRAMES, MAX_ITERATIONS, device)
        ref = os.path.join(outdir, f"solution_{storage}_linear.h5")
        ref_rows = _read_rows(ref)
        dist = _fitted_distance(world, sol["value"], ref_rows["value"][:GRID_FRAMES], device)
        iters = int(sol["iterations"].sum())
        n_pix = 2 if "--pixel_shards" in flags else 1
        n_vox = 2 if "--voxel_shards" in flags else 1
        backend = "nccl" if n == 1 and card else "gloo"
        want_mesh = f"mesh={n_pix}x{n_vox} "
        problems = []
        if len(ms) != GRID_FRAMES or want_mesh not in line or \
                f"collectives={backend}" not in line:
            problems.append(f"{len(ms)} frame lines, solver line {line!r}")
        if any("Processed in:" in r["stdout"] for r in recs[1:]):
            problems.append("a rank other than the primary printed frame lines")
        if not np.array_equal(sol["status"], ref_rows["status"][:GRID_FRAMES]) or \
                not (dist <= GRID_FIT_TOL).all():
            problems.append(f"statuses {sol['status']} / {ref_rows['status'][:GRID_FRAMES]}, "
                            f"fitted distance {dist}")
        for r in recs if card else ():
            if n_pix > 1:
                ok = (r["sharded_sweep_bp"] == iters and r["sharded_sweep_finish"] == iters
                      and r["fused_sweep"] == 0)
            else:
                plan = plan_sweep(P, V // n_vox, 1, storage)
                ok = (r["fused_sweep"] == iters and r["fused_sweep_by_plan"][plan] == iters
                      and r["sharded_sweep_bp"] == 0)
            if not ok or r["rc"] != 0:
                problems.append(f"rank {r['rank']}: {r}")
        if problems:
            raise AssertionError(f"grid run {name}: " + "; ".join(problems))
        coll = recs[0]["collectives"]
        runs[name] = dict(
            ranks=n, storage=storage, backend=backend, seconds=secs, frame_ms=ms,
            status=sol["status"].tolist(), iterations=sol["iterations"].tolist(),
            fitted_distance_to_one_rank=dist.tolist(), fit_err=err.tolist(),
            solver_line=line, launches=[{k: r[k] for k in (
                "fused_sweep", "sharded_sweep_bp", "sharded_sweep_finish")} for r in recs],
            collectives=coll,
            collective_ms_per_iteration=coll["seconds"] * 1e3 / max(iters, 1),
            device_wait_ms_per_iteration=coll["device_wait_seconds"] * 1e3 / max(iters, 1),
            wall_ms_per_iteration=sum(ms) / max(iters, 1))
    return dict(kernels=kernels, kernels_seconds=kernels_s, parity=parity, audit=audited,
                parity_shape=list(GRID_PARITY), fit_tol=GRID_FIT_TOL, frames=GRID_FRAMES,
                torchruns=torchruns, runs=runs)


SERVE_LANES = 2  # the serving engine's default --lanes
SERVE_DRILL_LANES = 4  # the SIGTERM drill's server and its replay
SERVE_DEADLINE_S = 0.3  # the tight request's deadline_s
SERVE_TIMEOUT = 300  # seconds, each serve or submit process
# the requests of the main server (lanes 2): (id, tenant, time range,
# deadline, how it is submitted); the e2e world's frames are 0.1 apart
SERVE_REQUESTS = (
    ("diag-a-1", "diag-a", "0:0.35", None, "submit"),    # frames 0-3, the ingest dir
    ("diag-b-1", "diag-b", "0.4:0.75", None, "socket"),  # frames 4-7, the socket
    ("diag-a-late", "diag-a", "0.8:1.95", SERVE_DEADLINE_S, "staged"),  # 8-19, shed
    ("diag-b-2", "diag-b", "2:2.35", None, "staged"),    # 20-23, co-batched with it
)
# the CLI run the served rows are held against: the completing requests'
# ranges, each interval's composite times derived as the request's are
SERVE_CLI_RANGE = ",".join(r[2] for r in SERVE_REQUESTS if r[3] is None)
SERVE_DRILL = ("diag-a-drill", "diag-a", "2.4:3.15")  # frames 24-31, lanes 4
SERVE_GEOMETRY = ("geo-1", "diag-g", "0:0.35")  # the geometry server's request
# the stored-matrix servers (lanes 2), one request each, started with the
# drill's restart: (--rtm_dtype, id, tenant, time range)
SERVE_STORAGES = (("bfloat16", "diag-a-bf16", "diag-a", "0:0.35"),
                  ("int8", "diag-b-int8", "diag-b", "0.4:0.75"))
SERVE_SOCKET = "engine.sock"  # relative to the phase's directory: short at any depth


class _Serve:
    """One ``serve`` process of the port: its stdout collected by a thread,
    the HTTP port it announces, stopped by SIGTERM (killed on a timeout)."""

    def __init__(self, argv, env=None, cwd=REPO):
        import threading

        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "sartsolver_tpu_torch.cli", "serve", *argv],
            cwd=cwd, env=env or _serve_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self.stamps = []  # time.time() at each line's arrival
        self.matched_at = None  # the arrival time of wait_for's line
        self._cv = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append(line)
                self.stamps.append(time.time())
                self._cv.notify_all()
        with self._cv:
            self._cv.notify_all()

    def wait_for(self, pattern: str, timeout: float = SERVE_TIMEOUT, nth: int = 1) -> str:
        """The ``nth`` stdout line matching ``pattern`` (a regex)."""
        deadline = time.monotonic() + timeout
        rx = re.compile(pattern)
        with self._cv:
            while True:
                hits = [i for i, line in enumerate(self.lines) if rx.search(line)]
                if len(hits) >= nth:
                    self.matched_at = self.stamps[hits[nth - 1]]
                    return self.lines[hits[nth - 1]]
                left = deadline - time.monotonic()
                if left <= 0 or (self.proc.poll() is not None and not self._reader.is_alive()):
                    raise AssertionError(f"serve: no {pattern!r} line:\n"
                                         + "".join(self.lines)[-3000:])
                self._cv.wait(min(left, 0.5))

    def stop(self, timeout: float = SERVE_TIMEOUT) -> int:
        import signal as _signal

        if self.proc.poll() is None:
            self.proc.send_signal(_signal.SIGTERM)
        return self.wait(timeout)

    def wait(self, timeout: float = SERVE_TIMEOUT) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=60)
        self._reader.join(timeout=10)
        return rc

    def text(self) -> str:
        return "".join(self.lines)


def _serve_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("SART_FAULT", "SART_TEST_JOURNAL_DELAY")}
    env["PYTHONUNBUFFERED"] = "1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _submit(*argv, cwd=REPO) -> tuple:
    """``submit`` in a subprocess: (exit code, the record it printed)."""
    out = subprocess.run([sys.executable, "-m", "sartsolver_tpu_torch.cli", "submit", *argv],
                         cwd=cwd, env=_serve_env(), capture_output=True, text=True,
                         timeout=SERVE_TIMEOUT)
    try:
        rec = json.loads(out.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        raise AssertionError(f"submit {argv}: exit {out.returncode}, {out.stdout}{out.stderr}")
    return out.returncode, rec


def _stage(eng_dir: str, payloads) -> None:
    """Publish request files into the engine's ingest dir at once (each by
    rename, as ``submit`` does), so one scan admits them together."""
    from sartsolver_tpu_torch.utils import atomicio

    ingest = os.path.join(eng_dir, "ingest")
    os.makedirs(ingest, exist_ok=True)
    for i, payload in enumerate(payloads):
        atomicio.write_json_atomic(os.path.join(ingest, f"{i:03d}-{payload['id']}.json"),
                                   payload)


def _response(eng_dir: str, rid: str, timeout: float = SERVE_TIMEOUT) -> dict:
    """The request's terminal response (done, interrupted or rejected)."""
    path = os.path.join(eng_dir, "responses", f"{rid}.json")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                rec = json.load(f)
            if rec.get("verdict") == "rejected" or rec.get("state") in ("done", "interrupted"):
                return rec
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"no terminal response for {rid} in {timeout} s")


def _frame_index(world, t: float) -> int:
    return int(np.argmin(np.abs(np.asarray(world["times"]) - t)))


def _served_rows(path, world, device, fit_bound=FIT_BOUND) -> dict:
    """A served solution file: its rows and each frame's fitted-space error
    against the noiseless measurement."""
    import torch

    from sartsolver_tpu_torch.io import h5

    with h5.File(path, "r") as f:
        sol = {k: f["solution"][k][:] for k in f["solution"]}
        has_map = "voxel_map" in f
    idx = [_frame_index(world, t) for t in sol["time"]]
    H = torch.as_tensor(world["H"], device=device)
    truth = torch.as_tensor(world["f_true"][:, None] * world["scales"][None, idx],
                            dtype=torch.float32, device=device)
    fit = H @ torch.as_tensor(sol["value"].T, dtype=torch.float32, device=device)
    ref = H @ truth
    err = ((fit - ref).norm(dim=0) / ref.norm(dim=0)).cpu().numpy()
    if not has_map or not np.isfinite(sol["value"]).all():
        raise AssertionError(f"{path}: voxel_map {has_map}, finite values")
    if fit_bound is not None and not (err <= fit_bound).all():
        raise AssertionError(f"{path}: fitted-space errors {err} above {fit_bound}")
    return dict(sol=sol, idx=idx, fit_err=err)


def _same_rows(served: dict, cli_path: str, what: str) -> None:
    """The served rows equal, byte for byte, the CLI's rows of the same
    frames (matched by time)."""
    from sartsolver_tpu_torch.io import h5

    with h5.File(cli_path, "r") as f:
        ref = {k: f["solution"][k][:] for k in f["solution"]}
    rows = [int(np.argmin(np.abs(ref["time"] - t))) for t in served["sol"]["time"]]
    for key, got in served["sol"].items():
        if not np.array_equal(got, ref[key][rows]):
            raise AssertionError(f"{what}: solution/{key} differs from the CLI's rows")


def _artifact_metrics(path: str) -> dict:
    """A ``--metrics_out`` artifact: its metric records by name and labels,
    and its frame records."""
    metrics, frames = {}, []
    with open(path) as f:
        for rec in map(json.loads, f):
            if rec.get("type") == "metric":
                labels = ",".join(f"{k}={v}" for k, v in sorted(rec["labels"].items()))
                metrics[rec["name"] + (f"{{{labels}}}" if labels else "")] = rec
            elif rec.get("type") == "frame":
                frames.append(rec)
    return dict(metrics=metrics, frames=frames)


def _launches_of(art: dict) -> dict:
    return {key[len("kernel_launches_total{"):-1]: rec["value"]
            for key, rec in art["metrics"].items()
            if key.startswith("kernel_launches_total{")}


def _quantiles(art: dict, name: str) -> dict:
    rec = art["metrics"].get(name) or {}
    return {q: rec.get(q) for q in ("count", "p50", "p95", "p99", "max")}


def serve_phase(world, outdir: str, geometry_world=None, device: str = "cuda",
                rates=None, deadline_s: float = SERVE_DEADLINE_S, extra=()) -> dict:
    """The resident serving engine on the world (phase ``serve``).

    A ``serve`` process (``--lanes SERVE_LANES --socket ... --http_port 0
    --metrics_out``) on the e2e world, linear with the Laplacian, takes
    ``SERVE_REQUESTS``: two tenants, one request through ``submit`` and the
    ingest dir, one through the socket, and a pair published into the
    ingest dir at once, whose tight deadline (``SERVE_DEADLINE_S``) sheds
    its frames as -5 while the co-batched request completes. Started with
    it, a second server (lanes ``SERVE_DRILL_LANES``, the journal's windows
    held open) is sent SIGTERM inside the dispatched window of its request
    (``SERVE_DRILL``): exit 4; its restart, started once the first has
    served, replays the journal; a third, started with the first two,
    serves the geometry world's images through its implicit operator and
    takes ``submit --geometry`` while the restart comes up; with the
    restart, one server for each of ``SERVE_STORAGES`` (lanes
    ``SERVE_LANES``, the matrix stored as bf16 or int8) serves its staged
    request. Every served row is held, byte for byte,
    against the port's one-shot CLI over the same frames (``--no_guess
    --batch_frames`` at the server's lanes and ``--rtm_dtype``), and within
    ``FIT_BOUND`` of the truth; the HTTP endpoints answer while the server
    runs; each server's metrics artifact carries the hand kernels' launches
    by plan (``kernel_launches_total``). The socket is named relative to the
    phase's directory, where its server and client run. Recorded: request
    latency and queue wait (p50, p95), the first request's latency and ms
    per frame apart from the later requests', ms per frame served against
    the CLI's, the servers' start to ready. On the card with ``rates``, the fused sweep at the serving
    shape (B = 2 and 4) against its plain version, timed beside its bound
    and the library. ``deadline_s`` and ``extra`` (flags of every server and
    CLI run) size the deadline drill to a small world in the tests."""
    import shutil
    import urllib.request

    import torch

    p = world["paths"]
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    cap = str(MAX_ITERATIONS)
    solve = ["-m", cap, "-l", p["laplacian"], "--device", device, *extra]
    out = {"lanes": SERVE_LANES, "drill_lanes": SERVE_DRILL_LANES, "deadline_s": deadline_s}
    root = os.path.join(outdir, "serve")
    main_dir, drill_dir = os.path.join(root, "main"), os.path.join(root, "drill")
    # the socket by a relative name, server and client in the phase's
    # directory: an AF_UNIX path holds 107 bytes, a checkout's may be longer
    sock = SERVE_SOCKET
    os.makedirs(root, exist_ok=True)
    drill_id, drill_tenant, drill_range = SERVE_DRILL
    _stage(drill_dir, [{"id": drill_id, "tenant": drill_tenant, "time_range": drill_range}])
    servers = []
    try:
        main = _Serve(["--engine_dir", main_dir, "--lanes", str(SERVE_LANES), "--socket", sock,
                       "--http_port", "0", "--metrics_out",
                       os.path.join(root, "main.jsonl"), *solve, *inputs], cwd=root)
        servers.append(main)
        drill = _Serve(["--engine_dir", drill_dir, "--lanes", str(SERVE_DRILL_LANES), *solve,
                        *inputs], env=_serve_env(SART_TEST_JOURNAL_DELAY="0.5"))
        servers.append(drill)
        geo = None
        if geometry_world is not None:
            gp = geometry_world["paths"]
            geo_dir = os.path.join(root, "geometry")
            geo = _Serve(["--engine_dir", geo_dir, "--lanes", str(SERVE_LANES),
                          "--geometry", geometry_world["geometry"], "--http_port", "0",
                          "--metrics_out",
                          os.path.join(root, "geometry.jsonl"), "-m", cap, "--device", device,
                          *extra, gp["img_a"], gp["img_b"]])
            servers.append(geo)
        # the drill: SIGTERM inside its request's dispatched window
        drill.wait_for(r"SART_JOURNAL_POINT dispatched")
        drill_rc = drill.stop()
        drill_resp = _response(drill_dir, drill_id, timeout=10)
        if drill_rc != 4 or drill_resp.get("state") != "interrupted":
            raise AssertionError(f"drill server: exit {drill_rc}, {drill_resp}\n"
                                 f"{drill.text()[-2000:]}")
        out["sigterm"] = dict(exit=drill_rc, response=drill_resp.get("state"),
                              seconds=time.perf_counter() - drill.t0)

        line = main.wait_for(r"live endpoints on http://127\.0\.0\.1:(\d+)")
        ready_s = time.perf_counter() - main.t0
        base = "http://127.0.0.1:" + re.search(r":(\d+) ", line).group(1)
        with urllib.request.urlopen(base + "/readyz", timeout=10) as r:
            ready = json.loads(r.read())
        resident = main.wait_for(r"session resident").strip()
        warm = main.wait_for(r"engine: warm-up").strip() if device == "cuda" else None
        recs = {}
        rid, tenant, rng, _, _ = SERVE_REQUESTS[0]
        rc, recs[rid] = _submit("--engine_dir", main_dir, "--id", rid, "--tenant", tenant,
                                "--time_range", rng, "--wait", str(SERVE_TIMEOUT))
        if rc != 0:
            raise AssertionError(f"submit {rid}: exit {rc}, {recs[rid]}")
        rid, tenant, rng, _, _ = SERVE_REQUESTS[1]
        rc, verdict = _submit("--socket", sock, "--id", rid, "--tenant", tenant,
                              "--time_range", rng, cwd=root)
        if rc != 0 or verdict.get("verdict") != "accepted":
            raise AssertionError(f"socket submit {rid}: exit {rc}, {verdict}")
        recs[rid] = _response(main_dir, rid)
        _stage(main_dir, [dict({"id": r, "tenant": t, "time_range": g},
                               **({"deadline_s": deadline_s} if d else {}))
                          for r, t, g, d, how in SERVE_REQUESTS if how == "staged"])
        for r, *_ in SERVE_REQUESTS[2:]:
            recs[r] = _response(main_dir, r)
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            scrape = r.read().decode()
        main_rc = main.stop()
        if main_rc != 4:
            raise AssertionError(f"main server exit {main_rc}\n{main.text()[-2000:]}")
        out["main"] = dict(ready_s=ready_s, readyz=ready, resident_line=resident,
                           warm_up_line=warm, exit=main_rc, scrape_has_engine=("sart_engine_admitted_total"
                                                            in scrape))
        # the drill's restart, once the main server's timed requests are done:
        # the journal replays the interrupted request; with it the bf16 and
        # int8 servers, each serving its staged request; meanwhile the
        # geometry request and the CLI twins of the drill and of the stored
        # matrices (untimed)
        replay = _Serve(["--engine_dir", drill_dir, "--lanes", str(SERVE_DRILL_LANES),
                         "--idle_exit", "1", "--metrics_out", os.path.join(root, "drill.jsonl"),
                         *solve, *inputs])
        servers.append(replay)
        stored = {}
        for storage, rid, tenant, rng in SERVE_STORAGES:
            sdir = os.path.join(root, storage)
            _stage(sdir, [{"id": rid, "tenant": tenant, "time_range": rng}])
            stored[storage] = _Serve(["--engine_dir", sdir, "--lanes", str(SERVE_LANES),
                                      "--idle_exit", "1", "--rtm_dtype", storage,
                                      "--metrics_out", os.path.join(root, f"{storage}.jsonl"),
                                      *solve, *inputs])
            servers.append(stored[storage])
        if geo is not None:
            gid, gtenant, grange = SERVE_GEOMETRY
            geo.wait_for(r"live endpoints on")
            rc, recs[gid] = _submit("--engine_dir", geo_dir, "--geometry",
                                    geometry_world["geometry"], "--id", gid, "--tenant",
                                    gtenant, "--time_range", grange, "--wait",
                                    str(SERVE_TIMEOUT))
            if rc != 0:
                raise AssertionError(f"submit --geometry: exit {rc}, {recs[gid]}")
            geo_rc = geo.stop()
            if geo_rc != 4:
                raise AssertionError(f"geometry server exit {geo_rc}\n{geo.text()[-2000:]}")
            out["geometry_server"] = dict(exit=geo_rc, attach=[
                ln.strip() for ln in geo.lines if "session-attach" in ln])
        cli_dir = os.path.join(root, "cli")
        os.makedirs(cli_dir, exist_ok=True)
        cli_runs = {"lanes4": _cli_twin(
            os.path.join(cli_dir, "lanes4.h5"), inputs, cap, p["laplacian"], extra, drill_range,
            SERVE_DRILL_LANES, device)}
        for storage, rid, tenant, rng in SERVE_STORAGES:
            cli_runs[storage] = _cli_twin(
                os.path.join(cli_dir, f"{storage}.h5"), inputs, cap, p["laplacian"],
                [*extra, "--rtm_dtype", storage], rng, SERVE_LANES, device)
        replay_rc = replay.wait()
        if replay_rc != 0 or "1 accepted-but-unfinished re-queued" not in replay.text():
            raise AssertionError(f"replay server: exit {replay_rc}\n{replay.text()[-2000:]}")
        drill_done = _response(drill_dir, drill_id, timeout=10)
        for storage, rid, *_ in SERVE_STORAGES:
            rc = stored[storage].wait()
            if rc != 0:
                raise AssertionError(f"{storage} server: exit {rc}\n"
                                     f"{stored[storage].text()[-2000:]}")
            recs[rid] = _response(os.path.join(root, storage), rid, timeout=10)
    finally:
        for s in servers:
            if s.proc.poll() is None:
                s.proc.kill()
                s.proc.wait(timeout=60)
    out["replay"] = dict(exit=replay_rc, outcome=drill_done["outcome"])

    # the outcomes
    def outcome(rid):
        return recs[rid]["outcome"]

    for rid in [r[0] for r in SERVE_REQUESTS] + [r[1] for r in SERVE_STORAGES]:
        if outcome(rid)["status"] != ("shed-deadline" if rid == "diag-a-late" else "completed"):
            raise AssertionError(f"{rid}: {recs[rid]}")
    late = outcome("diag-a-late")
    if not late["by_status"].get("deadline"):
        raise AssertionError(f"the tight deadline shed no frame: {late}")

    # the served rows against the one-shot CLI over the same frames (the
    # servers all stopped: its ms per frame is timed alone)
    cli_runs["lanes2"] = _cli_twin(os.path.join(cli_dir, "lanes2.h5"), inputs, cap,
                                   p["laplacian"], extra, SERVE_CLI_RANGE, SERVE_LANES, device)
    requests = {}
    for rid, tenant, rng, deadline, how in SERVE_REQUESTS:
        o = outcome(rid)
        path = os.path.join(main_dir, o["output"])
        served = _served_rows(path, world, device,
                              fit_bound=None if deadline else FIT_BOUND)
        if deadline:
            st = served["sol"]["status"]
            shed = st == -5
            if not shed.any() or (served["sol"]["iterations"][shed] >= MAX_ITERATIONS).any():
                raise AssertionError(f"{rid}: statuses {st}")
        else:
            _same_rows(served, os.path.join(cli_dir, "lanes2.h5"), rid)
        requests[rid] = dict(tenant=tenant, via=how, time_range=rng, deadline_s=deadline,
                             status=o["status"], by_status=o["by_status"],
                             latency_s=o["latency_s"], solve_s=o["solve_s"],
                             frames=o["frames"], fit_err=served["fit_err"].tolist(),
                             iterations=served["sol"]["iterations"].tolist())
    drilled = _served_rows(os.path.join(drill_dir, "outputs", f"{drill_id}.h5"), world, device)
    _same_rows(drilled, os.path.join(cli_dir, "lanes4.h5"), "the replayed request")
    out["replay"]["fit_err"] = drilled["fit_err"].tolist()
    out["requests"] = requests
    out["cli"] = cli_runs

    # the servers' artifacts: latency, queue wait, the kernels' launches
    art = _artifact_metrics(os.path.join(root, "main.jsonl"))
    served_ms = [fr["solve_ms"] for fr in art["frames"]
                 if fr.get("solve_ms") is not None and fr["status"] != -5]
    launches = _launches_of(art)
    drill_art = _artifact_metrics(os.path.join(root, "drill.jsonl"))
    out["latency_s"] = _quantiles(art, "engine_request_latency_s")
    out["queue_wait_s"] = _quantiles(art, "engine_queue_wait_s")
    out["served_ms_per_frame"] = sum(served_ms) / max(len(served_ms), 1)
    # the first request apart from the rest: the warm-up stride should
    # leave it no dearer a frame than the later ones
    first = outcome(SERVE_REQUESTS[0][0])
    later_ms = [fr["solve_ms"] for fr in art["frames"]
                if fr.get("solve_ms") is not None and fr["status"] != -5
                and fr.get("trace") != first["trace"]]
    out["first_request"] = dict(latency_s=first["latency_s"], solve_s=first["solve_s"],
                                ms_per_frame=first["solve_s"] * 1e3 / max(first["frames"], 1))
    out["later_requests"] = dict(
        latency_s={r: outcome(r)["latency_s"] for r, *_ in SERVE_REQUESTS[1:]},
        served_ms_per_frame=sum(later_ms) / max(len(later_ms), 1))
    out["cli_ms_per_frame"] = cli_runs["lanes2"]["ms_per_frame"]
    out["launches"] = {"main": launches, "drill": _launches_of(drill_art)}
    out["deadline_shed_total"] = (art["metrics"].get("sched_deadline_shed_total") or {}).get("value")
    if device == "cuda":
        one = {k: v for k, v in launches.items() if k.startswith("kernel=fused_sweep")}
        if set(one) != {f"kernel=fused_sweep,plan={_plan_of(*world['H'].shape, SERVE_LANES)}"} \
                or min(one.values()) <= 0:
            raise AssertionError(f"main server's launches {launches}")
    # the stored matrices: each request's rows the CLI's at the same
    # storage, its frames through that storage's plan at B = lanes
    out["stored"] = {}
    P, V = world["H"].shape
    for storage, rid, tenant, rng in SERVE_STORAGES:
        o = outcome(rid)
        s_served = _served_rows(os.path.join(root, storage, o["output"]), world, device)
        _same_rows(s_served, os.path.join(cli_dir, f"{storage}.h5"), f"the {storage} request")
        s_launch = _launches_of(_artifact_metrics(os.path.join(root, f"{storage}.jsonl")))
        out["launches"][storage] = s_launch
        s_one = {k: v for k, v in s_launch.items() if k.startswith("kernel=fused_sweep")}
        if device == "cuda" and (
                set(s_one) != {f"kernel=fused_sweep,plan={_plan_of(P, V, SERVE_LANES, storage)}"}
                or min(s_one.values()) <= 0):
            raise AssertionError(f"{storage} server's launches {s_launch}")
        out["stored"][storage] = dict(
            tenant=tenant, time_range=rng, status=o["status"], frames=o["frames"],
            latency_s=o["latency_s"], solve_s=o["solve_s"],
            fit_err=s_served["fit_err"].tolist(),
            iterations=s_served["sol"]["iterations"].tolist(),
            cli_ms_per_frame=cli_runs[storage]["ms_per_frame"])
    if geometry_world is not None:
        gid = SERVE_GEOMETRY[0]
        o = outcome(gid)
        g_served = _served_rows(os.path.join(geo_dir, o["output"]), geometry_world, device)
        g_cli = os.path.join(cli_dir, "geometry.h5")
        gp = geometry_world["paths"]
        rc, ms, _text = run_cli(["-o", g_cli, "--geometry", geometry_world["geometry"],
                                 gp["img_a"], gp["img_b"], "-m", cap, *extra, "-t",
                                 SERVE_GEOMETRY[2],
                                 "--no_guess", "--batch_frames", str(SERVE_LANES)], device)
        if rc != 0:
            raise AssertionError(f"CLI --geometry: exit {rc}")
        _same_rows(g_served, g_cli, "the geometry request")
        geo_art = _artifact_metrics(os.path.join(root, "geometry.jsonl"))
        g_launch = _launches_of(geo_art)
        if device == "cuda" and not (g_launch.get("kernel=implicit_forward,plan=-", 0) > 0
                                     and g_launch.get("kernel=implicit_back,plan=-", 0) > 0):
            raise AssertionError(f"geometry server's launches {g_launch}")
        out["launches"]["geometry"] = g_launch
        out["geometry"] = dict(status=o["status"], frames=o["frames"],
                               latency_s=o["latency_s"], fit_err=g_served["fit_err"].tolist(),
                               cli_ms_per_frame=sum(ms) / max(len(ms), 1))
        shutil.rmtree(os.path.dirname(geometry_world["geometry"]), ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)

    # the fused sweep at the serving shape, against its plain version
    if device == "cuda" and rates is not None:
        P, V = world["H"].shape
        out["kernels"] = {}
        for B in (SERVE_LANES, SERVE_DRILL_LANES):
            gc.collect()
            torch.cuda.empty_cache()
            H, w, f, aux, scale = _sweep_inputs(P, V, B, False, True, seed=70 + B)
            kw = dict(logarithmic=False)
            plan = _plan_of(P, V, B)
            record, err = _check_kernel(H, w, f, aux, scale, kw, "float32")
            t = _timing(H, w, f, aux, scale, kw, rates, plan)
            t["max_abs_err"] = err
            t["check"] = record
            out["kernels"][f"float32@B{B}"] = t
            del H, w, f, aux
        gc.collect()
        torch.cuda.empty_cache()
    return out


SELFHEAL_REQUEST = ("heal-1", "diag-a", "0:0.35")  # frames 0-3, lanes 2
SELFHEAL_JOURNAL_DELAY = "0.5"  # s held inside each journal window of part (a)
SELFHEAL_FRAMES = 4  # the campaigns' images: the world's first frames
# the campaigns' seeds, fixed: FaultSchedule(3) arms hdf5.frame_read:io:1:2
# and one SIGKILL in the second dispatched window; FleetSchedule(3, size=2)
# one worker SIGKILL in the first pre-flush window, no controller kill
SELFHEAL_CHAOS_SEED = 3
SELFHEAL_FLEET_SEED = 3
SELFHEAL_FLEET = 2
SELFHEAL_TIMEOUT = 300  # seconds, each campaign's pass and its wait


def _prom_launches(text: str) -> dict:
    """``kernel_launches_total`` of a ``/metrics`` scrape, keyed as
    :func:`_launches_of` keys an artifact's."""
    return {f"kernel={k},plan={p}": float(v) for k, p, v in re.findall(
        r'sart_kernel_launches_total\{kernel="([^"]+)",plan="([^"]+)"\} (\S+)', text)}


def _released_after(free_at_kill: int, footprint: int, kill_unix: float,
                    timeout: float = 10.0) -> Optional[float]:
    """Seconds from the kill until the card's free memory is back up by
    nine tenths of the killed worker's ``footprint`` (nothing else on the
    card allocates meanwhile), or None past ``timeout``."""
    import torch

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if torch.cuda.mem_get_info()[0] >= free_at_kill + 0.9 * footprint:
            return time.time() - kill_unix
        time.sleep(0.01)
    return None


def _chaos_start(argv, log: str):
    """A ``chaos`` campaign in a subprocess, its output in ``log``."""
    with open(log, "w") as out:
        return subprocess.Popen([sys.executable, "-m", "sartsolver_tpu_torch.cli", "chaos",
                                 *argv], cwd=REPO, env=_serve_env(), stdout=out,
                                stderr=subprocess.STDOUT)


def _chaos_wait(proc, log: str, report: str, what: str) -> dict:
    try:
        rc = proc.wait(timeout=2 * SELFHEAL_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    with open(log) as f:
        text = f.read()
    if rc != 0 or not os.path.exists(report):
        raise AssertionError(f"{what}: exit {rc}\n{text[-3000:]}")
    with open(report) as f:
        rec = json.load(f)
    if rec.get("verdict") != "ok" or any(v["verdict"] != "ok" or v["kills_fired"] < 1
                                         or v["restarts"] > v["kills_fired"]
                                         for v in rec["passes"]):
        raise AssertionError(f"{what}: {rec}")
    return dict(rec, exit=rc, supervisor_lines=[
        ln for ln in text.splitlines() if ln.startswith("chaos:")])


def supervised_restart(world, root: str, device: str = "cuda", extra=(),
                       on_killed=None) -> dict:
    """Part (a) of phase ``selfheal``: ``serve --supervised --lanes 2
    --http_port 0 --metrics_out`` on the world, linear with the Laplacian,
    the journal's windows held open (``SART_TEST_JOURNAL_DELAY``), takes
    one request of 4 frames (``SELFHEAL_REQUEST``); its worker (the pid of
    the supervisor's ``worker-spawn`` event) is SIGKILLed inside the
    request's dispatched window, the supervisor restarts it and the restart
    replays the journal: exactly one ``completed`` marker and a ``done``
    response, the rows byte for byte the port CLI's at ``--no_guess
    --batch_frames 2`` over the same frames and within ``FIT_BOUND`` of the
    truth, ``engine_restarts_total{reason="signal:SIGKILL"}`` 1 in
    ``supervisor.prom``; then SIGTERM to the supervisor: one forwarded
    SIGTERM, exit 4. Recorded: the spawned worker's command line (from the
    running process); the kill to the restarted worker's ready, split into
    the supervisor's detection and backoff, process start and imports, the
    CUDA context, the kernel library's load, the ingest with the solver's
    construction and the warm-up (the worker's ``engine: start split``
    line); on the card, when the killed worker's memory came free (the
    card's free memory, nothing else allocating from the supervisor's
    start until then) against when the restart's ingest began; each
    incarnation's launches (``kernel_launches_total``: the first scraped
    from ``/metrics`` just before the kill, the second from the artifact).
    ``on_killed`` is called once that memory is free (or at once off the
    card): the phase starts its campaigns there. ``extra`` (flags of every
    run) sizes the runs to a small world in the tests."""
    import signal as _signal
    import urllib.request

    p = world["paths"]
    cap = str(MAX_ITERATIONS)
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    solve = ["-m", cap, "-l", p["laplacian"], "--device", device, *extra]
    eng = os.path.join(root, "supervised")
    rid, tenant, rng = SELFHEAL_REQUEST
    _stage(eng, [{"id": rid, "tenant": tenant, "time_range": rng}])
    art = os.path.join(root, "supervised.jsonl")
    on_card = device == "cuda"
    if on_card:
        import torch

        free_before = torch.cuda.mem_get_info()[0]
    start_unix = time.time()
    sup = _Serve(["--supervised", "--engine_dir", eng, "--lanes", str(SERVE_LANES),
                  "--http_port", "0", "--metrics_out", art, *solve, *inputs],
                 env=_serve_env(SART_TEST_JOURNAL_DELAY=SELFHEAL_JOURNAL_DELAY))
    try:
        pid1 = int(re.search(r"worker-spawn pid=(\d+)",
                             sup.wait_for(r"worker-spawn pid=")).group(1))
        with open(f"/proc/{pid1}/cmdline", "rb") as f:  # the worker the supervisor ran
            worker_argv = [a.decode() for a in f.read().split(b"\0") if a]
        port1 = re.search(r":(\d+) ", sup.wait_for(r"live endpoints on http")).group(1)
        first_ready_s = sup.matched_at - start_unix
        sup.wait_for(r"SART_JOURNAL_POINT dispatched")
        with urllib.request.urlopen(f"http://127.0.0.1:{port1}/metrics", timeout=10) as r:
            launches1 = _prom_launches(r.read().decode())
        if on_card:
            free_at_kill = torch.cuda.mem_get_info()[0]
        kill_unix = time.time()
        os.kill(pid1, _signal.SIGKILL)
        released_s = (_released_after(free_at_kill, free_before - free_at_kill, kill_unix)
                      if on_card else None)
        if on_killed is not None:
            on_killed()
        split_line = sup.wait_for(r"engine: start split", nth=2)
        sup.wait_for(r"live endpoints on http", nth=2)
        ready_unix = sup.matched_at
        done = _response(eng, rid)
        rc = sup.stop()
    finally:
        if sup.proc.poll() is None:
            sup.proc.kill()
            sup.proc.wait(timeout=60)
    text = sup.text()
    if rc != 4 or text.count("sigterm-forwarded") != 1 or done.get("state") != "done":
        raise AssertionError(f"supervised serve: exit {rc}, {done}\n{text[-3000:]}")
    if "1 accepted-but-unfinished re-queued" not in text:
        raise AssertionError(f"the restart replayed nothing\n{text[-3000:]}")
    with open(os.path.join(eng, "journal.jsonl")) as f:
        marks = [json.loads(ln) for ln in f if ln.strip()]
    completed = sum(m.get("marker") == "completed" and m.get("id") == rid for m in marks)
    with open(os.path.join(eng, "supervisor.prom")) as f:
        prom = f.read()
    with open(os.path.join(eng, "supervisor.jsonl")) as f:
        spawns = [e for e in map(json.loads, f) if e["kind"] == "worker-spawn"]
    if completed != 1 or len(spawns) != 2 or \
            'sart_engine_restarts_total{reason="signal:SIGKILL"} 1' not in prom:
        raise AssertionError(f"supervised serve: {completed} completed markers, "
                             f"{len(spawns)} spawns\n{prom}")
    split = {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)", split_line)}
    parts = {"detect_and_backoff_s": spawns[1]["unix"] - kill_unix,
             "process_start_and_imports_s": split["main_unix"] - spawns[1]["unix"]
             + split["imports_s"]}
    parts.update((k, split[k]) for k in ("cuda_init_s", "kernel_load_s", "ingest_s",
                                         "warm_up_s"))
    kill_to_ready = ready_unix - kill_unix
    parts["rest_s"] = kill_to_ready - sum(parts.values())
    ingest_began = sum(parts[k] for k in ("detect_and_backoff_s", "process_start_and_imports_s",
                                          "cuda_init_s"))
    launches2 = _launches_of(_artifact_metrics(art))
    if device == "cuda":
        plan = f"kernel=fused_sweep,plan={_plan_of(*world['H'].shape, SERVE_LANES)}"
        if {k for k in launches2 if k.startswith("kernel=fused_sweep")} != {plan} \
                or launches2[plan] <= 0:
            raise AssertionError(f"the restarted worker's launches {launches2}")
    cli_path = os.path.join(root, "supervised_cli.h5")
    cli = _cli_twin(cli_path, inputs, cap, p["laplacian"], extra, rng, SERVE_LANES, device)
    served = _served_rows(os.path.join(eng, done["outcome"]["output"]), world, device)
    _same_rows(served, cli_path, "the supervised request")
    return dict(
        exit=rc, worker_command=worker_argv[1:4],
        worker_supervised="--supervised" in worker_argv, start_split_line=split_line.strip(),
        first_ready_s=first_ready_s, kill_to_ready_s=kill_to_ready,
        kill_to_ready_parts=parts, completed_markers=completed, restarts_sigkill=1,
        outcome=done["outcome"], launches_by_incarnation=[launches1, launches2],
        worker_device_bytes=free_before - free_at_kill if on_card else None,
        killed_worker_released_after_s=released_s,
        restart_ingest_began_after_s=ingest_began,
        ingest_saw_memory_held=None if released_s is None else released_s > ingest_began,
        fit_err=served["fit_err"].tolist(), iterations=served["sol"]["iterations"].tolist(),
        cli_ms_per_frame=cli["ms_per_frame"])


def selfheal_phase(world, outdir: str, device: str = "cuda", extra=()) -> dict:
    """The self-healing serve on the world (phase ``selfheal``), three parts
    at once: (a) :func:`supervised_restart`; (b) ``chaos --seeds
    SELFHEAL_CHAOS_SEED --requests 4`` and (c) ``chaos --fleet
    SELFHEAL_FLEET --seeds SELFHEAL_FLEET_SEED``, on the world's matrix
    with images of its first ``SELFHEAL_FRAMES`` frames (a request without a
    range covers every frame), started once (a)'s killed worker has freed
    the card's memory, and run while (a)'s restart comes up: each judged
    ``ok`` with its kill fired and no more restarts than kills."""
    import shutil

    p = world["paths"]
    root = os.path.join(outdir, "selfheal")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    npix = world["G"].shape[0] // 2
    short = {}
    for key, camera, rows in (("img_a", "camA", slice(0, npix)),
                              ("img_b", "camB", slice(npix, None))):
        short[key] = os.path.join(root, f"{key}_{SELFHEAL_FRAMES}.h5")
        _write_image(short[key], camera,
                     world["G"][rows, :SELFHEAL_FRAMES].T.reshape(SELFHEAL_FRAMES,
                                                                  *world["cam"]),
                     world["times"][:SELFHEAL_FRAMES])
    worker = ["--", "-m", str(MAX_ITERATIONS), "-l", p["laplacian"], "--device", device,
              *extra, "--lanes", str(SERVE_LANES), p["rtm_a_seg1"], p["rtm_a_seg2"],
              p["rtm_b"], short["img_a"], short["img_b"]]
    out = {"lanes": SERVE_LANES, "journal_delay_s": float(SELFHEAL_JOURNAL_DELAY),
           "campaign_frames": SELFHEAL_FRAMES}
    campaigns = {}

    def start_campaigns():
        out["campaigns_started_at_s"] = time.perf_counter() - t0
        for name, flags in (("chaos", ["--seeds", str(SELFHEAL_CHAOS_SEED), "--requests",
                                       "4"]),
                            ("fleet", ["--fleet", str(SELFHEAL_FLEET), "--seeds",
                                       str(SELFHEAL_FLEET_SEED)])):
            report, log = (os.path.join(root, f"{name}.{x}") for x in ("json", "log"))
            campaigns[name] = (_chaos_start(
                ["--engine_dir", os.path.join(root, name), *flags, "--timeout",
                 str(SELFHEAL_TIMEOUT), "--report", report, *worker], log), log, report)

    try:
        out["supervised"] = supervised_restart(world, root, device, extra,
                                               on_killed=start_campaigns)
        out["supervised_s"] = time.perf_counter() - t0
        for name, (proc, log, report) in campaigns.items():
            out[name] = _chaos_wait(proc, log, report, f"chaos {name}")
            out[name]["ended_at_s"] = time.perf_counter() - t0
    finally:
        for proc, *_ in campaigns.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


POD_FRAMES = 16  # the pod phase's images: the world's first frames
POD_LANES = 4  # --batch_frames of every worker: one_read fp32 at B = 4
POD_CKPT_STRIDE = 2
POD_DEADLINE = "10"  # SART_POD_BARRIER_TIMEOUT of every pass
POD_SEEDS = "0,3"  # the JAX CI pair: 0 a ckpt kill, 3 a stride kill
POD_TIMEOUT = 300  # seconds, each pass and each torchrun
# the grid runs' windows, the whole series and its first half (0.0 .. 0.7),
# on one explicit tick of 0.1 s: a window's derived tick is its own, and
# moves a composite frame time by a few ulps from the whole series'
POD_GRID_ALL = "0:1.55:0.1"
POD_GRID_HALF = "0:0.75:0.1"


def _pod_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SART_POD_") and k not in (
               "SART_FAULT", "SART_SOLVE_CKPT_FILE", "SART_TEST_POD_MARKERS",
               "SART_TEST_SOLVE_CKPT_DELAY", "SART_TRACE_EVENTS")}
    env.update(PYTHONPATH=REPO, PYTHONUNBUFFERED="1", SART_POD_BARRIER_TIMEOUT=POD_DEADLINE,
               **extra)
    return env


def _pod_run(procs_argv, envs) -> tuple:
    """Start one CLI process per argv at once; their exit codes, stdout,
    stderr and the pass's seconds (every process killed past
    ``POD_TIMEOUT``)."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "sartsolver_tpu_torch.cli", *argv],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in zip(procs_argv, envs)]
    try:
        outs = [p.communicate(timeout=POD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    return [p.returncode for p in procs], outs, time.perf_counter() - t0


def _text_of(path: str) -> str:
    with open(path) as f:
        return f.read()


def _same_datasets(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


def _pod_worker_record(out: str, art: str, stdout: str, world, n_frames: int, device) -> dict:
    ms = [float(m) for m in re.findall(r"Processed in: ([0-9.eE+-]+) ms", stdout)]
    steps = re.search(r"loop_steps=(\d+)", stdout)
    sol, err = check_solution(out, world, n_frames, MAX_ITERATIONS, device)
    launches = _launches_of(_artifact_metrics(art))
    return dict(frames=len(ms), ms_per_frame=sum(ms) / max(len(ms), 1), frame_ms=ms,
                loop_steps=int(steps.group(1)) if steps else None,
                launches=launches, status=sol["status"].tolist(),
                iterations=sol["iterations"].tolist(), fit_err=err.tolist())


def pod_phase(world, outdir: str, device: str = "cuda", extra=()) -> dict:
    """The pod (phase ``pod``) on the world's matrix and its first
    ``POD_FRAMES`` frames, every worker ``--no_guess --batch_frames
    POD_LANES --solve_ckpt_stride POD_CKPT_STRIDE -m MAX_ITERATIONS -l
    <laplacian>`` (the scheduler on ``one_read`` fp32 at B = 4), each pass
    on a fresh barrier directory at ``SART_POD_BARRIER_TIMEOUT=10``:

    (a) one solo run, alone, then two fake-pod workers
        (``SART_POD_PROCESS=k/2``): the campaign's reference pass, whose
        workers keep their stdout and metrics artifact. All three files
        the same datasets bit for bit; each worker's ms per frame against
        the solo run's, its ``kernel_launches_total`` all on the plan
        ``plan_sweep`` gives B = 4, as many as the loop steps it printed;
    (b) ``chaos --pod 2 --seeds 0,3`` over the same flags, judged ``ok``:
        each survivor's exit within the deadline plus 15 s of the kill, the
        agreed resume serials (a ckpt kill's below the killed serial);
    (c) beside (b)'s seeds, once its reference pass has ended (the pod's
        frame times its own), a 2x1 grid under torchrun (``--multihost
        --pixel_shards 2``, the ranks sharing the card over gloo; the
        classic grouped loop): a ``-t`` run over the first half of the
        frames, then ``--resume``, its datasets bit for bit an
        uninterrupted 2x1 run's, whose statuses are the solo run's and
        whose rows are within ``GRID_FIT_TOL`` of them in fitted space; the
        resume view's broadcast timed (its ``resume.broadcast`` span); then
        rank 1 of two SIGKILLed in its ingest turn, rank 0's exit 3 within
        the deadline plus 15 s.
    Any miss raises. ``extra`` (flags of every run) sizes the runs to a
    small world in a rehearsal."""
    import shutil

    p = world["paths"]
    root = os.path.join(outdir, "pod")
    os.makedirs(root, exist_ok=True)
    t_phase = time.perf_counter()
    npix = world["G"].shape[0] // 2
    short = {}
    for key, camera, rows in (("img_a", "camA", slice(0, npix)),
                              ("img_b", "camB", slice(npix, None))):
        short[key] = os.path.join(root, f"{key}_{POD_FRAMES}.h5")
        _write_image(short[key], camera,
                     world["G"][rows, :POD_FRAMES].T.reshape(POD_FRAMES, *world["cam"]),
                     world["times"][:POD_FRAMES])
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], short["img_a"], short["img_b"]]
    solve = ["-m", str(MAX_ITERATIONS), "-l", p["laplacian"], "--device", device,
             "--no_guess", "--batch_frames", str(POD_LANES), *extra]
    ckpt = ["--solve_ckpt_stride", str(POD_CKPT_STRIDE)]
    P, V = world["H"].shape
    plan = f"kernel=fused_sweep,plan={_plan_of(P, V, POD_LANES)}"
    out = {"frames": POD_FRAMES, "lanes": POD_LANES, "ckpt_stride": POD_CKPT_STRIDE,
           "barrier_timeout_s": float(POD_DEADLINE), "plan": plan}

    def worker(rec):
        if device == "cuda" and (set(rec["launches"]) != {plan}
                                 or rec["launches"][plan] != rec["loop_steps"]):
            raise AssertionError(f"pod worker launches {rec['launches']}, "
                                 f"loop steps {rec['loop_steps']}")
        return rec

    # (a) the solo run alone, then (b) the campaign, whose reference pass
    # is the two fake-pod workers; (c) the grid starts once that pass has
    # ended, so the pod's frame times are not shared with the grid's
    solo_out, solo_art = os.path.join(root, "solo.h5"), os.path.join(root, "solo.jsonl")
    (rc,), (solo_text,), solo_s = _pod_run(
        [["-o", solo_out, *inputs, *solve, *ckpt, "--metrics_out", solo_art]], [_pod_env()])
    if rc != 0:
        raise AssertionError(f"pod solo run: exit {rc}\n{solo_text[1][-3000:]}")
    solo_rows = _read_rows(solo_out)
    solo = worker(_pod_worker_record(solo_out, solo_art, solo_text[0], world, POD_FRAMES,
                                     device))
    out["solo"] = dict(seconds=solo_s, **solo)

    report, log = (os.path.join(root, f"chaos.{x}") for x in ("json", "log"))
    with open(log, "w") as log_f:
        chaos = subprocess.Popen(
            [sys.executable, "-m", "sartsolver_tpu_torch.cli", "chaos", "--engine_dir",
             os.path.join(root, "chaos"), "--pod", "2", "--seeds", POD_SEEDS, "--timeout",
             str(POD_TIMEOUT), "--report", report, "--", *inputs, *solve, *ckpt],
            cwd=REPO, env=_pod_env(), stdout=log_f, stderr=subprocess.STDOUT)
    t_chaos = time.perf_counter()
    try:
        # the first seed's line follows the reference pass
        while chaos.poll() is None and "chaos: pod seed" not in _text_of(log):
            if time.perf_counter() - t_chaos > POD_TIMEOUT:
                raise AssertionError(f"chaos --pod 2: no seed began\n{_text_of(log)[-3000:]}")
            time.sleep(0.2)
        if chaos.poll() in (None, 0):
            out["grid"] = _pod_grid(world, root, inputs, solve, solo_rows, device)
        rc = chaos.wait(timeout=3 * POD_TIMEOUT)
        chaos_s = time.perf_counter() - t_chaos
    finally:
        if chaos.poll() is None:
            chaos.kill()
            chaos.wait(timeout=60)
    with open(log) as f:
        text = f.read()
    if rc != 0 or not os.path.exists(report):
        raise AssertionError(f"chaos --pod 2: exit {rc}\n{text[-3000:]}")
    with open(report) as f:
        rec = json.load(f)
    deadline = float(POD_DEADLINE)
    for v in rec.get("passes", ()):
        if (v["verdict"] != "ok" or v["barrier_timeout_s"] != deadline
                or not all(s < deadline + 15 for s in v["survivor_exit_after_kill_s"])
                or (v["window"].startswith("ckpt")
                    and v["resumed_serial"] >= v["killed_serial"])):
            raise AssertionError(f"chaos --pod 2 seed {v['seed']}: {v}")
    if rec.get("verdict") != "ok" or [v["seed"] for v in rec["passes"]] != [
            int(s) for s in POD_SEEDS.split(",")]:
        raise AssertionError(f"chaos --pod 2: {rec}")
    out["chaos"] = dict(rec, seconds=chaos_s,
                        lines=[ln for ln in text.splitlines() if ln.startswith("chaos:")])
    refs = rec["reference_workers"]
    if len(refs) != 2 or not all(_same_datasets(_read_rows(w["output"]), solo_rows)
                                 for w in refs):
        raise AssertionError("the fake-pod workers' files are not the solo run's")
    pair = [worker(_pod_worker_record(w["output"], w["metrics"], _text_of(w["stdout"]), world,
                                      POD_FRAMES, device)) for w in refs]
    ref_dir = os.path.dirname(refs[0]["output"])
    bdir = os.path.join(ref_dir, "barriers")
    out["pair"] = dict(seconds=rec["reference_s"], workers=pair,
                       stride_barriers=len([n for n in os.listdir(bdir)
                                            if n.startswith("stride.") and ".h0." in n]),
                       ckpt_files=sorted(n for n in os.listdir(ref_dir) if ".solveckpt." in n),
                       ms_per_frame_pod_over_solo=[w["ms_per_frame"] / solo["ms_per_frame"]
                                                   for w in pair])
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _pod_grid_kill(root: str, inputs, solve) -> dict:
    """Two ranks of the CLI started with the launcher's environment (not
    torchrun, which would stop rank 0 itself), rank 1 SIGKILLed as its
    ingest turn starts (``SART_POD_POINT ingest turn=1``): rank 0 must
    leave the turn's rendezvous over the process group with exit 3 within
    the deadline plus 15 s."""
    import signal as _signal
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(root, "grid_killed.h5")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sartsolver_tpu_torch.cli", "-o", out, *inputs, *solve,
         "--multihost", "--pixel_shards", "2"], cwd=REPO,
        env=_pod_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     SART_TEST_POD_MARKERS="1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for line in procs[1].stderr:
            if line.strip() == "SART_POD_POINT ingest turn=1":
                procs[1].send_signal(_signal.SIGKILL)
                killed = time.perf_counter()
                break
        else:
            raise AssertionError("pod grid kill: rank 1 ended before its ingest turn")
        err = procs[0].communicate(timeout=POD_TIMEOUT)[1]
        exit_after = time.perf_counter() - killed
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
    line = next((ln for ln in err.splitlines() if ln.startswith("Aborted at a pod barrier")),
                None)
    if procs[0].returncode != 3 or line is None or \
            not exit_after < float(POD_DEADLINE) + 15:
        raise AssertionError(f"pod grid kill: rank 0 exit {procs[0].returncode} after "
                             f"{exit_after} s\n{err[-3000:]}")
    return dict(exit=procs[0].returncode, exit_after_kill_s=exit_after, abort_line=line)


def _pod_grid(world, root: str, inputs, solve, solo_rows, device) -> dict:
    """Part (c) of phase ``pod``: three torchruns of the CLI over 2 ranks
    (the uninterrupted run and the first half at once, then ``--resume``),
    then the ingest-turn kill (:func:`_pod_grid_kill`)."""
    def start(name, flags):
        target = os.path.join(root, "grid_full.h5" if name == "full" else "grid_cut.h5")
        return subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "2", "-m", "sartsolver_tpu_torch.cli", "-o", target, *inputs, *solve,
             "--multihost", "--pixel_shards", "2", *flags], cwd=REPO,
            env=_pod_env(SART_TRACE_EVENTS=os.path.join(root, f"grid_{name}.trace.json")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), time.perf_counter()

    def finish(name, launch) -> dict:
        proc, t0 = launch
        try:
            out, err = proc.communicate(timeout=POD_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"pod grid run {name}: exit {proc.returncode}\n"
                                 f"{out[-2000:]}\n{err[-3000:]}")
        ms = [float(m) for m in re.findall(r"Processed in: ([0-9.eE+-]+) ms", out)]
        line = next((ln for ln in out.splitlines() if ln.startswith("solver: ")), "")
        if "mesh=2x1 " not in line or "collectives=gloo" not in line:
            raise AssertionError(f"pod grid run {name}: solver line {line!r}")
        broadcast = None
        if name == "resumed":
            with open(os.path.join(root, "grid_resumed.trace.json")) as f:
                spans = [e for e in json.load(f)["traceEvents"]
                         if e.get("name") == "resume.broadcast"]
            if len(spans) != 1:
                raise AssertionError(f"pod grid resume: {len(spans)} resume.broadcast spans")
            broadcast = spans[0]["dur"] / 1e6
        return dict(seconds=seconds, frames=len(ms), ms_per_frame=sum(ms) / max(len(ms), 1),
                    broadcast_s=broadcast)

    # the uninterrupted run and the cut one at once (two files), then the resume
    launches = {"full": start("full", ["-t", POD_GRID_ALL]),
                "half": start("half", ["-t", POD_GRID_HALF])}
    try:
        runs = {name: finish(name, launch) for name, launch in launches.items()}
    finally:
        for proc, _t0 in launches.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    runs["resumed"] = finish("resumed", start("resumed", ["-t", POD_GRID_ALL, "--resume"]))
    runs["killed"] = _pod_grid_kill(root, inputs, solve)
    half = runs["half"]["frames"]
    if half != POD_FRAMES // 2 or runs["resumed"]["frames"] != POD_FRAMES - half:
        raise AssertionError(f"pod grid: {half} frames, then {runs['resumed']['frames']}")
    full, cut = (_read_rows(os.path.join(root, n)) for n in ("grid_full.h5", "grid_cut.h5"))
    if not _same_datasets(full, cut):
        raise AssertionError("pod grid: the resumed file is not the uninterrupted run's")
    dist = _fitted_distance(world, full["value"], solo_rows["value"], device)
    if not np.array_equal(full["status"], solo_rows["status"]) or \
            not (dist <= GRID_FIT_TOL).all():
        raise AssertionError(f"pod grid: statuses {full['status']} / {solo_rows['status']}, "
                             f"fitted distance {dist}")
    return dict(runs=runs, status=full["status"].tolist(),
                iterations=full["iterations"].tolist(),
                fitted_distance_to_solo=dist.tolist(), fit_tol=GRID_FIT_TOL)

def _cli_twin(out, inputs, cap, laplacian, extra, time_range, lanes, device) -> dict:
    """The one-shot CLI over a request's frames at the server's lanes
    (``--no_guess --batch_frames``): its wall and ms per frame."""
    t0 = time.perf_counter()
    rc, ms, _text = run_cli(["-o", out, *inputs, "-m", cap, "-l", laplacian, *extra, "-t",
                             time_range, "--no_guess", "--batch_frames", str(lanes)], device)
    if rc != 0:
        raise AssertionError(f"CLI over {time_range} at {lanes} lanes: exit {rc}")
    return dict(wall_s=time.perf_counter() - t0, frames=len(ms),
                ms_per_frame=sum(ms) / max(len(ms), 1))


def _plan_of(P: int, V: int, B: int, storage: str = "float32") -> str:
    from sartsolver_tpu_torch.ops.fused_sweep import plan_sweep

    return plan_sweep(P, V, B, storage)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available.", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import sartsolver_tpu_torch

    if os.path.dirname(os.path.abspath(sartsolver_tpu_torch.__file__)) != \
            os.path.join(REPO, "sartsolver_tpu_torch"):
        print("chip_smoke: run it from a checkout of the repository.", file=sys.stderr)
        return 1
    from sartsolver_tpu_torch.models.sart import make_problem, solve
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.io.laplacian_io import read_laplacian
    from sartsolver_tpu_torch.ops import _build
    from sartsolver_tpu_torch.ops.fused_sweep import (
        fused_sweep, fused_sweep_reference, plan_sweep, reset_launch_counts,
    )
    from sartsolver_tpu_torch.ops.laplacian import make_laplacian
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver, os_padded_rows
    from sartsolver_tpu_torch.sched import ContinuousBatcher

    t_start = time.perf_counter()
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi,
         device=card, count=torch.cuda.device_count())

    scratch = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        # nvcc runs in its own processes while the host writes the e2e world
        # and the operators phase's reflective world
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            built = pool.submit(_build.build_all)
            world = write_world(tmp)
            world_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            reflective = write_reflective_world(os.path.join(tmp, "reflective"))
            reflective["world_seconds"] = time.perf_counter() - t1
            built.result()
        emit("build", seconds=time.perf_counter() - t0, world_written_meanwhile_s=world_s,
             reflective_world_written_meanwhile_s=reflective["world_seconds"],
             sources=sorted(p.name for p in _build.CSRC.glob("*.cu")),
             into=os.path.relpath(_build.BUILD_DIR, REPO))

        # first, in a process whose profiler has recorded nothing yet: later
        # on it leaves out CUDA kernels (all of them after phase obs, now and
        # then a call's after debug_nans), and the audit's agreement needs
        # every one (PERF.md section 7)
        emit("audit", **audit_phase(world))
        # the split kernels' profiled kernels a call, in the same clean window
        t0 = time.perf_counter()
        split = split_kernels(PEAKS["PCIe" if "PCIe" in card else "SXM"])
        split_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        errors, timing = kernel_phase(card)

        p = world["paths"]
        inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]

        # the main path, once per storage type: counts zeroed just before,
        # read just after
        cap = str(MAX_ITERATIONS)
        H_dev = torch.as_tensor(world["H"], device="cuda")
        runs, values, by_plan_of = {}, {}, {}
        reset_launch_counts()
        for storage in STORAGES:
            plans_before = dict(fused_sweep.launches_by_plan)
            # --chain_frames 1: every frame its own group, so its own time
            # (the guess frame apart from the warm ones); the chain is held
            # against it in the frames phase
            for name, flags, n_frames in (
                ("linear", ["-l", p["laplacian"], "-t", "0:0.75", "--chain_frames", "1"], 8),
                ("log", ["-L", "-t", "0:0.35", "--chain_frames", "1"], 4),
            ):
                out = os.path.join(tmp, f"solution_{storage}_{name}.h5")
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                rc, ms, _ = run_cli(["-o", out, *inputs, "-m", cap, *flags,
                                     "--rtm_dtype", storage])
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() - base
                if rc != 0 or len(ms) != n_frames:
                    raise AssertionError(f"{storage} {name} run: exit {rc}, {len(ms)} frames")
                sol, err = check_solution(out, world, n_frames, MAX_ITERATIONS, "cuda")
                values[storage, name] = sol["value"]
                fp32 = values["float32", name]
                fit = H_dev @ torch.as_tensor(sol["value"].T, dtype=torch.float32,
                                              device="cuda")
                ref = H_dev @ torch.as_tensor(fp32.T, dtype=torch.float32, device="cuda")
                to_fp32 = ((fit - ref).norm(dim=0) / ref.norm(dim=0)).cpu().numpy()
                runs[f"{storage}_{name}"] = dict(
                    storage=storage, frames=n_frames, exit=rc, wall_s=wall, frame_ms=ms,
                    iterations=sol["iterations"].tolist(), status=sol["status"].tolist(),
                    fit_err=err.tolist(), fitted_distance_to_float32=to_fp32.tolist(),
                    peak_device_bytes=peak)
            by_plan_of[storage] = {plan: n - plans_before[plan]
                                   for plan, n in fused_sweep.launches_by_plan.items()}
        launches = fused_sweep.launches
        by_storage = dict(fused_sweep.launches_by_storage)
        by_plan = dict(fused_sweep.launches_by_plan)
        iters = {st: sum(sum(r["iterations"]) for r in runs.values() if r["storage"] == st)
                 for st in STORAGES}
        # one launch per iteration, each storage type's through the plan
        # plan_sweep gives the CLI's shape (B = 1)
        want = {st: {plan: 0 for plan in by_plan} for st in STORAGES}
        for st in STORAGES:
            want[st][plan_sweep(8192, 65536, 1, st)] = iters[st]
        if launches != sum(iters.values()) or by_plan_of != want or any(
                by_storage[st] <= 0 or by_storage[st] != iters[st] for st in STORAGES):
            raise AssertionError(f"main path made {by_storage} / {by_plan_of} kernel "
                                 f"launches for {iters} iterations")
        emit("solve", world_seconds=world_s, max_iterations=MAX_ITERATIONS,
             fit_bound=FIT_BOUND, fused_sweep_launches=launches,
             launches_by_storage=by_storage, launches_by_plan=by_plan,
             launches_by_storage_and_plan=by_plan_of, iterations_by_storage=iters, runs=runs)
        del H_dev

        frames = frames_phase(world, tmp)
        emit("frames", max_iterations=MAX_ITERATIONS, fit_bound=FIT_BOUND, **frames)
        variants = variants_phase(world, tmp)
        emit("variants", max_iterations=MAX_ITERATIONS, fit_bound=FIT_BOUND, **variants)
        t0 = time.perf_counter()
        os_rec = os_phase(world, tmp)
        emit("os", seconds=time.perf_counter() - t0, max_iterations=MAX_ITERATIONS,
             fit_bound=FIT_BOUND, **os_rec)
        emit("debug_nans", **debug_nans_phase(world, tmp))
        t0 = time.perf_counter()
        obs = obs_phase(world, tmp, card=card)
        emit("obs", seconds=time.perf_counter() - t0, **obs)
        t0 = time.perf_counter()
        ingest = ingest_phase(world, tmp)
        emit("ingest", seconds=time.perf_counter() - t0, **ingest)
        t0 = time.perf_counter()
        resilience = resilience_phase(world, tmp)
        emit("resilience", seconds=time.perf_counter() - t0, **resilience)
        t0 = time.perf_counter()
        sparse = sparse_phase(world, tmp, rates=PEAKS["PCIe" if "PCIe" in card else "SXM"])
        emit("sparse", seconds=time.perf_counter() - t0, **sparse)
        t0 = time.perf_counter()
        kept = {}
        operators = operators_phase(tmp, world=world,
                                    rates=PEAKS["PCIe" if "PCIe" in card else "SXM"],
                                    reflective=reflective, keep_geometry=kept)
        del reflective
        emit("operators", seconds=time.perf_counter() - t0, fit_tol=OPERATOR_FIT_TOL,
             max_iterations=MAX_ITERATIONS, **operators)
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        serve = serve_phase(world, tmp, kept.pop("world"),
                            rates=PEAKS["PCIe" if "PCIe" in card else "SXM"])
        emit("serve", seconds=time.perf_counter() - t0, card=smi, fit_bound=FIT_BOUND,
             max_iterations=MAX_ITERATIONS, **serve)
        selfheal = selfheal_phase(world, tmp)
        emit("selfheal", card=smi, fit_bound=FIT_BOUND, max_iterations=MAX_ITERATIONS,
             **selfheal)
        gc.collect()
        torch.cuda.empty_cache()
        pod = pod_phase(world, tmp)
        emit("pod", card=smi, fit_bound=FIT_BOUND, max_iterations=MAX_ITERATIONS, **pod)

        V = world["H"].shape[1]
        rows, cols, vals = read_laplacian(p["laplacian"], V)
        lap = make_laplacian(rows, cols, vals, nvoxel=V, device="cuda")
        batch = batch_phase(world, lap)
        emit("batch", **batch)
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        grid = grid_phase(world, tmp, kernels=split, kernels_s=split_s)
        emit("grid", seconds=time.perf_counter() - t0, **grid)

        # frame 0 of the linear run, through the kernel and the plain version
        opts = SolverOptions(max_iterations=MAX_ITERATIONS)
        problem = make_problem(world["H"], lap, opts=opts, device="cuda")
        g0 = world["G"][:, 0].astype(np.float64)
        cross = {}
        for name, fn in (("kernel", fused_sweep), ("plain", fused_sweep_reference)):
            t0 = time.perf_counter()
            res = solve(problem, g0, opts=opts, device="cuda", sweep_fn=fn)
            fitted = problem.rtm @ res.solution
            torch.cuda.synchronize()
            cross[name] = dict(status=int(res.status), iterations=int(res.iterations),
                               seconds=time.perf_counter() - t0, fitted=fitted)
        k, q = cross["kernel"], cross["plain"]
        diff = float((k["fitted"] - q["fitted"]).norm() / q["fitted"].norm())
        if (k["status"] != q["status"] or abs(k["iterations"] - q["iterations"]) > 1
                or diff > CROSS_TOL):
            raise AssertionError(f"kernel vs plain on frame 0: {k['status']}/{q['status']}, "
                                 f"{k['iterations']}/{q['iterations']}, fitted {diff}")
        emit("plain_crosscheck", tolerance=CROSS_TOL, fitted_rel_diff=diff,
             **{n: {kk: v for kk, v in c.items() if kk != "fitted"} for n, c in cross.items()})
        del problem
        # frame 0 from the guess, serially, and the first FRAME_LANES frames
        # as one group of the classic loop and through the scheduler's lanes,
        # per storage type
        group = world["G"][:, :FRAME_LANES].T.astype(np.float64)
        profiles = {}
        for storage in STORAGES:
            st_opts = SolverOptions(max_iterations=MAX_ITERATIONS,
                                    rtm_dtype=None if storage == "float32" else storage)
            with DistributedSARTSolver(world["H"], lap, opts=st_opts, device="cuda") as solver:
                frame0, res = profile_run(lambda: solve(solver.problem, g0, opts=st_opts,
                                                        device="cuda"))
                grouped, iters = profile_run(lambda: solver.solve_batch(group).iterations)
                batcher = ContinuousBatcher(solver, lanes=FRAME_LANES,
                                            on_result=lambda *r: r[5]())
                lanes, stats = profile_run(lambda: batcher.run(
                    (frame, float(t), [float(t)]) for t, frame in enumerate(group)))
                # one OS guess frame on the same stored matrix (P divides
                # into OS_SUBSETS, so the OS solver's problem is this one):
                # its iterations' device ms split into the subset forwards,
                # the subset back projections and the full forward; the
                # rest of the wall time is the host's
                os_opts = SolverOptions(max_iterations=MAX_ITERATIONS, os_subsets=OS_SUBSETS,
                                        rtm_dtype=st_opts.rtm_dtype)
                npix = world["H"].shape[0]
                if os_padded_rows(npix, OS_SUBSETS) != npix:
                    raise AssertionError(f"P = {npix} does not divide into {OS_SUBSETS} subsets")
                solve(solver.problem, g0, opts=os_opts, device="cuda")  # warm-up
                os_frame0, os_res = profile_run(
                    lambda: solve(solver.problem, g0, opts=os_opts, device="cuda"),
                    ranges=OS_RANGES)
            its = int(os_res.iterations)
            split = os_frame0["range_device_ms"]
            os_frame0.update(
                iterations=its, os_subsets=OS_SUBSETS,
                per_iteration_ms={k: v / its for k, v in split.items()},
                rest_device_ms=os_frame0["device_busy_ms"] - sum(split.values()),
                host_ms=os_frame0["wall_ms"] - os_frame0["device_busy_ms"],
                wall_ms_per_iteration=os_frame0["wall_ms"] / its)
            profiles[storage] = dict(frame0, iterations=int(res.iterations), os_frame0=os_frame0,
                                     batch=dict(grouped, frames=FRAME_LANES,
                                                loop_iterations=int(iters.max())),
                                     scheduled=dict(lanes, frames=FRAME_LANES,
                                                    loop_steps=stats.loop_steps,
                                                    strides=stats.strides))
        emit("profile", **profiles)
        for name in ("rtm_a_seg1", "rtm_a_seg2", "rtm_b"):
            os.remove(p[name])  # the e2e RTM's 2 GiB on disk, before the tall world's 4 GiB
        del lap, world
        gc.collect()
        torch.cuda.empty_cache()
        tall_dir = os.path.join(tmp, "tall")
        os.makedirs(tall_dir)
        tall = tall_world_phase(tall_dir)
        emit("tall_world", max_iterations=MAX_ITERATIONS, fit_bound=FIT_BOUND, **tall)

    def row(name, t, launches, err, variant, replaces=REPLACES):
        r = {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": t["library_ms"], "plan": t["plan"], "storage": t["storage"],
             "cuda_kernels_per_launch": t["device"]["kernels_per_call"],
             "bound_rate": t["bound_rate"], "variant": variant, "shape": t["shape"]}
        if "versus" in t:
            r["two_read_ms"] = t["versus"]["ms"]
            r["two_read_bound_ms"] = t["versus"]["bound_ms"]
        return r

    rows = [row("fused_sweep" if storage == "float32" else f"fused_sweep[{storage}]",
                timing[storage], by_plan_of[storage][timing[storage]["plan"]],
                errors[storage], VARIANT[storage])
            for storage in STORAGES]
    for storage in STORAGES:
        key = f"{storage}@B{FRAME_LANES}"
        batch_runs = (frames[storage]["scheduled"], frames[storage]["classic"])
        r = row(("fused_sweep" if storage == "float32" else f"fused_sweep[{storage}]")
                + f"@B{FRAME_LANES}", timing[key],
                sum(run["launches_by_plan"][timing[key]["plan"]] for run in batch_runs),
                errors[key], f"{VARIANT[storage]} at the batch loops' B = {FRAME_LANES}")
        log = timing[key + "_log"]
        r.update(log_ms=log["ms"], log_plain_ms=log["plain_ms"], log_bound_ms=log["bound_ms"],
                 log_library_ms=log["library_ms"], log_two_read_ms=log.get("versus", {}).get("ms"))
        rows.append(r)
    for lanes, name, key in (
            (SIXTEEN_LANES, "sixteen_lanes", f"float32@B{SIXTEEN_LANES}"),
            (THIRTY_TWO_LANES, "thirty_two_lanes", f"float32@8192x65536xB{THIRTY_TWO_LANES}")):
        wide = frames["float32"][name]
        plan = timing[key]["plan"]
        r = row(f"fused_sweep@B{lanes}", timing[key],
                wide["launches_by_plan"][plan] + wide["classic"]["launches_by_plan"][plan],
                errors[key], f"B1/B2 at --batch_frames {lanes} (two_read, one pass over H)")
        r["two_read_floor_ms"] = timing[key]["two_read_floor_ms"]
        rows.append(r)
    # the tall world's shape, each storage through two_read (P past one_read's)
    for storage in STORAGES:
        P, V = tall["shape"]
        key = f"{storage}@{P}x{V}xB1"
        r = row(("fused_sweep" if storage == "float32" else f"fused_sweep[{storage}]")
                + f"@{P}x{V}", timing[key], tall[storage]["launches_by_plan"]["two_read"],
                errors[key], f"{VARIANT[storage]} on the tall world (P = {P}, two_read)")
        r["two_read_floor_ms"] = timing[key]["two_read_floor_ms"]
        rows.append(r)
    # the compacted call of the block-sparse runs (--sparse_rtm): the
    # occupied columns of the dark world, each storage at B = 1, fp32 at 8
    for key, t in sparse["kernels"].items():
        P_s, V_s, B_s = t["shape"]
        storage = t["storage"]
        name = (("fused_sweep" if storage == "float32" else f"fused_sweep[{storage}]")
                + f"_sparse@{P_s}x{V_s}" + (f"xB{B_s}" if B_s > 1 else ""))
        rows.append(row(name, t, sparse["launches"][key], t["max_abs_err"],
                        f"{VARIANT[storage]} on the occupied voxel columns (--sparse_rtm)"))
    # the implicit projector (no Pallas counterpart), its two entry points at
    # the geometry world's shape; launches: the geometry runs' of the phase
    for key, t in operators["kernels"].items():
        if "@" not in key:
            continue  # the table's checks and the work counts, not a row
        which, B = key.split("@")
        rows.append({"name": f"implicit_{which}@{B}", "route": "cuda",
                     "source": IMPLICIT_SOURCE, "replaces": IMPLICIT_REPLACES,
                     "launches": t["launches"], "max_abs_err": t["max_abs_err"],
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "shape": t["shape"], "pairs_evaluated": t["pairs_evaluated"],
                     "nnz": t["nnz"], "variant": "the implicit operator (--geometry)"})
    # the pixel-sharded sweep split at the all-reduce (no Pallas
    # counterpart), fp32 at the 2x1 grid's block; launches: every rank's of
    # the fp32 grid runs on a pixel-sharded grid (bf16 and int8 are checked
    # and timed in the phase, not run there)
    k = grid["kernels"]["float32"]
    for which in ("bp", "finish"):
        t = k[which]
        rows.append({
            "name": f"sharded_sweep_{which}", "route": "cuda", "source": SOURCE,
            "replaces": GRID_REPLACES,
            "launches": sum(lr[f"sharded_sweep_{which}"] for r in grid["runs"].values()
                            for lr in r["launches"]),
            "max_abs_err": k[f"max_abs_err_{which}"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": k["shape"], "storage": "float32",
            "route": t["route"], "kernels_per_call": t["kernels_per_call"],
            "device_ms": t["device_ms"],
            "variant": "the pixel-sharded sweep, split at the all-reduce"})
    # the fused sweep at the serving engine's lanes: B = 2 (the main server)
    # and B = 4 (the SIGTERM drill's restart); launches: those servers'
    # kernel_launches_total on the plan,
    # and at B = 2 the supervised worker's incarnations (phase selfheal)
    healed = selfheal["supervised"]["launches_by_incarnation"]
    for B, server in ((SERVE_LANES, "main"), (SERVE_DRILL_LANES, "drill")):
        t = serve["kernels"][f"float32@B{B}"]
        key = f"kernel=fused_sweep,plan={t['plan']}"
        launches = serve["launches"][server].get(key, 0)
        if B == SERVE_LANES:
            launches += sum(inc.get(key, 0) for inc in healed)
        rows.append(row(f"fused_sweep_serve@B{B}", t, launches, t["max_abs_err"],
                        f"B1/B2 in the serving engine at --lanes {B}"))
    for name, replaces, _ in PROBES:
        rows.append(row(name, timing[name], batch["launches_by_plan"]["tensor_core"],
                        timing[name]["max_abs_err"], "B4 at the probe's B = 32", replaces))
    # the scheduled log update, each plan with the runs of the variants
    # phase that launched it (B = 1: the serial decay run; B = 8: the scheduler
    # and the classic loop; int8 B = 4: four lanes)
    for storage, B in SCHED_CASES:
        v = variants[storage]
        runs_of = {1: ("decay_serial",), 8: ("decay_scheduled", "decay_classic"),
                   4: ("decay_four_lanes",) if storage == "int8" else ()}[B]
        if not runs_of:
            continue  # checked and timed in the kernels phase; no CLI path at this B
        key = f"sched_{storage}@B{B}"
        r = row(f"fused_sweep_sched[{storage}]@B{B}", timing[key],
                sum(v[n]["scheduled_by_plan"][timing[key]["plan"]] for n in runs_of),
                errors[key], f"{VARIANT[storage]}, the scheduled log update (alpha_lane)")
        r["fixed_alpha_ms"] = timing[key]["fixed_alpha_ms"]
        rows.append(r)
    print(json.dumps({"kernels": rows}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--grid-rank":
        sys.exit(grid_rank_main(sys.argv[1:]))
    sys.exit(main())
