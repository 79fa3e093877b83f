"""Convergence-aware batch scheduler for the grouped solve loop.

Counterpart of ``sartsolver_tpu/sched/scheduler.py``. The run-to-slowest
batch loop (the CLI's ``run_grouped``) solves K frames and waits for the
slowest to converge; converged frames pad the sweep until then.
:class:`ContinuousBatcher` keeps the batch full instead: the solver holds B
persistent *lanes* (``models/sart.py:SchedState``), each device dispatch runs
at most ``SolverOptions.schedule_stride`` iterations, and between strides the
host retires the lanes that are done and backfills them from the frame
queue. Every stride runs the sweep at the same B, so one kernel plan serves
every occupancy, and the tail drains with the free lanes inert.

Contracts kept from the grouped loop:

- **Parity**: a retired lane's solution, status and iteration count equal,
  byte for byte, the same frame solved by the grouped loop at the same B
  (the stride shares the batched loop's ``_SweepContext`` body).
- **Row order**: results are emitted in frame order through a reorder
  buffer (retirement order is convergence order).
- **Statuses**: a lane that is done retires, whatever its status:
  converged, at the iteration cap, or DIVERGED by the divergence guard
  (in the stride, or at its refill for a non-finite frame, after no
  iteration).
- **Failure isolation**: the prefetcher's
  :class:`~sartsolver_tpu_torch.resilience.failures.FrameFailure` items
  pass through as FAILED rows in frame order without taking a lane; with
  ``isolate``, a dispatch that fails with a recoverable error
  (``RECOVERABLE_FRAME_ERRORS``) fails the frames in its lanes, in order
  (the grouped loop's "the group produced nothing"), and the run goes on
  with fresh lanes. Without ``isolate`` that error raises.
- **OOM**: a device out-of-memory hands every un-emitted frame back to the
  caller in frame order (``SchedRunStats.leftover``, FrameFailure items
  included), for the grouped loop's halving ladder: the lane count cannot
  halve itself.
- **SDC** (``integrity_policy``, ``--integrity``): a lane that retires
  SDC_DETECTED is re-queued once onto a fresh lane, ahead of new frames;
  a second trip is a FAILED row in the same ordered stream
  (``resilience/integrity.py:SdcEscalation`` may then quarantine).
- **Stop** (``stop_check``, the CLI's SIGTERM flag): polled at each stride
  boundary; once it answers True no new frame enters, the lanes in flight
  drain, and ``SchedRunStats.interrupted`` is set — unless the stream was
  already exhausted, when the drain completes the run.

- **Deadline shed** (the serving engine): a stream item may carry a 4th
  element, an absolute ``time.monotonic()`` deadline, and a 5th, the
  request's trace id. At each stride boundary, after the retirements, the
  occupied lanes past their deadline retire with status
  ``DEADLINE_EXCEEDED`` (-5) and the last iterate reached, freeing the lane
  for backfill while the co-batched lanes run on. CLI frames carry no
  deadline, and for them the sweep does nothing.

- **Checkpoints** (``ckpt_stride``, ``ckpt_sink``; ``--solve_ckpt_stride``):
  every ``ckpt_stride`` strides the run's whole state — the solver's lanes
  (``export_sched_lanes``), the occupied and awaiting-recompute slots with
  their raw frames, the reorder buffer with its rows fetched, the ordering
  and stats counters — goes to ``ckpt_sink(serial, snapshot)``, the serial
  being the stride count. ``restore`` re-enters such a snapshot;
  ``restore_emitted`` is the rows the output file already holds (the killed
  run wrote on past its snapshot): every restored entry below it is dropped,
  its lane reset to inert, and emission resumes there. The stats counters
  carry across, so serials stay monotonic over a resume.

- **Pod rendezvous** (``stride_barrier``, the CLI's file-mode pod): called
  with the stride count at every stride boundary, after the checkpoint (a
  host killed after the barrier has its record durable; one killed inside
  the append leaves the pod a stride back).

While :meth:`ContinuousBatcher.run` drives, the lanes' occupancy and
in-flight frame serials feed the heartbeat line and the SIGUSR1 status
snapshot (``watchdog.set_sched_status_provider``).

Telemetry, the JAX scheduler's six instruments, updated once per stride
from the values the stride already read back: ``sched_lane_occupancy``
(the run's occupancy so far), ``sched_stride_occupancy`` (one sample per
stride), ``sched_lanes_retired_total``, ``sched_lanes_backfilled_total``,
``sched_strides_total`` and ``sched_deadline_shed_total`` (CLI frames carry
no deadline: it stays 0 there). Each dispatch is a ``solve.dispatch`` trace
span; with a trace buffer installed, a lane whose item carries a trace id
also records each stride (``sched.stride``), its retirement
(``lane.retire``) and a shed (``deadline.shed``) on its request's track.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.obs import trace as obs_trace
from sartsolver_tpu_torch.resilience import failures, watchdog
from sartsolver_tpu_torch.resilience.degrade import dispatch_guarded, is_resource_exhausted
from sartsolver_tpu_torch.resilience.failures import (
    DEADLINE_EXCEEDED,
    SDC_DETECTED,
    FrameFailure,
    IntegrityError,
)
from sartsolver_tpu_torch.resilience.integrity import SDC_REPRODUCED


@dataclass
class SchedRunStats:
    """End-of-run scheduler accounting (plus the OOM fallback payload)."""

    frames: int = 0  # results emitted (FAILED rows included)
    failed: int = 0  # FrameFailure rows and the lanes of failed dispatches
    strides: int = 0  # device dispatches
    loop_steps: int = 0  # solver iterations the device executed
    useful_iters: int = 0  # per-frame iterations summed over retirees
    backfilled: int = 0  # lane loads (the initial fill included)
    interrupted: bool = False  # a stop request truncated the stream
    # un-emitted frames, in frame order, after a device OOM: the caller
    # re-solves them on the grouped loop at a halved group size; None on
    # every other path
    leftover: Optional[List] = None
    oom_error: Optional[BaseException] = None  # the OOM that set leftover
    _capacity: int = 0  # lane-iterations dispatched

    @property
    def occupancy(self) -> float:
        """Useful lane-iterations / lane capacity actually dispatched."""
        return self.useful_iters / self._capacity if self._capacity else 0.0


class _Slot:
    """One occupied lane's host-side bookkeeping."""

    __slots__ = ("seq", "frame", "ftime", "cam_times", "it_prev", "sdc_retries",
                 "deadline", "trace")

    def __init__(self, seq, frame, ftime, cam_times, deadline=None, trace=None):
        self.seq = seq
        self.frame = frame  # kept for an OOM requeue or an SDC recompute
        self.ftime = ftime
        self.cam_times = cam_times
        self.it_prev = 0
        self.sdc_retries = 0  # re-queues after an integrity trip
        # the serving engine's absolute time.monotonic() deadline and
        # request trace id; None on CLI frames
        self.deadline = deadline
        self.trace = trace


class ContinuousBatcher:
    """Drive a :class:`~sartsolver_tpu_torch.parallel.sharded.DistributedSARTSolver`'s
    lanes over a frame stream with convergence-aware retirement and
    backfill.

    ``on_result(ftime, cam_times, status, iterations, convergence, fetcher,
    per_frame_ms)`` receives each retired frame in frame order (``fetcher``
    is a zero-argument callable resolving the solution in physical units).
    ``on_failed(ftime, cam_times, error)`` receives FAILED frames in the
    same ordered stream (a FrameFailure item with no ``on_failed`` raises
    its error). ``isolate``: a recoverable dispatch error fails the lanes'
    frames instead of raising (the CLI's per-frame isolation).
    ``on_event`` receives one line per notable event (the OOM hand-back).
    ``on_stride`` (optional) is called just before each stride's dispatch:
    the CLI's ``--profile_dir`` steps the profiler there. ``stop_check``
    (optional) is polled at each stride boundary; ``integrity_policy`` (an
    :class:`~sartsolver_tpu_torch.resilience.integrity.SdcEscalation`)
    turns the SDC retry on.
    """

    def __init__(self, solver, *, lanes: int, on_result: Callable,
                 on_failed: Optional[Callable] = None, isolate: bool = False,
                 on_event: Optional[Callable[[str], None]] = None,
                 on_stride: Optional[Callable[[], None]] = None,
                 refill_quantum: Optional[int] = None,
                 stop_check: Optional[Callable[[], bool]] = None,
                 integrity_policy=None, ckpt_stride: Optional[int] = None,
                 ckpt_sink: Optional[Callable[[int, dict], None]] = None,
                 stride_barrier: Optional[Callable[[int], None]] = None,
                 restore: Optional[dict] = None, restore_emitted: int = 0):
        if lanes < 1:
            raise ValueError("Lane count must be positive.")
        self._ckpt_stride = int(ckpt_stride) if ckpt_stride else None
        self._ckpt_sink = ckpt_sink
        self._stride_barrier = stride_barrier
        self._restore = restore
        self._restore_emitted = int(restore_emitted)
        self._solver = solver
        self._lanes = int(lanes)
        # A refill stride pays the Eq. 4 guess (two extra reads of the
        # matrix) however many lanes it loads; waiting until a quarter of
        # the lanes are free amortizes it. An empty batch always refills.
        if refill_quantum is None:
            refill_quantum = max(1, self._lanes // 4)
        self._refill_quantum = max(1, min(int(refill_quantum), self._lanes))
        self._on_result = on_result
        self._on_failed = on_failed
        self._isolate = isolate
        self._on_event = on_event
        self._on_stride = on_stride
        self._stop_check = stop_check
        self._integrity = integrity_policy
        self._occupied = self._stats = None  # the live view's sources
        registry = obs_metrics.get_registry()
        self._occ_gauge = registry.gauge("sched_lane_occupancy")
        self._occ_hist = registry.histogram("sched_stride_occupancy")
        self._retired_ctr = registry.counter("sched_lanes_retired_total")
        self._backfill_ctr = registry.counter("sched_lanes_backfilled_total")
        self._stride_ctr = registry.counter("sched_strides_total")
        # CLI frames carry no deadline: there it stays 0
        self._deadline_ctr = registry.counter("sched_deadline_shed_total")

    def _emit_ready(self) -> None:
        """Flush the reorder buffer's contiguous prefix (frame order)."""
        while self._next_emit in self._emit_buf:
            kind, payload, _frame = self._emit_buf.pop(self._next_emit)
            self._next_emit += 1
            self._stats.frames += 1
            if kind == "failed":
                self._stats.failed += 1
                ftime, cam_times, err = payload
                if self._on_failed is None:
                    raise err
                self._on_failed(ftime, cam_times, err)
            else:
                self._on_result(*payload)

    def _live_status(self) -> Optional[dict]:
        """Occupancy and in-flight lane serials for the heartbeat and the
        SIGUSR1 snapshot: the run's own bookkeeping, read lock-free (it
        runs in signal context), a racing insert degrading to no lane
        list."""
        from sartsolver_tpu_torch.utils.locking import stale_read

        occupied, stats = self._occupied, self._stats
        if occupied is None or stats is None:
            return None
        lanes = stale_read(lambda: sorted(slot.seq for slot in occupied.values()))
        return {"occupancy": round(stats.occupancy, 3), "lanes": lanes,
                "strides": stats.strides, "frames_emitted": stats.frames}

    def run(self, items) -> SchedRunStats:
        """Consume the ``(frame, time, camera_times[, deadline[, trace]]) |
        FrameFailure`` stream
        until it is drained, or a stop request truncates it.
        ``stats.leftover`` is not None exactly when a device OOM handed the
        run back to the grouped loop."""
        watchdog.set_sched_status_provider(self._live_status)
        try:
            return self._run(items)
        finally:
            watchdog.set_sched_status_provider(None)

    def _run(self, items) -> SchedRunStats:
        solver = self._solver
        B = self._lanes
        stats = self._stats = SchedRunStats()
        self._emit_buf = {}  # seq -> ("result" | "failed", payload, raw frame)
        self._next_emit = 0
        it = iter(items)
        exhausted = False
        sdc_retry = self._sdc_retry = deque()  # slots awaiting their SDC recompute
        if self._restore is not None:
            lane_state, free, seq = self._apply_restore(stats, B)
            occupied = self._occupied
        else:
            lane_state = solver.sched_lanes(B)
            free = deque(range(B))
            occupied = self._occupied = {}  # lane index -> _Slot
            seq = 0
        t_last = time.perf_counter()
        tracebuf = obs_trace.active_buffer()

        def intake():
            """Fill free lanes: SDC recomputes first (their serial holds
            up the ordered emission), then the stream; below the refill
            quantum (with work in flight) the free lanes ride empty one
            more stride."""
            nonlocal exhausted, seq
            refills = []
            while sdc_retry and free:
                slot = sdc_retry.popleft()
                slot.it_prev = 0
                lane = free.popleft()
                occupied[lane] = slot
                refills.append((lane, slot.frame))
            if occupied and len(free) < self._refill_quantum:
                return refills
            while free and not exhausted and not stats.interrupted:
                try:
                    item = next(it)
                except StopIteration:
                    exhausted = True
                    break
                if isinstance(item, FrameFailure):  # a FAILED row, no lane
                    self._emit_buf[seq] = ("failed", (item.time, item.camera_times,
                                                      item.error), None)
                    seq += 1
                    continue
                # the CLI's (frame, time, camera times), or the serving
                # engine's with a deadline and a trace id
                frame, ftime, cam_times = item[0], item[1], item[2]
                lane = free.popleft()
                occupied[lane] = _Slot(seq, np.asarray(frame), ftime, cam_times,
                                       deadline=item[3] if len(item) > 3 else None,
                                       trace=item[4] if len(item) > 4 else None)
                refills.append((lane, occupied[lane].frame))
                seq += 1
            return refills

        while True:
            if (self._stop_check is not None and not stats.interrupted
                    and not exhausted and self._stop_check()):
                # a stride-boundary stop: nothing new enters, the lanes in
                # flight drain; once the stream is exhausted a stop cuts
                # nothing, and the run completes
                stats.interrupted = True
            refills = intake()
            self._seq = seq  # for the stride-boundary snapshot
            if not occupied:
                self._emit_ready()  # trailing FAILED rows
                break
            if self._on_stride is not None:
                self._on_stride()
            t_stride0 = time.perf_counter()
            try:
                dispatch_guarded(lambda: solver.sched_step(lane_state, refills))
            except Exception as err:
                if not (isinstance(err, RuntimeError) and is_resource_exhausted(err)):
                    if not (self._isolate
                            and isinstance(err, failures.RECOVERABLE_FRAME_ERRORS)):
                        raise
                    # the dispatch produced nothing: every frame in the
                    # lanes fails, in order, and the run goes on with fresh
                    # lanes
                    for slot in occupied.values():
                        self._emit_buf[slot.seq] = (
                            "failed", (slot.ftime, slot.cam_times, err), None)
                    occupied.clear()
                    free = deque(range(B))
                    lane_state = solver.sched_lanes(B)
                    self._emit_ready()
                    continue
                # the one failure a fixed lane count cannot absorb: every
                # un-emitted frame goes back, in frame order
                torch.cuda.empty_cache()
                self._emit_ready()
                stats.leftover = self._requeue(occupied)
                stats.oom_error = err
                if self._on_event is not None:
                    self._on_event(
                        f"device OOM in the continuous-batching scheduler "
                        f"({type(err).__name__}); handing {len(stats.leftover)} "
                        "in-flight/buffered frame(s) back to the fixed-group loop"
                    )
                return stats
            stats.strides += 1
            stats.backfilled += len(refills)
            self._stride_ctr.inc()
            self._backfill_ctr.inc(len(refills))
            done, status, iters, conv, itv = lane_state.scalars()
            # the device loop ends early once every lane is done, so count
            # what ran: the longest advance of an occupied lane
            steps = useful = 0
            deltas = {}
            for lane, slot in occupied.items():
                delta = deltas[lane] = int(itv[lane]) - slot.it_prev
                slot.it_prev = int(itv[lane])
                steps = max(steps, delta)
                useful += delta
            stats.loop_steps += steps
            stats._capacity += steps * B
            stats.useful_iters += useful
            if steps:
                self._occ_hist.observe(useful / (steps * B))
            self._occ_gauge.set(round(stats.occupancy, 6))
            if tracebuf is not None:
                # one span a traced lane on its request's track: this
                # dispatch and its read-back, the iterations the lane ran
                t_stride1 = time.perf_counter()
                for lane, slot in occupied.items():
                    if slot.trace:
                        tracebuf.add_request_complete(
                            slot.trace, "sched.stride", t_stride0, t_stride1,
                            {"lane": lane, "iters": deltas[lane],
                             "stride": stats.strides,
                             "occupancy": round(useful / (steps * B), 3) if steps else 0.0})
            # retire: convergence order on the device, frame order out
            now = time.perf_counter()
            retired = sorted((lane for lane in occupied if done[lane]),
                             key=lambda b: occupied[b].seq)
            per_frame_ms = (now - t_last) * 1e3 / max(len(retired), 1)
            self._retired_ctr.inc(len(retired))
            for lane in retired:
                slot = occupied.pop(lane)
                if self._integrity is not None and int(status[lane]) == SDC_DETECTED:
                    # an integrity trip: re-solve once on a fresh lane; a
                    # repeat is a FAILED row (the policy may quarantine)
                    free.append(lane)
                    self._integrity.detected()
                    if slot.sdc_retries == 0:
                        slot.sdc_retries = 1
                        self._integrity.note_recompute()
                        sdc_retry.append(slot)
                        continue
                    self._integrity.record_terminal(slot.ftime)
                    self._emit_buf[slot.seq] = (
                        "failed", (slot.ftime, slot.cam_times,
                                   IntegrityError(SDC_REPRODUCED)), None)
                    continue
                if tracebuf is not None and slot.trace:
                    tracebuf.add_request_instant(
                        slot.trace, "lane.retire",
                        {"lane": lane, "status": int(status[lane]),
                         "iterations": int(iters[lane])})
                self._emit_buf[slot.seq] = (
                    "result",
                    (slot.ftime, slot.cam_times, int(status[lane]), int(iters[lane]),
                     float(conv[lane]), lane_state.lane_solution_fetcher(lane),
                     per_frame_ms),
                    # the raw frame rides along until emission: an OOM
                    # requeue re-solves a completion stuck behind a lane
                    # still in flight
                    slot.frame,
                )
                free.append(lane)
            if retired:
                t_last = now
            # the deadline sweep: an occupied lane past its deadline retires
            # here, at the stride boundary, with DEADLINE_EXCEEDED and the
            # iterate it reached; the co-batched lanes run on
            now_mono = time.monotonic()
            overdue = [lane for lane, slot in occupied.items()
                       if slot.deadline is not None and now_mono > slot.deadline]
            for lane in sorted(overdue, key=lambda b: occupied[b].seq):
                slot = occupied.pop(lane)
                self._deadline_ctr.inc()
                if tracebuf is not None and slot.trace:
                    tracebuf.add_request_instant(
                        slot.trace, "deadline.shed",
                        {"lane": lane, "iterations": int(itv[lane])})
                self._emit_buf[slot.seq] = (
                    "result",
                    (slot.ftime, slot.cam_times, DEADLINE_EXCEEDED, int(itv[lane]),
                     float(conv[lane]), lane_state.lane_solution_fetcher(lane), 0.0),
                    slot.frame,
                )
                free.append(lane)
            self._emit_ready()
            if (self._ckpt_sink is not None and self._ckpt_stride
                    and stats.strides % self._ckpt_stride == 0):
                self._ckpt_sink(stats.strides, self._snapshot(lane_state))
            if self._stride_barrier is not None:
                self._stride_barrier(stats.strides)
        return stats

    # ---- in-solve checkpoints ---------------------------------------------

    @staticmethod
    def _slot_entry(slot, lane=None) -> dict:
        ent = {"seq": int(slot.seq), "ftime": slot.ftime, "cam_times": slot.cam_times,
               "it_prev": int(slot.it_prev), "sdc_retries": int(slot.sdc_retries),
               "frame": np.asarray(slot.frame)}
        if lane is not None:
            ent["lane"] = int(lane)
        return ent

    def _snapshot(self, lane_state) -> dict:
        """The run state a resume needs, taken at a stride boundary
        (``sartsolver_tpu/sched/scheduler.py:_snapshot``): the occupied and
        awaiting-recompute slots with their raw frames, the reorder buffer
        with each result's row fetched now (the lanes it reads are
        overwritten by later strides), the ordering and stats counters and
        the solver's lanes."""
        stats = self._stats
        emit = []
        for seq_i, (kind, payload, frame) in self._emit_buf.items():
            if kind == "failed":
                ftime, cam_times, err = payload
                emit.append({"seq": int(seq_i), "kind": "failed", "ftime": ftime,
                             "cam_times": cam_times, "error": str(err)})
            else:
                ftime, cam_times, status, iters, conv, fetcher, ms = payload
                emit.append({"seq": int(seq_i), "kind": "result", "ftime": ftime,
                             "cam_times": cam_times, "status": int(status),
                             "iters": int(iters), "conv": float(conv),
                             "row": np.asarray(fetcher()), "ms": float(ms),
                             "frame": None if frame is None else np.asarray(frame)})
        return {
            "serial": int(stats.strides),
            "lanes": int(self._lanes),
            "seq": int(self._seq),
            "next_emit": int(self._next_emit),
            "stats": {"frames": stats.frames, "failed": stats.failed,
                      "backfilled": stats.backfilled, "strides": stats.strides,
                      "loop_steps": stats.loop_steps, "useful_iters": stats.useful_iters,
                      "capacity": stats._capacity},
            "occupied": [self._slot_entry(slot, lane)
                         for lane, slot in self._occupied.items()],
            "sdc_retry": [self._slot_entry(slot) for slot in self._sdc_retry],
            "emit": emit,
            "solver": self._solver.export_sched_lanes(lane_state),
        }

    def _apply_restore(self, stats: SchedRunStats, B: int):
        """Re-enter a :meth:`_snapshot` payload
        (``sartsolver_tpu/sched/scheduler.py:_apply_restore``): returns
        ``(lane_state, free, seq)`` and seeds the reorder buffer, the
        occupied map, the SDC-retry queue and the stats counters. Entries
        below ``restore_emitted`` (W, rows the file already holds: the
        run's frame-order prefix) are dropped, their lanes reset to inert,
        and emission resumes at W. A snapshot of another lane count, or one
        ahead of the file, raises ValueError."""
        snap = self._restore
        W = self._restore_emitted
        if int(snap.get("lanes", B)) != B:
            raise ValueError(f"Solve checkpoint has {snap.get('lanes')} lanes; this run "
                             f"was started with {B} — resume with the same --batch_frames.")
        if int(snap["next_emit"]) > W:
            raise ValueError(f"Solve checkpoint is ahead of the output file "
                             f"({snap['next_emit']} emitted vs {W} rows written) — "
                             "pick an earlier checkpoint.")
        st = snap["stats"]
        stats.frames, stats.failed = int(st["frames"]), int(st["failed"])
        stats.backfilled, stats.strides = int(st["backfilled"]), int(st["strides"])
        stats.loop_steps, stats.useful_iters = int(st["loop_steps"]), int(st["useful_iters"])
        stats._capacity = int(st["capacity"])

        def slot_of(ent) -> _Slot:
            slot = _Slot(int(ent["seq"]), np.asarray(ent["frame"]), ent["ftime"],
                         ent["cam_times"])
            slot.it_prev, slot.sdc_retries = int(ent["it_prev"]), int(ent["sdc_retries"])
            return slot

        occupied = self._occupied = {}
        kill_lanes = []
        for ent in snap["occupied"]:
            if int(ent["seq"]) < W:  # retired and written by the killed run
                kill_lanes.append(int(ent["lane"]))
                stats.frames += 1
                continue
            occupied[int(ent["lane"])] = slot_of(ent)
        for ent in snap["sdc_retry"]:
            if int(ent["seq"]) < W:
                stats.frames += 1
                continue
            self._sdc_retry.append(slot_of(ent))
        for ent in snap["emit"]:
            seq_i = int(ent["seq"])
            if seq_i < W:
                stats.frames += 1
                stats.failed += ent["kind"] == "failed"
                continue
            if ent["kind"] == "failed":
                self._emit_buf[seq_i] = (
                    "failed", (ent["ftime"], ent["cam_times"], RuntimeError(ent["error"])),
                    None)
            else:
                row = np.asarray(ent["row"])
                frame = ent.get("frame")
                self._emit_buf[seq_i] = (
                    "result",
                    (ent["ftime"], ent["cam_times"], int(ent["status"]), int(ent["iters"]),
                     float(ent["conv"]), (lambda r=row: r), float(ent["ms"])),
                    None if frame is None else np.asarray(frame))
        self._next_emit = max(int(snap["next_emit"]), W)
        seq = max(int(snap["seq"]), W)
        lane_state = self._solver.restore_sched_lanes(snap["solver"], kill_lanes=kill_lanes)
        free = deque(b for b in range(B) if b not in occupied)
        return lane_state, free, seq

    def _requeue(self, occupied) -> List:
        """Un-emitted frames in frame order for the grouped-loop fallback.
        Completed but unemitted results are re-solved from their raw frames:
        emitting them after the fallback re-solves an earlier frame would
        break row order."""
        entries = [(seq, FrameFailure(None, *payload) if kind == "failed"
                     else (frame, payload[0], payload[1]))
                   for seq, (kind, payload, frame) in self._emit_buf.items()]
        entries += [(slot.seq, self._requeue_item(slot)) for slot in occupied.values()]
        self._emit_buf.clear()
        return [item for _, item in sorted(entries, key=lambda e: e[0])]


    @staticmethod
    def _requeue_item(slot):
        """An in-flight slot back in stream-item form; the engine's deadline
        and trace id survive the requeue, so the fallback can still shed
        and attribute the frame."""
        if slot.trace is not None:
            return (slot.frame, slot.ftime, slot.cam_times, slot.deadline, slot.trace)
        if slot.deadline is not None:
            return (slot.frame, slot.ftime, slot.cam_times, slot.deadline)
        return (slot.frame, slot.ftime, slot.cam_times)


def sched_held_ftimes(snapshot: dict, emitted: int) -> List:
    """Frame times a run restored from ``snapshot`` serves from the
    checkpoint (its lanes, its slots awaiting a recompute, its buffered
    results): a resumed stream must skip them besides the rows already
    written, or they would be solved twice. Entries below ``emitted`` are
    dropped at the restore (written already), so they are not held."""
    W = int(emitted)
    return [ent["ftime"] for key in ("occupied", "sdc_retry", "emit")
            for ent in snapshot.get(key, ()) if int(ent["seq"]) >= W]
