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
- **OOM**: a device out-of-memory hands every un-emitted frame back to the
  caller in frame order (``SchedRunStats.leftover``), for the grouped
  loop's halving ladder: the lane count cannot halve itself. Any other
  dispatch error raises.

Telemetry, the JAX scheduler's six instruments, updated once per stride
from the values the stride already read back: ``sched_lane_occupancy``
(the run's occupancy so far), ``sched_stride_occupancy`` (one sample per
stride), ``sched_lanes_retired_total``, ``sched_lanes_backfilled_total``,
``sched_strides_total`` and ``sched_deadline_shed_total`` (CLI frames carry
no deadline: it stays 0). Each dispatch is a ``solve.dispatch`` trace span.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.resilience.degrade import dispatch_guarded, is_resource_exhausted


@dataclass
class SchedRunStats:
    """End-of-run scheduler accounting (plus the OOM fallback payload)."""

    frames: int = 0  # results emitted
    strides: int = 0  # device dispatches
    loop_steps: int = 0  # solver iterations the device executed
    useful_iters: int = 0  # per-frame iterations summed over retirees
    backfilled: int = 0  # lane loads (the initial fill included)
    # un-emitted frames, in frame order, after a device OOM: the caller
    # re-solves them on the grouped loop at a halved group size; None on
    # every other path
    leftover: Optional[List] = None
    _capacity: int = 0  # lane-iterations dispatched

    @property
    def occupancy(self) -> float:
        """Useful lane-iterations / lane capacity actually dispatched."""
        return self.useful_iters / self._capacity if self._capacity else 0.0


class _Slot:
    """One occupied lane's host-side bookkeeping."""

    __slots__ = ("seq", "frame", "ftime", "cam_times", "it_prev")

    def __init__(self, seq, frame, ftime, cam_times):
        self.seq = seq
        self.frame = frame  # kept for an OOM requeue (one [P] fp64 row)
        self.ftime = ftime
        self.cam_times = cam_times
        self.it_prev = 0


class ContinuousBatcher:
    """Drive a :class:`~sartsolver_tpu_torch.parallel.sharded.DistributedSARTSolver`'s
    lanes over a frame stream with convergence-aware retirement and
    backfill.

    ``on_result(ftime, cam_times, status, iterations, convergence, fetcher,
    per_frame_ms)`` receives each retired frame in frame order (``fetcher``
    is a zero-argument callable resolving the solution in physical units).
    ``on_event`` receives one line per notable event (the OOM hand-back).
    ``on_stride`` (optional) is called just before each stride's dispatch:
    the CLI's ``--profile_dir`` steps the profiler there.
    """

    def __init__(self, solver, *, lanes: int, on_result: Callable,
                 on_event: Optional[Callable[[str], None]] = None,
                 on_stride: Optional[Callable[[], None]] = None,
                 refill_quantum: Optional[int] = None):
        if lanes < 1:
            raise ValueError("Lane count must be positive.")
        self._solver = solver
        self._lanes = int(lanes)
        # A refill stride pays the Eq. 4 guess (two extra reads of the
        # matrix) however many lanes it loads; waiting until a quarter of
        # the lanes are free amortizes it. An empty batch always refills.
        if refill_quantum is None:
            refill_quantum = max(1, self._lanes // 4)
        self._refill_quantum = max(1, min(int(refill_quantum), self._lanes))
        self._on_result = on_result
        self._on_event = on_event
        self._on_stride = on_stride
        registry = obs_metrics.get_registry()
        self._occ_gauge = registry.gauge("sched_lane_occupancy")
        self._occ_hist = registry.histogram("sched_stride_occupancy")
        self._retired_ctr = registry.counter("sched_lanes_retired_total")
        self._backfill_ctr = registry.counter("sched_lanes_backfilled_total")
        self._stride_ctr = registry.counter("sched_strides_total")
        # CLI frames carry no deadline: registered as in the JAX scheduler,
        # it stays 0
        registry.counter("sched_deadline_shed_total")

    def _emit_ready(self) -> None:
        """Flush the reorder buffer's contiguous prefix (frame order)."""
        while self._next_emit in self._emit_buf:
            payload, _frame = self._emit_buf.pop(self._next_emit)
            self._next_emit += 1
            self._stats.frames += 1
            self._on_result(*payload)

    def run(self, items) -> SchedRunStats:
        """Consume the ``(frame, time, camera_times)`` stream until it is
        drained. ``stats.leftover`` is not None exactly when a device OOM
        handed the run back to the grouped loop."""
        solver = self._solver
        B = self._lanes
        stats = self._stats = SchedRunStats()
        self._emit_buf = {}  # seq -> (on_result payload, raw frame)
        self._next_emit = 0
        it = iter(items)
        exhausted = False
        lane_state = solver.sched_lanes(B)
        free = deque(range(B))
        occupied = {}  # lane index -> _Slot
        seq = 0
        t_last = time.perf_counter()

        def intake():
            """Fill free lanes from the stream; below the refill quantum
            (with work in flight) the free lanes ride empty one more
            stride."""
            nonlocal exhausted, seq
            refills = []
            if occupied and len(free) < self._refill_quantum:
                return refills
            while free and not exhausted:
                try:
                    frame, ftime, cam_times = next(it)
                except StopIteration:
                    exhausted = True
                    break
                lane = free.popleft()
                occupied[lane] = _Slot(seq, np.asarray(frame), ftime, cam_times)
                refills.append((lane, occupied[lane].frame))
                seq += 1
            return refills

        while True:
            refills = intake()
            if not occupied:
                break
            if self._on_stride is not None:
                self._on_stride()
            try:
                dispatch_guarded(lambda: solver.sched_step(lane_state, refills))
            except RuntimeError as err:  # torch.cuda.OutOfMemoryError is one
                if not is_resource_exhausted(err):
                    raise
                # the one failure a fixed lane count cannot absorb: every
                # un-emitted frame goes back, in frame order
                torch.cuda.empty_cache()
                self._emit_ready()
                stats.leftover = self._requeue(occupied)
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
            for lane, slot in occupied.items():
                delta = int(itv[lane]) - slot.it_prev
                slot.it_prev = int(itv[lane])
                steps = max(steps, delta)
                useful += delta
            stats.loop_steps += steps
            stats._capacity += steps * B
            stats.useful_iters += useful
            if steps:
                self._occ_hist.observe(useful / (steps * B))
            self._occ_gauge.set(round(stats.occupancy, 6))
            # retire: convergence order on the device, frame order out
            now = time.perf_counter()
            retired = sorted((lane for lane in occupied if done[lane]),
                             key=lambda b: occupied[b].seq)
            per_frame_ms = (now - t_last) * 1e3 / max(len(retired), 1)
            self._retired_ctr.inc(len(retired))
            for lane in retired:
                slot = occupied.pop(lane)
                self._emit_buf[slot.seq] = (
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
            self._emit_ready()
        return stats

    def _requeue(self, occupied) -> List:
        """Un-emitted frames in frame order for the grouped-loop fallback.
        Completed but unemitted results are re-solved from their raw frames:
        emitting them after the fallback re-solves an earlier frame would
        break row order."""
        entries = [(seq, (frame, payload[0], payload[1]))
                   for seq, (payload, frame) in self._emit_buf.items()]
        entries += [(slot.seq, (slot.frame, slot.ftime, slot.cam_times))
                    for slot in occupied.values()]
        self._emit_buf.clear()
        return [item for _, item in sorted(entries, key=lambda e: e[0])]
