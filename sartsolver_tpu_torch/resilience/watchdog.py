"""Hang watchdog: per-phase progress beacons, stack dumps, escalation.

Counterpart of ``sartsolver_tpu/resilience/watchdog.py``, with the same
knobs, phases, stages and heartbeat line; the serving engine's status
provider comes with the serving slice.

A fleet-operated solver dies three ways that the PR-2 fault paths do not
cover: preemption (shutdown.py), device OOM (degrade.py) — and the worst
one, the *silent hang*: a wedged device runtime, a stalled NFS mount or a
deadlocked collective leaves the process alive but making no progress,
invisible to a scheduler until its global walltime expires. This module
turns "no progress" into a first-class, recoverable event:

- **Beacons** — the pipeline's host phases announce the start of their
  work with :func:`beacon`: frame prefetch and each RTM chunk read
  (``utils/prefetch.py``, ``parallel/multihost.py``), host-to-device
  staging and solve dispatch (``parallel/sharded.py``), result fetch
  (``DeviceSolveResult``), output flush (``io/solution.py``), the CUDA
  extension's build (``ops/_build.py``, phase ``build``) and per-frame
  completion (``cli.py``). A beacon is one tuple assignment plus a clock
  read — nanoseconds, no lock (the GIL makes the assignment atomic) — and
  never touches the device.
- **Monitor** — :class:`Watchdog` (armed by ``SART_WATCHDOG_TIMEOUT``
  seconds; unset/0 = off) runs a daemon thread that watches the beacon
  and escalates in stages once ``timeout`` seconds pass without a new
  beacon anywhere (the pipeline's threads beacon concurrently, so "which
  thread is stuck" cannot be read off the last beacon — a finished
  prefetcher's beacon can postdate the dispatch that hung; the staged
  ladder needs no such attribution):

  1. dump every thread's stack to stderr, then raise
     :class:`~sartsolver_tpu_torch.resilience.failures.WatchdogTimeout`
     asynchronously into the **main thread** — the frame-loop owner,
     where the three dispatch-side hang hazards (``device.put``,
     ``solve.dispatch``, result fetch) live. An interrupted frame
     escalates through the existing taxonomy: per-frame isolation
     absorbs it as a FRAME_FAILED row; ``--fail_fast``/multihost runs
     abort with EXIT_INFRASTRUCTURE.
  2. after ``SART_WATCHDOG_GRACE`` more seconds without progress (the
     main thread may be wedged inside a C call, where an async
     exception stays pending), interrupt every **registered worker
     thread** (prefetcher, async writer) — a hung prefetch read becomes
     a FrameFailure, a hung lazy fetch/flush latches as a write error,
     and either unblocks the main thread (which then raises its pending
     interrupt: a clean resumable abort).
  3. after another grace without progress, dump stacks once more and
     hard-exit with EXIT_INFRASTRUCTURE — the output file is
     crash-consistent (killdrill model), and "never a deadlocked
     process" is the contract.
- **Heartbeat** — when ``SART_HEARTBEAT_FILE`` is set, every
  frame-completion beacon touches that file, so an *external* supervisor
  (Kubernetes liveness probe, a pod babysitter) gets a progress signal
  without parsing stdout.

Knobs (environment):

- ``SART_WATCHDOG_TIMEOUT`` (seconds; unset/0 disables): beacon-silence
  threshold. Must exceed the slowest legitimate beacon gap. The CUDA
  extension's first build (``nvcc``, about half a minute) beacons only
  before and after it: a cold build that outlasts the timeout aborts the
  run, as the JAX package's first compile does. Build once first (any
  run, or ``ops._build.load``) or give a generous timeout.
- ``SART_WATCHDOG_GRACE`` (default ``max(timeout, 5)``): extra seconds
  after the async interrupt before the hard abort.
- ``SART_HEARTBEAT_FILE`` (optional): path touched on each frame.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading
import time
import traceback
import weakref
from typing import Callable, Optional, Tuple

from sartsolver_tpu_torch.resilience.failures import (
    EXIT_INFRASTRUCTURE,
    WatchdogTimeout,
)

# Beacon phase names (free-form strings are fine; these are the pipeline's
# canonical five plus the per-frame completion tick).
PHASE_PREFETCH = "prefetch"
PHASE_STAGE = "device.put"
PHASE_DISPATCH = "solve.dispatch"
PHASE_FETCH = "result.fetch"
PHASE_FLUSH = "io.flush"
PHASE_FRAME_DONE = "frame.done"
PHASE_BUILD = "build"

# (phase, serial, monotonic time, owning thread ident). The serial makes
# progress detection independent of clock resolution; the whole-tuple
# swap keeps readers consistent without a lock.
_last: Tuple[str, int, float, int] = ("start", 0, 0.0, 0)
_serial = 0
# completed frames this run (the heartbeat file's progress counter) and
# the last *work* phase (any beacon that is not the frame-done tick) — a
# supervisor reading the heartbeat wants "where is it", and at write time
# the most recent beacon is always frame.done itself
_frames_done = 0
_last_work_phase = "start"
# last beacon per phase: phase -> (serial, monotonic time). The SIGUSR1
# status snapshot (obs/flight.py) reads per-phase ages off this — "the
# prefetcher last moved 0.1 s ago but the dispatch is 40 s stale" is the
# attribution the single _last tuple cannot give.
_last_by_phase: dict = {}

# Observability taps (obs/trace.py spans, obs/flight.py ring): every
# beacon is mirrored into each installed tap. One global emptiness check
# when disabled — beacons stay nanoseconds.
_taps: dict = {}
_tap_seq: Tuple[Callable[[str, int, float, int], None], ...] = ()

# Threads that volunteered for async interruption (prefetcher / async
# writer workers — they catch the exception and degrade their stream).
# WeakSet: a worker that exits without unregistering just vanishes.
_interruptible: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()


def add_beacon_tap(
    key: str, tap: Callable[[str, int, float, int], None]
) -> None:
    """Install a keyed beacon observer. Taps must be cheap and
    exception-free — they run inside every beacon."""
    global _tap_seq
    _taps[key] = tap
    _tap_seq = tuple(_taps.values())


def remove_beacon_tap(key: str) -> None:
    global _tap_seq
    _taps.pop(key, None)
    _tap_seq = tuple(_taps.values())


def set_beacon_tap(
    tap: Optional[Callable[[str, int, float, int], None]]
) -> None:
    """The trace buffer's single-slot API (obs/trace.py), kept as a view
    over the keyed taps: install (or with None remove) the ``trace``
    tap without touching any other observer (the flight ring)."""
    if tap is None:
        remove_beacon_tap("trace")
    else:
        add_beacon_tap("trace", tap)


def frames_done() -> int:
    """Frames completed (``frame.done`` beacons) since process start."""
    return _frames_done


def beacon(phase: str) -> None:
    """Announce the start of host-side work in ``phase``.

    Called from multiple threads; always recorded (so a watchdog can
    attach mid-run), costs one clock read + two dict/tuple assignments
    when no heartbeat file or tap is configured.
    """
    global _last, _serial, _frames_done, _last_work_phase
    _serial += 1
    now = time.monotonic()
    ident = threading.get_ident()
    _last = (phase, _serial, now, ident)
    _last_by_phase[phase] = (_serial, now)
    if phase == PHASE_FRAME_DONE:
        _frames_done += 1
        path = os.environ.get("SART_HEARTBEAT_FILE")
        if path:
            _write_heartbeat(path)
    else:
        _last_work_phase = phase
    taps = _tap_seq
    if taps:
        for tap in taps:
            try:
                tap(phase, _serial, now, ident)
            except Exception:  # observability must never hurt the run
                pass


def last_beacon() -> Tuple[str, int, float, int]:
    """The most recent beacon (phase, serial, monotonic time, thread id)."""
    return _last


def beacon_ages() -> dict:
    """Seconds since the last beacon of each phase seen so far (the
    SIGUSR1 status snapshot's per-phase staleness table).

    Worker threads insert first-occurrence phases concurrently; a dict
    iteration racing such an insert raises RuntimeError, which would
    silently cost the crash bundle its snapshot — the shared
    ``stale_read`` fallback (utils/locking.py) retries the copy."""
    from sartsolver_tpu_torch.utils.locking import stale_read

    items = stale_read(lambda: list(_last_by_phase.items()), default=[])
    now = time.monotonic()
    return {
        phase: round(now - t, 3)
        for phase, (_serial_, t) in sorted(items)
    }


# Live scheduler view (sched/scheduler.py registers a provider while the
# continuous batcher drives the run): occupancy + in-flight lane serials
# for the heartbeat line and the SIGUSR1 status snapshot. A provider
# must be cheap and exception-tolerant — it runs inside the per-frame
# heartbeat write.
_sched_status: Optional[Callable[[], Optional[dict]]] = None

# Crash hook (obs/flight.py): called with a reason string immediately
# before the stage-3 ``os._exit`` so the flight recorder can flush its
# crash bundle — the one abort path no ``finally`` block survives.
_crash_hook: Optional[Callable[[str], None]] = None


def set_sched_status_provider(
    provider: Optional[Callable[[], Optional[dict]]]
) -> None:
    global _sched_status
    _sched_status = provider


def sched_status() -> Optional[dict]:
    """The live scheduler view ({occupancy, lanes, strides}), or None
    when the continuous batcher is not driving."""
    provider = _sched_status
    if provider is None:
        return None
    try:
        return provider()
    except Exception:  # observability must never hurt the run
        return None


def set_crash_hook(hook: Optional[Callable[[str], None]]) -> None:
    global _crash_hook
    _crash_hook = hook


def _fire_crash_hook(reason: str, timeout: float = 5.0) -> None:
    """Run the crash hook in a bounded daemon thread. The hook writes a
    file, and the filesystem may be EXACTLY what is wedged — the hard
    abort must reach ``os._exit`` whether or not the bundle lands, so
    the write gets ``timeout`` seconds and is then abandoned."""
    hook = _crash_hook
    if hook is None:
        return

    def run() -> None:
        try:
            hook(reason)
        except Exception:  # the bundle must never mask the abort
            pass

    t = threading.Thread(target=run, name="sart-crash-hook", daemon=True)
    try:
        t.start()
        t.join(timeout)
    except Exception:
        pass


def _write_heartbeat(path: str) -> None:
    """Write progress state into the heartbeat file (advisory: failures
    never hurt the run).

    The file carries WHERE the run is, not just that it is alive: the
    last pipeline phase that ran before this frame completed, the
    completed-frame counter and the beacon serial — plus, when the
    continuous-batching scheduler is driving (the default batched path),
    ``occupancy=`` and the in-flight lane serials, so a supervisor sees
    lane health, not just frame count — one ``key=value`` line parseable
    without any schema machinery. The mtime contract is unchanged —
    still one touch per completed frame — so ``find -mmin``-style
    liveness probes keep working. Published via temp-file + rename: the
    supervisor reads at arbitrary instants, and an in-place truncating
    write would expose an empty/partial file between the truncate and
    the write.
    """
    try:
        sched = sched_status()
        extra = ""
        # pod identity (SART_POD_PROCESS, the JAX package's k/n): host=k/n
        # lets a supervisor attribute a stalled pod to the wedged host;
        # absent (one process), the line is byte-unchanged.
        host = os.environ.get("SART_POD_PROCESS")
        if host:
            extra += f" host={host}"
        if sched:
            occ = sched.get("occupancy")
            if occ is not None:
                extra += f" occupancy={float(occ):.3f}"
            lanes = sched.get("lanes")
            if lanes is not None:
                extra += " lanes=" + (
                    ",".join(str(s) for s in lanes) if lanes else "-"
                )
        from sartsolver_tpu_torch.utils import atomicio

        # fsync=False: the heartbeat is advisory and high-frequency —
        # a torn line after a machine crash only costs one staleness
        # reading, while an fsync per beat would tax the solve loop
        atomicio.write_atomic(
            path,
            f"phase={_last_work_phase} frames={_frames_done} "
            f"serial={_serial}{extra} unix={time.time():.3f}\n",
            fsync=False,
        )
    except OSError:
        pass


def register_interruptible(thread: threading.Thread) -> None:
    """Mark ``thread`` as safe to receive the watchdog's async
    ``WatchdogTimeout`` (it catches the exception and degrades its
    stream instead of dying silently)."""
    _interruptible.add(thread)


def unregister_interruptible(thread: threading.Thread) -> None:
    _interruptible.discard(thread)


def _async_raise(thread_ident: int) -> bool:
    """Raise ``WatchdogTimeout`` in the thread with ``thread_ident``.

    CPython delivers the exception at the next bytecode boundary — which
    is exactly what un-sticks a cooperative stall (the injected ``hang``
    fault's sleep loop, a Python-level retry spin). A thread blocked
    inside a C call (a wedged CUDA synchronize, ``Thread.join``) will not see it
    until the call returns; the monitor's grace-period hard abort covers
    that case.
    """
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_ident), ctypes.py_object(WatchdogTimeout)
    )
    if res > 1:  # pragma: no cover - "should never happen" per CPython docs
        # more than one thread state modified: revoke to avoid collateral
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_ident), None
        )
        return False
    return res == 1


def _async_revoke(thread_ident: int) -> None:
    """Clear a still-pending async ``WatchdogTimeout`` for a thread.

    A stage-1 interrupt aimed at a thread inside a C call stays PENDING
    until that call returns. If the stall then resolves on its own (a
    legitimately slow compile/write finished — beacons resumed) the
    pending exception would otherwise detonate at some arbitrary later
    bytecode of a healthy run. Revoking is a no-op when the exception
    was already delivered."""
    ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_ident), None
    )


def dump_stacks(out=None) -> None:
    """Write every live thread's stack to ``out`` (default stderr)."""
    out = out if out is not None else sys.stderr
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = ["sartsolve watchdog: thread stacks:"]
    for ident, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        lines.extend(
            line.rstrip("\n") for line in traceback.format_stack(frame)
        )
    out.write("\n".join(lines) + "\n")
    out.flush()


class Watchdog:
    """Monitor thread escalating beacon silence (module docstring).

    ``hard_exit=False`` replaces the final ``os._exit`` with an event
    record — for in-process tests, where killing the interpreter would
    take the test runner with it.
    """

    def __init__(
        self,
        timeout: float,
        *,
        grace: Optional[float] = None,
        poll: Optional[float] = None,
        on_event: Optional[Callable[[str], None]] = None,
        hard_exit: bool = True,
    ):
        if timeout <= 0:
            raise ValueError("Watchdog timeout must be positive.")
        self.timeout = float(timeout)
        self.grace = float(grace) if grace is not None else max(timeout, 5.0)
        self._poll = poll if poll is not None else min(timeout / 4.0, 1.0)
        self._on_event = on_event
        self._hard_exit = hard_exit
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._main_interrupted = False  # stage-1 interrupt possibly pending
        self.fired = 0  # escalations (observability / tests)
        self.hard_aborted = False  # only observable with hard_exit=False

    @classmethod
    def from_env(
        cls, on_event: Optional[Callable[[str], None]] = None
    ) -> Optional["Watchdog"]:
        """A watchdog per ``SART_WATCHDOG_TIMEOUT``, or None when unset/0."""
        timeout = float(os.environ.get("SART_WATCHDOG_TIMEOUT", "0") or 0)
        if timeout <= 0:
            return None
        grace_env = os.environ.get("SART_WATCHDOG_GRACE")
        return cls(
            timeout,
            grace=float(grace_env) if grace_env else None,
            on_event=on_event,
        )

    def start(self) -> "Watchdog":
        beacon("watchdog.start")  # the watch begins from a fresh beacon
        self._thread = threading.Thread(
            target=self._run, name="sart-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._revoke_main()

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _note(self, message: str) -> None:
        sys.stderr.write(f"sartsolve watchdog: {message}\n")
        sys.stderr.flush()
        if self._on_event is not None:
            try:
                self._on_event(f"watchdog: {message}")
            except Exception:  # the event sink must never kill the monitor
                pass

    def _run(self) -> None:
        seen = last_beacon()
        progressed_at = time.monotonic()
        stage = 0  # 0 watching, 1 main interrupted, 2 workers interrupted
        stage_at = progressed_at
        while not self._stop.wait(self._poll):
            now = time.monotonic()
            cur = last_beacon()
            if cur[1] != seen[1]:  # serial moved: progress
                seen = cur
                progressed_at = now
                stage = 0
                # the stall resolved on its own (a slow-but-healthy
                # compile/write finished): a stage-1 interrupt still
                # pending in a C call must not detonate later
                self._revoke_main()
                continue
            stalled = now - progressed_at
            if stage == 0:
                if stalled < self.timeout:
                    continue
                # stage 1: dump everything, interrupt the frame loop —
                # per-frame isolation turns a hung staging/dispatch/fetch
                # into a FRAME_FAILED row and the run continues
                self.fired += 1
                self._note(
                    f"no progress for {stalled:.1f}s (last beacon: phase "
                    f"{cur[0]!r}); dumping thread stacks and interrupting "
                    "the stuck frame"
                )
                dump_stacks()
                self._interrupt_main()
                stage, stage_at = 1, now
            elif stage == 1 and now - stage_at >= self.grace:
                # stage 2: the main thread may be wedged inside a C call
                # (async exceptions stay pending there); interrupting the
                # worker threads un-sticks a hung read/fetch/flush and,
                # by completing the handoff, lets the main thread's
                # pending interrupt fire
                self._note(
                    f"still no progress {stalled:.1f}s in; interrupting "
                    "worker threads"
                )
                self._interrupt_workers()
                stage, stage_at = 2, now
            elif stage == 2 and now - stage_at >= self.grace:
                # stage 3: nothing can be un-stuck from in-process
                self._note(
                    f"still no progress {stalled:.1f}s in; aborting with "
                    f"exit {EXIT_INFRASTRUCTURE} — the output file is "
                    "resumable (--resume)"
                )
                dump_stacks()
                self.hard_aborted = True
                # flush the flight recorder's crash bundle (obs/flight.py)
                # NOW: os._exit skips every finally block, so this hook is
                # the bundle's only chance on the hard-abort path
                _fire_crash_hook(
                    f"watchdog hard abort: no progress for {stalled:.1f}s "
                    f"(last beacon: phase {cur[0]!r})"
                )
                if self._hard_exit:
                    # os._exit: no atexit/finally — anything those would
                    # flush is exactly what is wedged; the solution file
                    # is crash-consistent by construction
                    os._exit(EXIT_INFRASTRUCTURE)
                return

    def _interrupt_main(self) -> None:
        main = threading.main_thread()
        if main.ident is not None and main.is_alive():
            if _async_raise(main.ident):
                self._main_interrupted = True
            else:
                self._note("could not deliver the interrupt to the main "
                           "thread")

    def _revoke_main(self) -> None:
        if not self._main_interrupted:
            return
        self._main_interrupted = False
        main = threading.main_thread()
        if main.ident is not None and main.is_alive():
            _async_revoke(main.ident)

    def _interrupt_workers(self) -> None:
        for t in list(_interruptible):
            if t.ident is not None and t.is_alive():
                _async_raise(t.ident)


