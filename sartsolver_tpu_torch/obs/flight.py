"""Flight recorder: live status snapshots, SIGUSR1, crash bundles.

Counterpart of ``sartsolver_tpu/obs/flight.py``: the same records, files
and knobs, so either package's ``sartsolve top`` renders the other's
snapshot. Like the rest of ``obs/`` it loads neither torch nor numpy, and
nothing in it touches the device: a status poke reads host state only.

A resident solver run is otherwise observable at exactly two grains: a
per-frame heartbeat mtime while it lives, and a post-mortem artifact
after it exits. This module fills the gap between them
(the JAX package's docs/OBSERVABILITY.md §9):

- **Status snapshot** — :func:`status_snapshot` assembles a one-shot
  live view: completed frames, the last beacon and per-phase beacon
  ages (resilience/watchdog.py), the continuous-batching scheduler's
  lane occupancy + in-flight lane serials when it is driving, and the
  metric registry snapshot — as a versioned obs ``status`` record.
  ``SIGUSR1`` dumps it to stderr and a JSON file
  (:func:`install_status_handler`; ``kill -USR1 <pid>`` from any
  terminal, no restart, no flags), and ``sartsolve top`` renders the
  same files as a refreshing screen.
- **Flight ring** — :class:`FlightRecorder` keeps a bounded ring of
  recent beacons and availability events (``SART_FLIGHT_EVENTS``,
  default 512). In-memory only: the steady state costs one deque append
  per beacon, writes nothing, and changes no output — the disabled-path
  byte-identity contract holds.
- **Crash bundle** — :func:`write_crash_bundle` flushes {reason, status
  snapshot, ring, partial-run accounting} as one JSON file on every
  abnormal exit path: the CLI's infrastructure aborts (watchdog
  timeout, retries exhausted, output write failure, SDC quarantine),
  the graceful-stop exit 4, unhandled internal errors — and, via
  ``watchdog.set_crash_hook``, the stage-3 ``os._exit(3)`` that no
  ``finally`` block survives. Exit-3/4 triage starts from this file
  (the JAX package's docs/RESILIENCE.md §9).

Everything here is host-side, advisory and exception-swallowing: a
failed snapshot or bundle write is a stderr note, never a new failure
mode on top of the one being reported.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
from collections import deque
from typing import List, Optional

from sartsolver_tpu_torch.obs import metrics, schema
from sartsolver_tpu_torch.resilience import watchdog
from sartsolver_tpu_torch.utils.locking import named_lock, stale_read


class FlightRecorder:
    """Bounded in-memory ring of recent events (newest kept)."""

    def __init__(self, max_events: Optional[int] = None) -> None:
        if max_events is None:
            raw = os.environ.get("SART_FLIGHT_EVENTS", "512")
            try:
                max_events = int(raw)
            except ValueError:
                # advisory layer: a typo'd ring size must not become a
                # startup crash — note it and run at the default
                print(f"sartsolve: ignoring malformed SART_FLIGHT_EVENTS="
                      f"{raw!r} (using 512)", file=sys.stderr)
                max_events = 512
        self._lock = named_lock("obs.flight.ring")
        self._ring: deque = deque(maxlen=max(int(max_events), 1))  # guarded by: self._lock
        self.total = 0  # guarded by: self._lock

    def record(self, kind: str, **data) -> None:
        entry = {"unix": round(time.time(), 3), "kind": str(kind)}
        entry.update(data)
        with self._lock:
            self._ring.append(entry)
            self.total += 1

    def beacon(self, phase: str, serial: int, _t: float,
               ident: int) -> None:
        """Beacon-tap target (watchdog.add_beacon_tap): every pipeline
        phase transition lands in the ring, so the bundle's tail shows
        what the run was doing right before it died."""
        self.record("beacon", phase=phase, serial=serial, tid=ident)

    def snapshot(self, blocking: bool = True) -> List[dict]:
        """Ring contents, oldest first. ``blocking=False`` is for signal
        context and the crash hook: a ring lock held by the interrupted
        (or wedged) thread degrades to a lock-free stale read — the
        report must never hang on the state it is reporting."""
        if self._lock.acquire(blocking=blocking):
            try:
                return list(self._ring)
            finally:
                self._lock.release()
        # lock-free stale fallback (utils/locking.stale_read)
        return stale_read(lambda: list(self._ring), default=[])


# Module-global active recorder; None = not installed (library callers).
_recorder: Optional[FlightRecorder] = None


def install(recorder: Optional[FlightRecorder] = None) -> FlightRecorder:
    """Activate the flight ring and tap the beacon stream into it."""
    global _recorder
    _recorder = recorder if recorder is not None else FlightRecorder()
    watchdog.add_beacon_tap("flight", _recorder.beacon)
    return _recorder


def uninstall() -> None:
    global _recorder
    _recorder = None
    watchdog.remove_beacon_tap("flight")


def record_event(kind: str, message: str = "", **data) -> None:
    """Drop an event into the active ring; no-op when none installed."""
    rec = _recorder
    if rec is not None:
        if message:
            data["message"] = str(message)
        rec.record(kind, **data)


def default_status_path(output_file: str) -> str:
    """``SART_STATUS_FILE`` or ``<output>.status.json``."""
    return os.environ.get("SART_STATUS_FILE") \
        or f"{output_file}.status.json"


def default_bundle_path(output_file: str) -> str:
    """``SART_FLIGHT_BUNDLE`` or ``<output>.crash.json``."""
    return os.environ.get("SART_FLIGHT_BUNDLE") \
        or f"{output_file}.crash.json"


def status_snapshot(blocking: bool = True, **extra) -> dict:
    """The live one-shot view as a versioned obs ``status`` record.

    ``blocking=False`` is mandatory from signal context (the SIGUSR1
    handler) and the watchdog crash hook: the metric/ring locks may be
    held by the very thread the handler interrupted — or by a wedged
    one — and a blocking acquire there self-deadlocks the run the
    snapshot was meant to describe. The non-blocking form degrades a
    held lock to a stale read (pinned by the signal-under-lock drill in
    ``tests/test_concurrency.py``)."""
    phase, serial, t, _ident = watchdog.last_beacon()
    now = time.monotonic()
    rec = {
        "type": "status",
        "schema": schema.SCHEMA_VERSION,
        "unix": round(time.time(), 3),
        "pid": os.getpid(),
        # pod identity ("k/n", parallel/multihost.export_pod_identity):
        # which host of a pod this snapshot/crash bundle describes
        "host": os.environ.get("SART_POD_PROCESS"),
        "frames_done": int(watchdog.frames_done()),
        "last_beacon": {
            "phase": phase,
            "serial": int(serial),
            "age_s": round(now - t, 3) if t else None,
        },
        "beacon_ages": watchdog.beacon_ages(),
        "sched": watchdog.sched_status(),
        "engine": watchdog.engine_status(),  # a serve process's view
        "metrics": metrics.get_registry().snapshot(blocking=blocking),
    }
    rec.update(extra)
    return rec


def _write_json_atomic(path: str, payload: dict) -> None:
    from sartsolver_tpu_torch.utils import atomicio

    # fsync=True: crash bundles and status dumps exist to be read
    # AFTER something went wrong — they must survive it
    atomicio.write_json_atomic(path, payload, fsync=True)


def write_status(path: str, blocking: bool = True, **extra) -> dict:
    """Snapshot + atomic publish (the SIGUSR1 dump / ``sartsolve top``
    source). Returns the record; raises only OSError from the write."""
    rec = status_snapshot(blocking=blocking, **extra)
    _write_json_atomic(path, rec)
    return rec


def install_status_handler(path: str):
    """Install the SIGUSR1 status dump; returns the previous handler
    (pass back to :func:`uninstall_status_handler`), or None when the
    platform has no SIGUSR1 or this is not the main thread."""
    if not hasattr(signal, "SIGUSR1"):  # pragma: no cover - non-POSIX
        return None

    def handler(_signum, _frame):
        # runs between bytecodes of the main thread: keep it short,
        # allocation-light, and absolutely exception-free — a failed
        # snapshot must never kill a healthy run. blocking=False is
        # load-bearing: the interrupted bytecode may be inside
        # record_frame holding a metric lock, and a blocking snapshot
        # would wait on a lock whose owner cannot run until this
        # handler returns (self-deadlock). Host state only: no CUDA call.
        try:
            rec = write_status(path, blocking=False)
            lb = rec["last_beacon"]
            line = (
                f"sartsolve status: frames={rec['frames_done']} "
                f"phase={lb['phase']} serial={lb['serial']}"
            )
            if lb["age_s"] is not None:
                line += f" beacon_age={lb['age_s']:.1f}s"
            sched = rec.get("sched")
            if sched:
                line += f" occupancy={sched.get('occupancy')}"
            sys.stderr.write(f"{line} -> {path}\n")
            sys.stderr.flush()
        except Exception:
            pass

    try:
        return signal.signal(signal.SIGUSR1, handler)
    except ValueError:  # pragma: no cover - not the main thread
        return None


def uninstall_status_handler(previous) -> None:
    if not hasattr(signal, "SIGUSR1"):  # pragma: no cover - non-POSIX
        return
    try:
        signal.signal(signal.SIGUSR1,
                      previous if previous is not None else signal.SIG_DFL)
    except (ValueError, TypeError):  # pragma: no cover - defensive
        pass


def write_crash_bundle(path: str, reason: str, summary=None) -> bool:
    """Flush {reason, status snapshot, event ring, partial accounting}
    to ``path`` (obs ``flight`` record). Never raises — called from
    abort paths (including the watchdog's pre-``os._exit`` hook) where
    a second failure must not mask the first. Returns True when the
    bundle landed."""
    try:
        # blocking=False throughout: the crash hook fires while the
        # process may be wedged mid-phase with metric/ring locks held —
        # the bundle settles for a stale view over hanging alongside it
        return _write_crash_bundle_quiet(path, reason, summary)
    except Exception as err:  # pragma: no cover - double-fault guard
        try:
            print(f"sartsolve: crash-bundle write failed: {err}",
                  file=sys.stderr)
        except Exception:
            pass
        return False


def _write_crash_bundle_quiet(path: str, reason: str, summary) -> bool:
    try:
        rec = {
            "type": "flight",
            "schema": schema.SCHEMA_VERSION,
            "unix": round(time.time(), 3),
            "pid": os.getpid(),
            "reason": str(reason),
            "status": status_snapshot(blocking=False),
            "ring": (_recorder.snapshot(blocking=False)
                     if _recorder is not None else []),
        }
        if _recorder is not None:
            rec["ring_total"] = _recorder.total
        if summary is not None:
            # the partial-run accounting an operator triages from: what
            # the aborted run DID complete (the metrics artifact holds
            # the full per-frame detail when a sink was configured)
            from sartsolver_tpu_torch.resilience.failures import status_name

            rec["partial"] = {
                "frames": summary.n_frames,
                "by_status": {
                    status_name(s): n
                    for s, n in sorted(summary.counts.items()) if n
                },
                "failed_times": [float(t) for t in summary.failed_times],
                "events": list(summary.events),
            }
        _write_json_atomic(path, rec)
        print(f"sartsolve: crash bundle written to {path}",
              file=sys.stderr)
        return True
    except Exception as err:
        try:
            print(f"sartsolve: crash-bundle write failed: {err}",
                  file=sys.stderr)
        except Exception:
            pass
        return False
