"""Trace spans of the host phases, as Chrome trace-event JSON.

Counterpart of ``sartsolver_tpu/obs/trace.py`` without the request tracks
of the serving engine (ROADMAP queue A item 6). :func:`span` wraps host
work that has a natural duration (RTM ingest, a dispatch, a result fetch,
the voxel-map write) in a complete event with optional key=value args.
:meth:`TraceBuffer.beacon` folds a stream of phase beacons into
per-thread phase spans; the watchdog that emits them comes with queue A
item 3 and connects in :func:`_tap_beacons`.

The buffer renders to Chrome trace-event JSON (``ph: "X"`` complete events,
microsecond timestamps), loadable in Perfetto or chrome://tracing beside
``--profile_dir``'s ``torch.profiler`` trace.

Cost: with no buffer installed (the default) :func:`span` returns a shared
no-op context manager; nothing is recorded or allocated per call. The CLI
installs a buffer only when ``SART_TRACE_EVENTS`` is set.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from sartsolver_tpu_torch.utils.locking import named_lock


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    def __init__(self, buffer: "TraceBuffer", name: str, cat: str,
                 args: Dict[str, object]):
        self._buffer = buffer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._buffer.add_complete(
            self._name, self._cat, self._t0,
            time.perf_counter() - self._t0,
            threading.get_ident(), self._args,
        )


class TraceBuffer:
    """Thread-safe in-memory store of trace events.

    Bounded: past ``max_events`` (default 1e6; env
    ``SART_TRACE_MAX_EVENTS``) new events are dropped and counted. The
    trace keeps its head (ingest, the first frames: the part that
    attributes a slow run), and the export records how many tail events
    were dropped.
    """

    def __init__(self, max_events: Optional[int] = None) -> None:
        self._lock = named_lock("obs.trace.buffer")
        self._events: List[dict] = []  # guarded by: self._lock
        self._epoch = time.perf_counter()
        self._max = max_events if max_events is not None else int(
            os.environ.get("SART_TRACE_MAX_EVENTS", "1000000")
        )
        self._dropped = 0  # guarded by: self._lock
        # per-thread open phase span from the beacon stream:
        # ident -> (phase, perf_counter at its beacon)
        self._open: Dict[int, Tuple[str, float]] = {}  # guarded by: self._lock

    def _us(self, t: float) -> float:
        return (t - self._epoch) * 1e6

    def _append_locked(self, event: dict) -> None:
        if len(self._events) >= self._max:
            self._dropped += 1
            return
        self._events.append(event)

    def add_complete(self, name: str, cat: str, start: float, dur: float,
                     tid: int, args: Optional[Dict[str, object]] = None) -> None:
        event = {"name": name, "cat": cat, "ph": "X", "pid": os.getpid(),
                 "tid": tid, "ts": self._us(start), "dur": dur * 1e6}
        if args:
            event["args"] = dict(args)
        with self._lock:
            self._append_locked(event)

    def add_instant(self, name: str, cat: str, tid: int,
                    args: Optional[Dict[str, object]] = None) -> None:
        event = {"name": name, "cat": cat, "ph": "i", "s": "t",
                 "pid": os.getpid(), "tid": tid,
                 "ts": self._us(time.perf_counter())}
        if args:
            event["args"] = dict(args)
        with self._lock:
            self._append_locked(event)

    def beacon(self, phase: str, serial: int, _t: float, ident: int) -> None:
        """Beacon-tap target: a beacon marks "phase X of this thread starts
        now", which also ends the thread's previous phase span."""
        now = time.perf_counter()
        with self._lock:
            prev = self._open.get(ident)
            if prev is not None:
                name, t0 = prev
                self._append_locked({
                    "name": name, "cat": "beacon", "ph": "X",
                    "pid": os.getpid(), "tid": ident,
                    "ts": self._us(t0), "dur": (now - t0) * 1e6,
                })
            self._open[ident] = (phase, now)

    def close_open_spans(self) -> None:
        """Flush still-open per-thread phase spans (end of run)."""
        now = time.perf_counter()
        with self._lock:
            for ident, (name, t0) in self._open.items():
                self._append_locked({
                    "name": name, "cat": "beacon", "ph": "X",
                    "pid": os.getpid(), "tid": ident,
                    "ts": self._us(t0), "dur": (now - t0) * 1e6,
                })
            self._open.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        other = {"tool": "sartsolve", "pid": os.getpid()}
        if dropped:
            other["dropped_events"] = dropped
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def write_json(self, path: str) -> None:
        from sartsolver_tpu_torch.utils.atomicio import write_atomic

        # fsync=False: a trace is advisory, like a scrape textfile
        write_atomic(path, json.dumps(self.to_chrome()), fsync=False)


# Module-global active buffer; None = tracing disabled (the default).
_buffer: Optional[TraceBuffer] = None


def _tap_beacons(target) -> None:
    """Where the watchdog's beacon stream (queue A item 3) connects:
    ``target`` is :meth:`TraceBuffer.beacon`, or None to disconnect. The
    port has no beacon source yet."""


def active_buffer() -> Optional[TraceBuffer]:
    return _buffer


def install(buffer: TraceBuffer) -> TraceBuffer:
    """Activate ``buffer``: :func:`span` records into it."""
    global _buffer
    _buffer = buffer
    _tap_beacons(buffer.beacon)
    return buffer


def uninstall() -> None:
    global _buffer
    _buffer = None
    _tap_beacons(None)


def span(name: str, cat: str = "host", **args):
    """Context manager recording ``name`` as a complete trace event.

    Returns a shared no-op object when tracing is disabled, so it is safe
    and cheap to leave in production code paths.
    """
    buf = _buffer
    if buf is None:
        return _NULL_SPAN
    return _Span(buf, name, cat, args)
