"""Trace spans of the host phases, as Chrome trace-event JSON.

Counterpart of ``sartsolver_tpu/obs/trace.py``. :func:`span` wraps host
work that has a natural duration (RTM ingest, a dispatch, a result fetch,
the voxel-map write) in a complete event with optional key=value args. The
serving engine records each request on a track of its own
(:func:`request_span`, :func:`request_instant`, :func:`request_complete`),
and :func:`request_trace` cuts one request's track out as a standalone
trace.
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
        # request tracks (serving engine): trace id -> synthetic tid, so
        # each request renders as its own named row, apart from the host
        # threads' phase timelines (pthread idents are large; the synthetic
        # tids start at 1)
        self._tracks: Dict[str, int] = {}  # guarded by: self._lock
        self._next_track = 1  # guarded by: self._lock
        # per-track event index (the same dicts as _events): a request's
        # trace is cut out at its completion without scanning the buffer
        self._track_events: Dict[int, List[dict]] = {}  # guarded by: self._lock

    def _us(self, t: float) -> float:
        return (t - self._epoch) * 1e6

    def _append_locked(self, event: dict, track: Optional[int] = None) -> None:
        if len(self._events) >= self._max:
            self._dropped += 1
            return
        self._events.append(event)
        if track is not None:
            self._track_events.setdefault(track, []).append(event)

    def add_complete(self, name: str, cat: str, start: float, dur: float,
                     tid: int, args: Optional[Dict[str, object]] = None,
                     _track: bool = False) -> None:
        event = {"name": name, "cat": cat, "ph": "X", "pid": os.getpid(),
                 "tid": tid, "ts": self._us(start), "dur": dur * 1e6}
        if args:
            event["args"] = dict(args)
        with self._lock:
            self._append_locked(event, track=tid if _track else None)

    def add_instant(self, name: str, cat: str, tid: int,
                    args: Optional[Dict[str, object]] = None,
                    _track: bool = False) -> None:
        event = {"name": name, "cat": cat, "ph": "i", "s": "t",
                 "pid": os.getpid(), "tid": tid,
                 "ts": self._us(time.perf_counter())}
        if args:
            event["args"] = dict(args)
        with self._lock:
            self._append_locked(event, track=tid if _track else None)

    # ---- request-scoped tracks (serving engine) --------------------------

    def request_track(self, trace_id: str) -> Optional[int]:
        """The synthetic tid of ``trace_id``'s track, allocated (with a
        Perfetto ``thread_name`` metadata event) on first use.

        Bounded like everything else in the buffer: a resident server
        sees one NEW track per request forever, so past the event cap
        no further tracks (or their metadata rows) are allocated —
        returns None and the would-be events count as dropped. An
        unbounded track table would be exactly the slow host-memory
        leak the cap exists to prevent."""
        trace_id = str(trace_id)
        with self._lock:
            tid = self._tracks.get(trace_id)
            if tid is None:
                if len(self._events) >= self._max:
                    self._dropped += 1
                    return None
                tid = self._tracks[trace_id] = self._next_track
                self._next_track += 1
                # the name row is what makes the track readable; it is
                # appended under the same cap check above
                meta = {
                    "name": "thread_name", "ph": "M", "pid": os.getpid(),
                    "tid": tid, "args": {"name": f"request {trace_id}"},
                }
                self._events.append(meta)
                self._track_events[tid] = [meta]
            return tid

    def add_request_complete(self, trace_id: str, name: str, start: float,
                             end: float, args: Optional[dict] = None
                             ) -> None:
        """A complete span on ``trace_id``'s track, from perf_counter
        ``start`` to ``end`` (retroactive emission is fine — queue-wait
        spans are only known complete at dispatch)."""
        tid = self.request_track(trace_id)
        if tid is None:  # buffer saturated: already counted as dropped
            return
        merged = {"trace": str(trace_id)}
        if args:
            merged.update(args)
        self.add_complete(name, "request", start, max(end - start, 0.0),
                          tid, merged, _track=True)

    def add_request_instant(self, trace_id: str, name: str,
                            args: Optional[dict] = None) -> None:
        tid = self.request_track(trace_id)
        if tid is None:
            return
        merged = {"trace": str(trace_id)}
        if args:
            merged.update(args)
        self.add_instant(name, "request", tid, merged, _track=True)

    def request_events(self, trace_id: str) -> Optional[dict]:
        """One trace id's section of the buffer as a standalone Chrome
        trace-event object (Perfetto-loadable), or None when the trace
        id owns no track. Reads the per-track index — O(this track's
        events), never a scan of the whole buffer. Note the unit is the
        TRACE id: a client that deliberately reuses one id across
        requests (distributed-tracing propagation) gets all of them on
        one track, and every per-request publish of that id carries the
        whole track — that is the grouping semantics trace propagation
        asks for, not a leak."""
        with self._lock:
            tid = self._tracks.get(str(trace_id))
            if tid is None:
                return None
            events = [dict(e) for e in self._track_events.get(tid, ())]
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"tool": "sartsolve", "pid": os.getpid(),
                          "trace": str(trace_id)},
        }

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
    """Connect the watchdog's beacon stream to ``target``
    (:meth:`TraceBuffer.beacon`: a beacon closes its thread's previous
    phase span and opens the next), or with
    None disconnect it; the flight ring's tap is left alone."""
    from sartsolver_tpu_torch.resilience import watchdog

    watchdog.set_beacon_tap(target)


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


class _RequestSpan:
    """Span recorded on one request's track (serving engine)."""

    def __init__(self, buffer: "TraceBuffer", trace_id: str, name: str,
                 args: Dict[str, object]):
        self._buffer = buffer
        self._trace_id = trace_id
        self._name = name
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_RequestSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._buffer.add_request_complete(
            self._trace_id, self._name, self._t0, time.perf_counter(),
            self._args,
        )


def request_span(trace_id: Optional[str], name: str, **args):
    """Context manager recording ``name`` on ``trace_id``'s request
    track; the shared no-op when tracing is disabled or the id is
    falsy (one None check on the hot path, like :func:`span`)."""
    buf = _buffer
    if buf is None or not trace_id:
        return _NULL_SPAN
    return _RequestSpan(buf, str(trace_id), name, args)


def request_instant(trace_id: Optional[str], name: str, **args) -> None:
    """Instant event on a request track; no-op when disabled."""
    buf = _buffer
    if buf is not None and trace_id:
        buf.add_request_instant(str(trace_id), name, args)


def request_complete(trace_id: Optional[str], name: str, start: float,
                     end: float, **args) -> None:
    """Retroactive complete span on a request track from perf_counter
    ``start`` to ``end`` (queue-wait is only known at dispatch);
    no-op when disabled."""
    buf = _buffer
    if buf is not None and trace_id:
        buf.add_request_complete(str(trace_id), name, start, end, args)


def request_trace(trace_id: Optional[str]) -> Optional[dict]:
    """The active buffer's section for ``trace_id`` as a standalone
    Chrome trace object, or None (disabled / unknown id)."""
    buf = _buffer
    if buf is None or not trace_id:
        return None
    return buf.request_events(str(trace_id))
