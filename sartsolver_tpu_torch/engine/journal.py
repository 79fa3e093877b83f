"""Crash-recoverable append-only request journal (docs/SERVING.md §4).

Counterpart of ``sartsolver_tpu/engine/journal.py``, host-only: it imports
neither torch nor JAX, and its records are the JAX engine's, field for field.

One JSONL file under the engine directory records every request's
lifecycle as three markers::

    {"marker": "accepted",   "id": ..., "unix": ..., "request": {...}}
    {"marker": "dispatched", "id": ..., "unix": ...}
    {"marker": "completed",  "id": ..., "unix": ..., "outcome": {...}}

Durability and replay contract (pinned by the crash drill in
tests/test_engine.py):

- Every append is flush+fsync'd before the engine acts on it, so after
  a ``kill -9`` at ANY instant the journal is a consistent prefix of
  the run (a torn final line — the kill landing mid-append — is
  ignored by :func:`replay`, which is exactly the state "the marker
  never landed").
- Replay is idempotent by id: a request with a ``completed`` marker is
  never re-run; a request with ``accepted`` (with or without
  ``dispatched``) but no ``completed`` is re-run from its journaled
  payload, in acceptance order, ahead of new ingest. Requests solve
  frames independently (no cross-request warm state), so a replayed
  solve writes byte-identical output.

Named fault site ``journal.append`` (wrapped in the shared retry
policy): the journal is the engine's correctness backbone, so a
*permanent* append failure is an engine abort (EXIT_INFRASTRUCTURE),
never a silently unjournaled request.

Deterministic crash windows for the kill drill: with
``SART_TEST_JOURNAL_DELAY`` set, the named commit points announce
``SART_JOURNAL_POINT <name>`` on stderr and sleep inside the window —
"accepted" / "dispatched" (marker durable, nothing acted on yet) and
"pre-flush" (outputs written, completed marker NOT yet durable).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from sartsolver_tpu_torch.engine.request import Request
from sartsolver_tpu_torch.obs import trace as obs_trace
from sartsolver_tpu_torch.resilience import faults
from sartsolver_tpu_torch.resilience.retry import retry_call
from sartsolver_tpu_torch.utils import atomicio

MARKER_ACCEPTED = "accepted"
MARKER_DISPATCHED = "dispatched"
MARKER_COMPLETED = "completed"
# fleet failover (docs/SERVING.md §10): the controller appends a
# handoff marker to a DEAD worker's journal before re-staging the
# request on a survivor — the dead worker's own replay then skips the
# id (exactly one of {local re-drive, fleet handoff} can happen)
MARKER_HANDOFF = "handoff"
# session-cache attach/evict events (engine/session.py): observability
# records riding the journal's durability; replay skips them
MARKER_SESSION = "session"

_MARKERS = (MARKER_ACCEPTED, MARKER_DISPATCHED, MARKER_COMPLETED,
            MARKER_HANDOFF, MARKER_SESSION)


def _crash_window(point: str) -> None:
    """Test-only hook mirroring io/solution.py's flush windows: announce
    the commit point and hold it open so the kill drill can SIGKILL the
    real serve process deterministically inside it. Zero work unset."""
    delay = os.environ.get("SART_TEST_JOURNAL_DELAY")
    if delay:
        # fleet workers tag the announcement so the fleet chaos harness
        # can SIGKILL the SPECIFIC worker sleeping in this window; the
        # controller (no SART_WORKER_ID) announces untagged, which is
        # how the harness recognizes a mid-handoff controller
        worker = os.environ.get("SART_WORKER_ID")
        tag = f" worker={worker}" if worker else ""
        sys.stderr.write(f"SART_JOURNAL_POINT {point}{tag}\n")
        sys.stderr.flush()
        time.sleep(float(delay))


class RequestJournal:
    """Append-only journal over one JSONL file."""

    def __init__(self, path: str):
        self.path = path  # durable: journal

    # ---- append ----------------------------------------------------------

    def append(self, marker: str, request_id: str, *,
               trace_id: Optional[str] = None, **data) -> None:
        """Durably append one marker record (flush + fsync before
        returning). The ``completed`` marker exposes the "pre-flush"
        crash window BEFORE the record lands (outputs are on disk, the
        completion is not — a kill there must replay the request);
        ``accepted``/``dispatched`` expose theirs AFTER (the marker is
        durable, the work it promises has not started)."""
        if marker not in _MARKERS:
            raise ValueError(f"Unknown journal marker {marker!r}.")
        rec = {"marker": marker, "id": str(request_id),
               "unix": round(time.time(), 3)}
        if trace_id:
            # the trace id rides every marker so post-mortem triage can
            # join the journal against traces/metrics/crash bundles
            # ("which requests were in flight when it died")
            rec["trace"] = str(trace_id)
        rec.update(data)
        line = json.dumps(rec) + "\n"
        if marker == MARKER_COMPLETED:
            _crash_window("pre-flush")

        def write() -> None:
            faults.fire(faults.SITE_JOURNAL_APPEND)
            atomicio.append_line(self.path, line)

        # transient fs blips (an NFS hiccup under the engine dir) retry
        # with the shared policy; exhaustion raises RetriesExhausted,
        # which the server maps to the infrastructure abort — an engine
        # that cannot journal must stop, not serve unjournaled work
        with obs_trace.request_span(trace_id, f"journal.{marker}"):
            retry_call(write, site=faults.SITE_JOURNAL_APPEND,
                       retry_on=(OSError,))
        if marker != MARKER_COMPLETED:
            _crash_window(marker)

    def accepted(self, request: Request) -> None:
        self.append(MARKER_ACCEPTED, request.id, trace_id=request.trace,
                    request=request.to_dict())

    def dispatched(self, request: Request) -> None:
        self.append(MARKER_DISPATCHED, request.id,
                    trace_id=request.trace)

    def completed(self, request: Request, outcome: dict) -> None:
        self.append(MARKER_COMPLETED, request.id, trace_id=request.trace,
                    outcome=outcome)

    def handoff(self, request_id: str, target: int, *,
                trace_id: Optional[str] = None) -> None:
        """Record that the fleet controller re-drove this accepted-but-
        uncompleted request onto worker ``target``. Appended to the
        DEAD worker's journal BEFORE the payload is re-staged, so a
        crash between the two leaves at most an unacted-on marker (the
        controller re-stages on recovery) and never two drivers."""
        self.append(MARKER_HANDOFF, request_id, trace_id=trace_id,
                    target=int(target))

    def session_event(self, kind: str, key: str, **data) -> None:
        """Journal a session-cache attach/evict event (kind is
        ``session-attach`` / ``session-evict``). Replay skips these —
        they carry no request lifecycle, only the audit trail."""
        self.append(MARKER_SESSION, f"{kind}:{key}", event=kind,
                    key=key, **data)

    # ---- replay ----------------------------------------------------------

    def replay(self) -> Tuple[Dict[str, dict], List[Request]]:
        """Read the journal back: ``(completed, pending)``.

        ``completed`` maps request id -> its outcome dict (these are
        never re-run, and re-submissions of the same id are rejected as
        duplicates). ``pending`` holds the accepted-but-not-completed
        requests, reconstructed from their journaled payloads, in
        acceptance order — the restart re-runs exactly these. Requests
        with a ``handoff`` marker are NOT pending here: the controller
        re-drove them on another worker (see :meth:`replay_full`). A
        torn final line (kill mid-append) is skipped; a torn line
        anywhere else would mean the fsync contract broke, but replay
        still degrades per-line rather than refusing the whole
        journal."""
        completed, pending, _ = self.replay_full()
        return completed, pending

    def replay_full(self) -> Tuple[Dict[str, dict], List[Request],
                                   Dict[str, dict]]:
        """:meth:`replay` plus the handoff story: ``(completed,
        pending, handed_off)`` where ``handed_off`` maps each
        re-driven (and not locally completed) request id to
        ``{"target": worker-index, "request": Request-or-None}`` — the
        payload rides along so the controller can re-stage it if the
        handoff was interrupted before the survivor saw the file."""
        completed: Dict[str, dict] = {}
        accepted: Dict[str, Request] = {}
        handoff: Dict[str, dict] = {}
        order: List[str] = []
        if not os.path.exists(self.path):
            return completed, [], {}
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn append (the kill window); marker absent
                marker = rec.get("marker")
                rid = rec.get("id")
                if not isinstance(rid, str):
                    continue
                if marker == MARKER_ACCEPTED:
                    # direct reconstruction, NOT parse_request: the
                    # payload was validated at acceptance, and replay
                    # must not consult the request.parse fault site (an
                    # armed ingest-parse drill would otherwise silently
                    # drop journaled work on restart)
                    raw = rec.get("request") or {}
                    if not isinstance(raw, dict):
                        continue
                    req = Request(
                        id=rid,
                        tenant=str(raw.get("tenant", "default")),
                        time_range=str(raw.get("time_range", "")),
                        deadline_s=raw.get("deadline_s"),
                        submitted_unix=float(
                            raw.get("submitted_unix") or 0.0
                        ),
                        # replay keeps the original trace id: the re-run
                        # is the same request, and its spans/markers must
                        # join against the pre-crash ones
                        trace=str(raw.get("trace", "")),
                        handoff=bool(raw.get("handoff", False)),
                        # the inline geometry record rides the journal so
                        # replay rebuilds the identical implicit operator
                        geometry=(raw["geometry"]
                                  if isinstance(raw.get("geometry"), dict)
                                  else None),
                    )
                    if rid not in accepted:
                        accepted[rid] = req
                        order.append(rid)
                elif marker == MARKER_HANDOFF:
                    handoff[rid] = {"target": rec.get("target")}
                elif marker == MARKER_COMPLETED:
                    outcome = dict(rec.get("outcome") or {})
                    if outcome:
                        # the marker's wall-clock rides along so replay
                        # consumers can age-gate (e.g. the server's
                        # response republish vs its retention TTL)
                        outcome.setdefault("journal_unix",
                                           rec.get("unix"))
                    completed[rid] = outcome
        handed_off = {
            rid: {"target": rec.get("target"),
                  "request": accepted.get(rid)}
            for rid, rec in handoff.items() if rid not in completed
        }
        pending = [accepted[rid] for rid in order
                   if rid not in completed and rid not in handed_off]
        return completed, pending, handed_off

    # ---- rotation --------------------------------------------------------

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def compact(self) -> int:
        """Rewrite the journal keeping only the *pending* story: one
        fresh ``accepted`` marker per accepted-but-not-completed request
        (acceptance order preserved). Completed records are dropped —
        which is only safe once their ids are durable in the engine
        state checkpoint's dedup watermark (engine/state.py), so the
        server always checkpoints BEFORE compacting. Handoff stories
        for non-completed ids survive compaction (accepted + handoff
        markers re-written) — dropping them would resurrect the id as
        pending on the dead worker's next replay, re-driving a request
        the fleet already owns elsewhere. Atomic rename, so a kill
        mid-compaction leaves the previous journal intact. Returns the
        bytes reclaimed (0 when nothing to do)."""
        before = self.size()
        if before == 0:
            return 0
        completed, pending, handed_off = self.replay_full()
        lines = []

        def accepted_line(req: Request) -> str:
            rec = {"marker": MARKER_ACCEPTED, "id": req.id,
                   "unix": round(time.time(), 3)}
            if req.trace:
                rec["trace"] = req.trace
            rec["request"] = req.to_dict()
            return json.dumps(rec) + "\n"

        for req in pending:
            lines.append(accepted_line(req))
        for rid, story in handed_off.items():
            if story.get("request") is not None:
                lines.append(accepted_line(story["request"]))
            lines.append(json.dumps(
                {"marker": MARKER_HANDOFF, "id": rid,
                 "unix": round(time.time(), 3),
                 "target": story.get("target")}) + "\n")
        atomicio.write_atomic(self.path, "".join(lines))
        return max(0, before - self.size())
