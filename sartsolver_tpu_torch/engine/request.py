"""Request model and admission/outcome vocabulary (docs/SERVING.md).

Counterpart of ``sartsolver_tpu/engine/request.py``, host-only: it imports
neither torch nor JAX, and its records are the JAX engine's, field for field.

A request is a small JSON document — there is deliberately no binary
payload: the measurement data already lives in the image files the
resident session ingested, so a request only *selects* work (a time
range) and attaches policy (tenant, deadline)::

    {"id": "shot42-a", "tenant": "diag-a",
     "time_range": "0.1:0.3", "deadline_s": 30.0}

Every admission verdict and terminal outcome is a machine-readable
string from the vocabularies below; they are part of the response-file/
socket contract the same way exit codes are part of the CLI's.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
import uuid
from typing import Optional

from sartsolver_tpu_torch.config import SartInputError, parse_time_intervals
from sartsolver_tpu_torch.resilience import faults

# ---- admission rejection reasons (machine-readable) -----------------------
REASON_MALFORMED = "malformed-request"      # payload failed to parse/validate
REASON_QUEUE_FULL = "queue-full"            # bounded queue at capacity
REASON_TENANT_QUOTA = "tenant-quota"        # tenant's in-queue cap reached
REASON_TENANT_QUARANTINED = "tenant-quarantined"  # failure quarantine active
REASON_DRAINING = "draining"                # engine is stopping (SIGTERM)
REASON_DEGRADED = "degraded"                # load-shed mode (e.g. after OOM)
REASON_DUPLICATE = "duplicate-id"           # id already accepted or completed
REASON_CRASH_LOOP = "crash-loop"            # supervisor breaker open (lame duck)
REASON_WRONG_WORKER = "wrong-worker"        # tenant affinity routes elsewhere

SHED_REASONS = (
    REASON_MALFORMED, REASON_QUEUE_FULL, REASON_TENANT_QUOTA,
    REASON_TENANT_QUARANTINED, REASON_DRAINING, REASON_DEGRADED,
    REASON_DUPLICATE, REASON_CRASH_LOOP, REASON_WRONG_WORKER,
)

# Rejections a client should retry after backing off (`sartsolve submit
# --retry`): transient pool pressure, not a problem with the request.
# The matching responses carry a `retry_after_s` hint derived from the
# queue depth / quarantine cooldown / circuit-breaker window.
RETRYABLE_REASONS = (
    REASON_QUEUE_FULL, REASON_TENANT_QUOTA, REASON_DEGRADED,
    REASON_DRAINING, REASON_TENANT_QUARANTINED, REASON_CRASH_LOOP,
    REASON_WRONG_WORKER,
)

# ---- terminal request outcomes (journal / response records) ---------------
REQ_COMPLETED = "completed"          # every frame SUCCESS/MAX_ITERATIONS
REQ_PARTIAL = "partial"              # completed, some FAILED/DIVERGED/SDC
REQ_FAILED = "failed"                # produced no usable output (attach died)
REQ_SHED_DEADLINE = "shed-deadline"  # deadline passed (queued or mid-solve)
REQ_REJECTED = "rejected"            # never accepted (reason above)

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")
# trace ids are looser than request ids: clients propagate their own
# (e.g. a W3C traceparent fragment), so any reasonable token is accepted
_TRACE_RE = re.compile(r"^[A-Za-z0-9._-]{1,128}$")


def new_trace_id() -> str:
    """A fresh request trace id (assigned at admission for payloads
    that carry none; docs/OBSERVABILITY.md §10)."""
    return uuid.uuid4().hex[:16]


class RequestError(SartInputError):
    """A problem with a request payload (the engine's analog of a flag
    error: rejected with REASON_MALFORMED, never an engine abort)."""


@dataclasses.dataclass(frozen=True)
class Request:
    """One validated serving request."""

    id: str
    tenant: str = "default"
    time_range: str = ""            # parse_time_intervals grammar; "" = all
    deadline_s: Optional[float] = None  # wall-clock budget from acceptance
    submitted_unix: float = 0.0
    # request trace id (docs/OBSERVABILITY.md §10): client-propagated
    # via the payload's "trace" field, or assigned at parse time — every
    # journal marker, response record, frame record and trace span the
    # request touches carries it
    trace: str = ""
    # fleet failover flag (docs/SERVING.md §10): set by the controller
    # when it re-stages a dead worker's journal entry on a survivor —
    # the survivor's admission must accept it even though tenant
    # affinity would normally route the tenant elsewhere
    handoff: bool = False
    # inline geometry record (docs/FORMATS.md §geometry): attaches the
    # matrix-free implicit operator for THIS request's session instead
    # of the worker's resident default. Carried inline (the full
    # validated record, not a path) so journal replay after a crash
    # rebuilds the identical operator from the journal alone. None =
    # the worker's default session.
    geometry: Optional[dict] = None

    def to_dict(self) -> dict:
        return {
            "id": self.id, "tenant": self.tenant,
            "time_range": self.time_range, "deadline_s": self.deadline_s,
            "submitted_unix": self.submitted_unix, "trace": self.trace,
            "handoff": self.handoff, "geometry": self.geometry,
        }


def parse_request(payload, *, default_deadline_s: Optional[float] = None
                  ) -> Request:
    """Parse and validate one request payload (JSON text or dict).

    Named fault site ``request.parse``: an armed ``io``/``error`` fault
    models a torn ingest-file read or a corrupt socket payload — the
    server's handling (reject with REASON_MALFORMED, keep serving) is
    what the drill pins. Raises :class:`RequestError` on anything a
    client got wrong; internal bugs propagate loudly.
    """
    faults.fire(faults.SITE_REQUEST_PARSE)
    if isinstance(payload, (str, bytes)):
        try:
            payload = json.loads(payload)
        except ValueError as err:
            raise RequestError(f"Request is not valid JSON: {err}") from err
    if not isinstance(payload, dict):
        raise RequestError(
            f"Request must be a JSON object, got {type(payload).__name__}."
        )
    unknown = set(payload) - {
        "id", "tenant", "time_range", "deadline_s", "submitted_unix",
        "trace", "handoff", "geometry",
    }
    if unknown:
        raise RequestError(
            f"Unknown request field(s): {', '.join(sorted(unknown))}."
        )
    req_id = payload.get("id")
    if not isinstance(req_id, str) or not _ID_RE.match(req_id):
        raise RequestError(
            "Request field 'id' must be 1-64 characters of "
            "[A-Za-z0-9._-] starting alphanumeric."
        )
    tenant = payload.get("tenant", "default")
    if not isinstance(tenant, str) or not _ID_RE.match(tenant):
        raise RequestError(
            "Request field 'tenant' must be 1-64 characters of "
            "[A-Za-z0-9._-] starting alphanumeric."
        )
    time_range = payload.get("time_range", "")
    if not isinstance(time_range, str):
        raise RequestError("Request field 'time_range' must be a string.")
    try:
        parse_time_intervals(time_range)
    except SartInputError as err:
        raise RequestError(f"Request field 'time_range': {err}") from err
    deadline_s = payload.get("deadline_s", default_deadline_s)
    if deadline_s is not None:
        try:
            deadline_s = float(deadline_s)
        except (TypeError, ValueError) as err:
            raise RequestError(
                "Request field 'deadline_s' must be a number."
            ) from err
        if not deadline_s > 0:
            raise RequestError("Request field 'deadline_s' must be > 0.")
    submitted = payload.get("submitted_unix") or round(time.time(), 3)
    try:
        submitted = float(submitted)
    except (TypeError, ValueError) as err:
        raise RequestError(
            "Request field 'submitted_unix' must be a number."
        ) from err
    trace_id = payload.get("trace")
    if trace_id is None:
        trace_id = new_trace_id()
    elif not isinstance(trace_id, str) or not _TRACE_RE.match(trace_id):
        raise RequestError(
            "Request field 'trace' must be 1-128 characters of "
            "[A-Za-z0-9._-]."
        )
    handoff = payload.get("handoff", False)
    if not isinstance(handoff, bool):
        raise RequestError("Request field 'handoff' must be a boolean.")
    geometry = payload.get("geometry")
    if geometry is not None:
        # full schema validation NOW, at the admission boundary: a bad
        # record is the client's mistake (REASON_MALFORMED), never a
        # session-build crash after acceptance
        from sartsolver_tpu_torch.operators.geometry import parse_geometry

        try:
            geometry = parse_geometry(geometry).to_dict()
        except SartInputError as err:
            raise RequestError(
                f"Request field 'geometry': {err}"
            ) from err
    return Request(
        id=req_id, tenant=tenant, time_range=time_range,
        deadline_s=deadline_s, submitted_unix=submitted, trace=trace_id,
        handoff=handoff, geometry=geometry,
    )
