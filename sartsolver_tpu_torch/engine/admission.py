"""Admission control: bounded queue, quotas, quarantine, degraded mode.

Counterpart of ``sartsolver_tpu/engine/admission.py``, host-only: it imports
neither torch nor JAX, and its records are the JAX engine's, field for field.

Policy lives here; the server owns the actual queue and calls in at the
three lifecycle points (``admit`` / ``note_dispatched`` /
``note_outcome``). Every rejection returns a machine-readable reason
from :mod:`sartsolver_tpu_torch.engine.request` — the engine never queues a
request to death and never answers "no" without saying why
(docs/SERVING.md §3).

Check order in :meth:`AdmissionController.admit` (most-specific verdict
first, so a rejected client learns the *actionable* reason):

1. ``draining`` — the engine is stopping (SIGTERM); resubmit elsewhere.
2. ``wrong-worker`` — fleet tenant affinity routes this tenant to a
   different worker (docs/SERVING.md §10); bypassed for requests the
   controller re-staged with the ``handoff`` flag.
3. ``duplicate-id`` — the id was already accepted or completed
   (idempotent replay: a resubmitted completed request is NOT re-run).
4. ``tenant-quarantined`` — this tenant's requests keep failing; the
   pool is protected until the cooldown passes.
5. ``degraded`` — load-shed mode (the OOM ladder engaged or the queue
   saturated); only :attr:`degraded_admit_below` headroom is served.
6. ``queue-full`` — the bounded queue is at capacity (backpressure).
7. ``tenant-quota`` — the tenant's in-queue share is at its cap.

Quarantine: :attr:`quarantine_after` *consecutive* terminal failures
(REQ_FAILED / REQ_PARTIAL — frames hitting FAILED/SDC/DIVERGED) rate-
limits the tenant for :attr:`quarantine_cooldown` seconds. Deadline
sheds deliberately do NOT count: a missed deadline is the pool's
congestion, not the tenant's data. One completed request resets the
streak.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from sartsolver_tpu_torch.engine import request as reqmod
from sartsolver_tpu_torch.engine.routing import tenant_worker
from sartsolver_tpu_torch.obs import metrics as obs_metrics


class _TenantState:
    __slots__ = ("queued", "failures", "quarantined_until")

    def __init__(self) -> None:
        self.queued = 0
        self.failures = 0  # consecutive terminal failures
        self.quarantined_until = 0.0  # monotonic; 0 = not quarantined


class AdmissionController:
    """Admission policy + per-tenant bookkeeping.

    Not internally locked: the server serializes every mutating call
    (``admit`` / ``note_dispatched`` / ``note_outcome`` /
    ``set_degraded``) under its engine lock — the socket thread admits
    concurrently with the serve loop's dispatch/outcome accounting, and
    an unserialized ``queue_depth`` read-modify-write would either
    wedge the bounded queue at "full" or silently disable
    backpressure. Read-only views (``tenant_view``,
    ``quarantined_tenants``, the status provider's field reads) are
    GIL-atomic-stale by design."""

    def __init__(
        self,
        *,
        max_queue: int = 16,
        max_per_tenant: int = 0,  # 0 = no per-tenant cap
        quarantine_after: int = 3,
        quarantine_cooldown: float = 60.0,
        on_event: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        affinity: Optional[tuple] = None,  # (worker_index, fleet_size)
    ):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1.")
        if quarantine_after < 1:
            raise ValueError("quarantine_after must be >= 1.")
        if affinity is not None:
            index, size = int(affinity[0]), int(affinity[1])
            if size < 1 or not 0 <= index < size:
                raise ValueError(
                    f"affinity index {index} out of range for fleet "
                    f"size {size}.")
            affinity = (index, size)
        # fleet tenant affinity (docs/SERVING.md §10): with (k, M) set,
        # tenants whose affinity hash routes elsewhere are rejected
        # REASON_WRONG_WORKER (retryable) unless the request carries
        # the controller's handoff flag
        self.affinity = affinity
        self.max_queue = int(max_queue)
        self.max_per_tenant = int(max_per_tenant)
        self.quarantine_after = int(quarantine_after)
        self.quarantine_cooldown = float(quarantine_cooldown)
        self._on_event = on_event
        self._clock = clock
        self._tenants: Dict[str, _TenantState] = {}
        self.queue_depth = 0  # accepted-not-yet-dispatched
        self.degraded_reason: Optional[str] = None
        # with degraded mode on, admit only while the queue is below
        # this fraction of capacity (shed the rest): serve *some* work
        # at reduced pressure instead of hard-failing everything
        self.degraded_admit_below = 0.5
        # ids ever accepted or completed this engine lifetime (duplicate
        # rejection = the idempotency half of exactly-once). Insertion-
        # ordered so the checkpoint can export the newest N (below)
        # instead of re-serializing an ever-growing set per save.
        self._seen_ids: Dict[str, None] = {}
        registry = obs_metrics.get_registry()
        self._admitted_ctr = registry.counter("engine_admitted_total")
        self._shed_ctrs = {
            reason: registry.counter("engine_shed_total", reason=reason)
            for reason in reqmod.SHED_REASONS
        }
        self._quarantine_ctr = registry.counter(
            "engine_quarantines_total"
        )
        self._depth_gauge = registry.gauge("engine_queue_depth")
        self._quarantined_gauge = registry.gauge(
            "engine_tenants_quarantined"
        )

    # ---- helpers ---------------------------------------------------------

    def _tenant(self, name: str) -> _TenantState:
        state = self._tenants.get(name)
        if state is None:
            state = self._tenants[name] = _TenantState()
        return state

    def _event(self, message: str) -> None:
        if self._on_event is not None:
            self._on_event(message)

    def note_seen(self, request_id: str) -> None:
        """Record an id as taken (journal replay seeds completed and
        pending ids here so restarts keep rejecting duplicates)."""
        self._seen_ids[str(request_id)] = None

    def shed(self, reason: str) -> None:
        """Count one shed verdict (the server calls this for rejections
        decided outside :meth:`admit` too — e.g. malformed payloads)."""
        ctr = self._shed_ctrs.get(reason)
        if ctr is None:  # defensive: unknown reasons still count
            ctr = obs_metrics.get_registry().counter(
                "engine_shed_total", reason=reason
            )
        ctr.inc()

    def quarantined_tenants(self) -> list:
        now = self._clock()
        return sorted(
            name for name, st in self._tenants.items()
            if st.quarantined_until > now
        )

    def set_degraded(self, reason: Optional[str]) -> None:
        """Enter (reason string) or leave (None) degraded load-shed
        mode; the reason is surfaced verbatim in rejections."""
        if reason != self.degraded_reason:
            self._event(
                f"engine degraded mode {'on: ' + reason if reason else 'off'}"
            )
        self.degraded_reason = reason

    # ---- lifecycle -------------------------------------------------------

    def admit(self, request: reqmod.Request, *,
              draining: bool = False) -> Optional[str]:
        """Admission verdict: None = admitted (queue depth taken), else
        the machine-readable rejection reason."""
        if draining:
            self.shed(reqmod.REASON_DRAINING)
            return reqmod.REASON_DRAINING
        if self.affinity is not None and not request.handoff:
            index, size = self.affinity
            if tenant_worker(request.tenant, size) != index:
                self.shed(reqmod.REASON_WRONG_WORKER)
                return reqmod.REASON_WRONG_WORKER
        if request.id in self._seen_ids:
            self.shed(reqmod.REASON_DUPLICATE)
            return reqmod.REASON_DUPLICATE
        tenant = self._tenant(request.tenant)
        if tenant.quarantined_until > self._clock():
            self.shed(reqmod.REASON_TENANT_QUARANTINED)
            return reqmod.REASON_TENANT_QUARANTINED
        if (self.degraded_reason is not None
                and self.queue_depth
                >= max(1, int(self.max_queue * self.degraded_admit_below))):
            self.shed(reqmod.REASON_DEGRADED)
            return reqmod.REASON_DEGRADED
        if self.queue_depth >= self.max_queue:
            self.shed(reqmod.REASON_QUEUE_FULL)
            return reqmod.REASON_QUEUE_FULL
        if self.max_per_tenant and tenant.queued >= self.max_per_tenant:
            self.shed(reqmod.REASON_TENANT_QUOTA)
            return reqmod.REASON_TENANT_QUOTA
        self._seen_ids[request.id] = None
        tenant.queued += 1
        self.queue_depth += 1
        self._admitted_ctr.inc()
        self._depth_gauge.set(float(self.queue_depth))
        return None

    def note_dispatched(self, request: reqmod.Request) -> None:
        """The request left the queue for the solver."""
        tenant = self._tenant(request.tenant)
        tenant.queued = max(0, tenant.queued - 1)
        self.queue_depth = max(0, self.queue_depth - 1)
        self._depth_gauge.set(float(self.queue_depth))

    def note_outcome(self, request: reqmod.Request, outcome: str) -> None:
        """Terminal accounting: completed resets the tenant's failure
        streak; failed/partial extends it and may quarantine."""
        tenant = self._tenant(request.tenant)
        if outcome in (reqmod.REQ_FAILED, reqmod.REQ_PARTIAL):
            tenant.failures += 1
            if tenant.failures >= self.quarantine_after:
                tenant.quarantined_until = (
                    self._clock() + self.quarantine_cooldown
                )
                tenant.failures = 0
                self._quarantine_ctr.inc()
                self._quarantined_gauge.set(
                    float(len(self.quarantined_tenants()))
                )
                self._event(
                    f"tenant {request.tenant!r} quarantined for "
                    f"{self.quarantine_cooldown:g}s after "
                    f"{self.quarantine_after} consecutive failing "
                    "request(s); other tenants unaffected "
                    f"(tripping request {request.id!r}, "
                    f"trace={request.trace})"
                )
        elif outcome == reqmod.REQ_COMPLETED:
            tenant.failures = 0
        # deadline sheds leave the streak untouched (module docstring)
        self._quarantined_gauge.set(
            float(len(self.quarantined_tenants()))
        )

    # ---- durable state (engine/state.py; docs/SERVING.md §9) -------------

    def quarantine_left_s(self, tenant: str) -> float:
        """Remaining quarantine cooldown for ``tenant`` (0 when clear) —
        the `retry_after_s` hint for tenant-quarantined rejections."""
        state = self._tenants.get(tenant)
        if state is None:
            return 0.0
        return max(0.0, state.quarantined_until - self._clock())

    def export_state(self) -> dict:
        """Checkpoint payload: tenant streaks/cooldowns, the dedup
        watermark, degraded reason. Quarantine deadlines are exported as
        *wall-clock* epochs so the downtime between a crash and the
        restart counts against the cooldown (the monotonic clock does
        not survive the process).

        The watermark is bounded to the NEWEST ``SART_STATE_SEEN_CAP``
        ids (default 100000): the checkpoint writes at every outcome
        boundary, and re-serializing an unbounded lifetime id set would
        make each save — and total checkpoint I/O — grow with traffic.
        Post-compaction dedup is therefore guaranteed for the most
        recent cap-many ids; older ones stay covered by the journal
        until it compacts (docs/SERVING.md §9)."""
        import os as _os

        try:
            cap = max(int(_os.environ.get("SART_STATE_SEEN_CAP",
                                          "100000")), 1)
        except ValueError:
            cap = 100000
        now_mono = self._clock()
        now_unix = time.time()
        tenants = {}
        for name, st in self._tenants.items():
            left = st.quarantined_until - now_mono
            rec = {"failures": int(st.failures),
                   "quarantined_unix": (round(now_unix + left, 3)
                                        if left > 0 else 0.0)}
            if rec["failures"] or rec["quarantined_unix"]:
                tenants[name] = rec
        return {
            "tenants": tenants,
            "seen_ids": list(self._seen_ids)[-cap:],
            "degraded_reason": self.degraded_reason,
        }

    def restore_state(self, state: dict) -> None:
        """Fold a checkpoint back in (restart path): a tenant
        quarantined when the process died stays quarantined for
        whatever cooldown its wall-clock deadline still holds."""
        now_mono = self._clock()
        # deliberate wall-clock: quarantine deadlines are checkpointed
        # as unix stamps exactly so the REMAINING cooldown carries
        # across restarts — the nondeterminism is the design
        now_unix = time.time()  # sart-lint: disable=SL204
        for name, rec in (state.get("tenants") or {}).items():
            st = self._tenant(str(name))
            st.failures = max(st.failures, int(rec.get("failures", 0)))
            q_unix = float(rec.get("quarantined_unix", 0.0) or 0.0)
            left = q_unix - now_unix
            if left > 0:
                st.quarantined_until = max(st.quarantined_until,
                                           now_mono + left)
        for rid in state.get("seen_ids") or ():
            self._seen_ids[str(rid)] = None
        reason = state.get("degraded_reason")
        if reason and self.degraded_reason is None:
            self.set_degraded(str(reason))
        self._quarantined_gauge.set(
            float(len(self.quarantined_tenants()))
        )

    # ---- introspection ---------------------------------------------------

    def tenant_view(self) -> Dict[str, dict]:
        """Per-tenant occupancy for the status snapshot / heartbeat."""
        now = self._clock()
        return {
            name: {
                "queued": st.queued,
                "failures": st.failures,
                "quarantined_s": (
                    round(st.quarantined_until - now, 1)
                    if st.quarantined_until > now else 0
                ),
            }
            for name, st in sorted(self._tenants.items())
        }
