"""The engine's durable-effect protocol, declared once (docs/SERVING.md).

Counterpart of ``sartsolver_tpu/engine/protocol.py``, host-only: it imports
neither torch nor JAX, and its records are the JAX engine's, field for field.

The exactly-once contract is carried by a small set of *effect points*
— the durable writes/deletes the serve loop performs, in a fixed commit
order. Until now that order lived implicitly in ``EngineServer``'s
method bodies and was proven only by seeded chaos sampling; this module
declares it as data so that

- the crash-point model checker (``analysis/protocol.py``) can enumerate a
  crash at EVERY effect prefix (and every byte boundary of every
  append) and assert the chaos invariants over all of them, and
- docs/SERVING.md's runbook can point a checker failure at the
  ``sartsolve chaos`` kill window that samples the same point.

The replay-side decision logic that the checker must drive UNCHANGED
against its crash states also lives here (:func:`needs_republish`,
:func:`uncounted_completed`): both are imported by ``EngineServer`` for
the real serve path and by the checker for the simulated one, so a
regression in either is caught by the same code object. An earlier
replay bug — republish gated on a *missing* response only, while the real kill
leaves the stale ``pending`` acceptance response behind — lived exactly
here, which is why the gate is now a named function with a model
checker aimed at it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EffectPoint:
    """One durable effect the engine performs.

    ``op`` is the durability primitive (``append`` via
    atomicio.append_line, ``publish`` via atomicio.write_atomic,
    ``delete`` via unlink); ``family`` names the durable file it
    touches; ``chaos_window`` is the ``sartsolve chaos`` kill window
    that samples this point dynamically (None = only the model checker
    reaches it deterministically)."""

    name: str
    component: str
    op: str  # "append" | "publish" | "delete"
    family: str  # "journal" | "state" | "response" | "ingest" | ...
    chaos_window: Optional[str]
    description: str


PROTOCOL: Tuple[EffectPoint, ...] = (
    EffectPoint(
        "journal.accepted", "engine/journal.py", "append", "journal",
        "accepted",
        "acceptance marker (request payload rides along) — fsync'd "
        "before the engine acts on the request",
    ),
    EffectPoint(
        "response.accepted", "engine/server.py", "publish", "response",
        None,
        "acceptance (pending) response publish — written only AFTER "
        "the accepted marker is durable (never promise unjournaled "
        "work)",
    ),
    EffectPoint(
        "ingest.consume", "engine/server.py", "delete", "ingest",
        None,
        "ingest-file unlink after the acceptance response — a crash "
        "before it re-scans the file, which the dedup watermark "
        "resolves as a duplicate",
    ),
    EffectPoint(
        "state.checkpoint", "engine/state.py", "append", "state",
        "ckpt",
        "soft-state checkpoint append (quarantine/ladder/SLO/dedup + "
        "counted-outcome watermark), CRC-framed; torn tail restores "
        "the previous record",
    ),
    EffectPoint(
        "journal.dispatched", "engine/journal.py", "append", "journal",
        "dispatched",
        "dispatch marker — durable before the solve starts",
    ),
    EffectPoint(
        "journal.completed", "engine/journal.py", "append", "journal",
        "pre-flush",
        "completion marker with the outcome record — the exactly-once "
        "commit point: once durable the request is never re-run",
    ),
    EffectPoint(
        "response.done", "engine/server.py", "publish", "response",
        "response",
        "completion response publish — AFTER the post-completion "
        "checkpoint, so a kill inside the response window loses "
        "neither the outcome counters nor the response (replay "
        "republishes from the journaled outcome)",
    ),
    EffectPoint(
        "journal.compact", "engine/journal.py", "publish", "journal",
        None,
        "completed-id compaction rewrite (atomic rename) — only after "
        "a checkpoint made the dedup watermark durable",
    ),
    EffectPoint(
        "state.compact", "engine/state.py", "publish", "state",
        None,
        "last-valid-record rewrite (atomic rename)",
    ),
    EffectPoint(
        "retention.delete", "engine/server.py", "delete", "response",
        None,
        "TTL retention unlink — replay's age gate keeps swept "
        "responses from resurrecting",
    ),
    EffectPoint(
        "trace.publish", "engine/server.py", "publish", "trace",
        None,
        "per-request Perfetto trace publish (best-effort, not part of "
        "the exactly-once contract)",
    ),
    EffectPoint(
        "supervisor.event", "resilience/supervisor.py", "append",
        "supervisor", None,
        "supervisor event append — the record of the crash must "
        "survive the crash (flush+fsync like the journal)",
    ),
    EffectPoint(
        "journal.session", "engine/session.py", "append", "journal",
        None,
        "session-cache attach/evict audit record riding the journal's "
        "durability — replay skips it (no request lifecycle), "
        "compaction drops it",
    ),
    # ---- fleet failover effects (docs/SERVING.md §10) ---------------------
    EffectPoint(
        "journal.handoff", "resilience/supervisor.py", "append",
        "journal", "handoff",
        "handoff marker appended to the DEAD worker's journal BEFORE "
        "the payload is re-staged on a survivor — the marker is what "
        "keeps a later restart of the dead worker from re-driving the "
        "same request (exactly one driver per id)",
    ),
    EffectPoint(
        "ingest.stage", "resilience/supervisor.py", "publish", "ingest",
        None,
        "failover re-stage: the handed-off payload published "
        "atomically into the survivor's ingest dir (handoff flag set "
        "so affinity admits it); a crash before it leaves the handoff "
        "marker, which controller recovery resolves by re-staging",
    ),
    EffectPoint(
        "routing.publish", "resilience/supervisor.py", "publish",
        "routing", None,
        "fleet routing-table publish (atomic rename, fsync'd) — "
        "clients re-read it every retry attempt, so a torn table "
        "would strand every retrying client at once",
    ),
    EffectPoint(
        "fleet.event", "resilience/supervisor.py", "append", "fleet",
        None,
        "controller event append (worker death, handoff, routing "
        "change) — same durability as supervisor events",
    ),
)

# The per-request commit order the clean effect trace must honor (a
# subsequence check: checkpoints/compactions interleave freely between
# these anchors). This IS the ordering contract SL203 lints statically.
REQUEST_COMMIT_ORDER: Tuple[str, ...] = (
    "journal.accepted", "response.accepted", "journal.dispatched",
    "journal.completed", "response.done",
)


def effect(name: str) -> EffectPoint:
    for ep in PROTOCOL:
        if ep.name == name:
            return ep
    raise KeyError(f"unknown effect point {name!r}")


# ---------------------------------------------------------------------------
# replay-side decision logic (shared by EngineServer and the checker)
# ---------------------------------------------------------------------------


def needs_republish(outcome: Optional[dict], prev_response: Optional[dict],
                    *, response_ttl_s: float,
                    now: Optional[float] = None) -> bool:
    """Whether replay must republish a completed id's response.

    True when the completion is younger than the retention TTL AND the
    response on disk is missing OR still shows a pre-completion state
    (the kill landed after the ``completed`` marker fsync'd but before
    the done response replaced the pending one). Gating on *missing
    only* was an earlier replay bug — the real kill leaves the stale
    ``pending`` acceptance response behind — and the crash-point model
    checker (the JAX package's ``analysis/protocol.py``) pins this function against every
    crash prefix so the regression cannot come back quietly.

    The age gate is deliberately wall-clock: a response swept by the
    retention TTL on purpose must not come back with a fresh mtime (and
    another full TTL) on restart. A record without the ``journal_unix``
    stamp (legacy journal) counts fresh — better one resurrected
    response than a lost one.
    """
    if not outcome:
        return False
    if now is None:
        now = time.time()
    done_unix = float(outcome.get("journal_unix") or now)
    fresh = (not response_ttl_s) or (now - done_unix < response_ttl_s)
    return bool(fresh and (prev_response is None
                           or prev_response.get("state") != "done"))


def uncounted_completed(
    completed: Dict[str, dict], counted_ids: Iterable[str]
) -> List[Tuple[str, dict]]:
    """Completed journal entries whose outcome counters never reached a
    durable checkpoint (journal order preserved).

    The counters' only durability is the state checkpoint, and the
    checkpoint lands AFTER the ``completed`` marker — so a kill between
    the two loses the increment with nothing to rebuild it from: the
    restart restores the previous checkpoint and replay used to
    republish the response WITHOUT re-counting. The model checker found
    that window on its first exhaustive pass (the seeded chaos
    campaign's ``ckpt`` kills had simply never landed on a post-
    completion save). The fix: checkpoints carry a ``counted_ids``
    watermark, and replay re-counts exactly the journal-completed ids
    the restored watermark does not cover. Idempotent across repeated
    restarts: the recount is derived state, re-derivable until a later
    checkpoint absorbs it.
    """
    counted = set(str(rid) for rid in counted_ids)
    return [(rid, outcome) for rid, outcome in completed.items()
            if rid not in counted]


def needs_restage(*, completed_anywhere: bool, pending_on_target: bool,
                  staged_on_target: bool) -> bool:
    """Whether controller recovery must re-stage a handed-off id.

    A handoff marker on a dead worker's journal promises the request to
    a survivor, but the crash may have landed between the marker and
    the re-stage publish. Recovery re-stages exactly when no other copy
    of the story exists: the id is not completed anywhere in the fleet,
    not pending in the survivor's journal, and not already staged in
    the survivor's ingest. Any one of those means a driver exists and a
    re-stage would risk a duplicate (the dedup watermark would catch
    it, but the invariant is cheaper to hold than to repair)."""
    return not (completed_anywhere or pending_on_target
                or staged_on_target)


__all__ = [
    "EffectPoint", "PROTOCOL", "REQUEST_COMMIT_ORDER", "effect",
    "needs_republish", "uncounted_completed", "needs_restage",
]
