"""Deterministic crash-point model checker for the exactly-once protocol.

Counterpart of ``sartsolver_tpu/analysis/protocol.py``, driving the port's
own engine. The seeded chaos campaign (``chaos``) proves the serve loop's
crash contract by *sampling*: SIGKILLs inside a handful of announced
windows of the real process. This module proves the same invariants
*exhaustively* over the durable-effect protocol declared in
``engine/protocol.py``: it drives the REAL journal/state/response logic
(``RequestJournal``, ``StateStore``, the atomicio publish primitives, and
the shared replay gates ``needs_republish``/``uncounted_completed``)
through a scripted serving workload, then simulates a crash

- after every durable-effect *prefix* (effect k lands, effect k+1 never
  starts), and
- at every *byte boundary* of every append effect (the torn-final-line
  states a ``kill -9`` mid-``write(2)`` can leave),

and for each of the resulting crash states runs the real recovery path
(orphan sweep, checkpoint restore, journal replay, response republish,
outcome recount, ingest rescan, pending re-drive) and asserts the chaos
invariants over the outcome. The crash state is never hand-built: the
workload runs against a real scratch directory through a filesystem shim
(installed via :func:`atomicio.use_fs`) that executes effects for real
until the planned crash point, so the directory *is* the post-crash disk
image.

What a scenario asserts (the chaos judge's invariants, plus the
publish-atomicity contract the sampled campaign cannot see):

- exactly-once: an id whose ``completed`` marker was durable at the
  crash is never re-driven; no id is ever solved more than twice
  (once per incarnation);
- no lost outcome: every request ends with a parseable ``done``
  response carrying the deterministic expected outcome;
- no stale pending response survives recovery;
- counter continuity: the final checkpoint's outcome counters and SLO
  tallies exactly cover every request ever served, across the crash
  (the ``counted_ids`` watermark + recount path);
- no ``*.tmp`` publish debris survives the startup sweep; a response
  swept by the retention TTL stays swept (no resurrection);
- fleet failover: a request handed off a dead worker's journal completes
  exactly once fleet-wide, whatever prefix of the handoff protocol
  (handoff marker, routing publish, fleet event, ingest re-stage,
  survivor lifecycle) the crash cut short, and the outcome counters stay
  continuous when summed across every worker's checkpoint;
- published (renamed) files are never torn: only possible when a publish
  site drops ``fsync=True``, so the shim models the ``fsync=False``
  failure mode and the checker catches it if the knob regresses;
- the supervisor event log has at most one torn line, and it is the
  last.

Run via ``python -m sartsolver_tpu_torch.cli lint --protocol``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Set, Tuple

from sartsolver_tpu_torch.engine import protocol as engine_protocol
from sartsolver_tpu_torch.engine import routing as fleet_routing
from sartsolver_tpu_torch.engine.journal import RequestJournal
from sartsolver_tpu_torch.engine.request import Request
from sartsolver_tpu_torch.engine.state import StateStore
from sartsolver_tpu_torch.utils import atomicio

# ---------------------------------------------------------------------------
# workload constants (all deterministic — a scenario's expected end
# state is a pure function of the request ids)
# ---------------------------------------------------------------------------

REQUEST_IDS: Tuple[str, ...] = ("req-a", "req-b", "req-c")
OLD_ID = "old-0"                # completed long ago; past the TTL
ANCIENT_UNIX = 1000.0           # its journal stamp (epoch dawn)
SLO_MS = 600.0
RESPONSE_TTL_S = 3600.0
# The failover epilogue's request: accepted by worker 0, which then
# "dies"; the controller hands it off to worker 1 (docs/SERVING.md §10)
HANDOFF_ID = "req-d"
HANDOFF_TARGET = 1

# Re-break knob for the drills: flipping this to False re-introduces the
# missing-fsync response bug, and the shim's torn-rename sub-cases must
# make the checker fail on it.
RESPONSE_FSYNC = True


def expected_outcome(rid: str) -> dict:
    """The deterministic outcome of solving ``rid`` — identical on
    every incarnation, which is what makes re-drives observationally
    idempotent (the real engine's per-request solves are likewise
    deterministic given the resident RTM)."""
    h = sum(ord(c) for c in rid)
    return {
        "status": "completed" if h % 3 else "partial",
        "frames": 3 + h % 4,
        "latency_s": round(0.45 + (h % 5) * 0.1, 3),
        "tenant": f"t-{rid}",
    }


class SimulatedCrash(Exception):
    """Raised by the shim at the planned crash point.

    Deliberately NOT an ``OSError`` subclass: the journal/state append
    sites wrap their writes in ``retry_call(..., retry_on=(OSError,))``,
    and a retried "crash" would silently re-run the effect instead of
    stopping the world — the one thing a SIGKILL never does.
    """


@dataclasses.dataclass(frozen=True)
class CrashPlan:
    """Crash at effect ``effect_index`` (0-based; effects before it
    land fully). ``sub`` refines the failure mode: for appends, the
    number of bytes that hit disk (0..n-1, the torn-line states); for
    publishes, None = tmp written but never renamed (the atomic-rename
    contract), an int = renamed but only a prefix durable (only
    reachable when the publish site skipped fsync); for deletes, the
    unlink simply never happens."""

    effect_index: int
    sub: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class EffectRecord:
    """One durable effect observed by the shim."""

    name: str            # engine/protocol.py effect-point name
    key: Optional[str]   # request id, when the effect is per-request
    op: str              # "append" | "publish" | "delete"
    nbytes: int
    fsync: bool


def _classify(op: str, path: str,
              data: Optional[str]) -> Tuple[str, Optional[str]]:
    """Map a concrete filesystem effect onto its protocol effect point
    (and the request id it serves, when per-request). Raises KeyError
    via :func:`engine_protocol.effect` when the engine grows a durable
    write the protocol table does not declare — which is the point."""
    base = os.path.basename(path)
    parent = os.path.basename(os.path.dirname(path))
    if base == "journal.jsonl":
        if op == "append":
            rec = json.loads(data or "{}")
            name = f"journal.{rec.get('marker')}"
            return engine_protocol.effect(name).name, rec.get("id")
        return engine_protocol.effect("journal.compact").name, None
    if base == "state.jsonl":
        name = "state.checkpoint" if op == "append" else "state.compact"
        return engine_protocol.effect(name).name, None
    if base == "supervisor.jsonl":
        return engine_protocol.effect("supervisor.event").name, None
    if base == "fleet.jsonl":
        return engine_protocol.effect("fleet.event").name, None
    if base == fleet_routing.ROUTING_BASENAME:
        return engine_protocol.effect("routing.publish").name, None
    stem = base[:-len(".json")] if base.endswith(".json") else base
    if parent == "responses":
        if op == "delete":
            return engine_protocol.effect("retention.delete").name, stem
        state = json.loads(data or "{}").get("state")
        name = "response.done" if state == "done" else "response.accepted"
        return engine_protocol.effect(name).name, stem
    if parent == "ingest":
        # delete = the worker consuming an admitted file; publish = the
        # controller re-staging a handed-off payload on a survivor
        name = "ingest.stage" if op == "publish" else "ingest.consume"
        return engine_protocol.effect(name).name, stem
    if parent == "traces":
        name = engine_protocol.effect("trace.publish").name
        return name, stem[:-len(".trace")] if stem.endswith(".trace") \
            else stem
    raise KeyError(f"durable effect on undeclared path {path!r}")


class ShimFS:
    """atomicio backend that executes effects for real until the
    planned crash point, then applies the crash's partial effect and
    raises :class:`SimulatedCrash`. With ``plan=None`` it is a pure
    write-through tracer (the dry run that discovers the effect
    schedule)."""

    def __init__(self, plan: Optional[CrashPlan] = None):
        self.plan = plan
        self.count = 0
        self.log: List[EffectRecord] = []
        self._real = atomicio._RealFS()

    def _arm(self, name: str, key: Optional[str], op: str,
             nbytes: int, fsync: bool) -> bool:
        idx = self.count
        self.count += 1
        self.log.append(EffectRecord(name, key, op, nbytes, fsync))
        return self.plan is not None and idx == self.plan.effect_index

    def append(self, path: str, data: str, *, fsync: bool = True) -> None:
        name, key = _classify("append", path, data)
        if self._arm(name, key, "append", len(data), fsync):
            b = self.plan.sub or 0
            if b > 0:
                # the torn final line: only a prefix of the record's
                # bytes reached the platter before the power went
                self._real.append(path, data[:b], fsync=True)
            raise SimulatedCrash(f"{name} torn at {b}B")
        self._real.append(path, data, fsync=fsync)

    def write_atomic(self, path: str, data: str, *,
                     fsync: bool = True) -> None:
        name, key = _classify("publish", path, data)
        if self._arm(name, key, "publish", len(data), fsync):
            if self.plan.sub is None:
                # died between the tmp write and the rename: debris
                # only, never published — what fsync=True guarantees
                with open(f"{path}.{os.getpid()}.tmp", "w") as f:
                    f.write(data)
                raise SimulatedCrash(f"{name} tmp debris")
            # fsync was skipped and the crash straddled the rename:
            # the file IS published, torn — the failure mode the
            # explicit fsync= knob exists to rule out
            with open(path, "w") as f:
                f.write(data[:self.plan.sub])
            raise SimulatedCrash(f"{name} torn rename")
        self._real.write_atomic(path, data, fsync=fsync)

    def remove(self, path: str) -> None:
        name, key = _classify("delete", path, None)
        if self._arm(name, key, "delete", 0, True):
            raise SimulatedCrash(f"{name} skipped")
        self._real.remove(path)


# ---------------------------------------------------------------------------
# the scripted workload + the real recovery path
# ---------------------------------------------------------------------------


class _Worker:
    """One worker's durable world inside the simulated fleet: its own
    journal shard, state checkpoint and ingest dir (responses/outputs
    are fleet-shared, held by the driver)."""

    def __init__(self, engine_dir: str, ingest_dir: str):
        self.engine_dir = engine_dir
        self.ingest_dir = ingest_dir
        os.makedirs(engine_dir, exist_ok=True)
        os.makedirs(ingest_dir, exist_ok=True)
        self.journal_path = os.path.join(engine_dir, "journal.jsonl")
        self.state_path = os.path.join(engine_dir, "state.jsonl")
        self.journal = RequestJournal(self.journal_path)
        self.state = StateStore(self.state_path)
        self.counters: Dict[str, int] = {}
        self.slo = {"ok": 0, "breach": 0}
        self.counted: Dict[str, None] = {}
        self.seen: Dict[str, None] = {}

    def reopen(self) -> None:
        self.journal = RequestJournal(self.journal_path)
        self.state = StateStore(self.state_path)


class ProtocolDriver:
    """One serving workload over the real journal/state/response code.

    The armed run mirrors ``EngineServer``'s effect order per request
    (journal accepted -> pending response -> ingest consume ->
    checkpoint -> dispatched -> solve -> completed -> count ->
    checkpoint -> done response), plus a retention delete of a long-
    completed id, a mid-run checkpoint+compact rotation, and the fleet
    failover epilogue: worker 0 accepts :data:`HANDOFF_ID` and dies,
    the controller appends the handoff marker to the dead journal,
    republishes the routing table, logs the fleet event and re-stages
    the payload on worker 1, which drives it to completion.
    :meth:`recover` is the restart: the same sweep/restore/replay/
    republish/recount/rescan/re-drive sequence ``EngineServer.run``
    performs on every worker, built from the same shared gates, plus
    the controller's handoff-resolution pass
    (:func:`engine_protocol.needs_restage`).
    """

    def __init__(self, root: str):
        self.root = root
        self.engine_dir = os.path.join(root, "engine")
        self.ingest_dir = os.path.join(root, "ingest")
        self.responses_dir = os.path.join(self.engine_dir, "responses")
        self.traces_dir = os.path.join(self.engine_dir, "traces")
        self.worker_b_dir = os.path.join(root, "workers", "w1")
        self.b_ingest_dir = os.path.join(self.worker_b_dir, "ingest")
        for d in (self.responses_dir, self.traces_dir):
            os.makedirs(d, exist_ok=True)
        self.supervisor_path = os.path.join(self.engine_dir,
                                            "supervisor.jsonl")
        self.fleet_path = os.path.join(root, "fleet.jsonl")
        self.w = [_Worker(self.engine_dir, self.ingest_dir),
                  _Worker(self.worker_b_dir, self.b_ingest_dir)]
        # worker 0 aliases (the single-worker story most scenarios crash
        # inside)
        self.journal_path = self.w[0].journal_path
        self.state_path = self.w[0].state_path
        self.solves: Dict[str, int] = {}
        self.republished: Set[str] = set()

    def _publish_routing(self) -> None:
        fleet_routing.publish_routing(
            self.root,
            [{"index": i, "ingest_dir": w.ingest_dir, "http_port": None,
              "state": "up" if i != 0 else "down"}
             for i, w in enumerate(self.w)],
            responses_dir=self.responses_dir,
            ingest_dir=self.ingest_dir)

    # ---- setup (unarmed: the pre-existing world) ------------------------

    def setup(self) -> None:
        for rid in REQUEST_IDS + (HANDOFF_ID,):
            with open(os.path.join(self.ingest_dir, f"{rid}.json"),
                      "w") as f:
                json.dump({"id": rid, "tenant": f"t-{rid}",
                           "trace": f"tr-{rid}"}, f)
        # OLD_ID completed in a previous epoch: journal records with an
        # ancient stamp (so the replay age gate sees it as past the
        # TTL) and a done response awaiting retention
        old = Request(id=OLD_ID, tenant=f"t-{OLD_ID}",
                      trace=f"tr-{OLD_ID}")
        outcome = expected_outcome(OLD_ID)
        with open(self.journal_path, "a") as f:
            f.write(json.dumps({
                "marker": "accepted", "id": OLD_ID,
                "unix": ANCIENT_UNIX, "trace": old.trace,
                "request": old.to_dict()}) + "\n")
            f.write(json.dumps({
                "marker": "completed", "id": OLD_ID,
                "unix": ANCIENT_UNIX, "trace": old.trace,
                "outcome": outcome}) + "\n")
        with open(os.path.join(self.responses_dir, f"{OLD_ID}.json"),
                  "w") as f:
            json.dump({"id": OLD_ID, "verdict": "accepted",
                       "state": "done", "outcome": outcome}, f)
        w = self.w[0]
        w.seen[OLD_ID] = None
        self._count(w, OLD_ID, outcome)
        w.state.save(self._state_payload(w))

    # ---- the armed run (the incarnation that dies) ----------------------

    def run_armed(self) -> None:
        a, b = self.w
        atomicio.append_line(
            self.supervisor_path,
            json.dumps({"kind": "worker-start", "pid": 1}) + "\n")
        self._lifecycle(a, REQUEST_IDS[0])
        # session-cache audit record (engine/session.py): attach/evict
        # events ride the journal's durability; replay must skip them
        a.journal.session_event("session-attach", "default", bytes=4096)
        atomicio.current_fs().remove(
            os.path.join(self.responses_dir, f"{OLD_ID}.json"))
        self._lifecycle(a, REQUEST_IDS[1])
        # rotation: checkpoint FIRST (the dedup/counted watermark must
        # be durable before compaction drops the completed records)
        self._checkpoint(a)
        a.journal.compact()
        a.state.compact()
        self._lifecycle(a, REQUEST_IDS[2])
        atomicio.write_json_atomic(
            os.path.join(self.traces_dir,
                         f"{REQUEST_IDS[2]}.trace.json"),
            {"id": REQUEST_IDS[2], "spans": []}, fsync=True)
        # ---- failover epilogue (docs/SERVING.md §10) --------------------
        # worker 0 accepts HANDOFF_ID ... and dies before dispatching it
        rid = HANDOFF_ID
        req = Request(id=rid, tenant=f"t-{rid}", trace=f"tr-{rid}")
        a.journal.accepted(req)
        a.seen[rid] = None
        self._respond(rid, {"id": rid, "verdict": "accepted",
                            "state": "pending", "trace": req.trace})
        atomicio.current_fs().remove(
            os.path.join(a.ingest_dir, f"{rid}.json"))
        self._checkpoint(a)
        # the controller takes over: handoff marker on the DEAD journal
        # FIRST (the re-stage file existing implies the marker is
        # durable, so worker 0's restart can never become a second
        # driver), then the routing/event/re-stage publishes
        a.journal.handoff(rid, HANDOFF_TARGET, trace_id=req.trace)
        self._publish_routing()
        atomicio.append_line(
            self.fleet_path,
            json.dumps({"kind": "worker-crash", "worker": 0,
                        "handoff": [rid],
                        "target": HANDOFF_TARGET}) + "\n")
        atomicio.write_json_atomic(
            os.path.join(b.ingest_dir, f"{rid}.json"),
            {"id": rid, "tenant": f"t-{rid}", "trace": f"tr-{rid}",
             "handoff": True}, fsync=True)
        # the survivor drives the handed-off request to completion
        self._lifecycle(b, rid, handoff=True)

    def _lifecycle(self, w: _Worker, rid: str,
                   handoff: bool = False) -> None:
        req = Request(id=rid, tenant=f"t-{rid}", trace=f"tr-{rid}",
                      handoff=handoff)
        w.journal.accepted(req)
        w.seen[rid] = None
        self._respond(rid, {"id": rid, "verdict": "accepted",
                            "state": "pending", "trace": req.trace})
        atomicio.current_fs().remove(
            os.path.join(w.ingest_dir, f"{rid}.json"))
        self._checkpoint(w)
        self._dispatch_and_complete(w, req)

    def _dispatch_and_complete(self, w: _Worker,
                               req: Request) -> None:
        w.journal.dispatched(req)
        outcome = self._solve(req.id)
        w.journal.completed(req, outcome)
        self._count(w, req.id, outcome)
        self._checkpoint(w)
        self._respond(req.id, {"id": req.id, "verdict": "accepted",
                               "state": "done", "trace": req.trace,
                               "outcome": outcome})

    def _solve(self, rid: str) -> dict:
        self.solves[rid] = self.solves.get(rid, 0) + 1
        return dict(expected_outcome(rid))

    def _count(self, w: _Worker, rid: str, outcome: dict) -> None:
        status = str(outcome.get("status") or "unknown")
        w.counters[status] = w.counters.get(status, 0) + 1
        if float(outcome.get("latency_s") or 0.0) * 1000.0 > SLO_MS:
            w.slo["breach"] += 1
        else:
            w.slo["ok"] += 1
        w.counted[rid] = None

    def _state_payload(self, w: _Worker) -> dict:
        return {"lanes": 2,
                "admission": {"seen_ids": list(w.seen)},
                "counted_ids": list(w.counted),
                "counters": dict(w.counters),
                "slo": dict(w.slo)}

    def _checkpoint(self, w: _Worker) -> None:
        w.state.save(self._state_payload(w))

    def _respond(self, rid: str, body: dict) -> None:
        atomicio.write_json_atomic(
            os.path.join(self.responses_dir, f"{rid}.json"), body,
            fsync=RESPONSE_FSYNC)

    def _read_response(self, rid: str) -> Optional[dict]:
        path = os.path.join(self.responses_dir, f"{rid}.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # ---- recovery (the restart incarnation; real code, real fs) ---------

    def recover(self) -> Tuple[Set[str], List[str]]:
        """Run the restart path against the crash state — every worker
        restarts, and the controller resolves interrupted handoffs
        before the survivor rescans its ingest. Returns
        ``(completed_at_crash, redriven_ids)`` for the invariant
        checks."""
        for w in self.w:
            w.reopen()
        for d in (self.engine_dir, self.responses_dir, self.traces_dir,
                  self.worker_b_dir, self.b_ingest_dir, self.root):
            atomicio.sweep_orphans(d)
        for w in self.w:
            restored = w.state.load() or {}
            w.counters = dict(restored.get("counters") or {})
            slo = restored.get("slo") or {}
            w.slo = {"ok": int(slo.get("ok") or 0),
                     "breach": int(slo.get("breach") or 0)}
            w.counted = {str(r): None
                         for r in restored.get("counted_ids") or []}
            w.seen = {str(r): None for r in
                      (restored.get("admission") or {}).get("seen_ids")
                      or []}
        completed0, pending0, handed_off = self.w[0].journal.replay_full()
        completed1, pending1, _ = self.w[1].journal.replay_full()
        completed_at_crash = set(completed0) | set(completed1)
        stories = [(self.w[0], completed0, pending0),
                   (self.w[1], completed1, pending1)]
        for w, completed, _pending in stories:
            for rid, outcome in completed.items():
                w.seen.setdefault(rid, None)
                prev = self._read_response(rid)
                if engine_protocol.needs_republish(
                        outcome, prev, response_ttl_s=RESPONSE_TTL_S):
                    self._respond(rid, {
                        "id": rid, "verdict": "accepted",
                        "state": "done",
                        "outcome": {k: v for k, v in outcome.items()
                                    if k != "journal_unix"},
                        "republished": True})
                    self.republished.add(rid)
            for rid, outcome in engine_protocol.uncounted_completed(
                    completed, w.counted):
                self._count(w, rid, outcome)
        # controller recovery: an interrupted handoff (marker durable,
        # re-stage not) is re-staged on the survivor BEFORE the
        # survivor's ingest rescan picks up new work
        pending1_ids = {req.id for req in pending1}
        for rid, story in handed_off.items():
            staged = os.path.exists(
                os.path.join(self.b_ingest_dir, f"{rid}.json"))
            if engine_protocol.needs_restage(
                    completed_anywhere=(rid in completed0
                                        or rid in completed1),
                    pending_on_target=rid in pending1_ids,
                    staged_on_target=staged):
                req = story.get("request")
                atomicio.write_json_atomic(
                    os.path.join(self.b_ingest_dir, f"{rid}.json"),
                    {"id": rid,
                     "tenant": req.tenant if req else f"t-{rid}",
                     "trace": req.trace if req else f"tr-{rid}",
                     "handoff": True}, fsync=True)
        # the controller always republishes the routing table at start
        self._publish_routing()
        redriven: List[str] = []
        for w, completed, pending in stories:
            # ingest rescan: files whose id the journal/watermark
            # already knows are duplicates of consumed work; unseen
            # files admit
            pending_ids = {req.id for req in pending}
            for name in sorted(os.listdir(w.ingest_dir)):
                if not name.endswith(".json"):
                    continue
                rid = name[:-len(".json")]
                path = os.path.join(w.ingest_dir, name)
                if (rid in completed or rid in pending_ids
                        or rid in w.seen):
                    os.unlink(path)
                    continue
                req = Request(id=rid, tenant=f"t-{rid}",
                              trace=f"tr-{rid}")
                w.journal.accepted(req)
                w.seen[rid] = None
                self._respond(rid, {"id": rid, "verdict": "accepted",
                                    "state": "pending",
                                    "trace": req.trace})
                os.unlink(path)
                pending.append(req)
                pending_ids.add(rid)
            for req in pending:
                w.journal.dispatched(req)
                outcome = self._solve(req.id)
                w.journal.completed(req, outcome)
                self._count(w, req.id, outcome)
                self._checkpoint(w)
                self._respond(req.id, {"id": req.id,
                                       "verdict": "accepted",
                                       "state": "done",
                                       "trace": req.trace,
                                       "outcome": outcome})
                redriven.append(req.id)
            self._checkpoint(w)
        return completed_at_crash, redriven

    # ---- invariants ------------------------------------------------------

    def pre_recovery_check(self) -> List[str]:
        """Published files must never be torn, even BEFORE recovery —
        a client can read a response at any instant. Only violable
        when a publish site skipped fsync (the shim's torn-rename
        sub-cases)."""
        out = []
        for name in sorted(os.listdir(self.responses_dir)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.responses_dir, name)) as f:
                    json.load(f)
            except ValueError:
                out.append(f"published response {name} is torn "
                           f"(atomic-publish contract broken — "
                           f"missing fsync at the publish site?)")
        return out

    def check(self, completed_at_crash: Set[str],
              redriven: List[str]) -> List[str]:
        out: List[str] = []
        # exactly-once
        for rid in redriven:
            if rid in completed_at_crash:
                out.append(f"{rid}: re-driven although its completed "
                           f"marker was durable at the crash")
        for rid, n in self.solves.items():
            if n > 2:
                out.append(f"{rid}: solved {n} times")
        for rid in completed_at_crash & set(REQUEST_IDS + (HANDOFF_ID,)):
            if self.solves.get(rid, 0) != 1:
                out.append(f"{rid}: completed at crash but solved "
                           f"{self.solves.get(rid, 0)} times")
        # exactly one driver per handed-off id: whatever prefix of the
        # handoff protocol landed, the request is solved at most twice
        # (once per incarnation) and never concurrently re-driven —
        # covered by the checks above; additionally it must END done
        # fleet-wide, which the response loop below asserts
        # no lost outcome
        for rid in REQUEST_IDS + (HANDOFF_ID,):
            body = self._read_response(rid)
            if body is None:
                out.append(f"{rid}: done response missing or torn")
                continue
            if body.get("state") != "done":
                out.append(f"{rid}: response stuck in state "
                           f"{body.get('state')!r} after recovery")
                continue
            got = body.get("outcome") or {}
            exp = expected_outcome(rid)
            if (got.get("status") != exp["status"]
                    or got.get("latency_s") != exp["latency_s"]):
                out.append(f"{rid}: outcome drifted across replay "
                           f"({got.get('status')!r} vs "
                           f"{exp['status']!r})")
        # no stale pending response anywhere
        for name in sorted(os.listdir(self.responses_dir)):
            if not name.endswith(".json"):
                continue
            body = self._read_response(name[:-len(".json")])
            if body is None or body.get("state") != "done":
                out.append(f"stale/torn response {name} survived "
                           f"recovery")
        # counter continuity across the crash, summed FLEET-WIDE: the
        # handed-off request counts on whichever worker completed it,
        # and the sum over every worker's final checkpoint must cover
        # every request exactly once
        got_counters: Dict[str, int] = {}
        got_slo = {"ok": 0, "breach": 0}
        for w in self.w:
            final = StateStore(w.state_path).load() or {}
            for k, v in (final.get("counters") or {}).items():
                got_counters[k] = got_counters.get(k, 0) + int(v)
            for k in got_slo:
                got_slo[k] += int((final.get("slo") or {}).get(k) or 0)
        ids = (OLD_ID,) + REQUEST_IDS + (HANDOFF_ID,)
        exp_counters: Dict[str, int] = {}
        exp_slo = {"ok": 0, "breach": 0}
        for rid in ids:
            o = expected_outcome(rid)
            exp_counters[o["status"]] = \
                exp_counters.get(o["status"], 0) + 1
            key = ("breach" if o["latency_s"] * 1000.0 > SLO_MS
                   else "ok")
            exp_slo[key] += 1
        if got_counters != exp_counters:
            out.append(f"outcome counters {got_counters} != "
                       f"{exp_counters} (lost or double count)")
        if got_slo != exp_slo:
            out.append(f"slo tallies {got_slo} != {exp_slo}")
        # publish debris must not survive the startup sweep
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                if name.endswith(".tmp"):
                    out.append(f"orphan tmp survived the sweep: "
                               f"{os.path.join(dirpath, name)}")
        # the TTL-swept id must stay swept
        if OLD_ID in self.republished:
            out.append(f"{OLD_ID}: TTL-expired response resurrected "
                       f"by replay")
        if OLD_ID in redriven:
            out.append(f"{OLD_ID}: long-completed request re-driven")
        # supervisor/fleet logs: at most one torn line, and it is the
        # last (appends are fsync'd in order)
        for label, path in (("supervisor.jsonl", self.supervisor_path),
                            ("fleet.jsonl", self.fleet_path)):
            if not os.path.exists(path):
                continue
            with open(path) as f:
                lines = [ln for ln in f.read().splitlines() if ln]
            for ln in lines[:-1]:
                try:
                    json.loads(ln)
                except ValueError:
                    out.append(f"{label} torn on a NON-final line "
                               f"(append not fsync'd in order)")
        return out


# ---------------------------------------------------------------------------
# scenario enumeration + report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProtocolReport:
    effect_points: int              # declared protocol table size
    effects_armed: int              # durable effects in the clean run
    scenarios_total: int            # crash states enumerated
    scenarios_by_effect: Dict[str, int]
    byte_stride: int
    commit_order_ok: bool
    violations: List[str]

    @property
    def ok(self) -> bool:
        return self.commit_order_ok and not self.violations


def _enumerate(trace: List[EffectRecord],
               byte_stride: int) -> List[Tuple[CrashPlan, str]]:
    stride = max(1, int(byte_stride))
    plans: List[Tuple[CrashPlan, str]] = []
    for k, rec in enumerate(trace):
        if rec.op == "append":
            for b in range(0, rec.nbytes, stride):
                plans.append((CrashPlan(k, b),
                              f"effect #{k} {rec.name} torn at {b}B"))
        elif rec.op == "publish":
            plans.append((CrashPlan(k, None),
                          f"effect #{k} {rec.name} tmp debris"))
            if not rec.fsync:
                for b in sorted({0, rec.nbytes // 2,
                                 max(rec.nbytes - 1, 0)}):
                    plans.append(
                        (CrashPlan(k, b),
                         f"effect #{k} {rec.name} torn rename "
                         f"at {b}B"))
        else:
            plans.append((CrashPlan(k, None),
                          f"effect #{k} {rec.name} never happened"))
    return plans


def _commit_order(trace: List[EffectRecord]) -> List[str]:
    order = engine_protocol.REQUEST_COMMIT_ORDER
    out = []
    for rid in REQUEST_IDS:
        seq = tuple(r.name for r in trace
                    if r.key == rid and r.name in order)
        if seq != order:
            out.append(f"[clean run] {rid}: commit order {list(seq)} "
                       f"!= {list(order)}")
    return out


def _window(name: str) -> str:
    w = engine_protocol.effect(name).chaos_window
    return (f"chaos kill window: {w}" if w
            else "model-checker-only point (no chaos window samples it)")


def run_protocol_check(byte_stride: int = 1) -> ProtocolReport:
    """Enumerate every crash state of the workload and check every
    invariant over each. ``byte_stride`` thins the torn-append byte
    boundaries (1: every byte, ``lint --protocol``'s default)."""
    parent = tempfile.mkdtemp(prefix="sart-protocol-")
    violations: List[str] = []
    try:
        # dry run: discover the effect schedule, pin the commit order,
        # and require a clean-shutdown restart to be invariant-silent
        root = os.path.join(parent, "dry")
        driver = ProtocolDriver(root)
        driver.setup()
        shim = ShimFS(plan=None)
        with atomicio.use_fs(shim):
            driver.run_armed()
        trace = list(shim.log)
        violations.extend(_commit_order(trace))
        completed_at_crash, redriven = driver.recover()
        violations.extend(
            f"[clean run] {v}"
            for v in driver.check(completed_at_crash, redriven))
        shutil.rmtree(root, ignore_errors=True)

        plans = _enumerate(trace, byte_stride)
        by_effect: Dict[str, int] = {}
        for i, (plan, desc) in enumerate(plans):
            name = trace[plan.effect_index].name
            by_effect[name] = by_effect.get(name, 0) + 1
            root = os.path.join(parent, f"s{i}")
            driver = ProtocolDriver(root)
            driver.setup()
            fired = False
            try:
                with atomicio.use_fs(ShimFS(plan=plan)):
                    driver.run_armed()
            except SimulatedCrash:
                fired = True
            if not fired:
                violations.append(f"[{desc}] crash plan never fired "
                                  f"(effect schedule drifted)")
                shutil.rmtree(root, ignore_errors=True)
                continue
            found = driver.pre_recovery_check()
            completed_at_crash, redriven = driver.recover()
            found.extend(driver.check(completed_at_crash, redriven))
            violations.extend(
                f"[{desc}] {v} ({_window(name)})" for v in found)
            shutil.rmtree(root, ignore_errors=True)
    finally:
        shutil.rmtree(parent, ignore_errors=True)
    return ProtocolReport(
        effect_points=len(engine_protocol.PROTOCOL),
        effects_armed=len(trace),
        scenarios_total=len(plans),
        scenarios_by_effect=by_effect,
        byte_stride=max(1, int(byte_stride)),
        commit_order_ok=not any("commit order" in v
                                for v in violations),
        violations=violations,
    )


__all__ = [
    "CrashPlan", "EffectRecord", "ProtocolDriver", "ProtocolReport",
    "ShimFS", "SimulatedCrash", "REQUEST_IDS", "HANDOFF_ID",
    "expected_outcome", "run_protocol_check",
]
