"""The port's durable-effect protocol against the JAX engine's.

Ported from ``tests/test_protocol.py`` without the crash-point model
checker (``sartsolver_tpu/analysis/protocol.py``), which waits for the
static-analysis slice. The effect-point table and the replay decisions
(``needs_republish``, ``uncounted_completed``, ``needs_restage``) are held
to the JAX module over a grid of inputs; the atomicio primitives the
protocol leans on (the self-sealing append, the orphan-tmp sweep) and the
journal's replay under truncation at every byte are drilled as the JAX
suite drills them, and each torn state replays to the same story in both
packages.
"""

import itertools
import json
import os

import pytest

import sartsolver_tpu.engine.protocol as jep
from sartsolver_tpu.engine.journal import RequestJournal as JJournal

import sartsolver_tpu_torch.engine.protocol as ep
from sartsolver_tpu_torch.engine.journal import RequestJournal
from sartsolver_tpu_torch.engine.request import Request
from sartsolver_tpu_torch.utils import atomicio


def test_effect_points_match_jax():
    assert [p.name for p in ep.PROTOCOL] == [p.name for p in jep.PROTOCOL]
    for a, b in zip(ep.PROTOCOL, jep.PROTOCOL):
        assert (a.component, a.op, a.family, a.chaos_window) == (
            b.component, b.op, b.family, b.chaos_window), a.name
    assert ep.REQUEST_COMMIT_ORDER == jep.REQUEST_COMMIT_ORDER
    assert ep.effect("journal.completed").chaos_window == "pre-flush"
    with pytest.raises(KeyError):
        ep.effect("nope")


_OUTCOMES = [None, {}, {"status": "completed"},
             {"status": "completed", "journal_unix": 1000.0},
             {"status": "completed", "journal_unix": 100.0}]
_RESPONSES = [None, {"state": "pending"}, {"state": "done"}, {"state": "interrupted"}]


@pytest.mark.parametrize("ttl", [0.0, 500.0])
def test_needs_republish_matches_jax(ttl):
    for outcome, prev in itertools.product(_OUTCOMES, _RESPONSES):
        got = ep.needs_republish(outcome, prev, response_ttl_s=ttl, now=1200.0)
        want = jep.needs_republish(outcome, prev, response_ttl_s=ttl, now=1200.0)
        assert got == want, (outcome, prev, ttl)
    # the republish gate: a stale pending response is republished
    assert ep.needs_republish({"status": "completed"}, {"state": "pending"},
                              response_ttl_s=0.0)


def test_uncounted_and_restage_match_jax():
    completed = {"a": {"status": "completed"}, "b": {"status": "partial"},
                 "c": {"status": "failed"}}
    for counted in ([], ["a"], ["a", "b", "c"], ["c", "x"]):
        assert ep.uncounted_completed(completed, counted) == \
            jep.uncounted_completed(completed, counted)
    for flags in itertools.product([False, True], repeat=3):
        kw = dict(zip(("completed_anywhere", "pending_on_target",
                       "staged_on_target"), flags))
        assert ep.needs_restage(**kw) == jep.needs_restage(**kw)


def test_append_seals_a_torn_tail(tmp_path):
    """A torn final line has no newline; the next append must seal it so
    the new record survives on a line of its own."""
    path = str(tmp_path / "log.jsonl")
    atomicio.append_line(path, json.dumps({"n": 1}) + "\n")
    with open(path, "a") as f:
        f.write('{"n": 2, "torn')  # kill -9 mid-append
    atomicio.append_line(path, json.dumps({"n": 3}) + "\n")
    parsed = []
    for ln in open(path).read().splitlines():
        try:
            parsed.append(json.loads(ln))
        except ValueError:
            parsed.append(None)
    assert parsed[0] == {"n": 1}
    assert parsed[-1] == {"n": 3}, "record after a torn tail was lost"
    assert parsed.count(None) == 1


def test_append_after_every_truncation_point(tmp_path):
    """Whatever prefix of the file a crash leaves, the next append lands a
    parseable final record."""
    base = str(tmp_path / "base.jsonl")
    for i in range(3):
        atomicio.append_line(base, json.dumps({"i": i}) + "\n")
    data = open(base, "rb").read()
    rec = json.dumps({"i": "after"}) + "\n"
    for cut in range(len(data) + 1):
        path = str(tmp_path / f"cut{cut}.jsonl")
        with open(path, "wb") as f:
            f.write(data[:cut])
        atomicio.append_line(path, rec, fsync=False)
        last = open(path).read().splitlines()[-1]
        assert json.loads(last) == {"i": "after"}


def test_journal_replay_tolerates_truncation_at_every_byte(tmp_path):
    """The real journal under every torn-tail state: no exception, a
    consistent prefix, and the JAX replay's story at every cut."""
    j = RequestJournal(str(tmp_path / "journal.jsonl"))
    reqs = [Request(id=f"r{i}", trace=f"t{i}") for i in range(3)]
    for r in reqs:
        j.accepted(r)
        j.dispatched(r)
        j.completed(r, {"status": "completed"})
    data = open(j.path, "rb").read()
    all_ids = {r.id for r in reqs}
    prev_known = -1
    p = str(tmp_path / "cut.jsonl")
    for cut in range(len(data) + 1):
        with open(p, "wb") as f:
            f.write(data[:cut])
        completed, pending = RequestJournal(p).replay()
        jcompleted, jpending = JJournal(p).replay()
        assert completed == jcompleted
        assert [r.id for r in pending] == [r.id for r in jpending]
        known = set(completed) | {r.id for r in pending}
        assert known <= all_ids
        assert len(known) >= prev_known
        prev_known = len(known)
    assert prev_known == 3


def test_sweep_orphans_removes_only_tmp_files(tmp_path):
    d = str(tmp_path)
    open(os.path.join(d, "keep.json"), "w").write("{}")
    open(os.path.join(d, "a.json.123.tmp"), "w").write("debris")
    open(os.path.join(d, "b.json.456.tmp"), "w").write("debris")
    os.makedirs(os.path.join(d, "sub.tmp"))  # directory: not swept
    assert atomicio.sweep_orphans(d) == 2
    assert sorted(os.listdir(d)) == ["keep.json", "sub.tmp"]
    assert atomicio.sweep_orphans(os.path.join(d, "missing")) == 0


def test_server_startup_sweep_counts_into_retention_metric(tmp_path):
    """The startup sweep removes publish debris from the three durable dirs
    and counts it into engine_retention_deleted_total. The server's
    constructor never touches the session, so a bare object stands in."""
    from sartsolver_tpu_torch.engine.server import EngineServer
    from sartsolver_tpu_torch.obs import metrics as obs_metrics

    eng = str(tmp_path / "engine")
    server = EngineServer(object(), engine_dir=eng, lanes=1)
    os.makedirs(os.path.join(eng, "traces"), exist_ok=True)
    for rel in ("journal.jsonl.77.tmp", "responses/r1.json.77.tmp",
                "traces/r1.trace.json.77.tmp"):
        with open(os.path.join(eng, rel), "w") as f:
            f.write("debris")

    def _swept(snapshot):
        return sum(s["value"] for s in snapshot
                   if s["name"] == "engine_retention_deleted_total"
                   and s["labels"].get("dir") in ("engine", "responses", "traces"))

    before = _swept(obs_metrics.get_registry().snapshot())
    server._sweep_orphan_tmp()
    after = _swept(obs_metrics.get_registry().snapshot())
    assert after - before == 3
    assert not [n for n in os.listdir(eng) if n.endswith(".tmp")]
    assert not os.listdir(os.path.join(eng, "responses"))


def test_replay_republishes_and_recounts(tmp_path):
    """A kill after the completed marker and before the done response and
    the checkpoint: the restart republishes the response from the journaled
    outcome and re-counts the outcome once (the two replay decisions, on
    the real server)."""
    from sartsolver_tpu_torch.engine.server import EngineServer
    from sartsolver_tpu_torch.obs import metrics as obs_metrics

    eng = str(tmp_path / "engine")
    server = EngineServer(object(), engine_dir=eng, lanes=1)
    req = Request(id="k1", tenant="t", trace="tr-k1")
    server.journal.accepted(req)
    server._respond("k1", {"id": "k1", "verdict": "accepted", "state": "pending"})
    server.journal.dispatched(req)
    server.journal.completed(req, {"status": "completed", "frames": 2, "tenant": "t",
                                   "trace": "tr-k1"})
    obs_metrics.reset_registry()
    restarted = EngineServer(object(), engine_dir=eng, lanes=1)
    restarted._restore_state()
    restarted._replay()
    with open(os.path.join(eng, "responses", "k1.json")) as f:
        resp = json.load(f)
    assert resp["state"] == "done" and resp["republished"] is True
    assert resp["outcome"]["frames"] == 2
    reg = obs_metrics.get_registry()
    assert reg.counter("engine_requests_total", outcome="completed").value == 1
    assert not restarted._queue  # completed: never re-run
