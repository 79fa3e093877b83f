"""The port's serving engine against the JAX engine, and inside itself.

Ported from ``tests/test_engine.py`` (the supervisor and fleet legs are in
``tests/test_torch_supervisor.py`` and ``test_torch_fleet.py``; the model
checker's waits for its slice). The request record, the journal, the
admission policy and the soft state are held to the JAX modules on the
same inputs; a served world goes through the JAX ``EngineServer`` and the
port's under ``--use_cpu -m 40 -c 1e-12`` (outcomes, journal markers,
statuses and iterations equal, values within 1e-8, the fp64 bar); inside
the port a served request's rows equal, byte for byte, the port CLI's
``--no_guess --batch_frames 2`` over the same frames, in fp64 and in the
``--device cpu`` fp32 profile. The in-process drills (deadline shed while
co-batched, queue full, attach-fault quarantine, OOM halving, heartbeat
and ``top``) share module-scoped sessions; the real-process drills (the
serve/submit lifecycle with SIGTERM, the crash-replay matrix, the four
fault sites) run ``python -m sartsolver_tpu_torch.cli serve`` with a
timeout on every subprocess.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import h5py
import numpy as np
import pytest

import fixtures as fx

from sartsolver_tpu.engine import admission as jadm
from sartsolver_tpu.engine import journal as jjournal
from sartsolver_tpu.engine import request as jreq
from sartsolver_tpu.engine import state as jstate

from sartsolver_tpu_torch.engine import admission as adm_mod
from sartsolver_tpu_torch.engine import journal as journal_mod
from sartsolver_tpu_torch.engine import request as req_mod
from sartsolver_tpu_torch.engine import state as state_mod
from sartsolver_tpu_torch.engine.request import Request, RequestError, parse_request
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.resilience import faults
from sartsolver_tpu_torch.resilience.failures import DEADLINE_EXCEEDED, status_name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, per subprocess
SOLVE_FLAGS = ["--use_cpu", "-m", "40", "-c", "1e-12"]


# ---------------------------------------------------------------------------
# request parsing
# ---------------------------------------------------------------------------

def test_parse_request_matches_jax():
    payload = {"id": "r1", "tenant": "diag-a", "time_range": "0.1:0.3",
               "deadline_s": 2.5, "submitted_unix": 12.5, "trace": "t-1"}
    req = parse_request(json.dumps(payload))
    assert req.to_dict() == jreq.parse_request(json.dumps(payload)).to_dict()
    # to_dict round-trips through the journal's accepted record
    again = parse_request(req.to_dict())
    assert again == req
    assert parse_request({"id": "r"}).submitted_unix > 0
    assert req_mod.SHED_REASONS == jreq.SHED_REASONS
    assert req_mod.RETRYABLE_REASONS == jreq.RETRYABLE_REASONS
    assert (req_mod.REQ_COMPLETED, req_mod.REQ_PARTIAL, req_mod.REQ_FAILED,
            req_mod.REQ_SHED_DEADLINE, req_mod.REQ_REJECTED) == (
        jreq.REQ_COMPLETED, jreq.REQ_PARTIAL, jreq.REQ_FAILED,
        jreq.REQ_SHED_DEADLINE, jreq.REQ_REJECTED)


@pytest.mark.parametrize("payload", [
    "not json",
    json.dumps(["list"]),
    json.dumps({"tenant": "t"}),                      # missing id
    json.dumps({"id": "bad id!"}),                    # bad id charset
    json.dumps({"id": "r", "unknown_field": 1}),      # unknown field
    json.dumps({"id": "r", "deadline_s": -1}),        # bad deadline
    json.dumps({"id": "r", "time_range": "5:1"}),     # bad range
    json.dumps({"id": "r", "tenant": 7}),             # bad tenant type
    json.dumps({"id": "r", "trace": "no spaces"}),    # bad trace id
    json.dumps({"id": "r", "handoff": "yes"}),        # bad handoff type
    json.dumps({"id": "r", "geometry": {"format": "x"}}),  # bad geometry
])
def test_parse_request_rejects(payload):
    """Both packages reject the same payloads, each with its RequestError."""
    with pytest.raises(RequestError) as port_err:
        parse_request(payload)
    with pytest.raises(jreq.RequestError) as jax_err:
        jreq.parse_request(payload)
    assert str(port_err.value).split(":")[0] == str(jax_err.value).split(":")[0]


def test_parse_request_default_deadline():
    req = parse_request(json.dumps({"id": "r"}), default_deadline_s=9.0)
    assert req.deadline_s == 9.0
    req = parse_request(json.dumps({"id": "r", "deadline_s": 1.5}),
                        default_deadline_s=9.0)
    assert req.deadline_s == 1.5


def test_parse_request_fault_site():
    """request.parse models a torn payload read: an armed io fault surfaces
    as OSError (the server's malformed-rejection leg)."""
    with faults.injected(faults.SITE_REQUEST_PARSE, "io", 1.0, count=1):
        with pytest.raises(OSError):
            parse_request(json.dumps({"id": "ok"}))
        parse_request(json.dumps({"id": "ok"}))  # count exhausted


# ---------------------------------------------------------------------------
# journal
# ---------------------------------------------------------------------------

def _journal_story(j, mod):
    r1 = mod.parse_request({"id": "r1", "tenant": "a", "deadline_s": 5,
                            "submitted_unix": 1.0, "trace": "t1"})
    r2 = mod.parse_request({"id": "r2", "tenant": "b", "submitted_unix": 2.0,
                            "trace": "t2"})
    r3 = mod.parse_request({"id": "r3", "tenant": "b", "submitted_unix": 3.0,
                            "trace": "t3"})
    j.accepted(r1)
    j.dispatched(r1)
    j.completed(r1, {"status": "completed", "frames": 4})
    j.accepted(r2)
    j.dispatched(r2)  # dispatched but never completed -> replays
    j.accepted(r3)    # accepted only -> replays
    j.session_event("session-attach", "default", bytes=10)


def test_journal_roundtrip_and_replay(tmp_path):
    j = journal_mod.RequestJournal(str(tmp_path / "j.jsonl"))
    _journal_story(j, req_mod)
    completed, pending = j.replay()
    assert set(completed) == {"r1"}
    assert [r.id for r in pending] == ["r2", "r3"]
    assert pending[0].tenant == "b" and pending[0].trace == "t2"
    with open(j.path) as f:
        first = json.loads(f.readline())
    assert first["request"]["deadline_s"] == 5


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_format_crosses_packages(tmp_path, writer):
    """The journal's lines are the JAX format field for field: each
    package replays what the other wrote, to the same story."""
    mods = {"port": (journal_mod, req_mod), "jax": (jjournal, jreq)}
    wmod, wreq = mods[writer]
    path = str(tmp_path / "j.jsonl")
    _journal_story(wmod.RequestJournal(path), wreq)
    got = journal_mod.RequestJournal(path).replay_full()
    want = jjournal.RequestJournal(path).replay_full()
    assert got[0] == want[0]
    assert [r.to_dict() for r in got[1]] == [r.to_dict() for r in want[1]]
    assert got[2] == want[2] == {}
    # the same lines, field for field, whichever package wrote them
    other = str(tmp_path / "other.jsonl")
    omod, oreq = mods["jax" if writer == "port" else "port"]
    _journal_story(omod.RequestJournal(other), oreq)

    def lines(p):
        out = []
        for ln in open(p):
            rec = json.loads(ln)
            rec.pop("unix")
            out.append(rec)
        return out

    assert lines(path) == lines(other)


def test_journal_ignores_torn_tail(tmp_path):
    j = journal_mod.RequestJournal(str(tmp_path / "j.jsonl"))
    j.accepted(parse_request({"id": "r1"}))
    with open(j.path, "a") as f:
        f.write('{"marker": "completed", "id": "r1", "out')  # torn append
    completed, pending = j.replay()
    assert not completed and [r.id for r in pending] == ["r1"]
    # the next append seals the torn line: both records stay readable
    j.dispatched(pending[0])
    j.completed(pending[0], {"status": "completed"})
    completed, pending = j.replay()
    assert set(completed) == {"r1"} and not pending


def test_journal_append_fault_retries(tmp_path, monkeypatch):
    """Transient journal I/O faults retry in place; the marker still
    lands (the engine never proceeds unjournaled)."""
    monkeypatch.setenv("SART_RETRY_BASE_DELAY", "0.01")
    j = journal_mod.RequestJournal(str(tmp_path / "j.jsonl"))
    with faults.injected(faults.SITE_JOURNAL_APPEND, "io", 1.0, count=2):
        j.accepted(parse_request({"id": "r1"}))
    completed, pending = j.replay()
    assert [r.id for r in pending] == ["r1"]


def test_journal_crash_window_announces(tmp_path, monkeypatch, capfd):
    monkeypatch.setenv("SART_TEST_JOURNAL_DELAY", "0.01")
    j = journal_mod.RequestJournal(str(tmp_path / "j.jsonl"))
    r = parse_request({"id": "r1"})
    j.accepted(r)
    j.dispatched(r)
    j.completed(r, {})
    err = capfd.readouterr().err
    assert "SART_JOURNAL_POINT accepted" in err
    assert "SART_JOURNAL_POINT dispatched" in err
    assert "SART_JOURNAL_POINT pre-flush" in err


def test_journal_compaction_matches_jax(tmp_path):
    """Compaction keeps the pending story, in acceptance order, in both
    packages."""
    for name, jmod, rmod in (("port", journal_mod, req_mod), ("jax", jjournal, jreq)):
        j = jmod.RequestJournal(str(tmp_path / f"{name}.jsonl"))
        _journal_story(j, rmod)
        assert j.compact() > 0
        completed, pending = j.replay()
        assert not completed and [r.id for r in pending] == ["r2", "r3"]


# ---------------------------------------------------------------------------
# admission policy
# ---------------------------------------------------------------------------

def _req(rid, tenant="t", mod=req_mod):
    return mod.parse_request({"id": rid, "tenant": tenant})


def _admission_script(mod, amod):
    """One scripted admission history; returns every verdict."""
    clock = {"t": 0.0}
    adm = amod.AdmissionController(max_queue=3, max_per_tenant=2,
                                   quarantine_after=2, quarantine_cooldown=10.0,
                                   clock=lambda: clock["t"])
    out = []
    for rid, tenant in (("a1", "a"), ("a2", "a"), ("a3", "a"), ("b1", "b"),
                        ("c1", "c")):
        out.append(adm.admit(_req(rid, tenant, mod)))
    for rid, tenant, outcome in (("a1", "a", mod.REQ_FAILED),
                                 ("a2", "a", mod.REQ_PARTIAL),
                                 ("b1", "b", mod.REQ_SHED_DEADLINE)):
        adm.note_dispatched(_req(rid, tenant, mod))
        adm.note_outcome(_req(rid, tenant, mod), outcome)
    out.append(adm.admit(_req("a4", "a", mod)))  # quarantined
    out.append(adm.admit(_req("a1", "a", mod)))  # duplicate
    out.append(adm.admit(_req("z", "z", mod), draining=True))
    adm.set_degraded("device OOM; lanes halved to 1")
    out.append(adm.admit(_req("d1", "d", mod)))
    clock["t"] = 11.0
    out.append(adm.admit(_req("a5", "a", mod)))
    state = adm.export_state()
    state.pop("tenants")  # wall-clock stamps
    out.append(state)
    out.append(adm.tenant_view())
    return out


def test_admission_policy_matches_jax():
    obs_metrics.reset_registry()
    assert _admission_script(req_mod, adm_mod) == _admission_script(jreq, jadm)


def test_admission_queue_and_quota():
    obs_metrics.reset_registry()
    adm = adm_mod.AdmissionController(max_queue=2, max_per_tenant=1)
    assert adm.admit(_req("a1", "a")) is None
    # tenant quota before global capacity
    assert adm.admit(_req("a2", "a")) == req_mod.REASON_TENANT_QUOTA
    assert adm.admit(_req("b1", "b")) is None
    assert adm.admit(_req("c1", "c")) == req_mod.REASON_QUEUE_FULL
    adm.note_dispatched(_req("a1", "a"))
    adm.note_outcome(_req("a1", "a"), req_mod.REQ_COMPLETED)
    assert adm.admit(_req("a1", "a")) == req_mod.REASON_DUPLICATE
    assert adm.admit(_req("z", "z"), draining=True) == req_mod.REASON_DRAINING


def test_admission_quarantine_and_cooldown():
    obs_metrics.reset_registry()
    clock = {"t": 0.0}
    adm = adm_mod.AdmissionController(max_queue=8, quarantine_after=2,
                                      quarantine_cooldown=10.0,
                                      clock=lambda: clock["t"])
    for i, outcome in enumerate((req_mod.REQ_FAILED, req_mod.REQ_PARTIAL)):
        r = _req(f"bad{i}", "noisy")
        assert adm.admit(r) is None
        adm.note_dispatched(r)
        adm.note_outcome(r, outcome)
    assert adm.admit(_req("bad2", "noisy")) == req_mod.REASON_TENANT_QUARANTINED
    assert adm.admit(_req("ok1", "calm")) is None
    assert adm.quarantined_tenants() == ["noisy"]
    clock["t"] = 11.0
    assert adm.admit(_req("bad3", "noisy")) is None
    adm.note_dispatched(_req("bad3", "noisy"))
    adm.note_outcome(_req("bad3", "noisy"), req_mod.REQ_COMPLETED)
    r = _req("bad4", "noisy")
    assert adm.admit(r) is None
    adm.note_dispatched(r)
    adm.note_outcome(r, req_mod.REQ_FAILED)
    assert adm.admit(_req("bad5", "noisy")) is None  # streak is 1, not 3


def test_admission_deadline_shed_not_quarantined():
    obs_metrics.reset_registry()
    adm = adm_mod.AdmissionController(max_queue=8, quarantine_after=1)
    r = _req("d1", "t")
    assert adm.admit(r) is None
    adm.note_dispatched(r)
    adm.note_outcome(r, req_mod.REQ_SHED_DEADLINE)
    assert adm.admit(_req("d2", "t")) is None


def test_admission_degraded_mode():
    obs_metrics.reset_registry()
    adm = adm_mod.AdmissionController(max_queue=4)
    adm.set_degraded("device OOM; lanes halved to 1")
    assert adm.admit(_req("a")) is None  # below the degraded watermark
    assert adm.admit(_req("b")) is None
    assert adm.admit(_req("c")) == req_mod.REASON_DEGRADED
    adm.set_degraded(None)
    assert adm.admit(_req("c2")) is None


def test_admission_affinity_matches_jax():
    from sartsolver_tpu.engine.routing import tenant_worker as jtenant_worker

    from sartsolver_tpu_torch.engine.routing import tenant_worker

    tenants = [f"tenant-{i}" for i in range(40)]
    assert [tenant_worker(t, 3) for t in tenants] == [jtenant_worker(t, 3) for t in tenants]
    obs_metrics.reset_registry()
    adm = adm_mod.AdmissionController(max_queue=8, affinity=(0, 3))
    for t in tenants[:6]:
        want = None if tenant_worker(t, 3) == 0 else req_mod.REASON_WRONG_WORKER
        assert adm.admit(_req(f"x-{t}", t)) == want
    handed = parse_request({"id": "h1", "tenant": tenants[1], "handoff": True})
    assert adm.admit(handed) is None


def test_state_store_crosses_packages(tmp_path):
    """The soft-state checkpoint is the JAX format: each package loads
    what the other saved, a torn tail falls back to the last valid
    record, and a flipped byte fails its CRC."""
    state = {"lanes": 1, "admission": {"seen_ids": ["a", "b"]},
             "counted_ids": ["a"], "metrics": []}
    for name, smod, other in (("port", state_mod, jstate), ("jax", jstate, state_mod)):
        path = str(tmp_path / f"{name}.jsonl")
        store = smod.StateStore(path)
        store.save({"lanes": 2})
        store.save(state)
        assert other.StateStore(path).load() == state
        with open(path, "a") as f:
            f.write('{"v": 1, "serial": 3, "crc": 1, "state": {"lan')  # torn
        assert other.StateStore(path).load() == state
        other.StateStore(path).compact()
        assert smod.StateStore(path).load() == state
        text = open(path).read().replace('"lanes": 1', '"lanes": 7')
        with open(path, "w") as f:
            f.write(text)
        assert other.StateStore(path).load() is None  # the CRC catches it


def test_state_checkpoint_fault_retries(tmp_path, monkeypatch):
    monkeypatch.setenv("SART_RETRY_BASE_DELAY", "0.01")
    store = state_mod.StateStore(str(tmp_path / "s.jsonl"))
    with faults.injected(faults.SITE_STATE_CHECKPOINT, "io", 1.0, count=2):
        store.save({"lanes": 2})
    assert store.load() == {"lanes": 2}


def test_status_taxonomy():
    assert DEADLINE_EXCEEDED == -5
    assert status_name(DEADLINE_EXCEEDED) == "deadline"


# ---------------------------------------------------------------------------
# in-process engine: against the JAX engine, and inside the port
# ---------------------------------------------------------------------------

def _inputs(paths):
    return [paths[k] for k in ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    td = tmp_path_factory.mktemp("torch_engine_world")
    paths, *_ = fx.write_world(str(td), n_frames=4)
    return paths


def _port_session(paths, flags):
    from sartsolver_tpu_torch.cli import _validate
    from sartsolver_tpu_torch.engine.cli import build_serve_parser
    from sartsolver_tpu_torch.engine.session import ResidentSession

    args = build_serve_parser().parse_args(
        ["--engine_dir", "/nonexistent-unused", *flags, *_inputs(paths)])
    _validate(args)
    return ResidentSession.build(args)


@pytest.fixture(scope="module")
def session(world):
    return _port_session(world, SOLVE_FLAGS)


@pytest.fixture(scope="module")
def fp32_session(world):
    return _port_session(world, ["--device", "cpu", "-m", "40", "-c", "1e-12"])


def _stage(eng_dir, requests):
    os.makedirs(os.path.join(eng_dir, "ingest"), exist_ok=True)
    for i, payload in enumerate(requests):
        with open(os.path.join(eng_dir, "ingest", f"{i:03d}-{payload['id']}.json"),
                  "w") as f:
            json.dump(payload, f)


def _run_server(session, eng_dir, requests, *, lanes=2, idle_exit=0.4, **kw):
    from sartsolver_tpu_torch.engine.server import EngineServer

    _stage(eng_dir, requests)
    admission = kw.pop("admission", None)
    if admission is None:
        admission = adm_mod.AdmissionController(
            max_queue=kw.pop("max_queue", 16),
            max_per_tenant=kw.pop("max_per_tenant", 0),
            quarantine_after=kw.pop("quarantine_after", 3),
            quarantine_cooldown=kw.pop("quarantine_cooldown", 60.0),
        )
    server = EngineServer(session, engine_dir=eng_dir, lanes=lanes, admission=admission,
                          poll_interval=0.05, idle_exit=idle_exit, **kw)
    rc = server.run()
    return server, rc


def _response(eng_dir, rid):
    with open(os.path.join(eng_dir, "responses", f"{rid}.json")) as f:
        return json.load(f)


def _solution(path):
    with h5py.File(path, "r") as f:
        return {k: f[f"solution/{k}"][:] for k in f["solution"]}


def _markers(eng_dir):
    with open(os.path.join(eng_dir, "journal.jsonl")) as f:
        return [(rec["marker"], rec["id"]) for rec in map(json.loads, f)]


PARITY_REQUESTS = [
    {"id": "all", "tenant": "a"},
    {"id": "head", "tenant": "b", "time_range": "0.05:0.25"},
    {"id": "tail", "tenant": "a", "time_range": "0.25:1"},
]


def test_engine_matches_jax_engine(session, world, tmp_path):
    """The same world and requests through the JAX EngineServer and the
    port's: outcomes and journal markers equal, statuses and iteration
    counts equal, values within 1e-8 (fp64)."""
    from sartsolver_tpu.cli import _validate as jvalidate
    from sartsolver_tpu.engine.cli import build_serve_parser as jparser
    from sartsolver_tpu.engine.server import EngineServer as JServer
    from sartsolver_tpu.engine.session import ResidentSession as JSession
    from sartsolver_tpu.obs import metrics as jmetrics

    jargs = jparser().parse_args(["--engine_dir", "/unused", *SOLVE_FLAGS,
                                  "--pixel_shards", "1", *_inputs(world)])
    jvalidate(jargs)
    jsession = JSession.build(jargs)
    jeng = str(tmp_path / "jax")
    _stage(jeng, PARITY_REQUESTS)
    jmetrics.reset_registry()
    assert JServer(jsession, engine_dir=jeng, lanes=2,
                   admission=jadm.AdmissionController(max_queue=16),
                   poll_interval=0.05, idle_exit=0.4).run() == 0
    obs_metrics.reset_registry()
    peng = str(tmp_path / "port")
    _, rc = _run_server(session, peng, PARITY_REQUESTS)
    assert rc == 0
    assert _markers(peng) == _markers(jeng)
    for req in PARITY_REQUESTS:
        got, want = _response(peng, req["id"]), _response(jeng, req["id"])
        for key in ("status", "frames", "by_status", "output", "tenant"):
            assert got["outcome"][key] == want["outcome"][key], (req["id"], key)
        a = _solution(os.path.join(peng, "outputs", f"{req['id']}.h5"))
        b = _solution(os.path.join(jeng, "outputs", f"{req['id']}.h5"))
        for key in ("status", "iterations", "time", "time_camA", "time_camB"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        np.testing.assert_allclose(a["value"], b["value"], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("profile", ["fp64", "fp32"])
def test_engine_output_equals_the_cli(session, fp32_session, world, tmp_path, profile):
    """A served request's rows equal, byte for byte, the port CLI's
    continuous-batching run over the same frames (lane parity), and a
    second engine run reproduces them (replay determinism)."""
    from sartsolver_tpu_torch.cli import main as cli_main

    sess, flags = ((session, SOLVE_FLAGS) if profile == "fp64" else
                   (fp32_session, ["--device", "cpu", "-m", "40", "-c", "1e-12"]))
    obs_metrics.reset_registry()
    eng = str(tmp_path / "eng")
    _, rc = _run_server(sess, eng, PARITY_REQUESTS[:2])
    assert rc == 0
    out = _response(eng, "all")["outcome"]
    assert out["status"] == "completed" and out["frames"] == 4
    assert _response(eng, "head")["outcome"]["frames"] == 2
    completed, pending = journal_mod.RequestJournal(os.path.join(eng, "journal.jsonl")).replay()
    assert set(completed) == {"all", "head"} and not pending
    cli_out = str(tmp_path / "cli.h5")
    assert cli_main(["-o", cli_out, *flags, "--no_guess", "--batch_frames", "2",
                     *_inputs(world)]) == 0
    a = _solution(os.path.join(eng, "outputs", "all.h5"))
    b = _solution(cli_out)
    assert sorted(a) == sorted(b)
    for key in sorted(b):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    eng2 = str(tmp_path / "eng2")
    _run_server(sess, eng2, [{"id": "all", "tenant": "a"}])
    c = _solution(os.path.join(eng2, "outputs", "all.h5"))
    for key in sorted(a):
        np.testing.assert_array_equal(a[key], c[key], err_msg=key)


def test_warm_up_leaves_the_served_rows_as_they_were(fp32_session, world, tmp_path):
    """The warm-up stride ``serve`` runs on the card before it is ready:
    it touches no scheduler metric, and a request served after it has the
    CLI's rows byte for byte (run here on the fp32 plain profile)."""
    from sartsolver_tpu_torch.cli import main as cli_main

    flags = ["--device", "cpu", "-m", "40", "-c", "1e-12"]
    obs_metrics.reset_registry()
    assert fp32_session.warm_up(2) > 0
    assert obs_metrics.get_registry().counter("sched_strides_total").value == 0
    eng = str(tmp_path / "eng")
    _, rc = _run_server(fp32_session, eng, PARITY_REQUESTS[:1])
    assert rc == 0
    cli_out = str(tmp_path / "cli.h5")
    assert cli_main(["-o", cli_out, *flags, "--no_guess", "--batch_frames", "2",
                     *_inputs(world)]) == 0
    a = _solution(os.path.join(eng, "outputs", "all.h5"))
    b = _solution(cli_out)
    assert sorted(a) == sorted(b)
    for key in sorted(b):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


DEADLINE_CAP = 40000  # -m of the deadline drill's session


def test_engine_deadline_shed_while_cobatched_completes(world, tmp_path):
    """An over-deadline request retires at a stride boundary with the
    distinct status while the co-batched request completes normally."""
    obs_metrics.reset_registry()
    # a tolerance below reach and a cap far past the deadline, so the
    # deadline expires mid-solve however fast the host (4000 iterations of
    # this world take under 0.6 s on an idle CPU)
    slow = _port_session(world, ["--use_cpu", "-m", str(DEADLINE_CAP), "-c", "1e-300",
                                 "--schedule_stride", "8"])
    eng = str(tmp_path / "eng")
    _, rc = _run_server(slow, eng, [
        {"id": "hurried", "tenant": "a", "deadline_s": 0.6},
        {"id": "patient", "tenant": "b"},
    ], lanes=2)
    assert rc == 0
    hurried = _response(eng, "hurried")["outcome"]
    patient = _response(eng, "patient")["outcome"]
    assert hurried["status"] == "shed-deadline"
    assert set(hurried["by_status"]) == {"deadline"}
    assert patient["status"] == "completed"
    sol = _solution(os.path.join(eng, "outputs", "hurried.h5"))
    assert (sol["status"] == DEADLINE_EXCEEDED).all()
    assert (sol["iterations"] < DEADLINE_CAP).all()
    reg = obs_metrics.get_registry()
    assert reg.counter("engine_deadline_miss_total").value >= 1
    assert reg.counter("sched_deadline_shed_total").value >= 1


def test_engine_queue_full_rejects_machine_readable(session, tmp_path):
    obs_metrics.reset_registry()
    eng = str(tmp_path / "eng")
    _, rc = _run_server(session, eng, [
        {"id": "q1", "tenant": "a"},
        {"id": "q2", "tenant": "a"},
        {"id": "q3", "tenant": "a"},
    ], max_queue=1, max_cycle_requests=1)
    assert rc == 0
    verdicts = {rid: _response(eng, rid) for rid in ("q1", "q2", "q3")}
    assert verdicts["q1"]["verdict"] == "accepted"
    shed = [r for r in verdicts.values() if r.get("reason") == req_mod.REASON_QUEUE_FULL]
    assert len(shed) == 2
    assert all(r["retry_after_s"] >= 1.0 for r in shed)
    reg = obs_metrics.get_registry()
    assert reg.counter("engine_shed_total", reason=req_mod.REASON_QUEUE_FULL).value == 2


def test_engine_attach_fault_quarantines_tenant(session, tmp_path):
    """session.attach faults fail the request (FAILED outcome, no engine
    abort), and consecutive failures quarantine only that tenant."""
    obs_metrics.reset_registry()
    eng = str(tmp_path / "eng")
    adm = adm_mod.AdmissionController(max_queue=16, quarantine_after=2)
    with faults.injected(faults.SITE_SESSION_ATTACH, "error", 1.0, count=2):
        _run_server(session, eng, [{"id": "n1", "tenant": "noisy"}], admission=adm)
        _run_server(session, eng, [{"id": "n2", "tenant": "noisy"}], admission=adm)
    _run_server(session, eng, [{"id": "n3", "tenant": "noisy"},
                               {"id": "c1", "tenant": "calm"}], admission=adm)
    assert _response(eng, "n1")["outcome"]["status"] == "failed"
    assert _response(eng, "n2")["outcome"]["status"] == "failed"
    assert _response(eng, "n3")["reason"] == req_mod.REASON_TENANT_QUARANTINED
    assert _response(eng, "c1")["outcome"]["status"] == "completed"


def test_engine_oom_halves_lanes_and_degrades(session, world, tmp_path):
    """An injected device OOM mid-cycle (the solve.dispatch site, through
    resilience/degrade.py:is_resource_exhausted): the lane count halves
    (sticky), every frame still solves, admission flips degraded, and the
    rows equal the port CLI's at the halved lane count."""
    from sartsolver_tpu_torch.cli import main as cli_main

    obs_metrics.reset_registry()
    eng = str(tmp_path / "eng")
    with faults.injected(faults.SITE_SOLVE, "oom", 1.0, count=1):
        server, rc = _run_server(session, eng, [{"id": "o1", "tenant": "a"}], lanes=2)
    assert rc == 0
    assert server.lanes == 1
    assert server.admission.degraded_reason is not None
    out = _response(eng, "o1")["outcome"]
    assert out["status"] == "completed" and out["frames"] == 4
    cli_out = str(tmp_path / "cli.h5")
    assert cli_main(["-o", cli_out, *SOLVE_FLAGS, "--no_guess", "--batch_frames", "1",
                     *_inputs(world)]) == 0
    a, b = _solution(os.path.join(eng, "outputs", "o1.h5")), _solution(cli_out)
    for key in sorted(b):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # the ladder level is checkpointed: a restart resumes at one lane
    again = state_mod.StateStore(os.path.join(eng, "state.jsonl")).load()
    assert again["lanes"] == 1


def test_engine_status_heartbeat_and_top(session, tmp_path, monkeypatch):
    """The engine view reaches the status snapshot (SIGUSR1, crash bundle),
    the heartbeat line and ``top``."""
    from sartsolver_tpu_torch.engine.server import EngineServer
    from sartsolver_tpu_torch.obs import flight as obs_flight
    from sartsolver_tpu_torch.obs.cli import render_top
    from sartsolver_tpu_torch.resilience import watchdog

    obs_metrics.reset_registry()
    eng = str(tmp_path / "eng")
    server = EngineServer(session, engine_dir=eng, lanes=2,
                          admission=adm_mod.AdmissionController(max_queue=4))
    server.admission.admit(_req("s1", "a"))
    server._active_ids.append("s0")
    watchdog.set_engine_status_provider(server._status)
    try:
        rec = obs_flight.status_snapshot()
        assert rec["engine"]["queue_depth"] == 1
        assert rec["engine"]["admitted"] == 1
        assert rec["engine"]["active_requests"] == ["s0"]
        status_path = str(tmp_path / "status.json")
        obs_flight.write_status(status_path)
        screen = render_top(status_path)
        assert "engine: queue 1" in screen
        assert "s0" in screen
        hb = str(tmp_path / "hb")
        monkeypatch.setenv("SART_HEARTBEAT_FILE", hb)
        watchdog.beacon(watchdog.PHASE_FRAME_DONE)
        line = open(hb).read()
        assert "queue=1" in line and "admitted=1" in line and "requests=s0" in line
    finally:
        watchdog.set_engine_status_provider(None)
    assert watchdog.engine_status() is None


def test_session_cache_budget_and_eviction(session, tmp_path):
    """The byte-budgeted cache charges a session its held device storage
    (here the CPU's: the stored matrix, its ray stats) and an eviction
    closes the solver, whose problem is then gone."""
    from sartsolver_tpu_torch.engine.session import SessionCache, session_nbytes

    assert session_nbytes(session) == session.nbytes() >= 14 * 16 * 8
    built = []

    class Stub:
        def __init__(self, n):
            self.nbytes, self.closed = n, False

        def close(self):
            self.closed = True

    def build(key):
        built.append(key)
        return Stub(60)

    obs_metrics.reset_registry()
    cache = SessionCache(build, byte_budget=100)
    cache.seed("default", Stub(50))
    first = cache.get("geometry:a")
    assert cache.keys() == ["geometry:a"]  # the default went over the budget
    cache.get("geometry:b")
    assert first.closed and cache.keys() == ["geometry:b"]
    cache.get("geometry:a")  # rebuilt: a compile-reuse count, not a hit
    reg = obs_metrics.get_registry()
    assert reg.counter("session_cache_evictions_total").value == 3
    assert reg.counter("session_cache_compile_reuse_total").value == 1
    assert built == ["geometry:a", "geometry:b", "geometry:a"]


# ---------------------------------------------------------------------------
# real-process drills
# ---------------------------------------------------------------------------

def _env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("SART_TEST_JOURNAL_DELAY", "SART_FAULT")}
    env["PYTHONUNBUFFERED"] = "1"  # the drills watch live stdout lines
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def _serve_cmd(paths, eng_dir, *extra):
    return [sys.executable, "-m", "sartsolver_tpu_torch.cli", "serve",
            "--engine_dir", eng_dir, *SOLVE_FLAGS, "--lanes", "2",
            "--poll_interval", "0.05", *extra, *_inputs(paths)]


def _submit(eng_dir, *extra, env=None):
    return subprocess.run([sys.executable, "-m", "sartsolver_tpu_torch.cli", "submit",
                           "--engine_dir", eng_dir, *extra],
                          env=env or _env(), capture_output=True, text=True,
                          timeout=TIMEOUT)


def _start_serve(cmd, env):
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    killer = threading.Timer(TIMEOUT, proc.kill)
    killer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if "session resident" in line:
                return proc, lines
    finally:
        killer.cancel()
    proc.kill()
    raise AssertionError("serve process never became resident:\n" + "".join(lines))


def _drain_stdout(proc, sink):
    t = threading.Thread(target=lambda: sink.extend(proc.stdout), daemon=True)
    t.start()
    return t


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise


@pytest.fixture(scope="module")
def drill_world(tmp_path_factory):
    td = tmp_path_factory.mktemp("torch_engine_drill")
    paths, *_ = fx.write_world(str(td), n_frames=4)
    return paths


def test_serve_submit_lifecycle_and_sigterm(drill_world, tmp_path):
    """One real serve process: a directory submit with --wait completes;
    a socket submit gets its verdict; a duplicate id is answered with the
    recorded outcome; a malformed submit fails locally with exit 1; SIGTERM
    drains and exits 4. Without a card and without --use_cpu/--device cpu,
    serve exits 1 with a message."""
    eng = str(tmp_path / "eng")
    sock = str(tmp_path / "s.sock")
    env = _env()
    proc, lines = _start_serve(_serve_cmd(drill_world, eng, "--socket", sock), env)
    _drain_stdout(proc, lines)
    try:
        done = _submit(eng, "--id", "life1", "--tenant", "demo", "--wait", "90")
        assert done.returncode == 0, done.stderr
        rec = json.loads(done.stdout)
        assert rec["outcome"]["status"] == "completed"
        assert rec["outcome"]["frames"] == 4
        viasock = subprocess.run(
            [sys.executable, "-m", "sartsolver_tpu_torch.cli", "submit", "--socket", sock,
             "--id", "sock1", "--tenant", "demo", "--time_range", "0.05:0.25"],
            env=env, capture_output=True, text=True, timeout=TIMEOUT)
        assert viasock.returncode == 0, viasock.stderr
        assert json.loads(viasock.stdout)["verdict"] == "accepted"
        dup = _submit(eng, "--id", "life1", "--wait", "60")
        assert dup.returncode == 0, dup.stdout + dup.stderr
        dup_rec = json.loads(dup.stdout)
        assert dup_rec.get("duplicate") is True
        assert dup_rec["outcome"]["status"] == "completed"
        assert _response(eng, "life1")["outcome"]["frames"] == 4
        bad = _submit(eng, "--id", "bad name!")
        assert bad.returncode == 1
    finally:
        rc = _stop(proc)
    assert rc == 4
    assert "draining" in "".join(lines)
    assert _response(eng, "sock1")["outcome"]["frames"] == 2
    # the default device is the card's
    nocard = subprocess.run(
        [sys.executable, "-m", "sartsolver_tpu_torch.cli", "serve", "--engine_dir",
         str(tmp_path / "e2"), "-m", "40", *_inputs(drill_world)],
        env=_env({"CUDA_VISIBLE_DEVICES": ""}), capture_output=True, text=True,
        timeout=TIMEOUT)
    assert nocard.returncode == 1
    assert "No CUDA device" in nocard.stderr


def test_serve_refuses_a_socket_path_too_long_for_af_unix(world, tmp_path, capsys):
    """A socket path past AF_UNIX's 107 bytes fails with a message and exit
    1 before the ingest, not at bind after it."""
    from sartsolver_tpu_torch.engine.cli import SOCKET_PATH_MAX, serve_main

    sock = str(tmp_path / ("s" * SOCKET_PATH_MAX)) + ".sock"
    assert serve_main(["--engine_dir", str(tmp_path / "e"), "--socket", sock,
                       *SOLVE_FLAGS, *_inputs(world)]) == 1
    err = capsys.readouterr()
    assert "AF_UNIX socket path holds at most 107" in err.err
    assert "session resident" not in err.out


@pytest.mark.parametrize("argv,words", [
    (["chaos", "--engine_dir", "e", "--pod", "2", "--", "--use_cpu", "a.h5"],
     "--pod is not ported"),
])
def test_unported_subcommands_refuse(argv, words, capsys):
    """Of the serving subcommands only the pod campaign refuses (it needs
    the pod barriers of a multi-host solve); ``serve --supervised``,
    ``fleet`` and ``chaos`` run (tests/test_torch_supervisor.py,
    test_torch_fleet.py, test_torch_chaos.py)."""
    from sartsolver_tpu_torch.cli import main as cli_main

    assert cli_main(argv) == 1
    assert words in capsys.readouterr().err


CRASH_REQUESTS = [
    {"id": "cr1", "tenant": "a", "time_range": "0.05:0.25"},
    {"id": "cr2", "tenant": "b"},
]


@pytest.fixture(scope="module")
def crash_reference(drill_world, tmp_path_factory):
    """Uninterrupted outputs for the crash matrix (one real serve run)."""
    ref = str(tmp_path_factory.mktemp("torch_crash_ref"))
    _stage(ref, CRASH_REQUESTS)
    res = subprocess.run(_serve_cmd(drill_world, ref, "--idle_exit", "1"), env=_env(),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stdout + res.stderr
    return {r["id"]: _solution(os.path.join(ref, "outputs", f"{r['id']}.h5"))
            for r in CRASH_REQUESTS}


@pytest.mark.parametrize("marker", ["accepted", "dispatched", "pre-flush"])
def test_crash_replay_matrix(drill_world, crash_reference, tmp_path, marker):
    """SIGKILL the real serve process inside a journal marker window,
    restart: no request lost, none solved twice, outputs byte-identical to
    an uninterrupted run."""
    eng = str(tmp_path / "eng")
    _stage(eng, CRASH_REQUESTS)
    proc = subprocess.Popen(_serve_cmd(drill_world, eng),
                            env=_env({"SART_TEST_JOURNAL_DELAY": "1.0"}),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    killer = threading.Timer(TIMEOUT, proc.kill)
    killer.start()
    try:
        for line in proc.stdout:
            if f"SART_JOURNAL_POINT {marker}" in line:
                proc.kill()
                break
    finally:
        killer.cancel()
    assert proc.wait(timeout=60) == -signal.SIGKILL
    rc = subprocess.run(_serve_cmd(drill_world, eng, "--idle_exit", "1"), env=_env(),
                        capture_output=True, text=True, timeout=TIMEOUT).returncode
    assert rc == 0
    completed, pending = journal_mod.RequestJournal(os.path.join(eng, "journal.jsonl")).replay()
    assert set(completed) == {"cr1", "cr2"} and not pending
    with open(os.path.join(eng, "journal.jsonl")) as f:
        markers = [json.loads(ln) for ln in f if ln.strip() and ln.strip().endswith("}")]
    n_completed = {}
    for rec in markers:
        if rec.get("marker") == "completed":
            n_completed[rec["id"]] = n_completed.get(rec["id"], 0) + 1
    assert n_completed == {"cr1": 1, "cr2": 1}
    for rid, ref_sol in crash_reference.items():
        got = _solution(os.path.join(eng, "outputs", f"{rid}.h5"))
        for key in sorted(ref_sol):
            np.testing.assert_array_equal(got[key], ref_sol[key],
                                          err_msg=f"{marker}/{rid}/{key}")


def test_serve_fault_sites_end_to_end(drill_world, tmp_path):
    """The four engine fault sites through one real serve process:
    state.checkpoint -> the startup checkpoint's retries run out, a loud
    event, and the engine keeps serving; request.parse -> a malformed
    rejection; journal.append -> retried in place; session.attach -> FAILED
    outcomes that quarantine the tenant (and only that tenant)."""
    eng = str(tmp_path / "eng")
    env = _env({
        "SART_FAULT": "request.parse:io:1:1,journal.append:io:1:2,"
                      "session.attach:error:1:2,state.checkpoint:io:1:3",
        "SART_RETRY_BASE_DELAY": "0.01",
    })
    proc, lines = _start_serve(_serve_cmd(drill_world, eng, "--quarantine_after", "2"), env)
    _drain_stdout(proc, lines)
    try:
        def submit(rid, tenant):
            return _submit(eng, "--id", rid, "--tenant", tenant, "--wait", "90")

        p1 = submit("p1", "noisy")
        assert p1.returncode == 1, p1.stdout + p1.stderr
        assert json.loads(p1.stdout)["reason"] == req_mod.REASON_MALFORMED
        f1 = submit("f1", "noisy")
        assert f1.returncode == 3, f1.stdout + f1.stderr
        assert json.loads(f1.stdout)["outcome"]["status"] == "failed"
        f2 = submit("f2", "noisy")
        assert json.loads(f2.stdout)["outcome"]["status"] == "failed"
        f3 = submit("f3", "noisy")
        assert f3.returncode == 3
        assert json.loads(f3.stdout)["reason"] == req_mod.REASON_TENANT_QUARANTINED
        ok = submit("ok", "calm")
        assert ok.returncode == 0, ok.stdout + ok.stderr
        assert json.loads(ok.stdout)["outcome"]["status"] == "completed"
    finally:
        rc = _stop(proc)
    assert rc == 4
    text = "".join(lines)
    assert "state checkpoint failed" in text
    completed, pending = journal_mod.RequestJournal(os.path.join(eng, "journal.jsonl")).replay()
    assert set(completed) == {"f1", "f2", "ok"} and not pending
    # the later checkpoints landed: the quarantine survives a restart
    state = state_mod.StateStore(os.path.join(eng, "state.jsonl")).load()
    assert state["admission"]["tenants"]["noisy"]["quarantined_unix"] > 0


def test_request_fields_round_trip():
    """The record's fields, in the JAX order, through to_dict."""
    req = Request(id="x", tenant="t", time_range="0:1", deadline_s=1.0,
                  submitted_unix=2.0, trace="tr", handoff=True)
    assert list(req.to_dict()) == list(jreq.Request(id="x").to_dict())
    assert Request(**req.to_dict()) == req
    with pytest.raises(RequestError):
        parse_request({"id": "x", "submitted_unix": "soon"})
    assert time.time() - parse_request({"id": "y"}).submitted_unix < 60
