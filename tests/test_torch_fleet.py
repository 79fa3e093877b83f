"""The port's fleet controller (``fleet``) against the JAX package's, and the
fleet chaos campaign through the port's workers on the CPU.

Ported from ``tests/test_fleet.py``: the controller's failover (the handoff
marker first, then the re-stage on a survivor), its recovery of an
interrupted handoff, its intake routing and its choice of survivor, driven
directly against on-disk journals (no processes); the event log's rotation;
``FleetSchedule`` equal to the JAX schedule for every seed; the ``fleet``
parser's usage errors with the JAX words and exit codes. End to end:
``chaos --fleet 2`` on the JAX CI seeds through the port's workers
(``python -m sartsolver_tpu_torch.cli fleet``), every seed's worker kill
fired, exactly once fleet-wide, the outputs byte-identical to an undisturbed
run, the counters continuous.
"""

import json
import os

import pytest

import fixtures as fx

from sartsolver_tpu.engine import cli as jcli
from sartsolver_tpu.resilience import chaos as jchaos

from sartsolver_tpu_torch.engine import routing as routing_mod
from sartsolver_tpu_torch.engine.cli import fleet_cli_main
from sartsolver_tpu_torch.engine.request import Request
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.resilience.chaos import FleetSchedule, chaos_main
from sartsolver_tpu_torch.resilience.supervisor import (
    DEFAULT_ROTATE_BYTES,
    FleetController,
    rotate_events,
)

# the JAX chaos suite's CI seeds (tests/test_chaos.py), at M = 2
FLEET_SEEDS = "3,5"
FLEET_SIZE = 2


def _req(rid, tenant="default", handoff=False):
    return Request(id=rid, tenant=tenant, time_range="", deadline_s=None,
                   submitted_unix=0.0, trace="", handoff=handoff)


# ---------------------------------------------------------------------------
# event-log rotation
# ---------------------------------------------------------------------------

def test_rotate_events_keeps_newest_tail(tmp_path):
    path = str(tmp_path / "fleet.jsonl")
    lines = [json.dumps({"kind": "tick", "n": i}) + "\n" for i in range(500)]
    with open(path, "w") as f:
        f.writelines(lines)
    limit = 2048
    assert rotate_events(path, limit) > 0
    size = os.path.getsize(path)
    assert 0 < size <= limit
    kept = open(path).read().splitlines()
    # the newest records survive, whole lines only
    assert json.loads(kept[-1])["n"] == 499
    assert all(json.loads(ln)["n"] >= 400 for ln in kept)
    assert rotate_events(path, limit) == 0  # under limit: no-op
    assert rotate_events(path, 0) == 0  # rotation disabled
    assert DEFAULT_ROTATE_BYTES > 0


# ---------------------------------------------------------------------------
# the controller (direct API: on-disk journals, no processes)
# ---------------------------------------------------------------------------

class _FakeProc:
    def __init__(self, pid=4242):
        self.pid = pid

    def poll(self):
        return None


def _controller(tmp_path, size=3):
    obs_metrics.reset_registry()
    return FleetController([], fleet_dir=str(tmp_path / "fleet"), size=size)


def _mark_up(fc, k):
    fc.workers[k]["proc"] = _FakeProc(pid=5000 + k)
    fc.workers[k]["state"] = "up"


def test_fleet_failover_marker_first_then_restage(tmp_path):
    fc = _controller(tmp_path)
    _mark_up(fc, 1)
    j0 = fc._journal(0)
    j0.accepted(_req("a", tenant="t1"))
    j0.accepted(_req("done", tenant="t1"))
    j0.completed(_req("done"), {"state": "done"})
    # a partial output from the dead worker's interrupted attempt
    partial = os.path.join(fc.outputs_dir, "a.h5")
    open(partial, "wb").write(b"torn")
    fc._failover(0)
    # the handoff marker landed in the DEAD worker's journal, target=1
    _, pending, handed = j0.replay_full()
    assert not pending and handed["a"]["target"] == 1
    # the payload re-staged on the survivor with the affinity bypass set
    staged = os.path.join(fc.workers[1]["dir"], "ingest", "a.json")
    payload = json.load(open(staged))
    assert payload["handoff"] is True and payload["tenant"] == "t1"
    assert not os.path.exists(partial)  # the survivor writes it fresh
    assert not os.path.exists(os.path.join(fc.workers[1]["dir"], "ingest", "done.json"))
    table = routing_mod.read_routing(fc.fleet_dir)
    assert [r["state"] for r in table["workers"]] == ["down", "up", "down"]
    kinds = [json.loads(ln)["kind"] for ln in open(fc.events_path)]
    assert kinds == ["handoff"]


def test_fleet_failover_no_survivor_skips(tmp_path, capsys):
    """Nobody alive to hand off to: the respawned worker replays its own
    journal, and no handoff marker is written."""
    fc = _controller(tmp_path)
    j0 = fc._journal(0)
    j0.accepted(_req("a"))
    fc._failover(0)
    _, pending, handed = j0.replay_full()
    assert [r.id for r in pending] == ["a"] and not handed
    assert "handoff-skipped" in capsys.readouterr().err


def test_fleet_recover_restages_interrupted_handoff(tmp_path):
    """A controller crash between the handoff marker and the re-stage: a
    fresh incarnation's _recover() finishes the job, and a second pass is a
    no-op (needs_restage sees the staged copy)."""
    fc = _controller(tmp_path)
    j0 = fc._journal(0)
    j0.accepted(_req("a", tenant="t1"))
    j0.handoff("a", 2)  # marker durable, re-stage never happened
    fc2 = FleetController([], fleet_dir=fc.fleet_dir, size=3)
    fc2._recover()
    staged = os.path.join(fc2.workers[2]["dir"], "ingest", "a.json")
    assert json.load(open(staged))["handoff"] is True
    before = os.path.getmtime(staged)
    fc2._recover()  # idempotent: staged copy exists, no rewrite
    assert os.path.getmtime(staged) == before


def test_fleet_recover_skips_completed_anywhere(tmp_path):
    """The survivor already completed the handed-off request before the
    controller crashed: recovery must not resurrect it."""
    fc = _controller(tmp_path)
    fc._journal(0).accepted(_req("a"))
    fc._journal(0).handoff("a", 1)
    fc._journal(1).completed(_req("a", handoff=True), {"state": "done"})
    fc2 = FleetController([], fleet_dir=fc.fleet_dir, size=3)
    fc2._recover()
    assert not os.path.exists(os.path.join(fc2.workers[1]["dir"], "ingest", "a.json"))


def test_fleet_recover_reads_a_jax_journal(tmp_path):
    """The journal is the JAX format: a handoff the JAX engine's journal
    recorded is re-staged by the port's controller."""
    from sartsolver_tpu.engine.journal import RequestJournal as JaxJournal
    from sartsolver_tpu.engine.request import Request as JaxRequest

    fc = _controller(tmp_path)
    jj = JaxJournal(os.path.join(fc.workers[0]["dir"], "journal.jsonl"))
    jj.accepted(JaxRequest(id="a", tenant="t1", time_range="", deadline_s=None,
                           submitted_unix=0.0, trace="", handoff=False))
    jj.handoff("a", 1)
    fc._recover()
    staged = json.load(open(os.path.join(fc.workers[1]["dir"], "ingest", "a.json")))
    assert staged["handoff"] is True and staged["tenant"] == "t1"


def test_fleet_intake_routes_by_affinity(tmp_path):
    fc = _controller(tmp_path)
    for k in range(3):
        _mark_up(fc, k)
    tenant = "t-intake"
    home = routing_mod.tenant_worker(tenant, 3)
    with open(os.path.join(fc.ingest_dir, "r1.json"), "w") as f:
        json.dump({"id": "r1", "tenant": tenant}, f)
    with open(os.path.join(fc.ingest_dir, "torn.json"), "w") as f:
        f.write('{"id": "r2"')  # mid-write; picked up next pass
    assert fc._pump_intake() == 1
    routed = os.path.join(fc.workers[home]["dir"], "ingest", "r1.json")
    payload = json.load(open(routed))
    assert "handoff" not in payload  # affinity target: no bypass needed
    assert not os.path.exists(os.path.join(fc.ingest_dir, "r1.json"))
    assert os.path.exists(os.path.join(fc.ingest_dir, "torn.json"))


def test_fleet_intake_falls_back_to_survivor(tmp_path):
    fc = _controller(tmp_path)
    tenant = "t-intake"
    home = routing_mod.tenant_worker(tenant, 3)
    survivor = (home + 1) % 3
    _mark_up(fc, survivor)  # the affinity worker stays down
    with open(os.path.join(fc.ingest_dir, "r1.json"), "w") as f:
        json.dump({"id": "r1", "tenant": tenant}, f)
    assert fc._pump_intake() == 1
    routed = os.path.join(fc.workers[survivor]["dir"], "ingest", "r1.json")
    assert json.load(open(routed))["handoff"] is True


def test_fleet_intake_holds_when_fleet_dark(tmp_path):
    """No worker alive: the request stays in the controller intake for the
    next loop instead of being dropped."""
    fc = _controller(tmp_path)
    with open(os.path.join(fc.ingest_dir, "r1.json"), "w") as f:
        json.dump({"id": "r1", "tenant": "t"}, f)
    assert fc._pump_intake() == 0
    assert os.path.exists(os.path.join(fc.ingest_dir, "r1.json"))


def test_fleet_pick_survivor_prefers_least_backlog(tmp_path):
    fc = _controller(tmp_path)
    for k in (1, 2):
        _mark_up(fc, k)
    for i in range(3):
        open(os.path.join(fc.workers[1]["dir"], "ingest", f"q{i}.json"), "w").close()
    assert fc._pick_survivor(exclude=0) == 2
    assert fc._pick_survivor(exclude=2) == 1
    assert fc._pick_survivor(exclude=0) == fc._pick_survivor(exclude=0)
    for k in (1, 2):
        fc.workers[k]["state"] = "down"
    assert fc._pick_survivor(exclude=0) is None


def test_fleet_routing_table_matches_jax(tmp_path):
    """The routing table the controller publishes is the JAX controller's,
    field for field (clients of either package read it)."""
    from sartsolver_tpu.obs import metrics as jmetrics
    from sartsolver_tpu.resilience.supervisor import FleetController as JaxController

    fc = _controller(tmp_path, size=2)
    jmetrics.reset_registry()
    jfc = JaxController([], fleet_dir=str(tmp_path / "jfleet"), size=2, base_port=9000)
    fc.base_port = 9000
    _mark_up(fc, 1)
    jfc.workers[1]["proc"] = _FakeProc(pid=5001)
    jfc.workers[1]["state"] = "up"
    fc._publish_routing()
    jfc._publish_routing()
    ours = routing_mod.read_routing(fc.fleet_dir)
    theirs = routing_mod.read_routing(jfc.fleet_dir)
    for table, root in ((ours, fc.fleet_dir), (theirs, jfc.fleet_dir)):
        table.pop("unix", None)
        for key in ("responses_dir", "ingest_dir"):
            table[key] = os.path.relpath(table[key], root)
        for row in table["workers"]:
            row["ingest_dir"] = os.path.relpath(row["ingest_dir"], root)
    assert ours == theirs


# ---------------------------------------------------------------------------
# the schedule and the parser against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [2, 3])
def test_fleet_schedule_matches_jax(size):
    for seed in range(16):
        ours, theirs = FleetSchedule(seed, size=size), jchaos.FleetSchedule(seed, size=size)
        assert ours.describe() == theirs.describe()
        assert (ours.window, ours.occurrence, ours.kill_controller_in_handoff,
                ours.evict_every, ours.size) == (
            theirs.window, theirs.occurrence, theirs.kill_controller_in_handoff,
            theirs.evict_every, theirs.size)
    kills = {FleetSchedule(s).kill_controller_in_handoff for s in range(24)}
    assert kills == {True, False}  # both flavours reachable


@pytest.mark.parametrize("argv", [
    ["--fleet_dir", "f", "--size", "0", "--", "x.h5"],
    ["--fleet_dir", "f", "--restart_backoff", "-1", "--", "x.h5"],
    ["--fleet_dir", "f", "--poll_interval", "0", "--", "x.h5"],
    ["--fleet_dir", "f", "--max_restarts", "-2", "--", "x.h5"],
    ["--fleet_dir", "f", "--base_port", "65535", "--size", "3", "--", "x.h5"],
    ["--fleet_dir", "f", "--", "--engine_dir", "e", "x.h5"],
    ["--fleet_dir", "f", "--", "--http_port=9000", "x.h5"],
    ["--fleet_dir", "f", "--", "--supervised", "x.h5"],
    ["--fleet_dir", "f", "--", "--worker_index", "0", "x.h5"],
])
def test_fleet_cli_usage_errors_match_jax(argv, capsys):
    assert fleet_cli_main(argv) == 1
    ours = capsys.readouterr().err
    assert jcli.fleet_cli_main(argv) == 1
    assert ours == capsys.readouterr().err


def test_fleet_cli_missing_fleet_dir_exits_1(capsys):
    with pytest.raises(SystemExit) as err:
        fleet_cli_main(["--", "x.h5"])
    assert err.value.code == 1
    assert "--fleet_dir" in capsys.readouterr().err


def test_fleet_chaos_cli_rejects_bad_fleet_size(tmp_path):
    assert chaos_main(["--engine_dir", str(tmp_path), "--fleet", "1", "--", "x.h5"]) == 1
    assert chaos_main(["--engine_dir", str(tmp_path), "--fleet", "-2", "--", "x.h5"]) == 1


# ---------------------------------------------------------------------------
# the fleet campaign
# ---------------------------------------------------------------------------

def test_fleet_chaos_campaign_ci_seed_set(tmp_path, capsys):
    """M = 2 of the port's workers under the port's controller, a seeded
    SIGKILL inside a journal commit window, forced session evictions
    throughout: exactly once, byte-identical, counters continuous
    fleet-wide."""
    world = str(tmp_path / "world")
    os.makedirs(world)
    paths, *_ = fx.write_world(world, n_frames=4)
    report_path = str(tmp_path / "report.json")
    rc = chaos_main([
        "--engine_dir", str(tmp_path / "camp"), "--fleet", str(FLEET_SIZE),
        "--seeds", FLEET_SEEDS, "--slo_ms", "300000",
        # each pass's wait: generous, as it bounds the run under the test
        # suite's load and is no correctness bar (alone a pass takes ~15 s)
        "--timeout", "600", "--report", report_path, "--",
        "--use_cpu", "-m", "40", "-c", "1e-12", "--lanes", "2",
        paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"],
        paths["img_a"], paths["img_b"],
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    report = json.load(open(report_path))
    assert report["verdict"] == "ok"
    assert report["fleet"] == FLEET_SIZE
    n_requests = 2 * FLEET_SIZE + 2
    assert report["requests"] == n_requests
    assert len(report["passes"]) == len(FLEET_SEEDS.split(","))
    for verdict, seed in zip(report["passes"], FLEET_SEEDS.split(",")):
        schedule = jchaos.FleetSchedule(int(seed), size=FLEET_SIZE).describe()
        assert {k: verdict[k] for k in schedule} == schedule
        assert verdict["verdict"] == "ok"
        assert verdict["kills_fired"] >= 1  # every seed really killed
        assert verdict["restarts"] <= verdict["kills_fired"]
        assert verdict["evictions"] >= 1  # forced churn actually fired
        assert verdict["requests"] == n_requests  # 2*M + 2, exactly once each
        assert verdict["requests_total"] == {"completed": float(n_requests)}
    # each controller respawned its killed worker
    for seed in FLEET_SEEDS.split(","):
        events = [json.loads(ln) for ln in open(tmp_path / "camp" / f"fleet{seed}"
                                                / "fleet.jsonl")]
        assert sum(e["kind"] == "worker-spawn" for e in events) >= FLEET_SIZE + 1
