"""The port's chaos harness (``chaos``) against the JAX package's, and the
serve campaign through the port's supervised workers on the CPU.

Ported from ``tests/test_chaos.py``: ``FaultSchedule`` draws the JAX
schedule for every seed (faults, kill plan, slowed windows), from the safe
fault pool only; ``line_window`` reads the same windows from the same lines;
the CLI's usage errors carry the JAX words and exit codes; the judge has
teeth (a doubled completed marker and a lost request each violate an
invariant). The pod campaign (``--pod N``) is tested in
``tests/test_torch_pod_chaos.py``. End to end: ``chaos`` on the JAX CI seeds through the
port's ``serve --supervised``: every seed's kill fired, restarts within the
kills, each request exactly once, outputs byte-identical to an undisturbed
run, the counters and the SLO pair continuous across incarnations.
"""

import json
import os

import pytest

import fixtures as fx

from sartsolver_tpu.resilience import chaos as jchaos

from sartsolver_tpu_torch.resilience import chaos as chaos_mod
from sartsolver_tpu_torch.resilience.chaos import (
    FAULT_POOL,
    CampaignError,
    ChaosCampaign,
    FaultSchedule,
    chaos_main,
    line_window,
)

# the JAX suite's bounded CI seed set (tests/test_chaos.py)
CI_SEEDS = "3,5"


# ---------------------------------------------------------------------------
# the schedule and the windows against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_kills,max_faults", [(2, 2), (1, 2), (3, 1)])
def test_schedule_matches_jax_per_seed(max_kills, max_faults):
    assert FAULT_POOL == jchaos.FAULT_POOL
    assert chaos_mod.KILL_WINDOWS == jchaos.KILL_WINDOWS
    for seed in range(16):
        ours = FaultSchedule(seed, max_kills=max_kills, max_faults=max_faults)
        theirs = jchaos.FaultSchedule(seed, max_kills=max_kills, max_faults=max_faults)
        assert ours.faults == theirs.faults
        assert ours.kills == theirs.kills
        assert ours.describe() == theirs.describe()
        assert ours.fault_spec() == theirs.fault_spec()
        assert ours.window_env() == theirs.window_env()


def test_schedule_deterministic_per_seed():
    for seed in range(8):
        a, b = FaultSchedule(seed), FaultSchedule(seed)
        assert a.describe() == b.describe()
        assert a.fault_spec() == b.fault_spec()
        assert a.window_env() == b.window_env()
    assert len({FaultSchedule(s).fault_spec() for s in range(16)}) > 1


def test_schedule_draws_from_safe_pool_only():
    from sartsolver_tpu_torch.resilience.faults import parse_fault_spec

    sites = {site for site, _kind in FAULT_POOL}
    for seed in range(16):
        sched = FaultSchedule(seed)
        armed = parse_fault_spec(sched.fault_spec())  # a valid spec of the port
        assert set(armed) <= sites
        for window, occurrence in sched.kills:
            assert window in chaos_mod.KILL_WINDOWS
            assert 1 <= occurrence <= 3


@pytest.mark.parametrize("line", [
    "SART_JOURNAL_POINT accepted\n",
    "SART_JOURNAL_POINT dispatched worker=w1\n",
    "SART_JOURNAL_POINT pre-flush\n",
    "SART_JOURNAL_POINT handoff\n",
    "SART_CKPT_POINT pre-append\n",
    "SART_RESPONSE_POINT r1 state=done\n",
    "SART_RESPONSE_POINT r1 state=pending\n",
    "SART_RESPONSE_POINT r1 state=none\n",
    "engine: session resident\n",
    "sartsolve supervisor: worker-spawn pid=12 spawn=1\n",
])
def test_line_window_matches_jax(line):
    assert line_window(line) == jchaos.line_window(line)


def test_line_window_parsing():
    assert line_window("SART_JOURNAL_POINT accepted\n") == "accepted"
    assert line_window("SART_JOURNAL_POINT pre-flush\n") == "pre-flush"
    assert line_window("SART_CKPT_POINT pre-append\n") == "ckpt"
    # only COMPLETION responses are the 'response' kill window
    assert line_window("SART_RESPONSE_POINT r1 state=done\n") == "response"
    assert line_window("SART_RESPONSE_POINT r1 state=pending\n") is None
    assert line_window("engine: session resident\n") is None


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--engine_dir", "x"],                                   # no serve args
    ["--engine_dir", "x", "--seeds", "nope", "--", "f.h5"],
    ["--engine_dir", "x", "--seeds", ",", "--", "f.h5"],
    ["--engine_dir", "x", "--requests", "0", "--", "f.h5"],
    ["--engine_dir", "x", "--max_kills", "0", "--", "f.h5"],
    ["--engine_dir", "x", "--fleet", "1", "--", "f.h5"],
    ["--engine_dir", "x", "--pod", "1", "--", "f.h5"],
    ["--engine_dir", "x", "--pod", "-3", "--", "f.h5"],
    ["--engine_dir", "x", "--pod", "2", "--fleet", "2", "--", "f.h5"],
])
def test_chaos_cli_usage_errors_match_jax(argv, capsys):
    assert chaos_main(argv) == 1
    ours = capsys.readouterr().err
    assert jchaos.chaos_main(argv) == 1
    assert ours == capsys.readouterr().err


def test_chaos_cli_unknown_flag_exits_1(capsys):
    with pytest.raises(SystemExit) as err:
        chaos_main(["--seeds", "1", "--", "f.h5"])  # --engine_dir missing
    assert err.value.code == 1


# ---------------------------------------------------------------------------
# the judge's teeth
# ---------------------------------------------------------------------------

def _campaign(tmp_path):
    campaign = ChaosCampaign(root=str(tmp_path), serve_args=["x.h5"],
                             requests=[{"id": "a", "tenant": "t0"}], slo_ms=None, timeout=10.0)
    campaign.reference = {"a": {"datasets": {}, "status": "completed"}}
    seed_dir = str(tmp_path / "seed0")
    os.makedirs(seed_dir)
    return campaign, seed_dir


def test_judge_catches_double_solve(tmp_path):
    """The exactly-once gate has teeth: a journal showing two completed
    markers for one id violates the invariant loudly."""
    campaign, seed_dir = _campaign(tmp_path)
    with open(os.path.join(seed_dir, "journal.jsonl"), "w") as f:
        f.write(json.dumps({"marker": "accepted", "id": "a", "unix": 1.0,
                            "request": {"id": "a"}}) + "\n")
        for _ in range(2):  # double solve
            f.write(json.dumps({"marker": "completed", "id": "a", "unix": 2.0,
                                "outcome": {}}) + "\n")
    with pytest.raises(CampaignError, match="double-solved"):
        campaign._judge(seed_dir, FaultSchedule(0), kills_fired=1, text="")


def test_judge_catches_lost_request(tmp_path):
    campaign, seed_dir = _campaign(tmp_path)
    with open(os.path.join(seed_dir, "journal.jsonl"), "w") as f:
        f.write(json.dumps({"marker": "accepted", "id": "a", "unix": 1.0,
                            "request": {"id": "a"}}) + "\n")
    with pytest.raises(CampaignError, match="journal shows"):
        campaign._judge(seed_dir, FaultSchedule(0), kills_fired=0, text="")


def test_judge_catches_restarts_past_the_kills(tmp_path, monkeypatch):
    """A worker crashing on its own (more restarts than kills) breaks the
    bounded-unavailability invariant."""
    from sartsolver_tpu_torch.engine.journal import RequestJournal
    from sartsolver_tpu_torch.engine.request import parse_request

    campaign, seed_dir = _campaign(tmp_path)
    req = parse_request({"id": "a", "tenant": "t0"})
    j = RequestJournal(os.path.join(seed_dir, "journal.jsonl"))
    j.accepted(req)
    j.completed(req, {"state": "done"})
    os.makedirs(os.path.join(seed_dir, "responses"))
    with open(os.path.join(seed_dir, "responses", "a.json"), "w") as f:
        json.dump({"id": "a", "state": "done", "outcome": {"status": "completed"}}, f)
    monkeypatch.setattr(chaos_mod, "_solution_datasets", lambda path: {})
    with pytest.raises(CampaignError, match="crashing on its own"):
        campaign._judge(seed_dir, FaultSchedule(0), kills_fired=1,
                        text="sartsolve supervisor: worker-crash code=-9\n" * 2)


# ---------------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------------

def test_chaos_campaign_ci_seed_set(tmp_path, capsys):
    """Randomized fault schedules and SIGKILLs against the port's supervised
    engine, on the JAX CI seed set: the four invariants hold on every
    seed, and each seed ran the JAX schedule."""
    world = str(tmp_path / "world")
    os.makedirs(world)
    paths, *_ = fx.write_world(world, n_frames=4)
    report_path = str(tmp_path / "report.json")
    rc = chaos_main([
        "--engine_dir", str(tmp_path / "camp"),
        "--seeds", CI_SEEDS, "--requests", "4",
        "--slo_ms", "300000", "--timeout", "120",
        "--report", report_path, "--",
        "--use_cpu", "-m", "40", "-c", "1e-12", "--lanes", "2",
        paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"],
        paths["img_a"], paths["img_b"],
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    report = json.load(open(report_path))
    assert report["verdict"] == "ok"
    assert len(report["passes"]) == len(CI_SEEDS.split(","))
    for verdict, seed in zip(report["passes"], CI_SEEDS.split(",")):
        assert {k: verdict[k] for k in ("seed", "faults", "kills")} == \
            jchaos.FaultSchedule(int(seed)).describe()
        assert verdict["verdict"] == "ok"
        assert verdict["kills_fired"] >= 1  # every seed really killed
        assert verdict["restarts"] <= verdict["kills_fired"]
        assert verdict["requests_total"] == {"completed": 4.0}
        # the supervisor counted each restart by its reason
        prom = open(tmp_path / "camp" / f"seed{seed}" / "supervisor.prom").read()
        assert (f'sart_engine_restarts_total{{reason="signal:SIGKILL"}} '
                f'{verdict["restarts"]}') in prom
