"""``chaos --pod 2`` through the port's fake-pod workers, on the JAX CI seeds.

The JAX suite's bounded seed pair (``tests/test_pod.py``): seed 0 kills host
0 inside a checkpoint's held-open append (the record is not durable, so the
pod falls back below the killed serial), seed 3 kills host 1 at a stride
rendezvous. Each seed: the survivor exits 3 at the barrier deadline
(``SART_POD_BARRIER_TIMEOUT=10``) naming the dead host, within the deadline
plus 15 s of the kill; the whole pod resumes from one agreed serial without
re-running a stride, byte-identical to the undisturbed reference; the
checkpoint counters hold. Also: the judge refuses a resume that re-ran a
stride, divergent resume serials, and a ``ckpt`` kill resumed at or past
the killed serial. (The usage errors of ``--pod`` are among
``test_torch_chaos.py``'s, against the JAX words.)
"""

import json

import pytest

import fixtures as fx
from sartsolver_tpu.resilience import chaos as jchaos

from sartsolver_tpu_torch.resilience.chaos import (
    CampaignError, PodCampaign, PodSchedule, chaos_main,
)

POD_SEEDS = "0,3"
DEADLINE = 10


@pytest.fixture(scope="module")
def pod_world(tmp_path_factory):
    td = tmp_path_factory.mktemp("pod_chaos_world")
    paths, *_ = fx.write_world(str(td), with_laplacian=True, n_frames=10)
    return paths


def _solver_args(paths):
    return [paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"], paths["img_a"], paths["img_b"],
            "--use_cpu", "-m", "40", "-c", "1e-12", "-l", paths["laplacian"], "-b", "0.001",
            "--max_cached_solutions", "1", "--no_guess", "--batch_frames", "4"]


def test_pod_chaos_ci_seed_pair(pod_world, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("SART_POD_BARRIER_TIMEOUT", str(DEADLINE))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    report_path = str(tmp_path / "report.json")
    rc = chaos_main(["--engine_dir", str(tmp_path / "camp"), "--pod", "2", "--seeds",
                     POD_SEEDS, "--timeout", "240", "--report", report_path, "--",
                     *_solver_args(pod_world)])
    out = capsys.readouterr().out
    assert rc == 0, out
    with open(report_path) as f:
        report = json.load(f)
    assert report["verdict"] == "ok" and report["pod"] == 2
    assert [v["seed"] for v in report["passes"]] == [0, 3]
    for verdict in report["passes"]:
        want = jchaos.PodSchedule(verdict["seed"], size=2).describe()
        assert {k: verdict[k] for k in want} == want
        assert verdict["verdict"] == "ok" and verdict["hosts"] == 2
        assert verdict["resumed_serial"] >= 1
        assert verdict["barrier_timeout_s"] == DEADLINE
        assert all(DEADLINE * 0.9 <= s < DEADLINE + 15
                   for s in verdict["survivor_exit_after_kill_s"])
        if verdict["window"].startswith("ckpt"):
            assert verdict["resumed_serial"] < verdict["killed_serial"]
    assert out.count("chaos: pod seed") >= 2


def test_pod_judge_refuses_a_rerun_stride(tmp_path):
    campaign = PodCampaign(root=str(tmp_path), solve_args=["x.h5"], size=2, timeout=10)
    campaign.reference = {}
    errs = ["SART_POD_POINT resume serial=4\nSART_POD_POINT stride serial=4\n"] * 2
    with pytest.raises(CampaignError, match="a completed stride was re-run"):
        campaign._judge_pod(PodSchedule(3), [], [], errs, killed_serial=4)
    errs = ["SART_POD_POINT resume serial=4\n", "SART_POD_POINT resume serial=2\n"]
    with pytest.raises(CampaignError, match="divergent serials"):
        campaign._judge_pod(PodSchedule(3), [], [], errs, killed_serial=4)
    errs = ["SART_POD_POINT resume serial=4\n"] * 2
    with pytest.raises(CampaignError, match="yet the pod resumed from serial 4"):
        campaign._judge_pod(PodSchedule(0), [], [], errs, killed_serial=4)
