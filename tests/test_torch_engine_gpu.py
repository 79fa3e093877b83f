"""The serving engine on the card: every served frame through the hand
kernels, byte for byte the one-shot CLI's.

Needs a CUDA device and ``nvcc``: every test is marked ``gpu`` and skips
without a card. Run on the card with
``python -m pytest -q --noconftest -m gpu tests/test_torch_engine_gpu.py``.
This file imports no JAX and no h5py.

The world is chip_smoke.py's at P = V = 4096 (cameras of 64 x 32, a 64 x 64
grid), where ``plan_sweep`` gives ``one_read`` at B = 2 and 4 for every
storage type. A served request's rows equal the CLI's ``--no_guess
--batch_frames <lanes>`` rows over the same time range for fp32, bf16 and
int8, and every launch of the served frames is on that plan; the deadline
shed retires lanes as -5 while the co-batched request completes; a device
OOM, injected or raised by the allocator, halves the lanes instead of
failing the request; evicting a session gives its device memory back;
the warm-up stride's launches stay out of the server's counts.
"""

import contextlib
import gc
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 200


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    return cs.write_world(str(tmp_path_factory.mktemp("engine_gpu")), nx=64, ny=64,
                          cam=(64, 32), n_frames=8)


def _inputs(world):
    p = world["paths"]
    return [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]


def _session(world, *flags):
    from sartsolver_tpu_torch.cli import _validate
    from sartsolver_tpu_torch.engine.cli import build_serve_parser
    from sartsolver_tpu_torch.engine.session import ResidentSession

    args = build_serve_parser().parse_args(
        ["--engine_dir", "/unused", "-m", str(CAP), "-l", world["paths"]["laplacian"],
         *flags, *_inputs(world)])
    _validate(args)
    return ResidentSession.build(args)


def _serve(session, eng_dir, requests, lanes=2):
    from sartsolver_tpu_torch.engine.admission import AdmissionController
    from sartsolver_tpu_torch.engine.server import EngineServer
    from sartsolver_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.reset_registry()
    os.makedirs(os.path.join(eng_dir, "ingest"), exist_ok=True)
    for i, payload in enumerate(requests):
        with open(os.path.join(eng_dir, "ingest", f"{i:03d}.json"), "w") as f:
            json.dump(payload, f)
    server = EngineServer(session, engine_dir=eng_dir, lanes=lanes,
                          admission=AdmissionController(max_queue=16),
                          poll_interval=0.05, idle_exit=0.5)
    assert server.run() == 0
    return server


def _outcome(eng_dir, rid):
    with open(os.path.join(eng_dir, "responses", f"{rid}.json")) as f:
        return json.load(f)["outcome"]


def _rows(path):
    from sartsolver_tpu_torch.io import h5

    with h5.File(path, "r") as f:
        return {k: f["solution"][k][:] for k in f["solution"]}


def _cli(world, out, *flags):
    from sartsolver_tpu_torch.cli import main

    assert main(["-o", out, *_inputs(world), "-m", str(CAP), "-l", world["paths"]["laplacian"],
                 *flags]) == 0
    return _rows(out)


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for key in sorted(b):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_served_rows_equal_the_cli_on_the_card(world, tmp_path, storage):
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, plan_sweep, reset_launch_counts

    session = _session(world, "--rtm_dtype", storage)
    P, V = world["H"].shape
    plan = plan_sweep(P, V, 2, storage)
    assert plan == "one_read"
    reset_launch_counts()
    eng = str(tmp_path / "eng")
    _serve(session, eng, [{"id": "r1", "tenant": "a", "time_range": "0:0.35"},
                          {"id": "r2", "tenant": "b", "time_range": "0.4:0.75"}])
    served = {plan_: n for plan_, n in fused_sweep.launches_by_plan.items() if n}
    iters = 0  # the longest frame: at least one launch a loop step
    for rid, rng in (("r1", "0:0.35"), ("r2", "0.4:0.75")):
        assert _outcome(eng, rid)["status"] == "completed"
        got = _rows(os.path.join(eng, "outputs", f"{rid}.h5"))
        _assert_same(got, _cli(world, str(tmp_path / f"{rid}.h5"), "--rtm_dtype", storage,
                               "-t", rng, "--no_guess", "--batch_frames", "2"))
        iters = max(iters, int(got["iterations"].max()))
    # every served launch on the plan of B = 2
    assert set(served) == {plan} and served[plan] >= iters > 0
    session.close()


@pytest.mark.gpu
def test_deadline_shed_on_the_card(world, tmp_path):
    from sartsolver_tpu_torch.obs import metrics as obs_metrics

    # a tolerance below reach: each frame runs for seconds, past the deadline
    session = _session(world, "-c", "1e-300", "-m", "50000")
    eng = str(tmp_path / "eng")
    _serve(session, eng, [{"id": "hurried", "tenant": "a", "time_range": "0:0.35",
                           "deadline_s": 0.2},
                          {"id": "patient", "tenant": "b", "time_range": "0.4:0.45"}])
    hurried, patient = _outcome(eng, "hurried"), _outcome(eng, "patient")
    assert hurried["status"] == "shed-deadline" and set(hurried["by_status"]) == {"deadline"}
    assert patient["status"] == "completed"
    rows = _rows(os.path.join(eng, "outputs", "hurried.h5"))
    assert (rows["status"] == -5).all() and np.isfinite(rows["value"]).all()
    assert obs_metrics.get_registry().counter("sched_deadline_shed_total").value == 4
    session.close()


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["injected", "allocator"])
def test_oom_halves_the_lanes_on_the_card(world, tmp_path, monkeypatch, source):
    """Both OOMs reach the lane-halving ladder through
    ``resilience/degrade.py:is_resource_exhausted``, never a FAILED
    request; the rows are the CLI's at the halved lane count."""
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
    from sartsolver_tpu_torch.resilience import faults

    session = _session(world)
    eng = str(tmp_path / "eng")
    if source == "injected":
        ctx = faults.injected(faults.SITE_SOLVE, "oom", 1.0, count=1)
    else:
        real = DistributedSARTSolver.sched_step
        state = {"raised": False}

        def once(self, *a, **kw):
            if not state["raised"]:
                state["raised"] = True
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
            return real(self, *a, **kw)

        monkeypatch.setattr(DistributedSARTSolver, "sched_step", once)
        ctx = contextlib.nullcontext()
    with ctx:
        server = _serve(session, eng, [{"id": "o1", "tenant": "a", "time_range": "0:0.35"}])
    assert server.lanes == 1 and server.admission.degraded_reason is not None
    out = _outcome(eng, "o1")
    assert out["status"] == "completed" and out["frames"] == 4
    monkeypatch.undo()
    _assert_same(_rows(os.path.join(eng, "outputs", "o1.h5")),
                 _cli(world, str(tmp_path / "cli.h5"), "-t", "0:0.35", "--no_guess",
                      "--batch_frames", "1"))
    session.close()


@pytest.mark.gpu
def test_eviction_gives_the_device_memory_back(world, tmp_path):
    from sartsolver_tpu_torch.engine.session import SessionCache

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cache = SessionCache(lambda key: _session(world), byte_budget=0)
    session = cache.get("default")
    held = session.nbytes()
    P, V = world["H"].shape
    assert held >= P * V * 4  # the stored fp32 matrix at least
    assert torch.cuda.memory_allocated() - before >= held
    eng = str(tmp_path / "eng")
    _serve(cache, eng, [{"id": "e1", "tenant": "a", "time_range": "0:0.15"}])
    assert _outcome(eng, "e1")["status"] == "completed"  # run() closed the cache
    assert len(cache) == 0 and session.nbytes() == 0
    del session
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before < 1 << 20


@pytest.mark.gpu
def test_warm_up_stride_launches_before_the_server_counts(world, tmp_path):
    """``serve``'s warm-up stride runs the sweep's plan at B = lanes before
    the server starts counting: the server's ``kernel_launches_total`` holds
    the request's launches only, and the rows stay the CLI's."""
    from sartsolver_tpu_torch.obs import metrics as obs_metrics
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, plan_sweep, reset_launch_counts

    session = _session(world)
    P, V = world["H"].shape
    plan = plan_sweep(P, V, 2, "float32")
    reset_launch_counts()
    assert session.warm_up(2) > 0
    warm = fused_sweep.launches_by_plan.get(plan, 0)
    assert warm > 0
    eng = str(tmp_path / "eng")
    _serve(session, eng, [{"id": "w1", "tenant": "a", "time_range": "0:0.35"}])
    assert _outcome(eng, "w1")["status"] == "completed"
    counted = obs_metrics.get_registry().counter("kernel_launches_total", kernel="fused_sweep",
                                                 plan=plan).value
    assert counted == fused_sweep.launches_by_plan[plan] - warm > 0
    _assert_same(_rows(os.path.join(eng, "outputs", "w1.h5")),
                 _cli(world, str(tmp_path / "cli.h5"), "-t", "0:0.35", "--no_guess",
                      "--batch_frames", "2"))
    session.close()
