"""Continuous batching on the card: scheduled lanes against the classic
grouped loop, byte for byte, through each plan of the sweep kernel.

Needs a CUDA device and ``nvcc``: every test is marked ``gpu`` and skips
without a card. Run on the card with
``python -m pytest -q --noconftest -m gpu tests/test_torch_sched_gpu.py``.
This file imports no JAX.

Byte identity holds when every lane's result is independent of the other
lanes' contents and both loops sweep the same B: the kernel's split-K and
rank orders are fixed, cuBLAS products of one shape are deterministic, and
the fp64 ``||Hf||^2`` is taken per row. The grouped loop pads its tail with
dark frames to keep B equal to the lane count.
"""

import numpy as np
import pytest
import torch

from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, plan_sweep, reset_launch_counts
from sartsolver_tpu_torch.ops.laplacian import make_laplacian
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
from sartsolver_tpu_torch.sched import ContinuousBatcher


def _mixed_case(P, V, n, seed):
    """(H, frames) whose iteration counts spread: truths with more fine
    structure straggle."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.1, 1.0, (P, V)).astype(np.float32)
    x = np.arange(V) / V
    base = 1.0 + 0.5 * np.sin(2 * np.pi * x)
    rough = np.sin(2 * np.pi * 6.5 * x)
    amps = np.geomspace(1e-3, 3.0, n)
    rng.shuffle(amps)
    H64 = H.astype(np.float64)
    frames = [np.maximum(H64 @ np.maximum(base + a * rough, 1e-3)
                         * (1.0 + 1e-3 * rng.standard_normal(P)), 0.0) for a in amps]
    return H, frames


def _chain_laplacian(V):
    i = np.arange(V)
    rows = np.concatenate([i, i[1:], i[:-1]])
    cols = np.concatenate([i, i[1:] - 1, i[:-1] + 1])
    vals = np.concatenate([np.full(V, 0.2), np.full(2 * V - 2, -0.1)])
    return make_laplacian(rows, cols, vals, nvoxel=V, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("storage,P,V,lanes,plan", [
    ("float32", 512, 256, 8, "two_read"),
    ("float32", 8192, 256, 8, "one_read"),
    ("bfloat16", 512, 256, 8, "tensor_core"),
    ("int8", 512, 256, 8, "tensor_core"),
    ("bfloat16", 4096, 256, 4, "one_read"),
    ("int8", 5120, 256, 4, "one_read"),
])
def test_scheduled_lanes_equal_the_grouped_loop_on_the_card(storage, P, V, lanes, plan,
                                                            logarithmic):
    """Every retired lane equals the grouped loop's frame byte for byte
    (solution, status, iterations); every launch of both loops is on the
    plan ``plan_sweep`` gives at B = lanes; the scheduler's launches equal
    its loop steps, the grouped loop's the sum of its groups' loop counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert plan_sweep(P, V, lanes, storage) == plan
    H, frames = _mixed_case(P, V, 2 * lanes + lanes // 2, seed=P + lanes)
    # tolerances at which these frames' counts spread below the cap
    opts = SolverOptions(max_iterations=300, conv_tolerance=1e-7 if logarithmic else 1e-8,
                         schedule_stride=8,
                         logarithmic=logarithmic, rtm_dtype=storage,
                         beta_laplace=0.0 if logarithmic else 0.01)
    lap = None if logarithmic else _chain_laplacian(V)
    with DistributedSARTSolver(H, lap, opts=opts, device="cuda") as solver:
        reset_launch_counts()
        dense, loops = [], 0
        for s in range(0, len(frames), lanes):
            stack = np.stack(frames[s:s + lanes])
            n = stack.shape[0]
            if n < lanes:
                stack = np.concatenate([stack, np.zeros((lanes - n, P))])
            res = solver.solve_batch(stack)
            loops += int(res.iterations.max())
            dense += [(res.fetch_solutions()[b], int(res.status[b]), int(res.iterations[b]))
                      for b in range(n)]
        torch.cuda.synchronize()
        dense_launches = dict(fused_sweep.launches_by_plan)

        reset_launch_counts()
        got = []

        def on_result(_t, _ct, status, iters, _conv, fetcher, _ms):
            got.append((fetcher(), status, iters))

        stats = ContinuousBatcher(solver, lanes=lanes, on_result=on_result).run(
            (fr, float(i), [float(i)]) for i, fr in enumerate(frames))
        torch.cuda.synchronize()
        sched_launches = dict(fused_sweep.launches_by_plan)

    assert [g[1] for g in got] == [d[1] for d in dense]
    assert [g[2] for g in got] == [d[2] for d in dense]
    np.testing.assert_array_equal(np.stack([g[0] for g in got]),
                                  np.stack([d[0] for d in dense]))
    assert len({d[2] for d in dense}) >= 3  # the frames really spread
    assert dense_launches == {**dict.fromkeys(dense_launches, 0), plan: loops}
    assert sched_launches == {**dict.fromkeys(sched_launches, 0), plan: stats.loop_steps}


@pytest.mark.gpu
@pytest.mark.parametrize("storage,P,plan", [
    ("float32", 512, "two_read"), ("float32", 8192, "one_read"),
    ("bfloat16", 512, "tensor_core"), ("int8", 512, "tensor_core")])
@pytest.mark.parametrize("variant", [
    dict(logarithmic=True, relaxation_decay=0.97),
    dict(momentum="nesterov"),
    dict(logarithmic=True, momentum="nesterov", relaxation_decay=0.98),
    dict(divergence_recovery=2, relaxation_decay=0.99),
], ids=["log-decay", "momentum", "log-momentum-decay", "guard-decay"])
def test_variants_scheduled_equal_the_grouped_loop_on_the_card(variant, storage, P, plan):
    """The solver variants at B = 8: every retired lane equals the grouped
    loop's frame byte for byte, every launch on the plan of B = 8 (fp32
    two_read or one_read by P, bf16 and int8 tensor_core; the scheduled log
    update's launches counted as such), and with the guard a NaN frame
    retires DIVERGED (-2) with a zero row in both loops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lanes, V = 8, 256
    assert plan_sweep(P, V, lanes, storage) == plan
    H, frames = _mixed_case(P, V, 2 * lanes + lanes // 2, seed=P + 3)
    if variant.get("divergence_recovery"):
        frames[5] = frames[5].copy()
        frames[5][7] = np.nan
    log = variant.get("logarithmic", False)
    opts = SolverOptions(max_iterations=300, conv_tolerance=1e-7, schedule_stride=8,
                         rtm_dtype=storage, beta_laplace=0.0 if log else 0.01, **variant)
    lap = None if log else _chain_laplacian(V)
    with DistributedSARTSolver(H, lap, opts=opts, device="cuda") as solver:
        reset_launch_counts()
        dense = []
        for s in range(0, len(frames), lanes):
            stack = np.stack(frames[s:s + lanes])
            n = stack.shape[0]
            if n < lanes:
                stack = np.concatenate([stack, np.zeros((lanes - n, P))])
            res = solver.solve_batch(stack)
            dense += [(res.fetch_solutions()[b], int(res.status[b]), int(res.iterations[b]))
                      for b in range(n)]
        got = []
        ContinuousBatcher(solver, lanes=lanes, on_result=lambda _t, _c, st, it, _cv, fe, _ms:
                          got.append((fe(), st, it))).run(
            (fr, float(i), [float(i)]) for i, fr in enumerate(frames))
        torch.cuda.synchronize()
        by_plan = dict(fused_sweep.launches_by_plan)
        scheduled = dict(fused_sweep.scheduled_by_plan)
    assert [g[1:] for g in got] == [d[1:] for d in dense]
    np.testing.assert_array_equal(np.stack([g[0] for g in got]),
                                  np.stack([d[0] for d in dense]))
    assert by_plan[plan] > 0 and sum(by_plan.values()) == by_plan[plan]
    if log and variant.get("relaxation_decay"):
        assert scheduled[plan] == by_plan[plan]
    if variant.get("divergence_recovery"):
        assert [d[1] for d in dense].count(-2) == 1
        assert not got[5][0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_sinks_change_no_byte_of_the_scheduled_cli_run_on_the_card(tmp_path, monkeypatch,
                                                                    storage):
    """The CLI's scheduler at 8 lanes on the card, with every sink on
    (--metrics_out, SART_METRICS_PROM, SART_TRACE_EVENTS): the solution file
    is the same bytes as without them and as the classic loop's, and the
    artifact's frames and stride count are the run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import os
    import re
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(repo)
    from sartsolver_tpu_torch.obs.cli import metrics_main

    world = cs.write_world(str(tmp_path), nx=16, ny=16, cam=(8, 4), n_frames=12)
    p = world["paths"]
    argv = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"],
            "-m", "300", "-l", p["laplacian"], "--rtm_dtype", storage,
            "--no_guess", "--batch_frames", "8"]
    files, texts = {}, {}
    for name, extra in (("plain", []), ("classic", ["--no_continuous_batching"]),
                        ("sinks", ["--metrics_out", str(tmp_path / "run.jsonl")])):
        if name == "sinks":
            monkeypatch.setenv("SART_METRICS_PROM", str(tmp_path / "run.prom"))
            monkeypatch.setenv("SART_TRACE_EVENTS", str(tmp_path / "run.trace.json"))
        out = str(tmp_path / f"{name}.h5")
        rc, ms, texts[name] = cs.run_cli(["-o", out, *argv, *extra])
        assert rc == 0 and len(ms) == 12
        with open(out, "rb") as f:
            files[name] = f.read()
    assert files["sinks"] == files["plain"] == files["classic"]
    assert metrics_main(["--check", str(tmp_path / "run.jsonl")]) == 0
    with open(tmp_path / "run.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len([r for r in records if r["type"] == "frame"]) == 12
    strides = int(re.search(r"strides=(\d+)", texts["sinks"])[1])
    assert [r["value"] for r in records if r.get("name") == "sched_strides_total"] == [strides]
    assert records[0]["backend"] == "cuda"
