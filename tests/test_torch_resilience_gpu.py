"""The resilience slice on the card: the integrity check against the Hopper
kernel in each plan, the resident re-audit, and --resume through the CLI.

Needs a CUDA device: every test is marked ``gpu`` and skips without a card.
Run on the card with
``python -m pytest -q --noconftest -m gpu tests/test_torch_resilience_gpu.py``.
No JAX, no h5py: the world is written by ``chip_smoke.py``'s writer.

- with ``integrity=True`` each plan of the fused sweep (``one_read``,
  ``tensor_core``, ``two_read``) solves the same bytes as without, its
  largest ABFT residual inside the band, and the re-audit of the resident
  matrix finds nothing (the ray stats' reductions give the same bits on
  every call);
- a corrupted resident matrix (a float's exponent bit flipped) trips the
  check through the same kernel (the plan's launch count advances on the
  recompute); a corrupted int8 code, too small for the band at this size,
  and every corruption show in the re-audit;
- a half run and ``--resume`` on the card give the uninterrupted run's
  rows before the cut and its statuses after it.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (storage, B) and the plan plan_sweep gives them at 4096 x 4096
PLANS = [("float32", 1, "one_read"), ("bfloat16", 8, "tensor_core"),
         ("int8", 8, "tensor_core"), ("float32", 16, "two_read")]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _problem(storage, seed=0):
    rng = np.random.default_rng(seed)
    P, V = 4096, 4096
    H = (rng.random((P, V), dtype=np.float32) * 0.9 + 0.1) / V
    f = rng.random((V, 16), dtype=np.float32) + 0.5
    return H, (H @ f).T.astype(np.float64)


@pytest.mark.gpu
@pytest.mark.parametrize("storage,B,plan", PLANS)
def test_integrity_on_each_plan_changes_nothing_and_trips_nothing(storage, B, plan):
    _needs_card()
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.models.sart import abft_worst_ratio, record_abft_worst
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, plan_sweep, reset_launch_counts
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

    H, G = _problem(storage)
    assert plan_sweep(*H.shape, B, storage) == plan
    out = {}
    record_abft_worst(True)
    for on in (False, True):
        opts = SolverOptions(max_iterations=60, rtm_dtype=storage, integrity=on)
        with DistributedSARTSolver(H, opts=opts, device="cuda") as solver:
            reset_launch_counts()
            res = solver.solve_batch(G[:B])
            out[on] = (res.status.copy(), res.iterations.copy(), res.fetch_solutions().copy())
            assert fused_sweep.launches_by_plan[plan] > 0
            if on:
                ratio = abft_worst_ratio()
                record_abft_worst(False)
                assert 0 <= ratio < 1, ratio
                assert solver.reaudit_ray_stats() == []
    for a, b in zip(out[False], out[True]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("storage,B,plan", PLANS)
def test_resident_corruption_trips_through_the_same_kernel(storage, B, plan):
    _needs_card()
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, reset_launch_counts
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
    from sartsolver_tpu_torch.resilience import faults
    from sartsolver_tpu_torch.resilience.failures import SDC_DETECTED

    H, G = _problem(storage, seed=1)
    opts = SolverOptions(max_iterations=60, rtm_dtype=storage, integrity=True)
    with DistributedSARTSolver(H, opts=opts, device="cuda") as solver:
        faults.clear_faults()
        faults.inject(faults.SITE_DEVICE_BUFFER, "corrupt", count=1)
        try:
            reset_launch_counts()
            res = solver.solve_batch(G[:B])
            first = fused_sweep.launches_by_plan[plan]
            again = solver.solve_batch(G[:B])  # the recompute: the same plan
        finally:
            faults.reset()
        assert first > 0 and fused_sweep.launches_by_plan[plan] > first
        assert solver.reaudit_ray_stats()
        if storage != "int8":  # a reflected code moves sum(H f) by less than the band
            assert (res.status == SDC_DETECTED).all() and (again.status == SDC_DETECTED).all()


@pytest.mark.gpu
def test_resume_on_the_card(tmp_path):
    _needs_card()
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    world = cs.write_world(str(tmp_path), nx=64, ny=64, cam=(32, 32), n_frames=8)
    p = world["paths"]
    base = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"], "-m", "200",
            "-l", p["laplacian"], "--chain_frames", "1"]
    ref, out = str(tmp_path / "ref.h5"), str(tmp_path / "out.h5")
    assert cs.run_cli(["-o", ref, *base])[0] == 0
    assert cs.run_cli(["-o", out, *base, "-t", "0:0.35"])[0] == 0
    rc, ms, _ = cs.run_cli(["-o", out, *base, "--resume"])
    assert rc == 0 and len(ms) == 4
    rec = cs.check_resumed(out, ref, world, 4, "cuda", "resume on the card")
    assert rec["rows"] == 8
