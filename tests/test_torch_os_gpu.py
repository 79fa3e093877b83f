"""Ordered subsets (``os_subsets``) on the card.

Needs a CUDA device: every test is marked ``gpu`` and skips without a card.
Run on the card with
``python -m pytest -q --noconftest -m gpu tests/test_torch_os_gpu.py``.
This file imports no JAX.

- OS on the card against OS on the CPU, for fp32, bf16 and int8 storage;
- the scheduler against the classic grouped loop at 8 lanes, and the chain
  against the serial loop, byte for byte;
- no fused-sweep launch during an OS solve;
- the products' memory: an fp32 subset is handed to cuBLAS as a strided
  view (no copy), a bf16 or int8 subset is upcast one block at a time.
"""

import numpy as np
import pytest
import torch

from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.models import sart as tsart
from sartsolver_tpu_torch.ops import os_subsets as oss
from sartsolver_tpu_torch.ops import projection
from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, reset_launch_counts
from sartsolver_tpu_torch.ops.laplacian import make_laplacian
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
from sartsolver_tpu_torch.sched import ContinuousBatcher

STORAGES = ["float32", "bfloat16", "int8"]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _mixed_case(P, V, n, seed):
    """(H, frames) whose iteration counts spread."""
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


def _lap(V, device):
    i = np.arange(V)
    rows = np.concatenate([i, i[1:], i[:-1]])
    cols = np.concatenate([i, i[1:] - 1, i[:-1] + 1])
    vals = np.concatenate([np.full(V, 0.2), np.full(2 * V - 2, -0.1)])
    return make_laplacian(rows, cols, vals, nvoxel=V, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("storage", STORAGES)
def test_os_on_the_card_matches_the_cpu(storage, logarithmic):
    """Three frames to the cap (no stall test) at os_subsets = 4, with
    momentum: equal statuses and iterations, solutions at the fp32 bar
    (rtol 2e-4, atol 1e-5 of the normalized solution); no fused-sweep
    launch on the card."""
    _needs_card()
    P, V = 512, 256
    H, frames = _mixed_case(P, V, 3, seed=21)
    opts = SolverOptions(max_iterations=25, conv_tolerance=0.0, os_subsets=4,
                         momentum="nesterov", logarithmic=logarithmic, rtm_dtype=storage,
                         beta_laplace=0.0 if logarithmic else 0.01)
    out = {}
    for device in ("cpu", "cuda"):
        lap = None if logarithmic else _lap(V, device)
        with DistributedSARTSolver(H, lap, opts=opts, device=device) as solver:
            reset_launch_counts()
            res = solver.solve_batch(np.stack(frames))
            out[device] = (res.solution_norm.cpu().numpy(), res.status, res.iterations)
            assert fused_sweep.launches == 0
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_array_equal(out["cuda"][2], out["cpu"][2])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=2e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("storage", STORAGES)
def test_os_scheduled_equals_the_grouped_loop_on_the_card(storage, logarithmic):
    """os_subsets = 4 at 8 lanes: every retired lane equals the grouped
    loop's frame byte for byte, and neither loop launches the fused
    sweep."""
    _needs_card()
    P, V, lanes = 512, 256, 8
    H, frames = _mixed_case(P, V, 2 * lanes + lanes // 2, seed=22)
    opts = SolverOptions(max_iterations=300, conv_tolerance=1e-7 if logarithmic else 1e-6,
                         schedule_stride=8, os_subsets=4, logarithmic=logarithmic,
                         rtm_dtype=storage, beta_laplace=0.0 if logarithmic else 0.01)
    lap = None if logarithmic else _lap(V, "cuda")
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
        assert fused_sweep.launches == 0
    assert [g[1:] for g in got] == [d[1:] for d in dense]
    np.testing.assert_array_equal(np.stack([g[0] for g in got]),
                                  np.stack([d[0] for d in dense]))
    assert len({d[2] for d in dense}) >= 2  # the frames spread


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
def test_os_chain_equals_serial_on_the_card(storage):
    """Warm-started frames through chains of 3 equal the serial loop's byte
    for byte with os_subsets = 4 (log with momentum)."""
    _needs_card()
    P, V = 512, 256
    H, frames = _mixed_case(P, V, 7, seed=23)
    opts = SolverOptions(max_iterations=300, conv_tolerance=1e-6, os_subsets=4,
                         momentum="nesterov", logarithmic=True, rtm_dtype=storage)
    rows = {}
    with DistributedSARTSolver(H, None, opts=opts, device="cuda") as solver:
        for K in (3, 1):
            warm, out = None, []
            for s in range(0, len(frames), K):
                warm = solver.solve_chain(np.stack(frames[s:s + K]), warm=warm)
                out += [(warm.fetch_solutions()[b], int(warm.status[b]),
                         int(warm.iterations[b])) for b in range(len(frames[s:s + K]))]
            rows[K] = out
    assert [r[1:] for r in rows[3]] == [r[1:] for r in rows[1]]
    np.testing.assert_array_equal(np.stack([r[0] for r in rows[3]]),
                                  np.stack([r[0] for r in rows[1]]))


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
def test_subset_products_hold_no_subset_copy(storage):
    """At 4096 x 65536 and four subsets: an fp32 subset's products allocate
    only their outputs (cuBLAS is handed the strided view); a bf16 or int8
    subset's allocate at most one fp32 block of ``PANEL_ELEMENTS``
    (64 MiB) beside them, never the subset's 256 MiB in fp32. The results
    equal the products of an fp32 copy of the subset at fp32 tolerance."""
    _needs_card()
    P, V, n = 4096, 65536, 4
    gen = torch.Generator(device="cuda").manual_seed(24)
    H = torch.rand((P, V), device="cuda", generator=gen)
    scale = None
    if storage == "int8":
        stored, scale = tsart.quantize_rtm(H)
    else:
        stored = H.to(tsart.torch_dtype(storage))
    del H
    f = torch.rand((1, V), device="cuda", generator=gen)
    w = torch.rand((1, P // n), device="cuda", generator=gen)
    panel = oss.os_subset_rows(stored, 1, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fwd = oss.os_subset_forward(panel, f, scale)
    back = oss.os_subset_back(panel, w, scale)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    outputs = (fwd.numel() + back.numel()) * 4
    block = 0 if storage == "float32" else projection.PANEL_ELEMENTS * 4
    # the outputs, one block, and the small operand copies (f * scale, w)
    assert grown <= outputs + block + 4 * (f.numel() + w.numel()) * 4 + (1 << 20), grown
    full = panel.float() if scale is None else panel.float() * scale[None, :]
    np.testing.assert_allclose(fwd.cpu().numpy(), (f @ full.T).cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(back.cpu().numpy(), (w @ full).cpu().numpy(), rtol=1e-4)
