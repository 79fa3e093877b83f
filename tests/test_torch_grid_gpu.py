"""The pixel-sharded sweep and a grid of ranks on the card.

Needs a CUDA device: every test is marked ``gpu`` and skips without a card.
Run on the card with
``python -m pytest -q --noconftest -m gpu tests/test_torch_grid_gpu.py``.
This file imports no JAX and no h5py: its world is ``chip_smoke.py``'s at a
small size.

- ``sharded_sweep_bp`` and ``sharded_sweep_finish`` launched on the card
  against their plain versions at ragged shapes, for fp32, bf16 and int8
  storage, linear with the penalty and log with a per-row exponent: within
  1e-5 of the output's max, two launches byte-identical, each launch
  counted; at one rank the pair is ``two_read`` bit for bit;
- both routes of the pair (``split_route``: the cluster route, one kernel
  a call, and two_read's, three) for every storage, linear and log, at
  ragged P and V, unaligned rows, B = 1, 3, 8, 17 and 32 and two_read's
  splits of P from 1 to 3: the one-rank pair bit for bit against
  ``two_read``, repeat launches byte-identical, within 1e-5 of the plain
  version, and the route's CUDA kernels a call from the profiler; the
  kernel's own rule (``sart_split_route_ok``) against ``split_route``;
- a CUDA tensor launches the kernel or raises: a refused shape is an error,
  never the plain version;
- the kernel path against the plain path of a one-rank solver on the card
  (``utils/fused_parity.py``), on the e2e world's banded matrix and on a
  uniform random one, each fp32 path also against the fp64 solve of the
  same problem: the kernel no farther from fp64 than ``FP64_RATIO`` times
  the plain path;
- a two-rank gloo run of the CLI on the card (``--multihost --pixel_shards
  2``, ranks sharing the card) against the one-rank run: statuses equal,
  fitted distance within 5e-3, the split kernels launched once an
  iteration on each rank; then the ranks' parity check on a 2x1 grid with
  its fp64 witness.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORAGES = ["float32", "bfloat16", "int8"]
SHAPES = [(1000, 3001, 3), (257, 129, 40), (4096, 8192, 1)]
# (P, V, B): the 2x1 grid's block of the e2e world, the tall world's (two
# splits of P), three splits at ragged P, ragged V with 16-byte rows, ragged
# P and V, one split of V (no partials), unaligned rows (two_read's route),
# and B past the cluster route
ROUTE_SHAPES = [(4096, 65536, 1), (8192, 65536, 1), (9000, 65536, 3), (1000, 4000, 1),
                (777, 5008, 2), (1000, 1008, 2), (1000, 4001, 1), (4096, 8192, 8),
                (1000, 3008, 17), (257, 4000, 32)]
TOL = 1e-5
DISTANCES = ("kernel_to_fp64", "plain_to_fp64", "kernel_to_plain")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("logarithmic", [False, True], ids=["linear", "log"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("storage", STORAGES)
def test_split_kernels_match_plain(storage, shape, logarithmic):
    _needs_card()
    from sartsolver_tpu_torch.ops import fused_sweep as fs

    cs = _chip_smoke()
    P, V, B = shape
    H, w, f, aux, scale = cs._sweep_inputs(P, V, B, logarithmic, True, seed=P + V + B,
                                           storage=storage)
    kw = dict(logarithmic=logarithmic, alpha=0.7, eps=1e-7, scale=scale)
    if logarithmic:  # a distinct exponent per row
        kw["alpha_lane"] = cs._lanes(B)
    before = (fs.sharded_sweep_bp.launches, fs.sharded_sweep_finish.launches)
    bp1, bp2 = fs.sharded_sweep_bp(H, w), fs.sharded_sweep_bp(H, w)
    bp_ref = fs.sharded_sweep_bp_reference(H, w)
    out1 = fs.sharded_sweep_finish(H, f, bp_ref, aux, **kw)
    out2 = fs.sharded_sweep_finish(H, f, bp_ref, aux, **kw)
    ref = fs.sharded_sweep_finish_reference(H, f, bp_ref, aux, **kw)
    torch.cuda.synchronize()
    assert (fs.sharded_sweep_bp.launches - before[0],
            fs.sharded_sweep_finish.launches - before[1]) == (2, 2)
    assert torch.equal(bp1, bp2)
    assert all(torch.equal(a, b) for a, b in zip(out1, out2))
    assert _rel(bp1, bp_ref) <= TOL
    for a, r in zip(out1, ref):
        assert torch.isfinite(r).all()
        assert _rel(a, r) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("logarithmic", [False, True], ids=["linear", "log"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("storage", STORAGES)
def test_split_routes_against_two_read(storage, shape, logarithmic):
    """Either route: the one-rank pair is two_read's bytes (every sum in its
    order), two launches give the same bytes, each output within 1e-5 of
    the plain version's max, and a call is the route's CUDA kernels."""
    _needs_card()
    from sartsolver_tpu_torch.ops import fused_sweep as fs

    cs = _chip_smoke()
    P, V, B = shape
    route = fs.split_route(P, V, B, storage)
    H, w, f, aux, scale = cs._sweep_inputs(P, V, B, logarithmic, True, seed=P + 3 * V + B,
                                           storage=storage)
    kw = dict(logarithmic=logarithmic, alpha=0.7, eps=1e-7, scale=scale)
    if logarithmic:
        kw["alpha_lane"] = cs._lanes(B)
    before = (fs.sharded_sweep_bp.launches_by_route[route],
              fs.sharded_sweep_finish.launches_by_route[route])
    bp1, bp2 = fs.sharded_sweep_bp(H, w), fs.sharded_sweep_bp(H, w)
    pair1 = fs.sharded_sweep_finish(H, f, bp1, aux, **kw)
    pair2 = fs.sharded_sweep_finish(H, f, bp2, aux, **kw)
    two = fs._sweep(H, w, f, aux, plan="two_read", **kw)
    bp_ref = fs.sharded_sweep_bp_reference(H, w)
    ref = fs.sharded_sweep_finish_reference(H, f, bp_ref, aux, **kw)
    torch.cuda.synchronize()
    assert (fs.sharded_sweep_bp.launches_by_route[route] - before[0],
            fs.sharded_sweep_finish.launches_by_route[route] - before[1]) == (2, 2)
    assert torch.equal(bp1, bp2)
    assert all(torch.equal(a, b) for a, b in zip(pair1, pair2))
    assert all(torch.equal(a, b) for a, b in zip(pair1, two)), route
    assert _rel(bp1, bp_ref) <= TOL
    for a, r in zip(pair1, ref):
        assert torch.isfinite(r).all()
        assert _rel(a, r) <= TOL
    want = fs.SPLIT_KERNELS_PER_CALL[route]
    assert cs._trace_profile(lambda: fs.sharded_sweep_bp(H, w))["kernels_per_call"] == want
    assert cs._trace_profile(
        lambda: fs.sharded_sweep_finish(H, f, bp1, aux, **kw))["kernels_per_call"] == want


@pytest.mark.gpu
def test_split_route_rule_is_the_kernels():
    """``split_route`` and the kernel's own preconditions
    (``sart_split_route_ok``) agree on a grid of shapes, batch sizes and
    storage types."""
    _needs_card()
    from sartsolver_tpu_torch.ops import fused_sweep as fs

    lib = fs._sharded_lib()
    for storage, code in (("float32", 0), ("bfloat16", 1), ("int8", 2)):
        for P in (1, 63, 64, 257, 1000, 4096, 8192, 9000, 16384, 32768, 40000, 65536):
            for V in (1, 8, 129, 3001, 3008, 4000, 4001, 5008, 8192, 16384, 65536):
                for B in (1, 2, 3, 4, 5, 8, 32):
                    ok = bool(lib.sart_split_route_ok(code, P, V, B))
                    assert ok == (fs.split_route(P, V, B, storage) == "cluster"), \
                        (storage, P, V, B)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
def test_split_pair_at_one_rank_is_two_read(storage):
    """Nothing between the two calls (one rank): the bp the finish takes is
    the sum of the same splits in the same order, so the pair gives
    two_read's bytes."""
    _needs_card()
    from sartsolver_tpu_torch.ops import fused_sweep as fs

    cs = _chip_smoke()
    for P, V, B in SHAPES:
        H, w, f, aux, scale = cs._sweep_inputs(P, V, B, False, True, seed=7, storage=storage)
        pair = fs.sharded_sweep_finish(H, f, fs.sharded_sweep_bp(H, w), aux,
                                       logarithmic=False, scale=scale)
        two = fs._sweep(H, w, f, aux, logarithmic=False, scale=scale, plan="two_read")
        assert all(torch.equal(a, b) for a, b in zip(pair, two))


@pytest.mark.gpu
def test_split_kernels_launch_or_raise():
    _needs_card()
    from sartsolver_tpu_torch.ops import fused_sweep as fs

    H = torch.rand(64, 256, device="cuda")
    w = torch.rand(2, 64, device="cuda")
    before = fs.sharded_sweep_bp.launches
    with pytest.raises(ValueError, match="contiguous"):
        fs.sharded_sweep_bp(H.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="do not agree"):
        fs.sharded_sweep_bp(H, w[:, :10])
    f = torch.rand(2, 256, device="cuda")
    with pytest.raises(ValueError):
        fs.sharded_sweep_finish(H, f, torch.rand(2, 256, device="cuda"),
                                [torch.rand(1, 255, device="cuda")], logarithmic=False)
    assert fs.sharded_sweep_bp.launches == before


@pytest.mark.gpu
def test_kernel_vs_plain_parity_one_rank():
    """On the e2e world's banded matrix at 1024 x 4096 (``chip_smoke.py:
    parity_problem``), 15 iterations."""
    _needs_card()
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
    from sartsolver_tpu_torch.utils.fused_parity import measure_kernel_vs_plain

    H, G = _chip_smoke().parity_problem(1024, 4096)
    opts = SolverOptions(max_iterations=15, conv_tolerance=0.0)
    solver = DistributedSARTSolver(H, opts=opts, device="cuda")
    reference = DistributedSARTSolver(H.astype(np.float64), opts=SolverOptions(
        max_iterations=15, conv_tolerance=0.0, dtype="float64"), device="cuda")
    out = measure_kernel_vs_plain(solver, G, reps=1, reference=reference)
    print("banded 1024x4096:", {k: out[k] for k in DISTANCES})
    assert out["kernel_engaged"] == "compiled" and out["kernel_launches"] == 15
    assert out["plain_engaged"] == "plain"


@pytest.mark.gpu
def test_kernel_vs_plain_against_fp64_random_matrix():
    """A uniform random 512 x 2048 matrix, 15 iterations: its kernel-vs-plain
    gap is the largest of the cases held here, so the fp64 witness says
    whether it is reassociation (the kernel path and the plain path like
    distances from the fp64 solve) or a kernel fault (the kernel farther)."""
    _needs_card()
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
    from sartsolver_tpu_torch.utils.fused_parity import (
        FP64_RATIO, fp64_distances, solve_kernel_and_plain,
    )

    rng = np.random.default_rng(3)
    H = rng.random((512, 2048), dtype=np.float32)
    f_true = rng.random(2048) * 1.5 + 0.5
    G = np.stack([H @ f_true, H @ (1.1 * f_true)])
    solver = DistributedSARTSolver(H, opts=SolverOptions(max_iterations=15, conv_tolerance=0.0),
                                   device="cuda")
    reference = DistributedSARTSolver(H.astype(np.float64), opts=SolverOptions(
        max_iterations=15, conv_tolerance=0.0, dtype="float64"), device="cuda")
    out, sols = solve_kernel_and_plain(solver, G, reps=1)
    d = fp64_distances(reference, G, sols)
    print("random 512x2048:", d)
    assert out["kernel_engaged"] == "compiled" and out["kernel_launches"] == 15
    assert d["kernel_to_fp64"] <= FP64_RATIO * d["plain_to_fp64"]


@pytest.mark.gpu
def test_two_rank_gloo_run_on_card(tmp_path):
    """Two ranks share the card over gloo (NCCL refuses two ranks on one
    device); the run against the one-rank run of the same flags."""
    _needs_card()
    cs = _chip_smoke()
    world = cs.write_world(str(tmp_path), nx=64, ny=64, cam=(32, 32), n_frames=4)
    p = world["paths"]
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    flags = ["-m", "300", "-l", p["laplacian"], "--chain_frames", "1"]
    one = str(tmp_path / "one.h5")
    rc, ms, _ = cs.run_cli(["-o", one, *inputs, *flags])
    assert rc == 0 and len(ms) == 4
    out, prefix = str(tmp_path / "two.h5"), str(tmp_path / "two")
    rc, so, se, _ = cs._torchrun(2, ["--grid-rank", prefix, "--parity", "--", "-o", out,
                                     *inputs, *flags,
                                     "--device", "cuda", "--multihost", "--pixel_shards", "2"],
                                 timeout=600)
    assert rc == 0, se[-3000:]
    assert so.count("Processed in:") == 4
    assert "mesh=2x1 (pixels x voxels, pixel-major)" in so and "collectives=gloo" in so
    a, b = cs._read_rows(out), cs._read_rows(one)
    np.testing.assert_array_equal(a["status"], b["status"])
    assert (cs._fitted_distance(world, a["value"], b["value"], "cuda") <= 5e-3).all()
    iters = int(a["iterations"].sum())
    recs = cs._rank_records(prefix, 2)
    for rec in recs:
        assert rec["rc"] == 0 and rec["fused_sweep"] == 0
        assert rec["sharded_sweep_bp"] == rec["sharded_sweep_finish"] == iters
        assert rec["parity"]["kernel_engaged"] == "split"
    # the ranks' parity on the 2x1 grid, its fp64 witness held in the protocol
    print("grid 2x1 banded:", {k: recs[0]["parity"][k] for k in DISTANCES})
