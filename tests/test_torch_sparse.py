"""The block-sparse RTM (``--sparse_rtm``) of the port against the JAX package.

Ports the cases of ``tests/test_sparse_rtm.py`` that need neither a mesh
nor an XLA audit, on a small world: P = 64 pixels, V = 1024 voxels, tile
columns 1, 3, 5 and 6 (4 of 8) empty. The arrays are made from a seed with
numpy and go through both packages on the CPU.

- The index: the same digest as the JAX index of the same fp32 matrix, the
  chunked accumulation equal to the one-shot build, the NaN refusal, the
  thresholding; the port's ingest (tile maxima of the stored values on the
  device) equal in digest to the JAX ingest's index for every storage.
- The solve at EPS = 0: the port's sparse solve against the port's dense
  solve and against the JAX sparse solve, in the linear and log solvers, the
  OS cycle, a batch and a chain. fp32 runs to the ``-m`` cap (no stall
  crossing: ROADMAP §C items 2-4) with equal statuses and iterations, the
  values at the JAX sparse suite's bar (``max|d| <= 2e-4 * max|x|``); fp64 (where 'auto' declines in both packages)
  at a real tolerance, statuses, iterations and values within 1e-8.
- EPS > 0: self-consistent (a dropped voxel has no ray density) and
  residual-matched to the dense solve and to the JAX thresholded solve.
- The decline and raise reasons and their messages; the departure from the
  JAX package's static-unroll cap; the all-dark and all-empty operators;
  the ``--integrity`` verification skip; the metrics; the CLI against the
  JAX CLI at ``--sparse_rtm auto`` and ``0.05``.
"""

import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch

import fixtures as fx
from sartsolver_tpu.cli import main as jax_main
from sartsolver_tpu.config import SolverOptions as JaxOptions
from sartsolver_tpu.models import sart as jsart
from sartsolver_tpu.ops import sparse as jsparse
from sartsolver_tpu.parallel.mesh import make_mesh
from sartsolver_tpu.parallel.sharded import DistributedSARTSolver as JaxSolver

from sartsolver_tpu_torch.cli import main as torch_main
from sartsolver_tpu_torch.config import SartInputError, SolverOptions
from sartsolver_tpu_torch.models import sart as tsart
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.ops import sparse as tsparse
from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep
from sartsolver_tpu_torch.parallel import multihost as mh
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

P, V, TC = 64, 1024, 128
EMPTY = (1, 3, 5, 6)  # the tile columns no pixel sees
NAME = "with_reflections"


def _matrix(seed=0, empty=EMPTY):
    rng = np.random.default_rng(seed)
    H = (rng.random((P, V), dtype=np.float32) * 0.9 + 0.1)
    for j in empty:
        H[:, j * TC:(j + 1) * TC] = 0.0
    return H


def _frames(H, n=1, seed=21):
    rng = np.random.default_rng(seed)
    f_true = rng.random(H.shape[1]) + 0.5
    return np.stack([H.astype(np.float64) @ (f_true * (1.0 + 0.1 * k)) for k in range(n)])


def _normalized(G):
    """``(g [B, P], msq [B])`` as ``prepare_measurement`` gives them."""
    gs, msqs = [], []
    for row in G:
        g, msq, _ = tsart.prepare_measurement(row, SolverOptions())
        gs.append(g)
        msqs.append(msq)
    return np.stack(gs), np.asarray(msqs)


def _jax_opts(opts, **extra):
    kw = {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}
    if kw["sparse_rtm"] != "off":
        kw["fused_panel_voxels"] = TC  # the JAX panel sweep's width at this size
    kw.update(extra)
    return JaxOptions(**kw)


def _port_solve(H, G, opts, sparse=True, sweep_fn=fused_sweep):
    if sparse:
        problem, occ = tsart.make_sparse_problem(H, opts=opts, device="cpu")
    else:
        problem, occ = tsart.make_problem(H, opts=opts, device="cpu"), None
    g, msq = _normalized(G)
    dt = tsart.torch_dtype(opts.dtype)
    res = tsart.solve_normalized_batch(
        problem, torch.as_tensor(g, dtype=dt), torch.as_tensor(msq, dtype=dt),
        torch.zeros((len(G), H.shape[1]), dtype=dt), opts=opts, use_guess=True,
        device="cpu", sweep_fn=sweep_fn)
    return res, problem, occ


def _jax_solve(H, G, jopts, sparse=True):
    import jax.numpy as jnp

    if sparse:
        problem, occ = jsart.make_sparse_problem(H, opts=jopts)
    else:
        problem, occ = jsart.make_problem(H, opts=jopts), None
    g, msq = _normalized(G)
    dt = jnp.dtype(jopts.dtype)
    return jsart.solve_normalized_batch(
        problem, jnp.asarray(g, dt), jnp.asarray(msq, dt),
        jnp.zeros((len(G), H.shape[1]), dt), opts=jopts, axis_name=None,
        voxel_axis=None, use_guess=True, tile_occupancy=occ)


def _assert_solves(got, want, fp64=False):
    np.testing.assert_array_equal(np.asarray(got.status), np.asarray(want.status))
    np.testing.assert_array_equal(np.asarray(got.iterations), np.asarray(want.iterations))
    a = np.asarray(got.solution, np.float64)
    b = np.asarray(want.solution, np.float64)
    if fp64:
        np.testing.assert_allclose(a, b, rtol=1e-8)
    else:
        _assert_parity(a, b)


def _assert_parity(a, b):
    """The JAX sparse suite's bar (``tests/test_sparse_rtm.py:_assert_parity``):
    ``max|a - b| <= PARITY_RTOL * max(max|b|, 1)``, PARITY_RTOL = 2e-4."""
    scale = max(float(np.max(np.abs(b))), 1.0)
    assert float(np.max(np.abs(a - b))) <= 2e-4 * scale


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [0.0, 0.01, 0.5])
def test_index_has_the_jax_digest(eps):
    H = _matrix(seed=3)
    H[:, 0:TC] *= np.where(np.random.default_rng(4).random((P, TC)) < 0.5, 1.0, 1e-3)
    ours = tsparse.build_tile_occupancy(H, epsilon=eps)
    theirs = jsparse.build_tile_occupancy(H, epsilon=eps)
    assert ours.to_payload() == theirs.to_payload()
    assert ours.grid_shape == (P // 8, V // TC)
    np.testing.assert_array_equal(ours.col_panel_occupied(TC), theirs.col_panel_occupied(TC))
    np.testing.assert_array_equal(ours.col_panel_occupied(2 * TC),
                                  theirs.col_panel_occupied(2 * TC))
    ours.verify()
    assert tsparse.TileOccupancy.from_payload(theirs.to_payload()) == ours
    assert jsparse.TileOccupancy.from_payload(ours.to_payload()) == theirs


def test_index_queries_and_digest_guard():
    occ = tsparse.build_tile_occupancy(_matrix())
    assert occ.occupancy_fraction() == pytest.approx(0.5)
    np.testing.assert_array_equal(occ.col_panel_occupied(TC),
                                  [j not in EMPTY for j in range(V // TC)])
    np.testing.assert_array_equal(
        occ.occupied_columns(V),
        np.concatenate([np.arange(j * TC, (j + 1) * TC) for j in range(8) if j not in EMPTY]))
    # the last tile column cut at a ragged extent
    ragged = tsparse.build_tile_occupancy(np.ones((8, 300), np.float32))
    np.testing.assert_array_equal(ragged.occupied_columns(300), np.arange(300))
    tampered = occ.to_payload()
    raw = bytearray(bytes.fromhex(tampered["packed_hex"]))
    raw[0] ^= 0x80
    tampered["packed_hex"] = bytes(raw).hex()
    with pytest.raises(ValueError, match="digest"):
        tsparse.TileOccupancy.from_payload(tampered)
    with pytest.raises(ValueError, match="tile width"):
        occ.col_panel_occupied(100)


def test_chunked_tile_stats_match_one_shot_and_are_idempotent():
    H = _matrix(seed=3)
    one_shot = tsparse.build_tile_occupancy(H, epsilon=0.01)
    stats = tsparse.TileMaxStats(P, V)
    rng = np.random.default_rng(7)
    for _ in range(40):  # unaligned, overlapping windows
        r0, c0 = int(rng.integers(0, P - 1)), int(rng.integers(0, V - 1))
        h, w = int(rng.integers(1, P - r0 + 1)), int(rng.integers(1, V - c0 + 1))
        stats.add(H[r0:r0 + h, c0:c0 + w], r0, c0)
    stats.add(H, 0, 0)
    stats.add(H, 0, 0)
    assert stats.occupancy(0.01) == one_shot
    # the ingest's path: per-chunk tile maxima taken where the rows lie
    fed = tsparse.TileMaxStats(P, V)
    for r0 in range(0, P, 5):
        mh._feed_tile_stats(fed, torch.as_tensor(H[r0:r0 + 5]), r0)
    np.testing.assert_array_equal(fed.tile_max, stats.tile_max)


def test_nan_poisoned_matrix_refuses_an_index():
    H = _matrix()
    H[3, 7] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        tsparse.build_tile_occupancy(H)
    fed = tsparse.TileMaxStats(P, V)
    mh._feed_tile_stats(fed, torch.as_tensor(H), 0)
    with pytest.raises(ValueError, match="non-finite"):
        fed.occupancy(0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_thresholding_and_compaction_where_the_matrix_lies(dtype):
    """``threshold_matrix`` semantics and the in-place compaction on a
    tensor: the port's tile zeroing equals the JAX host function, and the
    compacted matrix equals the occupied columns of the thresholded one."""
    H = _matrix(seed=5, empty=(1, 6))
    H[:, TC:2 * TC] = 1e-6  # sub-threshold tiles: eps drops them
    H[8:16, 0:TC] = 1e-6
    occ = tsparse.build_tile_occupancy(H, epsilon=1e-3)
    want = jsparse.threshold_matrix(H, jsparse.build_tile_occupancy(H, epsilon=1e-3))
    np.testing.assert_array_equal(tsparse.threshold_matrix(H, occ), want)
    x = torch.as_tensor(H)
    x = (x * 100).round().to(dtype) if dtype == torch.int8 else x.to(dtype)
    ref = x.clone()
    tsart.zero_dropped_tiles_(ref, occ.mask, 8, TC)
    cols = torch.as_tensor(occ.occupied_columns(V))
    got = tsart.compact_columns_(x, cols)
    assert got.data_ptr() == x.data_ptr()  # the same storage
    tiles = np.flatnonzero(occ.mask.any(axis=0))
    tsart.zero_dropped_tiles_(got, occ.mask[:, tiles], 8, TC)
    assert torch.equal(got, ref[:, cols])
    assert not ref[:, TC:2 * TC].any() and not ref[8:16, :TC].any()


@pytest.mark.parametrize("keep", [0, 1, 127, 250, 299, 300])
def test_compaction_in_place_at_any_occupancy(keep):
    rng = np.random.default_rng(keep)
    x = torch.as_tensor(rng.random((37, 300)), dtype=torch.float32)
    cols = torch.as_tensor(np.sort(rng.choice(300, keep, replace=False)), dtype=torch.long)
    want = x[:, cols].clone()
    got = tsart.compact_columns_(x, cols)
    assert got.shape == (37, keep) and torch.equal(got, want)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_ingest_index_matches_the_jax_ingest(tmp_path, storage):
    """The port's chunked ingest takes the tile maxima of the stored values
    on the device (fp32 or bf16 rows, int8 codes times scales): its index
    has the digest of the JAX ingest's, and for fp32 of the JAX one-shot
    index of the matrix."""
    from sartsolver_tpu.io import hdf5files as jhf
    from sartsolver_tpu.parallel import multihost as jmh

    paths, H = write_sparse_world(tmp_path)
    m, _ = jhf.categorize_input_files([paths[k] for k in ("rtm_a1", "rtm_a2", "rtm_b")])
    files = jhf.sort_rtm_files(m)
    ours = mh.make_tile_stats(P, V)
    theirs = jmh.make_tile_stats(P, V, make_mesh(1, 1))
    if storage == "int8":
        mh.read_and_quantize_rtm(files, NAME, P, V, "cpu", chunk_rows=5, tile_stats=ours)
        jmh.read_and_quantize_rtm(files, NAME, P, V, make_mesh(1, 1), tile_stats=theirs)
    else:
        mh.read_and_shard_rtm(files, NAME, P, V, "cpu", dtype=storage, chunk_rows=5,
                              tile_stats=ours)
        jmh.read_and_shard_rtm(files, NAME, P, V, make_mesh(1, 1), dtype=storage,
                               tile_stats=theirs)
    for eps in (0.0, 0.05):
        assert ours.occupancy(eps).to_payload() == theirs.occupancy(eps).to_payload()
    if storage == "float32":
        assert ours.occupancy(0.0).digest == jsparse.build_tile_occupancy(H).digest


# ---------------------------------------------------------------------------
# the solve at EPS = 0
# ---------------------------------------------------------------------------

VARIANTS = {
    "linear": {},
    "log": dict(logarithmic=True),
    "os4": dict(os_subsets=4),
    "os4_log": dict(os_subsets=4, logarithmic=True),
    "momentum": dict(momentum="nesterov"),
    "bf16": dict(rtm_dtype="bfloat16"),
    "int8": dict(rtm_dtype="int8"),
    "decay": dict(relaxation_decay=0.95),
    "integrity": dict(integrity=True),
    "recovery": dict(divergence_recovery=2),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_eps0_sparse_matches_dense(variant):
    """Inside the port: the sparse solve (two frames, to the cap) equals the
    dense one at the fp32 bars, and every sweep went through the kernel's
    wrapper on the compacted matrix."""
    kw = VARIANTS[variant]
    H = _matrix()
    G = _frames(H, 2)
    opts_d = SolverOptions(max_iterations=25, conv_tolerance=0.0, **kw)
    opts_s = dataclasses.replace(opts_d, sparse_rtm="auto")
    calls = []

    def counting(rtm, *a, **k):
        calls.append(tuple(rtm.shape))
        return fused_sweep(rtm, *a, **k)

    got, problem, occ = _port_solve(H, G, opts_s, sweep_fn=counting)
    engaged = tsart.FUSED_ENGAGEMENT["last"]
    want, _, _ = _port_solve(H, G, opts_d, sparse=False)
    assert problem.rtm.shape == (P, V // 2) and occ.occupancy_fraction() == 0.5
    if kw.get("os_subsets", 1) > 1:
        assert engaged == "os-subset-sparse" and not calls
    else:
        assert engaged == "sparse-plain"
        assert calls and set(calls) == {(P, V // 2)}
    _assert_solves(got, want)


@pytest.mark.parametrize("variant", ["linear", "log", "os4", "int8"])
def test_eps0_sparse_matches_the_jax_sparse_solve(variant):
    kw = VARIANTS[variant]
    H = _matrix(seed=2)
    G = _frames(H, 2)
    opts = SolverOptions(max_iterations=25, conv_tolerance=0.0, sparse_rtm="auto", **kw)
    got, _, _ = _port_solve(H, G, opts)
    want = _jax_solve(H, G, _jax_opts(opts))
    assert jsart.FUSED_ENGAGEMENT["last"] in ("sparse-panel", "os-subset-sparse")
    _assert_solves(got, want)


@pytest.mark.parametrize("logarithmic", [False, True])
def test_fp64_auto_declines_in_both_packages(logarithmic):
    """The fp64 parity profile: 'auto' declines quietly in both packages
    (the sparse sweep computes in fp32), so the solves are the dense ones,
    held at a real tolerance to 1e-8."""
    H = _matrix(seed=8)
    G = _frames(H, 2)
    opts = SolverOptions.cpu_parity(logarithmic=logarithmic, max_iterations=200,
                                    conv_tolerance=1e-6, sparse_rtm="auto")
    got, problem, _ = _port_solve(H, G, opts)
    assert problem.occupancy is None and problem.rtm.shape == (P, V)
    assert tsart.FUSED_ENGAGEMENT["last"] == "off"
    want = _jax_solve(H, G, _jax_opts(opts))
    _assert_solves(got, want, fp64=True)


@pytest.mark.parametrize("profile", ["fp32", "fp64"])
def test_batch_and_chain_match_the_jax_solver(profile):
    """``solve_batch`` and ``solve_chain`` of the port's solver with the
    index it builds from the host matrix, against the JAX solver's with
    its own: the same index, and the solutions at the bars (fp32 sparse,
    fp64 declined in both)."""
    H = _matrix(seed=9)
    G = _frames(H, 4, seed=10)
    if profile == "fp32":
        opts = SolverOptions(max_iterations=30, conv_tolerance=0.0, sparse_rtm="auto")
    else:
        opts = SolverOptions.cpu_parity(max_iterations=200, conv_tolerance=1e-6,
                                        sparse_rtm="auto")
    with JaxSolver(H, opts=_jax_opts(opts), mesh=make_mesh(1, 1)) as jsolver:
        jocc = jsolver._tile_occupancy
        jb = jsolver.solve_batch(G[:2], device_result=True)
        jc = jsolver.solve_chain(G[2:])
    with DistributedSARTSolver(H, opts=opts, device="cpu") as solver:
        if profile == "fp32":
            assert solver.tile_occupancy.to_payload() == jocc.to_payload()
            assert solver.problem.rtm.shape == (P, V // 2)
        else:
            assert solver.tile_occupancy is None
        tb = solver.solve_batch(G[:2])
        tc = solver.solve_chain(G[2:])
    for got, want in ((tb, jb), (tc, jc)):
        np.testing.assert_array_equal(got.status, want.status)
        np.testing.assert_array_equal(got.iterations, want.iterations)
        if profile == "fp64":
            np.testing.assert_allclose(got.fetch_solutions(), want.fetch_solutions(), rtol=1e-8)
        else:
            _assert_parity(got.fetch_solutions(), want.fetch_solutions())


def test_scheduler_lanes_match_the_dense_lanes():
    """The continuous-batching stride over the compacted matrix: each
    retired lane's solution equals the dense scheduler's at the fp32 bars."""
    from sartsolver_tpu_torch.sched import ContinuousBatcher

    H = _matrix(seed=17)
    G = _frames(H, 5, seed=23)
    sols = {}
    for mode in ("auto", "off"):
        opts = SolverOptions(max_iterations=30, conv_tolerance=0.0, schedule_stride=4,
                             sparse_rtm=mode)
        out = {}
        with DistributedSARTSolver(H, opts=opts, device="cpu") as solver:
            ContinuousBatcher(solver, lanes=2, on_result=lambda t, c, s, i, cv, fetch, ms:
                              out.__setitem__(t, (s, i, fetch()))).run(
                [(g, float(k), [float(k)]) for k, g in enumerate(G)])
        sols[mode] = out
    assert sorted(sols["auto"]) == sorted(sols["off"]) == [0.0, 1.0, 2.0, 3.0, 4.0]
    for t, (s, i, row) in sols["off"].items():
        s2, i2, row2 = sols["auto"][t]
        assert (s, i) == (s2, i2)
        _assert_parity(row2, row)


# ---------------------------------------------------------------------------
# EPS > 0
# ---------------------------------------------------------------------------

def test_eps_threshold_is_self_consistent_and_residual_matched():
    H = _matrix(seed=11)
    rng = np.random.default_rng(12)
    H[:, TC:2 * TC] = rng.random((P, TC), dtype=np.float32) * 1e-5  # dropped at eps
    G = _frames(H, 1)
    eps = 1e-3
    opts = SolverOptions(max_iterations=60, conv_tolerance=1e-6, sparse_rtm=str(eps))
    got, problem, occ = _port_solve(H, G, opts)
    assert occ.occupancy_fraction() == pytest.approx(0.5)  # tile column 1 dropped
    assert occ.threshold == pytest.approx(eps * np.abs(H).max(), rel=1e-6)
    assert tsart.FUSED_ENGAGEMENT["last"] == "sparse-plain"
    # the dropped voxels have no ray density: they mask out like dark ones
    assert np.all(problem.ray_density.numpy()[TC:2 * TC] == 0)
    dense, _, _ = _port_solve(H, G, SolverOptions(max_iterations=60, conv_tolerance=1e-6),
                              sparse=False)
    want = _jax_solve(H, G, _jax_opts(opts))
    g = _normalized(G)[0][0]
    Ht = tsparse.threshold_matrix(H, occ).astype(np.float64)
    sol = got.solution.numpy()[0].astype(np.float64)
    r_s = np.linalg.norm(g - Ht @ sol)
    r_d = np.linalg.norm(g - H.astype(np.float64) @ dense.solution.numpy()[0])
    r_j = np.linalg.norm(g - Ht @ np.asarray(want.solution)[0].astype(np.float64))
    assert r_s <= 1.2 * r_d + 1e-3
    assert abs(r_s - r_j) <= 5e-3 * max(r_j, 1e-3) + 1e-6


# ---------------------------------------------------------------------------
# engagement: declines, raises, the departures
# ---------------------------------------------------------------------------

def _raise_message(module, opts, problem, **kw):
    with pytest.raises(ValueError) as info:
        module(problem, opts, **kw)
    return str(info.value)


def test_decline_and_raise_reasons_match_jax(capsys):
    import jax.numpy as jnp

    H = _matrix()
    g, msq = _normalized(_frames(H, 1))
    # no index: an explicit threshold raises at the solve, 'auto' runs dense
    for pkg in ("port", "jax"):
        opts = (SolverOptions if pkg == "port" else JaxOptions)(
            max_iterations=5, conv_tolerance=0.0, sparse_rtm="0.001")
        with pytest.raises(ValueError, match="no tile-occupancy index") as info:
            if pkg == "port":
                tsart.solve_normalized_batch(
                    tsart.make_problem(H, opts=opts, device="cpu"), torch.as_tensor(g).float(),
                    torch.as_tensor(msq).float(), torch.zeros((1, V)), opts=opts,
                    use_guess=True, device="cpu")
            else:
                jsart.solve_normalized_batch(
                    jsart.make_problem(H, opts=opts), jnp.asarray(g, jnp.float32),
                    jnp.asarray(msq, jnp.float32), jnp.zeros((1, V), jnp.float32), opts=opts,
                    axis_name=None, voxel_axis=None, use_guess=True)
        if pkg == "port":
            port_msg = str(info.value)
        else:
            assert str(info.value) == port_msg
    # log + divergence recovery on the classic sweep: the same reason
    occ = tsparse.build_tile_occupancy(H)
    opts = SolverOptions(logarithmic=True, divergence_recovery=2, sparse_rtm="0.0")
    with pytest.raises(ValueError, match="divergence_recovery on the logarithmic solver"):
        tsart.make_problem(H, opts=opts, device="cpu", tile_occupancy=occ)
    problem = tsart.make_problem(H, opts=dataclasses.replace(opts, sparse_rtm="auto"),
                                 device="cpu", tile_occupancy=occ)
    assert problem.occupancy is None  # 'auto' declined
    # an index of another matrix
    other = tsparse.build_tile_occupancy(np.ones((P, 2 * V), np.float32))
    with pytest.raises(ValueError, match=r"covers \[64, 2048\]"):
        tsart.make_problem(H, opts=SolverOptions(sparse_rtm="0.0"), device="cpu",
                           tile_occupancy=other)
    # the flag-only gate of the ingest: 'auto' warns and declines, EPS raises
    gate = SolverOptions(logarithmic=True, divergence_recovery=2, sparse_rtm="auto")
    assert mh.sparse_tile_stats_or_decline(gate, P, V) is None
    assert "Warning: sparse_rtm declines here (logarithmic + divergence_recovery" \
        in capsys.readouterr().err
    with pytest.raises(SartInputError, match="Argument sparse_rtm=0.01: logarithmic"):
        mh.sparse_tile_stats_or_decline(dataclasses.replace(gate, sparse_rtm="0.01"), P, V)
    assert mh.sparse_tile_stats_or_decline(SolverOptions(), P, V) is None
    stats = mh.sparse_tile_stats_or_decline(SolverOptions(sparse_rtm="auto"), 60, 1000)
    assert (stats.rows, stats.cols) == (64, 1024)
    # fp64: the JAX reason, word for word
    opts64 = SolverOptions.cpu_parity(sparse_rtm="0.0")
    with pytest.raises(ValueError) as info:
        tsart.make_problem(H, opts=opts64, device="cpu", tile_occupancy=occ)
    assert "dtype=float64 / rtm dtype=float64 (the sparse panel sweep computes in fp32" \
        in str(info.value)


def test_options_validation_matches_jax():
    for bad in ("1.5", "nonsense", "-0.1", "nan"):
        for cls in (SolverOptions, JaxOptions):
            with pytest.raises(ValueError, match="sparse_rtm"):
                cls(sparse_rtm=bad)
    for cls in (SolverOptions, JaxOptions):
        with pytest.raises(ValueError, match="sparse_rtm"):
            cls(sparse_rtm="auto", fused_sweep="on")
    assert SolverOptions(sparse_rtm="0.01").sparse_epsilon() == 0.01
    assert SolverOptions(sparse_rtm="auto").sparse_epsilon() == 0.0
    assert SolverOptions().sparse_epsilon() is None
    assert SolverOptions(sparse_rtm="0.01").sparse_explicit()
    assert not SolverOptions(sparse_rtm="auto").sparse_explicit()


@pytest.mark.parametrize("sparse_rtm", ["auto", "0.0"])
def test_no_static_unroll_cap(monkeypatch, sparse_rtm):
    """A departure from the JAX package, on purpose: its OS cycle declines
    ('auto') or raises (a threshold) past ``SART_SPARSE_UNROLL_MAX``
    occupied panels, a bound on an XLA program's size; the port has no such
    program and engages at any panel count."""
    monkeypatch.setattr(jsart, "SPARSE_STATIC_UNROLL_MAX", 1)
    H = _matrix(seed=27)
    G = _frames(H, 1)
    opts = SolverOptions(max_iterations=10, conv_tolerance=0.0, sparse_rtm=sparse_rtm,
                         os_subsets=4)
    got, problem, _ = _port_solve(H, G, opts)
    assert tsart.FUSED_ENGAGEMENT["last"] == "os-subset-sparse"
    assert problem.rtm.shape == (P, V // 2)
    assert np.isfinite(got.solution.numpy()).all()
    if sparse_rtm == "auto":
        _jax_solve(H, G, _jax_opts(opts))
        assert jsart.FUSED_ENGAGEMENT["last"] == "os-subset"  # declined to dense
    else:
        with pytest.raises(ValueError, match="UNROLL_MAX"):
            _jax_solve(H, G, _jax_opts(opts))


def test_all_empty_rows_and_columns_mask_cleanly():
    H = _matrix(seed=13)
    H[5, :] = 0.0  # a dead pixel row
    H[:, 7] = 0.0  # a dead voxel column inside an occupied tile column
    G = _frames(H, 1)
    opts = SolverOptions(max_iterations=25, conv_tolerance=0.0)
    got, _, _ = _port_solve(H, G, dataclasses.replace(opts, sparse_rtm="auto"))
    want, _, _ = _port_solve(H, G, opts, sparse=False)
    assert np.isfinite(got.solution.numpy()).all()
    _assert_solves(got, want)


@pytest.mark.parametrize("logarithmic", [False, True])
def test_fully_empty_operator_is_benign(logarithmic):
    """No occupied column: no kernel launch, ``fitted = 0``, every voxel
    given the base update; finite, as in the JAX package."""
    H = np.zeros((P, V), np.float32)
    opts = SolverOptions(max_iterations=5, conv_tolerance=0.0, sparse_rtm="auto",
                         logarithmic=logarithmic)
    problem, occ = tsart.make_sparse_problem(H, opts=opts, device="cpu")
    assert occ.occupancy_fraction() == 0.0 and problem.rtm.shape == (P, 0)
    calls = []
    g = torch.full((1, P), 0.5)
    res = tsart.solve_normalized_batch(problem, g, torch.ones(1), torch.zeros((1, V)),
                                       opts=opts, use_guess=True, device="cpu",
                                       sweep_fn=lambda *a, **k: calls.append(1))
    assert not calls
    assert np.isfinite(res.solution.numpy()).all()
    jres = _jax_solve(H, np.full((1, P), 0.5), _jax_opts(opts))
    np.testing.assert_allclose(res.solution.numpy(), np.asarray(jres.solution), rtol=1e-6)


def test_sparse_metrics_are_recorded():
    obs_metrics.reset_registry()
    H = _matrix(seed=19)
    _port_solve(H, _frames(H, 1), SolverOptions(max_iterations=3, conv_tolerance=0.0,
                                                sparse_rtm="auto"))
    reg = obs_metrics.get_registry()
    assert reg.gauge("rtm_tile_occupancy").value == pytest.approx(0.5)
    # 4 empty tile columns x 8 tile rows, skipped by each of 3 sweeps
    assert reg.counter("sparse_tiles_skipped_total", path="sparse_panel").value == 3 * 32
    assert reg.gauge("fused_panel_voxels", path="sparse_panel").value == TC


def test_device_buffer_corruption_hits_the_compacted_matrix(monkeypatch):
    """The ``device.buffer`` fault and the re-audit act on the matrix the
    sweeps read: the compacted one."""
    from sartsolver_tpu_torch.resilience import faults

    H = _matrix(seed=31)
    opts = SolverOptions(max_iterations=5, conv_tolerance=0.0, sparse_rtm="auto",
                         integrity=True)
    with DistributedSARTSolver(H, opts=opts, device="cpu") as solver:
        before = solver.problem.rtm.clone()
        assert solver.reaudit_ray_stats() == []
        monkeypatch.setenv("SART_FAULT", "device.buffer:corrupt:1:1")
        faults.reset()
        solver.solve_batch(_frames(H, 1))
        assert not torch.equal(solver.problem.rtm, before)
        assert solver.problem.rtm.shape == (P, V // 2)
        assert solver.reaudit_ray_stats()
    faults.reset()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def write_sparse_world(d, n_frames=4, seed=0):
    """Two cameras of 8 x 4 pixels (P = 64) over a 32 x 32 x 1 grid (V =
    1024) whose tile columns 1, 3, 5 and 6 no pixel sees; camera A in a dense
    and a sparse segment. Returns ``(paths, H)``; the frames are ``H @
    (f_true * s)`` for growing ``s``."""
    rng = np.random.default_rng(seed)
    half = P // 2
    mask = np.ones((8, 4), np.int64)
    H = _matrix(seed)
    f_true = rng.uniform(0.5, 2.0, V)
    cells = np.arange(V, dtype=np.int64)
    d = str(d)
    paths = {k: os.path.join(d, f"{k}.h5")
             for k in ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b", "laplacian")}
    old = fx.NX, fx.NY, fx.NZ
    fx.NX, fx.NY, fx.NZ = 32, 32, 1
    try:
        fx._write_rtm_file(paths["rtm_a1"], fx.CAM_A, mask, H[:half, :V // 2],
                           cells[:V // 2], cells[:V // 2])
        fx._write_rtm_file(paths["rtm_a2"], fx.CAM_A, mask, H[:half, V // 2:],
                           cells[V // 2:], cells[:V // 2], sparse=True)
        fx._write_rtm_file(paths["rtm_b"], fx.CAM_B, mask, H[half:], cells, cells)
    finally:
        fx.NX, fx.NY, fx.NZ = old
    scales = 1.0 + 0.1 * np.arange(n_frames)
    times = 0.1 + 0.1 * np.arange(n_frames)
    for cam, rows, key, jitter in ((fx.CAM_A, slice(0, half), "img_a", 0.0),
                                   (fx.CAM_B, slice(half, None), "img_b", 0.003)):
        frames = np.stack([fx.frame_from_measurement(mask, H[rows].astype(np.float64)
                                                     @ (f_true * s)) for s in scales])
        fx._write_image_file(paths[key], cam, frames, times + jitter)
    fx.write_laplacian_file(paths["laplacian"], nvoxel=V)
    return paths, H


def _inputs(paths):
    return [paths[k] for k in ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b")]


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f["solution"][k][:] for k in f["solution"]}


@pytest.fixture(scope="module")
def sparse_world(tmp_path_factory):
    return write_sparse_world(tmp_path_factory.mktemp("sparse_world"))


@pytest.mark.parametrize("mode", ["auto", "0.05"])
def test_cli_matches_jax_cli(sparse_world, tmp_path, capsys, mode):
    """``--sparse_rtm auto`` and ``0.05`` through both CLIs (the port on
    ``--device cpu``): the same ``sparse:`` line (occupancy, threshold,
    digest), the same frames in fitted space within 5e-3; the port's file
    equal to its dense run's in fitted space (at ``auto``)."""
    paths, H = sparse_world
    flags = ["-m", "40", "-c", "1e-12", "-l", paths["laplacian"], "-b", "0.001",
             "--sparse_rtm", mode]
    jax_out, port_out = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jax_main(["-o", jax_out, *_inputs(paths), *flags, "--pixel_shards", "1"]) == 0
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("sparse:")]
    assert torch_main(["-o", port_out, *_inputs(paths), *flags, "--device", "cpu",
                       "--timing"]) == 0
    out = capsys.readouterr().out
    port_lines = [ln for ln in out.splitlines() if ln.startswith("sparse:")]
    assert port_lines == jax_lines and len(port_lines) == 1
    assert "engaged=sparse-plain" in out and "sweep=fused-sparse" in out
    jsol, tsol = _read(jax_out), _read(port_out)
    np.testing.assert_array_equal(tsol["time"], jsol["time"])
    np.testing.assert_array_equal(tsol["status"], jsol["status"])
    occ = tsparse.build_tile_occupancy(H, epsilon=float(mode) if mode != "auto" else 0.0)
    Ht = tsparse.threshold_matrix(H, occ).astype(np.float64)
    fit_t, fit_j = tsol["value"] @ Ht.T, jsol["value"] @ Ht.T
    assert np.abs(fit_t - fit_j).max() <= 5e-3 * np.abs(fit_j).max()
    if mode == "auto":
        dense_out = str(tmp_path / "dense.h5")
        assert torch_main(["-o", dense_out, *_inputs(paths), *flags[:-2], "--device",
                           "cpu"]) == 0
        fit_d = _read(dense_out)["value"] @ Ht.T
        assert np.abs(fit_t - fit_d).max() <= 5e-3 * np.abs(fit_d).max()


def test_cli_fp64_auto_declines_like_jax(sparse_world, tmp_path, capsys):
    paths, _ = sparse_world
    flags = ["--use_cpu", "-m", "300", "-c", "1e-6", "--sparse_rtm", "auto"]
    jax_out, port_out = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jax_main(["-o", jax_out, *_inputs(paths), *flags, "--pixel_shards", "1"]) == 0
    assert torch_main(["-o", port_out, *_inputs(paths), *flags, "--timing"]) == 0
    assert "engaged=off" in capsys.readouterr().out
    jsol, tsol = _read(jax_out), _read(port_out)
    for key in ("status", "iterations"):
        np.testing.assert_array_equal(tsol[key], jsol[key])
    np.testing.assert_allclose(tsol["value"], jsol["value"], rtol=1e-8)


@pytest.mark.parametrize("argv,message", [
    (["--sparse_rtm", "1.5"], "Argument sparse_rtm must be 'auto', 'off' or a relative"),
    (["--sparse_rtm", "x"], "Argument sparse_rtm must be 'auto', 'off' or a relative"),
    (["--sparse_rtm", "0.01", "--use_cpu"], "needs the fp32 device profile"),
    (["--sparse_rtm", "auto", "--fused_sweep", "on"], "engages the block-sparse panel sweep"),
    (["--sparse_rtm", "0.01", "-L", "--divergence_recovery", "2"],
     "Argument sparse_rtm=0.01: logarithmic + divergence_recovery"),
])
def test_cli_sparse_flag_refusals_match_jax(sparse_world, tmp_path, capsys, argv, message):
    paths, _ = sparse_world
    for main, extra in ((torch_main, ["--device", "cpu"]), (jax_main, ["--pixel_shards", "1"])):
        try:
            rc = main(["-o", str(tmp_path / "x.h5"), *_inputs(paths), *argv, *extra])
        except SystemExit as err:
            rc = err.code
        assert rc == 1
        assert message in capsys.readouterr().err


def test_cli_env_precedence(sparse_world, tmp_path, capsys, monkeypatch):
    """``SART_SPARSE_RTM`` turns the mode on without the flag; the flag
    wins over it."""
    paths, _ = sparse_world
    base = ["-m", "5", "--device", "cpu", *_inputs(paths)]
    monkeypatch.setenv("SART_SPARSE_RTM", "auto")
    assert torch_main(["-o", str(tmp_path / "a.h5"), *base]) == 0
    assert "sparse: tile occupancy 0.500" in capsys.readouterr().out
    assert torch_main(["-o", str(tmp_path / "b.h5"), *base, "--sparse_rtm", "off"]) == 0
    assert "sparse:" not in capsys.readouterr().out


def test_cli_integrity_with_threshold_skips_ray_stats_verify(tmp_path, capsys):
    """``--integrity`` with a threshold that drops tiles: the post-upload
    ray-stats check is skipped with the JAX package's warning (the ingest
    summed the dropped entries), and the run completes; at 'auto' the check
    runs and passes."""
    NP_, NV = 16, 256
    rng = np.random.default_rng(0)
    H = (rng.random((NP_, NV)) * 0.9 + 0.1).astype(np.float32)
    H[:, 128:] = 1e-5  # sub-threshold tiles: eps=0.01 drops them
    mask = np.ones((4, 4), np.int64)
    cells = np.arange(NV, dtype=np.int64)
    old = fx.NX, fx.NY, fx.NZ
    fx.NX, fx.NY, fx.NZ = 16, 16, 1
    try:
        fx._write_rtm_file(str(tmp_path / "rtm.h5"), "cam", mask, H, cells, cells)
    finally:
        fx.NX, fx.NY, fx.NZ = old
    frames = np.stack([fx.frame_from_measurement(
        mask, H.astype(np.float64) @ (rng.random(NV) + 0.5))])
    fx._write_image_file(str(tmp_path / "img.h5"), "cam", frames, [0.1])
    argv = [str(tmp_path / "rtm.h5"), str(tmp_path / "img.h5"), "-m", "50", "--integrity",
            "--device", "cpu"]
    assert torch_main(["-o", str(tmp_path / "a.h5"), *argv, "--sparse_rtm", "0.01"]) == 0
    assert "ray-stats verification skipped" in capsys.readouterr().err
    assert torch_main(["-o", str(tmp_path / "b.h5"), *argv, "--sparse_rtm", "auto"]) == 0
    assert "ray-stats verification skipped" not in capsys.readouterr().err


def test_cli_metrics_artifact_carries_the_sparse_run(sparse_world, tmp_path, capsys):
    paths, _ = sparse_world
    art = str(tmp_path / "run.jsonl")
    assert torch_main(["-o", str(tmp_path / "a.h5"), *_inputs(paths), "-m", "4",
                       "--device", "cpu", "--sparse_rtm", "auto", "--metrics_out", art]) == 0
    import json

    recs = [json.loads(ln) for ln in open(art)]
    meta = next(r for r in recs if r.get("type") == "meta")
    assert meta["operator"] == "tileskip"
    names = {r["name"]: r for r in recs if r.get("type") == "metric"}
    assert names["rtm_tile_occupancy"]["value"] == pytest.approx(0.5)
    assert names["sparse_tiles_skipped_total"]["value"] > 0
    from sartsolver_tpu.obs.cli import metrics_main as jax_metrics

    assert jax_metrics(["--check", art]) == 0
