"""The factored RTM (``H ~= S + U V^T``, ``--lowrank_rtm``) of the port against
the JAX package's, on the CPU.

Ports the one-device, non-serving cases of ``tests/test_operator.py``'s
factored backend (``:790-1087``) on its case (a 1024 x 512 matrix: a dense
core on the first 256 voxel columns plus a rank-2 floor below the 5% tile
threshold everywhere):

- the host part: ``split_sparse_core``, ``randomized_svd`` and
  ``build_lowrank_operator`` give factors byte-identical to the JAX
  package's; rank determinism; the operator's identity, accounting, spec
  and cache key equal to the JAX operator's; the quality gate's refusals
  and ``lowrank_static_decline_reason`` with the JAX words; the parity gap;
- the device part: forward, back, ray stats and subset densities against
  the materialized fp64 matrix and against the JAX functions, on the whole
  core and on its occupied columns (what the solver holds), int8 included;
- the solver: ``LOWRANK_PARITY_LEGS`` and fp64 against the JAX factored
  solve (equal statuses and iterations, solutions within ``PARITY_RTOL``,
  ``conv_tolerance=0``), the staged int8 codes and scales equal to the JAX
  solver's, the int8 solve against the dense solve of its dequantized
  operator, the restrictions with the JAX words; only the occupied columns
  of S held on the device;
- ``sartsolve --lowrank_rtm`` against the JAX CLI: an explicit rank on the
  fixture world, ``auto``'s loud decline, and on a small reflective world
  (``chip_smoke.write_reflective_world``) ``auto`` taking rank 4 and rank 2
  exiting 1 with the gate's words; the flag refusals.

The pixel-sharded leg waits for the port's meshes (queue A item 4); the
session leg for the serving engine (queue A item 5).
"""

import os
import sys

import h5py
import numpy as np
import pytest
import torch

import fixtures as fx
import test_operator as T
from sartsolver_tpu.cli import main as jax_main
from sartsolver_tpu.config import SartInputError as JaxInputError
from sartsolver_tpu.config import SolverOptions as JaxOptions
from sartsolver_tpu.operators import lowrank as jl
from sartsolver_tpu.parallel.mesh import make_mesh
from sartsolver_tpu.parallel.sharded import DistributedSARTSolver as JaxSolver

from sartsolver_tpu_torch.cli import main as torch_main
from sartsolver_tpu_torch.config import SartInputError, SolverOptions
from sartsolver_tpu_torch.models.convert import operator_from_jax
from sartsolver_tpu_torch.operators import lowrank as tl
from sartsolver_tpu_torch.ops.laplacian import make_laplacian
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY_RTOL = tl.PARITY_RTOL
_CACHE = {}


def _case():
    """(H, port operator, JAX operator, g): the JAX suite's case, the port's
    operator built by its own gate on the CPU."""
    if "case" not in _CACHE:
        H, jop, g = T._lowrank_case()
        op, reason = tl.build_lowrank_operator(H, rank=2, device="cpu")
        assert reason is None
        _CACHE["case"] = (H, op, jop, g)
    return _CACHE["case"]


def _opts(jax=False, **kw):
    kw.setdefault("max_iterations", 40)
    kw.setdefault("conv_tolerance", 0.0)
    kw.setdefault("fused_sweep", "off")
    if kw.pop("fp64", False):
        return (JaxOptions if jax else SolverOptions).cpu_parity(**kw)
    return (JaxOptions if jax else SolverOptions)(**kw)


def _assert_parity(got, want, nvoxel=512, rtol=PARITY_RTOL):
    assert int(got.status) == int(want.status)
    assert int(got.iterations) == int(want.iterations)
    a = np.asarray(got.solution)[:nvoxel]
    b = np.asarray(want.solution)[:nvoxel]
    assert np.max(np.abs(a - b)) <= rtol * max(np.max(np.abs(b)), 1e-12)


# ---- host part ----------------------------------------------------------------

def test_factors_byte_identical_to_the_jax_package():
    H, op, jop, _g = _case()
    S, occ = tl.split_sparse_core(H)
    jS, jocc = jl.split_sparse_core(H)
    assert S.tobytes() == jS.tobytes()
    assert occ.digest == jocc.digest
    for r in (1, 2, 3, 8):
        for seed in (tl.LOWRANK_SEED, 3):
            U, V = tl.randomized_svd(H - S, r, seed=seed)
            jU, jV = jl.randomized_svd(H - jS, r, seed=seed)
            assert U.tobytes() == jU.tobytes() and V.tobytes() == jV.tobytes()
    assert op.payload().tobytes() == jop.payload().tobytes()
    for a, b in zip(op.factors(), jop.factors()):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="must lie in"):
        tl.randomized_svd(H - S, 0)


def test_rank_determinism():
    H, op, _jop, _g = _case()
    S, _occ = tl.split_sparse_core(H)
    U1, V1 = tl.randomized_svd(H - S, 2)
    U2, V2 = tl.randomized_svd(H - S, 2)
    assert U1.tobytes() == U2.tobytes() and V1.tobytes() == V2.tobytes()
    op2, reason = tl.build_lowrank_operator(H, rank=2, check_parity=False, device="cpu")
    assert reason is None and op2.cache_key() == op.cache_key()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tensor_rsvd_and_frobenius_against_the_host_functions(dtype):
    """The card's steps of the gate (``_card_residual``,
    ``randomized_svd_tensor``, ``_frobenius_residual``; fp32 is what the
    card holds) run here on CPU tensors, in bands of 100 rows: the residual
    equal to ``H - S``, ``U V^T`` within 1e-6 of the host factors' product
    (fp32 factors of the same fp64 steps), and the Frobenius residual
    within 1e-5 of numpy's plus 1e-9 of ``||H||`` (numpy's is fp32
    arithmetic: where the residual is exactly of the rank, both are
    rounding noise, five orders below the gate's 1e-4 of ``||H||``)."""
    H, _op, _jop, _g = _case()
    S, _occ = tl.split_sparse_core(H)
    R32, h_norm = tl._card_residual(H, S, "cpu", band=100)
    np.testing.assert_array_equal(R32.numpy(), H - S)
    assert abs(h_norm - float(np.linalg.norm(H.astype(np.float64)))) <= 1e-12 * h_norm
    R = (H - S).astype(np.float64)
    Rt = R32.to(dtype)
    for r in (1, 2, 3, 8):
        U, V = tl.randomized_svd(R, r)
        tU, tV = tl.randomized_svd_tensor(Rt, r, band=100)
        assert tU.dtype == tV.dtype == np.float32 and tU.shape == U.shape
        want = U.astype(np.float64) @ V.T.astype(np.float64)
        got = tU.astype(np.float64) @ tV.T.astype(np.float64)
        assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1e-30)
        frob = tl._frobenius_residual(Rt, tU, tV, band=100)
        host = float(np.linalg.norm((H - S) - U @ V.T))
        assert abs(frob - host) <= 1e-5 * host + 1e-9 * float(np.linalg.norm(H))
    with pytest.raises(ValueError, match="must lie in"):
        tl.randomized_svd_tensor(Rt, 0)


def test_operator_identity_and_accounting():
    H, op, jop, _g = _case()
    assert op.kind == "lowrank" and op.shape == (1024, 512) and op.rank == 2
    S = op.payload()
    np.testing.assert_array_equal(S[:, :256], H[:, :256])
    assert (S[:, 256:] == 0.0).all()
    assert op.resident_nbytes() == (1024 * 512 + (1024 + 512) * 2) * 4 == jop.resident_nbytes()
    M = op.materialize()
    assert np.linalg.norm(M - H) / np.linalg.norm(H) <= tl.DEFAULT_TOL
    spec, jspec = op.spec(), jop.spec()
    assert (spec.rank, spec.nvoxel, spec.panel_voxels, spec.occ_panels) == (
        jspec.rank, jspec.nvoxel, jspec.panel_voxels, jspec.occ_panels) == (
        2, 512, 256, (True, False))
    assert op.cache_key() == jop.cache_key()
    assert op.cache_key().startswith("lowrank:1024x512:float32:2:")
    np.testing.assert_array_equal(op.occupied_columns(), np.arange(256))
    # the port solver's spec: the tile columns of the split's index
    sspec = op.solver_spec()
    assert sspec.nvoxel == 512 and sspec.panel_voxels == 128
    assert sspec.occ_panels == (True, True, False, False)
    np.testing.assert_array_equal(sspec.occupied_columns(), np.arange(256))
    # the JAX operator carried across
    conv = operator_from_jax(jop)
    assert isinstance(conv, tl.LowRankOperator) and conv.cache_key() == jop.cache_key()
    for kw, match in ((dict(rank=0, nvoxel=512, panel_voxels=256, occ_panels=(True,) * 2),
                       ">= 1"),
                      (dict(rank=2, nvoxel=512, panel_voxels=200, occ_panels=(True,) * 2),
                       "divide"),
                      (dict(rank=2, nvoxel=512, panel_voxels=256, occ_panels=(True,)),
                       "entries")):
        with pytest.raises(ValueError, match=match) as got:
            tl.LowRankSpec(**kw)
        with pytest.raises(ValueError) as want:
            jl.LowRankSpec(**kw)
        assert str(got.value) == str(want.value)


def test_quality_gate_matches_the_jax_package():
    H, _op, _jop, _g = _case()
    for rank, match in ((1, "factorization gate"), (0, "must lie in"),
                        (10_000, "must lie in"), ("three", "positive integer")):
        with pytest.raises(SartInputError, match=match) as got:
            tl.build_lowrank_operator(H, rank=rank, device="cpu")
        with pytest.raises(JaxInputError) as want:
            jl.build_lowrank_operator(H, rank=rank)
        assert str(got.value) == str(want.value)
    flat = (np.random.default_rng(11).random((64, 128)) * 0.9 + 0.1).astype(np.float32)
    op, reason = tl.build_lowrank_operator(flat, rank="auto", device="cpu")
    assert op is None and reason == jl.build_lowrank_operator(flat, rank="auto")[1]
    assert "no tile fell below" in reason
    tiny = np.ones((2, 3), np.float32)
    assert tl.build_lowrank_operator(tiny, rank="auto")[1] == \
        jl.build_lowrank_operator(tiny, rank="auto")[1]


def test_static_decline_reason_matches_the_jax_package():
    opts, jopts = _opts(), _opts(jax=True)
    for kw in ({}, {"process_count": 2}, {"n_voxel_shards": 2}, {"has_laplacian": True}):
        assert tl.lowrank_static_decline_reason(opts, **kw) == \
            jl.lowrank_static_decline_reason(jopts, **kw)
    assert "checksum" in tl.lowrank_static_decline_reason(_opts(integrity=True))
    assert tl.lowrank_static_decline_reason(_opts(integrity=True)) == \
        jl.lowrank_static_decline_reason(_opts(jax=True, integrity=True))


def test_solve_parity_gap_matches_the_jax_gate():
    H, op, jop, _g = _case()
    gap = tl.solve_parity_gap(H, op, device="cpu")
    jgap = jl.solve_parity_gap(H, jop)
    assert gap <= PARITY_RTOL and jgap <= PARITY_RTOL
    assert abs(gap - jgap) <= 1e-5


# ---- device part ----------------------------------------------------------------

def _M(op):
    S = op.payload().astype(np.float64)
    U, V = (x.astype(np.float64) for x in op.factors())
    return S + U @ V.T


@pytest.mark.parametrize("held", ["whole", "columns"])
def test_functions_match_the_materialized_matrix(held):
    _H, op, _jop, _g = _case()
    spec = op.spec()
    M = _M(op)
    S = torch.as_tensor(op.payload())
    cols = None
    if held == "columns":
        cols = torch.as_tensor(op.occupied_columns())
        S = S[:, cols].contiguous()
    U, V = (torch.as_tensor(x) for x in op.factors())
    rng = np.random.default_rng(3)
    f = rng.uniform(0.0, 2.0, (3, 512)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (3, 1024)).astype(np.float32)
    kw = dict(cols=cols)
    tol = dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tl.lowrank_forward(S, U, V, torch.as_tensor(f), spec, **kw),
                               f.astype(np.float64) @ M.T, **tol)
    np.testing.assert_allclose(tl.lowrank_forward(S, U, V, torch.as_tensor(f[0]), spec, **kw),
                               M @ f[0].astype(np.float64), **tol)
    np.testing.assert_allclose(tl.lowrank_back(S, U, V, torch.as_tensor(w), spec, **kw),
                               w.astype(np.float64) @ M, **tol)
    dens, length = tl.lowrank_ray_stats(S, U, V, spec, **kw)
    np.testing.assert_allclose(dens, M.sum(axis=0), **tol)
    np.testing.assert_allclose(length, M.sum(axis=1), **tol)
    sub = tl.lowrank_subset_density(S, U, V, spec, 4, **kw)
    np.testing.assert_allclose(sub, M.reshape(256, 4, 512).sum(axis=0), **tol)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_functions_match_the_jax_functions(storage):
    """The same numpy inputs (S, its int8 codes and scales, the factors)
    through both packages' functions."""
    import jax.numpy as jnp

    _H, op, _jop, _g = _case()
    spec = op.spec()
    jspec = jl.LowRankSpec(rank=spec.rank, nvoxel=spec.nvoxel,
                           panel_voxels=spec.panel_voxels, occ_panels=spec.occ_panels)
    S = op.payload()
    U, V = op.factors()
    scale = None
    if storage == "int8":
        amax = np.abs(S).max(axis=0)
        scale = np.where(amax > 0, amax / np.float32(127.0), 1.0).astype(np.float32)
        S = np.clip(np.round(S / scale[None, :]), -127, 127).astype(np.int8)
    rng = np.random.default_rng(5)
    f = rng.uniform(0.0, 2.0, (2, 512)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (2, 1024)).astype(np.float32)
    t = dict(scale=None if scale is None else torch.as_tensor(scale))
    j = dict(scale=None if scale is None else jnp.asarray(scale))
    St, Ut, Vt = torch.as_tensor(S), torch.as_tensor(U), torch.as_tensor(V)
    Sj, Uj, Vj = jnp.asarray(S), jnp.asarray(U), jnp.asarray(V)
    tol = dict(rtol=2e-6, atol=2e-5)
    np.testing.assert_allclose(tl.lowrank_forward(St, Ut, Vt, torch.as_tensor(f), spec, **t),
                               jl.lowrank_forward(Sj, Uj, Vj, jnp.asarray(f), jspec, **j), **tol)
    np.testing.assert_allclose(tl.lowrank_back(St, Ut, Vt, torch.as_tensor(w), spec, **t),
                               jl.lowrank_back(Sj, Uj, Vj, jnp.asarray(w), jspec, **j), **tol)
    for got, want in zip(tl.lowrank_ray_stats(St, Ut, Vt, spec, **t),
                         jl.lowrank_ray_stats(Sj, Uj, Vj, jspec, **j)):
        np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(tl.lowrank_subset_density(St, Ut, Vt, spec, 4, **t),
                               jl.lowrank_subset_density(Sj, Uj, Vj, jspec, 4, **j), **tol)


# ---- the solver ------------------------------------------------------------------

# (fp64 compares the core-determined voxels, as the JAX suite's log leg
# does: the other half is pinned by the rank-2 floor alone, two constraints
# for 256 voxels, and drifts along those null directions with the order of
# the products; the determined half agrees to ~1e-10)
LOWRANK_PARITY_LEGS = T.LOWRANK_PARITY_LEGS + [
    ("bf16", {"rtm_dtype": "bfloat16"}, 512),
    ("fp64", {"fp64": True}, 256),
]


@pytest.mark.parametrize("name,kw,nvox", LOWRANK_PARITY_LEGS,
                         ids=[n for n, *_ in LOWRANK_PARITY_LEGS])
def test_parity_against_the_jax_factored_solve(name, kw, nvox):
    H, op, jop, g = _case()
    fac = DistributedSARTSolver(operator=op, opts=_opts(**kw), device="cpu")
    ref = JaxSolver(operator=jop, opts=_opts(jax=True, **kw), mesh=make_mesh(1, 1))
    try:
        # only the occupied columns of S are held
        assert fac.problem.rtm.shape == (1024, 256)
        rtol = 1e-8 if kw.get("fp64") else PARITY_RTOL
        for scale in (1.0, 1.3):
            _assert_parity(fac.solve(g * scale), ref.solve(g * scale), nvoxel=nvox, rtol=rtol)
    finally:
        ref.close()


def test_int8_codes_and_the_dequantized_oracle():
    """The int8 factored problem's codes and scales are the JAX solver's (on
    the occupied columns); its solve matches the dense fp32 solve of its
    dequantized operator to rounding, and the JAX int8 factored solve."""
    H, op, jop, g = _case()
    fac = DistributedSARTSolver(operator=op, opts=_opts(rtm_dtype="int8"), device="cpu")
    ref = JaxSolver(operator=jop, opts=_opts(jax=True, rtm_dtype="int8"), mesh=make_mesh(1, 1))
    try:
        pr, jpr = fac.problem, ref.problem
        cols = pr.cols.numpy()
        np.testing.assert_array_equal(pr.rtm.numpy(), np.asarray(jpr.rtm)[:, cols])
        np.testing.assert_array_equal(pr.rtm_scale.numpy(), np.asarray(jpr.rtm_scale)[cols])
        np.testing.assert_array_equal(pr.factor_u.numpy(), np.asarray(jpr.factor_u))
        np.testing.assert_array_equal(pr.factor_v.numpy(), np.asarray(jpr.factor_v))
        np.testing.assert_array_equal(pr.factor_scale.numpy(), np.asarray(jpr.factor_scale))
        fs = pr.factor_scale.numpy()
        S_dq = np.zeros((1024, 512), np.float32)
        S_dq[:, cols] = pr.rtm.numpy().astype(np.float32) * pr.rtm_scale.numpy()[None, :]
        M_dq = S_dq + (pr.factor_u.numpy() * fs[0]) @ (pr.factor_v.numpy() * fs[1]).T
        assert 1e-4 < np.max(np.abs(M_dq - H)) / np.abs(H).max() < 0.01
        dq = DistributedSARTSolver(M_dq.astype(np.float32), opts=_opts(), device="cpu")
        for s in (1.0, 1.3):
            got = fac.solve(g * s)
            _assert_parity(got, dq.solve(g * s))
            _assert_parity(got, ref.solve(g * s))
    finally:
        ref.close()


RESTRICTIONS = [
    ({"integrity": True}, "integrity"),
    ({"sparse_rtm": "1e-8"}, "tile-thresholds"),
]


@pytest.mark.parametrize("kw,match", RESTRICTIONS, ids=["integrity", "sparse-explicit"])
def test_restrictions_match_the_jax_solver(kw, match):
    _H, op, jop, _g = _case()
    base = dict(max_iterations=5, conv_tolerance=1e-30, fused_sweep="off")
    with pytest.raises(SartInputError, match=match) as got:
        DistributedSARTSolver(operator=op, opts=SolverOptions(**base, **kw), device="cpu")
    with pytest.raises(JaxInputError) as want:
        JaxSolver(operator=jop, opts=JaxOptions(**base, **kw), mesh=make_mesh(1, 1))
    assert str(got.value) == str(want.value)


def test_laplacian_matrix_and_fused_conflicts():
    H, op, _jop, g = _case()
    lap = make_laplacian(np.array([0]), np.array([0]), np.array([1.0], np.float32),
                         nvoxel=512, device="cpu")
    with pytest.raises(SartInputError, match="beta_laplace"):
        DistributedSARTSolver(operator=op, laplacian=lap, opts=_opts(), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        DistributedSARTSolver(np.zeros((4, 4), np.float32), operator=op, opts=_opts(),
                              device="cpu")
    with pytest.raises(SartInputError, match="fused_sweep"):
        DistributedSARTSolver(operator=op, opts=SolverOptions(
            max_iterations=5, conv_tolerance=1e-30, fused_sweep="on"), device="cpu")
    # int8 is admitted and needs no fused sweep
    s = DistributedSARTSolver(operator=op, opts=_opts(max_iterations=3, rtm_dtype="int8"),
                              device="cpu")
    assert np.isfinite(s.solve(g).solution).all()


# ---- sartsolve --lowrank_rtm against the JAX CLI --------------------------------

def _rc(main, argv) -> int:
    try:
        return main(argv)
    except SystemExit as err:
        return err.code


def _solution(path):
    with h5py.File(path, "r") as f:
        return {k: f["solution"][k][...] for k in f["solution"]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixture_world")
    paths, H, f_true, _times, _scales = fx.write_world(str(d), n_frames=2,
                                                       with_laplacian=True)
    return paths, H


def test_cli_explicit_rank_against_the_jax_cli(world, tmp_path, capsys):
    """``--lowrank_rtm 14`` on the fixture world (14 x 16, every tile above
    the threshold: S = H and the factors fit the zero residual): both CLIs
    print the same operator line; statuses equal, fitted space within 5e-3
    (fp32 stop iterations may differ, ROADMAP §C items 2-4); the port's
    file equal to its own dense run's statuses."""
    paths, H = world
    inputs = [paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"], paths["img_a"], paths["img_b"]]
    common = [*inputs, "-m", "40", "-c", "1e-12", "--lowrank_rtm", "14"]
    assert torch_main(["-o", str(tmp_path / "t.h5"), "--device", "cpu", *common]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("lowrank:")]
    assert jax_main(["-o", str(tmp_path / "j.h5"), "--pixel_shards", "1", "--fused_sweep",
                     "off", *common]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("lowrank:")]
    assert got == want and len(got) == 1
    a, b = _solution(tmp_path / "t.h5"), _solution(tmp_path / "j.h5")
    np.testing.assert_array_equal(a["status"], b["status"])
    fa, fb = a["value"] @ H.T, b["value"] @ H.T
    assert (np.linalg.norm(fa - fb, axis=1) / np.linalg.norm(fb, axis=1)).max() <= 5e-3


def test_cli_auto_declines_loudly(world, tmp_path, capsys):
    paths, _H = world
    inputs = [paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"], paths["img_a"], paths["img_b"]]
    common = [*inputs, "-m", "20", "-c", "1e-12", "--lowrank_rtm", "auto"]
    assert torch_main(["-o", str(tmp_path / "t.h5"), "--device", "cpu", *common]) == 0
    got = capsys.readouterr()
    assert "lowrank:" not in got.out and "sweep=fused" in got.out
    assert jax_main(["-o", str(tmp_path / "j.h5"), "--pixel_shards", "1", *common]) == 0
    want = capsys.readouterr()
    warn = [ln for ln in got.err.splitlines() if "lowrank_rtm declines" in ln]
    assert warn and warn == [ln for ln in want.err.splitlines() if "lowrank_rtm declines" in ln]
    # SART_LOWRANK_RTM stands in for the flag
    os.environ["SART_LOWRANK_RTM"] = "auto"
    try:
        assert torch_main(["-o", str(tmp_path / "e.h5"), "--device", "cpu",
                           *common[:-2]]) == 0
        assert "lowrank_rtm declines" in capsys.readouterr().err
    finally:
        del os.environ["SART_LOWRANK_RTM"]


@pytest.fixture(scope="module")
def reflective(tmp_path_factory):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    d = tmp_path_factory.mktemp("reflective")
    return chip_smoke.write_reflective_world(str(d), nx=32, ny=32, cam=(16, 16), n_frames=3)


def test_cli_reflective_world_against_the_jax_cli(reflective, tmp_path, capsys):
    """On the reflective world ``auto`` takes rank 4 in both CLIs (the same
    line), the solve within 5e-3 of the dense run in fitted space with equal
    statuses; ``--lowrank_rtm 2`` exits 1 in both with the gate's words."""
    p = reflective["paths"]
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    common = [*inputs, "-m", "100", "-c", "1e-6"]
    assert torch_main(["-o", str(tmp_path / "t.h5"), "--device", "cpu", *common,
                       "--lowrank_rtm", "auto"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("lowrank:")]
    assert len(got) == 1 and "rank=4 " in got[0]
    assert "core occupancy 0.500" in got[0]
    assert jax_main(["-o", str(tmp_path / "j.h5"), "--pixel_shards", "1", "--fused_sweep",
                     "off", *common, "--lowrank_rtm", "auto"]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("lowrank:")]
    assert got == want
    assert torch_main(["-o", str(tmp_path / "d.h5"), "--device", "cpu", *common,
                       "--lowrank_rtm", "off"]) == 0
    H = reflective["H"].astype(np.float64)
    a, b = _solution(tmp_path / "t.h5"), _solution(tmp_path / "d.h5")
    np.testing.assert_array_equal(a["status"], b["status"])
    fa, fb = a["value"] @ H.T, b["value"] @ H.T
    assert (np.linalg.norm(fa - fb, axis=1) / np.linalg.norm(fb, axis=1)).max() <= 5e-3
    capsys.readouterr()
    assert _rc(torch_main, ["-o", str(tmp_path / "r.h5"), "--device", "cpu", *common,
                            "--lowrank_rtm", "2"]) == 1
    err_t = capsys.readouterr().err.strip().splitlines()
    assert _rc(jax_main, ["-o", str(tmp_path / "rj.h5"), "--pixel_shards", "1", *common,
                          "--lowrank_rtm", "2"]) == 1
    err_j = capsys.readouterr().err.strip().splitlines()
    assert err_t[-1] == err_j[-1] and "factorization gate" in err_t[-1]


@pytest.mark.parametrize("extra", [["--lowrank_rtm", "x"], ["--lowrank_rtm", "0"],
                                   ["--lowrank_rtm", "4", "--use_cpu"],
                                   ["--lowrank_rtm", "4", "--fused_sweep", "on"],
                                   ["--lowrank_rtm", "4", "--sparse_rtm", "0.1"],
                                   ["--lowrank_rtm", "4", "--integrity"],
                                   ["--lowrank_rtm", "4", "-l", "LAP"]],
                         ids=["word", "zero", "use_cpu", "fused-on", "sparse", "integrity",
                              "laplacian"])
def test_cli_refusals_match_the_jax_cli(world, tmp_path, capsys, extra):
    paths, _H = world
    extra = [paths["laplacian"] if x == "LAP" else x for x in extra]
    inputs = [paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"], paths["img_a"], paths["img_b"]]
    capsys.readouterr()
    assert _rc(torch_main, ["-o", str(tmp_path / "t.h5"), "--device", "cpu", *inputs,
                            *extra]) == 1
    got = capsys.readouterr().err.strip().splitlines()
    assert _rc(jax_main, ["-o", str(tmp_path / "j.h5"), "--pixel_shards", "1", *inputs,
                          *extra]) == 1
    want = capsys.readouterr().err.strip().splitlines()
    assert got and got[-1] == want[-1]
