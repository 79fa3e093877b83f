"""The PyTorch solver (sartsolver_tpu_torch.models) against the JAX package.

The same inputs, made from a numpy seed, go through both packages on the
CPU. The JAX side runs its fused sweep in Pallas interpret mode (or its
two-matmul path with ``fused_sweep="off"``); the PyTorch side runs the fused
sweep's plain version, which is what its wrapper does with CPU tensors.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sartsolver_tpu.config import SolverOptions as JaxOptions
from sartsolver_tpu.models import sart as jsart
from sartsolver_tpu.models.oracle import solve_oracle
from sartsolver_tpu.ops.laplacian import coo_matvec as jax_coo_matvec
from sartsolver_tpu.ops.laplacian import make_laplacian as jax_make_laplacian

from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.models import sart as tsart
from sartsolver_tpu_torch.models.convert import problem_from_numpy
from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep_reference
from sartsolver_tpu_torch.ops.laplacian import coo_matvec, make_laplacian

P, V = 24, 256  # the JAX fused kernel needs P % 8 == 0 and V % 128 == 0


def _case(seed=0):
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.1, 1.0, (P, V)).astype(np.float32)
    H[:, :3] = 0.0  # masked voxels (zero ray density)
    H[3, :] = 0.0  # masked pixel (zero ray length)
    f_true = rng.uniform(0.5, 2.0, V)
    g = H.astype(np.float64) @ f_true
    g[5] = -1.0  # saturated detector
    f0 = rng.uniform(0.2, 1.5, V)
    return H, g, f0


def _lap_triplets(seed=1):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(V), np.arange(V)])
    cols = np.concatenate([(np.arange(V) + 1) % V, np.arange(V)])
    vals = np.concatenate([rng.uniform(-0.2, 0.2, V), np.full(V, 0.3)])
    return rows, cols, vals


def assert_solutions_close(got, want, dtype):
    """The JAX suite's bar, rtol 2e-5 / atol 2e-6, for fp64. In fp32 the two
    frameworks sum each product in another order (one ulp per element), and
    the linear update's cancellation ``f + invd * H^T w`` and its clamp at
    zero amplify that in solution space over the iterations of an
    underdetermined system (P < V) — up to ~3e-5 of the solution's max after
    30 iterations from the Eq. 4 guess, while ``H f`` agrees to ~3e-7. So
    fp32 keeps rtol 2e-5 with atol 1e-4 of the max, and the fitted space is
    held to rtol 2e-5 as well."""
    got, want = np.asarray(got), np.asarray(want)
    atol = 2e-6 if dtype == "float64" else 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=atol)


def _both_problems(H, lap, opts):
    """(JAX problem, PyTorch problem) for the same matrix and Laplacian."""
    jlap = tlap = None
    if lap is not None:
        jlap = jax_make_laplacian(*lap, dtype=opts.dtype)
        tlap = make_laplacian(*lap, nvoxel=V, dtype=tsart.torch_dtype(opts.dtype),
                              device="cpu")
    jopts = JaxOptions(**{f.name: getattr(opts, f.name)
                          for f in dataclasses.fields(opts)})
    return (jsart.make_problem(H, jlap, opts=jopts), jopts,
            tsart.make_problem(H, tlap, opts=opts, device="cpu"))


@pytest.mark.parametrize("profile", ["fp32-off", "fp32-fused", "fp64"])
@pytest.mark.parametrize("given_f0", [False, True])
@pytest.mark.parametrize("with_lap", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
def test_solve_matches_jax(logarithmic, with_lap, given_f0, profile):
    H, g, f0 = _case()
    kw = dict(max_iterations=30, conv_tolerance=1e-12, logarithmic=logarithmic,
              beta_laplace=1e-3 if with_lap else 0.0, relaxation=0.7)
    if profile == "fp64":
        opts = SolverOptions.cpu_parity(**kw)
        jax_fused = "auto"  # the fp64 profile declines the fused sweep
    else:
        fused = profile == "fp32-fused"
        opts = SolverOptions(fused_sweep="auto" if fused else "off", **kw)
        jax_fused = "interpret" if fused else "off"
    jprob, jopts, tprob = _both_problems(H, _lap_triplets() if with_lap else None, opts)
    jopts = dataclasses.replace(jopts, fused_sweep=jax_fused)
    seed = f0 if given_f0 else None
    ref = jsart.solve(jprob, g, seed, opts=jopts)
    res = tsart.solve(tprob, g, seed, opts=opts, device="cpu")
    assert int(res.status) == int(ref.status)
    assert int(res.iterations) == int(ref.iterations)
    assert_solutions_close(res.solution.numpy(), ref.solution, opts.dtype)
    H64 = H.astype(np.float64)
    np.testing.assert_allclose(H64 @ res.solution.numpy(),
                               H64 @ np.asarray(ref.solution), rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_problem_stats_and_measurement_match_jax(dtype):
    H, g, _ = _case(seed=2)
    kw = dict(dtype=dtype, normalize=dtype == "float32")
    opts = SolverOptions(**kw)
    jprob = jsart.make_problem(H, opts=JaxOptions(**kw))
    tprob = tsart.make_problem(H, opts=opts, device="cpu")
    assert tprob.rtm.dtype == tsart.torch_dtype(dtype)
    np.testing.assert_allclose(tprob.ray_density.numpy(), np.asarray(jprob.ray_density),
                               rtol=1e-6)
    np.testing.assert_allclose(tprob.ray_length.numpy(), np.asarray(jprob.ray_length),
                               rtol=1e-6)
    got = tsart.prepare_measurement(g, opts)
    want = jsart.prepare_measurement(g, JaxOptions(**kw))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_laplacian_penalty_matches_jax_bitwise(dtype):
    """The row-grouped penalty sums each row's triplets in stored order,
    as the JAX scatter does on the CPU: equal to the last bit."""
    rows, cols, vals = _lap_triplets(seed=3)
    order = np.random.default_rng(4).permutation(rows.size)
    rows, cols, vals = rows[order], cols[order], vals[order]
    # JAX scatters in the given order; the table keeps each row's relative
    # order, so give JAX the row-sorted triplets the table holds
    srt = np.argsort(rows, kind="stable")
    x = np.random.default_rng(5).uniform(-1, 1, (3, V)).astype(dtype)
    jlap = jax_make_laplacian(rows[srt], cols[srt], vals[srt], dtype=dtype)
    want = np.stack([np.asarray(jax_coo_matvec(jlap, xb, V)) for xb in x])
    tlap = make_laplacian(rows, cols, vals, nvoxel=V,
                          dtype=torch.float32 if dtype == np.float32 else torch.float64)
    got = coo_matvec(tlap, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("logarithmic", [False, True])
def test_carried_warm_start_matches_jax(logarithmic):
    """fitted0/return_fitted: frame 1 starts from frame 0's loop-exit pair,
    rescaled, and skips the setup projection — as the JAX core does."""
    H, g, _ = _case(seed=6)
    opts = SolverOptions(max_iterations=20, conv_tolerance=1e-12,
                         logarithmic=logarithmic, fused_sweep="off")
    jprob, jopts, tprob = _both_problems(H, None, opts)
    frames = [g, g * 1.2]
    prepared = [tsart.prepare_measurement(fr, opts) for fr in frames]
    outs = []
    for core, prob, mk, kw in (
        (jsart.solve_normalized_batch, jprob, np.asarray,
         dict(opts=jopts, axis_name=None, voxel_axis=None)),
        (tsart.solve_normalized_batch, tprob, torch.as_tensor,
         dict(opts=opts, device="cpu")),
    ):
        g0, msq0, norm0 = prepared[0]
        zeros = np.zeros((1, V), np.float32)
        res0, fit0 = core(prob, mk(g0[None].astype(np.float32)),
                          mk(np.float32([msq0])), mk(zeros), use_guess=True,
                          return_fitted=True, **kw)
        g1, msq1, norm1 = prepared[1]
        s = np.float32(norm0 / norm1)
        res1, fit1 = core(prob, mk(g1[None].astype(np.float32)),
                          mk(np.float32([msq1])), res0.solution * s,
                          use_guess=False, fitted0=fit0 * s,
                          return_fitted=True, **kw)
        outs.append((res1, fit1))
    (jres, jfit), (tres, tfit) = outs
    assert int(tres.iterations[0]) == int(jres.iterations[0])
    assert int(tres.status[0]) == int(jres.status[0])
    assert_solutions_close(tres.solution.numpy(), jres.solution, opts.dtype)
    np.testing.assert_allclose(tfit.numpy(), np.asarray(jfit), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("with_lap", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
def test_fp64_profile_matches_oracle(logarithmic, with_lap):
    rng = np.random.default_rng(7)
    H = rng.uniform(0.0, 1.0, (40, 30))
    H[:, 4] = 0.0
    g = np.abs(H @ rng.uniform(0.5, 2.0, 30) + 0.01 * rng.standard_normal(40))
    g[[2, 9]] = -1.0
    lap = None
    if with_lap:
        lap = (np.arange(29), np.arange(1, 30), np.full(29, -0.05))
    opts = SolverOptions.cpu_parity(logarithmic=logarithmic, max_iterations=40,
                                    conv_tolerance=1e-12, beta_laplace=1e-3)
    tlap = None if lap is None else make_laplacian(*lap, nvoxel=30, dtype=torch.float64)
    res = tsart.solve(tsart.make_problem(H, tlap, opts=opts, device="cpu"), g,
                      opts=opts, device="cpu")
    f_ref, status, iters, _ = solve_oracle(
        H, g, lap, logarithmic=logarithmic, max_iterations=40,
        conv_tolerance=1e-12, beta_laplace=1e-3, log_epsilon=opts.log_epsilon,
    )
    np.testing.assert_allclose(res.solution.numpy(), f_ref, rtol=1e-9, atol=1e-12)
    assert int(res.status) == status
    assert int(res.iterations) == iters


def test_problem_from_numpy_round_trip():
    H, g, _ = _case(seed=8)
    opts = SolverOptions(max_iterations=25, conv_tolerance=1e-12, beta_laplace=1e-3,
                         fused_sweep="off")
    rows, cols, vals = _lap_triplets()
    jprob = jsart.make_problem(H, jax_make_laplacian(rows, cols, vals, dtype="float32"),
                               opts=JaxOptions(**{f.name: getattr(opts, f.name)
                                                  for f in dataclasses.fields(opts)}))
    lap = jprob.laplacian
    tprob = problem_from_numpy(
        np.asarray(jprob.rtm), np.asarray(jprob.ray_density),
        np.asarray(jprob.ray_length), np.asarray(lap.rows), np.asarray(lap.cols),
        np.asarray(lap.vals), opts=opts, device="cpu",
    )
    np.testing.assert_array_equal(tprob.rtm.numpy(), np.asarray(jprob.rtm))
    ref = jsart.solve(jprob, g, opts=JaxOptions(max_iterations=25, conv_tolerance=1e-12,
                                               beta_laplace=1e-3, fused_sweep="off"))
    res = tsart.solve(tprob, g, opts=opts, device="cpu")
    assert int(res.iterations) == int(ref.iterations)
    assert_solutions_close(res.solution.numpy(), ref.solution, opts.dtype)
    with pytest.raises(ValueError, match="opts.dtype"):
        problem_from_numpy(H.astype(np.float64), np.asarray(jprob.ray_density),
                           np.asarray(jprob.ray_length), opts=opts, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        problem_from_numpy(H, np.asarray(jprob.ray_density)[:-1],
                           np.asarray(jprob.ray_length), opts=opts, device="cpu")
    with pytest.raises(ValueError, match="all three"):
        problem_from_numpy(H, np.asarray(jprob.ray_density),
                           np.asarray(jprob.ray_length), rows, opts=opts, device="cpu")


def test_sweep_fn_parameter_reaches_the_loop():
    """The solver core calls the sweep function it is given, once per
    iteration, when the fused sweep engages — and never for the fp64 profile."""
    H, g, _ = _case(seed=9)
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return fused_sweep_reference(*a, **kw)

    opts = SolverOptions(max_iterations=7, conv_tolerance=1e-12)
    res = tsart.solve(tsart.make_problem(H, opts=opts, device="cpu"), g, opts=opts,
                      device="cpu", sweep_fn=counting)
    assert len(calls) == int(res.iterations) == 7
    calls.clear()
    opts64 = SolverOptions.cpu_parity(max_iterations=7, conv_tolerance=1e-12)
    tsart.solve(tsart.make_problem(H, opts=opts64, device="cpu"), g, opts=opts64,
                device="cpu", sweep_fn=counting)
    assert not calls
    with pytest.raises(ValueError, match="fused_sweep='on'"):
        bad = SolverOptions.cpu_parity(fused_sweep="on")
        tsart.solve(tsart.make_problem(H, opts=bad, device="cpu"), g, opts=bad,
                    device="cpu")


@pytest.mark.parametrize("field,value", [
    ("integrity", True), ("sparse_rtm", "auto"),
    ("lowrank_rtm", "4"), ("rtm_dtype", "float16"),
])
def test_options_not_ported_raise(field, value):
    """Options still to port raise naming the option; so does an RTM
    storage dtype that neither package has. ``integrity`` is ported now: it
    is accepted, as the JAX package accepts it, and beside an option still
    to port that option's refusal holds."""
    if field == "integrity":
        assert SolverOptions(integrity=value).integrity is JaxOptions(integrity=value).integrity
        with pytest.raises(ValueError, match="sparse_rtm"):
            SolverOptions(integrity=value, sparse_rtm="auto")
        return
    with pytest.raises(ValueError, match=field):
        SolverOptions(**{field: value})


@pytest.mark.parametrize("field,value", [
    ("relaxation_decay", 0.0), ("relaxation_decay", 1.5), ("relaxation_decay", -0.1),
    ("momentum", "polyak"), ("divergence_recovery", -1), ("divergence_threshold", 1.0),
    ("divergence_threshold", 0.5),
])
def test_solver_variant_options_are_validated(field, value):
    """The JAX package's checks of the three solver variants
    (``sartsolver_tpu/config.py:399-411, 498-507``): a decay outside (0, 1],
    an unknown momentum, a negative recovery count and a threshold not above
    1 raise in both packages, naming the option."""
    with pytest.raises(ValueError, match=field):
        SolverOptions(**{field: value})
    with pytest.raises(ValueError, match=field):
        JaxOptions(**{field: value})


def test_cuda_entry_points_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    H, g, _ = _case()
    opts = SolverOptions()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsart.make_problem(H, opts=opts)
    prob = tsart.make_problem(H, opts=opts, device="cpu")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsart.solve(prob, g, opts=opts)
    with pytest.raises(RuntimeError, match="--use_cpu"):
        problem_from_numpy(H, np.asarray(prob.ray_density), np.asarray(prob.ray_length),
                           opts=opts)


def test_plain_fp32_convergence_sum_matches_jax():
    """precise_convergence=False: ||Hf||^2 as the reference CUDA path's fp32
    dot, on both sides. That sum's order differs between the frameworks, and
    the stall test fires where dC first rounds to exactly 0 — which is what
    the fp64 sum prevents — so the stop may move by an iteration."""
    H, g, f0 = _case(seed=10)
    opts = SolverOptions(max_iterations=30, conv_tolerance=1e-12,
                         precise_convergence=False, fused_sweep="off")
    jprob, jopts, tprob = _both_problems(H, None, opts)
    ref = jsart.solve(jprob, g, f0, opts=jopts)
    res = tsart.solve(tprob, g, f0, opts=opts, device="cpu")
    assert abs(int(res.iterations) - int(ref.iterations)) <= 1
    assert_solutions_close(res.solution.numpy(), ref.solution, opts.dtype)
    np.testing.assert_allclose(float(res.convergence), float(ref.convergence),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("given_f0", [False, True])
@pytest.mark.parametrize("with_lap", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("storage,sweep", [
    ("bfloat16", "fused"), ("bfloat16", "off"), ("int8", "fused"),
])
def test_reduced_storage_solve_matches_jax(storage, sweep, logarithmic, with_lap,
                                           given_f0):
    """bf16 and int8 storage through make_problem and solve: the JAX side
    runs its Pallas kernel in interpret mode (or its two-matmul path), the
    port its plain version. int8 solves the quantized system on both sides,
    with the quantized-vector projections for the guess, obs and setup.

    conv_tolerance=0 runs every frame to the cap: the Eq. 5 stall test fires
    where dC first rounds to exactly 0, which moves with the summation order
    (measured here: a log int8 frame stopped at 14 against JAX's 30, with
    C^k equal to 4 digits), so it would compare the summation orders, not
    the storage paths."""
    H, g, f0 = _case(seed=11)
    kw = dict(max_iterations=30, conv_tolerance=0.0, logarithmic=logarithmic,
              beta_laplace=1e-3 if with_lap else 0.0, relaxation=0.7)
    opts = SolverOptions(rtm_dtype=storage, fused_sweep="auto" if sweep == "fused" else "off",
                         **kw)
    jprob, jopts, tprob = _both_problems(H, _lap_triplets() if with_lap else None, opts)
    jopts = dataclasses.replace(jopts, fused_sweep="interpret" if sweep == "fused" else "off")
    seed = f0 if given_f0 else None
    ref = jsart.solve(jprob, g, seed, opts=jopts)
    res = tsart.solve(tprob, g, seed, opts=opts, device="cpu")
    assert int(res.status) == int(ref.status)
    assert int(res.iterations) == int(ref.iterations)
    assert_solutions_close(res.solution.numpy(), ref.solution, opts.dtype)
    H64 = H.astype(np.float64)
    np.testing.assert_allclose(H64 @ res.solution.numpy(),
                               H64 @ np.asarray(ref.solution), rtol=2e-5)


@pytest.mark.parametrize("logarithmic", [False, True])
def test_fp64_compute_bf16_storage_matches_jax(logarithmic):
    """The fp64 profile over a bf16 matrix: the two-matmul path, each block
    of the matrix upcast to fp64, against the JAX package's mixed-dtype
    contractions."""
    H, g, _ = _case(seed=12)
    opts = SolverOptions.cpu_parity(rtm_dtype="bfloat16", logarithmic=logarithmic,
                                    max_iterations=40, conv_tolerance=1e-12,
                                    beta_laplace=1e-3)
    jprob, jopts, tprob = _both_problems(H, _lap_triplets(), opts)
    assert tprob.rtm.dtype == torch.bfloat16
    ref = jsart.solve(jprob, g, opts=jopts)
    res = tsart.solve(tprob, g, opts=opts, device="cpu")
    assert int(res.status) == int(ref.status)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(res.solution.numpy(), np.asarray(ref.solution), rtol=1e-8)


def test_int8_requires_fused():
    """As the JAX package's test of the same name: int8 codes with the
    fused sweep off raise, and so does fused_sweep='on' over fp64 storage."""
    H, g, _ = _case()
    opts = SolverOptions(rtm_dtype="int8", fused_sweep="off")
    prob = tsart.make_problem(H, opts=opts, device="cpu")
    with pytest.raises(ValueError, match="requires the fused sweep"):
        tsart.solve(prob, g, opts=opts, device="cpu")
    on64 = SolverOptions(rtm_dtype="float64", fused_sweep="on")
    with pytest.raises(ValueError, match="rtm dtype=float64"):
        tsart.solve(tsart.make_problem(H, opts=on64, device="cpu"), g, opts=on64,
                    device="cpu")
    auto64 = SolverOptions(rtm_dtype="float64")
    assert not tsart.resolve_fused(auto64) and tsart.resolve_fused(
        SolverOptions(rtm_dtype="bfloat16"))


def test_int8_sweep_gets_the_scale():
    """The solver core hands the int8 codes' scale [1, V] to the sweep, and
    only for int8."""
    H, g, _ = _case(seed=13)
    seen = []

    def recording(rtm, w, f, aux, **kw):
        seen.append((rtm.dtype, kw.get("scale")))
        return fused_sweep_reference(rtm, w, f, aux, **kw)

    scales = []
    for storage in ("int8", "bfloat16"):
        opts = SolverOptions(rtm_dtype=storage, max_iterations=3, conv_tolerance=0.0)
        prob = tsart.make_problem(H, opts=opts, device="cpu")
        scales.append(prob.rtm_scale)
        tsart.solve(prob, g, opts=opts, device="cpu", sweep_fn=recording)
    assert [dt for dt, _ in seen] == [torch.int8] * 3 + [torch.bfloat16] * 3
    for _, scale in seen[:3]:
        assert torch.equal(scale, scales[0][None, :])
    assert scales[1] is None and all(scale is None for _, scale in seen[3:])
