"""The solver variants of the port against the JAX package: the relaxation
schedule (``relaxation_decay``), Nesterov momentum, the divergence guard
(``divergence_recovery``) and ordered subsets (``os_subsets``, alone and
composed with the others), in the batched solve, the warm-start chain and
the scheduler's stride (tests/test_accel.py and tests/test_resilience.py's
cases).

On the CPU the port's sweep is its plain version; the JAX side runs its
fused sweep in Pallas interpret mode (the scheduled log update through its
α aux panel), or its two-matmul path where the fused sweep declines. Both
run the OS cycle's plain subset products where ``os_subsets > 1``.

Bars: fp32 runs every frame to the cap (tolerance 0) and is held at the
JAX suite's rtol 2e-4 / atol 1e-5 (tests/test_sharded_fused.py) with equal
statuses and iteration counts — an fp32 stall crossing moves between the
frameworks with the products' summation order (ROADMAP.md, queue C items
3-5). fp64 stops at a real tolerance and is held to rtol 1e-8. Inside the
port, the scheduler equals the batched loop and the chain equals the serial
loop byte for byte, with every variant.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sartsolver_tpu.config import SolverOptions as JaxOptions
from sartsolver_tpu.models import sart as jsart
from sartsolver_tpu.ops.laplacian import make_laplacian as jax_make_laplacian

from sartsolver_tpu_torch.config import DIVERGED, SolverOptions
from sartsolver_tpu_torch.models import sart as tsart
from sartsolver_tpu_torch.ops import fused_sweep as fs
from sartsolver_tpu_torch.ops.laplacian import make_laplacian
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
from sartsolver_tpu_torch.sched import ContinuousBatcher

P, V = 24, 256  # the JAX fused kernel needs P % 8 == 0 and V % 128 == 0

VARIANTS = {
    "decay": dict(relaxation=0.8, relaxation_decay=0.9),
    "momentum": dict(momentum="nesterov"),
    "guard": dict(divergence_recovery=2),
    "all": dict(relaxation_decay=0.95, momentum="nesterov", divergence_recovery=2),
    "os": dict(os_subsets=4),
    "os_momentum": dict(os_subsets=4, momentum="nesterov"),
    "os_all": dict(os_subsets=4, relaxation_decay=0.95, momentum="nesterov",
                   divergence_recovery=2),
}


def _frames(n, seed=0, clean=False):
    """A matrix with masked voxels and a masked pixel, and ``n`` frames of a
    drifting truth whose iteration counts spread, each with a saturated
    detector; ``clean``: none of those (every pixel measured)."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.1, 1.0, (P, V)).astype(np.float32)
    if not clean:
        H[:, :3] = 0.0  # masked voxels (zero ray density)
        H[3, :] = 0.0  # masked pixel (zero ray length)
    x = np.arange(V) / V
    base = 1.0 + 0.5 * np.sin(2 * np.pi * x)
    rough = np.sin(2 * np.pi * 6.5 * x)
    frames = []
    for k, amp in enumerate(np.geomspace(1e-3, 2.0, n)):
        g = H.astype(np.float64) @ np.maximum(base + amp * rough, 1e-3) * (1.0 + 0.3 * k)
        if not clean:
            g *= 1.0 + 1e-3 * rng.standard_normal(P)
            g[5] = -1.0  # saturated detector
        frames.append(g)
    return H, np.stack(frames)


def _lap_triplets():
    i = np.arange(V)
    rows = np.concatenate([i, i[1:], i[:-1]])
    cols = np.concatenate([i, i[1:] - 1, i[:-1] + 1])
    vals = np.concatenate([np.full(V, 2.0), np.full(2 * V - 2, -1.0)])
    return rows, cols, vals


def _options(variant, profile, logarithmic, **kw):
    kw = {**VARIANTS[variant], "logarithmic": logarithmic, **kw}
    if profile == "fp64":
        return SolverOptions.cpu_parity(**{"conv_tolerance": 1e-6, "max_iterations": 300,
                                           **kw})
    return SolverOptions(**{"conv_tolerance": 0.0, "max_iterations": 25, **kw})


def _jax_opts(opts, fused=None):
    jopts = JaxOptions(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)})
    if fused is None:  # where the port's sweep is fused, JAX's interpreted kernel
        fused = "interpret" if tsart.resolve_fused(opts) else "off"
    return dataclasses.replace(jopts, fused_sweep=fused)


def _problems(H, opts, with_lap=False, jax_fused=None):
    jopts = _jax_opts(opts, jax_fused)
    jlap = tlap = None
    if with_lap:
        jlap = jax_make_laplacian(*_lap_triplets(), dtype=opts.dtype)
        tlap = make_laplacian(*_lap_triplets(), nvoxel=V, dtype=tsart.torch_dtype(opts.dtype),
                              device="cpu")
    return (jsart.make_problem(H, jlap, opts=jopts), jopts,
            tsart.make_problem(H, tlap, opts=opts, device="cpu"))


def _stage(frames, opts):
    """Normalized ``(g [B, P], msq [B])`` in the compute dtype, as numpy."""
    dt = np.float64 if opts.dtype == "float64" else np.float32
    gs, msqs, _ = zip(*(tsart.prepare_measurement(fr, opts) for fr in frames))
    return np.stack(gs).astype(dt), np.asarray(msqs).astype(dt)


def _both_batches(H, frames, opts, with_lap=False, jax_fused=None):
    jprob, jopts, tprob = _problems(H, opts, with_lap, jax_fused)
    g, msq = _stage(frames, opts)
    f0 = np.zeros((len(frames), V), g.dtype)
    want = jsart.solve_normalized_batch(jprob, jnp.asarray(g), jnp.asarray(msq),
                                        jnp.asarray(f0), opts=jopts, axis_name=None,
                                        voxel_axis=None, use_guess=True)
    got = tsart.solve_normalized_batch(tprob, torch.as_tensor(g), torch.as_tensor(msq),
                                       torch.as_tensor(f0), opts=opts, use_guess=True,
                                       device="cpu")
    return got, want


def _assert_matches(got, want, profile):
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    if profile == "fp64":
        np.testing.assert_allclose(got.solution.numpy(), np.asarray(want.solution), rtol=1e-8,
                                   atol=1e-12)
    else:
        np.testing.assert_allclose(got.solution.numpy(), np.asarray(want.solution), rtol=2e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the batched solve against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["fp32", "fp64"])
@pytest.mark.parametrize("with_lap", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_batched_variant_matches_jax(variant, logarithmic, with_lap, profile):
    """Three frames in one batched loop, from the Eq. 4 guess: equal
    statuses and iterations, solutions at the bar of the profile."""
    H, frames = _frames(3, seed=1)
    opts = _options(variant, profile, logarithmic,
                    beta_laplace=1e-3 if with_lap else 0.0)
    got, want = _both_batches(H, frames, opts, with_lap)
    _assert_matches(got, want, profile)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_scheduled_log_update_on_every_storage(storage):
    """``relaxation_decay`` with the log solver runs through the fused sweep
    on every storage type, the exponent per frame as the kernel's
    ``alpha_lane`` (int8 has no other path), against the JAX interpreted
    kernel with its α aux panel."""
    H, frames = _frames(3, seed=2)
    opts = SolverOptions(logarithmic=True, relaxation_decay=0.98, relaxation=0.9,
                         max_iterations=20, conv_tolerance=0.0, rtm_dtype=storage,
                         beta_laplace=1e-3)
    seen = []
    plain = fs.fused_sweep_reference

    def spy(*args, alpha_lane=None, **kw):
        seen.append(alpha_lane)
        return plain(*args, alpha_lane=alpha_lane, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fs, "fused_sweep_reference", spy)
        got, want = _both_batches(H, frames, opts, with_lap=True)
    assert len(seen) == 20 and all(a is not None and a.shape == (3, 1) for a in seen)
    # iteration k's exponent: relaxation * decay**k, for every frame
    np.testing.assert_allclose(seen[5].numpy()[:, 0], 0.9 * 0.98 ** 5, rtol=1e-6)
    _assert_matches(got, want, "fp32")


def test_scheduled_exponent_is_per_lane_in_the_stride():
    """Lanes that entered at different strides take their own ``decay**k``."""
    H, frames = _frames(2, seed=3)
    opts = SolverOptions(logarithmic=True, relaxation_decay=0.9, max_iterations=30,
                         conv_tolerance=0.0, schedule_stride=4)
    seen = []
    plain = fs.fused_sweep_reference

    def spy(*args, alpha_lane=None, **kw):
        seen.append(alpha_lane.numpy()[:, 0].copy())
        return plain(*args, alpha_lane=alpha_lane, **kw)

    with DistributedSARTSolver(H, None, opts=opts, device="cpu") as solver, \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(fs, "fused_sweep_reference", spy)
        lanes = solver.sched_lanes(2)
        solver.sched_step(lanes, [(0, frames[0])])
        solver.sched_step(lanes, [(1, frames[1])])
    # the second stride: lane 0 at iterations 4..7, lane 1 at 0..3
    second = np.stack(seen[4:8])
    np.testing.assert_allclose(second[:, 0], 0.9 ** np.arange(4, 8), rtol=1e-6)
    np.testing.assert_allclose(second[:, 1], 0.9 ** np.arange(4), rtol=1e-6)


# ---------------------------------------------------------------------------
# the divergence guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("variant", ["decay", "momentum"])
def test_armed_guard_untripped_is_identical(variant, logarithmic):
    """A guard that never fires changes no byte: its step scale is 1 and
    every rollback select keeps the candidate (the log solver with the guard
    leaves the fused sweep, so both sides run the two-product sweep)."""
    H, frames = _frames(3, seed=4)
    kw = dict(max_iterations=200, conv_tolerance=1e-6, logarithmic=logarithmic,
              fused_sweep="off" if logarithmic else "auto", **VARIANTS[variant])
    off, armed = SolverOptions(**kw), SolverOptions(divergence_recovery=3, **kw)
    g, msq = _stage(frames, off)
    outs = []
    for opts in (off, armed):
        prob = tsart.make_problem(H, opts=opts, device="cpu")
        outs.append(tsart.solve_normalized_batch(
            prob, torch.as_tensor(g), torch.as_tensor(msq), torch.zeros((3, V)),
            opts=opts, use_guess=True, device="cpu"))
    assert (outs[0].status.numpy() == 0).all()
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_momentum", [False, True])
def test_rollback_composition_matches_jax(use_momentum):
    """tests/test_accel.py::test_momentum_rollback_composition: frame 1's
    measurement is inflated 10x while its declared ``||g||^2`` is not, so
    its ``||Hf||^2`` crosses ``threshold * max(msq, 1)``, the guard rolls it
    back with a halved step until the ladder is spent, and it stops DIVERGED
    on a finite iterate; frame 0 converges as it does alone. Port and JAX
    agree in statuses and iterations, solutions at the fp32 bar."""
    H, frames = _frames(1, seed=5, clean=True)
    opts = SolverOptions(max_iterations=50, conv_tolerance=1e-5, fused_sweep="off",
                         momentum="nesterov" if use_momentum else "off",
                         divergence_recovery=2, divergence_threshold=1.001)
    g, msq = _stage(frames, opts)
    g2, msq2 = np.concatenate([g, g * 10.0]), np.concatenate([msq, msq])
    f0 = np.zeros((2, V), np.float32)
    jprob, jopts, tprob = _problems(H, opts, jax_fused="off")
    want = jsart.solve_normalized_batch(jprob, jnp.asarray(g2), jnp.asarray(msq2),
                                        jnp.asarray(f0), opts=jopts, axis_name=None,
                                        voxel_axis=None, use_guess=False)
    got = tsart.solve_normalized_batch(tprob, torch.as_tensor(g2), torch.as_tensor(msq2),
                                       torch.as_tensor(f0), opts=opts, use_guess=False,
                                       device="cpu")
    assert got.status.tolist() == [0, DIVERGED]
    assert torch.isfinite(got.solution).all()
    _assert_matches(got, want, "fp32")
    solo = tsart.solve_normalized_batch(tprob, torch.as_tensor(g), torch.as_tensor(msq),
                                        torch.as_tensor(f0[:1]), opts=opts,
                                        use_guess=False, device="cpu")
    # B = 2 against B = 1 sums the products in another order: the JAX
    # test's bar, rtol 1e-5 / atol 1e-7
    assert int(solo.iterations[0]) == int(got.iterations[0])
    np.testing.assert_allclose(got.solution[0].numpy(), solo.solution[0].numpy(), rtol=1e-5,
                               atol=1e-7)


def test_escalation_ladder_resumes_between_trips():
    """tests/test_resilience.py::test_escalation_ladder_rolls_back_and_exhausts
    on the port: an explicit-Euler-unstable Laplacian weight makes the
    linear solve oscillate; the guard rolls back, halves and iterates again
    between trips, and ends DIVERGED on a finite iterate, where the
    unguarded solve runs to the cap with the iterate grown ~1e9."""
    rng = np.random.default_rng(3)
    Hs = rng.uniform(0.1, 1.0, (16, 12)).astype(np.float32)
    g = Hs.astype(np.float64) @ rng.uniform(0.5, 2.0, 12)
    rows, cols, vals = [], [], []
    for i in range(12):
        for j, v in ((i, 2.0), (i - 1, -1.0), (i + 1, -1.0)):
            if 0 <= j < 12:
                rows.append(i)
                cols.append(j)
                vals.append(v)
    lap = make_laplacian(np.asarray(rows), np.asarray(cols), np.asarray(vals, np.float32),
                         nvoxel=12, device="cpu")
    kw = dict(max_iterations=500, conv_tolerance=1e-6, beta_laplace=0.8)
    on = SolverOptions(divergence_recovery=6, divergence_threshold=1e3, **kw)
    off = SolverOptions(**kw)
    r_on = tsart.solve(tsart.make_problem(Hs, lap, opts=on, device="cpu"), g, opts=on,
                       device="cpu")
    r_off = tsart.solve(tsart.make_problem(Hs, lap, opts=off, device="cpu"), g, opts=off,
                        device="cpu")
    assert int(r_on.status) == DIVERGED
    assert 6 < int(r_on.iterations) < 500
    assert torch.isfinite(r_on.solution).all()
    assert float(r_off.solution.max()) > 1e6 * float(r_on.solution.max())


@pytest.mark.parametrize("logarithmic", [False, True])
def test_nan_frame_diverges_with_zero_solution(logarithmic):
    """A frame with a NaN pixel stops DIVERGED at iteration 0 with a zero
    row, as in the JAX package; its neighbours solve to exactly what they
    solve in a batch without it (fp32 to the cap, the cross-framework bar)."""
    H, frames = _frames(3, seed=6)
    bad = frames.copy()
    bad[1, 7] = np.nan
    opts = SolverOptions(max_iterations=40, conv_tolerance=0.0, logarithmic=logarithmic,
                         divergence_recovery=2)
    g, msq = _stage(bad, opts)
    assert np.isnan(g[1, 7]) and np.isfinite(msq).all()  # kept non-finite for the guard
    got, want = _both_batches(H, bad, opts)
    assert got.status.tolist()[1] == DIVERGED and int(got.iterations[1]) == 0
    assert not got.solution[1].any()
    _assert_matches(got, want, "fp32")
    clean = tsart.solve_normalized_batch(
        tsart.make_problem(H, opts=opts, device="cpu"), torch.as_tensor(g[[0, 2]]),
        torch.as_tensor(msq[[0, 2]]), torch.zeros((2, V)), opts=opts, use_guess=True,
        device="cpu")
    np.testing.assert_array_equal(got.solution[[0, 2]].numpy(), clean.solution.numpy())
    np.testing.assert_array_equal(got.iterations[[0, 2]].numpy(), clean.iterations.numpy())
    # a non-finite seed has nothing to roll back to either
    res = tsart.solve(tsart.make_problem(H, opts=opts, device="cpu"), frames[0],
                      np.full(V, np.inf), opts=opts, device="cpu")
    assert int(res.status) == DIVERGED and int(res.iterations) == 0


# ---------------------------------------------------------------------------
# the scheduler's stride against the JAX package's
# ---------------------------------------------------------------------------

def _inert(mod, B, dtype, opts):
    """All-inert lanes as both packages' ``sched_lanes`` make them, with the
    guard's and momentum's per-lane state (with OS the per-subset
    observations, and no carried projection for momentum)."""
    n_os = opts.os_subsets
    fields = dict(
        g=np.full((B, P), -1.0, dtype), msq=np.ones(B, dtype), f=np.ones((B, V), dtype),
        fitted=np.zeros((B, P), dtype), conv=np.zeros(B, dtype), it=np.zeros(B, np.int32),
        done=np.ones(B, bool), status=np.full(B, -1, np.int32), iters=np.zeros(B, np.int32),
        obs=(np.zeros((B, n_os, V) if n_os > 1 else (B, V), dtype) if opts.logarithmic
             else None),
        ascale=np.ones(B, dtype), recov=np.zeros(B, np.int32))
    if opts.momentum != "off":
        fields.update(f_prev=np.ones((B, V), dtype), tk=np.ones(B, dtype),
                      fitted_prev=(None if opts.logarithmic or n_os > 1
                                   else np.zeros((B, P), dtype)))
    if mod is jsart:
        return jsart.SchedState(**{k: None if v is None else jnp.asarray(v)
                                   for k, v in fields.items()})
    if not opts.divergence_recovery:
        fields.update(ascale=None, recov=None)
    return tsart.SchedState(**{k: None if v is None else torch.as_tensor(v)
                               for k, v in fields.items()})


@pytest.mark.parametrize("profile", ["fp32", "fp64"])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sched_step_variant_matches_jax(variant, logarithmic, profile):
    """One lane loaded per stride (lanes start and stop at different
    strides), a NaN frame among them: equal done flags, statuses, iteration
    counts and iterations completed after every stride; iterates and fitted
    at the profile's bar."""
    H, frames = _frames(5, seed=7)
    frames[2, 9] = np.nan
    opts = _options(variant, profile, logarithmic, schedule_stride=6, max_iterations=
                    30 if profile == "fp32" else 200, beta_laplace=1e-3)
    jprob, jopts, tprob = _problems(H, opts, with_lap=True)
    jstep = jax.jit(functools.partial(jsart.sched_step_normalized, opts=jopts))
    B = 2
    dtype = np.float64 if profile == "fp64" else np.float32
    tdt = tsart.torch_dtype(opts.dtype)
    jst, tst = _inert(jsart, B, dtype, opts), _inert(tsart, B, dtype, opts)
    queue, loaded, statuses = list(range(len(frames))), np.zeros(B, bool), []
    while queue or not bool(np.asarray(jst.done).all()):
        refill = np.zeros(B, bool)
        g_new, msq_new = np.full((B, P), -1.0), np.ones(B)
        free = np.flatnonzero(np.asarray(jst.done))
        if queue and free.size:
            b = free[0]
            g_new[b], msq_new[b], _ = tsart.prepare_measurement(frames[queue.pop(0)], opts)
            refill[b] = True
        was_done = np.asarray(jst.done) & ~refill
        jst = jstep(jprob, jst, jnp.asarray(g_new, dtype), jnp.asarray(msq_new, dtype),
                    jnp.asarray(refill))
        tst = tsart.sched_step_normalized(
            tprob, tst, torch.as_tensor(g_new).to(tdt), torch.as_tensor(msq_new).to(tdt),
            refill, opts=opts, device="cpu")
        for name in ("done", "status", "iters", "it"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)), err_msg=name)
        loaded |= refill
        for name in ("f", "fitted"):
            got = getattr(tst, name).numpy()[loaded]
            want = np.asarray(getattr(jst, name))[loaded]
            if profile == "fp64":
                np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5, err_msg=name)
        statuses += np.asarray(jst.status)[np.asarray(jst.done) & ~was_done].tolist()
    assert len(statuses) == len(frames)
    if opts.divergence_recovery:
        assert statuses.count(DIVERGED) == 1


# ---------------------------------------------------------------------------
# the loops' identities inside the port
# ---------------------------------------------------------------------------

def _with_nan(frames):
    out = frames.copy()
    out[3, 11] = np.nan
    return out


@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_scheduler_equals_the_batched_loop(variant, logarithmic):
    """Every retired lane equals the grouped loop's frame (dark-padded groups
    of the lane count) byte for byte: solution, status, iterations; with the
    guard, a NaN frame among them retires DIVERGED."""
    H, frames = _frames(7, seed=8)
    if VARIANTS[variant].get("divergence_recovery"):
        frames = _with_nan(frames)
    # tolerances at which these frames' iteration counts spread below the cap
    tol = {"guard": 1e-5, "os": 1e-6}.get(variant, 1e-7) if not logarithmic else 1e-7
    opts = SolverOptions(max_iterations=300, conv_tolerance=tol, logarithmic=logarithmic,
                         schedule_stride=5, **VARIANTS[variant])
    K = 3
    with DistributedSARTSolver(H, None, opts=opts, device="cpu") as solver:
        want = []
        for s in range(0, len(frames), K):
            stack = frames[s:s + K]
            n = len(stack)
            if n < K:
                stack = np.concatenate([stack, np.zeros((K - n, P))])
            res = solver.solve_batch(stack)
            want += [(res.fetch_solutions()[b], int(res.status[b]), int(res.iterations[b]))
                     for b in range(n)]
        got = []
        ContinuousBatcher(solver, lanes=K, on_result=lambda _t, _c, st, it, _cv, fe, _ms:
                          got.append((fe(), st, it))).run(
            (fr, float(i), [float(i)]) for i, fr in enumerate(frames))
    assert [g[1:] for g in got] == [w[1:] for w in want]
    np.testing.assert_array_equal(np.stack([g[0] for g in got]),
                                  np.stack([w[0] for w in want]))
    assert len({w[2] for w in want}) >= 3  # the lanes retire at different strides
    if opts.divergence_recovery:
        assert [w[1] for w in want].count(DIVERGED) == 1


@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_chain_equals_serial(variant, logarithmic):
    """``--chain_frames 3`` against ``--chain_frames 1``: the warm-started
    frames byte for byte, the warm carry crossing group boundaries (and,
    with the guard, a DIVERGED frame's zero row seeding the next frame)."""
    H, frames = _frames(7, seed=9)
    if VARIANTS[variant].get("divergence_recovery"):
        frames = _with_nan(frames)
    opts = SolverOptions(max_iterations=300, conv_tolerance=1e-6, logarithmic=logarithmic,
                         **VARIANTS[variant])
    rows = {}
    with DistributedSARTSolver(H, None, opts=opts, device="cpu") as solver:
        for K in (3, 1):
            warm, out = None, []
            for s in range(0, len(frames), K):
                warm = solver.solve_chain(frames[s:s + K], warm=warm)
                out += [(warm.fetch_solutions()[b], int(warm.status[b]),
                         int(warm.iterations[b])) for b in range(len(frames[s:s + K]))]
            rows[K] = out
    assert [r[1:] for r in rows[3]] == [r[1:] for r in rows[1]]
    np.testing.assert_array_equal(np.stack([r[0] for r in rows[3]]),
                                  np.stack([r[0] for r in rows[1]]))
    if opts.divergence_recovery:
        assert [r[1] for r in rows[1]].count(DIVERGED) == 1
