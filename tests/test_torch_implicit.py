"""The matrix-free implicit operator of the port against the JAX package's,
on the CPU (where the projector takes its plain version).

Ports ``tests/test_operator.py``'s implicit kernel and solver-parity cases
(``:212-315``, ``PARITY_LEGS`` at ``:353-381``, the divergence-recovery and
continuous-batching legs) on the canonical geometry (two cameras, 18 rays,
a 4 x 4 x 4 grid):

- forward, back, ray stats and the ordered-subsets densities against the
  materialized fp64 matrix and against the JAX functions on the same numpy
  inputs, padded rows included; a batched forward equal to the per-frame
  ones; a CPU tensor never reaches the kernel (its launch counts stay 0);
- the solver: the port's implicit solve against the JAX package's implicit
  solve, ``conv_tolerance=0`` as the JAX suite runs it (every frame to the
  cap): equal statuses and iterations, solutions within ``PARITY_RTOL``; the
  fp64 profile within 1e-8; against the port's dense solve of the
  materialized matrix; the warm-started chain equal to serial solves byte
  for byte; the divergence guard's DIVERGED; the scheduler's lanes against
  the JAX scheduler's.

The pixel-sharded legs wait for the port's meshes (queue A item 4).
"""

import json

import numpy as np
import pytest
import torch

import test_operator as T
from sartsolver_tpu.config import DIVERGED
from sartsolver_tpu.config import SolverOptions as JaxOptions
from sartsolver_tpu.operators import implicit as jimp
from sartsolver_tpu.parallel.mesh import make_mesh
from sartsolver_tpu.parallel.sharded import DistributedSARTSolver as JaxSolver
from sartsolver_tpu.sched import ContinuousBatcher as JaxBatcher

from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.operators import ImplicitOperator
from sartsolver_tpu_torch.operators import implicit as timp
from sartsolver_tpu_torch.operators.geometry import parse_geometry
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
from sartsolver_tpu_torch.sched import ContinuousBatcher

PARITY_RTOL = 2e-4


def _case(seed=0):
    """(port operator, JAX operator, H fp64, g fp64): the JAX suite's case."""
    rec, jop, H, g = T._case(seed)
    op = ImplicitOperator(parse_geometry(json.loads(json.dumps(T.GEO_DICT))))
    return op, jop, H, g


def _padded_rays(op):
    rays = np.zeros((24, 6), np.float32)  # 6 zero-padded ray rows
    rays[:18] = op.payload()
    return rays


def test_implicit_functions_match_the_materialized_matrix():
    op, _jop, H, _g = _case()
    spec = op.spec()
    assert spec.nvoxel == 128
    rays = torch.as_tensor(_padded_rays(op))
    rng = np.random.default_rng(1)
    f = np.zeros(128, np.float32)
    f[:64] = rng.uniform(0.0, 2.0, 64)
    got = timp.implicit_forward(rays, torch.as_tensor(f), spec).numpy()
    np.testing.assert_allclose(got[:18], H @ f[:64].astype(np.float64), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[18:], 0.0)
    w = rng.uniform(0.0, 1.0, 24).astype(np.float32)
    w[18:] = 0.0
    got_b = timp.implicit_back(rays, torch.as_tensor(w), spec).numpy()
    np.testing.assert_allclose(got_b[:64], H.T @ w[:18].astype(np.float64), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got_b[64:], 0.0)
    dens, length = timp.implicit_ray_stats(rays, spec)
    np.testing.assert_allclose(dens.numpy()[:64], H.sum(axis=0), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(dens.numpy()[64:], 0.0)
    np.testing.assert_allclose(length.numpy()[:18], H.sum(axis=1), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(length.numpy()[18:], 0.0)
    sub = timp.implicit_subset_density(rays, spec, 3).numpy()
    H_pad = np.zeros((24, 128))
    H_pad[:18, :64] = H
    np.testing.assert_allclose(sub, H_pad.reshape(8, 3, 128).sum(axis=0), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        timp.implicit_subset_density(rays, spec, 5)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("accum", ["float32", "float64"])
def test_implicit_functions_match_the_jax_functions(B, accum):
    """The same numpy inputs through both packages' functions."""
    import jax.numpy as jnp

    op, jop, _H, _g = _case()
    spec, jspec = op.spec(), jop.spec()
    rays = _padded_rays(op)
    rng = np.random.default_rng(B)
    f = rng.uniform(0.0, 2.0, (B, 128)).astype(accum)
    w = rng.uniform(-1.0, 1.0, (B, 24)).astype(accum)
    dt = getattr(torch, accum)
    tol = dict(rtol=1e-6, atol=1e-6) if accum == "float32" else dict(rtol=1e-12, atol=1e-12)
    # (tests/conftest.py turns JAX's x64 on)
    jdt = jnp.dtype(accum)
    np.testing.assert_allclose(
        timp.implicit_forward(torch.as_tensor(rays), torch.as_tensor(f), spec,
                              accum_dtype=dt).numpy(),
        np.asarray(jimp.implicit_forward(jnp.asarray(rays), jnp.asarray(f), jspec,
                                         accum_dtype=jdt)), **tol)
    np.testing.assert_allclose(
        timp.implicit_back(torch.as_tensor(rays), torch.as_tensor(w), spec,
                           accum_dtype=dt).numpy(),
        np.asarray(jimp.implicit_back(jnp.asarray(rays), jnp.asarray(w), jspec,
                                      accum_dtype=jdt)), **tol)
    for got, want in zip(timp.implicit_ray_stats(torch.as_tensor(rays), spec, dtype=dt),
                         jimp.implicit_ray_stats(jnp.asarray(rays), jspec, dtype=jdt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    for n in (2, 3, 4):
        np.testing.assert_allclose(
            timp.implicit_subset_density(torch.as_tensor(rays), spec, n, dtype=dt).numpy(),
            np.asarray(jimp.implicit_subset_density(jnp.asarray(rays), jspec, n,
                                                    dtype=jdt)), **tol)


def test_batched_forward_matches_per_frame_and_cpu_never_launches():
    op, _jop, _H, _g = _case()
    spec = op.spec()
    rays = torch.as_tensor(op.payload())
    fb = torch.as_tensor(np.random.default_rng(2).uniform(0.0, 1.0, (3, spec.nvoxel)),
                         dtype=torch.float32)
    timp.reset_launch_counts()
    got = timp.implicit_forward(rays, fb, spec)
    for b in range(3):
        torch.testing.assert_close(got[b], timp.implicit_forward(rays, fb[b], spec),
                                   rtol=1e-6, atol=1e-7)
    timp.implicit_back(rays, torch.ones(18), spec)
    assert timp.implicit_forward.launches == timp.implicit_back.launches == 0
    with pytest.raises(ValueError, match="extent"):
        timp.implicit_forward(rays, fb[:, :64], spec)
    with pytest.raises(ValueError, match="fp32"):
        timp.implicit_forward(rays.double(), fb, spec)


def _opts(jax=False, **kw):
    kw.setdefault("max_iterations", 40)
    kw.setdefault("conv_tolerance", 0.0)
    kw.setdefault("fused_sweep", "off")
    if kw.pop("fp64", False):
        return (JaxOptions if jax else SolverOptions).cpu_parity(**kw)
    return (JaxOptions if jax else SolverOptions)(**kw)


def _assert_parity(got, want, nvoxel=64, rtol=PARITY_RTOL):
    assert int(got.status) == int(want.status)
    assert int(got.iterations) == int(want.iterations)
    a = np.asarray(got.solution)[:nvoxel]
    b = np.asarray(want.solution)[:nvoxel]
    assert np.max(np.abs(a - b)) <= rtol * max(np.max(np.abs(b)), 1e-12)


PARITY_LEGS = T.PARITY_LEGS + [("log-os", {"logarithmic": True, "os_subsets": 3}),
                               ("fp64", {"fp64": True}),
                               ("fp64-log", {"fp64": True, "logarithmic": True})]


@pytest.mark.parametrize("name,kw", PARITY_LEGS, ids=[n for n, _ in PARITY_LEGS])
def test_parity_against_the_jax_implicit_solve(name, kw):
    """The port's implicit solve against the JAX package's (and the port's
    dense solve of the materialized matrix) on the same measurements."""
    op, jop, H, g = _case()
    fp64 = kw.get("fp64", False)
    rtol = 1e-8 if fp64 else PARITY_RTOL
    imp = DistributedSARTSolver(operator=op, opts=_opts(**kw), device="cpu")
    dense = DistributedSARTSolver(H.astype(np.float32), opts=_opts(**kw), device="cpu")
    ref = JaxSolver(operator=jop, opts=_opts(jax=True, **kw), mesh=make_mesh(1, 1))
    try:
        assert imp.problem.rtm.shape == (18, 6)  # the ray table: 432 bytes resident
        for scale in (1.0, 1.3):
            got = imp.solve(g * scale)
            _assert_parity(got, ref.solve(g * scale), rtol=rtol)
            _assert_parity(got, dense.solve(g * scale), rtol=rtol)
    finally:
        ref.close()


def test_chain_equals_serial_solves():
    """The warm-started chain through the implicit operator equals the
    serial loop's frames byte for byte, and the JAX chain's within the
    parity tolerance."""
    op, jop, _H, g = _case()
    G = np.stack([g * s for s in (1.0, 1.1, 0.9, 1.2)])
    imp = DistributedSARTSolver(operator=op, opts=_opts(), device="cpu")
    chain = imp.solve_chain(G)
    prev, rows = None, []
    for k in range(4):
        res = imp.solve_chain(G[k:k + 1], warm=prev)
        rows.append(res.fetch_solutions()[0])
        prev = res
    np.testing.assert_array_equal(chain.fetch_solutions(), np.stack(rows))
    ref = JaxSolver(operator=jop, opts=_opts(jax=True), mesh=make_mesh(1, 1))
    try:
        want = ref.solve_chain(G)
        np.testing.assert_array_equal(chain.status, np.asarray(want.status))
        a, b = chain.fetch_solutions(), np.asarray(want.fetch_solutions())[:, :64]
        assert np.max(np.abs(a - b)) <= PARITY_RTOL * np.max(np.abs(b))
    finally:
        ref.close()


def test_parity_divergence_recovery():
    op, jop, H, g = _case()
    imp = DistributedSARTSolver(operator=op, opts=_opts(divergence_recovery=3), device="cpu")
    ref = JaxSolver(operator=jop, opts=_opts(jax=True, divergence_recovery=3),
                    mesh=make_mesh(1, 1))
    try:
        g_bad = g.copy()
        g_bad[4] = np.nan
        ri, rj = imp.solve(g_bad), ref.solve(g_bad)
        assert int(ri.status) == int(rj.status) == DIVERGED
        assert int(ri.iterations) == int(rj.iterations)
        assert np.isfinite(ri.solution).all()
        _assert_parity(imp.solve(g), ref.solve(g))
    finally:
        ref.close()


def test_parity_continuous_batching():
    """The port's scheduler lanes over the implicit solver against the JAX
    scheduler over the JAX implicit solver: emission order, statuses and
    iterations equal, solutions within the parity tolerance."""
    op, jop, _H, g = _case()
    rng = np.random.default_rng(3)
    frames = [np.maximum(g * s + 0.01 * rng.standard_normal(18), 0.0)
              for s in (1.0, 0.7, 1.4, 1.1, 0.9)]
    items = [(fr, float(i), [float(i)]) for i, fr in enumerate(frames)]

    def drive(batcher_cls, solver):
        out = []

        def on_result(ftime, _ct, status, iters, _conv, fetcher, _ms):
            out.append((ftime, status, iters, np.asarray(fetcher())[:64]))

        def on_failed(ftime, _ct, err):
            raise AssertionError(f"frame {ftime} failed: {err}")

        batcher_cls(solver, lanes=2, on_result=on_result, on_failed=on_failed).run(
            iter(list(items)))
        return out

    got = drive(ContinuousBatcher, DistributedSARTSolver(
        operator=op, opts=_opts(schedule_stride=4), device="cpu"))
    ref = JaxSolver(operator=jop, opts=_opts(jax=True, schedule_stride=4),
                    mesh=make_mesh(1, 1))
    try:
        want = drive(JaxBatcher, ref)
    finally:
        ref.close()
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for a, b in zip(got, want):
        assert np.max(np.abs(a[3] - b[3])) <= PARITY_RTOL * max(np.max(np.abs(b[3])), 1e-12)
