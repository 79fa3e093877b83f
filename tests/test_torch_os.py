"""Ordered-subsets SART (``os_subsets``) and ``debug_nans`` of the port on
the CPU, against the JAX package where it has the same function
(tests/test_accel.py's OS cases).

- ``ops/os_subsets.py`` against ``sartsolver_tpu.ops.fused_sweep``'s
  subset helpers, for every storage, B = 1 and 3;
- the option refusals, the divide check and ``DistributedSARTSolver``'s padding to
  the JAX solver's row alignment;
- the Eq. 6 invariants over fp32, bf16 and int8 storage for every
  accelerated variant (a hypothesis sweep too);
- the accelerated log solve: fewer iterations to the same stall point,
  on the port alone and held against JAX;
- ``os_subsets = 1`` byte for byte the classic sweep; no fused-sweep call
  during an OS solve; no subset-sized fp32 copy of reduced storage;
- the NaN checks of ``debug_nans`` at the solve's step boundaries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sartsolver_tpu.config import SolverOptions as JaxOptions
from sartsolver_tpu.models import sart as jsart
from sartsolver_tpu.ops import fused_sweep as jfs

from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.models import sart as tsart
from sartsolver_tpu_torch.ops import fused_sweep as fs
from sartsolver_tpu_torch.ops import os_subsets as oss
from sartsolver_tpu_torch.ops import projection
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver, os_padded_rows

P, V = 32, 128


def _problem(seed=0, dead_voxels=()):
    """tests/test_accel.py's banded problem: ``(H, g_n [P], msq)``, with
    all-zero columns at ``dead_voxels`` for the Eq. 6 mask."""
    rng = np.random.default_rng(seed)
    H = rng.random((P, V)).astype(np.float32) * 0.9 + 0.1
    ii = np.arange(P, dtype=np.float32)[:, None] / P
    jj = np.arange(V, dtype=np.float32)[None, :] / V
    H = H * (np.exp(-((ii - jj) ** 2) * 100.0) + 0.02)
    for v in dead_voxels:
        H[:, v] = 0.0
    f_true = 1.0 + 0.5 * np.sin(2 * np.pi * np.arange(V) / V)
    g = H.astype(np.float64) @ f_true
    norm = g.max()
    msq = np.float32((np.where(g > 0, g, 0) ** 2).sum() / norm**2)
    return H, (g / norm).astype(np.float32), msq


def _options(**kw):
    return SolverOptions(**{"max_iterations": 200, "conv_tolerance": 1e-5,
                            "fused_sweep": "off", **kw})


def _solve(H, g, msq, opts, B=1, sweep_fn=fs.fused_sweep, debug_nans=False):
    prob = tsart.make_problem(H, opts=opts, device="cpu")
    return tsart.solve_normalized_batch(
        prob, torch.as_tensor(np.tile(g, (B, 1))), torch.full((B,), float(msq)),
        torch.zeros((B, V)), opts=opts, use_guess=True, device="cpu", sweep_fn=sweep_fn,
        debug_nans=debug_nans)


def _jax_solve(H, g, msq, opts):
    jopts = JaxOptions(**{k: getattr(opts, k) for k in (
        "max_iterations", "conv_tolerance", "fused_sweep", "logarithmic", "os_subsets",
        "momentum", "rtm_dtype", "guess_floor")})
    return jsart.solve_normalized_batch(
        jsart.make_problem(H, opts=jopts), jnp.asarray(g[None]), jnp.full((1,), msq),
        jnp.zeros((1, V)), opts=jopts, axis_name=None, voxel_axis=None, use_guess=True)


# ---------------------------------------------------------------------------
# the subset products against the JAX helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_subset_products_match_jax(storage, B):
    """Every subset's rows, pixels, forward and back products equal the
    JAX helpers' on the same stored matrix (int8: the same codes and
    scales), at fp32 summation-order tolerance."""
    rng = np.random.default_rng(11)
    H = rng.uniform(0.0, 1.0, (48, 96)).astype(np.float32)
    f = rng.uniform(0.5, 1.5, (B, 96)).astype(np.float32)
    w = rng.standard_normal((B, 48)).astype(np.float32)
    scale = None
    if storage == "int8":
        codes, tscale = tsart.quantize_rtm(H)
        stored, scale = codes, tscale
        jstored, jscale = jnp.asarray(codes.numpy()), jnp.asarray(tscale.numpy())
    else:
        stored = torch.as_tensor(H).to(tsart.torch_dtype(storage))
        jstored = jnp.asarray(H).astype(storage)
        jscale = None
    for n in (2, 4):
        for t in range(n):
            panel = oss.os_subset_rows(stored, t, n)
            assert panel.data_ptr() == stored[t].data_ptr()  # a view, not a copy
            jpanel = jfs.os_subset_rows(jstored, t, n)
            np.testing.assert_array_equal(panel.float().numpy(),
                                          np.asarray(jpanel).astype(np.float32))
            np.testing.assert_array_equal(oss.os_subset_pixels(torch.as_tensor(w), t, n).numpy(),
                                          np.asarray(jfs.os_subset_pixels(jnp.asarray(w), t, n)))
            fwd = oss.os_subset_forward(panel, torch.as_tensor(f), scale)
            jfwd = jfs.os_subset_forward(jpanel, jnp.asarray(f), jscale)
            assert fwd.dtype == torch.float32 and fwd.shape == (B, 48 // n)
            np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), rtol=1e-6, atol=1e-6)
            w_t = torch.as_tensor(w[:, t::n])
            back = oss.os_subset_back(panel, w_t, scale)
            jback = jfs.os_subset_back(jpanel, jnp.asarray(w[:, t::n]), jscale)
            assert back.dtype == torch.float32 and back.shape == (B, 96)
            np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_reduced_storage_is_upcast_a_block_at_a_time(storage, monkeypatch):
    """bf16 and int8 subsets reach the products as fp32 blocks of at most
    ``PANEL_ELEMENTS`` elements, never as a whole fp32 subset."""
    monkeypatch.setattr(projection, "PANEL_ELEMENTS", 256)
    rng = np.random.default_rng(12)
    H = rng.uniform(0.0, 1.0, (64, 128)).astype(np.float32)
    stored = (tsart.quantize_rtm(H)[0] if storage == "int8"
              else torch.as_tensor(H).to(torch.bfloat16))
    seen = []
    real_to = torch.Tensor.to

    def spy(self, *a, **kw):
        out = real_to(self, *a, **kw)
        if self.dtype == stored.dtype and out.dtype == torch.float32:
            seen.append(out.numel())
        return out

    monkeypatch.setattr(torch.Tensor, "to", spy)
    panel = oss.os_subset_rows(stored, 1, 4)
    full = panel.float()
    seen.clear()
    fwd = oss.os_subset_forward(panel, torch.ones((2, 128)))
    back = oss.os_subset_back(panel, torch.ones((2, 16)))
    assert seen and max(seen) <= 256
    np.testing.assert_allclose(fwd.numpy(), (torch.ones((2, 128)) @ full.T).numpy(), rtol=1e-6)
    np.testing.assert_allclose(back.numpy(), (torch.ones((2, 16)) @ full).numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# options, the divide check and the solver's row padding
# ---------------------------------------------------------------------------

def test_options_validation():
    """tests/test_accel.py::test_options_validation: os_subsets >= 1, and an
    explicit fused_sweep='on' refused with OS (the port has no
    'interpret' mode); auto and off compose, as does momentum."""
    with pytest.raises(ValueError, match="os_subsets"):
        SolverOptions(os_subsets=0)
    with pytest.raises(ValueError, match="os_subsets > 1 runs the subset-cycle sweep"):
        SolverOptions(os_subsets=4, fused_sweep="on")
    for fused in ("auto", "off"):
        assert not tsart.resolve_fused(SolverOptions(os_subsets=4, fused_sweep=fused))
    SolverOptions(os_subsets=4, momentum="nesterov")
    SolverOptions(os_subsets=4, rtm_dtype="int8")  # the cycle upcasts int8 itself


def test_os_subsets_must_divide_pixels():
    """P = 32, os_subsets = 5: the solve raises the JAX message; so does
    the JAX solve."""
    H, g, msq = _problem()
    opts = _options(max_iterations=5, os_subsets=5)
    with pytest.raises(ValueError, match="os_subsets=5 must divide the .* pixel extent 32"):
        _solve(H, g, msq, opts)
    with pytest.raises(ValueError, match="divide"):
        _jax_solve(H, g, msq, opts)


@pytest.mark.parametrize("npixel,n,rows", [
    (14, 4, 16), (14, 2, 14), (14, 16, 16), (32, 4, 32), (30, 8, 32), (8192, 4, 8192),
])
def test_solver_pads_to_the_jax_row_alignment(npixel, n, rows):
    """The solver holds ``npixel`` rows where ``os_subsets`` divides it, else
    the JAX solver's ``ceil(P / 8) * 8``."""
    assert os_padded_rows(npixel, n) == rows


@pytest.mark.parametrize("npixel,n,padded", [(14, 3, 16), (30, 5, 32), (9, 3, 16)])
def test_solver_refuses_what_the_jax_solver_refuses(npixel, n, padded):
    """Refused where ``os_subsets`` does not divide the padded extent, also
    where it divides ``npixel`` itself (30 by 5, 9 by 3), as the JAX solver
    refuses them."""
    with pytest.raises(ValueError, match=f"os_subsets={n} must divide the .* extent {padded}"):
        os_padded_rows(npixel, n)


@pytest.mark.parametrize("logarithmic", [False, True])
def test_padded_rows_change_nothing(logarithmic):
    """P = 30 at os_subsets = 4 (padded to 32) equals the same matrix with
    its two zero rows written out and their pixels masked, byte for byte:
    the padding is the JAX solver's, and zero rows add nothing."""
    H, g, _ = _problem(seed=1)
    H30, frames = H[:30], np.stack([g[:30], 0.5 * g[:30]]).astype(np.float64)
    opts = _options(os_subsets=4, logarithmic=logarithmic, max_iterations=30,
                    conv_tolerance=0.0)
    with DistributedSARTSolver(H30, None, opts=opts, device="cpu") as solver:
        assert solver.rows == 32 and solver.npixel == 30
        got = solver.solve_batch(frames)
    H32 = np.concatenate([H30, np.zeros((2, V), np.float32)])
    prob = tsart.make_problem(H32, opts=opts, device="cpu")
    gs = [tsart.prepare_measurement(fr, opts) for fr in frames]
    g32 = np.concatenate([np.stack([x[0] for x in gs]), np.full((2, 2), -1.0)], axis=1)
    want = tsart.solve_normalized_batch(
        prob, torch.as_tensor(g32).float(), torch.tensor([x[1] for x in gs]).float(),
        torch.zeros((2, V)), opts=opts, use_guess=True, device="cpu")
    assert torch.equal(got.solution_norm, want.solution)
    np.testing.assert_array_equal(got.iterations, want.iterations.numpy())


# ---------------------------------------------------------------------------
# invariants across the variant matrix
# ---------------------------------------------------------------------------

VARIANTS = [
    dict(os_subsets=4),
    dict(momentum="nesterov"),
    dict(os_subsets=4, momentum="nesterov"),
    dict(logarithmic=True, os_subsets=4),
    dict(logarithmic=True, momentum="nesterov"),
    dict(logarithmic=True, os_subsets=4, momentum="nesterov"),
]


def _check_invariants(sol, logarithmic, dead):
    assert np.all(np.isfinite(sol))
    if logarithmic:  # the multiplicative update keeps a positive iterate positive
        assert np.all(np.delete(sol[0], list(dead)) > 0)
    else:
        assert np.all(sol[0] >= 0)
        # Eq. 6: a voxel below the ray-density threshold is never updated
        assert np.all(sol[0, list(dead)] == 0.0)


@pytest.mark.parametrize("kw", VARIANTS,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in sorted(kw.items())))
@pytest.mark.parametrize("rtm_dtype", [None, "bfloat16", "int8"])
def test_invariants_variant_matrix(kw, rtm_dtype):
    """Non-negativity and ray-density masking hold for every accelerated
    variant and storage type, and the solve converges. int8 without OS runs
    the fused sweep's plain version (the JAX test skips it: its int8 needs
    the Pallas kernel)."""
    dead = (3, 70)
    H, g, msq = _problem(dead_voxels=dead)
    fused = "auto" if rtm_dtype == "int8" and kw.get("os_subsets", 1) == 1 else "off"
    opts = _options(rtm_dtype=rtm_dtype, guess_floor=0.0, fused_sweep=fused, **kw)
    res = _solve(H, g, msq, opts)
    assert int(res.status[0]) == 0, f"did not converge: {int(res.iterations[0])} iterations"
    _check_invariants(res.solution.numpy(), kw.get("logarithmic", False), dead)


try:
    import hypothesis  # noqa: F401

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=10, deadline=None, derandomize=True)
    @given(seed=st.integers(0, 2**16), os_subsets=st.sampled_from([1, 2, 4, 8]),
           momentum=st.sampled_from(["off", "nesterov"]), logarithmic=st.booleans())
    def test_invariants_property(seed, os_subsets, momentum, logarithmic):
        """tests/test_accel.py::test_invariants_property on the port."""
        H, g, msq = _problem(seed=seed, dead_voxels=(7,))
        opts = _options(os_subsets=os_subsets, momentum=momentum, logarithmic=logarithmic,
                        guess_floor=0.0)
        res = _solve(H, g, msq, opts)
        _check_invariants(res.solution.numpy(), logarithmic, (7,))


# ---------------------------------------------------------------------------
# acceleration, parity and identities
# ---------------------------------------------------------------------------

def test_accelerated_log_fewer_iterations_and_parity():
    """The headline contract: ``os_subsets=4`` with Nesterov momentum brings
    the log solve to the same stall tolerance in fewer iterations, on the
    unaccelerated stall point; the port and JAX agree in statuses and
    iterations of both solves, solutions at the fp32 bar."""
    H, g, msq = _problem(seed=3)
    base = _options(logarithmic=True)
    accel = _options(logarithmic=True, os_subsets=4, momentum="nesterov")
    r_b, r_a = _solve(H, g, msq, base), _solve(H, g, msq, accel)
    assert int(r_b.status[0]) == 0 and int(r_a.status[0]) == 0
    assert int(r_a.iterations[0]) < int(r_b.iterations[0])
    sol_a, sol_b = r_a.solution.numpy(), r_b.solution.numpy()
    assert np.linalg.norm(sol_a - sol_b) / np.linalg.norm(sol_b) < 0.05
    for got, opts in ((r_b, base), (r_a, accel)):
        want = _jax_solve(H, g, msq, opts)
        np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
        np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
        np.testing.assert_allclose(got.solution.numpy(), np.asarray(want.solution), rtol=2e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("logarithmic", [False, True])
def test_os_one_is_the_classic_sweep(logarithmic):
    """``os_subsets=1`` stated explicitly changes no byte of a solve."""
    H, g, msq = _problem(seed=4)
    a = _solve(H, g, msq, _options(logarithmic=logarithmic, fused_sweep="auto"), B=2)
    b = _solve(H, g, msq, _options(logarithmic=logarithmic, fused_sweep="auto", os_subsets=1),
               B=2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_no_fused_sweep_call_during_an_os_solve(storage):
    """With ``fused_sweep="auto"`` the OS cycle replaces the fused sweep on
    every storage: its implementation is never called."""
    H, g, msq = _problem(seed=5)
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return fs.fused_sweep_reference(*a, **kw)

    opts = _options(os_subsets=4, fused_sweep="auto", rtm_dtype=storage, max_iterations=10)
    res = _solve(H, g, msq, opts, sweep_fn=counting)
    assert not calls and int(res.iterations[0]) > 0
    classic = _options(fused_sweep="auto", rtm_dtype=storage, max_iterations=10)
    res = _solve(H, g, msq, classic, sweep_fn=counting)
    assert len(calls) == int(res.iterations[0])


# ---------------------------------------------------------------------------
# debug_nans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("os_subsets", [1, 4])
def test_debug_nans_names_the_step(os_subsets):
    """A NaN that enters the solve (here a NaN voxel of the warm start)
    aborts it with FloatingPointError naming where it was kept; without
    the checks the solve runs on and returns NaN."""
    H, g, msq = _problem(seed=6)
    opts = _options(os_subsets=os_subsets, max_iterations=5, fused_sweep="auto")
    prob = tsart.make_problem(H, opts=opts, device="cpu")
    f0 = torch.ones((1, V))
    f0[0, 9] = float("nan")
    args = (prob, torch.as_tensor(g[None]), torch.tensor([float(msq)]), f0)
    res = tsart.solve_normalized_batch(*args, opts=opts, use_guess=False, device="cpu")
    assert torch.isnan(res.solution).any()
    with pytest.raises(FloatingPointError,
                       match="NaN in the warm start at the start of the solve"):
        tsart.solve_normalized_batch(*args, opts=opts, use_guess=False, device="cpu",
                                     debug_nans=True)


def test_debug_nans_names_the_os_sub_step(monkeypatch):
    """A NaN born inside the cycle names the sub-step that produced it."""
    H, g, msq = _problem(seed=7)
    opts = _options(os_subsets=4, max_iterations=5)
    real = oss.os_subset_back
    calls = []

    def poisoned(panel, w, scale=None):
        out = real(panel, w, scale)
        calls.append(1)
        if len(calls) == 3 * 4 + 3:  # iteration 4's sub-step 2 (one back product a sub-step)
            out = out.clone()
            out[0, 5] = float("nan")
        return out

    monkeypatch.setattr(tsart, "os_subset_back", poisoned)
    with pytest.raises(FloatingPointError,
                       match="the iterate after OS sub-step 2 at iteration 4"):
        _solve(H, g, msq, opts, debug_nans=True)


@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("os_subsets", [1, 4])
def test_debug_nans_changes_no_byte(os_subsets, logarithmic):
    """A healthy solve with the checks on returns the same bytes."""
    H, g, msq = _problem(seed=8)
    opts = _options(os_subsets=os_subsets, logarithmic=logarithmic, fused_sweep="auto")
    off = _solve(H, g, msq, opts, B=2)
    on = _solve(H, g, msq, opts, B=2, debug_nans=True)
    for x, y in zip(off, on):
        assert torch.equal(x, y)
