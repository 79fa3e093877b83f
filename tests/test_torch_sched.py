"""Continuous batching in the port (sartsolver_tpu_torch/sched/): the
scheduler stride against the JAX package's, the port's ContinuousBatcher
against the JAX one, and the scheduler's own contracts inside the port
(tests/test_sched.py's cases): masked-lane byte parity against the port's
classic grouped loop, tail drain, one-stride convergence, stride 1, the OOM
hand-back, lane and stride validation, occupancy accounting, and one batch
size for every sweep of a scheduled run.

Everything runs on the CPU, where the port's sweep is its plain version and
the JAX sweep its two-matmul path.
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
from sartsolver_tpu.parallel.mesh import make_mesh
from sartsolver_tpu.parallel.sharded import DistributedSARTSolver as JaxSolver
from sartsolver_tpu.sched import ContinuousBatcher as JaxBatcher

from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.models import sart as tsart
from sartsolver_tpu_torch.ops import fused_sweep as fs
from sartsolver_tpu_torch.ops.laplacian import make_laplacian
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
from sartsolver_tpu_torch.sched import ContinuousBatcher

P_PIX, V_VOX = 24, 16


def _mixed_case(n, seed=0, spread=True):
    """(H, frames): per-frame iteration counts genuinely vary (SART
    converges low spatial frequencies first, so frames whose truth carries
    more fine structure straggle)."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.1, 1.0, (P_PIX, V_VOX)).astype(np.float32)
    x = np.arange(V_VOX) / V_VOX
    base = 1.0 + 0.5 * np.sin(2 * np.pi * x)
    rough = np.sin(2 * np.pi * 6.5 * x)
    amps = np.geomspace(1e-3, 3.0, n) if spread else np.zeros(n)
    rng.shuffle(amps)
    frames = []
    for i in range(n):
        f_i = np.maximum(base + amps[i] * rough, 1e-3)
        g_i = H.astype(np.float64) @ f_i
        frames.append(np.maximum(g_i * (1.0 + 1e-3 * rng.standard_normal(P_PIX)), 0.0))
    return H, frames


def _lap_triplets():
    """A chain Laplacian over the voxels (tests/fixtures.py's shape)."""
    rows, cols, vals = [], [], []
    for i in range(V_VOX):
        for j, v in ((i, 2.0), (i - 1, -1.0), (i + 1, -1.0)):
            if 0 <= j < V_VOX:
                rows.append(i)
                cols.append(j)
                vals.append(v)
    return np.asarray(rows), np.asarray(cols), np.asarray(vals)


def _opts(**kw):
    kw.setdefault("max_iterations", 300)
    kw.setdefault("conv_tolerance", 1e-6)
    kw.setdefault("schedule_stride", 8)
    return SolverOptions(**kw)


def _jax_opts(opts):
    return JaxOptions(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)})


def _solver(H, opts, lap=None):
    return DistributedSARTSolver(H, lap, opts=opts, device="cpu")


def _run_sched(solver, items, lanes, batcher_cls=ContinuousBatcher, **kw):
    """Drive a batcher; returns (results in emission order, stats), each
    result ``(ftime, status, iterations, solution)``."""
    out = []

    def on_result(ftime, _ct, status, iters, _conv, fetcher, _ms):
        out.append((ftime, status, iters, fetcher()))

    if batcher_cls is JaxBatcher:
        kw["on_failed"] = lambda *a: pytest.fail(f"JAX batcher failed a frame: {a}")
    batcher = batcher_cls(solver, lanes=lanes, on_result=on_result, **kw)
    stats = batcher.run(iter(items))
    return out, stats


def _run_dense(solver, frames, K):
    """The CLI's classic run-to-slowest group loop: frame-order groups of
    K, dark-frame tail padding, per-frame rows."""
    sols, statuses, iters = [], [], []
    for s in range(0, len(frames), K):
        stack = np.stack(frames[s:s + K])
        n = stack.shape[0]
        if n < K:
            stack = np.concatenate([stack, np.zeros((K - n, stack.shape[1]))], axis=0)
        res = solver.solve_batch(stack)
        sols.append(res.fetch_solutions()[:n])
        statuses.extend(res.status[:n].tolist())
        iters.extend(res.iterations[:n].tolist())
    return np.concatenate(sols), statuses, iters


def _items(frames):
    return [(fr, float(i), [float(i)]) for i, fr in enumerate(frames)]


def _assert_matches_dense(got, want):
    want_sol, want_st, want_it = want
    assert [r[1] for r in got] == want_st
    assert [r[2] for r in got] == want_it
    np.testing.assert_array_equal(np.stack([r[3] for r in got]), want_sol)


# ---------------------------------------------------------------------------
# the stride against the JAX package's
# ---------------------------------------------------------------------------

def _inert_state(mod, B, dtype, logarithmic, **extra):
    """All-inert lanes as both packages' ``sched_lanes`` make them."""
    fields = dict(
        g=np.full((B, P_PIX), -1.0, dtype), msq=np.ones(B, dtype),
        f=np.ones((B, V_VOX), dtype), fitted=np.zeros((B, P_PIX), dtype),
        conv=np.zeros(B, dtype), it=np.zeros(B, np.int32), done=np.ones(B, bool),
        status=np.full(B, -1, np.int32), iters=np.zeros(B, np.int32),
        obs=np.zeros((B, V_VOX), dtype) if logarithmic else None, **extra)
    if mod is jsart:
        return jsart.SchedState(**{k: None if v is None else jnp.asarray(v)
                                   for k, v in fields.items()})
    return tsart.SchedState(**{k: None if v is None else torch.as_tensor(v)
                               for k, v in fields.items()})


@pytest.mark.parametrize("profile", ["fp64", "fp32"])
@pytest.mark.parametrize("with_lap", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
def test_sched_step_matches_jax(logarithmic, with_lap, profile):
    """The same lanes and the same refill schedule (one lane loaded per
    stride, so lanes start and retire at different strides): equal done
    flags, statuses and iteration counts; fp64 iterates and fitted to rtol
    1e-8, fp32 at the JAX suite's bar (rtol 2e-4, atol 1e-5,
    tests/test_sharded_fused.py).

    fp64 stops at a real tolerance. fp32 runs every lane to the cap
    (tolerance 0): the two frameworks sum each product in another order,
    which moves an fp32 stall crossing by an iteration wherever dC lies
    within rounding of the tolerance (ROADMAP.md, queue C; measured here at
    ``-c 1e-5`` on the log variant and at ``-c 1e-12`` on the linear one).
    The crossing inside the port is pinned byte for byte by the parity tests
    below."""
    H, frames = _mixed_case(5, seed=21)
    kw = dict(max_iterations=60, schedule_stride=6, logarithmic=logarithmic,
              beta_laplace=0.01 if with_lap else 0.0)
    if profile == "fp64":
        opts = SolverOptions.cpu_parity(conv_tolerance=1e-5, **kw)
    else:
        opts = SolverOptions(conv_tolerance=0.0, **kw)
    jopts = _jax_opts(opts)
    dtype = np.float64 if profile == "fp64" else np.float32
    tdt = tsart.torch_dtype(opts.dtype)
    jlap = tlap = None
    if with_lap:
        jlap = jax_make_laplacian(*_lap_triplets(), dtype=opts.dtype)
        tlap = make_laplacian(*_lap_triplets(), nvoxel=V_VOX, dtype=tdt)
    jprob = jsart.make_problem(H, jlap, opts=jopts)
    tprob = tsart.make_problem(H, tlap, opts=opts, device="cpu")
    jstep = jax.jit(functools.partial(jsart.sched_step_normalized, opts=jopts))
    B = 3
    jst = _inert_state(jsart, B, dtype, logarithmic, ascale=np.ones(B, dtype),
                       recov=np.zeros(B, np.int32))
    tst = _inert_state(tsart, B, dtype, logarithmic)
    queue = list(range(len(frames)))
    retired_at = []  # stride of each retirement
    loaded = np.zeros(B, bool)
    stride = 0
    while queue or not bool(np.asarray(jst.done).all()):
        refill = np.zeros(B, bool)
        g_new = np.full((B, P_PIX), -1.0)
        msq_new = np.ones(B)
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
            # a lane never loaded holds placeholders: its fitted stays 0 on
            # the fused path and is H @ 1 on the two-matmul path
            got = getattr(tst, name).numpy()[loaded]
            want = np.asarray(getattr(jst, name))[loaded]
            if profile == "fp64":
                np.testing.assert_allclose(got, want, rtol=1e-8, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5, err_msg=name)
        retired_at += [stride] * int((np.asarray(jst.done) & ~was_done).sum())
        stride += 1
    assert len(retired_at) == len(frames) and len(set(retired_at)) >= 3


def test_batcher_matches_jax_batcher():
    """The port's ContinuousBatcher against the JAX one on the same frames
    (fp64): equal statuses and iterations, solutions to 1e-8."""
    H, frames = _mixed_case(9, seed=22)
    opts = SolverOptions.cpu_parity(max_iterations=300, conv_tolerance=1e-6,
                                    schedule_stride=5)
    with JaxSolver(H, None, opts=_jax_opts(opts), mesh=make_mesh(1, 1)) as jsolver:
        want, jax_stats = _run_sched(jsolver, _items(frames), lanes=3,
                                     batcher_cls=JaxBatcher)
    with _solver(H, opts) as solver:
        got, stats = _run_sched(solver, _items(frames), lanes=3)
    assert [r[0] for r in got] == [r[0] for r in want] == [float(i) for i in range(9)]
    assert [r[1] for r in got] == [r[1] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    np.testing.assert_allclose(np.stack([r[3] for r in got]),
                               np.stack([r[3] for r in want]), rtol=1e-8)
    assert len({r[2] for r in got}) >= 3  # lanes retire at different strides
    assert stats.frames == 9
    assert stats.backfilled == jax_stats.backfilled == 9  # every frame loaded once


# ---------------------------------------------------------------------------
# the scheduler's contracts inside the port
# ---------------------------------------------------------------------------

def test_masked_lane_byte_parity_vs_dense_grouped():
    """Every retired lane's solution, status and iteration count equal the
    classic grouped loop's on the same frame order, byte for byte, on a
    frame set whose iteration counts genuinely spread."""
    H, frames = _mixed_case(10, seed=1)
    with _solver(H, _opts()) as solver:
        want = _run_dense(solver, frames, 4)
        got, stats = _run_sched(solver, _items(frames), lanes=4)
    assert [r[0] for r in got] == [float(i) for i in range(10)]  # frame order
    _assert_matches_dense(got, want)
    assert max(want[2]) >= 2 * min(want[2])
    assert stats.frames == 10
    assert 0.0 < stats.occupancy <= 1.0


def test_tail_drain_below_full_batch():
    """Fewer frames than lanes: the tail drains with the free lanes inert
    and matches the dense loop's dark-padded group bitwise."""
    H, frames = _mixed_case(2, seed=2)
    with _solver(H, _opts()) as solver:
        want = _run_dense(solver, frames, 5)
        got, stats = _run_sched(solver, _items(frames), lanes=5)
    _assert_matches_dense(got, want)
    assert stats.frames == 2


def test_all_lanes_converge_in_one_stride():
    """A stride longer than any frame's iteration count: every lane
    retires at its first control return, the loop ends with the slowest
    lane, and each refill generation costs one stride."""
    H, frames = _mixed_case(6, seed=3)
    with _solver(H, _opts(schedule_stride=10_000)) as solver:
        want = _run_dense(solver, frames, 3)
        got, stats = _run_sched(solver, _items(frames), lanes=3)
    _assert_matches_dense(got, want)
    assert stats.strides == 2
    assert stats.loop_steps <= max(want[2]) * 2


def test_schedule_stride_one():
    """stride=1 (retirement checked every iteration) stays byte-correct."""
    H, frames = _mixed_case(4, seed=4)
    with _solver(H, _opts(schedule_stride=1, max_iterations=60)) as solver:
        want = _run_dense(solver, frames, 2)
        got, _ = _run_sched(solver, _items(frames), lanes=2)
    _assert_matches_dense(got, want)


def test_oom_hands_unemitted_frames_back_in_order(monkeypatch):
    """A device OOM in a stride: every un-emitted frame comes back in frame
    order (the rest of the stream unread), the lanes' state untouched, and
    the frames re-solve on the grouped loop."""
    H, frames = _mixed_case(6, seed=11)
    with _solver(H, _opts(max_iterations=800)) as solver:
        real = solver.sched_step
        calls = {"n": 0}

        def step(lane_state, refills):
            calls["n"] += 1
            if calls["n"] == 3:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")
            return real(lane_state, refills)

        monkeypatch.setattr(solver, "sched_step", step)
        items = iter(_items(frames))
        events = []
        got, stats = _run_sched(solver, items, lanes=2, refill_quantum=1,
                                on_event=events.append)
        assert len(events) == 1 and "OutOfMemoryError" in events[0]
        emitted = [r[0] for r in got]
        back = [it[1] for it in stats.leftover]
        assert emitted + back == [float(i) for i in range(len(emitted) + len(back))]
        assert len(back) >= 2
        rest = list(items)
        assert len(emitted) + len(back) + len(rest) == 6
        _, st, _ = _run_dense(solver, [it[0] for it in stats.leftover] +
                              [it[0] for it in rest], 1)
        assert st == [0] * (len(back) + len(rest))


def test_failed_stride_leaves_the_lane_state_intact(monkeypatch):
    """A stride that dies mid-way (an OOM in its third sweep) commits
    nothing: the lane state and norms are the previous stride's, and the
    scheduler hands the in-flight frames back."""
    H, frames = _mixed_case(4, seed=14)
    with _solver(H, _opts()) as solver:
        lanes = solver.sched_lanes(2)
        solver.sched_step(lanes, [(0, frames[0]), (1, frames[1])])
        before = [None if t is None else t.clone() for t in lanes.state]
        state, norms = lanes.state, lanes.norms.copy()
        plain, calls = fs.fused_sweep_reference, {"n": 0}

        def failing(*args, **kw):
            calls["n"] += 1
            if calls["n"] == 3:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
            return plain(*args, **kw)

        monkeypatch.setattr(fs, "fused_sweep_reference", failing)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            solver.sched_step(lanes, [])
        assert lanes.state is state and np.array_equal(lanes.norms, norms)
        for got, want in zip(lanes.state, before):
            assert (got is None) == (want is None)
            if got is not None:
                assert torch.equal(got, want)
        calls["n"] = 0
        _, stats = _run_sched(solver, _items(frames), lanes=2)
    assert [it[1] for it in stats.leftover] == [0.0, 1.0]


@pytest.mark.parametrize("error", [RuntimeError("launch failed"), ValueError("bad")])
def test_non_oom_dispatch_error_raises(monkeypatch, error):
    H, frames = _mixed_case(3, seed=10)
    with _solver(H, _opts()) as solver:
        def step(lane_state, refills):
            raise error
        monkeypatch.setattr(solver, "sched_step", step)
        with pytest.raises(type(error)):
            _run_sched(solver, _items(frames), lanes=2)


def test_lane_and_stride_validation():
    H, _ = _mixed_case(1, seed=13)
    with pytest.raises(ValueError, match="schedule_stride"):
        _opts(schedule_stride=0)
    with _solver(H, _opts()) as solver:
        with pytest.raises(ValueError, match="[Ll]ane count"):
            solver.sched_lanes(0)
        with pytest.raises(ValueError, match="[Ll]ane count"):
            ContinuousBatcher(solver, lanes=0, on_result=lambda *a: None)
        lanes = solver.sched_lanes(2)
        with pytest.raises(ValueError, match="refilled twice"):
            solver.sched_step(lanes, [(0, np.ones(P_PIX)), (0, np.ones(P_PIX))])
        with pytest.raises(ValueError, match="shape"):
            solver.sched_step(lanes, [(1, np.ones(P_PIX + 1))])
    with pytest.raises(ValueError, match="closed"):
        solver.sched_lanes(2)


def test_scheduler_occupancy_accounting_beats_run_to_slowest():
    """On a straggler-heavy stream (one slow frame leading every group of
    4) the scheduler does the same useful work at >= 1.5x the dense loop's
    run-to-slowest occupancy."""
    rng = np.random.default_rng(0)
    H = rng.uniform(0.1, 1.0, (P_PIX, V_VOX)).astype(np.float32)
    x = np.arange(V_VOX) / V_VOX
    base = 1.0 + 0.5 * np.sin(2 * np.pi * x)
    rough = np.sin(2 * np.pi * 6.5 * x)
    amps = np.full(24, 1e-3)
    amps[::4] = 3.0
    frames = [np.maximum(H.astype(np.float64) @ np.maximum(base + a * rough, 1e-3)
                         * (1.0 + 1e-3 * rng.standard_normal(P_PIX)), 0.0) for a in amps]
    opts = _opts(conv_tolerance=1e-5, max_iterations=800, schedule_stride=4)
    with _solver(H, opts) as solver:
        _, statuses, iters = _run_dense(solver, frames, 4)
        cap = sum(max(iters[s:s + 4]) * 4 for s in range(0, len(frames), 4))
        _, stats = _run_sched(solver, _items(frames), lanes=4)
    assert statuses == [0] * len(frames)
    assert stats.useful_iters == sum(iters)
    assert stats.occupancy >= 1.5 * sum(iters) / cap


@pytest.mark.parametrize("logarithmic", [False, True])
def test_every_sweep_of_a_scheduled_run_has_the_lane_count(monkeypatch, logarithmic):
    """One batch size, so one kernel plan, at every occupancy: full, partial
    and single-lane strides all sweep B = lanes rows."""
    H, frames = _mixed_case(7, seed=7)
    seen = []
    plain = fs.fused_sweep_reference

    def spy(rtm, w, *args, **kw):
        seen.append(w.shape[0])
        return plain(rtm, w, *args, **kw)

    monkeypatch.setattr(fs, "fused_sweep_reference", spy)
    with _solver(H, _opts(logarithmic=logarithmic)) as solver:
        _, stats = _run_sched(solver, _items(frames), lanes=3)
    assert stats.frames == 7
    assert len(seen) == stats.loop_steps and set(seen) == {3}
