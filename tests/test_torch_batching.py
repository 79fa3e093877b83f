"""Frame grouping in the port: the warm-start chain against the JAX package
and against serial solves, and the CLI's three frame loops (the
continuous-batching scheduler, the classic grouped loop, the chain) against
the JAX CLI and against each other.

On the CPU the port's sweep is its plain version; the JAX CLI runs on one
device (``--pixel_shards 1``), with ``--fused_sweep interpret`` for int8.
Inside the port the loops agree byte for byte: scheduled and classic
grouped, any ``--schedule_stride`` and the default, ``--chain_frames K``
and ``--chain_frames 1``. A device OOM halves the frame group and
re-solves the same frames.
"""

import dataclasses

import h5py
import numpy as np
import pytest
import torch

import fixtures as fx
from sartsolver_tpu.cli import main as jax_main
from sartsolver_tpu.config import SolverOptions as JaxOptions
from sartsolver_tpu.models import sart as jsart
from sartsolver_tpu.ops.laplacian import make_laplacian as jax_make_laplacian
from sartsolver_tpu.parallel.mesh import make_mesh
from sartsolver_tpu.parallel.sharded import DistributedSARTSolver as JaxSolver

from sartsolver_tpu_torch.cli import main as torch_main
from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.models import sart as tsart
from sartsolver_tpu_torch.ops.laplacian import make_laplacian
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

P, V = 24, 256


def _case(n_frames, seed=0):
    """A matrix with masked voxels and a masked pixel, and frames whose
    truth drifts from frame to frame (a time series)."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.1, 1.0, (P, V)).astype(np.float32)
    H[:, :3] = 0.0
    H[3, :] = 0.0
    f_true = rng.uniform(0.5, 2.0, V)
    frames = []
    for k in range(n_frames):
        f_k = f_true * (1.0 + 0.2 * np.sin(k + np.arange(V) / 40.0))
        g = H.astype(np.float64) @ f_k * (3.0 + k)
        g[5] = -1.0  # saturated detector
        frames.append(g)
    return H, np.stack(frames)


def _lap_triplets():
    i = np.arange(V)
    rows = np.concatenate([i, i[1:], i[:-1]])
    cols = np.concatenate([i, i[1:] - 1, i[:-1] + 1])
    vals = np.concatenate([np.full(V, 2.0), np.full(2 * V - 2, -1.0)])
    return rows, cols, vals


def _options(profile, logarithmic, with_lap):
    kw = dict(max_iterations=40, logarithmic=logarithmic,
              beta_laplace=0.005 if with_lap else 0.0)
    if profile == "fp64":
        return SolverOptions.cpu_parity(conv_tolerance=1e-6, **kw)
    # fp32 to the cap: an fp32 stall crossing moves by an iteration between
    # the frameworks where dC lies within rounding of the tolerance
    return SolverOptions(conv_tolerance=0.0, **kw)


def _jax_opts(opts):
    return JaxOptions(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)})


def _assert_close(got, want, profile):
    if profile == "fp64":
        np.testing.assert_allclose(got, want, rtol=1e-8)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("profile", ["fp64", "fp32"])
@pytest.mark.parametrize("with_lap", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
def test_solve_chain_normalized_matches_jax(logarithmic, with_lap, profile):
    """Frame 0 from the Eq. 4 guess, then each frame warm-started from the
    last: equal statuses and iterations, solutions and the last fitted at
    the bars (fp64 1e-8; fp32 rtol 2e-4, atol 1e-5)."""
    H, G = _case(4)
    opts = _options(profile, logarithmic, with_lap)
    jopts = _jax_opts(opts)
    tdt = tsart.torch_dtype(opts.dtype)
    jlap = tlap = None
    if with_lap:
        jlap = jax_make_laplacian(*_lap_triplets(), dtype=opts.dtype)
        tlap = make_laplacian(*_lap_triplets(), nvoxel=V, dtype=tdt)
    jprob = jsart.make_problem(H, jlap, opts=jopts)
    tprob = tsart.make_problem(H, tlap, opts=opts, device="cpu")
    gs, msqs, norms = zip(*(tsart.prepare_measurement(g, opts) for g in G))
    rescale = np.ones(len(G))
    rescale[1:] = np.asarray(norms[:-1]) / np.asarray(norms[1:])
    dtype = np.float64 if profile == "fp64" else np.float32
    want, want_fit = jsart.solve_chain_normalized(
        jprob, np.stack(gs).astype(dtype), np.asarray(msqs, dtype),
        np.zeros((1, V), dtype), np.asarray(rescale, dtype), opts=jopts,
        use_guess_first=True)
    got, got_fit = tsart.solve_chain_normalized(
        tprob, torch.as_tensor(np.stack(gs)).to(tdt), torch.as_tensor(msqs).to(tdt),
        torch.zeros((1, V), dtype=tdt), torch.as_tensor(rescale), opts=opts,
        use_guess_first=True, device="cpu")
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    _assert_close(got.solution.numpy(), np.asarray(want.solution), profile)
    _assert_close(got_fit.numpy(), np.asarray(want_fit), profile)


@pytest.mark.parametrize("profile", ["fp64", "fp32"])
def test_host_seeds_f0_match_the_jax_solver(profile):
    """``f0=`` (a resumed run's warm start, host rows in physical units) on
    ``solve_batch`` and ``solve_chain``: against the JAX solver's at the
    bars; ``warm=`` and ``f0=`` together raise the JAX ``ValueError``."""
    H, G = _case(4, seed=5)
    opts = _options(profile, False, True)
    tdt = tsart.torch_dtype(opts.dtype)
    tlap = make_laplacian(*_lap_triplets(), nvoxel=V, dtype=tdt)
    jlap = jax_make_laplacian(*_lap_triplets(), dtype=opts.dtype)
    seeds = np.random.default_rng(6).uniform(0.5, 2.0, (2, V)) * 3.0
    with JaxSolver(H, jlap, opts=_jax_opts(opts), mesh=make_mesh(1, 1)) as jsolver:
        jb = jsolver.solve_batch(G[:2], seeds, device_result=True)
        jc = jsolver.solve_chain(G[2:], f0=seeds[1])
        with pytest.raises(ValueError, match="not both"):
            jsolver.solve_chain(G[2:], f0=seeds[1], warm=jc)
    with DistributedSARTSolver(H, tlap, opts=opts, device="cpu") as solver:
        tb = solver.solve_batch(G[:2], f0=seeds)
        tc = solver.solve_chain(G[2:], f0=seeds[1])
        with pytest.raises(ValueError, match="not both"):
            solver.solve_chain(G[2:], f0=seeds[1], warm=tc)
    for got, want in ((tb, jb), (tc, jc)):
        np.testing.assert_array_equal(got.status, want.status)
        np.testing.assert_array_equal(got.iterations, want.iterations)
        _assert_close(got.fetch_solutions(), want.fetch_solutions(), profile)


@pytest.mark.parametrize("profile", ["fp64", "fp32"])
def test_solver_solve_chain_matches_jax_and_serial(profile):
    """``DistributedSARTSolver.solve_chain`` over two chains joined by the
    device warm carry: against the JAX solver's at the bars, and inside the
    port equal byte for byte to one chain of all the frames and to serial
    B = 1 solves, each warm-started from the last."""
    H, G = _case(5, seed=3)
    opts = _options(profile, False, True)
    tdt = tsart.torch_dtype(opts.dtype)
    tlap = make_laplacian(*_lap_triplets(), nvoxel=V, dtype=tdt)
    jlap = jax_make_laplacian(*_lap_triplets(), dtype=opts.dtype)
    with JaxSolver(H, jlap, opts=_jax_opts(opts), mesh=make_mesh(1, 1)) as jsolver:
        j1 = jsolver.solve_chain(G[:3])
        j2 = jsolver.solve_chain(G[3:], warm=j1)
        want = [np.concatenate([j1.fetch_solutions(), j2.fetch_solutions()]),
                np.concatenate([j1.status, j2.status]),
                np.concatenate([j1.iterations, j2.iterations])]
    with DistributedSARTSolver(H, tlap, opts=opts, device="cpu") as solver:
        t1 = solver.solve_chain(G[:3])
        t2 = solver.solve_chain(G[3:], warm=t1)
        got = [np.concatenate([t1.fetch_solutions(), t2.fetch_solutions()]),
               np.concatenate([t1.status, t2.status]),
               np.concatenate([t1.iterations, t2.iterations])]
        whole = solver.solve_chain(G)
        problem = solver.problem
        serial, warm = [], None
        for g_row in G:
            g64, msq, norm = tsart.prepare_measurement(g_row, opts)
            g = torch.as_tensor(g64[None, :]).to(tdt)
            msq_t = torch.tensor([msq], dtype=tdt)
            if warm is None:
                res, fitted = tsart.solve_normalized_batch(
                    problem, g, msq_t, torch.zeros((1, V), dtype=tdt), opts=opts,
                    use_guess=True, return_fitted=True, device="cpu")
            else:
                scale = torch.tensor(warm[2] / norm, dtype=tdt)
                res, fitted = tsart.solve_normalized_batch(
                    problem, g, msq_t, warm[0] * scale, opts=opts, use_guess=False,
                    fitted0=warm[1] * scale, return_fitted=True, device="cpu")
            warm = (res.solution, fitted, norm)
            serial.append((res.solution[0].double().numpy() * norm, int(res.status[0]),
                           int(res.iterations[0])))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    _assert_close(got[0], want[0], profile)
    np.testing.assert_array_equal(whole.fetch_solutions(), got[0])
    np.testing.assert_array_equal(whole.iterations, got[2])
    np.testing.assert_array_equal(np.stack([s[0] for s in serial]), got[0])
    assert [s[1] for s in serial] == got[1].tolist()
    assert [s[2] for s in serial] == got[2].tolist()


def test_solver_solve_batch_equals_the_solver_core():
    """``DistributedSARTSolver.solve_batch`` at B = 1 against
    ``models.sart.solve`` from the guess: the same loop, so equal statuses
    and iterations; the solutions one fp32 rounding apart (``solve``
    denormalizes in fp32 on the device, the solver in fp64 on the host). A
    closed solver refuses."""
    H, G = _case(2, seed=4)
    opts = _options("fp32", False, False)
    problem = tsart.make_problem(H, opts=opts, device="cpu")
    with DistributedSARTSolver(H, opts=opts, device="cpu") as solver:
        got = solver.solve_batch(G[1:2])
        want = tsart.solve(problem, G[1], opts=opts, device="cpu")
        np.testing.assert_allclose(got.fetch_solutions()[0], want.solution.double().numpy(),
                                   rtol=2 ** -23)
        assert (int(got.status[0]), int(got.iterations[0])) == (int(want.status),
                                                                int(want.iterations))
    with pytest.raises(ValueError, match="closed"):
        solver.solve_batch(G)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

FP64 = ["--use_cpu", "-m", "300", "-c", "1e-6"]
FP32 = ["-m", "40", "-c", "1e-12"]  # a short budget; -c 1e-12 stops only at a stall


@pytest.fixture
def world(tmp_path):
    return fx.write_world(tmp_path, n_frames=5, with_laplacian=True)


def _inputs(paths):
    return [paths[k] for k in ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b")]


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f["solution"][k][:] for k in f["solution"]}


def _port(paths, out, *flags):
    return torch_main(["-o", out, *_inputs(paths), "-l", paths["laplacian"],
                       "-b", "0.001", *flags])


def _assert_same_file(a, b):
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("profile", ["fp64", "fp32", "bfloat16", "int8"])
def test_cli_batch_frames_matches_jax_cli(world, tmp_path, profile, capsys):
    """``--no_guess --batch_frames 3`` (the scheduler, 3 lanes over 5
    frames) against the JAX CLI's: equal frame times; fp64 statuses,
    iterations and values at 1e-8; fp32, bf16 and int8 in fitted space
    within 5e-3, each status agreeing with its own iteration count."""
    paths, H, *_ = world
    flags = ["--no_guess", "--batch_frames", "3", "-l", paths["laplacian"], "-b", "0.001"]
    if profile == "fp64":
        flags += FP64
        port_flags = []
    else:
        flags += FP32 + ([] if profile == "fp32" else ["--rtm_dtype", profile])
        port_flags = ["--device", "cpu"]
    jax_extra = ["--fused_sweep", "interpret"] if profile == "int8" else []
    jax_out, port_out = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jax_main(["-o", jax_out, *_inputs(paths), *flags, *jax_extra,
                     "--pixel_shards", "1"]) == 0
    capsys.readouterr()
    assert torch_main(["-o", port_out, *_inputs(paths), *flags, *port_flags]) == 0
    out = capsys.readouterr().out
    assert out.count("Processed in:") == 5 and "continuous batch of 3 lanes" in out
    assert "continuous batching: lanes=3" in out
    jsol, tsol = _read(jax_out), _read(port_out)
    for key in ("time", f"time_{fx.CAM_A}", f"time_{fx.CAM_B}"):
        np.testing.assert_array_equal(tsol[key], jsol[key], err_msg=key)
    if profile == "fp64":
        for key in ("status", "iterations"):
            np.testing.assert_array_equal(tsol[key], jsol[key], err_msg=key)
        np.testing.assert_allclose(tsol["value"], jsol["value"], rtol=1e-8)
        return
    np.testing.assert_array_equal(tsol["status"] != 0, tsol["iterations"] == 40)
    for i in range(5):
        ref = H @ jsol["value"][i]
        err = np.linalg.norm(H @ tsol["value"][i] - ref) / np.linalg.norm(ref)
        assert err <= 5e-3, (i, err)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_cli_loops_agree_byte_for_byte(world, tmp_path, monkeypatch, storage, capsys):
    """Inside the port: the scheduler equals the classic grouped loop; a
    ``--schedule_stride`` flag and the ``SART_SCHEDULE_STRIDE`` environment
    variable equal the default stride; ``--chain_frames 3`` (groups crossing
    the warm carry) equals ``--chain_frames 1``."""
    paths, *_ = world
    flags = ["--device", "cpu", "-m", "60", "-c", "1e-5", "--rtm_dtype", storage]
    outs = {}
    for name, extra in (
        ("sched", ["--no_guess", "--batch_frames", "3"]),
        ("classic", ["--no_guess", "--batch_frames", "3", "--no_continuous_batching"]),
        ("stride", ["--no_guess", "--batch_frames", "3", "--schedule_stride", "5"]),
        ("chain3", ["--chain_frames", "3"]),
        ("chain1", ["--chain_frames", "1"]),
    ):
        outs[name] = str(tmp_path / f"{name}.h5")
        assert _port(paths, outs[name], *flags, *extra) == 0
    monkeypatch.setenv("SART_SCHEDULE_STRIDE", "3")
    outs["env"] = str(tmp_path / "env.h5")
    assert _port(paths, outs["env"], *flags, "--no_guess", "--batch_frames", "3") == 0
    text = capsys.readouterr().out
    assert text.count("average over chain of 3") == 3
    sched = _read(outs["sched"])
    for name in ("classic", "stride", "env"):
        _assert_same_file(_read(outs[name]), sched)
    _assert_same_file(_read(outs["chain3"]), _read(outs["chain1"]))
    assert (sched["status"] == 0).all() and (_read(outs["chain1"])["status"] == 0).all()


@pytest.mark.parametrize("where", ["sched_step", "solve_batch"])
def test_cli_oom_halves_the_group(world, tmp_path, monkeypatch, where, capsys):
    """A device OOM in the scheduler or in the grouped loop's first
    dispatch: the run exits 0 with every status 0, the frames re-solved at
    half the group size, and the file equals the grouped loop run at the
    halved size from the start."""
    _oom_halves_the_group(world, tmp_path, monkeypatch, where, capsys, [])


@pytest.mark.parametrize("where", ["sched_step", "solve_batch"])
def test_cli_oom_halves_the_group_with_the_variants(world, tmp_path, monkeypatch, where,
                                                    capsys):
    """The same with the solver variants on (the schedule, momentum and an
    armed guard): their per-frame state starts over in the halved groups."""
    _oom_halves_the_group(world, tmp_path, monkeypatch, where, capsys,
                          ["--relaxation_decay", "0.99", "--momentum", "nesterov",
                           "--divergence_recovery", "2"])


def _oom_halves_the_group(world, tmp_path, monkeypatch, where, capsys, variants):
    paths, *_ = world
    flags = ["--device", "cpu", "-m", "300", "-c", "1e-6", *variants]
    real = getattr(DistributedSARTSolver, where)
    calls = {"n": 0}

    def failing(self, *args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return real(self, *args, **kw)

    monkeypatch.setattr(DistributedSARTSolver, where, failing)
    loop = ["--no_guess", "--batch_frames", "4"]
    if where == "solve_batch":
        loop.append("--no_continuous_batching")
    halved = ["--no_guess", "--batch_frames", "2", "--no_continuous_batching"]
    out = str(tmp_path / "oom.h5")
    assert _port(paths, out, *flags, *loop) == 0
    captured = capsys.readouterr()
    if where == "sched_step":
        assert "handing 4 in-flight/buffered frame(s) back" in captured.err
    else:
        assert "re-solving the same frames at 2" in captured.err
        assert "oom degradation: frame-group size 4 -> 2" in captured.out
    got = _read(out)
    assert (got["status"] == 0).all() and len(got["status"]) == 5
    monkeypatch.setattr(DistributedSARTSolver, where, real)
    want_out = str(tmp_path / "halved.h5")
    assert _port(paths, want_out, *flags, *halved) == 0
    _assert_same_file(got, _read(want_out))


def test_cli_chain_oom_propagates(world, tmp_path, monkeypatch):
    """The chain loop has no ladder: it solves its frames one at a time at
    B = 1, so a smaller group would need no less memory. Under
    ``--fail_fast`` a device OOM there ends the run; with per-frame
    isolation (the default) it is a recoverable frame error, as in the JAX
    CLI: the group's frames are FAILED rows and the run exits 2."""
    paths, *_ = world

    def failing(self, *args, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")

    monkeypatch.setattr(DistributedSARTSolver, "solve_chain", failing)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _port(paths, str(tmp_path / "oom.h5"), "--device", "cpu", "--chain_frames", "4",
              "--fail_fast")
    out = str(tmp_path / "isolated.h5")
    assert _port(paths, out, "--device", "cpu", "--chain_frames", "4") == 2
    with h5py.File(out, "r") as f:
        assert (f["solution/status"][:] == -3).all()


@pytest.mark.parametrize("argv,env,message", [
    (["--batch_frames", "0"], None, "batch_frames must be >= 1"),
    (["--batch_frames", "2"], None, "requires --no_guess"),
    (["--chain_frames", "0"], None, "chain_frames must be >= 1"),
    (["--no_guess", "--batch_frames", "2", "--schedule_stride", "0"], None,
     "schedule_stride must be >= 1"),
    (["--no_guess", "--batch_frames", "2"], "abc", "SART_SCHEDULE_STRIDE must be an integer"),
    (["--no_guess", "--batch_frames", "2"], "0", "SART_SCHEDULE_STRIDE must be >= 1"),
])
def test_cli_frame_group_errors_exit_1(world, tmp_path, monkeypatch, argv, env, message,
                                       capsys):
    paths, *_ = world
    if env is not None:
        monkeypatch.setenv("SART_SCHEDULE_STRIDE", env)
    argv = ["-o", str(tmp_path / "o.h5"), *_inputs(paths), "--device", "cpu", *argv]
    try:
        rc = torch_main(argv)
    except SystemExit as err:
        rc = err.code
    assert rc == 1
    assert message in capsys.readouterr().err
