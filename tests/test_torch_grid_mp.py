"""The solve on a grid of ranks over gloo on the CPU, against the JAX package.

Ranks are processes of ``tests/torch_grid_worker.py`` (world 2 and 4, each
spawn with a timeout), started with the launcher's environment; the CLI is
also launched once by ``torch.distributed.run``. The JAX package runs its
mesh of the same shape on the CPU's 8 host devices (``tests/conftest.py``):

- ``DistributedSARTSolver`` on the grids (2,1), (1,2), (2,2), (4,1) and
  (1,4), linear and log, with and without the Laplacian, against the JAX
  solver on the same mesh shape: fp64 with equal statuses and iterations
  and values within 1e-8, fp32 to the iteration cap within rtol 2e-4 /
  atol 1e-5; also the warm chain, and per-rank measurement staging;
- the CLI over two ranks against the JAX CLI ``--use_cpu --pixel_shards 2``
  on ``fixtures.write_world`` (rtol 1e-9), as ``tests/test_multiprocess.py``
  holds the JAX package's two-process run; only rank 0 prints;
- two runs of the same grid byte for byte, and the ranks of a voxel column
  holding the same bytes;
- each refusal of a grid of more than one rank: exit 1, its words.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import h5py
import numpy as np
import pytest

import fixtures as fx
from sartsolver_tpu.cli import main as jax_main
from sartsolver_tpu.config import SolverOptions as JOptions
from sartsolver_tpu.ops.laplacian import make_laplacian as jax_laplacian
from sartsolver_tpu.parallel.mesh import make_mesh
from sartsolver_tpu.parallel.sharded import DistributedSARTSolver as JaxSolver
from test_sart_core import laplacian_1d_chain, make_case

from sartsolver_tpu_torch.cli import main as torch_main

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SPAWN_TIMEOUT = 240  # seconds, a whole spawn

# (name, profile, logarithmic, with the Laplacian)
CASES = [("fp64-linear-lap", "fp64", False, True), ("fp64-log", "fp64", True, False),
         ("fp32-linear", "fp32", False, False), ("fp32-log-lap", "fp32", True, True)]
GRIDS_2 = [(2, 1), (1, 2)]
GRIDS_4 = [(2, 2), (4, 1), (1, 4)]
FP64 = dict(max_iterations=200, conv_tolerance=1e-6)
FP32 = dict(max_iterations=60, conv_tolerance=1e-12)  # runs to the cap


def _problem():
    H, g, _ = make_case(seed=5, P=40, V=300)
    return H, np.stack([g, 1.3 * g]), laplacian_1d_chain(300, 0.05)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank: int, world: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def _spawn(world: int, jobs: list, out_dir: str) -> None:
    """Run ``jobs`` on ``world`` worker ranks; every rank must exit 0 within
    ``SPAWN_TIMEOUT`` seconds (all are killed otherwise)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "jobs.pkl")
    with open(path, "wb") as f:
        pickle.dump(jobs, f)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_grid_worker.py"),
                               path, out_dir], env=_env(r, world, port), cwd=out_dir,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"--- rank {r} (exit {p.returncode}) ---\n{o[-3000:]}"
        for r, (p, o) in enumerate(zip(procs, outs)))


def _solver_jobs(grids) -> list:
    H, G, lap = _problem()
    jobs = []
    for grid in grids:
        for name, profile, log, with_lap in CASES:
            jobs.append(dict(name=f"{grid[0]}x{grid[1]}-{name}", grid=grid, H=H, G=G,
                             lap=lap if with_lap else None, cpu_parity=profile == "fp64",
                             opts=dict(logarithmic=log, **(FP64 if profile == "fp64" else FP32)),
                             mode="batch"))
    return jobs


def _world_inputs(paths) -> list:
    return [paths[k] for k in ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b")]


# (name, the CLI's flags beyond the inputs and --multihost, the words of its refusal)
CLI_REFUSALS = [
    ("int8_pixel", ["--device", "cpu", "--rtm_dtype", "int8", "--pixel_shards", "2"],
     "so per-column maxima stay process-local"),
    ("os_subsets", ["--use_cpu", "--os_subsets", "2", "--pixel_shards", "2"],
     "Argument os_subsets=2 runs the subset cycle"),
    ("sparse", ["--use_cpu", "--sparse_rtm", "auto", "--pixel_shards", "2"],
     "Argument sparse_rtm=auto"),
    ("lowrank", ["--device", "cpu", "--lowrank_rtm", "4", "--voxel_shards", "2"],
     "Argument lowrank_rtm factors"),
    ("integrity", ["--use_cpu", "--integrity", "--pixel_shards", "2"], "Argument integrity"),
    ("debug_nans", ["--use_cpu", "--debug_nans", "--voxel_shards", "2"],
     "Argument debug_nans"),
    ("larger_grid", ["--use_cpu", "--pixel_shards", "3"], "Mesh 3x1 needs 3 devices, have 2."),
    ("smaller_grid", ["--use_cpu", "--pixel_shards", "1"], "covers 1 of the world's 2 ranks"),
]
CLI_RUN = ["--use_cpu", "-m", "100", "-c", "1e-8", "-b", "0.001"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("grid_world")
    paths = fx.write_world(str(d), with_laplacian=True)[0]
    return paths, d


@pytest.fixture(scope="module")
def world2(world, tmp_path_factory):
    """The world-2 spawn: the solver cases on (2,1) and (1,2), the warm chain
    and per-rank staging on (2,1), the CLI run and the CLI's refusals."""
    paths, _ = world
    out = str(tmp_path_factory.mktemp("world2"))
    H, G, lap = _problem()
    jobs = _solver_jobs(GRIDS_2)
    for mode in ("chain", "local"):
        jobs.append(dict(name=f"2x1-fp64-{mode}", grid=(2, 1), H=H, G=G, lap=lap,
                         cpu_parity=True, opts=FP64, mode=mode))
    inputs = _world_inputs(paths)
    jobs.append(dict(name="cli", cli=["-o", os.path.join(out, "cli.h5"), *inputs, *CLI_RUN,
                                      "-l", paths["laplacian"], "--multihost",
                                      "--pixel_shards", "2"]))
    for name, flags, _ in CLI_REFUSALS:
        jobs.append(dict(name=f"refuse-{name}",
                         cli=["-o", os.path.join(out, f"{name}.h5"), *inputs, *flags,
                              "--multihost"]))
    _spawn(2, jobs, out)
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("world4"))
    _spawn(4, _solver_jobs(GRIDS_4), out)
    return out


def _jax_solve(grid, profile, log, with_lap, mode="batch"):
    H, G, lap = _problem()
    base = FP64 if profile == "fp64" else FP32
    opts = (JOptions.cpu_parity if profile == "fp64" else JOptions)(logarithmic=log, **base)
    solver = JaxSolver(H if profile == "fp64" else H.astype(np.float32),
                       jax_laplacian(*lap, dtype=opts.dtype) if with_lap else None,
                       opts=opts, mesh=make_mesh(*grid))
    if mode == "chain":
        res = solver.solve_chain(G)
        return (res.fetch_solutions() if hasattr(res, "fetch_solutions") else
                np.asarray(res.solution)), np.asarray(res.status), np.asarray(res.iterations)
    res = solver.solve_batch(G)
    return np.asarray(res.solution), np.asarray(res.status), np.asarray(res.iterations)


def _check(out_dir, name, grid, profile, log, with_lap, mode="batch"):
    got = np.load(os.path.join(out_dir, f"{name}.npz"))
    sol, status, iters = _jax_solve(grid, profile, log, with_lap, mode)
    if profile == "fp64":
        np.testing.assert_array_equal(got["status"], status)
        np.testing.assert_array_equal(got["iterations"], iters)
        np.testing.assert_allclose(got["solution"], sol, rtol=1e-8, atol=1e-12)
    else:
        assert (got["iterations"] == FP32["max_iterations"]).all()
        np.testing.assert_array_equal(got["status"], status)
        np.testing.assert_allclose(got["solution"], sol, rtol=2e-4, atol=1e-5)
    if grid != (1, 1):
        assert int(got["collectives"]) > 0


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("grid", GRIDS_2, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_of_two_matches_jax_mesh(world2, grid, case):
    _check(world2, f"{grid[0]}x{grid[1]}-{case[0]}", grid, *case[1:])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("grid", GRIDS_4, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_of_four_matches_jax_mesh(world4, grid, case):
    _check(world4, f"{grid[0]}x{grid[1]}-{case[0]}", grid, *case[1:])


def test_grid_chain_matches_jax_mesh(world2):
    _check(world2, "2x1-fp64-chain", (2, 1), "fp64", False, True, mode="chain")


def test_grid_local_staging_matches_jax_mesh(world2):
    """Each rank given only its own pixel rows; the max and ||g||^2 of every
    frame combined over the pixel axis."""
    _check(world2, "2x1-fp64-local", (2, 1), "fp64", False, True)


def test_grid_runs_are_byte_identical(world2, tmp_path):
    """The same grid and jobs again: every rank's solution bytes; and the two
    ranks of the 2x1 grid's one voxel column hold the same bytes."""
    again = str(tmp_path / "again")
    jobs = [j for j in _solver_jobs(GRIDS_2) if j["name"] in ("2x1-fp32-linear",
                                                             "1x2-fp32-log-lap")]
    _spawn(2, jobs, again)
    for job in jobs:
        for r in range(2):
            a = np.load(os.path.join(world2, f"{job['name']}.r{r}.npy"))
            b = np.load(os.path.join(again, f"{job['name']}.r{r}.npy"))
            assert a.tobytes() == b.tobytes()
    r0, r1 = (np.load(os.path.join(world2, f"2x1-fp32-linear.r{r}.npy")) for r in range(2))
    assert r0.tobytes() == r1.tobytes()


def _rank_cli(out_dir, name, rank):
    with open(os.path.join(out_dir, f"{name}.r{rank}.json")) as f:
        return json.load(f)


def _jax_cli_reference(paths, tmp_path):
    ref = str(tmp_path / "jax.h5")
    assert jax_main(["-o", ref, *_world_inputs(paths), *CLI_RUN, "-l", paths["laplacian"],
                     "--pixel_shards", "2"]) == 0
    return ref


def _assert_same_file(got_path, ref_path):
    with h5py.File(ref_path, "r") as fr, h5py.File(got_path, "r") as fg:
        np.testing.assert_allclose(fg["solution/value"][:], fr["solution/value"][:],
                                   rtol=1e-9, atol=1e-12)
        for key in ("status", "iterations", "time"):
            np.testing.assert_array_equal(fg[f"solution/{key}"][:], fr[f"solution/{key}"][:])
        assert "voxel_map" in fg


def test_cli_over_two_ranks_matches_jax_cli(world, world2, tmp_path):
    paths, _ = world
    primary, other = _rank_cli(world2, "cli", 0), _rank_cli(world2, "cli", 1)
    assert primary["rc"] == other["rc"] == 0
    assert primary["out"].count("Processed in:") == 4
    assert other["out"] == ""  # only the primary rank prints
    assert ("solver: mesh=2x1 (pixels x voxels, pixel-major) device=cpu collectives=gloo"
            in primary["out"])
    _assert_same_file(os.path.join(world2, "cli.h5"), _jax_cli_reference(paths, tmp_path))


def test_torchrun_cli_matches_jax_cli(world, tmp_path):
    """The launch a user makes: torch.distributed.run over two ranks."""
    paths, _ = world
    out = str(tmp_path / "torchrun.h5")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "sartsolver_tpu_torch.cli", "-o", out, *_world_inputs(paths), *CLI_RUN,
         "-l", paths["laplacian"], "--multihost", "--pixel_shards", "2"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("Processed in:") == 4
    _assert_same_file(out, _jax_cli_reference(paths, tmp_path))


@pytest.mark.parametrize("name,flags,words", CLI_REFUSALS, ids=[r[0] for r in CLI_REFUSALS])
def test_cli_refusals_on_a_grid(world2, name, flags, words):
    for rank in range(2):
        rec = _rank_cli(world2, f"refuse-{name}", rank)
        assert rec["rc"] == 1
        assert words in rec["err"]
        assert "Processed in:" not in rec["out"]


@pytest.mark.parametrize("flags,words", [
    (["--geometry", "g.json"], "Argument geometry is single-process"),
    (["--no_guess", "--batch_frames", "2", "--solve_ckpt_stride", "1"],
     "multihost runs use the classic grouped loop and cannot checkpoint mid-frame"),
    (["--pixel_shards", "0"], "Argument pixel_shards must be >= 1"),
    (["--voxel_shards", "0"], "Argument voxel_shards must be >= 1"),
], ids=["geometry", "solve_ckpt_stride", "pixel_shards", "voxel_shards"])
def test_cli_flag_refusals(world, flags, words, capsys):
    paths, d = world
    with pytest.raises(SystemExit) as err:
        torch_main(["-o", str(d / "x.h5"), *_world_inputs(paths), "--use_cpu", "--multihost",
                    *flags])
    assert err.value.code == 1
    assert words in capsys.readouterr().err


def test_world_without_multihost_refused(world, monkeypatch, capsys):
    paths, d = world
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert torch_main(["-o", str(d / "y.h5"), *_world_inputs(paths), "--use_cpu"]) == 1
    assert "needs --multihost" in capsys.readouterr().err


def test_multihost_without_launcher_refused(world, monkeypatch, capsys):
    paths, d = world
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert torch_main(["-o", str(d / "z.h5"), *_world_inputs(paths), "--use_cpu",
                       "--multihost"]) == 1
    assert "launch with torchrun" in capsys.readouterr().err
