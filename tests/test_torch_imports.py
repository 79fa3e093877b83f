"""The port stands alone: importing every module of sartsolver_tpu_torch, and
chip_smoke.py and sweep_measure.py, loads neither JAX nor any module of the
JAX package, and its observability layer loads neither torch nor numpy.
Also a
small-size run of chip_smoke.py's world, solve checks, frames phase and
variants phase on the CPU."""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import sartsolver_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import sweep_measure
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "sartsolver_tpu" or m.startswith("sartsolver_tpu."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 15, out.stdout
    assert bad == "[]", bad


# the I/O pipeline's modules (the chunked ingest, retries, faults, the
# prefetcher, the async writer), each imported alone
_PIPELINE_MODULES = (
    "sartsolver_tpu_torch.parallel.multihost", "sartsolver_tpu_torch.resilience.retry",
    "sartsolver_tpu_torch.resilience.faults", "sartsolver_tpu_torch.utils.prefetch",
    "sartsolver_tpu_torch.utils.asyncwriter", "sartsolver_tpu_torch.io.raytransfer",
)


def test_io_pipeline_modules_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = ("import importlib, sys\n"
             "for name in sys.argv[1:]:\n"
             "    importlib.import_module(name)\n"
             "from sartsolver_tpu_torch.resilience import failures\n"
             "assert len(failures.RECOVERABLE_FRAME_ERRORS) == 5\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'sartsolver_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe, *_PIPELINE_MODULES], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


# the operator backends (the factored RTM, the matrix-free geometry
# operator and its projector's wrapper), each imported alone: no JAX, no
# JAX package, and no build of the kernel at import
_OPERATOR_MODULES = (
    "sartsolver_tpu_torch.operators", "sartsolver_tpu_torch.operators.geometry",
    "sartsolver_tpu_torch.operators.implicit", "sartsolver_tpu_torch.operators.lowrank",
    "sartsolver_tpu_torch.models.convert",
)


@pytest.mark.parametrize("name", _OPERATOR_MODULES)
def test_operator_modules_import_no_jax(name):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = ("import importlib, sys\n"
             "importlib.import_module(sys.argv[1])\n"
             "from sartsolver_tpu_torch.ops import _build\n"
             "assert not _build._loaded\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'sartsolver_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe, name], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


# the resilience of a run (the graceful stop, the hang watchdog, the
# integrity layer, the flight recorder), each imported alone in a fresh
# process: none loads JAX or the JAX package, and the stop, the watchdog and
# the flight recorder load neither torch nor numpy (a status poke and a
# crash bundle need neither)
_RESILIENCE_MODULES = (
    "sartsolver_tpu_torch.resilience.shutdown", "sartsolver_tpu_torch.resilience.watchdog",
    "sartsolver_tpu_torch.obs.flight", "sartsolver_tpu_torch.resilience.integrity",
)


@pytest.mark.parametrize("name", _RESILIENCE_MODULES)
def test_resilience_modules_import_no_jax(name):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = ("import importlib, sys\n"
             "importlib.import_module(sys.argv[1])\n"
             "print(sorted({m.split('.')[0] for m in sys.modules} & "
             "{'jax', 'jaxlib', 'sartsolver_tpu', 'torch', 'numpy'}))")
    out = subprocess.run([sys.executable, "-c", probe, name], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    loaded = eval(out.stdout.strip())
    assert not set(loaded) & {"jax", "jaxlib", "sartsolver_tpu"}, loaded
    if not name.endswith("integrity"):  # the integrity layer's sums are numpy
        assert loaded == [], loaded


_OBS_PROBE = """
import importlib, pkgutil, sys
import sartsolver_tpu_torch.obs as obs
names = [m.name for m in pkgutil.walk_packages(obs.__path__, obs.__name__ + ".")]
for name in names + ["sartsolver_tpu_torch.utils.timing",
                     "sartsolver_tpu_torch.utils.atomicio",
                     "sartsolver_tpu_torch.resilience.failures"]:
    importlib.import_module(name)
heavy = sorted(m for m in sys.modules
               if m.split(".")[0] in ("torch", "numpy", "jax", "jaxlib", "sartsolver_tpu"))
print(len(names), heavy)
"""


def test_obs_imports_only_the_standard_library():
    """sartsolver_tpu_torch.obs, the phase timer and the run summary load
    without torch or numpy (a benchmark harness loads them without starting
    CUDA), and without JAX."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _OBS_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    count, heavy = out.stdout.strip().split(" ", 1)
    assert int(count) == 8, out.stdout  # obs/flight.py among them
    assert heavy == "[]", heavy


def test_chip_smoke_world_and_checks_at_small_size(tmp_path):
    """The e2e world writer and the solve checks of chip_smoke.py, on the
    CPU at a small size: the port's CLI reads the world, solves linear with
    the Laplacian and logarithmic for each RTM storage type, and passes the
    script's own checks."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    world = cs.write_world(str(tmp_path), nx=16, ny=16, cam=(8, 4), n_frames=12)
    p = world["paths"]
    assert world["H"].shape == (64, 256) and world["G"].shape == (64, 12)
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    for storage, (name, flags, n_frames) in itertools.product(cs.STORAGES, (
        ("linear", ["-l", p["laplacian"], "-t", "0:0.75", "--chain_frames", "1"], 8),
        ("log", ["-L", "-t", "0:0.35", "--chain_frames", "1"], 4),
    )):
        out = str(tmp_path / f"{storage}_{name}.h5")
        rc, ms, _ = cs.run_cli(["-o", out, *inputs, "-m", "300", *flags,
                                "--rtm_dtype", storage], device="cpu")
        assert rc == 0 and len(ms) == n_frames
        sol, err = cs.check_solution(out, world, n_frames, 300, "cpu")
        assert np.all(err <= cs.FIT_BOUND)
    # the frames phase's runs and checks: scheduler = classic loop and chain
    # = serial byte for byte, statuses and fitted errors (launch counts are
    # the card's)
    frames = cs.frames_phase(world, str(tmp_path), device="cpu")
    assert set(frames) == set(cs.STORAGES)
    for storage, entry in frames.items():
        assert entry["scheduled"]["loop_steps"] > 0
        assert 0 < entry["scheduled"]["occupancy"] <= 1
        assert entry["classic"]["loop_iterations"] > 0
        for kind in ("scheduled", "classic"):
            assert len(entry[kind]["cli_ms_per_frame_in_turns"]) == 1
    assert set(frames["int8"]) >= {"four_lanes", "chain"}
    assert set(frames["float32"]) >= {"chain", "sixteen_lanes", "thirty_two_lanes"}
    for name in ("sixteen_lanes", "thirty_two_lanes"):
        assert frames["float32"][name]["classic"]["loop_iterations"] > 0
    # the variants phase: the scheduled log update's loops agree, the armed
    # guard equals the unguarded run, a NaN frame is DIVERGED and exits 2
    variants = cs.variants_phase(world, str(tmp_path), device="cpu")
    for storage, entry in variants.items():
        assert entry["guard_nan_frame"]["status"][3] == -2
        assert entry["decay_serial"]["guess_ms_per_iteration"] > 0
        assert entry["guard_linear"]["byte_equal_to_unguarded"]
        assert entry["decay_scheduled"]["loop_steps"] > 0
    assert "decay_four_lanes" in variants["int8"] and "refused" in variants["int8"]["guard_log"]


def test_chip_smoke_os_and_debug_nans_phases_at_small_size(tmp_path):
    """chip_smoke.py's os and debug_nans phases on the CPU at a small size:
    each storage's OS runs solve within the script's bound, scheduler and
    classic loop agree byte for byte, the poisoned world exits 0 from the
    chain and raises from the scheduler, and the flag changes no byte."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    world = cs.write_world(str(tmp_path), nx=16, ny=16, cam=(8, 4), n_frames=12)
    rec = cs.os_phase(world, str(tmp_path), device="cpu")
    assert rec["os_subsets"] == cs.OS_SUBSETS
    for storage in cs.STORAGES:
        for mode, _ in cs.OS_MODES:
            entry = rec[storage][mode]
            assert len(entry["chain"]["frame_ms"]) == 4
            assert entry["chain"]["fit_err_max"] <= cs.FIT_BOUND
            assert entry["scheduled"]["loop_steps"] > 0
            assert entry["classic"]["loop_iterations"] > 0
    dn = cs.debug_nans_phase(world, str(tmp_path), device="cpu")
    assert dn["nan_pixel_chain"] == "exit 0"
    assert dn["nan_pixel_scheduler"].startswith("FloatingPointError: NaN in the lanes'")
    assert dn["scheduler"]["byte_equal"] and dn["os_chain"]["byte_equal"]


def test_chip_smoke_tall_world_at_small_size(tmp_path):
    """chip_smoke.py's tall-world phase on the CPU at a small size: the
    world written with taller cameras, one CLI run per storage type over its
    frames, statuses and fitted errors within the script's bound."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    tall = cs.tall_world_phase(str(tmp_path), device="cpu", nx=16, ny=16, cam=(8, 8))
    assert tall["shape"] == [128, 256] and tall["frames"] == cs.TALL_FRAMES
    for storage in cs.STORAGES:
        rec = tall[storage]
        assert len(rec["frame_ms"]) == cs.TALL_FRAMES
        assert max(rec["fit_err"]) <= cs.FIT_BOUND
        assert all(st == 0 or it == cs.MAX_ITERATIONS
                   for st, it in zip(rec["status"], rec["iterations"]))


def test_chip_smoke_obs_phase_at_small_size(tmp_path):
    """chip_smoke.py's obs phase on the CPU at a small size: each storage's
    chain and scheduler runs with every sink on write the same bytes as
    without, their artifacts pass the checks, the phase split covers the
    run, and the profiled scheduler has one step per stride (the kernel
    counts and the roofline are the card's)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    world = cs.write_world(str(tmp_path), nx=16, ny=16, cam=(8, 4), n_frames=12)
    rec = cs.obs_phase(world, str(tmp_path), device="cpu")
    for storage in cs.STORAGES:
        for loop, _, _ in cs.OBS_LOOPS:
            entry = rec[storage][loop]
            split = entry["phase_split_ms"]
            assert entry["byte_equal"] and set(split) == {key for key, _ in cs.OBS_PHASES} | {
                "ingest_rtm_span_ms", "first_device_put_span_ms"}
            assert split["first_device_put_span_ms"] <= split["ingest_rtm_span_ms"] <= \
                split["ingest_upload_ms"]
            assert 0 < entry["split_sum_ms"] <= entry["sinks_on"]["wall_ms"]
        assert rec[storage]["scheduler"]["strides"] > 0
    assert rec["profile"]["steps"] == rec["profile"]["strides"] > 0
    assert "roofline" not in rec


def test_chip_smoke_ingest_phase_at_small_size(tmp_path):
    """chip_smoke.py's ingest phase on the CPU at a small size: every
    storage's stored matrix equals the host recipe on the files as written
    and on their row-chunked copy, the CLI writes the same bytes at the
    defaults and with one chunk, prefetch off and a writer queue of one, and
    the fault drill recovers or writes its one FAILED row (the peaks and the
    host memory are the card's)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    world = cs.write_world(str(tmp_path), nx=16, ny=16, cam=(8, 4), n_frames=12)
    rec = cs.ingest_phase(world, str(tmp_path), device="cpu")
    assert rec["shape"] == [64, 256]
    for storage in cs.STORAGES:
        for layout in ("contiguous", "chunked"):
            entry = rec[storage][layout]
            assert entry["bit_equal_to_host_recipe"]
            want = {"colmax", "quantize"} if storage == "int8" else {"store"}
            assert set(entry["passes"]) == want
        for loop, _, _ in cs.OBS_LOOPS:
            run = rec[storage][f"cli_{loop}"]
            assert run["byte_equal"] and set(run) == {"frames", "byte_equal", "default",
                                                      "one_chunk"}
            split = run["default"]["phase_split_ms"]
            assert split["ingest.rtm_first_ms"] <= split["ingest_upload_ms"]
    drill = rec["fault_drill"]
    assert drill["rtm_ingest"]["recovered"] and drill["solve_dispatch"]["failed_rows"] == 1
    assert drill["solve_dispatch"]["status"][0] == -3


def test_chip_smoke_resilience_phase_at_small_size(tmp_path):
    """chip_smoke.py's resilience phase on the CPU at a small size: the
    resumes of every storage and loop against the uninterrupted runs, the
    --integrity runs' bytes, the SIGKILL and SIGTERM drills (subprocesses),
    the watchdog's FAILED row and crash bundle, the quarantine under both
    packages' corruption recipes, the ingest's sums in both places, the
    loop's overhead in turns and the flush timing."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    world = cs.write_world(str(tmp_path), nx=16, ny=16, cam=(8, 4), n_frames=12)
    rec = cs.resilience_phase(world, str(tmp_path), device="cpu",
                              flush_kw=dict(rows=10, flush_at=(10, 40, 160),
                                            voxel_map_at=(8, 32, 160)), turns=1)
    for storage in cs.STORAGES:
        assert rec[storage]["chain"]["processed_in_resume"] == 4
        assert rec[storage]["scheduler"]["processed_in_resume"] == 6
        for loop in ("chain", "scheduler"):
            assert rec[storage][loop]["integrity"]["byte_equal"]
    assert rec["sigterm"]["exit"] == 4 and rec["sigterm"]["rows_at_stop"] < 8
    assert rec["watchdog"]["isolated"]["status"][0] == -3
    assert rec["corrupt"]["solver_api"]["status"] == -4
    jax_recipe = rec["corrupt_jax_recipe"]
    assert jax_recipe["cli_exit"] == 3 and jax_recipe["solver_api"]["reaudit"]
    assert jax_recipe["smallest_change_seen_any_element"] > 0
    assert set(rec["ingest"]["read_and_shard_rtm_seconds"]) == {
        "off", "sums_device", "sums_host", "double_read_sums_device"}
    turns = rec["integrity_ms_per_frame_in_turns"]
    assert all(len(turns[loop]["ms_per_frame"][k]) == 1 for loop in ("scheduler", "chain")
               for k in ("off", "on"))
    assert set(rec["flush"]["flush_ms_at_rows"]) == {"0", "10", "40", "160"}
    ckpt = rec["solve_ckpt"]
    assert ckpt["resumed_from_serial"] == 1 and ckpt["resumed_bytes_equal"]
    assert set(ckpt["wall_ms_per_frame"]) == {"off", "1", "4", "16"}
    assert ckpt["bytes_per_record"]["1"] > 0


def test_chip_smoke_sparse_phase_at_small_size(tmp_path):
    """chip_smoke.py's sparse phase on the CPU at a small size: the dark
    world holds half its tile columns, each storage's sparse and dense
    ingests, the linear and log runs at 'auto' beside 'off' (equal
    statuses, fitted distance within the bar), the scheduler and OS runs,
    and the threshold's run holding the same columns."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    world = cs.write_world(str(tmp_path), nx=32, ny=16, cam=(8, 4), n_frames=12)
    rec = cs.sparse_phase(world, str(tmp_path), device="cpu", dark_rows=8)
    assert rec["voxels_held"] == 256 and rec["dark_voxels"] == 256
    for storage in cs.STORAGES:
        ingest = rec["ingest"][storage]
        assert ingest["sparse"]["held_shape"] == [64, 256]
        assert ingest["dense"]["held_shape"] == [64, 512]
        for kind in ("linear", "log"):
            run = rec["runs"][storage][kind]
            assert run["sparse"]["voxels_held"] == 256 and run["dense"]["voxels_held"] == 512
            assert run["fitted_distance_max"] <= cs.SPARSE_FIT_TOL
    assert rec["runs"]["float32_batch"]["sparse"]["loop_steps"] > 0
    assert rec["runs"]["float32_eps"]["occupancy"] < 0.5
    assert not os.path.exists(os.path.join(str(tmp_path), "sparse_world", "rtm_b.h5"))



# the block-sparse index and the in-solve checkpoints, each imported alone:
# neither loads JAX, and the index is host-only numpy (no torch either)
_SPARSE_CKPT_MODULES = ("sartsolver_tpu_torch.ops.sparse",
                        "sartsolver_tpu_torch.resilience.podckpt")


@pytest.mark.parametrize("name", _SPARSE_CKPT_MODULES)
def test_sparse_and_checkpoint_modules_import_no_jax(name):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = ("import importlib, sys\n"
             "importlib.import_module(sys.argv[1])\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'sartsolver_tpu', 'torch')))")
    out = subprocess.run([sys.executable, "-c", probe, name], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_operators_phase_at_small_size(tmp_path):
    """chip_smoke.py's operators phase on the CPU at a small size: on the
    reflective world 'auto' takes rank 4 in every storage and run, the
    factored runs' statuses equal the dense runs' and their fitted distance
    is within the phase's bound, rank 2 exits 1, the fp32 factored solver
    holds half the dense matrix; on the geometry world the implicit runs
    against the dense twin, int8 refused (the launch counts and the kernel
    table are the card's)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    rec = cs.operators_phase(
        str(tmp_path), device="cpu",
        reflective_kw=dict(nx=16, ny=32, cam=(8, 8), n_frames=8),
        geometry_kw=dict(nx=8, ny=8, nz=4, cam=(8, 8), n_frames=8))
    r = rec["reflective"]
    assert r["factorization"]["rank"] == cs.LOWRANK_RANK
    assert r["resident"]["float32"]["matrix_fraction_of_dense"] == 0.5
    assert r["rank2_exit"] == 1
    for st in cs.STORAGES:
        for name in ("linear", "log"):
            run = r[f"{st}_{name}"]
            assert max(run["fitted_distance"]) <= cs.OPERATOR_FIT_TOL
            assert f"rank={cs.LOWRANK_RANK} " in run["factored"]["operator_line"]
    g = rec["geometry"]
    assert g["int8_exit"] == 1
    for name in ("linear", "log", "batch", "os"):
        assert g[name]["implicit"]["status"] == g[name]["dense"]["status"]
        assert g[name]["implicit"]["operator_line"].startswith("implicit: ray table resident")
    assert "kernels" not in rec


def test_grid_modules_import_no_jax():
    """The grid's modules (the partition, the collectives, the parity
    protocol), each imported alone, load no JAX and no JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = ("import importlib, sys\n"
             "for name in sys.argv[1:]:\n"
             "    importlib.import_module(name)\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'sartsolver_tpu')))")
    names = ("sartsolver_tpu_torch.parallel.mesh", "sartsolver_tpu_torch.parallel.comm",
             "sartsolver_tpu_torch.utils.fused_parity")
    out = subprocess.run([sys.executable, "-c", probe, *names], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_grid_command_line_holds_several_runs():
    """chip_smoke.py's ``--grid-rank`` command line: the runs of one world
    size, each ``--grid-rank OUT [options] -- ARGS``, split in order (one
    torchrun runs them one after another)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    argv = ["--grid-rank", "a", "--parity", "--", "-o", "a.h5", "--pixel_shards", "2",
            "--grid-rank", "b", "--", "-o", "b.h5", "--voxel_shards", "2",
            "--grid-rank", "c", "--", "-o", "c.h5"]
    assert cs.grid_runs_of(argv) == [
        ("a", ["--parity"], ["-o", "a.h5", "--pixel_shards", "2"]),
        ("b", [], ["-o", "b.h5", "--voxel_shards", "2"]),
        ("c", [], ["-o", "c.h5"])]
    assert cs.grid_runs_of(argv[:8]) == [("a", ["--parity"], ["-o", "a.h5", "--pixel_shards",
                                                              "2"])]


# the serving engine's modules, each imported alone: none loads JAX or the
# JAX package; the host-only ones (the request record, routing, admission,
# the journal, the soft state, the protocol, the endpoints) load no torch;
# and the one-shot CLI loads no engine module
_ENGINE_HOST_MODULES = ("request", "routing", "admission", "journal", "state", "protocol",
                        "httpd")
_ENGINE_MODULES = _ENGINE_HOST_MODULES + ("session", "server", "cli")


@pytest.mark.parametrize("name", _ENGINE_MODULES)
def test_engine_modules_import_no_jax(name):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = ("import importlib, sys\n"
             "importlib.import_module('sartsolver_tpu_torch.engine.' + sys.argv[1])\n"
             "print(sorted({m.split('.')[0] for m in sys.modules} & "
             "{'jax', 'jaxlib', 'sartsolver_tpu', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", probe, name], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    loaded = eval(out.stdout.strip())
    assert not set(loaded) & {"jax", "jaxlib", "sartsolver_tpu"}, loaded
    if name in _ENGINE_HOST_MODULES:
        assert loaded == [], loaded


def test_one_shot_cli_loads_no_engine_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = ("import sys\n"
             "from sartsolver_tpu_torch import cli\n"
             "try:\n"
             "    cli.main(['-o', 'x.h5', 'missing_a.h5', 'missing_b.h5', '--device', 'cpu'])\n"
             "except SystemExit:\n"
             "    pass\n"
             "print(sorted(m for m in sys.modules if m.startswith('sartsolver_tpu_torch.engine')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_chip_smoke_serve_phase_at_small_size(tmp_path):
    """chip_smoke.py's serve phase on the CPU at a small size: two tenants'
    requests through submit, the socket and the ingest dir, the tight
    deadline shed as -5 while its co-batched request completes, the SIGTERM
    drill's exit 4 and its replay, the geometry request on its own server,
    the bf16 and int8 servers' requests, every served row equal to the
    CLI's over the same frames and storage (the launch
    counts and the kernel table are the card's)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    world = cs.write_world(str(tmp_path), nx=16, ny=16, cam=(8, 4), n_frames=32)
    gw = cs.write_geometry_world(str(tmp_path / "geometry"), nx=4, ny=4, nz=4, cam=(4, 4),
                                 n_frames=8, device="cpu")
    # to the cap, so the tight deadline lands mid-solve on this small world
    rec = cs.serve_phase(world, str(tmp_path), gw, device="cpu", deadline_s=0.3,
                         extra=["-c", "1e-300"])
    req = rec["requests"]
    assert {r["status"] for k, r in req.items() if k != "diag-a-late"} == {"completed"}
    late = req["diag-a-late"]
    assert late["status"] == "shed-deadline" and late["by_status"]["deadline"] > 0
    assert rec["sigterm"]["exit"] == 4 and rec["sigterm"]["response"] == "interrupted"
    assert rec["replay"]["exit"] == 0 and rec["replay"]["outcome"]["frames"] == 8
    assert rec["main"]["exit"] == 4 and rec["main"]["readyz"] == {"status": "ready"}
    assert rec["main"]["scrape_has_engine"]
    assert rec["geometry"]["status"] == "completed" and rec["geometry"]["frames"] == 4
    assert rec["deadline_shed_total"] == late["by_status"]["deadline"]
    assert rec["latency_s"]["count"] == 4 and rec["queue_wait_s"]["p95"] is not None
    assert {k: (r["status"], r["frames"]) for k, r in rec["stored"].items()} == {
        "bfloat16": ("completed", 4), "int8": ("completed", 4)}
    assert rec["first_request"]["ms_per_frame"] > 0
    assert set(rec["later_requests"]["latency_s"]) == {"diag-b-1", "diag-a-late", "diag-b-2"}
    assert "kernels" not in rec


# the self-healing serve's modules, each imported alone in a fresh process:
# neither loads JAX, the JAX package or torch (the supervisor holds no CUDA
# context on the card its worker runs on)
@pytest.mark.parametrize("name", ["sartsolver_tpu_torch.resilience.supervisor",
                                  "sartsolver_tpu_torch.resilience.chaos"])
def test_selfheal_modules_import_neither_jax_nor_torch(name):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = ("import importlib, sys\n"
             "importlib.import_module(sys.argv[1])\n"
             "print(sorted({m.split('.')[0] for m in sys.modules} & "
             "{'jax', 'jaxlib', 'sartsolver_tpu', 'torch', 'h5py'}))")
    out = subprocess.run([sys.executable, "-c", probe, name], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_selfheal_phase_at_small_size(tmp_path):
    """chip_smoke.py's selfheal phase on the CPU at a small size: the
    supervised worker (its command line read from the running process:
    ``-m sartsolver_tpu_torch.cli serve``, the port's start split line)
    SIGKILLed in its request's dispatched window, restarted, the journal
    replayed, the rows equal to the CLI's, the restart counted, exit 4 on
    SIGTERM; the serve and fleet campaigns judged ok beside it."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    world = cs.write_world(str(tmp_path), nx=16, ny=16, cam=(8, 4), n_frames=8)
    rec = cs.selfheal_phase(world, str(tmp_path), device="cpu")
    sup = rec["supervised"]
    assert sup["worker_command"] == ["-m", "sartsolver_tpu_torch.cli", "serve"]
    assert not sup["worker_supervised"]
    assert sup["start_split_line"].startswith("engine: start split main_unix=")
    assert sup["exit"] == 4 and sup["completed_markers"] == 1 and sup["restarts_sigkill"] == 1
    assert sup["outcome"]["status"] == "completed" and sup["outcome"]["frames"] == 4
    parts = sup["kill_to_ready_parts"]
    assert set(parts) == {"detect_and_backoff_s", "process_start_and_imports_s", "cuda_init_s",
                          "kernel_load_s", "ingest_s", "warm_up_s", "rest_s"}
    assert 0 < parts["detect_and_backoff_s"] < sup["kill_to_ready_s"]
    assert sup["launches_by_incarnation"] == [{}, {}]  # the plain version on the CPU
    for name, seed in (("chaos", cs.SELFHEAL_CHAOS_SEED), ("fleet", cs.SELFHEAL_FLEET_SEED)):
        (verdict,) = rec[name]["passes"]
        assert verdict["seed"] == seed and verdict["verdict"] == "ok"
        assert verdict["kills_fired"] >= 1
    assert rec["fleet"]["fleet"] == cs.SELFHEAL_FLEET
    assert not os.path.exists(tmp_path / "selfheal")


# the static analysis (the lint, the launch audit's registry and auditor, the
# crash-point model checker, the command line), the lock-order detector and
# the durable writes, imported one after another in one fresh process, the
# loaded set read after each: none loads JAX, the JAX package or torch (the
# auditor imports torch only when it counts), and none before the checker
# (the engine's modules) and the auditor loads numpy
_ANALYSIS_MODULES = ("sartsolver_tpu_torch.utils.locking", "sartsolver_tpu_torch.utils.atomicio") \
    + tuple(f"sartsolver_tpu_torch.analysis.{m}" for m in (
        "registry", "rules", "concurrency", "durability", "cli")) \
    + ("sartsolver_tpu_torch.analysis", "sartsolver_tpu_torch.analysis.protocol",
       "sartsolver_tpu_torch.analysis.audit")


@pytest.fixture(scope="module")
def analysis_imports():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = ("import importlib, json, sys\n"
             "out = {}\n"
             "for name in sys.argv[1:]:\n"
             "    importlib.import_module(name)\n"
             "    out[name] = sorted({m.split('.')[0] for m in sys.modules} & "
             "{'jax', 'jaxlib', 'sartsolver_tpu', 'torch', 'numpy'})\n"
             "print(json.dumps(out))")
    out = subprocess.run([sys.executable, "-c", probe, *_ANALYSIS_MODULES], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120, check=True)
    import json

    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", _ANALYSIS_MODULES)
def test_analysis_modules_import_no_jax(name, analysis_imports):
    loaded = analysis_imports[name]
    assert not set(loaded) & {"jax", "jaxlib", "sartsolver_tpu", "torch"}, loaded
    if not name.endswith((".audit", ".protocol")):
        assert loaded == [], loaded
