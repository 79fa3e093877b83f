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
    assert int(count) == 7, out.stdout
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
            assert len(entry[kind]["cli_ms_per_frame_in_turns"]) == 2
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
