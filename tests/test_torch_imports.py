"""The port stands alone: importing every module of sartsolver_tpu_torch, and
chip_smoke.py and sweep_measure.py, loads neither JAX nor any module of the
JAX package. Also a
small-size run of chip_smoke.py's world and solve checks on the CPU."""

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
        ("linear", ["-l", p["laplacian"], "-t", "0:0.75"], 8),
        ("log", ["-L", "-t", "0:0.35"], 4),
    )):
        out = str(tmp_path / f"{storage}_{name}.h5")
        rc, ms = cs.run_cli(["-o", out, *inputs, "-m", "300", *flags,
                             "--rtm_dtype", storage], device="cpu")
        assert rc == 0 and len(ms) == n_frames
        sol, err = cs.check_solution(out, world, n_frames, 300, "cpu")
        assert np.all(err <= cs.FIT_BOUND)
