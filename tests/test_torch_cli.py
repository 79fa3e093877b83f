"""The PyTorch ``sartsolve`` (sartsolver_tpu_torch.cli) against the JAX CLI.

Both run on the CPU over the fixture world (``fixtures.write_world``): the
JAX CLI on one device (``--pixel_shards 1``), the port with ``--device cpu``
(the fp32 profile through the fused sweep's plain version) or ``--use_cpu``
(the fp64 parity profile). Frame times and the voxel map must be identical;
the fp64 profile also agrees in statuses, iterations and values (rtol 1e-8),
the fp32 profile in fitted space.
"""

import h5py
import numpy as np
import pytest

import fixtures as fx
from sartsolver_tpu.cli import main as jax_main

from sartsolver_tpu_torch.cli import main as torch_main
from sartsolver_tpu_torch.io.solution import row_checksum

FP64 = ["--use_cpu", "-m", "300", "-c", "1e-6"]
FP32 = ["-m", "40", "-c", "1e-12"]  # a short budget; -c 1e-12 stops only at a stall


@pytest.fixture
def world(tmp_path):
    return fx.write_world(tmp_path, with_laplacian=True)


def _inputs(paths):
    return [paths[k] for k in ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b")]


def _read(path):
    with h5py.File(path, "r") as f:
        return ({k: f["solution"][k][:] for k in f["solution"]},
                {k: f["voxel_map"][k][:] for k in f["voxel_map"]},
                dict(f["voxel_map"].attrs))


@pytest.mark.parametrize("case", [
    "fp64-laplacian", "fp32", "fp64-log", "fp32-log", "fp32-no_guess", "fp64-window",
])
def test_cli_matches_jax_cli(world, tmp_path, case, capsys):
    paths, H, f_true, times, scales = world
    profile, _, variant = case.partition("-")
    extra = {
        "laplacian": ["-l", paths["laplacian"], "-b", "0.001"],
        "log": ["-L"], "no_guess": ["--no_guess"], "window": ["-t", "0.15:0.35"],
    }.get(variant, [])
    flags = (FP64 if profile == "fp64" else FP32) + extra
    jax_out, port_out = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jax_main(["-o", jax_out, *_inputs(paths), *flags, "--pixel_shards", "1"]) == 0
    port_flags = flags if profile == "fp64" else flags + ["--device", "cpu"]
    assert torch_main(["-o", port_out, *_inputs(paths), *port_flags]) == 0
    jsol, jmap, jattrs = _read(jax_out)
    tsol, tmap, tattrs = _read(port_out)
    n = len(jsol["time"])
    assert capsys.readouterr().out.count("Processed in:") == 2 * n
    assert n == (2 if variant == "window" else len(times))

    assert set(tsol) == set(jsol)
    for key in ("time", f"time_{fx.CAM_A}", f"time_{fx.CAM_B}"):
        np.testing.assert_array_equal(tsol[key], jsol[key], err_msg=key)
    for key in jmap:
        np.testing.assert_array_equal(tmap[key], jmap[key], err_msg=key)
    assert tattrs == jattrs
    assert tsol["checksum"].tolist() == [int(row_checksum(r)) for r in tsol["value"]]
    if profile == "fp64":
        for key in ("status", "iterations"):
            np.testing.assert_array_equal(tsol[key], jsol[key], err_msg=key)
        np.testing.assert_allclose(tsol["value"], jsol["value"], rtol=1e-8)
        return
    # fp32: the frameworks sum each product in another order, and the Eq. 5
    # stall test |dC| < tol fires where dC first rounds to exactly 0, so a
    # frame may stop a few iterations apart (measured: up to 4 on this
    # world) and a capped frame may converge on the other side. Compared
    # in fitted space, as the JAX package compares its own fp32 runs.
    assert np.abs(tsol["iterations"] - jsol["iterations"]).max() <= 5
    for i in range(n):
        ref = H @ jsol["value"][i]
        err = np.linalg.norm(H @ tsol["value"][i] - ref) / np.linalg.norm(ref)
        assert err <= 5e-3, (i, err)


def test_cli_reconstructs_the_world(world, tmp_path, capsys):
    """The port's fp32 profile reproduces the measurements in fitted space
    (the JAX suite's own quality check, tests/test_cli.py)."""
    paths, H, f_true, times, scales = world
    out = str(tmp_path / "port.h5")
    assert torch_main(["-o", out, *_inputs(paths), "--device", "cpu",
                       "-m", "300", "-c", "1e-6"]) == 0
    out_text = capsys.readouterr().out
    assert "sweep=fused" in out_text
    with h5py.File(out, "r") as f:
        value = f["solution/value"][:]
        assert (f["solution/status"][:] == 0).all()
    for i, s in enumerate(scales):
        np.testing.assert_allclose(H @ value[i], H @ (f_true * s), rtol=0.05)


@pytest.mark.parametrize("argv,message", [
    (["-R", "1.5"], "relaxation must be within (0, 1]"),
    (["-m", "0"], "max_iterations must be >= 1"),
    (["--bogus"], "unrecognized arguments"),
])
def test_cli_flag_errors_exit_1(world, argv, message, capsys):
    paths, *_ = world
    with pytest.raises(SystemExit) as err:
        torch_main([*_inputs(paths), "--device", "cpu", *argv])
    assert err.value.code == 1
    assert message in capsys.readouterr().err


def test_cli_input_errors_exit_1(world, tmp_path, capsys):
    paths, *_ = world
    with pytest.raises(SystemExit) as err:
        torch_main([paths["rtm_b"], "--device", "cpu"])
    assert err.value.code == 1
    assert "At least two input file" in capsys.readouterr().err

    missing = str(tmp_path / "nope.h5")
    assert torch_main(["-o", str(tmp_path / "o.h5"), *_inputs(paths), missing,
                       "--device", "cpu"]) == 1
    assert capsys.readouterr().err.strip()

    assert torch_main(["-o", str(tmp_path / "o.h5"), *_inputs(paths),
                       "--device", "cpu", "-t", "0.3:0.1"]) == 1
    assert "upper limit" in capsys.readouterr().err


def test_cli_refuses_cuda_without_a_card(world, tmp_path, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths, *_ = world
    assert torch_main(["-o", str(tmp_path / "o.h5"), *_inputs(paths)]) == 1
    assert "--device cpu" in capsys.readouterr().err
