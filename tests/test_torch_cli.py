"""The PyTorch ``sartsolve`` (sartsolver_tpu_torch.cli) against the JAX CLI.

Both run on the CPU over the fixture world (``fixtures.write_world``): the
JAX CLI on one device (``--pixel_shards 1``), the port with ``--device cpu``
(the fp32 profile through the fused sweep's plain version) or ``--use_cpu``
(the fp64 parity profile). Frame times and the voxel map must be identical;
the fp64 profile also agrees in statuses, iterations and values (rtol 1e-8),
the fp32 profile in fitted space.
"""

import os
import re
import subprocess
import sys

import h5py
import numpy as np
import pytest

import fixtures as fx
from sartsolver_tpu.cli import main as jax_main

from sartsolver_tpu_torch.cli import main as torch_main
from sartsolver_tpu_torch.io.solution import row_checksum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


@pytest.mark.parametrize("variant", ["laplacian", "log"])
@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_cli_reduced_storage_matches_jax_cli(world, tmp_path, storage, variant, capsys):
    """--rtm_dtype bfloat16|int8: the port reads, rounds or quantizes on the
    host and uploads the stored matrix; the JAX CLI stages and quantizes its
    own way (int8 needs its --fused_sweep interpret off the TPU). Equal frame
    times, and every frame within 5e-3 in fitted space.

    Iterations: the guess frame to the fp32 bar. The warm-started frames
    stop where dC first rounds to exactly 0, which moves with the summation
    order in every storage type (measured on this world: fp32 with -l stops
    frames 2-3 at 11 and 26 where JAX runs to 40; bf16 at 40 and 27 against
    2 and 40; fitted space within 0.0037 throughout), so for them a status
    must only agree with its own iteration count."""
    paths, H, f_true, times, scales = world
    extra = ["-l", paths["laplacian"], "-b", "0.001"] if variant == "laplacian" else ["-L"]
    flags = FP32 + extra + ["--rtm_dtype", storage]
    jax_flags = flags + (["--fused_sweep", "interpret"] if storage == "int8" else [])
    jax_out, port_out = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jax_main(["-o", jax_out, *_inputs(paths), *jax_flags, "--pixel_shards", "1"]) == 0
    capsys.readouterr()
    assert torch_main(["-o", port_out, *_inputs(paths), *flags, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"rtm_dtype={storage} compute=float32 sweep=fused" in out
    assert out.count("Processed in:") == len(times)
    jsol, _, _ = _read(jax_out)
    tsol, _, _ = _read(port_out)
    for key in ("time", f"time_{fx.CAM_A}", f"time_{fx.CAM_B}"):
        np.testing.assert_array_equal(tsol[key], jsol[key], err_msg=key)
    np.testing.assert_array_equal(tsol["status"] != 0, tsol["iterations"] == 40)
    assert abs(int(tsol["iterations"][0]) - int(jsol["iterations"][0])) <= 5
    for i in range(len(times)):
        ref = H @ jsol["value"][i]
        err = np.linalg.norm(H @ tsol["value"][i] - ref) / np.linalg.norm(ref)
        assert err <= 5e-3, (i, err)


def test_cli_int8_refuses_the_fp64_profile(world, tmp_path, capsys):
    paths, *_ = world
    with pytest.raises(SystemExit) as err:
        torch_main(["-o", str(tmp_path / "o.h5"), *_inputs(paths), "--use_cpu",
                    "--rtm_dtype", "int8"])
    assert err.value.code == 1
    assert "cannot be combined with --use_cpu" in capsys.readouterr().err


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
    (["--relaxation_decay", "1.5"], "relaxation_decay must be within (0, 1]"),
    (["--relaxation_decay", "0"], "relaxation_decay must be within (0, 1]"),
    (["--momentum", "polyak"], "invalid choice: 'polyak'"),
    (["--divergence_recovery", "-1"], "divergence_recovery must be >= 0"),
    (["--fused_sweep", "interpret"], "Pallas interpreter"),
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


VARIANT_FLAGS = {
    "decay": ["--relaxation_decay", "0.95"],
    "momentum": ["--momentum", "nesterov"],
    "guard": ["--divergence_recovery", "2"],
    "all": ["--relaxation_decay", "0.97", "--momentum", "nesterov",
            "--divergence_recovery", "2"],
}


@pytest.mark.parametrize("loop", ["chain", "scheduled"])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANT_FLAGS))
def test_cli_variants_match_jax_cli(world, tmp_path, variant, logarithmic, loop, capsys):
    """The solver-variant flags through both CLIs (the warm-started chain,
    or ``--no_guess --batch_frames 3`` through the port's scheduler against
    the JAX CLI's), fp32: equal frame times, a status that agrees with its
    own iteration count, and every frame within 5e-3 in fitted space (the
    existing CLI tests' bar: an fp32 stall crossing moves between the
    frameworks, ROADMAP.md queue C)."""
    paths, H, f_true, times, scales = world
    flags = FP32 + VARIANT_FLAGS[variant] + (["-L"] if logarithmic else [])
    if loop == "scheduled":
        flags += ["--no_guess", "--batch_frames", "3"]
    jax_out, port_out = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jax_main(["-o", jax_out, *_inputs(paths), *flags, "--pixel_shards", "1"]) == 0
    capsys.readouterr()
    assert torch_main(["-o", port_out, *_inputs(paths), *flags, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("Processed in:") == len(times)
    jsol, _, _ = _read(jax_out)
    tsol, _, _ = _read(port_out)
    for key in ("time", f"time_{fx.CAM_A}", f"time_{fx.CAM_B}"):
        np.testing.assert_array_equal(tsol[key], jsol[key], err_msg=key)
    np.testing.assert_array_equal(tsol["status"] != 0, tsol["iterations"] == 40)
    for i in range(len(times)):
        ref = H @ jsol["value"][i]
        err = np.linalg.norm(H @ tsol["value"][i] - ref) / np.linalg.norm(ref)
        assert err <= 5e-3, (i, err)


@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("variant", ["decay", "all"])
def test_cli_variants_fp64_match_jax_cli(world, tmp_path, variant, logarithmic):
    """The fp64 parity profile with the variants: statuses, iterations and
    values (1e-8) equal to the JAX CLI's."""
    paths, *_ = world
    flags = FP64 + VARIANT_FLAGS[variant] + (["-L"] if logarithmic else [])
    jax_out, port_out = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jax_main(["-o", jax_out, *_inputs(paths), *flags, "--pixel_shards", "1"]) == 0
    assert torch_main(["-o", port_out, *_inputs(paths), *flags]) == 0
    jsol, _, _ = _read(jax_out)
    tsol, _, _ = _read(port_out)
    for key in ("status", "iterations"):
        np.testing.assert_array_equal(tsol[key], jsol[key], err_msg=key)
    np.testing.assert_allclose(tsol["value"], jsol["value"], rtol=1e-8)


def _poison_frame(paths, frame=1):
    """A NaN in one pixel of camera A's frame ``frame``."""
    with h5py.File(paths["img_a"], "r+") as f:
        f["image/frame"][frame, 0, 0] = np.nan


@pytest.mark.parametrize("flags", [
    ["--chain_frames", "1"], [], ["--no_guess", "--batch_frames", "3"],
    ["--no_guess", "--batch_frames", "3", "--no_continuous_batching"], ["-L"],
])
def test_cli_nan_frame_is_diverged_and_exits_2(world, tmp_path, flags, capsys):
    """--divergence_recovery with a NaN-poisoned frame: that frame is written
    DIVERGED (-2) with a zero row and no iteration, the others solve, and
    the run exits 2, in every frame loop; the JAX CLI agrees on which frame
    diverged and on the exit code (the others' fp32 stall crossings may
    fall on either side of the cap, ROADMAP.md queue C)."""
    paths, H, *_ = world
    _poison_frame(paths)
    argv = [*_inputs(paths), *FP32, "--divergence_recovery", "2", *flags]
    jax_out, port_out = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jax_main(["-o", jax_out, *argv, "--pixel_shards", "1"]) == 2
    capsys.readouterr()
    assert torch_main(["-o", port_out, *argv, "--device", "cpu"]) == 2
    assert "1 frame(s) DIVERGED (status -2)" in capsys.readouterr().err
    jsol, _, _ = _read(jax_out)
    tsol, _, _ = _read(port_out)
    assert tsol["status"].tolist()[1] == -2 and tsol["iterations"][1] == 0
    np.testing.assert_array_equal(tsol["value"][1], 0.0)
    np.testing.assert_array_equal(tsol["status"] == -2, jsol["status"] == -2)
    np.testing.assert_array_equal(tsol["status"] == -1, tsol["iterations"] == 40)
    for i in (0, 2, 3):
        ref = H @ jsol["value"][i]
        err = np.linalg.norm(H @ tsol["value"][i] - ref) / np.linalg.norm(ref)
        assert err <= 5e-3, (i, err)


def test_cli_armed_guard_changes_no_byte(world, tmp_path):
    """A healthy run with --divergence_recovery writes the same file as
    without it (the guard's selects keep every candidate)."""
    paths, *_ = world
    outs = []
    for extra in ([], ["--divergence_recovery", "3"]):
        out = str(tmp_path / f"port{len(extra)}.h5")
        assert torch_main(["-o", out, *_inputs(paths), *FP32, "-l", paths["laplacian"],
                           "--device", "cpu", *extra]) == 0
        outs.append(_read(out)[0])
    for key in outs[0]:
        np.testing.assert_array_equal(outs[0][key], outs[1][key], err_msg=key)


@pytest.mark.parametrize("argv,message", [
    (["--rtm_dtype", "int8"], "rtm_dtype='int8' requires the fused sweep"),
    (["--fused_sweep", "on"], "fused_sweep='on' requested but divergence_recovery"),
])
def test_cli_log_guard_refusals(world, tmp_path, argv, message, capsys):
    """The guard keeps the log solver off the fused sweep, as in the JAX
    package: int8 storage, which needs the fused sweep, and an explicit
    ``--fused_sweep on`` are refused with a message and exit 1."""
    paths, *_ = world
    assert torch_main(["-o", str(tmp_path / "o.h5"), *_inputs(paths), "--device", "cpu",
                       "-L", "--divergence_recovery", "2", *argv]) == 1
    assert message in capsys.readouterr().err


# ---------------------------------------------------------------------------
# ordered subsets (--os_subsets) and --debug_nans
# ---------------------------------------------------------------------------

OS_CASES = {
    # P = 14: the JAX solver pads its rows to 16, which 4 divides
    "os4": ["--os_subsets", "4"],
    "os2-log": ["--os_subsets", "2", "-L"],
    "os4-momentum-scheduled": ["--os_subsets", "4", "--momentum", "nesterov", "--no_guess",
                               "--batch_frames", "3"],
    "os2-int8": ["--os_subsets", "2", "--rtm_dtype", "int8"],
}


@pytest.mark.parametrize("case", sorted(OS_CASES))
def test_cli_os_subsets_match_jax_cli(world, tmp_path, case, capsys):
    """--os_subsets through both CLIs, fp32 (int8 storage needs no fused
    sweep in either with OS): the run's header names the subset cycle,
    equal frame times, a status that agrees with its own iteration count,
    every frame within 5e-3 in fitted space (the fp32 CLI bar)."""
    paths, H, *_ = world
    flags = FP32 + OS_CASES[case]
    jax_out, port_out = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jax_main(["-o", jax_out, *_inputs(paths), *flags, "--pixel_shards", "1"]) == 0
    capsys.readouterr()
    assert torch_main(["-o", port_out, *_inputs(paths), *flags, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    n_os = OS_CASES[case][1]
    assert f"compute=float32 sweep=os-subset rtm=[14, 16] os_subsets={n_os}" in out
    jsol, _, _ = _read(jax_out)
    tsol, _, _ = _read(port_out)
    assert out.count("Processed in:") == len(jsol["time"])
    for key in ("time", f"time_{fx.CAM_A}", f"time_{fx.CAM_B}"):
        np.testing.assert_array_equal(tsol[key], jsol[key], err_msg=key)
    np.testing.assert_array_equal(tsol["status"] != 0, tsol["iterations"] == 40)
    for i in range(len(jsol["time"])):
        ref = H @ jsol["value"][i]
        err = np.linalg.norm(H @ tsol["value"][i] - ref) / np.linalg.norm(ref)
        assert err <= 5e-3, (i, err)


@pytest.mark.parametrize("extra", [
    ["--os_subsets", "4"], ["--os_subsets", "2", "-L"],
    ["--os_subsets", "4", "--momentum", "nesterov", "-L", "--divergence_recovery", "2"],
    ["--os_subsets", "4", "--no_guess", "--batch_frames", "3"],
], ids=["os4", "os2-log", "os4-log-momentum-guard", "os4-scheduled"])
def test_cli_os_subsets_fp64_match_jax_cli(world, tmp_path, extra):
    """The fp64 parity profile with --os_subsets: statuses, iterations and
    values (1e-8) equal to the JAX CLI's, P = 14 padded to 16 included."""
    paths, *_ = world
    flags = FP64 + extra
    jax_out, port_out = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jax_main(["-o", jax_out, *_inputs(paths), *flags, "--pixel_shards", "1"]) == 0
    assert torch_main(["-o", port_out, *_inputs(paths), *flags]) == 0
    jsol, _, _ = _read(jax_out)
    tsol, _, _ = _read(port_out)
    for key in ("status", "iterations"):
        np.testing.assert_array_equal(tsol[key], jsol[key], err_msg=key)
    np.testing.assert_allclose(tsol["value"], jsol["value"], rtol=1e-8)


@pytest.mark.parametrize("argv,message", [
    (["--os_subsets", "0"], "Argument os_subsets must be >= 1, 0 given."),
    (["--os_subsets", "2", "--fused_sweep", "on"],
     "Argument os_subsets > 1 runs the subset-cycle sweep; --fused_sweep on"),
])
def test_cli_os_flag_errors_match_jax_cli(world, tmp_path, argv, message, capsys):
    """Refused by both CLIs with the JAX message and exit 1."""
    paths, *_ = world
    for main in (jax_main, torch_main):
        with pytest.raises(SystemExit) as err:
            main(["-o", str(tmp_path / "o.h5"), *_inputs(paths), *argv])
        assert err.value.code == 1
        assert message in capsys.readouterr().err


def test_cli_os_subsets_that_do_not_divide_are_refused(world, tmp_path, capsys):
    """--os_subsets 3 on P = 14: 3 divides neither 14 nor the padded 16. The
    JAX CLI raises the solver's ValueError; the port prints the same
    message and exits 1."""
    paths, *_ = world
    message = "os_subsets=3 must divide the (per-shard, padded) pixel extent 16."
    with pytest.raises(ValueError, match=re.escape(message)):
        jax_main(["-o", str(tmp_path / "j.h5"), *_inputs(paths), *FP32, "--os_subsets", "3",
                  "--pixel_shards", "1"])
    capsys.readouterr()
    assert torch_main(["-o", str(tmp_path / "t.h5"), *_inputs(paths), *FP32,
                       "--os_subsets", "3", "--device", "cpu"]) == 1
    assert message in capsys.readouterr().err


def _jax_debug_nans(argv):
    """The JAX CLI with --debug_nans: ``(raised, exit code)``. In a process
    of its own: ``jax_debug_nans`` is process-wide, and in a process that
    has run other JAX CLI calls (an int8 ``--fused_sweep interpret`` run,
    say) a NaN result can get past it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", SART_COMPILATION_CACHE="",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "sartsolver_tpu.cli", *argv, "--debug_nans",
                           "--pixel_shards", "1"], capture_output=True, text=True, env=env,
                          timeout=300)
    raised = proc.returncode not in (0, 2) and "FloatingPointError" in proc.stderr
    return raised, proc.returncode


@pytest.mark.parametrize("flags,raises", [
    ([], False),
    (["--divergence_recovery", "2"], False),
    (["-L"], False),
    (["--chain_frames", "1"], False),
    (["--os_subsets", "4"], False),
    (["--os_subsets", "4", "--divergence_recovery", "2"], False),
    (["--no_guess", "--batch_frames", "3", "--no_continuous_batching"], False),
    # the scheduler's lanes keep their measurements, NaN pixel included
    (["--no_guess", "--batch_frames", "3"], True),
    (["--no_guess", "--batch_frames", "3", "--divergence_recovery", "2"], True),
    (["--no_guess", "--batch_frames", "3", "--os_subsets", "4"], True),
    # the fp64 profile's guess takes the NaN pixel in
    (["--no_guess", "--use_cpu"], True),
    (["--no_guess", "--use_cpu", "--divergence_recovery", "2"], False),
])
def test_cli_debug_nans_raises_where_the_jax_cli_raises(world, tmp_path, flags, raises, capsys):
    """A NaN pixel in frame 1 under --debug_nans: the port raises
    FloatingPointError on exactly the runs where the JAX CLI raises
    (a NaN in a result of the solve: a lane's state, an iterate), and
    otherwise exits with the JAX CLI's code (2 where the guard writes the
    frame DIVERGED)."""
    paths, *_ = world
    _poison_frame(paths)
    fp = FP64[1:] if "--use_cpu" in flags else FP32
    argv = [*_inputs(paths), *fp, *flags]
    jax_raised, jax_rc = _jax_debug_nans(["-o", str(tmp_path / "jax.h5"), *argv])
    assert jax_raised == raises
    port = ["-o", str(tmp_path / "port.h5"), *argv, "--debug_nans"]
    if "--use_cpu" not in flags:
        port += ["--device", "cpu"]
    if raises:
        with pytest.raises(FloatingPointError, match=r"NaN in .* \(--debug_nans\)"):
            torch_main(port)
    else:
        assert torch_main(port) == jax_rc


@pytest.mark.parametrize("flags", [
    [], ["-L"], ["--no_guess", "--batch_frames", "3"], ["--os_subsets", "4"],
    ["--os_subsets", "2", "-L", "--no_guess", "--batch_frames", "3"],
], ids=["chain", "log", "scheduled", "os4", "os2-log-scheduled"])
def test_cli_debug_nans_changes_no_byte(world, tmp_path, flags):
    """A healthy run with --debug_nans writes the same file as without it."""
    paths, *_ = world
    outs = []
    for extra in ([], ["--debug_nans"]):
        out = str(tmp_path / f"port{len(extra)}.h5")
        assert torch_main(["-o", out, *_inputs(paths), *FP32, "-l", paths["laplacian"],
                           "--device", "cpu", *flags, *extra]) == 0
        outs.append(_read(out)[0])
    for key in outs[0]:
        np.testing.assert_array_equal(outs[0][key], outs[1][key], err_msg=key)
