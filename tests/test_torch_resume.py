"""--resume, the in-place append and the crash drills of the port.

The JAX CLI and the port's resume each other's partial files (fp64, the
JAX test's profile, ``tests/test_cli.py:188-300``) and both end equal to
an uninterrupted JAX run; the single-process kill drills of
``tests/test_killdrill.py`` (SIGKILL inside the ``torn`` and
``pre-counter`` flush windows, SIGTERM's exit 4, a second signal's abort)
run the port's CLI in a subprocess, each with its own timeout; and the
property test of ``tests/test_properties.py:453`` holds the port's writer
to any torn state of its in-place files, which h5py reads and extends.
"""

import os
import signal
import subprocess
import sys
import tempfile
import threading

import h5py
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import fixtures as fx
from sartsolver_tpu.cli import main as jax_main

from sartsolver_tpu_torch.cli import main as torch_main
from sartsolver_tpu_torch.io.solution import SolutionWriter, read_resume_state, row_checksum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP64 = ["--use_cpu", "-m", "300", "-c", "1e-6"]
# the drills' profile: every frame runs to the cap, so a killed and resumed
# run repeats the uninterrupted one exactly; one flush per frame
DRILL = ["--use_cpu", "-m", "40", "-c", "1e-12", "--max_cached_solutions", "1",
         "--chain_frames", "2"]
N_DRILL = 6
TIMEOUT = 120  # seconds, per subprocess


def _inputs(paths):
    return [paths[k] for k in ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b")]


def _read(path):
    with h5py.File(path, "r") as f:
        out = {k: f["solution"][k][:] for k in f["solution"]}
        out["completed"] = int(f["solution"].attrs["completed"])
        out["voxel_map"] = f["voxel_map/value"][:] if "voxel_map" in f else None
    return out


def _assert_same_run(got, want, rtol=1e-10, atol=1e-13):
    assert got["completed"] == want["completed"] == len(want["time"])
    for key in want:
        if key == "value":
            np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol)
        elif key in ("status", "iterations", "voxel_map"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        elif key == "checksum":  # each row's own CRC32 (the values agree to rtol)
            assert list(got[key]) == [row_checksum(r) for r in got["value"]]
        elif key != "completed":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-15, err_msg=key)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return fx.write_world(tmp_path_factory.mktemp("resume"), with_laplacian=True)


@pytest.fixture(scope="module")
def jax_reference(world, tmp_path_factory):
    paths, *_ = world
    out = str(tmp_path_factory.mktemp("ref") / "jax.h5")
    assert jax_main(["-o", out, *_inputs(paths), *FP64, "--pixel_shards", "1"]) == 0
    return _read(out)


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax"),
                                          ("port", "port")])
def test_resume_across_packages_matches_an_uninterrupted_run(
        world, jax_reference, tmp_path, first, second, capsys):
    """Half the frames (``-t``) by one package, ``--resume`` over all by the
    other: the rows the second skipped are the first's, the rest are
    appended warm-started from the file's last row, and the file equals an
    uninterrupted JAX run (statuses and iterations exactly, values to
    1e-10); a second ``--resume`` is a no-op."""
    paths, _, _, times, _ = world
    out = str(tmp_path / "out.h5")
    run = {"jax": lambda *a: jax_main(["-o", out, *_inputs(paths), *FP64, *a,
                                       "--pixel_shards", "1"]),
           "port": lambda *a: torch_main(["-o", out, *_inputs(paths), *FP64, *a])}
    assert run[first]("-t", "0.05:0.25") == 0
    assert _read(out)["completed"] == 2
    capsys.readouterr()
    assert run[second]("--resume") == 0
    assert capsys.readouterr().out.count("Processed in:") == len(times) - 2
    _assert_same_run(_read(out), jax_reference)
    assert run[second]("--resume") == 0
    assert capsys.readouterr().out.count("Processed in:") == 0
    _assert_same_run(_read(out), jax_reference)


def test_resume_refuses_an_incompatible_or_corrupt_file(world, tmp_path, capsys):
    """Another voxel count or camera set, or a completed row that fails its
    CRC32, refuses the resume: exit 1 with "Cannot resume", the file left
    as it was (``tests/test_cli.py:224``, ``tests/test_integrity.py:581``)."""
    paths, *_ = world
    out = str(tmp_path / "out.h5")
    with h5py.File(out, "w") as f:
        f.create_dataset("solution/value", data=np.zeros((1, 3)), maxshape=(None, 3),
                         chunks=(1, 3))
        f.create_dataset("solution/time", data=np.asarray([0.1]), maxshape=(None,),
                         chunks=(1,))
        f.create_dataset("solution/status", data=np.asarray([0], np.int32),
                         maxshape=(None,), chunks=(1,))
    assert torch_main(["-o", out, *_inputs(paths), *FP64, "--resume"]) == 1
    assert "Cannot resume" in capsys.readouterr().err
    assert torch_main(["-o", out, *_inputs(paths), *FP64, "-t", "0.05:0.25"]) == 0
    with h5py.File(out, "r+") as f:
        f["solution/value"][1, 0] += 1.0
    before = open(out, "rb").read()
    assert torch_main(["-o", out, *_inputs(paths), *FP64, "--resume"]) == 1
    err = capsys.readouterr().err
    assert "Cannot resume" in err and "row 1 fails its stored checksum" in err
    assert open(out, "rb").read() == before


def test_resume_truncates_a_torn_flush_and_rebuilds_a_torn_first_flush(world, tmp_path,
                                                                      capsys):
    """A flush killed half way (some datasets longer than the counter) is
    truncated and its frames redone; a file without ``status`` is a torn
    first flush and is written afresh (``tests/test_cli.py:240-270``)."""
    paths, _, _, times, _ = world
    out = str(tmp_path / "out.h5")
    assert torch_main(["-o", out, *_inputs(paths), *FP64]) == 0
    with h5py.File(out, "r+") as f:
        f["solution/time"].resize((5,))
        f["solution/time"][4] = 0.9
        f["solution/status"].resize((5,))
    capsys.readouterr()
    assert torch_main(["-o", out, *_inputs(paths), *FP64, "--resume"]) == 0
    assert capsys.readouterr().out.count("Processed in:") == 0
    with h5py.File(out, "r") as f:
        assert f["solution/time"].shape == f["solution/status"].shape == (4,)
        assert f["solution/value"].shape[0] == 4
    torn = str(tmp_path / "torn.h5")
    with h5py.File(torn, "w") as f:
        f.create_dataset("solution/value", data=np.zeros((1, fx.NVOXEL)),
                         maxshape=(None, fx.NVOXEL), chunks=(1, fx.NVOXEL))
    assert torch_main(["-o", torn, *_inputs(paths), *FP64, "--resume"]) == 0
    with h5py.File(torn, "r") as f:
        assert f["solution/value"].shape[0] == f["solution/status"].shape[0] == len(times)


# ---------------------------------------------------------------------------
# the kill drills: the port's CLI in a subprocess

def _env(flush_delay=None, writer_queue=None):
    env = {k: v for k, v in os.environ.items() if k != "SART_TEST_FLUSH_DELAY"}
    env["PYTHONPATH"] = REPO
    if flush_delay is not None:
        env["SART_TEST_FLUSH_DELAY"] = str(flush_delay)
    if writer_queue is not None:
        env["SART_WRITER_QUEUE"] = str(writer_queue)
    return env


def _cmd(paths, out, *extra):
    return [sys.executable, "-m", "sartsolver_tpu_torch.cli", "-o", out,
            *_inputs(paths), *DRILL, "-l", paths["laplacian"], "-b", "0.001", *extra]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    td = tmp_path_factory.mktemp("drill")
    paths, *_ = fx.write_world(td, with_laplacian=True, n_frames=N_DRILL)
    ref = str(td / "reference.h5")
    assert torch_main(["-o", ref, *_inputs(paths), *DRILL, "-l", paths["laplacian"],
                       "-b", "0.001"]) == 0
    return paths, _read(ref)


def _signal_at_marker(cmd, env, marker, occurrence, sig):
    """Run ``cmd``; at the ``occurrence``-th ``SART_FLUSH_POINT marker``
    send ``sig``; return (exit code, the rest of stderr)."""
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    timer = threading.Timer(TIMEOUT, proc.kill)
    timer.start()
    seen = 0
    try:
        for line in proc.stderr:
            if line.strip() == f"SART_FLUSH_POINT {marker}":
                seen += 1
                if seen >= occurrence:
                    proc.send_signal(sig)
                    break
        else:
            raise AssertionError(f"the run ended before marker {marker} x{occurrence}")
        rest = proc.stderr.read()
        proc.wait(timeout=TIMEOUT)
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=TIMEOUT)
    return proc.returncode, rest


def _resume(paths, out):
    return subprocess.run(_cmd(paths, out, "--resume"), env=_env(), timeout=TIMEOUT,
                          stdout=subprocess.DEVNULL).returncode


@pytest.mark.parametrize("marker,occurrence", [("torn", 2), ("pre-counter", 1)])
def test_kill_inside_a_flush_window_then_resume(drill, tmp_path, marker, occurrence):
    """SIGKILL inside a flush's commit window: the file keeps its last
    committed flush (the in-place append writes its extents and counter
    last), and ``--resume`` completes it to the uninterrupted run."""
    paths, want = drill
    out = str(tmp_path / "out.h5")
    rc, _ = _signal_at_marker(_cmd(paths, out), _env(flush_delay=0.5), marker, occurrence,
                              signal.SIGKILL)
    assert rc == -signal.SIGKILL
    state = read_resume_state(out, [fx.CAM_A, fx.CAM_B], fx.NVOXEL)
    assert state is not None and 0 < len(state.times) < N_DRILL
    assert _resume(paths, out) == 0
    _assert_same_run(_read(out), want, rtol=1e-12, atol=1e-14)


def test_sigterm_drains_exits_4_then_resumes(drill, tmp_path):
    """SIGTERM at a flush window: the group in flight drains, the run exits
    4 with a consistent prefix (every dataset covers the counter), and
    ``--resume`` completes it to the uninterrupted run."""
    paths, want = drill
    out = str(tmp_path / "out.h5")
    rc, rest = _signal_at_marker(_cmd(paths, out), _env(flush_delay=0.3, writer_queue=1),
                                 "torn", 1, signal.SIGTERM)
    assert rc == 4, rest
    assert "Interrupted by SIGTERM" in rest and "resumable" in rest
    got = _read(out)
    assert got["completed"] < N_DRILL
    assert all(got[k].shape[0] >= got["completed"] for k in ("value", "time", "status"))
    assert _resume(paths, out) == 0
    _assert_same_run(_read(out), want, rtol=1e-12, atol=1e-14)


def test_second_sigterm_aborts_at_once(drill, tmp_path):
    """A second SIGTERM during the drain kills the process by the signal."""
    paths, _ = drill
    out = str(tmp_path / "out.h5")
    proc = subprocess.Popen(_cmd(paths, out), env=_env(flush_delay=2.0, writer_queue=1),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    timer = threading.Timer(TIMEOUT, proc.kill)
    timer.start()
    try:
        for line in proc.stderr:
            if line.startswith("SART_FLUSH_POINT"):
                proc.send_signal(signal.SIGTERM)
                break
        for line in proc.stderr:
            if "received SIGTERM" in line:
                proc.send_signal(signal.SIGTERM)
                break
        else:
            raise AssertionError("the first SIGTERM was never acknowledged")
        proc.stderr.read()
        proc.wait(timeout=TIMEOUT)
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=TIMEOUT)
    assert proc.returncode == -signal.SIGTERM


# ---------------------------------------------------------------------------
# any torn state of an in-place file

@settings(max_examples=15, deadline=None)
@given(
    st.integers(1, 6),  # completed frames before the crash
    st.integers(1, 3),  # frames still to write after the resume
    st.sets(st.sampled_from(["value", "time", "status", "iterations", "time_camA",
                             "time_camB"])),  # datasets the crash extended
    st.integers(1, 3),  # torn rows
    st.integers(0, 2**32 - 1),
)
def test_resume_of_any_torn_state_of_an_in_place_file(n_done, n_rest, torn, extra, seed):
    """A kill mid-flush leaves any subset of the per-frame datasets longer
    than the counter, with garbage rows: ``read_resume_state`` reports the
    frames every dataset completed, the writer truncates the tail in place,
    and after the appends the file equals an uninterrupted run's byte for
    byte in every dataset; h5py reads it and appends to it again
    (``tests/test_properties.py:453``)."""
    rng = np.random.default_rng(seed)
    V, cams = 7, ["camA", "camB"]
    total = n_done + n_rest
    sols = rng.random((total, V))
    times = np.arange(total, dtype=np.float64) * 0.5

    def write(writer, lo, hi):
        for i in range(lo, hi):
            writer.add(sols[i], 0, times[i], [times[i], times[i] + 0.01], iterations=i)

    with tempfile.TemporaryDirectory() as td:
        _torn_state_case(os.path.join(td, "ref.h5"), os.path.join(td, "out.h5"), write,
                         rng, V, cams, n_done, total, torn, extra, sols)


def _torn_state_case(ref, out, write, rng, V, cams, n_done, total, torn, extra, sols):
    with SolutionWriter(ref, cams, V, max_cache_size=2) as w:
        write(w, 0, total)
    with SolutionWriter(out, cams, V, max_cache_size=2) as w:
        write(w, 0, n_done)
    with h5py.File(out, "r+") as f:  # the torn tail
        for key in sorted(torn):
            d = f["solution"][key]
            d.resize((n_done + extra,) + d.shape[1:])
            d[n_done:] = rng.random((extra,) + d.shape[1:]) * 100
    state = read_resume_state(out, cams, V)
    assert len(state.times) == n_done
    np.testing.assert_array_equal(state.last_solution, sols[n_done - 1])
    with SolutionWriter(out, cams, V, max_cache_size=2, resume=state) as w:
        write(w, n_done, total)
    with h5py.File(ref, "r") as fr, h5py.File(out, "r+") as fo:
        for key in fr["solution"]:
            np.testing.assert_array_equal(fo["solution"][key][:], fr["solution"][key][:],
                                          err_msg=key)
        assert int(fo["solution"].attrs["completed"]) == total
        fo["solution/value"].resize((total + 1, V))
        fo["solution/value"][total] = 1.0
    with h5py.File(out, "r") as f:
        np.testing.assert_array_equal(f["solution/value"][total], 1.0)
