"""The pod on a grid of two gloo ranks: ``--resume``, the resume view, the
rendezvous deadlines.

Each rank is a process started with the launcher's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), each with its own timeout,
on ``fixtures.write_world`` in the deterministic fp64 profile at 2×1:

- ``broadcast_resume_state`` over a real group: rank 0's times and last
  solution arrive bit for bit (subnormals, signed zeros, NaN payloads), None
  as None, and an error first, raised as ``SartInputError`` on both ranks;
  the world gather of the rendezvous, run in the deadline's thread, bit
  for bit and uncounted in ``comm.stats``;
- a ``-t`` run over the first half, then ``--resume``: rank 0 reads the file,
  both ranks skip the same frames, and the file's datasets equal an
  uninterrupted 2-rank run's bit for bit;
- a resume read that fails on rank 0 (the output is no HDF5 file) exits 1 on
  both ranks with rank 0's words, neither waiting;
- rank 1 killed in its ingest turn (``SART_POD_POINT ingest turn=1``) with a
  barrier directory: rank 0 exits 3 at ``rtm_read_turn_1``'s deadline naming
  ``h1``, its crash bundle too; a fresh two-rank ``--resume`` then writes the
  uninterrupted run's rows;
- the same turn over the process group alone (no directory): rank 0 exits 3
  within the deadline plus 15 s whether rank 1 is killed (gloo reports the
  lost peer) or stopped (the deadline ends the wait while a thread is still
  blocked in gloo).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import h5py
import numpy as np
import pytest

import fixtures as fx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT = 240  # seconds, one rank's run
N_FRAMES = 10
# the first half of the frames: a window of 5 whose composite frame times
# are the whole series' to the bit (a window's ticks are its own: over 2 or
# 3 of these frames a time lands an ulp away)
FIRST_HALF = "0:0.55"
DEADLINE = 10  # SART_POD_BARRIER_TIMEOUT of the drills
PROFILE = ["--use_cpu", "-m", "40", "-c", "1e-12", "-b", "0.001", "--max_cached_solutions", "1",
           "--chain_frames", "2", "--multihost", "--pixel_shards", "2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank, port, extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SART_") and k not in ("PYTHONPATH", "TORCHELASTIC_RUN_ID")}
    env.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=REPO,
               OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1",
               SART_POD_BARRIER_TIMEOUT=str(DEADLINE))
    env.update(extra or {})
    return env


def _start(argv, extra=None, stderr=subprocess.PIPE):
    port = _free_port()
    return [subprocess.Popen(argv, env=_env(r, port, extra), stdout=subprocess.PIPE,
                             stderr=stderr, text=True, cwd=REPO) for r in range(2)]


def _finish(procs, timeout=RUN_TIMEOUT):
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return [p.returncode for p in procs], outs


def _cli(paths, out, *extra):
    return [sys.executable, "-m", "sartsolver_tpu_torch.cli", "-o", out, paths["rtm_a1"],
            paths["rtm_a2"], paths["rtm_b"], paths["img_a"], paths["img_b"],
            "-l", paths["laplacian"], *PROFILE, *extra]


def _run_pair(paths, out, *extra, env=None):
    rcs, outs = _finish(_start(_cli(paths, out, *extra), env))
    assert rcs == [0, 0], "\n".join(o[1][-3000:] for o in outs)
    return outs


def _bytes(path):
    with h5py.File(path, "r") as f:
        data = {k: f["solution"][k][:].tobytes() for k in f["solution"]}
        data["completed"] = int(f["solution"].attrs["completed"])
    return data


@pytest.fixture(scope="module")
def grid_world(tmp_path_factory):
    td = tmp_path_factory.mktemp("pod_grid_world")
    paths = fx.write_world(str(td), with_laplacian=True, n_frames=N_FRAMES)[0]
    full = str(td / "full.h5")
    outs = _run_pair(paths, full)
    assert outs[0][0].count("Processed in:") == N_FRAMES
    want = _bytes(full)
    assert want["completed"] == N_FRAMES
    return paths, want, td


_BROADCAST = r"""
import os, sys
import numpy as np
import torch.distributed as dist
sys.path.insert(0, os.environ["PYTHONPATH"])
from sartsolver_tpu_torch.config import SartInputError
from sartsolver_tpu_torch.io.solution import ResumeState
from sartsolver_tpu_torch.parallel import comm, multihost as mh

comm.initialize("cpu")
rank, out = dist.get_rank(), sys.argv[1]
times = np.array([0.1, 0.2 + 1e-17, 5e-324, -0.0])
last = np.array([np.pi, np.nextafter(1.0, 2.0), 1e-300, np.nan, -np.inf])
last.view(np.uint64)[3] |= 0x5  # a NaN payload
try:
    mh.broadcast_resume_state(None, 5, error="Cannot resume into x.h5: corrupt" if rank == 0
                              else None)
    raise SystemExit("no error")
except SartInputError as err:
    msg = str(err)
state = mh.broadcast_resume_state(ResumeState(times, last) if rank == 0 else None, 5)
none = mh.broadcast_resume_state(None, 5)
gathered = mh._deadline_collective(
    "gather", lambda: comm.all_gather_host(np.array([rank + 0.1, 5e-324])), 10)
np.savez(f"{out}.r{rank}.npz", times=state.times, last=state.last_solution,
         none=none is None, msg=msg, gathered=gathered, calls=comm.stats["calls"])
comm.shutdown()
"""


def test_broadcast_resume_state_over_two_gloo_ranks(tmp_path):
    rcs, outs = _finish(_start([sys.executable, "-c", _BROADCAST, str(tmp_path / "b")]))
    assert rcs == [0, 0], "\n".join(o[1][-3000:] for o in outs)
    want_times = np.array([0.1, 0.2 + 1e-17, 5e-324, -0.0])
    for rank in range(2):
        got = np.load(tmp_path / f"b.r{rank}.npz")
        assert got["times"].dtype == np.float64
        assert got["times"].tobytes() == want_times.tobytes()
        last = got["last"].view(np.uint64)
        assert last[0] == np.array([np.pi]).view(np.uint64)[0]
        assert last[3] & 0xF == 0x5 and np.isnan(got["last"][3]) and got["last"][4] == -np.inf
        assert bool(got["none"])
        assert str(got["msg"]) == "Cannot resume into x.h5: corrupt"
        # the world gather from the deadline's thread, in rank order, bit
        # for bit, and left out of the solve's collective counts
        want = np.array([[0.1, 5e-324], [1.1, 5e-324]])
        assert got["gathered"].tobytes() == want.tobytes() and int(got["calls"]) == 0
    a, b = (np.load(tmp_path / f"b.r{r}.npz")["last"].tobytes() for r in range(2))
    assert a == b


def test_two_rank_resume_equals_uninterrupted_run(grid_world):
    paths, want, td = grid_world
    out = str(td / "resumed.h5")
    first = _run_pair(paths, out, "-t", FIRST_HALF)
    assert first[0][0].count("Processed in:") == N_FRAMES // 2
    second = _run_pair(paths, out, "--resume")
    # only the frames the file lacks
    assert second[0][0].count("Processed in:") == N_FRAMES - N_FRAMES // 2
    assert second[1][0] == ""  # only rank 0 prints
    assert _bytes(out) == want


def test_resume_error_exits_1_on_every_rank(grid_world, tmp_path):
    paths, _, _ = grid_world
    out = str(tmp_path / "garbage.h5")
    with open(out, "wb") as f:
        f.write(b"not an HDF5 file, a resume must refuse it" * 4)
    start = time.monotonic()
    rcs, outs = _finish(_start(_cli(paths, out, "--resume")), timeout=120)
    assert rcs == [1, 1], "\n".join(o[1][-3000:] for o in outs)
    assert time.monotonic() - start < 60
    words = outs[0][1].strip().splitlines()[-1]
    assert words and outs[1][1].strip().splitlines()[-1] == words
    assert all("Processed in:" not in o[0] for o in outs)


def _kill_in_turn(paths, out, extra, sig=signal.SIGKILL):
    """Both ranks with ``SART_TEST_POD_MARKERS``; rank 1 gets ``sig`` as its
    ingest turn starts. Rank 0's exit code, output and seconds from the
    signal to its exit."""
    procs = _start(_cli(paths, out), dict(extra, SART_TEST_POD_MARKERS="1"))
    try:
        for line in procs[1].stderr:
            if line.strip() == "SART_POD_POINT ingest turn=1":
                procs[1].send_signal(sig)
                signalled = time.monotonic()
                break
        else:
            raise AssertionError("rank 1 ended before its ingest turn")
        out0, err0 = procs[0].communicate(timeout=DEADLINE + 60)
        after = time.monotonic() - signalled
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    return procs[0].returncode, out0 + err0, after


def test_ingest_turn_kill_names_h1_then_fresh_resume(grid_world, tmp_path):
    paths, want, _ = grid_world
    out = str(tmp_path / "killed.h5")
    bdir = tmp_path / "bar"
    bdir.mkdir()
    rc, text, after = _kill_in_turn(paths, out, dict(SART_POD_BARRIER_DIR=str(bdir)))
    assert rc == 3, text[-4000:]
    assert after < DEADLINE + 15
    assert ("Aborted at a pod barrier: pod barrier 'rtm_read_turn_1' timed out after 10s; "
            "missing host(s): h1") in text
    with open(out + ".crash.json") as f:
        bundle = json.load(f)
    assert "h1" in bundle["reason"] and bundle["status"]["host"] == "0/2"
    # the kill came before any row: a --resume of the absent file is a fresh run
    assert not os.path.exists(out)
    bdir2 = tmp_path / "bar2"
    bdir2.mkdir()
    _run_pair(paths, out, "--resume", env=dict(SART_POD_BARRIER_DIR=str(bdir2)))
    assert _bytes(out) == want


@pytest.mark.parametrize("sig", [signal.SIGKILL, signal.SIGSTOP], ids=["killed", "wedged"])
def test_collective_rendezvous_ends_within_the_deadline(grid_world, tmp_path, sig):
    paths, _, _ = grid_world
    rc, text, after = _kill_in_turn(paths, str(tmp_path / "c.h5"), {}, sig)
    assert rc == 3, text[-4000:]
    assert after < DEADLINE + 15
    assert "Aborted at a pod barrier: pod barrier 'rtm_read_turn_1'" in text
    if sig == signal.SIGSTOP:
        assert after >= DEADLINE * 0.9  # the deadline, not an error, ended it
        assert "timed out after 10s; missing host(s): unknown (collective wedged)" in text
    else:
        assert "missing host(s): unknown (collective failed)" in text
