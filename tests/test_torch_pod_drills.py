"""The fake pod through the port's CLI: N one-process workers in lockstep.

Subprocess drills on ``fixtures.write_world`` (10 frames), the scheduler with
in-solve checkpoints (``--no_guess --batch_frames 4 --solve_ckpt_stride 2``)
in the deterministic fp64 profile, each worker with ``SART_POD_PROCESS=k/2``,
a fresh ``SART_POD_BARRIER_DIR`` a pass and one ``SART_SOLVE_CKPT_FILE``
base:

- two workers write files equal, dataset for dataset and bit for bit, to a
  solo run with the same flags, each host its own checkpoint file, both
  meeting at every stride and at the end;
- a SIGKILL of host 1 at its third stride marker, host 1 held there short of
  the barrier (``SART_TEST_POD_HOLD``) until the kill lands: host 0 exits 3
  within the barrier deadline plus 15 s, its stderr, crash bundle and artifact naming
  ``h1`` and the barrier; the whole pod's ``--resume`` on a fresh barrier
  directory agrees on one checkpoint serial and writes the solo run's rows.

The campaign (``chaos --pod 2``) is ``test_torch_pod_chaos.py``.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import h5py
import numpy as np
import pytest

import fixtures as fx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 10
DEADLINE = 10  # SART_POD_BARRIER_TIMEOUT of the drills
RUN_TIMEOUT = 180  # seconds, one worker's run


def _env(extra=None):
    env = dict(os.environ)
    for key in ("SART_FAULT", "SART_POD_PROCESS", "SART_POD_BARRIER_DIR",
                "SART_TEST_POD_MARKERS", "SART_TEST_POD_HOLD", "SART_TEST_SOLVE_CKPT_DELAY",
                "SART_SOLVE_CKPT_FILE"):
        env.pop(key, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    env["OMP_NUM_THREADS"] = "1"
    env["SART_POD_BARRIER_TIMEOUT"] = str(DEADLINE)
    env.update(extra or {})
    return env


def _cmd(paths, out, *extra):
    return [sys.executable, "-m", "sartsolver_tpu_torch.cli", "-o", out,
            paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"], paths["img_a"], paths["img_b"],
            "--use_cpu", "-m", "40", "-c", "1e-12", "-l", paths["laplacian"], "-b", "0.001",
            "--max_cached_solutions", "1", "--no_guess", "--batch_frames", "4",
            "--solve_ckpt_stride", "2", *extra]


def _bytes(path):
    with h5py.File(path, "r") as f:
        data = {k: f["solution"][k][:].tobytes() for k in f["solution"]}
        data["completed"] = int(f["solution"].attrs["completed"])
    return data


def _pod_env(k, bdir, ckpt, **extra):
    return _env(dict(SART_POD_PROCESS=f"{k}/2", SART_POD_BARRIER_DIR=bdir,
                     SART_SOLVE_CKPT_FILE=ckpt, **extra))


def _pod(paths, td, out, name, *extra, env_extra=None):
    """One pass of both hosts at once, writing ``<out>_h<k>.h5`` and meeting
    in a fresh barrier directory ``bar_<name>``: their exit codes, stderr
    and the directory."""
    bdir = os.path.join(td, f"bar_{name}")
    os.makedirs(bdir)
    procs = [subprocess.Popen(_cmd(paths, os.path.join(td, f"{out}_h{k}.h5"), *extra),
                              env=_pod_env(k, bdir, os.path.join(td, "pod.ck"),
                                           **(env_extra or {})),
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for k in range(2)]
    try:
        errs = [p.communicate(timeout=RUN_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return [p.returncode for p in procs], errs, bdir


@pytest.fixture(scope="module")
def pod_world(tmp_path_factory):
    td = tmp_path_factory.mktemp("pod_world")
    paths, *_ = fx.write_world(str(td), with_laplacian=True, n_frames=N_FRAMES)
    solo = str(td / "solo.h5")
    proc = subprocess.run(_cmd(paths, solo), env=_env(), capture_output=True, text=True,
                          timeout=RUN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = _bytes(solo)
    assert want["completed"] == N_FRAMES
    return paths, want, str(td)


def test_two_fake_pod_workers_equal_a_solo_run(pod_world, tmp_path):
    paths, want, _ = pod_world
    td = str(tmp_path)
    rcs, errs, bdir = _pod(paths, td, "pair", "pair")
    assert rcs == [0, 0], "\n".join(e[-3000:] for e in errs)
    for k in range(2):
        assert _bytes(os.path.join(td, f"pair_h{k}.h5")) == want
        assert os.path.exists(os.path.join(td, f"pod.ck.h{k}of2.jsonl"))
    assert not os.path.exists(os.path.join(td, "pod.ck"))
    names = os.listdir(bdir)
    strides = {int(m.group(1)) for n in names for m in [re.match(r"stride\.(\d+)\.h0", n)] if m}
    assert strides and strides == set(range(1, max(strides) + 1))
    for k in range(2):
        assert f"finalize.h{k}.json" in names and f"alive.h{k}" in names
        assert all(f"stride.{s}.h{k}.json" in names for s in strides)


def test_mid_stride_kill_survivor_exits_then_pod_resumes(pod_world, tmp_path):
    """SIGKILL host 1 at its third ``SART_POD_POINT stride`` marker: host 0
    leaves at the stride barrier's deadline, naming h1; the whole pod's
    resume writes the undisturbed rows."""
    paths, want, _ = pod_world
    td = str(tmp_path)
    bdir = os.path.join(td, "bar_kill")
    os.makedirs(bdir)
    ckpt = os.path.join(td, "pod.ck")
    art0 = os.path.join(td, "kill_h0.jsonl")
    outs = [os.path.join(td, f"pod_h{k}.h5") for k in range(2)]
    # host 1 holds after its third marker until the kill lands: it never
    # reaches barrier stride.3, however late the kill comes under load
    procs = [subprocess.Popen(
        _cmd(paths, outs[k], *(["--metrics_out", art0] if k == 0 else [])),
        env=_pod_env(k, bdir, ckpt, SART_TEST_POD_MARKERS="1",
                     **({"SART_TEST_POD_HOLD": "3"} if k == 1 else {})),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True) for k in range(2)]
    try:
        seen = 0
        for line in procs[1].stderr:
            if line.startswith("SART_POD_POINT stride serial="):
                seen += 1
                if seen == 3:
                    procs[1].kill()
                    killed_at = time.monotonic()
                    break
        else:
            raise AssertionError("host 1 ended before its third stride")
        err0 = procs[0].communicate(timeout=DEADLINE + 60)[1]
        exit_after = time.monotonic() - killed_at
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    assert procs[1].returncode == -signal.SIGKILL
    assert procs[0].returncode == 3, err0[-4000:]
    assert exit_after < DEADLINE + 15
    assert "Aborted at a pod barrier: pod barrier 'stride.3' timed out after 10s; missing " \
           "host(s): h1" in err0, err0[-4000:]
    with open(outs[0] + ".crash.json") as f:
        bundle = json.load(f)
    assert "h1" in bundle["reason"] and "pod barrier" in bundle["reason"]
    assert bundle["status"]["host"] == "0/2"
    with open(art0) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert any(r.get("name") == "pod_barrier_timeouts_total" and r.get("value") == 1
               for r in recs)

    rcs, errs, _ = _pod(paths, td, "pod", "resume", "--resume",
                        env_extra=dict(SART_TEST_POD_MARKERS="1"))
    assert rcs == [0, 0], "\n".join(e[-3000:] for e in errs)
    resumed = [re.search(r"SART_POD_POINT resume serial=(\d+)", e) for e in errs]
    assert all(resumed) and len({int(m.group(1)) for m in resumed}) == 1
    assert 1 <= int(resumed[0].group(1)) <= 3
    for k in range(2):
        assert _bytes(outs[k]) == want
