"""The port's supervisor (``serve --supervised``) against the JAX package's,
and its real processes on the CPU.

Ported from ``tests/test_selfheal.py``: the crash-loop breaker, the restart
backoff, the exit classification and the event-log rotation give the JAX
functions' answers on the same inputs; the lame duck never clobbers a done
response; the supervisor and the fleet controller spawn the port's worker
(``python -m sartsolver_tpu_torch.cli serve``), never the JAX CLI. The
real-process drills run ``python -m sartsolver_tpu_torch.cli serve
--supervised`` on the fixture world: a worker that exits 1 (a flag error, or
no CUDA device without ``--use_cpu``) is final; the restart storm trips the
breaker on schedule into lame duck (``/healthz`` 503 ``crash-loop``, ingest
rejected with a retry hint, ``supervisor.jsonl``, ``supervisor.prom``,
``supervisor.crash.json``), clears, serves, and drains on SIGTERM with exit
4; ``submit --retry`` honours the lame duck's hint.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import fixtures as fx

from sartsolver_tpu.resilience import supervisor as jsup

from sartsolver_tpu_torch.engine import request as req_mod
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.resilience import supervisor as sup_mod
from sartsolver_tpu_torch.resilience.supervisor import (
    CrashLoopBreaker,
    FleetController,
    Supervisor,
    classify_exit,
    restart_backoff,
    rotate_events,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, per subprocess
SOLVE_FLAGS = ["--use_cpu", "-m", "40", "-c", "1e-12"]


# ---------------------------------------------------------------------------
# the helpers against the JAX package's
# ---------------------------------------------------------------------------

def test_crash_loop_breaker_opens_and_clears_on_schedule():
    b = CrashLoopBreaker(threshold=3, window_s=10.0)
    b.record(0.0)
    b.record(2.0)
    assert not b.open(2.0)
    b.record(4.0)
    assert b.open(4.0)
    # clears exactly when the crash holding the count at threshold ages
    # out of the window (the first one here)
    assert b.remaining_s(4.0) == pytest.approx(6.0)
    assert b.open(9.9)
    assert not b.open(10.1)
    assert b.remaining_s(10.1) == 0.0


def test_breaker_matches_jax_on_a_random_crash_stream():
    rng = np.random.default_rng(18)
    for threshold, window in ((1, 5.0), (3, 10.0), (5, 60.0)):
        ours, theirs = CrashLoopBreaker(threshold, window), jsup.CrashLoopBreaker(threshold,
                                                                                 window)
        now = 0.0
        for _ in range(200):
            now += float(rng.exponential(window / threshold))
            if rng.random() < 0.6:
                ours.record(now)
                theirs.record(now)
            probe = now + float(rng.uniform(0.0, window))
            assert ours.open(probe) == theirs.open(probe)
            assert ours.remaining_s(probe) == theirs.remaining_s(probe)
            assert list(ours.crashes) == list(theirs.crashes)


def test_restart_backoff_matches_jax():
    assert restart_backoff(1, 1.0, 30.0) == 1.0
    assert restart_backoff(4, 1.0, 30.0) == 8.0
    assert restart_backoff(20, 1.0, 30.0) == 30.0  # capped
    assert restart_backoff(0, 1.0, 30.0) == 0.0
    for streak in range(-1, 12):
        for base, cap in ((0.05, 0.5), (0.5, 10.0), (1.0, 30.0), (0.0, 1.0)):
            assert restart_backoff(streak, base, cap) == jsup.restart_backoff(streak, base, cap)


@pytest.mark.parametrize("code", [-signal.SIGKILL, -signal.SIGSEGV, -signal.SIGTERM,
                                  -signal.SIGABRT, -99, 0, 1, 2, 3, 4, 7, 137])
def test_classify_exit_matches_jax(code):
    assert classify_exit(code) == jsup.classify_exit(code)


def test_classify_exit_vocabulary():
    assert classify_exit(-signal.SIGKILL) == "signal:SIGKILL"
    assert classify_exit(-signal.SIGSEGV) == "signal:SIGSEGV"
    assert classify_exit(3) == "infrastructure"
    assert classify_exit(7) == "exit:7"


@pytest.mark.parametrize("limit", [0, 512, 2048, 10_000, 1 << 20])
def test_rotate_events_matches_jax(tmp_path, limit):
    lines = [json.dumps({"kind": "tick", "n": i, "pad": "x" * (i % 37)}) + "\n"
             for i in range(400)]
    ours, theirs = str(tmp_path / "ours.jsonl"), str(tmp_path / "theirs.jsonl")
    for path in (ours, theirs):
        with open(path, "w") as f:
            f.writelines(lines)
    assert rotate_events(ours, limit) == jsup.rotate_events(theirs, limit)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert sup_mod.DEFAULT_ROTATE_BYTES == jsup.DEFAULT_ROTATE_BYTES


def test_rotate_limit_knob(monkeypatch):
    for value in ("4096", "0", "junk", ""):
        monkeypatch.setenv("SART_SUPERVISOR_ROTATE_BYTES", value)
        assert sup_mod._rotate_limit() == jsup._rotate_limit()


# ---------------------------------------------------------------------------
# the worker the supervisor and the controller spawn
# ---------------------------------------------------------------------------

class _Popen:
    """Stands in for subprocess.Popen: records the command and the env."""

    calls = []

    def __init__(self, cmd, env=None, **_kw):
        self.pid = 4242
        _Popen.calls.append((list(cmd), env))

    def poll(self):
        return None


def test_supervisor_and_controller_spawn_the_port_worker(tmp_path, monkeypatch):
    """The spawned worker is ``python -m sartsolver_tpu_torch.cli serve``
    with the supervised argv (the JAX supervisor's command names the JAX
    CLI); each fleet worker carries its SART_WORKER_ID and its shard."""
    obs_metrics.reset_registry()
    _Popen.calls = []
    monkeypatch.setattr(sup_mod.subprocess, "Popen", _Popen)
    sup = Supervisor(["--use_cpu", "a.h5"], engine_dir=str(tmp_path / "eng"))
    sup._spawn()
    fc = FleetController(["--use_cpu", "a.h5"], fleet_dir=str(tmp_path / "fleet"), size=2,
                         base_port=9100)
    fc._spawn(1)
    (cmd, _env), (fcmd, fenv) = _Popen.calls
    assert cmd == [sys.executable, "-m", "sartsolver_tpu_torch.cli", "serve", "--use_cpu",
                   "a.h5"]
    assert fcmd[:4] == [sys.executable, "-m", "sartsolver_tpu_torch.cli", "serve"]
    assert fcmd[4:] == ["--engine_dir", fc.workers[1]["dir"],
                        "--responses_dir", fc.responses_dir, "--outputs_dir", fc.outputs_dir,
                        "--worker_index", "1", "--fleet_size", "2", "--http_port", "9101",
                        "--use_cpu", "a.h5"]
    assert fenv["SART_WORKER_ID"] == "w1"
    kinds = [json.loads(ln)["kind"] for ln in open(sup.events_path)]
    assert kinds == ["worker-spawn"]


# ---------------------------------------------------------------------------
# lame duck
# ---------------------------------------------------------------------------

def test_lame_duck_never_clobbers_done_response(tmp_path):
    """A resubmission of a COMPLETED id arriving during lame duck is a
    duplicate: the recorded outcome survives; a new id gets the crash-loop
    rejection with its retry hint."""
    obs_metrics.reset_registry()
    eng = str(tmp_path / "eng")
    sup = Supervisor([], engine_dir=eng)
    done_rec = {"unix": 1.0, "id": "dup1", "verdict": "accepted",
                "state": "done", "outcome": {"status": "completed"}}
    with open(os.path.join(eng, "responses", "dup1.json"), "w") as f:
        json.dump(done_rec, f)
    for rid in ("dup1", "new1"):
        with open(os.path.join(eng, "ingest", f"{rid}.json"), "w") as f:
            json.dump({"id": rid, "tenant": "a"}, f)
    n = sup._reject_ingest(remaining_s=9.0)
    assert n == 1
    assert not os.listdir(os.path.join(eng, "ingest"))
    assert json.load(open(os.path.join(eng, "responses", "dup1.json"))) == done_rec
    new1 = json.load(open(os.path.join(eng, "responses", "new1.json")))
    assert new1["reason"] == req_mod.REASON_CRASH_LOOP
    assert new1["retry_after_s"] == 9.0
    reg = obs_metrics.get_registry()
    assert reg.counter("engine_shed_total", reason=req_mod.REASON_CRASH_LOOP).value == 1


# ---------------------------------------------------------------------------
# real supervised processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    td = tmp_path_factory.mktemp("torch_selfheal_world")
    paths, *_ = fx.write_world(str(td), n_frames=4)
    return paths


def _env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("SART_FAULT", "SART_TEST_JOURNAL_DELAY", "SART_TEST_SERVE_CRASH")}
    env["PYTHONUNBUFFERED"] = "1"  # the drills watch live lines
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def _supervised_cmd(paths, eng_dir, *extra, solve=SOLVE_FLAGS):
    return [sys.executable, "-m", "sartsolver_tpu_torch.cli", "serve",
            "--engine_dir", eng_dir, *solve, "--lanes", "2", "--poll_interval", "0.05",
            "--supervised", *extra,
            paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"], paths["img_a"], paths["img_b"]]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


def _response(eng_dir, rid):
    with open(os.path.join(eng_dir, "responses", f"{rid}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("case", ["flag-error", "no-card"])
def test_supervisor_config_error_is_final(world, tmp_path, case):
    """A worker that exits 1 is not restarted: a flag error (``--lanes 0``),
    or no CUDA device without ``--use_cpu`` / ``--device cpu`` (the default
    device is the card's; no fallback hides it)."""
    if case == "flag-error":
        cmd = _supervised_cmd(world, str(tmp_path / "eng"), "--restart_backoff", "0.05",
                              "--lanes", "0")
        env = _env()
    else:
        cmd = _supervised_cmd(world, str(tmp_path / "eng"), "--restart_backoff", "0.05",
                              solve=["-m", "40"])
        env = _env({"CUDA_VISIBLE_DEVICES": ""})
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    text = res.stdout + res.stderr
    assert res.returncode == 1, text
    assert "worker-config-error" in text
    assert "worker-crash" not in text
    assert text.count("worker-spawn pid=") == 1
    if case == "no-card":
        assert "No CUDA device" in text


def test_restart_storm_breaker_opens_and_clears(world, tmp_path):
    """A crash-looping worker trips the breaker on schedule -> lame duck
    (healthz 503 crash-loop, ingest rejected with the machine-readable
    reason and a retry hint, the engine_crash_loop gauge up) -> the window
    clears, the fixed worker serves, SIGTERM drains through the supervisor
    with exit 4 (one forwarded SIGTERM)."""
    eng = str(tmp_path / "eng")
    marker = str(tmp_path / "crash.marker")
    open(marker, "w").write("boom")
    proc = subprocess.Popen(
        _supervised_cmd(world, eng, "--restart_backoff", "0.05", "--restart_backoff_max", "0.2",
                        "--crash_loop_window", "12", "--crash_loop_threshold", "3",
                        "--http_port", "0"),
        env=_env({"SART_TEST_SERVE_CRASH": marker}), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    guard = threading.Timer(TIMEOUT, proc.kill)
    guard.start()
    lines = []
    state = {"resident": False, "port": None, "lame": False}
    try:
        for line in proc.stdout:
            lines.append(line)
            if "lame-duck-enter" in line and not state["lame"]:
                state["lame"] = True
                # the worker is gone: the marker can come off so the
                # half-open spawn succeeds once the window clears; a
                # request arriving now gets the crash-loop rejection
                os.unlink(marker)
                ingest = os.path.join(eng, "ingest")
                with open(os.path.join(ingest, "ld1.json.tmp"), "w") as f:
                    json.dump({"id": "ld1", "tenant": "a"}, f)
                os.replace(os.path.join(ingest, "ld1.json.tmp"),
                           os.path.join(ingest, "ld1.json"))
            m = re.search(r"lame-duck-endpoint port=(\d+)", line)
            if m:
                state["port"] = int(m.group(1))
                with pytest.raises(urllib.error.HTTPError) as exc:
                    _get(f"http://127.0.0.1:{state['port']}/healthz")
                assert exc.value.code == 503
                assert json.loads(exc.value.read())["status"] == req_mod.REASON_CRASH_LOOP
                with pytest.raises(urllib.error.HTTPError) as exc:
                    _get(f"http://127.0.0.1:{state['port']}/readyz")
                rec = json.loads(exc.value.read())
                assert rec == {"status": "not-ready", "reason": req_mod.REASON_CRASH_LOOP,
                               "detail": rec["detail"]}
                _code, prom = _get(f"http://127.0.0.1:{state['port']}/metrics")
                assert b"sart_engine_crash_loop 1" in prom
            if "session resident" in line and not state["resident"]:
                state["resident"] = True
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=TIMEOUT)
    finally:
        guard.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    text = "".join(lines)
    assert rc == 4, text[-4000:]
    assert state["lame"] and state["resident"] and state["port"], text[-4000:]
    assert "lame-duck-exit" in text
    # the port's worker (its session line), three on-schedule crashes
    assert "device=cpu operator=dense" in text
    assert text.count("worker-crash code=") == 3
    assert "reason=infrastructure" in text
    assert text.count("sigterm-forwarded") == 1
    rec = _response(eng, "ld1")
    assert rec["verdict"] == "rejected"
    assert rec["reason"] == req_mod.REASON_CRASH_LOOP
    assert rec["retry_after_s"] >= 1.0
    kinds = [json.loads(ln)["kind"] for ln in open(os.path.join(eng, "supervisor.jsonl"))]
    assert sum(k == "worker-crash" for k in kinds) == 3
    assert "lame-duck-enter" in kinds and "lame-duck-exit" in kinds
    assert kinds[-1] == "worker-done"
    prom = open(os.path.join(eng, "supervisor.prom")).read()
    assert 'sart_engine_restarts_total{reason="infrastructure"} 3' in prom
    assert "sart_engine_crash_loop 0" in prom
    bundle = json.load(open(os.path.join(eng, "supervisor.crash.json")))
    assert "crash-loop" in bundle["reason"]


def test_submit_retry_honors_hint_against_lame_duck(world, tmp_path):
    """``submit --retry`` against a crash-looping engine: the first attempt
    is rejected crash-loop with a hint; once the breaker clears and the
    worker serves, a retry completes the request."""
    eng = str(tmp_path / "eng")
    marker = str(tmp_path / "crash.marker")
    open(marker, "w").write("boom")
    proc = subprocess.Popen(
        _supervised_cmd(world, eng, "--restart_backoff", "0.05", "--restart_backoff_max", "0.2",
                        "--crash_loop_window", "8", "--crash_loop_threshold", "2"),
        env=_env({"SART_TEST_SERVE_CRASH": marker}), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    guard = threading.Timer(TIMEOUT, proc.kill)
    guard.start()
    lines = []
    submit = {"res": None}
    try:
        for line in proc.stdout:
            lines.append(line)
            if "lame-duck-enter" in line and submit["res"] is None:
                os.unlink(marker)

                def do_submit():
                    try:
                        submit["res"] = subprocess.run(
                            [sys.executable, "-m", "sartsolver_tpu_torch.cli", "submit",
                             "--engine_dir", eng, "--id", "rt1", "--tenant", "a",
                             "--wait", "60", "--retry", "8"],
                            env=_env({"SART_RETRY_BASE_DELAY": "0.2",
                                      "SART_RETRY_DEADLINE": "90"}),
                            capture_output=True, text=True, timeout=TIMEOUT)
                    finally:
                        # retries done: drain the engine so the test ends
                        proc.send_signal(signal.SIGTERM)

                submit["res"] = False
                threading.Thread(target=do_submit, daemon=True).start()
        rc = proc.wait(timeout=TIMEOUT)
    finally:
        guard.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    res = submit["res"]
    assert res, "".join(lines)[-3000:]
    assert res.returncode == 0, res.stdout + res.stderr + "".join(lines)[-3000:]
    rec = json.loads(res.stdout)
    assert rec["outcome"]["status"] == "completed"
    assert "rejected (crash-loop); retry" in res.stderr
    assert rc == 4
