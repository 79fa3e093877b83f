"""The graceful stop, the hang watchdog and the flight recorder of the port.

The JAX suite's drills (``tests/test_availability.py:125-241,299-358,
441-449``, ``tests/test_flight.py:156-308,412-459``) on the port's modules
and CLI: a ``hang`` at ``solve.dispatch`` or ``device.put`` becomes FAILED
rows and exit 2, under ``--fail_fast`` exit 3 with a crash bundle; a hang
while the solver is built aborts; the heartbeat is written; with the
watchdog armed and quiet the file is the same bytes; SIGUSR1 publishes a
status snapshot of a live run, and each package's ``top`` renders the
other's. Watchdog timeouts here are at most 1 s; the in-process drills keep
a long grace, so the hard abort (``os._exit``) is never reached in pytest.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import h5py
import numpy as np
import pytest

import fixtures as fx
from sartsolver_tpu.obs import flight as jflight
from sartsolver_tpu.obs import schema as jschema
from sartsolver_tpu.obs.cli import top_main as jax_top
from sartsolver_tpu.resilience import watchdog as jwatchdog

from sartsolver_tpu_torch.cli import main
from sartsolver_tpu_torch.obs import flight, schema
from sartsolver_tpu_torch.obs.cli import top_main
from sartsolver_tpu_torch.resilience import faults, shutdown, watchdog
from sartsolver_tpu_torch.resilience.failures import (
    EXIT_INFRASTRUCTURE,
    EXIT_INTERRUPTED,
    EXIT_PARTIAL,
    FRAME_FAILED,
    RunSummary,
    WatchdogTimeout,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    faults.clear_faults()
    yield
    faults.reset()
    shutdown.reset()


# ---------------------------------------------------------------------------
# the stop flag and the watchdog

def test_shutdown_flag_set_by_a_real_signal():
    assert not shutdown.stop_requested()
    with shutdown.installed():
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not shutdown.stop_requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert shutdown.stop_requested() and shutdown.stop_signal() == "SIGTERM"
    assert shutdown.stop_requested()  # the flag outlives the handler
    shutdown.reset()
    assert not shutdown.stop_requested()
    shutdown._state["stop"] = True
    with shutdown.installed():  # a new run starts clean
        assert not shutdown.stop_requested()


def test_beacons_and_the_heartbeat(tmp_path, monkeypatch):
    watchdog.beacon("unit.phase")
    phase, serial, _, ident = watchdog.last_beacon()
    assert phase == "unit.phase" and ident == threading.get_ident()
    hb = str(tmp_path / "heartbeat")
    monkeypatch.setenv("SART_HEARTBEAT_FILE", hb)
    done = watchdog.frames_done()
    watchdog.beacon(watchdog.PHASE_FRAME_DONE)
    assert watchdog.frames_done() == done + 1
    line = open(hb).read()
    assert line.startswith("phase=unit.phase ") and f"frames={done + 1}" in line
    os.unlink(hb)
    watchdog.beacon(watchdog.PHASE_DISPATCH)  # only frame.done writes it
    assert not os.path.exists(hb)
    assert watchdog.beacon_ages()["solve.dispatch"] >= 0


def test_watchdog_is_quiet_under_progress_and_interrupts_a_stall(monkeypatch):
    wd = watchdog.Watchdog(timeout=0.3, poll=0.05, hard_exit=False)
    with wd:
        for _ in range(10):
            watchdog.beacon("steady")
            time.sleep(0.05)
    assert wd.fired == 0
    wd = watchdog.Watchdog(timeout=0.3, grace=30, poll=0.05, hard_exit=False)
    watchdog.beacon("stall.start")
    t0 = time.monotonic()
    with wd, pytest.raises(WatchdogTimeout):
        while time.monotonic() - t0 < 10:
            time.sleep(0.01)
    assert wd.fired == 1 and time.monotonic() - t0 < 5
    monkeypatch.setenv("SART_WATCHDOG_TIMEOUT", "0")
    assert watchdog.Watchdog.from_env() is None
    monkeypatch.setenv("SART_WATCHDOG_TIMEOUT", "0.75")
    monkeypatch.setenv("SART_WATCHDOG_GRACE", "2.5")
    wd = watchdog.Watchdog.from_env()
    assert (wd.timeout, wd.grace) == (0.75, 2.5)


def test_watchdog_hard_abort_runs_the_crash_hook(tmp_path):
    """Stage 3: a stall in one long C-level sleep (the interrupt stays
    pending) ends in ``os._exit(3)``, the crash hook's bundle written
    first."""
    bundle = str(tmp_path / "crash.json")
    code = ("import time\n"
            "from sartsolver_tpu_torch.obs import flight\n"
            "from sartsolver_tpu_torch.resilience import watchdog\n"
            "flight.install()\n"
            f"watchdog.set_crash_hook(lambda r: flight.write_crash_bundle({bundle!r}, r))\n"
            "watchdog.Watchdog(timeout=0.3, grace=0.3, poll=0.05).start()\n"
            "time.sleep(60)\n"
            "print('unreachable')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == EXIT_INFRASTRUCTURE
    assert "aborting with exit 3" in proc.stderr and "thread stacks" in proc.stderr
    assert "unreachable" not in proc.stdout
    rec = json.load(open(bundle))
    assert rec["reason"].startswith("watchdog hard abort") and not schema.validate_record(rec)


# ---------------------------------------------------------------------------
# the flight recorder and `top`

def test_flight_ring_bounded_and_fed_by_beacons():
    rec = flight.FlightRecorder(max_events=4)
    for i in range(10):
        rec.record("event", i=i)
    assert [e["i"] for e in rec.snapshot()] == [6, 7, 8, 9] and rec.total == 10
    rec = flight.install(flight.FlightRecorder(max_events=16))
    try:
        watchdog.beacon("solve.dispatch")
        flight.record_event("event", "ladder engaged")
    finally:
        flight.uninstall()
    kinds = [e["kind"] for e in rec.snapshot()]
    assert "beacon" in kinds and "event" in kinds
    n = rec.total
    watchdog.beacon("solve.dispatch")
    assert rec.total == n


def test_status_snapshot_and_crash_bundle_validate_in_both_packages(tmp_path, capsys):
    watchdog.beacon("solve.dispatch")
    watchdog.set_sched_status_provider(lambda: {"occupancy": 0.5, "lanes": [1],
                                                "strides": 3})
    try:
        rec = flight.write_status(str(tmp_path / "s.json"))
    finally:
        watchdog.set_sched_status_provider(None)
    assert rec["sched"]["occupancy"] == 0.5 and rec["last_beacon"]["phase"] == "solve.dispatch"
    assert schema.validate_record(rec) == [] and jschema.validate_record(rec) == []
    path = str(tmp_path / "usr1.json")
    prev = flight.install_status_handler(path)
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.time() + 5
        while not os.path.exists(path) and time.time() < deadline:
            time.sleep(0.02)
    finally:
        flight.uninstall_status_handler(prev)
    assert json.load(open(path))["type"] == "status"
    assert "sartsolve status:" in capsys.readouterr().err
    summary = RunSummary()
    summary.record_status(0, 1.5)
    summary.record_status(FRAME_FAILED, 2.5)
    bundle = str(tmp_path / "crash.json")
    assert flight.write_crash_bundle(bundle, "watchdog abort: test", summary)
    rec = json.load(open(bundle))
    assert jschema.validate_record(rec) == [] and rec["partial"]["failed_times"] == [2.5]
    assert not flight.write_crash_bundle(str(tmp_path / "no/dir/x.json"), "r")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_top_renders_either_packages_snapshot(tmp_path, capsys, writer):
    """A status snapshot of either package, rendered by both ``top``s: the
    same screen but for the snapshot's age."""
    path = str(tmp_path / "s.json")
    mod, fl = (watchdog, flight) if writer == "port" else (jwatchdog, jflight)
    mod.beacon("solve.dispatch")
    mod.set_sched_status_provider(lambda: {"occupancy": 0.75, "lanes": [2, 5],
                                           "strides": 9})
    try:
        fl.write_status(path)
    finally:
        mod.set_sched_status_provider(None)
    screens = []
    for top in (top_main, jax_top):
        assert top([path, "--once"]) == 0
        screens.append(capsys.readouterr().out)
    for out in screens:
        assert "solve.dispatch" in out and "occupancy 0.75" in out and "2,5" in out
    strip = [[ln for ln in s.splitlines() if "snapshot" not in ln and "ago" not in ln]
             for s in screens]
    assert strip[0] == strip[1]
    hb = tmp_path / "hb"
    hb.write_text("phase=solve.dispatch frames=7 serial=21 occupancy=0.875 unix=1.5\n")
    assert top_main([str(hb), "--once"]) == 0
    assert "0.875" in capsys.readouterr().out
    (tmp_path / "junk").write_text("what is this\n")
    assert top_main([str(tmp_path / "junk"), "--once"]) == 1
    assert main(["top", str(tmp_path / "gone"), "--once"]) == 1


# ---------------------------------------------------------------------------
# through the CLI

@pytest.fixture
def world(tmp_path):
    return fx.write_world(tmp_path, with_laplacian=True)


def run_cli(paths, *extra, out=None):
    return main(["-o", out or paths["output"], paths["rtm_a1"], paths["rtm_a2"],
                 paths["rtm_b"], paths["img_a"], paths["img_b"], "--device", "cpu",
                 "-m", "300", "-c", "1e-6", *extra])


def _status(path):
    with h5py.File(path, "r") as f:
        return list(f["solution/status"][:]), f["solution/iterations"][:]


def _arm(monkeypatch, timeout="1"):
    monkeypatch.setenv("SART_WATCHDOG_TIMEOUT", timeout)
    monkeypatch.setenv("SART_WATCHDOG_GRACE", "60")  # stage 3 never in pytest
    monkeypatch.setenv("SART_HANG_RELEASE", "60")


@pytest.mark.parametrize("site,loop,want", [
    (faults.SITE_SOLVE, ["--chain_frames", "1"], [FRAME_FAILED, 0, 0, 0]),
    (faults.SITE_DEVICE_PUT, ["--chain_frames", "2"], [FRAME_FAILED, FRAME_FAILED, 0, 0]),
    (faults.SITE_SOLVE, ["--no_guess", "--batch_frames", "2"],
     [FRAME_FAILED, FRAME_FAILED, 0, 0]),
])
def test_cli_hang_becomes_failed_rows(world, monkeypatch, capsys, site, loop, want):
    """A hang at a dispatch-side site: stack dump, ``WatchdogTimeout`` in the
    frame loop, the group's frames FAILED, the rest solved, exit 2 — well
    before the hang's release."""
    paths, *_ = world
    _arm(monkeypatch)
    faults.inject(site, "hang", count=1)
    t0 = time.monotonic()
    assert run_cli(paths, *loop) == EXIT_PARTIAL
    assert time.monotonic() - t0 < 30
    status, iters = _status(paths["output"])
    assert status == want and (iters[np.asarray(status) == FRAME_FAILED] == -1).all()
    out = capsys.readouterr()
    assert "dumping thread stacks" in out.err and "WatchdogTimeout" in out.err
    assert "watchdog: no progress" in out.out  # the summary's event


def test_cli_hang_under_fail_fast_exits_3_with_a_crash_bundle(world, monkeypatch, capsys):
    paths, *_ = world
    _arm(monkeypatch)
    faults.inject(faults.SITE_SOLVE, "hang", count=1)
    assert run_cli(paths, "--fail_fast") == EXIT_INFRASTRUCTURE
    assert "Aborted by the hang watchdog" in capsys.readouterr().err
    rec = json.load(open(paths["output"] + ".crash.json"))
    assert rec["type"] == "flight" and rec["reason"].startswith("watchdog abort:")
    assert any(e["kind"] == "beacon" for e in rec["ring"])
    assert jschema.validate_record(rec) == []


def test_cli_hang_while_the_solver_is_built_aborts(world, monkeypatch, capsys):
    """The Laplacian's staging (a ``device.put`` of the solver's
    construction) hangs: no frame to fail, the run exits 3."""
    paths, *_ = world
    _arm(monkeypatch)
    faults.inject(faults.SITE_DEVICE_PUT, "hang", count=1)
    assert run_cli(paths, "-l", paths["laplacian"], "-b", "0.001") == EXIT_INFRASTRUCTURE
    err = capsys.readouterr().err
    assert "dumping thread stacks" in err and "Aborted by the hang watchdog" in err


def test_cli_watchdog_quiet_writes_the_same_bytes_and_the_heartbeat(world, monkeypatch,
                                                                  tmp_path):
    paths, *_ = world
    clean = str(tmp_path / "clean.h5")
    assert run_cli(paths, "--no_guess", "--batch_frames", "2", out=clean) == 0
    assert not os.path.exists(clean + ".crash.json")
    assert not os.path.exists(clean + ".status.json")
    _arm(monkeypatch)
    hb = str(tmp_path / "hb")
    monkeypatch.setenv("SART_HEARTBEAT_FILE", hb)
    assert run_cli(paths, "--no_guess", "--batch_frames", "2") == 0
    with open(clean, "rb") as a, open(paths["output"], "rb") as b:
        assert a.read() == b.read()
    line = open(hb).read()
    assert "frames=" in line and "occupancy=" in line  # the scheduler's lanes too


def test_cli_stop_exits_4_with_a_crash_bundle(world, monkeypatch, capsys):
    paths, *_ = world
    monkeypatch.setattr(shutdown, "stop_requested", lambda: True)
    for loop in ([], ["--no_guess", "--batch_frames", "2"]):
        assert run_cli(paths, *loop) == EXIT_INTERRUPTED
        assert "resumable" in capsys.readouterr().err
        rec = json.load(open(paths["output"] + ".crash.json"))
        assert rec["reason"].startswith("interrupted by")


def test_cli_sigusr1_snapshot_of_a_live_run_renders_in_both_tops(world, tmp_path, capsys):
    """SIGUSR1 to a live run (held in its flush windows) writes
    ``<output>.status.json``; it is the run's, and both ``top``s render it."""
    paths, *_ = world
    out = str(tmp_path / "live.h5")
    env = dict(os.environ, PYTHONPATH=REPO, SART_TEST_FLUSH_DELAY="0.3",
               SART_WRITER_QUEUE="1")
    cmd = [sys.executable, "-m", "sartsolver_tpu_torch.cli", "-o", out, paths["rtm_a1"],
           paths["rtm_a2"], paths["rtm_b"], paths["img_a"], paths["img_b"], "--device",
           "cpu", "-m", "300", "-c", "1e-6", "--max_cached_solutions", "1",
           "--chain_frames", "1"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    timer = threading.Timer(120, proc.kill)
    timer.start()
    try:
        for line in proc.stderr:
            if line.startswith("SART_FLUSH_POINT"):
                proc.send_signal(signal.SIGUSR1)
                break
        rest = proc.stderr.read()
        proc.wait(timeout=120)
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, rest
    assert "sartsolve status: frames=" in rest
    rec = json.load(open(out + ".status.json"))
    assert rec["pid"] == proc.pid and rec["frames_done"] >= 1
    assert jschema.validate_record(rec) == []
    for top in (top_main, jax_top):
        assert top([out + ".status.json", "--once"]) == 0
        assert "frames_done" in capsys.readouterr().out
