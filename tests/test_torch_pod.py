"""The pod's fault tolerance in the port, unit by unit, against the JAX package.

Ported from ``tests/test_pod.py``: the pod identity's and the barrier
deadline's environment forms, the file barrier (the payload exchange, a dead
host named at the deadline, a fresh liveness beacon extending the wait, a
torn payload), a pod of one process doing no I/O, the stop agreement in file
mode, the ``site@i`` fault qualifier (armed on its host only, validated on
every host), the per-host checkpoint files and the pod-wide resume point
(each package reading the other's files), ``PodSchedule``'s draws, and the
deadline collective. Each held against the JAX function in this process
where one exists; a JAX host and a port host also meet in one barrier
directory. Also the scheduler's stride barrier, the ``multihost.init``
retries through the CLI, and the timeout counter's help text.

The subprocess drills are in ``test_torch_pod_drills.py`` (fake-pod
workers), ``test_torch_pod_chaos.py`` (``chaos --pod 2``) and
``test_torch_pod_grid.py`` (a grid of two gloo ranks).
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

import fixtures as fx
from sartsolver_tpu.io.solution import ResumeState as JResumeState
from sartsolver_tpu.parallel import multihost as jmh
from sartsolver_tpu.resilience import chaos as jchaos
from sartsolver_tpu.resilience import faults as jfaults
from sartsolver_tpu.resilience import podckpt as jpodckpt

from sartsolver_tpu_torch.cli import main as torch_main
from sartsolver_tpu_torch.config import SartInputError, SolverOptions
from sartsolver_tpu_torch.io.solution import ResumeState
from sartsolver_tpu_torch.obs import metrics, sinks
from sartsolver_tpu_torch.parallel import multihost as mh
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
from sartsolver_tpu_torch.resilience import faults, podckpt
from sartsolver_tpu_torch.resilience.chaos import PodSchedule
from sartsolver_tpu_torch.resilience.retry import reset_retry_stats
from sartsolver_tpu_torch.sched import ContinuousBatcher

POD_ENV = ("SART_POD_PROCESS", "SART_POD_BARRIER_DIR", "SART_POD_BARRIER_TIMEOUT",
           "SART_FAULT")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for key in POD_ENV:
        monkeypatch.delenv(key, raising=False)
    for mod in (faults, jfaults):
        mod.reset()
    yield
    for mod in (faults, jfaults):
        mod.reset()
    reset_retry_stats()


# ---------------------------------------------------------------------------
# identity and deadline

@pytest.mark.parametrize("raw", [None, "1/3", "2", "x/y", "0/1", "3/0", "5/"])
def test_pod_identity_env_forms_match_jax(monkeypatch, raw):
    if raw is not None:
        monkeypatch.setenv("SART_POD_PROCESS", raw)
    assert mh.pod_identity() == jmh.pod_identity()
    assert faults.pod_index() == jfaults.pod_index()


def test_pod_identity_forms():
    assert mh.pod_identity() == (0, 1)  # no group, no variable
    os.environ["SART_POD_PROCESS"] = "1/3"
    try:
        assert mh.pod_identity() == (1, 3)
        assert mh.export_pod_identity() == (1, 3)  # already set: left as it is
        assert os.environ["SART_POD_PROCESS"] == "1/3"
    finally:
        del os.environ["SART_POD_PROCESS"]
    assert mh.export_pod_identity() == (0, 1)
    assert "SART_POD_PROCESS" not in os.environ  # a lone process publishes nothing


@pytest.mark.parametrize("raw", [None, "12.5", "0", "-4", "soon"])
def test_barrier_timeout_env_matches_jax(monkeypatch, capsys, raw):
    if raw is not None:
        monkeypatch.setenv("SART_POD_BARRIER_TIMEOUT", raw)
    ours = mh.barrier_timeout()
    our_err = capsys.readouterr().err
    assert ours == jmh.barrier_timeout()
    assert our_err == capsys.readouterr().err
    assert ours == {None: 300.0, "12.5": 12.5, "0": 0.0, "-4": 0.0, "soon": 300.0}[raw]
    assert ("SART_POD_BARRIER_TIMEOUT" in our_err) == (raw == "soon")


@pytest.mark.parametrize("missing", [[1, 2], [0], []])
def test_timeout_message_matches_jax(missing):
    ours = mh.PodBarrierTimeout("stride.4", missing, 0.6)
    theirs = jmh.PodBarrierTimeout("stride.4", missing, 0.6)
    assert str(ours) == str(theirs)
    assert ours.missing == theirs.missing and ours.name == "stride.4"
    failed = mh.PodBarrierTimeout("agree_stop", [], 10, cause="RuntimeError: reset")
    assert str(failed) == ("pod barrier 'agree_stop' failed (RuntimeError: reset); missing "
                           "host(s): unknown (collective failed)")


# ---------------------------------------------------------------------------
# the file barrier

def test_file_barrier_exchanges_payloads(tmp_path):
    rows = [None, None]

    def arrive(k):
        rows[k] = mh._file_barrier(str(tmp_path), "b.one", k, 2, {"host": k}, 30)

    threads = [threading.Thread(target=arrive, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert rows[0] == rows[1] == [{"host": 0}, {"host": 1}]


def test_file_barrier_meets_a_jax_host(tmp_path):
    """A port host and a JAX host in one directory: the same files, the
    same rows."""
    rows = {}

    def ours():
        rows["port"] = mh._file_barrier(str(tmp_path), "mixed", 0, 2, [0.5, "a"], 30)

    t = threading.Thread(target=ours)
    t.start()
    rows["jax"] = jmh._file_barrier(str(tmp_path), "mixed", 1, 2, {"k": 1}, 30)
    t.join(timeout=30)
    assert not t.is_alive()
    assert rows["port"] == rows["jax"] == [[0.5, "a"], {"k": 1}]
    assert sorted(os.listdir(tmp_path)) == ["alive.h0", "alive.h1", "mixed.h0.json",
                                            "mixed.h1.json"]


def test_file_barrier_names_dead_host(tmp_path):
    """A peer that never arrived and has no liveness beacon is dead at the
    deadline, named, and counted."""
    counter = metrics.get_registry().counter("pod_barrier_timeouts_total")
    before = counter.value
    start = time.monotonic()
    with pytest.raises(mh.PodBarrierTimeout) as err:
        mh._file_barrier(str(tmp_path), "b.dead", 0, 3, None, 0.6)
    elapsed = time.monotonic() - start
    assert err.value.missing == [1, 2]
    assert str(err.value) == str(jmh.PodBarrierTimeout("b.dead", [1, 2], 0.6))
    assert 0.5 <= elapsed < 5.0  # the deadline, not the 4x cap
    assert counter.value == before + 1


def test_file_barrier_fresh_beacon_extends_wait(tmp_path):
    """A missing peer whose beacon stays fresh extends the wait past the
    deadline; once it goes stale the barrier gives up, within the 4x cap."""
    bdir = str(tmp_path)
    stop = time.monotonic() + 0.9

    def beacon():
        while time.monotonic() < stop:
            mh._touch_alive(bdir, 1)
            time.sleep(0.1)

    t = threading.Thread(target=beacon, daemon=True)
    t.start()
    start = time.monotonic()
    with pytest.raises(mh.PodBarrierTimeout) as err:
        mh._file_barrier(bdir, "b.slow", 0, 2, None, 0.4)
    elapsed = time.monotonic() - start
    t.join(timeout=10)
    assert err.value.missing == [1]
    assert 0.8 <= elapsed < 4 * 0.4 + 2.0


def test_file_barrier_torn_payload_is_none_row(tmp_path):
    with open(tmp_path / "b.torn.h1.json", "w") as f:
        f.write('{"half')
    assert mh._file_barrier(str(tmp_path), "b.torn", 0, 2, {"ok": 1}, 5) == [{"ok": 1}, None]


def test_pod_barrier_single_process_no_io(monkeypatch, tmp_path):
    monkeypatch.setenv("SART_POD_BARRIER_DIR", str(tmp_path))
    assert mh.pod_barrier("solo", payload=7) == jmh.pod_barrier("solo", payload=7) == [7]
    assert os.listdir(tmp_path) == []


def test_pod_barrier_no_seam_degrades_local(monkeypatch):
    monkeypatch.setenv("SART_POD_PROCESS", "0/2")
    assert mh.pod_barrier("degraded", payload=5) == jmh.pod_barrier("degraded", payload=5) \
        == [5, None]


def test_pod_barrier_fires_its_fault_site(monkeypatch, tmp_path):
    monkeypatch.setenv("SART_POD_PROCESS", "0/2")
    monkeypatch.setenv("SART_POD_BARRIER_DIR", str(tmp_path))
    monkeypatch.setenv("SART_FAULT", "pod.barrier:error:1:1")
    faults.reset()
    with pytest.raises(faults.InjectedFault, match="pod.barrier"):
        mh.pod_barrier("faulted")
    assert os.listdir(tmp_path) == []  # fired before the arrival


def test_agree_stop_file_mode(monkeypatch, tmp_path):
    bdir = str(tmp_path)
    monkeypatch.setenv("SART_POD_PROCESS", "0/2")
    monkeypatch.setenv("SART_POD_BARRIER_DIR", bdir)
    monkeypatch.setenv("SART_POD_BARRIER_TIMEOUT", "10")
    monkeypatch.setattr(mh, "_stop_seq", 0)
    with open(os.path.join(bdir, "agree_stop.1.h1.json"), "w") as f:
        f.write("1")  # the peer votes stop at the first boundary
    assert mh.agree_stop(False) is True
    with open(os.path.join(bdir, "agree_stop.2.h1.json"), "w") as f:
        f.write("0")
    assert mh.agree_stop(False) is False
    with open(os.path.join(bdir, "agree_stop.2.h0.json")) as f:
        assert json.load(f) == 0  # this host's vote, in the numbered exchange


def test_agree_stop_lone_process():
    assert mh.agree_stop(True) is True and mh.agree_stop(False) is False


def test_install_pod_liveness_refreshes_the_beacon(monkeypatch, tmp_path):
    from sartsolver_tpu_torch.resilience import watchdog

    monkeypatch.setenv("SART_POD_PROCESS", "1/2")
    monkeypatch.setenv("SART_POD_BARRIER_DIR", str(tmp_path / "bar"))
    try:
        mh.install_pod_liveness()
        path = tmp_path / "bar" / "alive.h1"
        first = path.read_text()
        time.sleep(mh._ALIVE_THROTTLE + 0.05)
        watchdog.beacon("prefetch")
        assert float(path.read_text()) > float(first)
    finally:
        watchdog.remove_beacon_tap("pod.liveness")


# ---------------------------------------------------------------------------
# the deadline collective

def test_deadline_collective_times_out_and_maps_failures():
    with pytest.raises(mh.PodBarrierTimeout) as err:
        mh._deadline_collective("wedged", lambda: time.sleep(5), 0.3)
    assert err.value.missing == [] and "timed out after 0.3s" in str(err.value)

    def fails():
        raise RuntimeError("Connection closed by peer")

    with pytest.raises(mh.PodBarrierTimeout, match="Connection closed by peer"):
        mh._deadline_collective("lost", fails, 5)
    with pytest.raises(ValueError):  # not the backend's: raised as it is
        mh._deadline_collective("bug", lambda: int("x"), 5)
    assert mh._deadline_collective("inline", lambda: 41 + 1, 0) == 42
    assert mh._deadline_collective("threaded", lambda: 7, 5) == 7


def test_deadline_collective_thread_stages_on_the_callers_card(monkeypatch):
    """The CUDA current device is per thread: under NCCL the rendezvous
    thread must stage its bytes on the caller's card (``cuda:LOCAL_RANK``),
    not on a new thread's ``cuda:0``. Faked here with a per-thread device."""
    import torch

    from sartsolver_tpu_torch.parallel import comm

    local = threading.local()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: getattr(local, "dev", 0))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: setattr(local, "dev", d))
    torch.cuda.set_device(1)
    host = torch.zeros(1, dtype=torch.uint8)
    for timeout in (5, 0):
        got = mh._deadline_collective("where", lambda: comm._backend_device("nccl", host),
                                      timeout)
        assert got == torch.device("cuda", 1)
    assert comm._backend_device("gloo", host) == torch.device("cpu")


# ---------------------------------------------------------------------------
# the site@i qualifier

@pytest.mark.parametrize("here,spec", [
    ("1/2", "io.flush@1:io:1"), ("1/2", "io.flush@0:io:1"), (None, "io.flush@0:io:1"),
    ("0/2", "pod.barrier@0:hang:1:1,io.flush@1:io:1"),
    ("1/2", "multihost.init@1:error:1,multihost.init@0:io:1"),
])
def test_fault_pod_qualifier_arms_only_target(monkeypatch, here, spec):
    if here is not None:
        monkeypatch.setenv("SART_POD_PROCESS", here)
    ours, theirs = faults.parse_fault_spec(spec), jfaults.parse_fault_spec(spec)
    assert {k: (f.kind, f.prob, f.count) for k, f in ours.items()} \
        == {k: (f.kind, f.prob, f.count) for k, f in theirs.items()}
    target = int(spec.split("@")[1].split(":")[0])
    armed_here = target == (0 if here is None else int(here.split("/")[0]))
    assert (spec.split("@")[0] in ours) == armed_here


@pytest.mark.parametrize("bad", ["io.flsh@1:io:1", "io.flush@x:io:1", "io.flush@-1:io:1",
                                 "io.flush@1:meteor:1", "io.flush@1:io:3"])
def test_fault_pod_qualifier_validates_on_every_host(monkeypatch, bad):
    monkeypatch.setenv("SART_POD_PROCESS", "0/2")
    with pytest.raises(ValueError) as ours:
        faults.parse_fault_spec(bad)
    with pytest.raises(ValueError) as theirs:
        jfaults.parse_fault_spec(bad)
    assert str(ours.value) == str(theirs.value)


def test_fault_sites_equal_jax():
    assert faults.FAULT_SITES == jfaults.FAULT_SITES
    assert faults.SITE_MULTIHOST_INIT == jfaults.SITE_MULTIHOST_INIT
    assert faults.SITE_POD_BARRIER == jfaults.SITE_POD_BARRIER


# ---------------------------------------------------------------------------
# per-host checkpoint files

def _state(serial):
    return {"serial": serial, "lanes": np.arange(4.0) * serial}


@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 4), (3, 4)])
def test_host_path_matches_jax(index, count):
    assert podckpt.host_path("base", index, count) == jpodckpt.host_path("base", index, count)
    assert podckpt.SolveCheckpointStore("b", index, count).path \
        == jpodckpt.SolveCheckpointStore("b", index, count).path


def test_newest_consistent_serial(tmp_path):
    base = str(tmp_path / "pod.ck")
    h0 = podckpt.SolveCheckpointStore(base, 0, 2)
    h1 = podckpt.SolveCheckpointStore(base, 1, 2)
    for serial in (1, 2, 3):
        h0.save(serial, _state(serial))
    h1.save(1, _state(1))
    h1.save(2, _state(2))
    assert podckpt.newest_consistent_serial(base, 2) == 2  # h1 died before 3
    with open(h1.path, "rb+") as f:  # a torn tail on h1's newest
        blob = f.read()
        f.seek(0)
        f.truncate()
        f.write(blob[:-10])
    assert podckpt.newest_consistent_serial(base, 2) == 1
    assert podckpt.newest_consistent_serial(base, 3) is None  # a host without a file
    podckpt.SolveCheckpointStore(base).save(9, _state(9))
    assert podckpt.newest_consistent_serial(base, 1) == podckpt.newest_consistent_serial(base) \
        == 9


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_per_host_files_cross_packages(tmp_path, writer):
    """Each package's per-host files read by the other: the same serials,
    the same states, the same pod-wide resume point."""
    base = str(tmp_path / "pod.ck")
    w, r = (podckpt, jpodckpt) if writer == "port" else (jpodckpt, podckpt)
    for k, serials in enumerate(((2, 4, 6), (2, 4))):
        store = w.SolveCheckpointStore(base, k, 2)
        for serial in serials:
            store.save(serial, _state(serial))
    assert r.newest_consistent_serial(base, 2) == w.newest_consistent_serial(base, 2) == 4
    for k in range(2):
        theirs = r.SolveCheckpointStore(base, k, 2)
        assert theirs.serials() == w.SolveCheckpointStore(base, k, 2).serials()
        got = theirs.load(4)
        assert got["serial"] == 4 and got["lanes"].tobytes() == _state(4)["lanes"].tobytes()


# ---------------------------------------------------------------------------
# the campaign's schedule

@pytest.mark.parametrize("size", [2, 3, 4])
def test_pod_schedule_matches_jax(size):
    assert PodSchedule.WINDOWS == jchaos.PodSchedule.WINDOWS
    for seed in range(32):
        ours, theirs = PodSchedule(seed, size=size), jchaos.PodSchedule(seed, size=size)
        assert (ours.victim, ours.window, ours.occurrence) \
            == (theirs.victim, theirs.window, theirs.occurrence)
        assert ours.describe() == theirs.describe()
    assert {PodSchedule(s, size=size).window for s in range(32)} == {"stride", "ckpt"}


# ---------------------------------------------------------------------------
# the resume view on one process

@pytest.mark.parametrize("case", ["state", "none", "error"])
def test_broadcast_resume_state_one_process_matches_jax(case):
    times = np.array([0.1, 0.2 + 1e-17, 5e-324])
    last = np.array([np.pi, -0.0, 1e-300])
    if case == "error":
        with pytest.raises(SartInputError, match="cannot read"):
            mh.broadcast_resume_state(None, 3, error="cannot read")
        from sartsolver_tpu.config import SartInputError as JSartInputError

        with pytest.raises(JSartInputError, match="cannot read"):
            jmh.broadcast_resume_state(None, 3, error="cannot read")
        return
    ours = mh.broadcast_resume_state(ResumeState(times, last) if case == "state" else None, 3)
    theirs = jmh.broadcast_resume_state(
        JResumeState(times, last) if case == "state" else None, 3)
    if case == "none":
        assert ours is None and theirs is None
        return
    assert ours.times.tobytes() == theirs.times.tobytes() == times.tobytes()
    assert ours.last_solution.tobytes() == theirs.last_solution.tobytes() == last.tobytes()


# ---------------------------------------------------------------------------
# the scheduler's stride barrier

def test_stride_barrier_meets_every_stride_after_its_checkpoint():
    rng = np.random.default_rng(3)
    H = rng.uniform(0.0, 1.0, (24, 16))
    G = rng.uniform(0.5, 1.5, (6, 16)) @ H.T
    events = []
    with DistributedSARTSolver(H, None, opts=SolverOptions.cpu_parity(
            max_iterations=12, conv_tolerance=1e-14, schedule_stride=4),
            device="cpu") as solver:
        batcher = ContinuousBatcher(
            solver, lanes=2, on_result=lambda *r: None,
            ckpt_stride=2, ckpt_sink=lambda serial, snap: events.append(("ckpt", serial)),
            stride_barrier=lambda serial: events.append(("barrier", serial)))
        stats = batcher.run((frame, float(t), [float(t)]) for t, frame in enumerate(G))
    barriers = [s for kind, s in events if kind == "barrier"]
    assert barriers == list(range(1, stats.strides + 1))
    for i, (kind, serial) in enumerate(events):
        if kind == "ckpt":  # the checkpoint first, then the rendezvous
            assert serial % 2 == 0 and events[i + 1] == ("barrier", serial)


# ---------------------------------------------------------------------------
# the process group's start under its retry policy, through the CLI

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("count,want", [(1, 0), (5, 3)])
def test_multihost_init_retries_then_exit_3(tmp_path, monkeypatch, capsys, count, want):
    paths = fx.write_world(str(tmp_path), with_laplacian=False)[0]
    monkeypatch.setenv("SART_RETRY_BASE_DELAY", "0.001")
    monkeypatch.setenv("SART_FAULT", f"multihost.init:error:1:{count}")
    for key, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(key, value)
    faults.reset()
    rc = torch_main(["-o", str(tmp_path / "mi.h5"), paths["rtm_a1"], paths["rtm_a2"],
                     paths["rtm_b"], paths["img_a"], paths["img_b"], "--use_cpu", "-m", "20",
                     "--multihost"])
    err = capsys.readouterr().err
    assert rc == want, err
    if want == 3:
        assert "Unrecoverable after retries: multihost.init" in err
    assert faults.fault_trips()["multihost.init"] == min(count, 3)


def test_help_text_names_the_timeout_counter():
    assert "pod_barrier_timeouts_total" in sinks._HELP
