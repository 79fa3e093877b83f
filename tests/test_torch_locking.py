"""The port's lock-order detector (sartsolver_tpu_torch/utils/locking.py)
against the drills of tests/test_concurrency.py: the disabled path's plain
lock, the armed detector's order graph, the deadlock-injection drill (both
stacks and a flight-ring event), hold-time histograms, the race drills over
the port's shared stores, the signal-under-lock drills, and a CLI run whose
rows are byte-equal with SART_LOCK_DEBUG on and off."""

import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest

from sartsolver_tpu_torch.obs import flight as obs_flight
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.utils import locking
from sartsolver_tpu_torch.utils.locking import LockOrderViolation, named_lock

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import fixtures as fx  # noqa: E402


@pytest.fixture
def lock_debug(monkeypatch):
    """The detector armed and a fresh registry whose locks are instrumented
    (the mode latches when a lock is made); a plain-lock registry after."""
    monkeypatch.setenv("SART_LOCK_DEBUG", "1")
    locking.reset_order_state()
    registry = obs_metrics.reset_registry()
    yield registry
    monkeypatch.delenv("SART_LOCK_DEBUG")
    locking.reset_order_state()
    obs_metrics.reset_registry()


@pytest.mark.parametrize("value", ["1", "true", "on"])
def test_debug_switch_takes_the_jax_vocabulary(monkeypatch, value):
    from sartsolver_tpu.utils import env_truthy
    from sartsolver_tpu_torch.resilience import integrity

    monkeypatch.setenv("SART_LOCK_DEBUG", value)
    monkeypatch.setenv("SART_INTEGRITY", value)
    assert locking.debug_enabled() and env_truthy("SART_LOCK_DEBUG")
    assert integrity.env_enabled()  # one vocabulary for every switch
    monkeypatch.setenv("SART_LOCK_DEBUG", "yes")  # not in the vocabulary
    assert not locking.debug_enabled() and not env_truthy("SART_LOCK_DEBUG")


def test_disabled_path_returns_a_plain_lock(monkeypatch):
    monkeypatch.delenv("SART_LOCK_DEBUG", raising=False)
    locking.reset_order_state()
    lock = named_lock("drill.raw")
    assert type(lock) is type(threading.Lock())
    with lock:
        pass
    assert locking.order_graph() == {}


def test_production_lock_sites_are_plain_by_default(monkeypatch):
    monkeypatch.delenv("SART_LOCK_DEBUG", raising=False)
    raw = type(threading.Lock())
    registry = obs_metrics.MetricsRegistry()
    assert type(registry._lock) is raw
    assert type(registry.counter("drill_raw_total")._lock) is raw
    assert type(obs_flight.FlightRecorder(max_events=8)._lock) is raw


def test_instrumented_lock_basics(lock_debug):
    lock = named_lock("drill.basic")
    assert isinstance(lock, locking._InstrumentedLock)
    with lock:
        assert lock.locked()
    assert not lock.locked()
    assert lock.acquire(blocking=False)
    assert not lock.acquire(blocking=False)  # held: False, no raise
    lock.release()


def test_hold_time_histogram_lands_in_the_registry(lock_debug):
    lock = named_lock("drill.hold")
    with lock:
        time.sleep(0.01)
    snaps = [s for s in lock_debug.snapshot()
             if s["name"] == "lock_hold_seconds" and s["labels"].get("lock") == "drill.hold"]
    assert len(snaps) == 1 and snaps[0]["count"] == 1 and snaps[0]["sum"] >= 0.01


def test_order_graph_records_nesting(lock_debug):
    a, b = named_lock("drill.outer"), named_lock("drill.inner")
    with a:
        with b:
            pass
    assert "drill.inner" in locking.order_graph().get("drill.outer", set())


def test_deadlock_injection_drill_trips_the_detector(lock_debug):
    """A thread takes A then B; the main thread then B then A: the
    detector raises before the acquire blocks, names the cycle, carries
    both threads' stacks and leaves a lock_order_violation in the ring."""
    ring = obs_flight.install(obs_flight.FlightRecorder(max_events=64))
    try:
        a, b = named_lock("drill.A"), named_lock("drill.B")

        def establish():
            with a:
                with b:
                    pass

        t = threading.Thread(target=establish, name="drill-establisher", daemon=True)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()
        with b:
            with pytest.raises(LockOrderViolation) as exc:
                a.acquire()
        msg = str(exc.value)
        assert "drill.A" in msg and "drill.B" in msg
        assert "this thread's acquire stack" in msg and "drill-establisher" in msg
        events = [e for e in ring.snapshot() if e["kind"] == "lock_order_violation"]
        assert events and "drill.A" in events[0]["message"]
        assert events[0]["cycle"][0] == events[0]["cycle"][-1]
    finally:
        obs_flight.uninstall()


def test_same_name_reacquire_is_a_violation(lock_debug):
    lock = named_lock("drill.self")
    with lock:
        with pytest.raises(LockOrderViolation):
            lock.acquire()
    with lock:
        pass


def test_cross_thread_release_leaves_no_phantom_hold(lock_debug):
    lock = named_lock("drill.handoff")
    other = named_lock("drill.handoff.other")
    assert lock.acquire()
    t = threading.Thread(target=lock.release, daemon=True)
    t.start()
    t.join(timeout=5)
    assert not lock.locked()
    with lock:
        pass
    with other:
        pass
    assert "drill.handoff.other" not in locking.order_graph().get("drill.handoff", set())


def test_nonblocking_acquire_skips_the_order_check(lock_debug):
    a, b = named_lock("drill.nb.A"), named_lock("drill.nb.B")
    with a:
        with b:
            pass
    with b:
        assert a.acquire(blocking=False)
        a.release()


def _hammer(n_threads, worker):
    errors = []

    def run(k):
        try:
            worker(k)
        except BaseException as err:  # noqa: BLE001 - the drill collects all
            errors.append(err)

    threads = [threading.Thread(target=run, args=(k,), daemon=True) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_metrics_registry_hammer(lock_debug):
    registry = lock_debug

    def worker(k):
        c = registry.counter("hammer_total", thread=str(k))
        h = registry.histogram("hammer_seconds")
        g = registry.gauge("hammer_depth")
        for i in range(200):
            c.inc()
            h.observe(0.001 * i)
            g.set_max(i)
            if i % 50 == 0:
                registry.snapshot()
                registry.snapshot(blocking=False)

    _hammer(8, worker)
    snaps = registry.snapshot()
    assert sum(s["value"] for s in snaps if s["name"] == "hammer_total") == 1600
    assert next(s for s in snaps if s["name"] == "hammer_seconds")["count"] == 1600


def test_flight_ring_hammer(lock_debug):
    ring = obs_flight.FlightRecorder(max_events=128)

    def worker(k):
        for i in range(300):
            ring.record("drill", thread=k, i=i)
            if i % 60 == 0:
                assert isinstance(ring.snapshot(), list)
                assert isinstance(ring.snapshot(blocking=False), list)

    _hammer(8, worker)
    assert ring.total == 2400 and len(ring.snapshot()) == 128


class _FakeComposite:
    def __init__(self, n=64):
        self._n = n

    def __len__(self):
        return self._n

    def frame(self, i):
        return np.full(16, float(i), np.float64)

    def frame_time(self, i):
        return float(i)

    def camera_frame_time(self, i):
        return [float(i)]


def test_prefetcher_close_vs_blocked_put(lock_debug):
    from sartsolver_tpu_torch.utils.prefetch import FramePrefetcher

    pf = FramePrefetcher(_FakeComposite(n=64), depth=1)
    deadline = time.monotonic() + 10
    while pf._queue.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert pf._queue.qsize() >= 1
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_consume_all_under_the_detector(lock_debug):
    from sartsolver_tpu_torch.utils.prefetch import FramePrefetcher

    with FramePrefetcher(_FakeComposite(n=16), depth=2) as frames:
        got = list(frames)
    assert [item[1] for item in got] == [float(i) for i in range(16)]


class _LatchTestWriter:
    def __init__(self):
        self.added = 0
        self.closed = False

    def add(self, solution, *rest):
        self.added += 1
        if self.added == 2:
            time.sleep(0.05)
            raise OSError("injected: output filesystem gone")

    def close(self):
        self.closed = True


def test_asyncwriter_error_latch_vs_concurrent_flush(lock_debug):
    from sartsolver_tpu_torch.utils.asyncwriter import AsyncSolutionWriter, DeferredWriteError

    inner = _LatchTestWriter()
    w = AsyncSolutionWriter(inner, max_pending=8)
    for i in range(4):
        w.add(np.zeros(8, np.float64), 0, float(i), [float(i)])
    with pytest.raises(DeferredWriteError) as exc:
        w.close()
    assert isinstance(exc.value.__cause__, OSError)
    assert not w._thread.is_alive() and inner.closed and inner.added == 2


needs_sigusr1 = pytest.mark.skipif(not hasattr(signal, "SIGUSR1"),
                                   reason="platform has no SIGUSR1")


@needs_sigusr1
@pytest.mark.parametrize("armed", [False, True])
def test_sigusr1_under_a_held_registry_lock_completes(tmp_path, monkeypatch, armed):
    """A status poke landing while the interrupted frame holds the registry
    lock completes through the non-blocking path; armed, the handler's
    releases record no hold time (suppress_instrumentation)."""
    if armed:
        monkeypatch.setenv("SART_LOCK_DEBUG", "1")
    registry = obs_metrics.reset_registry()
    registry.counter("drill_signal_total").inc(7)
    path = str(tmp_path / "status.json")
    prev = obs_flight.install_status_handler(path)
    try:
        registry._lock.acquire()
        try:
            os.kill(os.getpid(), signal.SIGUSR1)
            time.sleep(0)  # a bytecode boundary: the handler runs here
        finally:
            registry._lock.release()
    finally:
        obs_flight.uninstall_status_handler(prev)
        monkeypatch.delenv("SART_LOCK_DEBUG", raising=False)
        obs_metrics.reset_registry()
        locking.reset_order_state()
    rec = json.load(open(path))
    assert rec["type"] == "status"
    assert [m["value"] for m in rec["metrics"] if m["name"] == "drill_signal_total"] == [7.0]


def test_crash_bundle_under_the_ring_lock_completes(tmp_path):
    ring = obs_flight.install(obs_flight.FlightRecorder(max_events=32))
    try:
        ring.record("drill", message="before the wedge")
        path = str(tmp_path / "crash.json")
        ring._lock.acquire()
        try:
            assert obs_flight.write_crash_bundle(path, "drill wedge")
        finally:
            ring._lock.release()
        rec = json.load(open(path))
        assert rec["reason"] == "drill wedge" and any(e["kind"] == "drill" for e in rec["ring"])
    finally:
        obs_flight.uninstall()


def test_cli_rows_byte_equal_with_the_detector_on_and_off(tmp_path, monkeypatch):
    """The port's CLI on the fixture world with SART_LOCK_DEBUG unset and
    set (the registry, made fresh, then holds instrumented locks): the
    solution files are equal byte for byte."""
    from sartsolver_tpu_torch import cli

    paths, *_ = fx.write_world(str(tmp_path))
    inputs = [paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"], paths["img_a"], paths["img_b"]]
    outs = {}
    for armed in (False, True):
        if armed:
            monkeypatch.setenv("SART_LOCK_DEBUG", "1")
        locking.reset_order_state()
        registry = obs_metrics.reset_registry()
        assert isinstance(registry._lock, locking._InstrumentedLock) == armed
        out = str(tmp_path / f"armed{int(armed)}.h5")
        try:
            assert cli.main(["-o", out, *inputs, "--device", "cpu", "-m", "40",
                             "-c", "1e-12", "--no_guess", "--batch_frames", "2"]) == 0
        finally:
            monkeypatch.delenv("SART_LOCK_DEBUG", raising=False)
            obs_metrics.reset_registry()
        outs[armed] = open(out, "rb").read()
    assert outs[True] == outs[False]
    assert locking.order_graph() is not None
