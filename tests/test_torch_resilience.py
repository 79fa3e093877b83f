"""The port's failure handling against the JAX package's (tests/test_resilience.py,
tests/test_io.py's async-writer tests), on the CPU over the fixture world.

- the fault registry (``resilience/faults.py``): the spec, counts, kinds and
  the seeded trip pattern, which equals the JAX registry's encounter for
  encounter;
- retries (``resilience/retry.py``): recovery, exhaustion, internal errors
  passed through, backoff (equal to the JAX policy's delays) and deadline;
- the frame prefetcher and the asynchronous writer (``utils/``);
- the CLI's fault matrix, run through the port's CLI with ``--device cpu``:
  a transient frame-read or RTM-ingest fault recovers with the same file, a
  persistent frame read writes one FAILED row and exits 2, a solve or
  staging fault fails its group and the run goes on (in every frame loop),
  ``--fail_fast`` turns isolation off, an exhausted ingest or a failed flush
  exits 3; an injected ``oom`` drives the halving ladder as a real
  ``torch.cuda.OutOfMemoryError`` does, and a CUDA extension error is never
  absorbed into a FAILED row.
"""

import threading
import time

import h5py
import numpy as np
import pytest
import torch

import fixtures as fx
from sartsolver_tpu.resilience import faults as jfaults
from sartsolver_tpu.resilience import retry as jretry

from sartsolver_tpu_torch.cli import main
from sartsolver_tpu_torch.config import DIVERGED
from sartsolver_tpu_torch.io.solution import SolutionWriter
from sartsolver_tpu_torch.resilience import faults
from sartsolver_tpu_torch.resilience.failures import (
    EXIT_INFRASTRUCTURE, EXIT_PARTIAL, FRAME_FAILED, RECOVERABLE_FRAME_ERRORS, FrameFailure,
    OutputWriteError,
)
from sartsolver_tpu_torch.resilience.retry import (
    RetriesExhausted, RetryPolicy, reset_retry_stats, retry_call, retry_stats,
)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """No armed fault, fresh retry stats and fast backoff, in and after
    every test (both packages' registries)."""
    monkeypatch.setenv("SART_RETRY_BASE_DELAY", "0.001")
    monkeypatch.setenv("SART_RETRY_MAX_DELAY", "0.002")
    for mod in (faults, jfaults):
        mod.clear_faults()
    reset_retry_stats()
    yield
    for mod in (faults, jfaults):
        mod.clear_faults()
    reset_retry_stats()


# ---------------------------------------------------------------------------
# the fault registry

def test_fault_spec_parsing_and_validation():
    armed = faults.parse_fault_spec("hdf5.frame_read:io:1, solve.dispatch:error:0.5:3")
    assert armed["hdf5.frame_read"].kind == "io"
    assert armed["solve.dispatch"].count == 3
    for bad in ("nosuch.site:io:1", "hdf5.frame_read:meteor:1",
                "hdf5.frame_read:io:0", "hdf5.frame_read:io:2",
                "hdf5.frame_read:io", "hdf5.frame_read:io:1:0",
                "io.flush:io:1,io.flush:error:1",
                "multihost.inits:error:1"):  # a real unknown site
        with pytest.raises(ValueError):
            faults.parse_fault_spec(bad)
    assert set(faults.parse_fault_spec("multihost.init:error:1,pod.barrier:hang:1:1")) \
        == {"multihost.init", "pod.barrier"}
    assert faults.FAULT_SITES == {
        "hdf5.frame_read", "hdf5.rtm_ingest", "prefetch.next", "device.put",
        "solve.dispatch", "io.flush", "device.buffer", "solve.checkpoint",
        # the serving engine's four seams
        "request.parse", "journal.append", "session.attach", "state.checkpoint",
        # the pod's: the process group's start and a pod rendezvous
        "multihost.init", "pod.barrier"}
    assert faults.FAULT_SITES == jfaults.FAULT_SITES
    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS


def test_fault_env_round_trip(monkeypatch):
    monkeypatch.setenv("SART_FAULT", "io.flush:io:1:2")
    faults.reset()
    for _ in range(2):
        with pytest.raises(faults.InjectedIOError):
            faults.fire(faults.SITE_FLUSH)
    faults.fire(faults.SITE_FLUSH)  # count 2 spent: no more trips
    assert faults.fault_trips()["io.flush"] == 2
    monkeypatch.delenv("SART_FAULT")
    faults.reset()
    assert faults.fault_trips() == {}


def test_fault_count_and_kinds(monkeypatch):
    faults.inject(faults.SITE_SOLVE, "error", count=1)
    with pytest.raises(faults.InjectedFault):
        faults.fire(faults.SITE_SOLVE)
    faults.fire(faults.SITE_SOLVE)  # capped

    faults.inject(faults.SITE_FRAME_READ, "nan", count=1)
    faults.fire(faults.SITE_FRAME_READ)  # the nan kind never raises
    arr = np.ones((2, 3))
    poisoned = faults.corrupt(faults.SITE_FRAME_READ, arr)
    assert np.isnan(poisoned).any() and not np.isnan(arr).any()
    assert faults.corrupt(faults.SITE_FRAME_READ, arr) is arr  # capped: no copy

    faults.inject(faults.SITE_RTM_INGEST, "corrupt", count=1)
    chunk = np.full((2, 2), 3.0, np.float32)
    hit = faults.corrupt(faults.SITE_RTM_INGEST, chunk)
    want = jfaults.corrupt  # the JAX recipe on the same data
    jfaults.inject(jfaults.SITE_RTM_INGEST, "corrupt", count=1)
    np.testing.assert_array_equal(hit, want(jfaults.SITE_RTM_INGEST, chunk))
    assert hit.dtype == np.float32 and hit[0, 0] == 3.0 * 256 + 1

    faults.inject(faults.SITE_DEVICE_PUT, "oom", count=1)
    with pytest.raises(faults.InjectedOOM, match="out of memory"):
        faults.fire(faults.SITE_DEVICE_PUT)

    monkeypatch.setenv("SART_HANG_RELEASE", "0.05")
    faults.inject(faults.SITE_PREFETCH, "hang", count=1)
    t0 = time.monotonic()
    with pytest.raises(faults.InjectedFault, match="SART_HANG_RELEASE"):
        faults.fire(faults.SITE_PREFETCH)
    assert time.monotonic() - t0 < 5


@pytest.mark.parametrize("seed", ["0", "7"])
def test_fault_probability_is_seeded_like_the_jax_registry(seed, monkeypatch):
    """prob < 1: the same encounters trip in every run and in either
    package (the same per-site seeds)."""
    monkeypatch.setenv("SART_FAULT_SEED", seed)

    def pattern(mod):
        mod.clear_faults()
        mod.inject(mod.SITE_PREFETCH, "io", prob=0.5)
        out = []
        for _ in range(48):
            try:
                mod.fire(mod.SITE_PREFETCH)
                out.append(False)
            except mod.InjectedIOError:
                out.append(True)
        return out

    first = pattern(faults)
    assert first == pattern(faults) == pattern(jfaults)
    assert any(first) and not all(first)


def test_injected_oom_drives_the_ladder_like_a_device_oom():
    """The ``oom`` kind halves the grouped loop's group as a
    ``torch.cuda.OutOfMemoryError`` does, and both are recoverable frame
    errors once the ladder is spent; a CUDA error that is not an OOM is
    neither."""
    from sartsolver_tpu_torch.resilience.degrade import (
        GroupSizeLadder, dispatch_guarded, is_resource_exhausted,
    )

    faults.inject(faults.SITE_SOLVE, "oom", count=2)
    for err in (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
                None):
        ladder = GroupSizeLadder(4)

        def dispatch(err=err):
            if err is not None:
                raise err
            faults.fire(faults.SITE_SOLVE)

        assert dispatch_guarded(dispatch, ladder=ladder)[0] is None and ladder.size == 2
        with pytest.raises(RECOVERABLE_FRAME_ERRORS):
            dispatch_guarded(dispatch, ladder=GroupSizeLadder(1))
    sticky = RuntimeError("CUDA error: an illegal memory access was encountered")
    assert not is_resource_exhausted(sticky)
    assert not isinstance(sticky, RECOVERABLE_FRAME_ERRORS)


# ---------------------------------------------------------------------------
# retries

def test_retry_recovers_after_transient_failure():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert retry_call(flaky, site="hdf5.rtm_ingest",
                      policy=RetryPolicy(attempts=4, base_delay=0),
                      sleep=lambda s: None) == "ok"
    stats = retry_stats()["hdf5.rtm_ingest"]
    assert stats["attempts"] == 3 and stats["recoveries"] == 1


def test_retry_exhaustion_raises_with_cause():
    def dead():
        raise OSError("permanent")

    with pytest.raises(RetriesExhausted) as exc:
        retry_call(dead, site="hdf5.rtm_ingest",
                   policy=RetryPolicy(attempts=3, base_delay=0), sleep=lambda s: None)
    assert isinstance(exc.value.__cause__, OSError)
    assert exc.value.attempts == 3 and not isinstance(exc.value, OSError)
    assert retry_stats()["hdf5.rtm_ingest"]["exhausted"] == 1
    assert str(exc.value) == str(jretry.RetriesExhausted("hdf5.rtm_ingest", 3,
                                                         exc.value.__cause__))


def test_retry_does_not_swallow_internal_errors():
    def bug():
        raise ValueError("internal bug")

    with pytest.raises(ValueError, match="internal bug"):
        retry_call(bug, site="hdf5.rtm_ingest",
                   policy=RetryPolicy(attempts=5, base_delay=0), sleep=lambda s: None)
    assert retry_stats()["hdf5.rtm_ingest"]["attempts"] == 1


def test_retry_backoff_is_exponential_capped_jittered_as_in_jax():
    def dead():
        raise OSError("x")

    delays = {}
    for name, mod in (("port", None), ("jax", jretry)):
        got = delays[name] = []
        call = retry_call if mod is None else mod.retry_call
        policy = (RetryPolicy if mod is None else mod.RetryPolicy)(
            attempts=5, base_delay=0.1, max_delay=0.3, jitter=0.1)
        with pytest.raises(Exception):
            call(dead, site="prefetch.next", policy=policy, sleep=got.append)
    got = delays["port"]
    assert len(got) == 4  # no sleep after the last attempt
    assert 0.09 <= got[0] <= 0.11 and 0.18 <= got[1] <= 0.22
    assert all(d <= 0.3 * 1.1 for d in got) and got[3] <= 0.33
    assert got == delays["jax"]  # one process, one site: the same draws


def test_retry_deadline_gives_up_early(monkeypatch):
    t = {"now": 0.0}
    monkeypatch.setattr(time, "monotonic", lambda: t["now"])

    def dead():
        t["now"] += 40.0
        raise OSError("slow device")

    with pytest.raises(RetriesExhausted) as exc:
        retry_call(dead, site="hdf5.rtm_ingest",
                   policy=RetryPolicy(attempts=10, base_delay=0, deadline=60.0),
                   sleep=lambda s: None)
    assert exc.value.attempts == 2  # 80 s elapsed > the 60 s deadline


def test_retry_policy_from_env(monkeypatch):
    monkeypatch.setenv("SART_RETRY_ATTEMPTS", "5")
    monkeypatch.setenv("SART_RETRY_DEADLINE", "7")
    p = RetryPolicy.from_env()
    assert (p.attempts, p.base_delay, p.max_delay, p.deadline) == (5, 0.001, 0.002, 7.0)


# ---------------------------------------------------------------------------
# the frame prefetcher

def _make_composite(tmp_path, **kw):
    from sartsolver_tpu_torch.io import hdf5files as hf
    from sartsolver_tpu_torch.io.image import CompositeImage

    paths, *_ = fx.write_world(tmp_path, **kw)
    m, i = hf.categorize_input_files([paths[k] for k in
                                      ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b")])
    sm, si = hf.sort_rtm_files(m), hf.sort_image_files(i)
    masks = hf.read_rtm_frame_masks(sm)
    return CompositeImage(si, masks, [(0.0, 10.0, 0.0, 0.0)], fx.NPIXEL)


def test_prefetcher_yields_the_composite_stream(tmp_path):
    from sartsolver_tpu_torch.utils.prefetch import FramePrefetcher

    composite = _make_composite(tmp_path)
    with FramePrefetcher(composite) as frames:
        got = list(frames)
    assert len(got) == len(composite) == 4
    for i, (frame, t, cams) in enumerate(got):
        np.testing.assert_array_equal(frame, composite.frame(i))
        assert t == composite.frame_time(i) and cams == composite.camera_frame_time(i)


def test_prefetcher_surfaces_worker_exception(tmp_path, monkeypatch):
    """A worker error that is not I/O (a bug) ends the stream and raises on
    the consumer's side: the stream is never cut short quietly."""
    from sartsolver_tpu_torch.io.image import CompositeImage
    from sartsolver_tpu_torch.utils.prefetch import FramePrefetcher

    composite = _make_composite(tmp_path)
    orig = CompositeImage.frame

    def broken(self, i=None):
        if i == 2:
            raise ValueError("internal decode bug")
        return orig(self, i)

    monkeypatch.setattr(CompositeImage, "frame", broken)
    got = []
    with FramePrefetcher(composite) as frames:
        with pytest.raises(ValueError, match="internal decode bug"):
            for item in frames:
                got.append(item)
    assert len(got) == 2


def test_prefetcher_close_during_blocked_put(tmp_path):
    from sartsolver_tpu_torch.utils.prefetch import FramePrefetcher

    composite = _make_composite(tmp_path, n_frames=8)
    pf = FramePrefetcher(composite, depth=1)
    deadline = time.monotonic() + 5
    while pf._queue.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pf._queue.qsize() >= 1
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_retries_transient_read(tmp_path):
    from sartsolver_tpu_torch.obs import metrics as obs_metrics
    from sartsolver_tpu_torch.utils.prefetch import FramePrefetcher

    composite = _make_composite(tmp_path)
    faults.inject(faults.SITE_PREFETCH, "io", count=1)
    obs_metrics.reset_registry()
    with FramePrefetcher(composite) as frames:
        got = list(frames)
    assert len(got) == 4 and not any(isinstance(x, FrameFailure) for x in got)
    assert retry_stats()["prefetch.next"]["recoveries"] == 1
    reg = obs_metrics.get_registry()
    assert reg.counter("frames_prefetched_total").value == 4
    assert reg.counter("bytes_ingested_total", source="frames").value == 4 * fx.NPIXEL * 8
    assert 1 <= reg.gauge("prefetch_queue_depth").value <= 2


def test_prefetcher_isolates_exhausted_frame(tmp_path):
    from sartsolver_tpu_torch.utils.prefetch import FramePrefetcher

    policy = RetryPolicy(attempts=2, base_delay=0)
    composite = _make_composite(tmp_path)
    faults.inject(faults.SITE_PREFETCH, "io", count=2)  # frame 0's budget
    with FramePrefetcher(composite, isolate_failures=True, retry_policy=policy) as frames:
        got = list(frames)
    assert len(got) == 4 and isinstance(got[0], FrameFailure)
    assert got[0].time == composite.frame_time(0) and got[0].frame is None
    assert isinstance(got[0].error, RetriesExhausted)
    assert not any(isinstance(x, FrameFailure) for x in got[1:])

    faults.inject(faults.SITE_PREFETCH, "io", count=2)
    with FramePrefetcher(_make_composite(tmp_path), retry_policy=policy) as frames:
        with pytest.raises(RetriesExhausted):
            list(frames)


# ---------------------------------------------------------------------------
# the asynchronous solution writer

def _wait_for_latch(w, timeout=5.0):
    deadline = time.monotonic() + timeout
    while w._error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert w._error is not None


class _Exploding:
    def __init__(self, err):
        self.err = err

    def add(self, *a):
        raise self.err

    def close(self):
        pass


class TestAsyncSolutionWriter:
    @pytest.mark.parametrize("max_pending", [1, 16])
    def test_matches_synchronous_writer(self, tmp_path, max_pending):
        from sartsolver_tpu_torch.utils.asyncwriter import AsyncSolutionWriter

        sols = np.random.default_rng(3).uniform(size=(7, fx.NVOXEL))
        sync_out, async_out = str(tmp_path / "sync.h5"), str(tmp_path / "async.h5")
        with SolutionWriter(sync_out, [fx.CAM_A], fx.NVOXEL, max_cache_size=3) as w:
            for t in range(7):
                w.add(sols[t], -(t % 2), 0.1 * t, [0.1 * t], iterations=t)
        with AsyncSolutionWriter(SolutionWriter(async_out, [fx.CAM_A], fx.NVOXEL,
                                                max_cache_size=3),
                                 max_pending=max_pending) as w:
            for t in range(7):
                w.add(sols[t] if t % 2 else (lambda t=t: sols[t]), -(t % 2), 0.1 * t,
                      [0.1 * t], iterations=t)
        with open(sync_out, "rb") as a, open(async_out, "rb") as b:
            assert a.read() == b.read()

    def test_lazy_callable_solution_resolved_on_worker(self, tmp_path):
        from sartsolver_tpu_torch.utils.asyncwriter import AsyncSolutionWriter

        out = str(tmp_path / "lazy.h5")
        caller, resolved_on = threading.get_ident(), []
        value = np.linspace(0.0, 1.0, fx.NVOXEL)

        def fetch():
            resolved_on.append(threading.get_ident())
            return value

        with AsyncSolutionWriter(SolutionWriter(out, [fx.CAM_A], fx.NVOXEL,
                                                max_cache_size=2)) as w:
            w.add(fetch, 0, 0.5, [0.5])
        with h5py.File(out) as f:
            np.testing.assert_allclose(f["solution/value"][0], value)
        assert resolved_on and resolved_on[0] != caller

    def test_write_error_surfaces_chained(self):
        from sartsolver_tpu_torch.utils.asyncwriter import (
            AsyncSolutionWriter, DeferredWriteError,
        )

        w = AsyncSolutionWriter(_Exploding(OSError("disk full")))
        w.add(np.zeros(4), 0, 0.0, [0.0])
        with pytest.raises(DeferredWriteError, match="disk full") as exc:
            for _ in range(50):
                w.add(np.zeros(4), 0, 0.0, [0.0])
            w.close()
        assert isinstance(exc.value.__cause__, OSError)

    def test_latched_error_traceback_not_stacked_across_raises(self):
        import traceback as tb_mod

        from sartsolver_tpu_torch.utils.asyncwriter import (
            AsyncSolutionWriter, DeferredWriteError,
        )

        w = AsyncSolutionWriter(_Exploding(OSError("disk full")))
        w.add(np.zeros(4), 0, 0.0, [0.0])
        _wait_for_latch(w)

        def surface():
            with pytest.raises(DeferredWriteError) as exc:
                w.add(np.zeros(4), 0, 0.0, [0.0])
            return exc.value

        first, second = surface(), surface()
        assert first is not second and first.__cause__ is second.__cause__
        depth = len(tb_mod.extract_tb(first.__cause__.__traceback__))
        assert len(tb_mod.extract_tb(second.__cause__.__traceback__)) == depth

    def test_output_write_error_cause_keeps_type(self):
        from sartsolver_tpu_torch.utils.asyncwriter import AsyncSolutionWriter

        w = AsyncSolutionWriter(_Exploding(OutputWriteError("flush of x failed; resumable")))
        w.add(np.zeros(4), 0, 0.0, [0.0])
        _wait_for_latch(w)
        with pytest.raises(OutputWriteError, match="resumable") as exc:
            w.add(np.zeros(4), 0, 0.0, [0.0])
        assert isinstance(exc.value.__cause__, OutputWriteError)
        assert exc.value is not exc.value.__cause__

    def test_buffer_copied_before_queueing(self, tmp_path):
        from sartsolver_tpu_torch.utils.asyncwriter import AsyncSolutionWriter

        out = str(tmp_path / "copy.h5")
        buf = np.ones(fx.NVOXEL)
        with AsyncSolutionWriter(SolutionWriter(out, [fx.CAM_A], fx.NVOXEL,
                                                max_cache_size=10)) as w:
            w.add(buf, 0, 0.0, [0.0])
            buf[:] = -99.0
        with h5py.File(out) as f:
            np.testing.assert_array_equal(f["solution/value"][0], np.ones(fx.NVOXEL))

    def test_telemetry(self, tmp_path):
        from sartsolver_tpu_torch.obs import metrics as obs_metrics
        from sartsolver_tpu_torch.utils.asyncwriter import AsyncSolutionWriter

        obs_metrics.reset_registry()
        with AsyncSolutionWriter(SolutionWriter(str(tmp_path / "t.h5"), [fx.CAM_A],
                                                fx.NVOXEL), max_pending=4) as w:
            for t in range(3):
                w.add(np.ones(fx.NVOXEL), 0, float(t), [float(t)])
        reg = obs_metrics.get_registry()
        assert reg.counter("frames_written_total").value == 3
        assert reg.counter("bytes_written_total").value == 3 * fx.NVOXEL * 8
        assert 1 <= reg.gauge("writer_queue_depth").value <= 4


class TestAsyncWriterErrorExit:
    """A consumer failure writes every frame already queued; a
    KeyboardInterrupt drops them."""

    def _run(self, exc_type):
        from sartsolver_tpu_torch.utils.asyncwriter import AsyncSolutionWriter

        gate, entered = threading.Event(), threading.Event()

        class Gated:
            def __init__(self):
                self.added, self.closed = [], False

            def add(self, *a):
                entered.set()
                gate.wait(10)
                self.added.append(a)

            def close(self):
                self.closed = True

        inner = Gated()
        w = AsyncSolutionWriter(inner)
        for t in range(3):
            w.add(np.zeros(4), 0, float(t), [float(t)])
        assert entered.wait(10)
        threading.Timer(2.0, gate.set).start()
        w.__exit__(exc_type, exc_type(), None)
        return inner

    def test_generic_error_writes_queued_frames(self):
        inner = self._run(OSError)
        assert [a[2] for a in inner.added] == [0.0, 1.0, 2.0] and inner.closed

    def test_keyboard_interrupt_drops_queued_frames(self):
        inner = self._run(KeyboardInterrupt)
        assert len(inner.added) <= 1 and inner.closed


# ---------------------------------------------------------------------------
# the CLI's fault matrix, --device cpu

@pytest.fixture
def world(tmp_path):
    return fx.write_world(tmp_path, with_laplacian=True)


def run_cli(paths, *extra, out=None):
    return main(["-o", out or paths["output"], paths["rtm_a1"], paths["rtm_a2"],
                 paths["rtm_b"], paths["img_a"], paths["img_b"], "--device", "cpu",
                 "-m", "300", "-c", "1e-6", *extra])


def _read_out(path):
    with h5py.File(path, "r") as f:
        return (f["solution/value"][:], f["solution/status"][:],
                f["solution/iterations"][:])


def test_cli_frame_read_transient_recovers(world):
    """hdf5.frame_read, recover leg: one torn read is retried; the same
    file, exit 0."""
    paths, *_ = world
    assert run_cli(paths, "--max_cached_frames", "1") == 0
    with open(paths["output"], "rb") as f:
        clean = f.read()
    faults.inject(faults.SITE_FRAME_READ, "io", count=1)
    assert run_cli(paths, "--max_cached_frames", "1") == 0
    with open(paths["output"], "rb") as f:
        assert f.read() == clean
    assert retry_stats()["prefetch.next"]["recoveries"] == 1


@pytest.mark.parametrize("loop", [[], ["--chain_frames", "1"],
                                  ["--no_guess", "--batch_frames", "3"],
                                  ["--no_guess", "--batch_frames", "3",
                                   "--no_continuous_batching"]])
def test_cli_frame_read_persistent_isolated(world, loop, capsys, tmp_path):
    """hdf5.frame_read, degrade leg: the frame's retries spent -> a FAILED
    row (zeros, -1 iterations), the others solve, exit 2, the summary and
    the artifact count it; as the JAX CLI does (its statuses on the same
    fault)."""
    from sartsolver_tpu.cli import main as jax_main

    paths, *_ = world
    art = str(tmp_path / "run.jsonl")
    faults.inject(faults.SITE_FRAME_READ, "io", count=3)  # the retry budget
    rc = run_cli(paths, "--max_cached_frames", "1", "--metrics_out", art, *loop)
    assert rc == EXIT_PARTIAL
    value, status, iters = _read_out(paths["output"])
    assert list(status) == [FRAME_FAILED, 0, 0, 0] and iters[0] == -1
    np.testing.assert_array_equal(value[0], 0.0)
    assert (value[1:] > 0).any()
    out = capsys.readouterr()
    assert "FAILED" in out.err and "resilience summary" in out.out and "1 failed" in out.out
    # three attempts for the dead frame, one each for the others
    assert "retries at prefetch.next: 6 attempt(s), 0 recovered, 1 exhausted" in out.out
    from sartsolver_tpu_torch.obs.schema import load_jsonl

    metrics = {(r["name"], tuple(sorted(r["labels"].items()))): r.get("value")
               for _, r in load_jsonl(art)[0] if r["type"] == "metric"}
    assert metrics[("retry_exhausted_total", (("site", "prefetch.next"),))] == 1
    assert metrics[("fault_trips_total", (("site", "hdf5.frame_read"),))] == 3
    assert metrics[("frame_failures_total", (("error", "RetriesExhausted"),))] == 1
    if not loop:  # the JAX CLI on the same fault
        jfaults.inject(jfaults.SITE_FRAME_READ, "io", count=3)
        jout = str(tmp_path / "jax.h5")
        assert jax_main(["-o", jout, paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"],
                         paths["img_a"], paths["img_b"], "--use_cpu", "-m", "300",
                         "-c", "1e-6", "--max_cached_frames", "1"]) == EXIT_PARTIAL
        np.testing.assert_array_equal(_read_out(jout)[1], status)


def test_cli_frame_read_nan_diverges(world):
    """hdf5.frame_read, corruption leg: a NaN-poisoned frame is DIVERGED
    under --divergence_recovery; the run goes on, exit 2."""
    paths, *_ = world
    faults.inject(faults.SITE_FRAME_READ, "nan", count=1)
    rc = run_cli(paths, "--max_cached_frames", "1", "--divergence_recovery", "2")
    assert rc == EXIT_PARTIAL
    value, status, _ = _read_out(paths["output"])
    assert list(status) == [DIVERGED, 0, 0, 0]
    np.testing.assert_array_equal(value[0], 0.0)


@pytest.mark.parametrize("loop, want", [
    (["--chain_frames", "2"], [FRAME_FAILED, FRAME_FAILED, 0, 0]),
    (["--chain_frames", "1"], [FRAME_FAILED, 0, 0, 0]),
    (["--no_guess", "--batch_frames", "2", "--no_continuous_batching"],
     [FRAME_FAILED, FRAME_FAILED, 0, 0]),
    (["--no_guess", "--batch_frames", "2"], [FRAME_FAILED, FRAME_FAILED, 0, 0]),
])
def test_cli_solve_fault_fails_group_and_continues(world, loop, want, tmp_path):
    """solve.dispatch: a dispatch fault fails exactly its group (FAILED rows,
    in order), later groups solve, exit 2; in the chain the next group
    warm-starts from the last good frame, so its rows equal a run over the
    surviving frames."""
    paths, *_ = world
    faults.inject(faults.SITE_SOLVE, "error", count=1)
    assert run_cli(paths, *loop) == EXIT_PARTIAL
    value, status, iters = _read_out(paths["output"])
    assert list(status) == want
    assert (iters[status == FRAME_FAILED] == -1).all()
    assert (value[2:] > 0).all()
    if loop[0] == "--no_guess":  # independent frames: the healthy run's rows
        clean = str(tmp_path / "clean.h5")
        assert run_cli(paths, *loop, out=clean) == 0
        np.testing.assert_array_equal(_read_out(clean)[0][2:], value[2:])


def test_cli_device_put_fault_isolated(world):
    """device.put: a staging fault is absorbed like a solve fault."""
    paths, *_ = world
    faults.inject(faults.SITE_DEVICE_PUT, "io", count=1)
    assert run_cli(paths, "--chain_frames", "2") == EXIT_PARTIAL
    status = _read_out(paths["output"])[1]
    assert sorted(status)[:2] == [FRAME_FAILED, FRAME_FAILED] and (status == 0).sum() == 2


def test_cli_oom_fault_halves_the_grouped_loop(world, tmp_path, capsys):
    """device.put:oom in the classic loop: the group halves and re-solves
    the same frames; the file equals the run at the halved size."""
    paths, *_ = world
    flags = ["--no_guess", "--no_continuous_batching"]
    half = str(tmp_path / "half.h5")
    assert run_cli(paths, *flags, "--batch_frames", "2", out=half) == 0
    faults.inject(faults.SITE_DEVICE_PUT, "oom", count=1)
    assert run_cli(paths, *flags, "--batch_frames", "4") == 0
    assert "re-solving the same frames at 2" in capsys.readouterr().err
    with open(half, "rb") as a, open(paths["output"], "rb") as b:
        assert a.read() == b.read()


def test_cli_fail_fast_disables_isolation(world):
    """--fail_fast: the first exhausted frame aborts with the infrastructure
    exit code; a solve fault raises."""
    paths, *_ = world
    faults.inject(faults.SITE_FRAME_READ, "io", count=3)
    assert run_cli(paths, "--max_cached_frames", "1", "--fail_fast") == EXIT_INFRASTRUCTURE
    faults.clear_faults()
    faults.inject(faults.SITE_SOLVE, "error", count=1)
    with pytest.raises(faults.InjectedFault):
        run_cli(paths, "--fail_fast")


def test_cli_kernel_error_is_never_a_failed_row(world, monkeypatch):
    """An error of the CUDA extension (a build or load failure, a refused
    plan, a sticky CUDA error) is not recoverable: it fails the run, with
    or without isolation, in every loop."""
    from sartsolver_tpu_torch.ops import fused_sweep as fs

    def broken(*a, **kw):
        raise RuntimeError("fused_sweep: CUDA error: invalid argument")

    monkeypatch.setattr(fs, "fused_sweep_reference", broken)
    paths, *_ = world
    for loop in ([], ["--no_guess", "--batch_frames", "2"]):
        with pytest.raises(RuntimeError, match="invalid argument"):
            run_cli(paths, *loop)


def test_solver_loads_the_extension_at_construction(monkeypatch):
    """On the card the solver builds and loads the fused sweep's extension
    while it is constructed, so a build error fails there, before any frame
    (here: the load is asked for on a stand-in CUDA device)."""
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.ops import _build
    from sartsolver_tpu_torch.parallel import sharded

    asked = []

    def load(name):
        asked.append(name)
        raise RuntimeError("nvcc failed to build fused_sweep.cu")

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(sharded, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(sharded, "make_problem", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sharded.DistributedSARTSolver(np.ones((4, 3), np.float32), opts=SolverOptions(),
                                      device="cuda")
    assert asked == ["fused_sweep"]


def test_cli_flush_fault_exits_3(world, capsys):
    """io.flush: a failed flush of the solution file aborts with the
    infrastructure exit code and the JAX message."""
    paths, *_ = world
    faults.inject(faults.SITE_FLUSH, "io", count=1)
    assert run_cli(paths, "--max_cached_solutions", "1") == EXIT_INFRASTRUCTURE
    assert "resumable" in capsys.readouterr().err


def test_cli_rtm_ingest_transient_recovers(world):
    """hdf5.rtm_ingest, recover leg: a torn chunk read is retried; the same
    file, exit 0."""
    paths, *_ = world
    assert run_cli(paths) == 0
    with open(paths["output"], "rb") as f:
        clean = f.read()
    faults.inject(faults.SITE_RTM_INGEST, "io", count=1)
    assert run_cli(paths, "--rtm_dtype", "float32") == 0
    with open(paths["output"], "rb") as f:
        assert f.read() == clean
    assert retry_stats()["hdf5.rtm_ingest"]["recoveries"] == 1


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_cli_rtm_ingest_exhausted_aborts(world, storage, capsys):
    """hdf5.rtm_ingest, degrade leg: no matrix, no run; exit 3 after the
    retry budget, with the JAX message."""
    paths, *_ = world
    faults.inject(faults.SITE_RTM_INGEST, "io", count=100)
    assert run_cli(paths, "--rtm_dtype", storage) == EXIT_INFRASTRUCTURE
    assert "Unrecoverable after retries: hdf5.rtm_ingest: 3 attempt(s) failed" in \
        capsys.readouterr().err


def test_cli_fault_env_spec(world, monkeypatch):
    """SART_FAULT arms the sites from the environment, as in a drill."""
    paths, *_ = world
    monkeypatch.setenv("SART_FAULT", "solve.dispatch:error:1:1")
    faults.reset()
    assert run_cli(paths, "--chain_frames", "1") == EXIT_PARTIAL
    assert list(_read_out(paths["output"])[1]) == [FRAME_FAILED, 0, 0, 0]
