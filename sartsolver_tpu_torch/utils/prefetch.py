"""Frame prefetcher: read the next frames while the device solves.

Counterpart of ``sartsolver_tpu/utils/prefetch.py``. The reference reads a
frame, solves it, and reads the next (main.cpp:131-140); here a worker
thread stays up to ``depth`` frames ahead in the composite stream, so a
frame's read hides behind the previous frame's solve, and at most ``depth``
frames wait in host memory.

Each frame read runs under the ``prefetch.next`` retry policy
(``resilience/retry.py``): a transient I/O error costs one backoff. When the
retries are exhausted:

- ``isolate_failures=False`` (the library default): the stream ends and the
  error is raised on the consumer's side;
- ``isolate_failures=True`` (the CLI without ``--fail_fast``): a
  :class:`~sartsolver_tpu_torch.resilience.failures.FrameFailure` takes the
  frame's place (its times come from the alignment tables, no I/O) and the
  stream goes on, so one dead frame costs one FAILED row.

Each read is a hang-watchdog ``prefetch`` beacon, and the worker is
registered as interruptible: a read that hangs is interrupted with
``WatchdogTimeout`` at the watchdog's second stage, and with
``isolate_failures`` becomes a FrameFailure like an exhausted read.

Telemetry: ``prefetch_queue_depth`` (the queue's high-water mark),
``frames_prefetched_total`` and ``bytes_ingested_total{source="frames"}``;
each read is a ``prefetch.read`` trace span.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

from sartsolver_tpu_torch.io.image import CompositeImage
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.obs import trace as obs_trace
from sartsolver_tpu_torch.resilience import faults, watchdog
from sartsolver_tpu_torch.resilience.failures import FrameFailure, WatchdogTimeout
from sartsolver_tpu_torch.resilience.retry import RetriesExhausted, RetryPolicy, retry_call


class FramePrefetcher:
    """Iterates ``(frame, time, camera_times)`` ahead of the consumer (and,
    with ``isolate_failures``, :class:`FrameFailure` items).

    Use it as a context manager (or call :meth:`close`) where the consumer
    may stop early, so the worker is released rather than left blocked on a
    full queue.
    """

    def __init__(self, composite: CompositeImage, depth: int = 2, *,
                 isolate_failures: bool = False,
                 retry_policy: Optional[RetryPolicy] = None):
        if depth < 1:
            raise ValueError("Prefetch depth must be positive.")
        self._composite = composite
        self._isolate = isolate_failures
        self._policy = retry_policy
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        registry = obs_metrics.get_registry()
        self._depth_gauge = registry.gauge("prefetch_queue_depth")
        self._frames_counter = registry.counter("frames_prefetched_total")
        self._bytes_counter = registry.counter("bytes_ingested_total", source="frames")
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        # registered before it starts: no beacon of it outruns the entry
        watchdog.register_interruptible(self._thread)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up once close() is asked for."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _read_frame(self, i: int):
        """One retried frame read (the retry unit is the whole cache fill,
        which leaves no partial state when it fails)."""

        def attempt():
            faults.fire(faults.SITE_PREFETCH)
            frame = self._composite.frame(i)
            return (frame, self._composite.frame_time(i),
                    self._composite.camera_frame_time(i))

        return retry_call(attempt, site=faults.SITE_PREFETCH, policy=self._policy,
                          retry_on=(OSError,))

    def _worker(self) -> None:
        try:
            for i in range(len(self._composite)):
                if self._stop.is_set():
                    return
                watchdog.beacon(watchdog.PHASE_PREFETCH)
                try:
                    with obs_trace.span("prefetch.read", frame=i):
                        item = self._read_frame(i)
                    self._frames_counter.inc()
                    self._bytes_counter.inc(item[0].nbytes)
                except (RetriesExhausted, WatchdogTimeout) as err:
                    # unreadable, or a read that hung and was interrupted:
                    # the frame's times are host memory, so a FAILED row
                    if not self._isolate:
                        raise
                    item = FrameFailure(None, self._composite.frame_time(i),
                                        self._composite.camera_frame_time(i), err)
                if not self._put(item):
                    return
                self._depth_gauge.set_max(self._queue.qsize())
        except BaseException as err:  # raised on the consumer's side
            self._error = err
        finally:
            self._put(None)

    def close(self) -> None:
        """Stop the worker and drop the queued frames."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        watchdog.unregister_interruptible(self._thread)

    def __enter__(self) -> "FramePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> Iterator:
        while True:
            item = self._queue.get()
            if item is None:
                if self._error is not None:
                    raise self._error
                return
            yield item
