"""Asynchronous solution writer: the solution file written off the loop.

Counterpart of ``sartsolver_tpu/utils/asyncwriter.py``. The reference
writes inside the frame loop (main.cpp:134-135): every
``max_cached_solutions``-th frame pays a flush before the next solve. This
wrapper runs the buffering writer on a worker thread, the output side of
the read / solve / write pipeline whose input side is
``utils/prefetch.py``. (The port's writer rewrites the file whole on each
flush, ``io/solution.py``: the thread hides that cost from the loop, it
does not remove it.)

Order, flush cadence and crash semantics are the wrapped writer's: only the
worker touches the file, and frames are written in submission order. A
solution may be a zero-argument callable (a result's device fetch), which
the worker resolves. A write error is latched and surfaces on the next
``add`` or on ``close``, as a fresh chained wrapper each time
(:class:`DeferredWriteError`, or an
:class:`~sartsolver_tpu_torch.resilience.failures.OutputWriteError` where
that was the cause, keeping the CLI's exit code), so the worker's
traceback stays whole as ``__cause__``. After a latched error no later
frame is written.

Telemetry: ``writer_queue_depth`` (high-water mark),
``frames_written_total`` and ``bytes_written_total``; each write is a
``write.frame`` trace span.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Sequence

import numpy as np

from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.obs import trace as obs_trace
from sartsolver_tpu_torch.resilience.failures import OutputWriteError


class DeferredWriteError(RuntimeError):
    """An asynchronous write failed earlier; ``__cause__`` is the worker's
    exception with its traceback. (A latched ``OutputWriteError`` surfaces
    as an ``OutputWriteError`` instead.)"""


class AsyncSolutionWriter:
    """Runs a :class:`~sartsolver_tpu_torch.io.solution.SolutionWriter` (or
    any object with ``add`` and ``close``) on a worker thread, with at most
    ``max_pending`` frames queued."""

    def __init__(self, writer, max_pending: int = 16):
        if max_pending < 1:
            raise ValueError("max_pending must be positive.")
        self._writer = writer
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=max_pending)
        registry = obs_metrics.get_registry()
        self._depth_gauge = registry.gauge("writer_queue_depth")
        self._frames_counter = registry.counter("frames_written_total")
        self._bytes_counter = registry.counter("bytes_written_total")
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        # a device fetch or a flush that hangs here may be interrupted by
        # the watchdog: the worker latches the WatchdogTimeout like any
        # write error and keeps draining
        from sartsolver_tpu_torch.resilience import watchdog

        watchdog.register_interruptible(self._thread)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            try:
                item = self._queue.get()
            except BaseException as err:
                # interrupted while idle in get(): dying would strand the
                # queue (close() could never hand over its sentinel)
                if self._error is None:
                    self._error = err
                continue
            if item is None:
                return
            if self._error is not None:
                continue  # latched: drain every later frame, write none
            try:
                solution, *rest = item
                with obs_trace.span("write.frame"):
                    if callable(solution):  # a device fetch, run here
                        solution = np.array(solution(), np.float64, copy=True)
                    self._writer.add(solution, *rest)
                self._frames_counter.inc()
                self._bytes_counter.inc(solution.nbytes)
            except BaseException as err:
                self._error = err

    def _check(self) -> None:
        # a fresh chained wrapper per raise: re-raising the latched object
        # would stack each surfacing site onto its traceback
        err = self._error
        if err is None:
            return
        msg = f"asynchronous write failed earlier: {type(err).__name__}: {err}"
        if isinstance(err, OutputWriteError):
            raise OutputWriteError(msg) from err
        raise DeferredWriteError(msg) from err

    def add(self, solution, status: int, time: float, camera_time: Sequence[float],
            iterations: int = -1) -> None:
        """``solution``: an array (copied now: the caller may reuse it) or a
        zero-argument callable returning one, resolved on the worker."""
        self._check()
        if self._closed:
            raise RuntimeError("Writer is closed.")
        payload = (solution if callable(solution)
                   else np.array(solution, np.float64, copy=True))
        self._queue.put((payload, int(status), float(time), list(camera_time),
                         int(iterations)))
        self._depth_gauge.set_max(self._queue.qsize())

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join()
        try:
            self._writer.close()
        except BaseException as err:
            if self._error is None:
                self._error = err
        self._check()

    def __enter__(self) -> "AsyncSolutionWriter":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is not None:
            self._closed = True
            if issubclass(exc[0], KeyboardInterrupt):
                # the caller wants out: drop the queued frames (their device
                # fetches would run on a possibly wedged device); only the
                # write in flight finishes
                try:
                    while True:
                        self._queue.get_nowait()
                except queue.Empty:
                    pass
            # any other failure: write every frame already queued (complete
            # and in order), then close, never masking the error in flight
            self._queue.put(None)
            self._thread.join()
            try:
                self._writer.close()
            except BaseException:
                pass
        else:
            self.close()
