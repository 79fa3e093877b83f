"""Failure taxonomy: statuses, exceptions, exit codes, the run summary.

Counterpart of ``sartsolver_tpu/resilience/failures.py``. The status codes
beyond the solver's own (``config.py``: 0 converged, -1 at the iteration
cap, -2 diverged) are the JAX package's pipeline codes, so an artifact or
a solution file of either package reads the same:

- ``-3`` FRAME_FAILED: the frame produced no solution (its read's retries
  were exhausted, or its staging or solve dispatch failed with a
  recoverable error); the row holds zeros and ``iterations = -1``;
- ``-4`` SDC_DETECTED: the in-solve integrity check (``--integrity``)
  tripped on the frame; the CLI re-solves it once and writes a frame that
  trips again as FAILED;
- ``-5`` DEADLINE_EXCEEDED, which only a serving engine writes.

Exit codes of the CLI: 0 every frame converged or at the cap; 1 an input
or flag error; 2 (``EXIT_PARTIAL``) the run completed with DIVERGED or
FAILED frames; 3 (``EXIT_INFRASTRUCTURE``) the run aborted on an
unrecoverable infrastructure failure (the RTM ingest's retries exhausted, a
solution-file flush failed, the hang watchdog aborted, the integrity layer
quarantined the run); 4 (``EXIT_INTERRUPTED``) a SIGTERM or SIGINT stopped
the run at a frame-group boundary, the file resumable.

What per-frame isolation may absorb into a FAILED row is
:data:`RECOVERABLE_FRAME_ERRORS`: I/O errors, injected faults, exhausted
retries, a hung frame the watchdog interrupted (:class:`WatchdogTimeout`)
and a device out-of-memory (``torch.cuda.OutOfMemoryError``, the
counterpart of the JAX package's ``JaxRuntimeError``) — and nothing wider.
A CUDA extension that fails to build or load, a kernel plan the extension
refuses, a sticky CUDA error or an internal bug fails the run.

The module loads with the standard library alone (the observability layer
imports it): :data:`RECOVERABLE_FRAME_ERRORS` is made, with torch, on first
use.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

from sartsolver_tpu_torch.config import DIVERGED, MAX_ITERATIONS_EXCEEDED, SUCCESS

FRAME_FAILED = -3
SDC_DETECTED = -4
DEADLINE_EXCEEDED = -5

EXIT_OK = 0
EXIT_INPUT_ERROR = 1
EXIT_PARTIAL = 2
EXIT_INFRASTRUCTURE = 3
EXIT_INTERRUPTED = 4


class OutputWriteError(RuntimeError):
    """A solution-file flush failed mid-run. Not an ``OSError``, so the CLI
    maps it to EXIT_INFRASTRUCTURE and not to the input-error exit."""


class WatchdogTimeout(RuntimeError):
    """Raised into a stuck thread by the hang watchdog
    (``resilience/watchdog.py``) once the progress beacons stalled past
    ``SART_WATCHDOG_TIMEOUT``. Defined here so the taxonomy owns every
    member of RECOVERABLE_FRAME_ERRORS: an interrupted staging or dispatch
    becomes a FAILED row, as the injected faults it stands in for do."""


class IntegrityError(RuntimeError):
    """A frame's silent-data-corruption detection survived its recompute;
    the frame becomes a FAILED row with this as its recorded error
    (``resilience/integrity.py``)."""


class PersistentCorruptionError(RuntimeError):
    """Corruption a recompute cannot clear: the resident matrix (or its
    staging) is wrong, so every further solve is poisoned. The CLI exits
    EXIT_INFRASTRUCTURE (the file stays resumable) after a quarantine
    event."""


class FrameFailure(NamedTuple):
    """A frame the prefetcher could not deliver (its read's retries were
    exhausted). Shaped like the ``(frame, time, camera_times)`` stream
    items, ``frame`` None; the frame loops record a FAILED row for it."""

    frame: None
    time: float
    camera_times: List[float]
    error: BaseException


def __getattr__(name: str):
    # RECOVERABLE_FRAME_ERRORS, made on first use: it names torch's OOM
    # error and the injected faults (numpy), which this module does not
    # load at import
    if name == "RECOVERABLE_FRAME_ERRORS":
        import torch

        from sartsolver_tpu_torch.resilience.faults import InjectedFault
        from sartsolver_tpu_torch.resilience.retry import RetriesExhausted

        value = (
            OSError,  # includes InjectedIOError and real I/O errors
            InjectedFault,  # includes InjectedOOM
            RetriesExhausted,
            WatchdogTimeout,  # a hung frame interrupted by the watchdog
            torch.cuda.OutOfMemoryError,  # a device OOM the ladder did not absorb
        )
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def status_name(status: int) -> str:
    return {
        SUCCESS: "converged",
        MAX_ITERATIONS_EXCEEDED: "max-iterations",
        DIVERGED: "diverged",
        FRAME_FAILED: "failed",
        SDC_DETECTED: "sdc",
        DEADLINE_EXCEEDED: "deadline",
    }.get(int(status), f"unknown({int(status)})")


class RunSummary:
    """End-of-run accounting of per-frame outcomes, retry activity and
    availability events."""

    def __init__(self) -> None:
        self.counts = {SUCCESS: 0, MAX_ITERATIONS_EXCEEDED: 0,
                       DIVERGED: 0, FRAME_FAILED: 0, SDC_DETECTED: 0}
        self.failed_times: List[float] = []
        # availability events (OOM degradations, watchdog fires, stop
        # requests, quarantines): one-liners appended by their owners (the
        # watchdog's monitor thread too: a list append is atomic) and echoed
        # verbatim in format()
        self.events: List[str] = []
        # in-solve SDC detections (--integrity), before their recompute,
        # and the frames re-solved for them
        self.sdc_detected = 0
        self.sdc_recomputed = 0

    def record_status(self, status: int, time: Optional[float] = None) -> None:
        status = int(status)
        self.counts[status] = self.counts.get(status, 0) + 1
        if (status in (DIVERGED, FRAME_FAILED, SDC_DETECTED)
                and time is not None):
            self.failed_times.append(float(time))

    def record_event(self, event: str) -> None:
        self.events.append(str(event))

    def record_sdc(self, detected: int = 0, recomputed: int = 0) -> None:
        self.sdc_detected += int(detected)
        self.sdc_recomputed += int(recomputed)

    @property
    def n_frames(self) -> int:
        return sum(self.counts.values())

    @property
    def n_failed(self) -> int:
        return (self.counts[DIVERGED] + self.counts[FRAME_FAILED]
                + self.counts[SDC_DETECTED])

    def had_retries(self) -> bool:
        return any(v["recoveries"] or v["exhausted"] for v in _retry_stats().values())

    def exit_code(self) -> int:
        return EXIT_PARTIAL if self.n_failed else EXIT_OK

    def format(self) -> str:
        parts = [
            f"{n} {status_name(s)}"
            for s, n in sorted(self.counts.items(), reverse=True) if n
        ]
        lines = [
            f"resilience summary: {self.n_frames} frame(s): "
            + ", ".join(parts or ["none"])
        ]
        if self.failed_times:
            shown = ", ".join(f"{t:g}" for t in self.failed_times[:8])
            more = len(self.failed_times) - 8
            lines.append(
                "  failed frame time(s): " + shown
                + (f" (+{more} more)" if more > 0 else "")
            )
        for site, v in sorted(_retry_stats().items()):
            if v["recoveries"] or v["exhausted"]:
                lines.append(
                    f"  retries at {site}: {v['attempts']} attempt(s), "
                    f"{v['recoveries']} recovered, {v['exhausted']} exhausted"
                )
        if self.sdc_detected:
            lines.append(f"  integrity: {self.sdc_detected} SDC detection(s), "
                         f"{self.sdc_recomputed} frame(s) re-solved")
        for event in self.events:
            lines.append(f"  {event}")
        return "\n".join(lines)


def _retry_stats():
    from sartsolver_tpu_torch.resilience.retry import retry_stats

    return retry_stats()


def failed_row(nvoxel: int):
    """The row written for a FAILED frame: zeros (the dataset's fill value);
    its status says what it is."""
    import numpy as np

    return np.zeros(nvoxel, np.float64)
