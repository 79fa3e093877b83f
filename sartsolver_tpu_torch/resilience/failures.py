"""Frame statuses by name and the end-of-run summary that ``--timing``
prints.

Counterpart of ``sartsolver_tpu/resilience/failures.py``'s
:func:`status_name` and :class:`RunSummary`. The status codes beyond the
solver's own (``config.py``: 0 converged, -1 at the iteration cap, -2
diverged) are the JAX package's pipeline codes, named here so that an
artifact of either package reads the same: -3 FRAME_FAILED, -4
SDC_DETECTED, -5 DEADLINE_EXCEEDED. The port writes none of them yet: the
per-frame isolation that writes FAILED rows, and the retry accounting of
the summary, come with ROADMAP queue A item 3.
"""

from __future__ import annotations

from typing import List, Optional

from sartsolver_tpu_torch.config import DIVERGED, MAX_ITERATIONS_EXCEEDED, SUCCESS

FRAME_FAILED = -3
SDC_DETECTED = -4
DEADLINE_EXCEEDED = -5


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
    """End-of-run accounting of per-frame outcomes and availability events."""

    def __init__(self) -> None:
        self.counts = {SUCCESS: 0, MAX_ITERATIONS_EXCEEDED: 0,
                       DIVERGED: 0, FRAME_FAILED: 0, SDC_DETECTED: 0}
        self.failed_times: List[float] = []
        # availability events (OOM degradations): one-liners appended by
        # their owners and echoed verbatim in format()
        self.events: List[str] = []

    def record_status(self, status: int, time: Optional[float] = None) -> None:
        status = int(status)
        self.counts[status] = self.counts.get(status, 0) + 1
        if (status in (DIVERGED, FRAME_FAILED, SDC_DETECTED)
                and time is not None):
            self.failed_times.append(float(time))

    def record_event(self, event: str) -> None:
        self.events.append(str(event))

    @property
    def n_frames(self) -> int:
        return sum(self.counts.values())

    @property
    def n_failed(self) -> int:
        return (self.counts[DIVERGED] + self.counts[FRAME_FAILED]
                + self.counts[SDC_DETECTED])

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
        for event in self.events:
            lines.append(f"  {event}")
        return "\n".join(lines)
