"""Bounded retry with exponential backoff, jitter, and a per-site deadline.

Counterpart of ``sartsolver_tpu/resilience/retry.py``, whole. HPC
tomography pipelines treat transient I/O stalls as expected events
(arXiv:2003.12677 §4, arXiv:2304.12934): a torn HDF5 read over NFS or a
coordinator that is still coming up usually succeeds on the second
attempt. This module wraps the port's two retried sites (composite frame
reads through the prefetcher, RTM stripe ingest) in a retry loop
that is **bounded three ways** — attempt count, per-attempt backoff
ceiling, and a wall-clock deadline for the whole site — so a *permanent*
failure still surfaces promptly as :class:`RetriesExhausted` for the
caller's degradation path (per-frame isolation, or a clean
infrastructure exit).

Knobs (environment, read per call so tests can monkeypatch):

- ``SART_RETRY_ATTEMPTS`` (default 3): total attempts, 1 = no retry.
- ``SART_RETRY_BASE_DELAY`` (default 0.05 s): first backoff.
- ``SART_RETRY_MAX_DELAY`` (default 2 s): backoff ceiling.
- ``SART_RETRY_DEADLINE`` (default 60 s): give up retrying once this much
  wall clock has elapsed at the site, even with attempts left.

Backoff jitter is seeded per (site, process): the per-process component
is what actually de-synchronizes a pod's hosts retrying the same stripe
(same-site seeds alone would give every host the identical backoff
sequence), while the stable site component keeps the sequences
well-spread across sites within one process. Reproducibility of *trip
patterns* lives in the fault registry (``resilience/faults.py``), which is
seeded stably — retry timing is allowed to vary run-to-run, trip
placement is not.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional, Tuple, Type

import numpy as np


class RetriesExhausted(RuntimeError):
    """Every attempt at a retried site failed; ``__cause__`` is the last
    error. Deliberately NOT an ``OSError``: the CLI maps an escaped
    exhaustion to the infrastructure exit code, not the polite
    input-error exit."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(
            f"{site}: {attempts} attempt(s) failed; last error: "
            f"{type(last).__name__}: {last}"
        )
        self.site = site
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry shape for one site; :meth:`from_env` is the production path."""

    attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.1  # +- fraction of the backoff
    deadline: float = 60.0  # wall-clock budget for all attempts at the site

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(
            attempts=max(1, int(os.environ.get("SART_RETRY_ATTEMPTS", "3"))),
            base_delay=float(os.environ.get("SART_RETRY_BASE_DELAY", "0.05")),
            max_delay=float(os.environ.get("SART_RETRY_MAX_DELAY", "2")),
            deadline=float(os.environ.get("SART_RETRY_DEADLINE", "60")),
        )

    def backoff(self, attempt: int, rng: np.random.Generator) -> float:
        """Delay before retry ``attempt`` (1-based): exponential, capped,
        jittered."""
        delay = min(self.base_delay * (2.0 ** (attempt - 1)), self.max_delay)
        if self.jitter > 0:
            delay *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(delay, 0.0)


# site -> {"attempts": total calls of fn, "recoveries": successes after at
# least one failure, "exhausted": RetriesExhausted raised}. Feeds the
# end-of-run resilience summary.
_STATS: Dict[str, Dict[str, int]] = {}


def retry_stats() -> Dict[str, Dict[str, int]]:
    return {site: dict(v) for site, v in _STATS.items()}


def reset_retry_stats() -> None:
    _STATS.clear()


def retry_call(
    fn: Callable,
    *,
    site: str,
    policy: Optional[RetryPolicy] = None,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` with the site's retry policy.

    Only ``retry_on`` exceptions are retried — anything else (an internal
    bug) propagates from the first attempt. Exhaustion (attempts, or the
    wall-clock deadline) raises :class:`RetriesExhausted` chaining the
    last error.
    """
    policy = policy or RetryPolicy.from_env()
    stats = _STATS.setdefault(
        site, {"attempts": 0, "recoveries": 0, "exhausted": 0}
    )
    from sartsolver_tpu_torch.resilience.faults import site_seed

    # stable site component + process component (see module docstring)
    rng = np.random.default_rng([site_seed(site), os.getpid()])
    start = time.monotonic()
    last: Optional[BaseException] = None
    attempt = 0
    for attempt in range(1, policy.attempts + 1):
        stats["attempts"] += 1
        try:
            result = fn()
        except retry_on as err:
            last = err
            if (attempt >= policy.attempts
                    or time.monotonic() - start >= policy.deadline):
                break
            sleep(policy.backoff(attempt, rng))
            continue
        if attempt > 1:
            stats["recoveries"] += 1
        return result
    stats["exhausted"] += 1
    raise RetriesExhausted(site, attempt, last) from last
