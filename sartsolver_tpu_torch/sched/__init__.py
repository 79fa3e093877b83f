"""Continuous batching: convergence-aware lane retirement and backfill."""

from sartsolver_tpu_torch.sched.scheduler import ContinuousBatcher, SchedRunStats

__all__ = ["ContinuousBatcher", "SchedRunStats"]
