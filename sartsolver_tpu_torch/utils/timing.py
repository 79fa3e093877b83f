"""Per-phase wall-clock accounting for the frame pipeline (``--timing``).

Counterpart of ``sartsolver_tpu/utils/timing.py``. The reference's only
built-in measurement is the per-frame solve time (main.cpp:128-137); this
module adds the phase breakdown: validation, RTM ingest and upload, the
frame loop (the first frame includes the kernel's first load) and the
voxel-map write, so a slow run can be attributed to host I/O or device
compute without a profiler. For kernel-level detail use ``--profile_dir``
(``torch.profiler``).

:class:`PhaseTimer` is a view over a metrics registry
(``obs/metrics.py``): each ``add`` observes one sample of the
``phase_seconds`` histogram labeled with the phase name. The CLI hands it
the run's registry, so the ``--timing`` text summary and the
``--metrics_out`` artifact are read from one source; constructed bare it
uses a private registry.
"""

from __future__ import annotations

from typing import Optional

from sartsolver_tpu_torch.obs.metrics import MetricsRegistry

PHASE_METRIC = "phase_seconds"


class PhaseTimer:
    """Accumulates wall time and hit counts per named phase.

    Phases print in stable insertion-then-name order: first-recorded
    first (registry registration order), with phases merged in from other
    hosts appended in name order (``MetricsRegistry.merge_snapshot``).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self._registry = registry if registry is not None \
            else MetricsRegistry()

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    def add(self, name: str, seconds: float, *, detail: bool = False) -> None:
        """Record one sample of ``name``. ``detail=True`` marks a phase
        that is a finer-grained breakdown *inside* another recorded phase
        (the CLI's per-frame solve rows live inside the frame-loop
        phase): it prints like any other row but is excluded from the
        ``total`` line, which must sum only the disjoint top-level phases
        — summing overlapping rows would fabricate wall clock."""
        labels = {"phase": str(name)}
        if detail:
            labels["detail"] = "1"
        self._registry.histogram(PHASE_METRIC, **labels).observe(seconds)

    def _phases(self):
        """(name, total_s, count, detail) per phase, snapshot order."""
        return [
            (snap["labels"]["phase"], snap["sum"], snap["count"],
             snap["labels"].get("detail") == "1")
            for snap in self._registry.snapshot()
            if snap["kind"] == "histogram" and snap["name"] == PHASE_METRIC
        ]

    def summary(self) -> str:
        phases = self._phases()
        if not phases:
            return "timing: no phases recorded"
        width = max(len(n) for n, _, _, _ in phases)
        width = max(width, len("total"))
        lines = ["timing summary (wall clock):"]
        for name, total, n, _detail in phases:
            per = f", {total / n * 1e3:8.1f} ms avg over {n}" if n > 1 else ""
            lines.append(f"  {name:<{width}}  {total * 1e3:10.1f} ms{per}")
        grand = sum(total for _, total, _, detail in phases if not detail)
        lines.append(f"  {'total':<{width}}  {grand * 1e3:10.1f} ms")
        return "\n".join(lines)
