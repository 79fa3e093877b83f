"""Host-side observability: metrics registry, trace spans, run artifacts.

Counterpart of ``sartsolver_tpu/obs``. Names, labels, record fields and
printed lines are the JAX package's, letter for letter, so that an artifact
of either package validates under either tool and the two diff against
each other.

- :mod:`~sartsolver_tpu_torch.obs.metrics`: a process-wide registry of
  counters, gauges and histograms (per-frame solve ms, iterations,
  statuses, the scheduler's occupancy, the frame-group ladder level).
  ``--timing``'s :class:`~sartsolver_tpu_torch.utils.timing.PhaseTimer`
  is a view over the same registry.
- :mod:`~sartsolver_tpu_torch.obs.trace`: :func:`span` blocks around the
  pipeline's host phases, exported as Chrome trace-event JSON.
- :mod:`~sartsolver_tpu_torch.obs.schema`: the record vocabulary of the
  JSONL artifacts, with its validators.
- :mod:`~sartsolver_tpu_torch.obs.sinks`: the JSONL log
  (``--metrics_out``), the Prometheus textfile (``SART_METRICS_PROM``) and
  the Chrome trace (``SART_TRACE_EVENTS``).
- :mod:`~sartsolver_tpu_torch.obs.run`: :class:`RunTelemetry`, the per-run
  state and sink fan-out the CLI wires in.
- :mod:`~sartsolver_tpu_torch.obs.roofline`: device peaks, the sweep's
  analytic cost, utilization.
- :mod:`~sartsolver_tpu_torch.obs.cli`: the ``sartsolve metrics``
  subcommand.

The layer is host-side only and costs nothing when disabled: nothing here
runs inside the solver's iteration loop (the registry is updated per
frame, group or stride), span buffering happens only when a trace sink is
configured, and with no sink and no ``--timing`` the CLI's stdout and
solution file are byte-identical to a run without it.

This package imports only the standard library at module level (numpy
lazily, in the one function that needs it), never ``torch``: a benchmark
harness can load :mod:`schema` and :mod:`roofline` by path without
starting CUDA.
"""

from sartsolver_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    reset_registry,
)
from sartsolver_tpu_torch.obs.trace import TraceBuffer, span  # noqa: F401
