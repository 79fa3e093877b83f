"""Per-run telemetry: frame and event records, sink fan-out.

Counterpart of ``sartsolver_tpu/obs/run.py``.
:class:`RunTelemetry` is what the CLI wires in: it owns the run's metrics
registry (the process default, reset per run), accumulates the typed frame
and event records beside it, and at the end of the run writes the artifact
to the configured sinks. With no sink configured it still keeps the
registry current (``--timing`` reads it) but writes and prints nothing.

A run over a grid of ranks aggregates at its end: one all-gather of every
rank's registry snapshot, a fixed-size length-prefixed buffer
(:func:`_encode_snapshot`), merged by :func:`aggregate_snapshots`
(counters sum, gauges keep the max, histograms merge); the primary rank
writes the sinks. The ``allgather`` is injected (the CLI's runs over
``parallel/comm.py``, ``parallel/multihost.py:deadline_allgather``), so
this module imports neither torch nor numpy at import time.

At the end of a run the per-site retry counters (``retry_attempts_total``,
``retry_recoveries_total``, ``retry_exhausted_total``) and
``fault_trips_total`` are folded in, as the JAX module does.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, List, Optional

from sartsolver_tpu_torch.obs import metrics, schema, sinks, trace
from sartsolver_tpu_torch.resilience.failures import status_name

# Upper bound on one process's JSON-encoded registry snapshot in the
# aggregation buffer: every process offers the same buffer shape to the one
# allgather, so the cap is fixed up front.
AGG_MAX_BYTES = 1 << 20


def _encode_snapshot(snapshot: List[dict], max_bytes: int):
    """Length-prefixed uint8 buffer holding the snapshot as valid JSON.

    A snapshot over the cap shrinks in stages (counters only, the one kind
    whose cross-process sum is irreplaceable, then halving the counter
    list), never by byte-slicing; the truncation marker travels inside the
    payload as a gauge, so the merged artifact is flagged whichever
    process truncated. Returns ``(buffer, truncated)``.
    """
    import numpy as np

    truncated_flag = {"kind": "gauge", "name": "aggregation_truncated",
                      "labels": {}, "value": 1.0}
    payload = json.dumps(snapshot).encode()
    truncated = False
    if len(payload) > max_bytes:
        truncated = True
        kept = [s for s in snapshot if s["kind"] == "counter"]
        payload = json.dumps(kept + [truncated_flag]).encode()
        while len(payload) > max_bytes and kept:
            kept = kept[: len(kept) // 2]
            payload = json.dumps(kept + [truncated_flag]).encode()
        if len(payload) > max_bytes:  # even [flag] alone cannot overflow
            payload = json.dumps([truncated_flag]).encode()
    buf = np.zeros(8 + max_bytes, np.uint8)
    buf[:8] = np.frombuffer(len(payload).to_bytes(8, "little"), np.uint8)
    buf[8:8 + len(payload)] = np.frombuffer(payload, np.uint8)
    return buf, truncated


def aggregate_snapshots(
    snapshot: List[dict],
    allgather: Optional[Callable] = None,
    max_bytes: int = AGG_MAX_BYTES,
) -> List[dict]:
    """Merge this process's registry snapshot with every peer's.

    ``allgather`` maps a [N] uint8 array to a [nproc, N] array (one row per
    process, this one's included); counters sum, gauges keep the max,
    histograms merge (obs/metrics.py). Without ``allgather`` there is one
    process, and the snapshot comes back as it is.
    """
    if allgather is None:
        return snapshot
    import numpy as np

    local, _truncated = _encode_snapshot(snapshot, max_bytes)
    gathered = np.asarray(allgather(local))
    # every process's snapshot, this one's included, is a row of the
    # gathered buffer, so the merge starts from an empty registry
    merged = metrics.MetricsRegistry()
    for row in np.atleast_2d(gathered):
        raw = np.asarray(row, np.uint8).tobytes()
        length = int.from_bytes(raw[:8], "little")
        try:
            remote = json.loads(raw[8:8 + length].decode())
        except ValueError:
            remote = []  # defensive: rows are valid JSON by construction
        merged.merge_snapshot(remote)
    return merged.snapshot()


class RunTelemetry:
    """One solver run's observability state and sink configuration."""

    def __init__(
        self,
        registry: Optional[metrics.MetricsRegistry] = None,
        *,
        jsonl_path: Optional[str] = None,
        prom_path: Optional[str] = None,
        trace_path: Optional[str] = None,
    ):
        self.registry = registry if registry is not None \
            else metrics.get_registry()
        self.jsonl_path = jsonl_path
        self.prom_path = prom_path
        self.trace_path = trace_path
        self._t0 = time.perf_counter()
        self._frames: List[dict] = []
        self._events: List[dict] = []
        self._run_info: dict = {}
        self._finalized = False
        self._trace_buffer: Optional[trace.TraceBuffer] = None
        if trace_path:
            self._trace_buffer = trace.install(trace.TraceBuffer())

    @classmethod
    def from_cli(cls, metrics_out: Optional[str]) -> "RunTelemetry":
        """Sinks from the CLI flag and the environment: ``--metrics_out``
        (JSONL), ``SART_METRICS_PROM`` (Prometheus textfile),
        ``SART_TRACE_EVENTS`` (Chrome trace JSON). The registry is the
        freshly reset process default, so ``--timing`` and the artifact
        read one source."""
        return cls(
            metrics.reset_registry(),
            jsonl_path=metrics_out or None,
            prom_path=os.environ.get("SART_METRICS_PROM") or None,
            trace_path=os.environ.get("SART_TRACE_EVENTS") or None,
        )

    @property
    def enabled(self) -> bool:
        return bool(self.jsonl_path or self.prom_path or self.trace_path)

    def set_run_info(self, **info) -> None:
        """Run provenance for the meta record (backend, mesh, dtype...)."""
        self._run_info.update(info)

    # ---- recording -------------------------------------------------------

    def record_frame(
        self,
        time_s: float,
        status: int,
        iterations: int,
        convergence: Optional[float],
        solve_ms: Optional[float],
        group: str,
        error: Optional[str] = None,
        **extra_fields,
    ) -> None:
        """One written row. ``extra_fields`` ride into the frame record
        verbatim (the schema is open over extras)."""
        name = status_name(status)
        if self.enabled:
            # the typed records only feed the sinks; with none configured,
            # buffering one dict per frame of a long run would be host
            # memory nobody reads (the registry below stays live)
            extra = {"error": error} if error else {}
            extra.update({k: v for k, v in extra_fields.items()
                          if v is not None})
            # solver-variant provenance on every frame, so `sartsolve
            # metrics --diff` sees a variant mismatch even on a slice of
            # an artifact
            for key in ("os_subsets", "momentum", "logarithmic",
                        "operator"):
                if key in self._run_info:
                    extra[key] = self._run_info[key]
            self._frames.append(schema.make_frame_record(
                time_s, status, name, iterations, solve_ms, convergence,
                group, **extra,
            ))
        self.registry.counter("frames_total", status=name).inc()
        if solve_ms is not None:
            self.registry.histogram("frame_solve_ms").observe(solve_ms)
        if iterations >= 0:
            self.registry.histogram("frame_iterations").observe(iterations)
        if status == 0 and iterations >= 0:
            # converged frames only: `sartsolve metrics --diff` gates on
            # this histogram's mean (convergence behavior)
            self.registry.histogram("iterations_to_converge").observe(
                iterations
            )
        if convergence is not None:
            self.registry.gauge("last_convergence").set(convergence)
        if error:
            self.registry.counter("frame_failures_total", error=error).inc()

    def record_event(self, message: str) -> None:
        """An availability event (an OOM halving, the scheduler's
        hand-back); the typed record is buffered only when a sink will read
        it."""
        if self.enabled:
            self._events.append(schema.make_event_record(
                message, time.perf_counter() - self._t0
            ))
        self.registry.counter("availability_events_total").inc()

    def _import_run_counters(self) -> None:
        """Fold the run's other host-side accounting into the registry so
        the artifact is self-contained: per-site retry stats and fault
        trips (``resilience/``). Imported here: this module loads without
        numpy, which they use."""
        from sartsolver_tpu_torch.resilience.faults import fault_trips
        from sartsolver_tpu_torch.resilience.retry import retry_stats

        for site, stats in sorted(retry_stats().items()):
            for key in ("attempts", "recoveries", "exhausted"):
                if stats[key]:
                    self.registry.counter(f"retry_{key}_total", site=site).inc(stats[key])
        for site, trips in sorted(fault_trips().items()):
            if trips:
                self.registry.counter("fault_trips_total", site=site).inc(trips)

    # ---- finalization ----------------------------------------------------

    def _records(self, snapshot: List[dict], summary,
                 partial: bool = False) -> List[dict]:
        extra_meta = {"partial": True} if partial else {}
        records: List[dict] = [schema.make_meta_record(
            created_unix=round(time.time(), 3), **extra_meta,
            **self._run_info
        )]
        records.extend(self._frames)
        records.extend(self._events)
        for snap in snapshot:
            records.append({"type": "metric", **snap})
        by_status = {}
        extra = {}
        if summary is not None:
            by_status = {
                status_name(s): n for s, n in sorted(summary.counts.items())
                if n
            }
            extra["failed_times"] = [float(t) for t in summary.failed_times]
            frames = summary.n_frames
        else:
            frames = len(self._frames)
        records.append(schema.make_summary_record(
            frames, by_status,
            wall_s=round(time.perf_counter() - self._t0, 3), **extra,
        ))
        return records

    def finalize(self, summary=None, *, multihost: bool = False, primary: bool = True,
                 allgather: Optional[Callable] = None) -> None:
        """Aggregate (``multihost``: one all-gather over ``allgather``; every
        rank calls this, never from an error path where a peer may not
        arrive) and write every configured sink on the primary rank.
        Idempotent; sink I/O errors are reported on stderr, never raised.
        With no sink configured this is a no-op, and no all-gather runs: the
        sinks must be configured alike on every rank, as the rest of the
        command line."""
        if self._finalized:
            return
        self._finalized = True
        if not self.enabled:
            self._teardown_trace()
            return
        self._import_run_counters()
        snapshot = self.registry.snapshot()
        if multihost:
            snapshot = aggregate_snapshots(snapshot, allgather=allgather)
        if not primary:
            self._teardown_trace()
            return
        self._write_sinks(snapshot, summary)

    def finalize_local(self, summary=None) -> None:
        """Best-effort variant for error exits; never raises. The artifact
        is marked ``partial`` in its meta record: an abort can predate any
        metric, and the validator's run contract exempts partial artifacts
        from the metric-presence requirement."""
        if self._finalized:
            return
        self._finalized = True
        if not self.enabled:
            self._teardown_trace()
            return
        try:
            self._import_run_counters()
            self._write_sinks(self.registry.snapshot(), summary,
                              partial=True)
        except Exception as err:  # noqa: BLE001 - must never mask the abort
            print(f"sartsolve: metrics finalization failed: {err}",
                  file=sys.stderr)
            self._teardown_trace()

    def _write_sinks(self, snapshot: List[dict], summary,
                     partial: bool = False) -> None:
        try:
            if self.jsonl_path:
                sinks.JsonlSink(self.jsonl_path).write(
                    self._records(snapshot, summary, partial=partial)
                )
                print(f"sartsolve: metrics written to {self.jsonl_path}",
                      file=sys.stderr)
            if self.prom_path:
                sinks.PromSink(self.prom_path).write(snapshot)
            if self.trace_path and self._trace_buffer is not None:
                sinks.ChromeTraceSink(self.trace_path).write(
                    self._trace_buffer
                )
                print(
                    f"sartsolve: trace events written to {self.trace_path}"
                    " (load in Perfetto / chrome://tracing)",
                    file=sys.stderr,
                )
        except OSError as err:
            print(f"sartsolve: metrics sink write failed: {err}",
                  file=sys.stderr)
        finally:
            self._teardown_trace()

    def _teardown_trace(self) -> None:
        if self._trace_buffer is not None:
            trace.uninstall()
            self._trace_buffer = None
