"""Artifact sinks: JSONL, Prometheus textfile, Chrome trace.

Counterpart of ``sartsolver_tpu/obs/sinks.py``: the same record lines,
metric family names, HELP text and exposition layout, so the port's files
read like the JAX package's. All three write once, at the end of a run (the
frame loop never blocks on a sink); a failed write is reported on stderr by
``RunTelemetry``, never raised: a metrics artifact is not worth failing a
completed run over.
"""

from __future__ import annotations

import json
import re
from typing import Iterable, List

from sartsolver_tpu_torch.utils import atomicio


class JsonlSink:
    """``--metrics_out``: one schema record per line."""

    def __init__(self, path: str):
        self.path = path

    def write(self, records: Iterable[dict]) -> None:
        with open(self.path, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")


_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LABEL = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str, suffix: str = "") -> str:
    return "sart_" + _PROM_NAME.sub("_", name) + suffix


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    def esc(value: str) -> str:
        return str(value).replace("\\", "\\\\").replace('"', '\\"')
    items = ",".join(
        f'{_PROM_LABEL.sub("_", k)}="{esc(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + items + "}"


# HELP text per registry metric name. Strict exposition-format scrapers
# (promtool check metrics, OpenMetrics parsers) warn on HELP-less
# families, so every emitted family gets a line — names missing here
# fall back to a generic pointer at the docs.
_HELP = {
    "frames_total": "Completed frames by final status.",
    "frame_failures_total": "Frames recorded FAILED, by error class.",
    "frame_solve_ms": "Wall-clock per solved frame, milliseconds.",
    "frame_iterations": "Solver iterations per frame.",
    "iterations_to_converge":
        "Solver iterations of SUCCESS frames (convergence behavior).",
    "last_convergence": "Convergence measure of the last solved frame.",
    "availability_events_total":
        "Degradations/recoveries noted by the resilience layer.",
    "frames_prefetched_total": "Frames read ahead by the prefetcher.",
    "bytes_ingested_total": "Bytes read from input files, by source.",
    "frames_written_total": "Solution rows handed to the writer.",
    "bytes_written_total": "Solution bytes flushed to the output file.",
    "prefetch_queue_depth": "Prefetch queue high-water mark.",
    "writer_queue_depth": "Async-writer queue high-water mark.",
    "frame_group_size": "Active solve group size (OOM ladder).",
    "oom_degradations_total": "Group-size halvings forced by device OOM.",
    "sched_lane_occupancy": "Live occupied-lane fraction (scheduler).",
    "sched_stride_occupancy": "Per-stride occupied-lane fraction.",
    "sched_lanes_retired_total": "Lanes retired on convergence.",
    "sched_lanes_backfilled_total": "Lanes refilled with waiting frames.",
    "sched_strides_total": "Scheduler strides dispatched.",
    "sdc_detected_total": "ABFT checksum mismatches (integrity layer).",
    "integrity_recomputes_total": "Frame recomputes after an SDC trip.",
    "stripe_digest_mismatch_total": "RTM stripe digest mismatches.",
    "nonfinite_pixels_total": "Non-finite measurement pixels dropped.",
    "fused_panel_count": "Panels per sweep in the panel-psum plan.",
    "fused_panel_voxels": "Voxels per panel in the panel-psum plan.",
    "collectives_planned_total":
        "Collectives in the compiled sweep, by site.",
    "fault_trips_total": "Injected faults tripped (SART_FAULT).",
    "phase_seconds": "Wall-clock per pipeline phase (--timing view).",
    "engine_queue_wait_s": "Request wait from acceptance to dispatch.",
    "engine_request_solve_s": "Request wall time in the solver.",
    "engine_request_latency_s":
        "Request latency from acceptance to completion.",
    "engine_slo_ok_total":
        "Requests finishing within the --slo_ms target.",
    "engine_slo_breach_total":
        "Requests finishing past the --slo_ms target (error budget "
        "burn).",
    "engine_slo_target_ms": "The serve process's --slo_ms target.",
    "sched_deadline_shed_total": "Lanes force-retired past their deadline.",
    "solver_os_subsets": "Ordered-subsets count of the run (--os_subsets).",
    "solver_momentum_on": "1 when the run uses --momentum, else 0.",
    "rtm_tile_occupancy":
        "Fraction of 8x128 RTM tiles holding data (--sparse_rtm).",
    "sparse_tiles_skipped_total":
        "RTM tiles the block-sparse sweeps skipped, by path.",
    "solve_ckpt_written_total":
        "In-solve checkpoint records appended (--solve_ckpt_stride).",
    "solve_ckpt_resumed_total":
        "Runs resumed from an in-solve checkpoint.",
    "pod_barrier_timeouts_total":
        "Pod rendezvous that gave up on a dead or wedged peer.",
}

# Histogram sub-series: what each exported moment is.
_HIST_SUFFIX = {
    "_count": "sample count",
    "_sum": "sum of samples",
    "_min": "smallest sample",
    "_max": "largest sample",
    "_p50": "estimated median, fixed-bucket",
    "_p95": "estimated 95th percentile, fixed-bucket",
    "_p99": "estimated 99th percentile, fixed-bucket",
}


def _help_text(reg_name: str, suffix: str = "") -> str:
    base = _HELP.get(reg_name)
    if base is None:
        if reg_name.startswith("retry_"):
            base = "Retry outcomes by site (resilience/retry.py)."
        else:
            base = f"sartsolver_tpu metric {reg_name} " \
                   "(docs/OBSERVABILITY.md)."
    if suffix:
        return f"{base[:-1] if base.endswith('.') else base} " \
               f"({_HIST_SUFFIX[suffix]})."
    return base


def render_prometheus(snapshot: Iterable[dict]) -> str:
    """Prometheus text exposition of a registry snapshot.

    Counters/gauges map directly; histograms export summary-style
    ``_count``/``_sum``/``_min``/``_max`` series (moments, no buckets —
    obs/metrics.py docstring). Samples are grouped by metric family
    first (first-registration order), not emitted in raw registry order:
    label-sets of one family registered at different times (e.g. a
    ``failed`` status appearing mid-run) must still form one contiguous
    block under single ``# HELP``/``# TYPE`` lines — the
    exposition-format rules strict scrapers enforce (and HELP-less
    families draw warnings from them, so every family carries one).
    """
    families: dict = {}  # name -> [line, ...], insertion-ordered
    typed: dict = {}

    def emit(name: str, mtype: str, labels: dict, value,
             help_text: str) -> None:
        if value is None:
            return
        if name not in typed:
            typed[name] = mtype
            families[name] = [
                f"# HELP {name} {help_text}",
                f"# TYPE {name} {mtype}",
            ]
        families[name].append(
            f"{name}{_prom_labels(labels)} {float(value):g}"
        )

    for snap in snapshot:
        kind, labels = snap["kind"], snap["labels"]
        help_ = _help_text(snap["name"])
        if kind == "counter":
            emit(_prom_name(snap["name"], "_total")
                 if not snap["name"].endswith("_total")
                 else _prom_name(snap["name"]),
                 "counter", labels, snap["value"], help_)
        elif kind == "gauge":
            emit(_prom_name(snap["name"]), "gauge", labels,
                 snap["value"], help_)
        elif kind == "histogram":
            base = _prom_name(snap["name"])
            for suffix, mtype in (("_count", "counter"),
                                  ("_sum", "counter"),
                                  ("_min", "gauge"), ("_max", "gauge")):
                emit(base + suffix, mtype, labels, snap[suffix[1:]],
                     _help_text(snap["name"], suffix))
            # fixed-bucket quantile estimates (obs/metrics.py); absent
            # from snapshots of a pre-bucket artifact generation, and
            # `emit` drops None values, so old snapshots render as before
            for suffix in ("_p50", "_p95", "_p99"):
                emit(base + suffix, "gauge", labels,
                     snap.get(suffix[1:]),
                     _help_text(snap["name"], suffix))
    lines: List[str] = [
        line for family in families.values() for line in family
    ]
    return "\n".join(lines) + ("\n" if lines else "")


class PromSink:
    """``SART_METRICS_PROM``: Prometheus textfile export.

    Written to a temp file then renamed — the node-exporter textfile
    collector reads at arbitrary instants, and rename is the one atomic
    publish primitive it documents.
    """

    def __init__(self, path: str):
        self.path = path

    def write(self, snapshot: Iterable[dict]) -> None:
        # fsync=False: scrape textfiles are advisory and rewritten on
        # every export; a torn file costs one scrape interval
        atomicio.write_atomic(self.path, render_prometheus(snapshot),
                              fsync=False)


class ChromeTraceSink:
    """``SART_TRACE_EVENTS``: Chrome trace-event JSON (Perfetto)."""

    def __init__(self, path: str):
        self.path = path

    def write(self, buffer) -> None:
        buffer.close_open_spans()
        buffer.write_json(self.path)
