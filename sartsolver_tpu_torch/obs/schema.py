"""The machine-readable record vocabulary (JSONL) for run artifacts.

Counterpart of ``sartsolver_tpu/obs/schema.py``, whole: the same
``SCHEMA_VERSION``, record types, validators and ``make_*_record``
builders, so that an artifact written by either package validates under
either package's tool and the two diff against each other.

``--metrics_out`` writes a ``meta`` line, one ``frame`` line per written
row, ``event`` lines for availability events, ``metric`` lines for the
end-of-run registry snapshot and a closing ``summary`` line. The other
types (``bench``, ``cost``, ``status``, ``flight``) are the JAX package's
benchmark results, compile-audit goldens and live-introspection files;
they validate here too.

Every record carries ``type`` (the discriminator); ``meta`` and ``bench``
carry ``schema`` (the version of this vocabulary). Validation is
structural and *closed over requirements, open over extras*: unknown
additional keys are allowed, missing or wrongly typed required keys are
errors.

This module imports only the standard library and nothing of its package,
so a benchmark harness can load it by file path
(``importlib.util.spec_from_file_location``) without starting CUDA.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

RECORD_TYPES = ("meta", "frame", "event", "metric", "summary", "bench",
                "cost", "status", "flight")

_NUMBER = (int, float)


def _need(rec: dict, errors: List[str], key: str, types, nullable=False):
    if key not in rec:
        errors.append(f"missing required key {key!r}")
        return None
    value = rec[key]
    if value is None:
        if not nullable:
            errors.append(f"key {key!r} must not be null")
        return None
    bad = not isinstance(value, types)
    if not bad and isinstance(value, bool) and (types is _NUMBER
                                                or types is int):
        bad = True  # bool is an int subclass; never a valid metric value
    if bad:
        errors.append(
            f"key {key!r} has type {type(value).__name__}, expected "
            + (types.__name__ if isinstance(types, type)
               else "/".join(t.__name__ for t in types))
        )
        return None
    return value


def validate_record(rec: object) -> List[str]:
    """Structural validation of one record; returns a list of errors
    (empty when valid)."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, expected object"]
    rtype = rec.get("type")
    if rtype not in RECORD_TYPES:
        return [f"unknown record type {rtype!r}; valid: "
                + ", ".join(RECORD_TYPES)]
    errors: List[str] = []
    if rtype == "meta":
        version = _need(rec, errors, "schema", int)
        if version is not None and version > SCHEMA_VERSION:
            errors.append(
                f"schema version {version} is newer than this tool's "
                f"{SCHEMA_VERSION}"
            )
        _need(rec, errors, "tool", str)
    elif rtype == "frame":
        _need(rec, errors, "time", _NUMBER)
        _need(rec, errors, "status", int)
        _need(rec, errors, "status_name", str)
        _need(rec, errors, "iterations", int)
        # null for frames that never produced a solve (FAILED rows)
        _need(rec, errors, "solve_ms", _NUMBER, nullable=True)
        _need(rec, errors, "convergence", _NUMBER, nullable=True)
        _need(rec, errors, "group", str)
    elif rtype == "event":
        _need(rec, errors, "message", str)
        _need(rec, errors, "t", _NUMBER)
    elif rtype == "metric":
        kind = _need(rec, errors, "kind", str)
        _need(rec, errors, "name", str)
        labels = _need(rec, errors, "labels", dict)
        if labels is not None and not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in labels.items()
        ):
            errors.append("labels must map strings to strings")
        if kind in ("counter", "gauge"):
            _need(rec, errors, "value", _NUMBER)
        elif kind == "histogram":
            _need(rec, errors, "count", int)
            _need(rec, errors, "sum", _NUMBER)
            _need(rec, errors, "min", _NUMBER, nullable=True)
            _need(rec, errors, "max", _NUMBER, nullable=True)
        elif kind is not None:
            errors.append(f"unknown metric kind {kind!r}")
    elif rtype == "summary":
        _need(rec, errors, "frames", int)
        by_status = _need(rec, errors, "by_status", dict)
        if by_status is not None and not all(
            isinstance(v, int) for v in by_status.values()
        ):
            errors.append("by_status values must be integers")
    elif rtype == "bench":
        version = _need(rec, errors, "schema", int)
        if version is not None and version > SCHEMA_VERSION:
            errors.append(
                f"schema version {version} is newer than this tool's "
                f"{SCHEMA_VERSION}"
            )
        _need(rec, errors, "metric", str)
        _need(rec, errors, "value", _NUMBER)
        _need(rec, errors, "unit", str)
        _need(rec, errors, "vs_baseline", _NUMBER)
        _need(rec, errors, "detail", dict)
    elif rtype == "cost":
        # static cost attribution of one compiled entry point
        # (analysis/audit.py cost goldens; docs/OBSERVABILITY.md §8).
        # flops/bytes nullable: a backend without cost_analysis support
        # still records the memory_analysis half (and vice versa).
        version = _need(rec, errors, "schema", int)
        if version is not None and version > SCHEMA_VERSION:
            errors.append(
                f"schema version {version} is newer than this tool's "
                f"{SCHEMA_VERSION}"
            )
        _need(rec, errors, "entry", str)
        _need(rec, errors, "backend", str)
        for key in ("flops", "bytes_accessed", "argument_bytes",
                    "output_bytes", "temp_bytes", "peak_bytes"):
            _need(rec, errors, key, _NUMBER, nullable=True)
    elif rtype == "status":
        # live status snapshot (obs/flight.py SIGUSR1 dump)
        version = _need(rec, errors, "schema", int)
        if version is not None and version > SCHEMA_VERSION:
            errors.append(
                f"schema version {version} is newer than this tool's "
                f"{SCHEMA_VERSION}"
            )
        _need(rec, errors, "unix", _NUMBER)
        _need(rec, errors, "frames_done", int)
        _need(rec, errors, "beacon_ages", dict)
        _need(rec, errors, "metrics", list)
    elif rtype == "flight":
        # crash bundle (obs/flight.py): status snapshot + event ring
        version = _need(rec, errors, "schema", int)
        if version is not None and version > SCHEMA_VERSION:
            errors.append(
                f"schema version {version} is newer than this tool's "
                f"{SCHEMA_VERSION}"
            )
        _need(rec, errors, "reason", str)
        _need(rec, errors, "status", dict)
        _need(rec, errors, "ring", list)
    return errors


def load_jsonl(path: str) -> Tuple[List[Tuple[int, object]], List[str]]:
    """Parse a JSONL file once: ``([(lineno, record), ...], parse_errors)``.

    Records that failed to parse are reported in the error list and
    omitted from the record list; validation is a separate step
    (:func:`validate_records`) so callers read and parse each artifact
    exactly once.
    """
    errors: List[str] = []
    records: List[Tuple[int, object]] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append((lineno, json.loads(line)))
            except ValueError as err:
                errors.append(f"line {lineno}: not valid JSON ({err})")
    return records, errors


def validate_records(numbered: List[Tuple[int, object]], *,
                     require_run: bool = False) -> List[str]:
    """Validate already-parsed ``(lineno, record)`` pairs; see
    :func:`validate_jsonl` for the ``require_run`` contract."""
    errors: List[str] = []
    for lineno, rec in numbered:
        for e in validate_record(rec):
            errors.append(f"line {lineno}: {e}")
    records = [rec for _, rec in numbered if isinstance(rec, dict)]
    if require_run:
        types = [r.get("type") for r in records]
        if not records or types[0] != "meta":
            errors.append("run artifact must start with a meta record")
        # abort-path artifacts (RunTelemetry.finalize_local) are marked
        # partial in their meta: the run may have died before any metric
        # was recorded, so only completed runs owe a metric snapshot
        partial = bool(records) and types[0] == "meta" \
            and records[0].get("partial") is True
        if "metric" not in types and not partial:
            errors.append("run artifact has no metric records")
        n_summaries = types.count("summary")
        if n_summaries != 1:
            errors.append(
                f"run artifact must have exactly one summary record, "
                f"found {n_summaries}"
            )
        frames = [r for r in records if r.get("type") == "frame"]
        summaries = [r for r in records if r.get("type") == "summary"]
        if summaries and isinstance(summaries[0].get("frames"), int) \
                and summaries[0]["frames"] != len(frames):
            errors.append(
                f"summary counts {summaries[0]['frames']} frame(s) but the "
                f"artifact holds {len(frames)} frame record(s)"
            )
        for rec in frames:
            if rec.get("status") == -3:  # FRAME_FAILED never solved
                continue
            for key in ("solve_ms", "iterations", "convergence", "status"):
                if rec.get(key) is None:
                    errors.append(
                        f"frame t={rec.get('time')}: {key} is null on a "
                        "non-failed frame"
                    )
    return errors


def validate_jsonl(path: str, *, require_run: bool = False
                   ) -> Tuple[int, List[str]]:
    """Validate a JSONL artifact; returns ``(n_records, errors)``.

    Errors are prefixed ``line N:``. With ``require_run`` the artifact is
    additionally held to the run-artifact contract the CLI writes: first
    record ``meta``, at least one ``metric`` record, exactly one
    ``summary`` whose frame count matches the ``frame`` records, and
    every non-failed frame carrying solve_ms/convergence values.
    """
    numbered, errors = load_jsonl(path)
    errors = errors + validate_records(numbered, require_run=require_run)
    return len(numbered), errors


def make_meta_record(tool: str = "sartsolve", **extra) -> dict:
    rec = {"type": "meta", "schema": SCHEMA_VERSION, "tool": tool}
    rec.update(extra)
    return rec


def make_frame_record(time_s: float, status: int, status_name: str,
                      iterations: int, solve_ms: Optional[float],
                      convergence: Optional[float], group: str,
                      **extra) -> dict:
    rec = {
        "type": "frame",
        "time": float(time_s),
        "status": int(status),
        "status_name": str(status_name),
        "iterations": int(iterations),
        "solve_ms": None if solve_ms is None else float(solve_ms),
        "convergence": None if convergence is None else float(convergence),
        "group": str(group),
    }
    rec.update(extra)
    return rec


def make_event_record(message: str, t: float, **extra) -> dict:
    rec = {"type": "event", "message": str(message), "t": float(t)}
    rec.update(extra)
    return rec


def make_summary_record(frames: int, by_status: Dict[str, int],
                        **extra) -> dict:
    rec = {"type": "summary", "frames": int(frames),
           "by_status": {str(k): int(v) for k, v in by_status.items()}}
    rec.update(extra)
    return rec


def make_cost_record(entry: str, backend: str, *,
                     flops: Optional[float] = None,
                     bytes_accessed: Optional[float] = None,
                     argument_bytes: Optional[float] = None,
                     output_bytes: Optional[float] = None,
                     temp_bytes: Optional[float] = None,
                     peak_bytes: Optional[float] = None,
                     **extra) -> dict:
    """Static cost attribution of one compiled entry point: XLA's
    ``cost_analysis()`` (flops, bytes accessed) plus ``memory_analysis()``
    (argument/output/temp bytes; ``peak_bytes`` is their sum — the
    program's device-memory high water). Written as the compile-audit
    cost goldens and consumed by ``obs/roofline.py``."""
    def num(v):
        return None if v is None else float(v)

    rec = {
        "type": "cost",
        "schema": SCHEMA_VERSION,
        "entry": str(entry),
        "backend": str(backend),
        "flops": num(flops),
        "bytes_accessed": num(bytes_accessed),
        "argument_bytes": num(argument_bytes),
        "output_bytes": num(output_bytes),
        "temp_bytes": num(temp_bytes),
        "peak_bytes": num(peak_bytes),
    }
    rec.update(extra)
    return rec


def make_bench_record(metric: str, value: float, unit: str,
                      vs_baseline: float, detail: dict) -> dict:
    """The BENCH result line: historical keys + the schema envelope.

    The envelope keys are *added*, never renamed — tools parsing the
    historical ``{metric, value, unit, vs_baseline, detail}`` shape keep
    working unchanged.
    """
    return {
        "type": "bench",
        "schema": SCHEMA_VERSION,
        "metric": str(metric),
        "value": float(value),
        "unit": str(unit),
        "vs_baseline": float(vs_baseline),
        "detail": dict(detail),
    }
