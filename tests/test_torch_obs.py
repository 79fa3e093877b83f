"""The port's observability layer (sartsolver_tpu_torch/obs, utils/timing.py,
resilience/failures.py) against the JAX package's.

The same inputs, made from a seed with numpy, go through both packages: the
registry snapshots, merges, histogram quantiles, Prometheus text, schema
validation errors, phase summaries, roofline numbers and ``sartsolve
metrics`` outputs must be equal. Then what only the port has: the H100 row
of the peaks table, the single-process aggregation, the bounded span
buffer. No CLI run here (tests/test_torch_obs_cli.py).
"""

import json

import numpy as np
import pytest

from sartsolver_tpu.obs import metrics as jmetrics
from sartsolver_tpu.obs import roofline as jroofline
from sartsolver_tpu.obs import run as jrun
from sartsolver_tpu.obs import schema as jschema
from sartsolver_tpu.obs import sinks as jsinks
from sartsolver_tpu.obs.cli import metrics_main as jax_metrics_main
from sartsolver_tpu.resilience import failures as jfailures
from sartsolver_tpu.utils.timing import PhaseTimer as JaxPhaseTimer

from sartsolver_tpu_torch.obs import metrics, roofline, run, schema, sinks, trace
from sartsolver_tpu_torch.obs.cli import metrics_main
from sartsolver_tpu_torch.resilience import failures
from sartsolver_tpu_torch.utils import atomicio
from sartsolver_tpu_torch.utils.timing import PhaseTimer

SEEDS = [0, 1, 2]

# families with curated HELP text in both packages, beside ones neither knows
FAMILIES = ["frames_total", "frame_solve_ms", "frame_iterations",
            "iterations_to_converge", "sched_strides_total",
            "sched_stride_occupancy", "frame_group_size", "phase_seconds",
            "retry_attempts_total", "somebody_elses_metric"]


def _ops(seed, n=60):
    """A seeded list of registry operations: (kind, name, labels, value)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = ["counter", "gauge", "gauge_max", "histogram"][rng.integers(4)]
        name = FAMILIES[rng.integers(len(FAMILIES))] + "_" + kind.split("_")[0]
        labels = {} if rng.random() < 0.4 else {"site": f"s{rng.integers(3)}"}
        if kind == "histogram":
            # log-uniform over the bucket range and past both ends, zeros
            # and infinities included
            pick = rng.random()
            value = (0.0 if pick < 0.05 else float("inf") if pick < 0.08
                     else float(10.0 ** rng.uniform(-8, 8)))
        elif kind == "counter":
            value = float(rng.integers(0, 5))
        else:
            value = float(rng.normal() * 10)
        ops.append((kind, name, labels, value))
    return ops


def _apply(registry, ops):
    for kind, name, labels, value in ops:
        if kind == "counter":
            registry.counter(name, **labels).inc(value)
        elif kind == "gauge":
            registry.gauge(name, **labels).set(value)
        elif kind == "gauge_max":
            registry.gauge(name, **labels).set_max(value)
        else:
            registry.histogram(name, **labels).observe(value)
    return registry


def _pair(seed):
    ops = _ops(seed)
    return _apply(metrics.MetricsRegistry(), ops), _apply(jmetrics.MetricsRegistry(), ops)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_registry_snapshot_matches_jax(seed):
    port, jax_reg = _pair(seed)
    assert port.snapshot() == jax_reg.snapshot()
    assert port.snapshot(blocking=False) == jax_reg.snapshot(blocking=False)


@pytest.mark.parametrize("seed", SEEDS)
def test_histogram_quantiles_and_buckets_match_jax(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate([10.0 ** rng.uniform(-9, 9, 200), [0.0, -1.0, np.inf]])
    for v in values:
        assert metrics.bucket_index(v) == jmetrics.bucket_index(v)
    for i in range(metrics.N_BUCKETS):
        assert metrics.bucket_upper(i) == jmetrics.bucket_upper(i)
        assert metrics.bucket_mid(i) == jmetrics.bucket_mid(i)
    h, jh = metrics.MetricsRegistry().histogram("h"), jmetrics.MetricsRegistry().histogram("h")
    for v in values[:100]:
        h.observe(v)
        jh.observe(v)
    snap, jsnap = h.snapshot(), jh.snapshot()
    assert [snap[q] for _, q in metrics.QUANTILES] == [jsnap[q] for _, q in jmetrics.QUANTILES]
    assert snap == jsnap


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_snapshot_matches_jax(seed):
    """A port snapshot merges into a JAX registry and a JAX snapshot into a
    port registry with the same result: counters sum, gauges max,
    histograms merge, foreign instruments appended in name order."""
    port, jax_reg = _pair(seed)
    other = _ops(seed + 100)
    port.merge_snapshot(_apply(jmetrics.MetricsRegistry(), other).snapshot())
    jax_reg.merge_snapshot(_apply(metrics.MetricsRegistry(), other).snapshot())
    assert port.snapshot() == jax_reg.snapshot()


def test_registry_semantics():
    r = metrics.MetricsRegistry()
    with pytest.raises(ValueError):
        r.counter("c").inc(-1)
    g = r.gauge("depth")
    g.set_max(3)
    g.set_max(1)
    assert g.value == 3
    metrics.get_registry().counter("stale").inc()
    fresh = metrics.reset_registry()
    assert fresh is metrics.get_registry()
    assert not [s for s in fresh.snapshot() if s["name"] == "stale"]


def test_nonblocking_snapshot_under_held_locks():
    """Signal context: with the registry's and an instrument's locks held
    (the interrupted frame's), snapshot(blocking=False) reads stale instead
    of waiting forever."""
    from sartsolver_tpu_torch.utils.locking import stale_read

    port, _ = _pair(0)
    want = port.snapshot()
    inst = next(iter(port._instruments.values()))
    with port._lock, inst._lock:
        assert port.snapshot(blocking=False) == want

    def racing():
        raise RuntimeError("dictionary changed size during iteration")

    assert stale_read(racing, default=[]) == []


def test_env_default_labels(monkeypatch):
    monkeypatch.setenv("SART_WORKER_ID", "w3")
    assert metrics._env_default_labels() == jmetrics._env_default_labels() == {"worker": "w3"}
    r = metrics.MetricsRegistry(default_labels=metrics._env_default_labels())
    r.counter("c", site="a").inc()
    assert r.snapshot()[0]["labels"] == {"site": "a", "worker": "w3"}


def test_the_two_registries_are_separate():
    """The JAX package's registry and the port's are separate objects: a
    test process that runs both CLIs never mixes their counts."""
    port = metrics.reset_registry()
    jax_reg = jmetrics.reset_registry()
    assert port is not jax_reg
    port.counter("frames_total", status="converged").inc(3)
    assert not jmetrics.get_registry().snapshot()
    jmetrics.get_registry().counter("frames_total", status="converged").inc(5)
    assert metrics.get_registry().snapshot()[0]["value"] == 3


# ---------------------------------------------------------------------------
# Prometheus text
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_prometheus_text_matches_jax(seed):
    port, jax_reg = _pair(seed)
    assert sinks.render_prometheus(port.snapshot()) == \
        jsinks.render_prometheus(jax_reg.snapshot())


def test_prometheus_help_covers_the_port_families():
    """Every family the port emits has curated HELP text: the JAX table's
    entries plus three it leaves to the generic fallback (the scheduler's
    deadline shed and the two solver-variant gauges)."""
    emitted = ["frames_total", "frame_solve_ms", "frame_iterations",
               "iterations_to_converge", "last_convergence",
               "availability_events_total", "frame_group_size",
               "oom_degradations_total", "sched_lane_occupancy",
               "sched_stride_occupancy", "sched_lanes_retired_total",
               "sched_lanes_backfilled_total", "sched_strides_total",
               "sched_deadline_shed_total", "nonfinite_pixels_total",
               "phase_seconds", "solver_os_subsets", "solver_momentum_on"]
    for name in emitted:
        assert name in sinks._HELP, name
    assert {k: v for k, v in sinks._HELP.items() if k in jsinks._HELP} == jsinks._HELP


def test_prom_sink_publishes_by_rename(tmp_path):
    r = metrics.MetricsRegistry()
    r.counter("frames_total", status="converged").inc(4)
    path = tmp_path / "run.prom"
    sinks.PromSink(str(path)).write(r.snapshot())
    assert 'sart_frames_total{status="converged"} 4' in path.read_text()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["run.prom"]
    atomicio.write_json_atomic(str(tmp_path / "x.json"), {"a": 1})
    assert json.loads((tmp_path / "x.json").read_text()) == {"a": 1}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["run.prom", "x.json"]


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

MALFORMED = [
    {"type": "nope"},
    {"type": "frame", "time": 1.0},
    {"type": "frame", "time": "x", "status": 0, "status_name": "s",
     "iterations": 1, "solve_ms": 1.0, "convergence": 1.0, "group": "g"},
    {"type": "metric", "kind": "counter", "name": "n", "labels": {"a": 1},
     "value": 1.0},
    {"type": "metric", "kind": "exotic", "name": "n", "labels": {}},
    {"type": "meta", "schema": 2, "tool": "t"},
    {"type": "frame", "time": 1.0, "status": 0, "status_name": "s",
     "iterations": 1, "solve_ms": True, "convergence": 1.0, "group": "g"},
    {"type": "summary", "frames": 2, "by_status": {"converged": "2"}},
    {"type": "metric", "kind": "histogram", "name": "h", "labels": {},
     "count": 1.5, "sum": 1.0, "min": None, "max": None},
    {"type": "event", "message": 3, "t": 1.0},
    {"type": "bench", "schema": 1, "metric": "m", "value": 1.0, "unit": "u",
     "vs_baseline": 1.0, "detail": []},
    ["not", "an", "object"],
]


@pytest.mark.parametrize("rec", MALFORMED, ids=range(len(MALFORMED)))
def test_schema_rejects_malformed_like_jax(rec):
    errors = schema.validate_record(rec)
    assert errors and errors == jschema.validate_record(rec)


def _run_records():
    return [
        schema.make_meta_record(backend="cuda", mesh="1x1"),
        schema.make_frame_record(1.5, 0, "converged", 10, 3.2, 1e-6, "chain"),
        schema.make_frame_record(2.5, -3, "failed", -1, None, None, "failed",
                                 error="OSError"),
        schema.make_event_record("device OOM", 1.0),
        {"type": "metric", "kind": "counter", "name": "frames_total",
         "labels": {"status": "converged"}, "value": 1.0},
        schema.make_summary_record(2, {"converged": 1, "failed": 1}),
    ]


@pytest.mark.parametrize("case", ["valid", "no_metric", "wrong_count", "two_summaries",
                                  "partial", "meta_not_first", "bad_json"])
def test_run_contract_matches_jax(tmp_path, case):
    records = _run_records()
    if case == "no_metric":
        records = [r for r in records if r["type"] != "metric"]
    elif case == "wrong_count":
        records[-1] = schema.make_summary_record(3, {"converged": 3})
    elif case == "two_summaries":
        records.append(records[-1])
    elif case == "partial":
        records = [schema.make_meta_record(partial=True), records[-1]]
        records[-1] = schema.make_summary_record(0, {})
    elif case == "meta_not_first":
        records = records[1:] + records[:1]
    path = tmp_path / "run.jsonl"
    text = "".join(json.dumps(r) + "\n" for r in records)
    if case == "bad_json":
        text += "not json\n"
    path.write_text(text)
    got = schema.validate_jsonl(str(path), require_run=True)
    assert got == jschema.validate_jsonl(str(path), require_run=True)
    assert (got[1] == []) == (case in ("valid", "partial"))


def test_record_builders_match_jax():
    kw = dict(backend="cuda", mesh="1x1", partial=True)
    assert schema.make_meta_record(**kw) == jschema.make_meta_record(**kw)
    for args in [(1.5, 0, "converged", 10, 3.2, 1e-6, "chain"),
                 (2.5, -3, "failed", -1, None, None, "failed")]:
        assert schema.make_frame_record(*args, error="E") == \
            jschema.make_frame_record(*args, error="E")
    assert schema.make_event_record("m", 1) == jschema.make_event_record("m", 1)
    assert schema.make_summary_record(2, {"converged": 2}, wall_s=1.0) == \
        jschema.make_summary_record(2, {"converged": 2}, wall_s=1.0)
    assert schema.make_bench_record("m", 1, "u", 1, {}) == \
        jschema.make_bench_record("m", 1, "u", 1, {})
    assert schema.make_cost_record("e", "gpu", flops=1) == \
        jschema.make_cost_record("e", "gpu", flops=1)


# ---------------------------------------------------------------------------
# PhaseTimer, statuses, the run summary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [
    [],
    [("zulu", 0.2, False), ("alpha", 0.1, False), ("zulu", 0.2, False)],
    [("frame loop", 10.0, False), ("solve frame", 8.0, True), ("solve frame", 1.0, True),
     ("write voxel map", 0.5, False)],
])
def test_phase_timer_summary_matches_jax(rows):
    """Insertion order, the avg-over-N column, detail rows printed but kept
    out of the total: the same text as the JAX timer."""
    port, jax_timer = PhaseTimer(), JaxPhaseTimer()
    for name, seconds, detail in rows:
        port.add(name, seconds, detail=detail)
        jax_timer.add(name, seconds, detail=detail)
    assert port.summary() == jax_timer.summary()
    if rows:
        lines = port.summary().splitlines()
        assert lines[1].strip().startswith(rows[0][0])
        total = sum(s for _, s, d in rows if not d)
        assert lines[-1].split()[-2] == f"{total * 1e3:.1f}"


def test_status_names_and_run_summary_match_jax():
    for status in range(-7, 2):
        assert failures.status_name(status) == jfailures.status_name(status)
    port, jax_summary = failures.RunSummary(), jfailures.RunSummary()
    for i, status in enumerate([0, 0, -1, -2, -2, 0, -2, -2, -2, -2, -2, -2, -2]):
        port.record_status(status, 0.1 * i)
        jax_summary.record_status(status, 0.1 * i)
    for summary in (port, jax_summary):
        summary.record_event("device OOM at frame-group size 8; re-solving at 4")
    assert port.format() == jax_summary.format()
    assert port.n_frames == 13 and port.n_failed == 9


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_span_disabled_is_a_shared_noop():
    assert trace.active_buffer() is None
    first = trace.span("anything", key="value")
    with first:
        pass
    assert first is trace.span("other") and trace.active_buffer() is None


def test_span_buffer_records_spans_and_beacons():
    buf = trace.install(trace.TraceBuffer())
    try:
        with trace.span("unit.work", cat="test", frame=3):
            pass
        buf.beacon("unit.phase_a", 0, 0.0, 7)
        buf.beacon("unit.phase_b", 1, 0.0, 7)  # closes phase_a's span
    finally:
        trace.uninstall()
    events = buf.to_chrome()["traceEvents"]
    spans = [e for e in events if e["name"] == "unit.work"]
    assert spans and spans[0]["ph"] == "X" and spans[0]["args"]["frame"] == 3
    assert [e["name"] for e in events if e["cat"] == "beacon"] == ["unit.phase_a"]
    buf.close_open_spans()
    assert [e["name"] for e in buf.to_chrome()["traceEvents"]
            if e["cat"] == "beacon"] == ["unit.phase_a", "unit.phase_b"]
    assert trace.span("after") is trace.span("uninstall")  # the no-op again


@pytest.mark.parametrize("bound,env", [(3, None), (None, "4")])
def test_span_buffer_is_bounded(monkeypatch, tmp_path, bound, env):
    if env is not None:
        monkeypatch.setenv("SART_TRACE_MAX_EVENTS", env)
    buf = trace.TraceBuffer(max_events=bound)
    for i in range(10):
        buf.add_instant(f"e{i}", "test", 1)
    kept = bound or int(env)
    chrome = buf.to_chrome()
    assert len(buf) == kept and chrome["otherData"]["dropped_events"] == 10 - kept
    assert chrome["traceEvents"][0]["name"] == "e0"  # the head survives
    sinks.ChromeTraceSink(str(tmp_path / "t.json")).write(buf)
    assert json.loads((tmp_path / "t.json").read_text()) == buf.to_chrome()


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform,kind", [
    ("tpu", "TPU v5 lite"), ("tpu", "TPU v5p"), ("tpu", "TPU v6e"), ("tpu", "TPU v4"),
    ("tpu", "TPU v9 prototype"), ("cpu", "cpu"), ("gpu", "NVIDIA A100-SXM4-80GB"),
])
def test_device_peaks_match_jax_off_the_h100(platform, kind):
    assert roofline.device_peaks(platform, kind, ndev=4) == \
        jroofline.device_peaks(platform, kind, ndev=4)


def test_device_peaks_h100_row_and_env(monkeypatch):
    peaks = roofline.device_peaks("gpu", "NVIDIA H100 80GB HBM3")
    assert (peaks["per_device_tflops"], peaks["per_device_hbm_gbs"]) == (989.0, 3350.0)
    assert peaks["source"] == "table:h100 80gb hbm3"
    assert peaks["hbm_bytes_s"] == 3.35e12 and peaks["mxu_flops_s"] == 989e12
    # the PCIe part is another card: not the SXM row
    assert roofline.device_peaks("gpu", "NVIDIA H100 PCIe")["source"] == "default"
    monkeypatch.setenv("SART_PEAK_HBM_GBS", "2000")
    peaks = roofline.device_peaks("gpu", "NVIDIA H100 80GB HBM3", ndev=2)
    assert peaks["per_device_hbm_gbs"] == 2000.0 and peaks["hbm_bytes_s"] == 4e12
    assert peaks["source"] == "env" and peaks["per_device_tflops"] == 989.0
    monkeypatch.setenv("SART_PEAK_MXU_TFLOPS", "500")
    assert roofline.device_peaks("gpu", "x") == jroofline.device_peaks("gpu", "x")


@pytest.mark.parametrize("shape", [(8192, 65536, 1, 4, 1), (8192, 65536, 8, 4, 1),
                                   (8192, 65536, 8, 2, 1), (16384, 65536, 1, 1, 2)])
def test_utilization_matches_jax(shape):
    cost = roofline.sweep_cost_model(*shape)
    assert cost == jroofline.sweep_cost_model(*shape)
    peaks = roofline.device_peaks("tpu", "TPU v5 lite")
    assert roofline.utilization(*cost, 640.0, peaks) == \
        jroofline.utilization(*cost, 640.0, jroofline.device_peaks("tpu", "TPU v5 lite"))
    # the H100: fp32 B = 8 one_read at 640 loop steps a second moves
    # 2 GiB a step, 1.37 TB/s: under the bytes roofline, far under the bf16 peak
    util = roofline.utilization(*roofline.sweep_cost_model(8192, 65536, 8, 4, 1), 640.0,
                                roofline.device_peaks("gpu", "NVIDIA H100 80GB HBM3"))
    assert util["bound"] == "hbm" and 0.40 < util["hbm_util"] < 0.42
    assert util["mxu_util"] < 0.02


# ---------------------------------------------------------------------------
# RunTelemetry and the aggregation
# ---------------------------------------------------------------------------

def test_record_buffers_skipped_when_disabled():
    telem = run.RunTelemetry(metrics.MetricsRegistry())
    for i in range(10):
        telem.record_frame(float(i), 0, 5, 1e-6, 2.0, "frame")
        telem.record_event(f"event {i}")
    assert telem._frames == [] and telem._events == []
    snap = {s["name"]: s for s in telem.registry.snapshot()}
    assert snap["frames_total"]["value"] == 10
    assert snap["availability_events_total"]["value"] == 10
    telem.finalize()  # no sink: writes nothing


def test_finalize_multihost_waits_for_the_multi_gpu_slice(tmp_path):
    """The multi-GPU slice has come: ``finalize(multihost=True)`` aggregates
    over the injected allgather (none: one process, the snapshot as it is)
    and the primary writes a valid artifact; a second call is a no-op."""
    telem = run.RunTelemetry(metrics.MetricsRegistry(), jsonl_path=str(tmp_path / "a.jsonl"))
    telem.record_frame(0.1, 0, 5, 1e-6, 2.0, "frame")
    telem.finalize(multihost=True)
    telem.finalize()
    assert schema.validate_jsonl(str(tmp_path / "a.jsonl"), require_run=True)[1] == []


@pytest.mark.parametrize("seed", SEEDS)
def test_aggregation_matches_jax(seed):
    """Two processes' snapshots through an injected allgather: the port's
    merge equals the JAX package's, and the encoded buffers are the same
    bytes."""
    snaps = [_apply(metrics.MetricsRegistry(), _ops(seed + k)).snapshot() for k in range(2)]
    rows = [run._encode_snapshot(s, 1 << 16)[0] for s in snaps]
    jrows = [jrun._encode_snapshot(s, 1 << 16)[0] for s in snaps]
    for a, b in zip(rows, jrows):
        np.testing.assert_array_equal(a, b)

    def allgather(_local):
        return np.stack(rows)

    got = run.aggregate_snapshots(snaps[0], allgather=allgather, max_bytes=1 << 16)
    assert got == jrun.aggregate_snapshots(snaps[0], allgather=allgather, max_bytes=1 << 16)
    assert run.aggregate_snapshots(snaps[0]) is snaps[0]  # one process


def test_encode_snapshot_truncation_keeps_counters():
    r = metrics.MetricsRegistry()
    for i in range(200):
        r.counter("c", idx=str(i)).inc(1)
    buf, truncated = run._encode_snapshot(r.snapshot(), 2048)
    assert truncated
    raw = buf.tobytes()
    decoded = json.loads(raw[8:8 + int.from_bytes(raw[:8], "little")].decode())
    assert any(s["name"] == "aggregation_truncated" for s in decoded)
    assert any(s["name"] == "c" for s in decoded)


# ---------------------------------------------------------------------------
# sartsolve metrics
# ---------------------------------------------------------------------------

def _artifact(path, seed, solve_scale=1.0, iters_shift=0, statuses=None):
    """A seeded run artifact: frames, one event, the registry's metrics."""
    rng = np.random.default_rng(seed)
    telem = run.RunTelemetry(metrics.MetricsRegistry(), jsonl_path=str(path))
    telem.set_run_info(backend="cuda", mesh="1x1", os_subsets=1, momentum="off",
                       logarithmic=False, operator="dense")
    statuses = statuses or [0] * 6
    summary = failures.RunSummary()
    for i, status in enumerate(statuses):
        iters = int(rng.integers(5, 100)) + iters_shift
        telem.record_frame(0.1 * i, status, iters, float(rng.random()),
                           float(rng.uniform(10, 20)) * solve_scale, "sched")
        summary.record_status(status, 0.1 * i)
    telem.registry.counter("sched_strides_total").inc(7)
    telem.record_event("device OOM in the continuous-batching scheduler")
    telem.finalize(summary)
    return str(path)


def _both(argv, capsys):
    """(exit code, stdout, stderr) of the port's tool and the JAX tool."""
    out = []
    for tool in (metrics_main, jax_metrics_main):
        rc = tool(list(argv))
        captured = capsys.readouterr()
        out.append((rc, captured.out, captured.err))
    return out


@pytest.mark.parametrize("mode", ["check", "check_json", "summary", "summary_json"])
def test_metrics_check_and_summary_match_jax(tmp_path, capsys, mode):
    path = _artifact(tmp_path / "a.jsonl", 0, statuses=[0, 0, -1, -2, 0, 0])
    capsys.readouterr()
    argv = (["--check"] if mode.startswith("check") else []) + \
        (["--json"] if mode.endswith("json") else []) + [path]
    port, jax_out = _both(argv, capsys)
    assert port == jax_out and port[0] == 0
    if mode == "summary":
        assert "6 frame(s)" in port[1] and "1 diverged" in port[1]


@pytest.mark.parametrize("case,threshold,rc", [
    ("same", "5", 0),
    ("slower", "50", 2),
    ("slower", "500", 0),
    ("more_iterations", "5", 2),
    ("statuses", None, 0),
])
def test_metrics_diff_and_threshold_match_jax(tmp_path, capsys, case, threshold, rc):
    old = _artifact(tmp_path / "old.jsonl", 1)
    new = _artifact(tmp_path / "new.jsonl", 1,
                    solve_scale=3.0 if case == "slower" else 1.0,
                    iters_shift=50 if case == "more_iterations" else 0,
                    statuses=[0, -1, 0, 0, -2, 0] if case == "statuses" else None)
    capsys.readouterr()
    argv = ["--diff"] + (["--threshold", threshold] if threshold else []) + [old, new]
    port, jax_out = _both(argv, capsys)
    assert port == jax_out and port[0] == rc
    if case == "statuses":
        assert "status diverged: 0 -> 1" in port[1]
    port, jax_out = _both(["--diff", "--json", old, new], capsys)
    assert port == jax_out


@pytest.mark.parametrize("argv", [[], ["--diff", "one.jsonl"], ["/does/not/exist.jsonl"],
                                  ["--threshold", "5", "a.jsonl"]])
def test_metrics_usage_errors_match_jax(capsys, argv):
    port, jax_out = _both(argv, capsys)
    assert port[0] == jax_out[0] == 1 and port[2] == jax_out[2]


def test_metrics_check_rejects_a_corrupt_artifact(tmp_path, capsys):
    path = _artifact(tmp_path / "a.jsonl", 2)
    lines = open(path).read().splitlines()
    broken = json.loads(lines[1])
    del broken["iterations"]
    lines[1] = json.dumps(broken)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    capsys.readouterr()
    port, jax_out = _both(["--check", path], capsys)
    assert port == jax_out and port[0] == 1 and "iterations" in port[2]
