"""The port's request-lifecycle observatory against the JAX engine's.

Ported from ``tests/test_request_trace.py``: trace ids ride the payload or
are assigned at parse time; the request tracks of ``obs/trace.py`` hold the
JAX buffer's events for the same calls, under the same cap; a traced serve
run yields, per request, a Perfetto-loadable section with the full
lifecycle (admission, queue.wait, the journal markers, session.attach, the
scheduler's per-stride spans, lane.retire, io.write, request.done); the
``--http_port`` /metrics scrape equals the Prometheus textfile of the same
snapshot, and /healthz, /readyz and /status answer from host state; without
``--http_port`` and tracing a serve run makes no endpoint, no traces
directory and no thread; the SLO counter pair; the crash bundle and the
journal name the requests in flight.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

import fixtures as fx

from sartsolver_tpu.engine.request import parse_request as jparse_request
from sartsolver_tpu.obs import trace as jtrace

from sartsolver_tpu_torch.engine import admission as adm_mod
from sartsolver_tpu_torch.engine.request import RequestError, parse_request
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.obs import sinks as obs_sinks
from sartsolver_tpu_torch.obs import trace as obs_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, per subprocess
SOLVE_FLAGS = ["--use_cpu", "-m", "40", "-c", "1e-12"]


def test_trace_id_passthrough_and_assignment():
    req = parse_request('{"id": "a", "trace": "client.span-1"}')
    assert req.trace == "client.span-1" == jparse_request(
        '{"id": "a", "trace": "client.span-1"}').trace
    req = parse_request('{"id": "b"}')
    assert req.trace and len(req.trace) == 16
    assert parse_request(json.dumps(req.to_dict())).trace == req.trace
    with pytest.raises(RequestError):
        parse_request('{"id": "c", "trace": "no spaces"}')
    with pytest.raises(RequestError):
        parse_request('{"id": "c", "trace": ""}')


def _events_of(mod):
    """One script of request-track calls through ``mod``'s trace module;
    the recorded events without their clock and pid."""
    buf = mod.install(mod.TraceBuffer())
    try:
        with mod.request_span("tr-1", "session.attach", time_range="0:1"):
            pass
        mod.request_instant("tr-1", "admission", verdict="accepted")
        mod.request_complete("tr-1", "queue.wait", 1.0, 2.0, tenant="a")
        mod.request_instant("tr-2", "admission", verdict="rejected")
        mod.request_instant(None, "ignored")
        with mod.request_span("", "ignored"):
            pass
        with mod.span("host.work", what="x"):
            pass
        trace = mod.request_trace("tr-1")
        missing = mod.request_trace("nope")
    finally:
        mod.uninstall()
    assert mod.request_trace("tr-1") is None  # disabled again

    def strip(events):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
                for e in events]

    return strip(buf.to_chrome()["traceEvents"]), strip(trace["traceEvents"]), missing


def test_request_tracks_match_jax():
    got, want = _events_of(obs_trace), _events_of(jtrace)
    for g, w in zip(got[:2], want[:2]):
        # host spans carry the thread ident: compare the request tracks'
        assert [e for e in g if e.get("cat") != "host"] == \
            [e for e in w if e.get("cat") != "host"]
    assert got[2] is None and want[2] is None


def test_trace_buffer_track_cap():
    """A saturated buffer stops allocating request tracks (and their
    metadata rows): the track table is bounded by the event cap."""
    buf = obs_trace.TraceBuffer(max_events=4)
    buf.add_request_instant("t1", "a")  # metadata + instant = 2 events
    buf.add_request_instant("t1", "b")  # 3
    buf.add_request_instant("t2", "a")  # 4 (track t2's metadata) + drop
    for i in range(20):
        buf.add_request_instant(f"late-{i}", "x")  # all dropped
    assert len(buf._tracks) <= 4
    chrome = buf.to_chrome()
    assert len(chrome["traceEvents"]) == 4
    assert chrome["otherData"]["dropped_events"] >= 20
    assert buf.request_events("late-5") is None


def test_prometheus_renders_quantile_series():
    reg = obs_metrics.MetricsRegistry()
    reg.histogram("engine_queue_wait_s").observe(0.25)
    text = obs_sinks.render_prometheus(reg.snapshot())
    for suffix in ("_p50", "_p95", "_p99"):
        assert f"sart_engine_queue_wait_s{suffix}" in text


# ---------------------------------------------------------------------------
# in-process serve runs
# ---------------------------------------------------------------------------

def _inputs(paths):
    return [paths[k] for k in ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    td = tmp_path_factory.mktemp("torch_trace_world")
    paths, *_ = fx.write_world(str(td), n_frames=4)
    return paths


@pytest.fixture(scope="module")
def session(world):
    from sartsolver_tpu_torch.cli import _validate
    from sartsolver_tpu_torch.engine.cli import build_serve_parser
    from sartsolver_tpu_torch.engine.session import ResidentSession

    args = build_serve_parser().parse_args(
        ["--engine_dir", "/nonexistent-unused", *SOLVE_FLAGS, *_inputs(world)])
    _validate(args)
    return ResidentSession.build(args)


def _run_server(session, eng_dir, requests, **kw):
    from sartsolver_tpu_torch.engine.server import EngineServer

    os.makedirs(os.path.join(eng_dir, "ingest"), exist_ok=True)
    for i, payload in enumerate(requests):
        with open(os.path.join(eng_dir, "ingest", f"{i:03d}-{payload['id']}.json"),
                  "w") as f:
            json.dump(payload, f)
    admission = kw.pop("admission", None) or adm_mod.AdmissionController(max_queue=16)
    server = EngineServer(session, engine_dir=eng_dir, lanes=kw.pop("lanes", 2),
                          admission=admission, poll_interval=0.05,
                          idle_exit=kw.pop("idle_exit", 0.4), **kw)
    rc = server.run()
    return server, rc


def test_serve_run_span_completeness(session, tmp_path):
    """One traced serve round trip: the request's track holds the full
    lifecycle and lands as a standalone trace file; the trace id joins the
    journal markers and the response record."""
    obs_metrics.reset_registry()
    buf = obs_trace.install(obs_trace.TraceBuffer())
    eng = str(tmp_path / "eng")
    try:
        _, rc = _run_server(session, eng, [
            {"id": "traced", "tenant": "a", "trace": "trace-0001"},
        ])
    finally:
        obs_trace.uninstall()
    assert rc == 0
    with open(os.path.join(eng, "responses", "traced.json")) as f:
        resp = json.load(f)
    assert resp["trace"] == "trace-0001"
    assert resp["outcome"]["trace"] == "trace-0001"
    markers = {}
    with open(os.path.join(eng, "journal.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            markers[rec["marker"]] = rec
    for marker in ("accepted", "dispatched", "completed"):
        assert markers[marker]["trace"] == "trace-0001", marker
    payload = buf.request_events("trace-0001")
    names = [e["name"] for e in payload["traceEvents"]]
    for expected in ("thread_name", "admission", "queue.wait",
                     "journal.accepted", "journal.dispatched",
                     "journal.completed", "session.attach",
                     "sched.stride", "lane.retire", "io.write",
                     "request.done"):
        assert expected in names, (expected, names)
    assert len({e["tid"] for e in payload["traceEvents"]}) == 1
    strides = [e for e in payload["traceEvents"] if e["name"] == "sched.stride"]
    for ev in strides:
        assert {"lane", "iters", "stride", "occupancy"} <= set(ev["args"])
        assert ev["args"]["trace"] == "trace-0001"
    assert sum(e["args"]["iters"] for e in strides) == 4 * 40  # 4 frames to the cap
    retire = [e for e in payload["traceEvents"] if e["name"] == "lane.retire"]
    assert len(retire) == 4
    assert all(e["args"]["status"] == -1 and e["args"]["iterations"] == 40 for e in retire)
    with open(os.path.join(eng, "traces", "traced.trace.json")) as f:
        published = json.load(f)
    assert published["otherData"]["trace"] == "trace-0001"
    assert [e["name"] for e in published["traceEvents"]] == names


def test_trace_rides_metrics_artifact(session, tmp_path):
    """Frame records in the run artifact carry the request trace id."""
    from sartsolver_tpu_torch.obs.run import RunTelemetry

    obs_metrics.reset_registry()
    telem = RunTelemetry(jsonl_path=str(tmp_path / "run.jsonl"))
    eng = str(tmp_path / "eng")
    _, rc = _run_server(session, eng, [{"id": "ok1", "tenant": "a", "trace": "tr-ok"}],
                        telemetry=telem)
    assert rc == 0
    telem.finalize(None)
    with open(str(tmp_path / "run.jsonl")) as f:
        frames = [rec for rec in map(json.loads, f) if rec.get("type") == "frame"]
    assert len(frames) == 4 and all(fr["trace"] == "tr-ok" for fr in frames)


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def test_scrape_vs_textfile_byte_parity(tmp_path):
    """/metrics is rendered from the same snapshot by the same renderer as
    the Prometheus textfile sink: byte-equivalent."""
    from sartsolver_tpu_torch.engine.httpd import EngineHTTPServer

    reg = obs_metrics.MetricsRegistry()
    reg.counter("frames_total", status="success").inc(3)
    reg.gauge("engine_lanes").set(2)
    reg.histogram("engine_queue_wait_s").observe(0.05)
    reg.histogram("engine_queue_wait_s", tenant="a").observe(0.05)
    frozen = reg.snapshot()
    srv = EngineHTTPServer(0, metrics_snapshot=lambda: frozen,
                           health=lambda: ("ok", None), status=lambda: {"type": "status"})
    srv.start()
    try:
        code, scraped = _get(f"http://127.0.0.1:{srv.port}/metrics")
        assert code == 200
        prom_path = str(tmp_path / "metrics.prom")
        obs_sinks.PromSink(prom_path).write(frozen)
        with open(prom_path, "rb") as f:
            assert scraped == f.read()
        with pytest.raises(urllib.error.HTTPError):
            _get(f"http://127.0.0.1:{srv.port}/nope")
    finally:
        srv.stop()


def test_endpoints_on_live_engine(session, tmp_path, monkeypatch):
    """A real serve loop with --http_port: /healthz live, /readyz ready
    then draining 503, /status with the engine section, /metrics, and
    ``top http://...`` renders live (exit 1 once the engine is gone)."""
    from sartsolver_tpu_torch.engine.httpd import EngineHTTPServer
    from sartsolver_tpu_torch.engine.server import EngineServer
    from sartsolver_tpu_torch.obs.cli import render_top, top_main
    from sartsolver_tpu_torch.resilience import shutdown

    obs_metrics.reset_registry()
    obs_metrics.get_registry().histogram("engine_queue_wait_s").observe(0.01)
    eng = str(tmp_path / "eng")
    os.makedirs(os.path.join(eng, "ingest"), exist_ok=True)
    server = EngineServer(session, engine_dir=eng, lanes=2,
                          admission=adm_mod.AdmissionController(max_queue=4),
                          poll_interval=0.05, idle_exit=0.0, http_port=0)
    stop = {"flag": False}
    monkeypatch.setattr(shutdown, "stop_requested", lambda: stop["flag"])
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 30
        while server.http is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert server.http is not None
        base = f"http://127.0.0.1:{server.http.port}"
        code, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "live"
        code, body = _get(base + "/readyz")
        assert code == 200 and json.loads(body)["status"] == "ready"
        code, body = _get(base + "/status")
        rec = json.loads(body)
        assert code == 200 and rec["type"] == "status"
        assert rec["engine"]["queue_depth"] == 0 and rec["engine"]["lanes"] == 2
        code, body = _get(base + "/metrics")
        assert code == 200 and b"sart_engine_queue_wait_s_p99" in body
        screen = render_top(base)
        assert "engine" in screen and "sart_engine_queue_wait_s" in screen
        assert top_main([base, "--once"]) == 0
    finally:
        stop["flag"] = True
        t.join(timeout=60)
    assert not t.is_alive()
    assert server.http is None
    assert server._ready()[0] == "draining"
    srv = EngineHTTPServer(0, metrics_snapshot=lambda: [], health=server._health,
                           ready=server._ready, status=lambda: {})
    srv.start()
    try:
        code, body = _get(f"http://127.0.0.1:{srv.port}/healthz")
        assert code == 200 and json.loads(body)["status"] == "live"
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"http://127.0.0.1:{srv.port}/readyz")
        assert exc.value.code == 503
        rec = json.loads(exc.value.read())
        assert rec["status"] == "not-ready" and rec["reason"] == "draining"
    finally:
        srv.stop()
    assert top_main(["http://127.0.0.1:1/", "--once"]) == 1


def test_http_port_bind_failure_is_input_error(session, tmp_path, monkeypatch):
    """An unbindable --http_port exits with the input-error code."""
    from sartsolver_tpu_torch.engine.server import EngineServer

    monkeypatch.setenv("SART_HTTP_BIND_RETRY_S", "0.2")
    obs_metrics.reset_registry()
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    holder.listen(1)
    try:
        server = EngineServer(session, engine_dir=str(tmp_path / "eng"), lanes=2,
                              admission=adm_mod.AdmissionController(max_queue=4),
                              idle_exit=0.2, http_port=holder.getsockname()[1])
        assert server.run() == 1
        assert server.http is None
    finally:
        holder.close()


def test_disabled_path_identity(session, tmp_path):
    """Without --http_port and tracing: no traces dir, no endpoint, no
    extra threads after the run; the trace ids still ride the journal and
    the response."""
    obs_metrics.reset_registry()
    before = threading.active_count()
    eng = str(tmp_path / "eng")
    server, rc = _run_server(session, eng, [{"id": "plain", "tenant": "a"}])
    assert rc == 0
    assert server.http is None
    assert not os.path.exists(os.path.join(eng, "traces"))
    assert threading.active_count() == before
    with open(os.path.join(eng, "responses", "plain.json")) as f:
        assert json.load(f)["trace"]


def test_slo_counter_pair_on_live_run(session, tmp_path):
    """--slo_ms: a generous target burns no budget; a 0.001 ms target
    breaches on every request."""
    obs_metrics.reset_registry()
    _run_server(session, str(tmp_path / "eng"), [{"id": "s1", "tenant": "a"}],
                slo_ms=10 * 60 * 1000.0)
    snap = {(s["name"], tuple(sorted(s["labels"].items()))): s
            for s in obs_metrics.get_registry().snapshot()}
    assert snap[("engine_slo_ok_total", (("tenant", "a"),))]["value"] == 1
    assert ("engine_slo_breach_total", (("tenant", "a"),)) not in snap
    obs_metrics.reset_registry()
    _run_server(session, str(tmp_path / "eng2"), [{"id": "s2", "tenant": "b"}],
                slo_ms=0.001)
    snap = {(s["name"], tuple(sorted(s["labels"].items()))): s
            for s in obs_metrics.get_registry().snapshot()}
    assert snap[("engine_slo_breach_total", (("tenant", "b"),))]["value"] == 1


def test_crash_bundle_names_inflight_traces(session, tmp_path):
    """The crash bundle's engine section carries the live request table
    (id, trace id, last span) through the non-blocking snapshot path."""
    from sartsolver_tpu_torch.engine.server import EngineServer
    from sartsolver_tpu_torch.obs import flight as obs_flight
    from sartsolver_tpu_torch.resilience import watchdog

    obs_metrics.reset_registry()
    server = EngineServer(session, engine_dir=str(tmp_path / "eng"), lanes=2,
                          admission=adm_mod.AdmissionController(max_queue=4))
    req = parse_request('{"id": "wedged", "trace": "tr-wedged"}')
    server._set_span(req, "solve")
    server._active_ids.append("wedged")
    watchdog.set_engine_status_provider(server._status)
    try:
        bundle_path = str(tmp_path / "crash.json")
        assert obs_flight.write_crash_bundle(bundle_path, "watchdog abort (drill)")
        with open(bundle_path) as f:
            bundle = json.load(f)
        table = bundle["status"]["engine"]["requests"]
        assert table["wedged"] == {"trace": "tr-wedged", "span": "solve"}
        assert "wedged" in bundle["status"]["engine"]["active_requests"]
    finally:
        watchdog.set_engine_status_provider(None)


def test_sigkill_journal_names_inflight_trace(tmp_path):
    """SIGKILL a real serve inside the dispatched journal window: the
    in-flight request's accepted and dispatched markers carry its trace
    id, and no completed marker landed."""
    td = tmp_path / "world"
    td.mkdir()
    paths, *_ = fx.write_world(str(td), n_frames=3)
    eng = str(tmp_path / "eng")
    os.makedirs(os.path.join(eng, "ingest"))
    with open(os.path.join(eng, "ingest", "0-k.json"), "w") as f:
        json.dump({"id": "kill1", "trace": "tr-kill1"}, f)
    env = {k: v for k, v in os.environ.items() if k != "SART_FAULT"}
    env.update(PYTHONUNBUFFERED="1", SART_TEST_JOURNAL_DELAY="1.0",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sartsolver_tpu_torch.cli", "serve", "--engine_dir", eng,
         *SOLVE_FLAGS, "--lanes", "2", "--poll_interval", "0.05", *_inputs(paths)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    killer = threading.Timer(TIMEOUT, proc.kill)
    killer.start()
    try:
        for line in proc.stdout:
            if "SART_JOURNAL_POINT dispatched" in line:
                proc.kill()
                break
        proc.wait(timeout=30)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    markers = []
    with open(os.path.join(eng, "journal.jsonl")) as f:
        for line in f:
            try:
                markers.append(json.loads(line))
            except ValueError:
                pass  # a torn tail: the kill window's own contract
    by_marker = {m["marker"]: m for m in markers}
    assert by_marker["accepted"]["trace"] == "tr-kill1"
    assert by_marker["dispatched"]["trace"] == "tr-kill1"
    assert "completed" not in by_marker
