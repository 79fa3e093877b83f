"""``serve`` / ``submit`` / ``fleet`` of the port (docs/SERVING.md).

Counterpart of ``sartsolver_tpu/engine/cli.py``: ``python -m
sartsolver_tpu_torch.cli serve`` / ``submit`` / ``fleet`` take every flag of
the JAX commands. The port builds its kernels at first use (the resident
session loads them while it is built), so the JAX
``configure_compilation_cache`` has no counterpart. ``serve --supervised``
and ``fleet`` run the port's supervisor and fleet controller
(``resilience/supervisor.py``), which import no torch: the parent process
never holds a CUDA context.

``serve`` takes the one-shot CLI's full flag set (the session is built
through the same validation gate and ingest) plus the engine options,
then runs resident: requests arrive as JSON files in
``<engine_dir>/ingest/`` or over the local socket, verdicts and
outcomes land in ``<engine_dir>/responses/``, solutions in
``<engine_dir>/outputs/<id>.h5``, and the request journal in
``<engine_dir>/journal.jsonl``.

``submit`` is the matching client: build or load a request payload,
validate it locally, hand it to a serve process (ingest dir or
socket), optionally wait for the outcome — with exit codes at parity
with the solver taxonomy (0 clean, 1 malformed input, 2 completed
with failed/deadline-shed frames, 3 rejected/unavailable, 4
interrupted).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from sartsolver_tpu_torch.engine.request import (
    REASON_MALFORMED,
    REQ_COMPLETED,
    RequestError,
    parse_request,
)
from sartsolver_tpu_torch.utils import atomicio

EXIT_OK = 0
EXIT_INPUT_ERROR = 1
EXIT_PARTIAL = 2
EXIT_INFRASTRUCTURE = 3
EXIT_INTERRUPTED = 4
SOCKET_PATH_MAX = 107  # bytes of an AF_UNIX path, its NUL not counted


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def build_serve_parser() -> argparse.ArgumentParser:
    from sartsolver_tpu_torch.cli import build_parser

    p = build_parser()
    p.prog = "sartsolve serve"
    p.description = (
        "Resident serving engine: hold the RTM and the solver on the "
        "device and solve queued requests against them "
        "(docs/SERVING.md)."
    )
    eng = p.add_argument_group("engine options")
    eng.add_argument("--engine_dir", required=True,
                     help="Engine state directory: ingest/ (file-watch "
                          "request intake), outputs/, responses/, "
                          "journal.jsonl.")
    eng.add_argument("--lanes", type=int, default=2,
                     help="Continuous-batcher lanes serving requests "
                          "(the fused sweep's batch B, one kernel plan; a "
                          "device OOM halves this, sticky). Default 2.")
    eng.add_argument("--max_queue", type=int, default=16,
                     help="Bounded accepted-request queue; a full queue "
                          "rejects with reason 'queue-full' instead of "
                          "queueing to death. Default 16.")
    eng.add_argument("--max_per_tenant", type=int, default=0,
                     help="Per-tenant in-queue cap (reason "
                          "'tenant-quota'); 0 = no cap (default).")
    eng.add_argument("--quarantine_after", type=int, default=3,
                     help="Consecutive failing requests before a tenant "
                          "is quarantined (reason 'tenant-quarantined'). "
                          "Default 3.")
    eng.add_argument("--quarantine_cooldown", type=float, default=60.0,
                     help="Tenant quarantine duration in seconds. "
                          "Default 60.")
    eng.add_argument("--default_deadline", type=float, default=None,
                     help="Default per-request deadline_s for requests "
                          "that carry none (default: no deadline).")
    eng.add_argument("--poll_interval", type=float, default=0.2,
                     help="Ingest-dir poll interval in seconds. "
                          "Default 0.2.")
    eng.add_argument("--socket", default=None, metavar="PATH",
                     help="Also serve admission on a local AF_UNIX "
                          "socket at PATH (synchronous verdict reply).")
    eng.add_argument("--idle_exit", type=float, default=0.0,
                     help="Exit 0 after this many seconds with an empty "
                          "queue (drills/CI); 0 = serve forever "
                          "(default).")
    eng.add_argument("--max_cycle_requests", type=int, default=8,
                     help="Requests co-batched into one solve cycle. "
                          "Default 8.")
    eng.add_argument("--http_port", type=int, default=None,
                     metavar="PORT",
                     help="Opt-in live pull endpoints on 127.0.0.1:PORT "
                          "(/metrics Prometheus exposition, /healthz "
                          "admission state, /status snapshot JSON; "
                          "docs/OBSERVABILITY.md §10). 0 binds an "
                          "ephemeral port. Default: no endpoint, no "
                          "thread.")
    eng.add_argument("--slo_ms", type=float, default=None,
                     help="Per-request latency target in milliseconds "
                          "(acceptance to completion, queue wait "
                          "included); tracked as the engine_slo_ok/"
                          "breach counter pair per tenant (error-budget "
                          "burn). Default: no SLO accounting.")
    eng.add_argument("--journal_rotate_bytes", type=int,
                     default=64 * 2 ** 20, metavar="N",
                     help="Journal rotation: compact completed-request "
                          "records at startup and whenever the journal "
                          "passes N bytes (the dedup watermark moves "
                          "into the state checkpoint first). 0 disables "
                          "rotation AND startup compaction. Default "
                          "64 MiB.")
    eng.add_argument("--response_ttl", type=float, default=7 * 86400.0,
                     metavar="S",
                     help="Retention sweep: delete response files older "
                          "than S seconds (0 = keep forever). Default "
                          "604800 (7 days).")
    eng.add_argument("--trace_ttl", type=float, default=86400.0,
                     metavar="S",
                     help="Retention sweep: delete per-request trace "
                          "files older than S seconds (0 = keep "
                          "forever). Default 86400 (1 day).")
    flt = p.add_argument_group("fleet membership (docs/SERVING.md §10)")
    flt.add_argument("--responses_dir", default=None, metavar="DIR",
                     help="Write verdict/outcome responses here instead "
                          "of <engine_dir>/responses (the fleet "
                          "controller points every worker at one shared "
                          "dir so clients poll a single place).")
    flt.add_argument("--outputs_dir", default=None, metavar="DIR",
                     help="Write solution HDF5 files here instead of "
                          "<engine_dir>/outputs (shared across a "
                          "fleet, like --responses_dir).")
    flt.add_argument("--worker_index", type=int, default=None,
                     metavar="K",
                     help="This worker's shard index in a fleet of "
                          "--fleet_size workers: requests whose tenant "
                          "hashes to a different shard are shed with "
                          "reason 'wrong-worker' (requests re-staged by "
                          "the controller's failover carry handoff=true "
                          "and bypass the check). Needs --fleet_size.")
    flt.add_argument("--fleet_size", type=int, default=None, metavar="M",
                     help="Total workers in the fleet (tenant-affinity "
                          "modulus). Needs --worker_index.")
    sup = p.add_argument_group(
        "supervision (docs/SERVING.md §9, docs/RESILIENCE.md §10)"
    )
    sup.add_argument("--supervised", action="store_true",
                     help="Run self-healing: a torch-free supervisor "
                          "process forks the serve worker and restarts "
                          "it across every abnormal exit (bounded "
                          "exponential backoff + crash-loop circuit "
                          "breaker -> lame-duck 503s). Deliberate exits "
                          "(0 idle, 4 drained, 1 config error) are "
                          "final.")
    sup.add_argument("--restart_backoff", type=float, default=1.0,
                     metavar="S",
                     help="Base respawn delay after a crash; doubles "
                          "per consecutive crash. Default 1.")
    sup.add_argument("--restart_backoff_max", type=float, default=30.0,
                     metavar="S",
                     help="Respawn delay ceiling. Default 30.")
    sup.add_argument("--crash_loop_window", type=float, default=60.0,
                     metavar="S",
                     help="Crash-loop breaker sliding window. Default "
                          "60.")
    sup.add_argument("--crash_loop_threshold", type=int, default=5,
                     metavar="N",
                     help="Crashes inside the window that open the "
                          "breaker (lame-duck mode: /healthz 503 + "
                          "machine-readable crash-loop rejections until "
                          "the window clears). Default 5.")
    sup.add_argument("--max_restarts", type=int, default=0, metavar="N",
                     help="Total restart budget; exhausted -> the "
                          "supervisor gives up with exit 3. 0 = "
                          "unlimited (default).")
    return p


def serve_main(argv: Optional[List[str]] = None) -> int:
    main_unix = time.time()  # the start split's anchor; the caller knows when the process began
    raw_argv = list(argv) if argv is not None else list(sys.argv[1:])
    if raw_argv[:1] == ["serve"]:  # direct serve_main(None) invocation
        raw_argv = raw_argv[1:]
    parser = build_serve_parser()
    try:
        args = parser.parse_args(raw_argv)
    except SystemExit as err:
        raise SystemExit(1 if err.code else 0) from None

    if (args.restart_backoff < 0 or args.restart_backoff_max < 0
            or args.crash_loop_window <= 0):
        print("Arguments restart_backoff/restart_backoff_max must be "
              ">= 0 and crash_loop_window > 0.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    if args.crash_loop_threshold < 1 or args.max_restarts < 0:
        print("Argument crash_loop_threshold must be >= 1 and "
              "max_restarts >= 0.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    if (args.journal_rotate_bytes < 0 or args.response_ttl < 0
            or args.trace_ttl < 0):
        print("Arguments journal_rotate_bytes/response_ttl/trace_ttl "
              "must be >= 0.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    if (args.worker_index is None) != (args.fleet_size is None):
        print("Arguments worker_index and fleet_size must be given "
              "together.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    if (args.worker_index is not None
            and not 0 <= args.worker_index < args.fleet_size):
        print("Argument worker_index must satisfy "
              "0 <= worker_index < fleet_size.", file=sys.stderr)
        return EXIT_INPUT_ERROR

    if args.supervised:
        # the supervisor imports no torch: it must stay alive through
        # exactly the failures that can wedge a worker's CUDA context, and
        # hold none of its own on the card
        from sartsolver_tpu_torch.resilience.supervisor import supervisor_main

        # argparse accepts unambiguous prefixes ("--super" parses as
        # --supervised): strip every token that resolved to the flag, or
        # the worker would parse as supervised too and spawn supervisors
        # recursively. "--su" is the shortest unambiguous prefix here.
        worker_argv = [
            a for a in raw_argv
            if not (len(a) >= 4 and "--supervised".startswith(a))
        ]
        return supervisor_main(args, worker_argv)

    # Deterministic crash hook for the restart-storm drill (tests/
    # test_selfheal.py): while the marker file exists the WORKER dies
    # abnormally right after flag parsing — fast enough to trip the
    # supervisor's crash-loop breaker on schedule. Sits after the
    # --supervised dispatch so the supervisor itself never fires it.
    # Zero work unset.
    crash_marker = os.environ.get("SART_TEST_SERVE_CRASH")
    if crash_marker and os.path.exists(crash_marker):
        print("SART_TEST_SERVE_CRASH firing (exit 3)", file=sys.stderr,
              flush=True)
        os._exit(3)

    from sartsolver_tpu_torch.cli import _validate

    _validate(args)
    if args.lanes < 1:
        print("Argument lanes must be >= 1.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    if args.max_queue < 1:
        print("Argument max_queue must be >= 1.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    if args.http_port is not None and not 0 <= args.http_port <= 65535:
        print("Argument http_port must be 0..65535.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    if args.socket and len(os.fsencode(args.socket)) > SOCKET_PATH_MAX:
        # an AF_UNIX address holds the path in sun_path (108 bytes with
        # its NUL): a longer one fails at bind, after the ingest
        print(f"Argument socket: {len(os.fsencode(args.socket))} bytes, an "
              f"AF_UNIX socket path holds at most {SOCKET_PATH_MAX}; give a "
              "shorter or a relative path.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    if args.slo_ms is not None and not args.slo_ms > 0:
        print("Argument slo_ms must be > 0.", file=sys.stderr)
        return EXIT_INPUT_ERROR

    t_imports = time.perf_counter()
    from sartsolver_tpu_torch.config import SartInputError
    from sartsolver_tpu_torch.engine.admission import AdmissionController
    from sartsolver_tpu_torch.engine.server import EngineServer
    from sartsolver_tpu_torch.engine.session import ResidentSession, SessionCache
    from sartsolver_tpu_torch.obs import flight as obs_flight
    from sartsolver_tpu_torch.obs.run import RunTelemetry
    from sartsolver_tpu_torch.resilience import shutdown, watchdog
    from sartsolver_tpu_torch.resilience.degrade import is_resource_exhausted
    from sartsolver_tpu_torch.resilience.failures import RunSummary
    from sartsolver_tpu_torch.resilience.retry import (
        RetriesExhausted, reset_retry_stats,
    )

    imports_s = time.perf_counter() - t_imports
    reset_retry_stats()
    # telemetry FIRST (it resets the metric registry; the engine's
    # instruments register against the fresh one)
    telem = RunTelemetry.from_cli(args.metrics_out)
    shutdown.install()
    obs_flight.install()
    status_path = obs_flight.default_status_path(
        os.path.join(args.engine_dir, "engine")
    )
    bundle_path = obs_flight.default_bundle_path(
        os.path.join(args.engine_dir, "engine")
    )
    prev_usr1 = obs_flight.install_status_handler(status_path)
    summary = RunSummary()
    watchdog.set_crash_hook(
        lambda reason: obs_flight.write_crash_bundle(
            bundle_path, reason, summary
        )
    )
    wd = watchdog.Watchdog.from_env(on_event=summary.record_event)
    if wd is not None:
        wd.start()
    abort_reason = None
    try:
        try:
            session = ResidentSession.build(args)
        except KeyError as err:
            print(f"Missing dataset or attribute in input files: {err}",
                  file=sys.stderr)
            return EXIT_INPUT_ERROR
        except (SartInputError, OSError) as err:
            print(err, file=sys.stderr)
            return EXIT_INPUT_ERROR
        warm_s = 0.0
        if session.device is not None and session.device.type == "cuda":
            # the first launches before ready (the server's launch counts
            # start after it); a device OOM here is left to the lane
            # ladder of the first request
            try:
                warm_s = session.warm_up(args.lanes)
                print(f"engine: warm-up stride at lanes={args.lanes} in "
                      f"{warm_s * 1e3:.1f} ms", flush=True)
            except RuntimeError as err:
                if not is_resource_exhausted(err):
                    raise
                print(f"engine: warm-up at lanes={args.lanes} skipped: device OOM",
                      flush=True)
        # where the start to ready went (a supervisor's restart reads it
        # beside its spawn time): the heavy imports (torch), the CUDA
        # context, the kernel libraries' load, the ingest and the solver's
        # construction, the warm-up stride
        split = dict(imports_s=imports_s, **session.build_split, warm_up_s=warm_s)
        print(f"engine: start split main_unix={main_unix:.3f} "
              + " ".join(f"{k}={v:.3f}" for k, v in split.items()), flush=True)
        telem.set_run_info(
            engine=True,
            lanes=int(args.lanes),
            max_queue=int(args.max_queue),
        )
        # multi-session residency (docs/SERVING.md §10): the eagerly
        # built default session is seeded into a byte-budgeted cache so
        # flag/input errors still surface before the first request, and
        # later keys warm through the same validated builder. A request
        # carrying an inline geometry record routes to its own key —
        # a matrix-free implicit session over the worker's image files
        # (docs/SERVING.md §11) — costing its ray table, not a second
        # RTM, under the same byte budget.
        import hashlib

        geo_records: dict = {}

        def _session_key_for(req) -> str:
            if req.geometry is None:
                return "default"
            digest = hashlib.sha1(json.dumps(
                req.geometry, sort_keys=True).encode()).hexdigest()[:12]
            key = f"geometry:{digest}"
            geo_records[key] = req.geometry
            return key

        def _build_session(key: str) -> ResidentSession:
            rec = geo_records.get(key)
            if rec is None:
                return ResidentSession.build(args)
            from sartsolver_tpu_torch.io import hdf5files as hf

            # the geometry replaces the worker's matrix files; its
            # cameras must match the worker's image files (checked by
            # the geometry build — a mismatch fails THIS request)
            geo_args = argparse.Namespace(**vars(args))
            _, image_files = hf.categorize_input_files(args.input_files)
            geo_args.input_files = image_files
            return ResidentSession.build(geo_args, geometry=rec)

        cache = SessionCache(_build_session, key_for=_session_key_for)
        cache.seed("default", session)
        admission = AdmissionController(
            max_queue=args.max_queue,
            max_per_tenant=args.max_per_tenant,
            quarantine_after=args.quarantine_after,
            quarantine_cooldown=args.quarantine_cooldown,
            affinity=((args.worker_index, args.fleet_size)
                      if args.worker_index is not None else None),
        )
        server = EngineServer(
            cache,
            engine_dir=args.engine_dir,
            lanes=args.lanes,
            admission=admission,
            poll_interval=args.poll_interval,
            socket_path=args.socket,
            default_deadline_s=args.default_deadline,
            idle_exit=args.idle_exit,
            max_cycle_requests=args.max_cycle_requests,
            telemetry=telem,
            http_port=args.http_port,
            slo_ms=args.slo_ms,
            journal_rotate_bytes=args.journal_rotate_bytes,
            response_ttl_s=args.response_ttl,
            trace_ttl_s=args.trace_ttl,
            responses_dir=args.responses_dir,
            outputs_dir=args.outputs_dir,
        )
        code = server.run()
        if code == EXIT_INTERRUPTED:
            abort_reason = (
                f"interrupted by {shutdown.stop_signal()} (exit 4)"
            )
        # clean/drain exits write a complete artifact; the finally
        # block's finalize_local stays the abort-path fallback
        telem.finalize(None)
        return code
    except RetriesExhausted as err:
        # the journal (or another retried site) failed permanently: the
        # engine must not serve unjournaled work — infrastructure abort
        abort_reason = f"retries exhausted: {err}"
        print(f"Unrecoverable after retries: {err}", file=sys.stderr)
        return EXIT_INFRASTRUCTURE
    except BaseException as err:
        abort_reason = f"unhandled {type(err).__name__}: {err}"
        raise
    finally:
        if abort_reason is not None:
            obs_flight.write_crash_bundle(bundle_path, abort_reason,
                                          summary)
        watchdog.set_crash_hook(None)
        obs_flight.uninstall_status_handler(prev_usr1)
        obs_flight.uninstall()
        if wd is not None:
            wd.stop()
        shutdown.uninstall()
        telem.finalize_local(None)


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------

def build_fleet_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sartsolve fleet",
        description="Run M supervised serve workers behind one "
                    "controller: tenant-affinity routing "
                    "(routing.json), shared responses/outputs dirs, "
                    "and journal-backed failover — a dead worker's "
                    "accepted-but-uncompleted requests are re-driven "
                    "on a survivor exactly once (docs/SERVING.md §10). "
                    "Worker flags (the full `sartsolve serve` set) go "
                    "after `--`.",
    )
    p.add_argument("--fleet_dir", required=True,
                   help="Fleet state directory: routing.json, "
                        "fleet.jsonl, shared ingest/responses/outputs, "
                        "workers/w<k>/ engine dirs.")
    p.add_argument("--size", type=int, default=3, metavar="M",
                   help="Worker count (tenant-affinity modulus). "
                        "Default 3.")
    p.add_argument("--base_port", type=int, default=None, metavar="PORT",
                   help="Give worker k the live endpoint PORT+k "
                        "(/readyz drives the controller's "
                        "load-balancing and drain detection). Default: "
                        "no endpoints.")
    p.add_argument("--restart_backoff", type=float, default=0.5,
                   metavar="S",
                   help="Base respawn delay after a worker crash; "
                        "doubles per consecutive crash. Default 0.5.")
    p.add_argument("--restart_backoff_max", type=float, default=10.0,
                   metavar="S",
                   help="Respawn delay ceiling. Default 10.")
    p.add_argument("--max_restarts", type=int, default=0, metavar="N",
                   help="Fleet-wide restart budget; exhausted -> exit "
                        "3. 0 = unlimited (default).")
    p.add_argument("--poll_interval", type=float, default=0.1,
                   metavar="S",
                   help="Controller loop interval (worker liveness, "
                        "intake routing). Default 0.1.")
    p.add_argument("worker_args", nargs=argparse.REMAINDER,
                   help="Flags forwarded to every worker's `sartsolve "
                        "serve` (put them after `--`).")
    return p


def fleet_cli_main(argv: Optional[List[str]] = None) -> int:
    parser = build_fleet_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as err:
        raise SystemExit(1 if err.code else 0) from None
    if args.size < 1:
        print("Argument size must be >= 1.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    if (args.restart_backoff < 0 or args.restart_backoff_max < 0
            or args.max_restarts < 0 or args.poll_interval <= 0):
        print("Arguments restart_backoff/restart_backoff_max/"
              "max_restarts must be >= 0 and poll_interval > 0.",
              file=sys.stderr)
        return EXIT_INPUT_ERROR
    if (args.base_port is not None
            and not 1 <= args.base_port <= 65535 - args.size):
        print("Argument base_port must leave room for size ports "
              "below 65536.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    worker_argv = list(args.worker_args)
    if worker_argv[:1] == ["--"]:
        worker_argv = worker_argv[1:]
    for banned in ("--engine_dir", "--worker_index", "--fleet_size",
                   "--responses_dir", "--outputs_dir", "--http_port",
                   "--supervised"):
        if any(a == banned or a.startswith(banned + "=")
               for a in worker_argv):
            print(f"sartsolve fleet: {banned} is controller-owned; "
                  "drop it from the worker flags.", file=sys.stderr)
            return EXIT_INPUT_ERROR

    # like `serve --supervised`, the controller imports no torch: it must
    # outlive exactly the failures that wedge a worker
    from sartsolver_tpu_torch.resilience.supervisor import FleetController

    controller = FleetController(
        worker_argv,
        fleet_dir=args.fleet_dir,
        size=args.size,
        base_port=args.base_port,
        backoff_base=args.restart_backoff,
        backoff_max=args.restart_backoff_max,
        max_restarts=args.max_restarts,
        poll_interval=args.poll_interval,
    )
    return controller.run()


# ---------------------------------------------------------------------------
# submit
# ---------------------------------------------------------------------------

def build_submit_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sartsolve submit",
        description="Submit a request to a running `sartsolve serve` "
                    "engine and optionally wait for its outcome "
                    "(docs/SERVING.md). Exit codes mirror the solver "
                    "taxonomy: 0 accepted/completed clean; 1 malformed "
                    "request or flags; 2 completed with failed or "
                    "deadline-shed frames; 3 rejected by admission "
                    "(machine-readable reason on stdout) or engine "
                    "unreachable.",
    )
    p.add_argument("request_file", nargs="?", default=None,
                   help="JSON request payload file; omit to build one "
                        "from --id/--tenant/--time_range/--deadline.")
    p.add_argument("--engine_dir", default=None,
                   help="Submit via the engine's ingest directory "
                        "(atomic rename into <engine_dir>/ingest/).")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="Submit over the engine's local socket "
                        "(synchronous admission verdict).")
    p.add_argument("--id", dest="req_id", default=None,
                   help="Request id (required without request_file).")
    p.add_argument("--tenant", default="default")
    p.add_argument("--time_range", default="",
                   help="Frame selection (solver -t grammar; empty = "
                        "all frames).")
    p.add_argument("--deadline", type=float, default=None,
                   help="deadline_s: wall-clock budget from acceptance.")
    p.add_argument("--trace", default=None, metavar="ID",
                   help="Propagate a caller-chosen trace id (payload "
                        "'trace' field; 1-128 chars of [A-Za-z0-9._-]). "
                        "Without it the engine assigns one at admission; "
                        "either way it lands in the response, journal "
                        "markers and trace spans "
                        "(docs/OBSERVABILITY.md §10).")
    p.add_argument("--geometry", default=None, metavar="FILE",
                   help="Attach a matrix-free implicit operator: inline "
                        "the geometry record FILE (docs/FORMATS.md "
                        "§geometry) into the payload's 'geometry' field "
                        "— the engine solves this request on a "
                        "geometry-keyed session instead of its resident "
                        "RTM (docs/SERVING.md §11).")
    p.add_argument("--wait", type=float, default=0.0, metavar="S",
                   help="Wait up to S seconds for the outcome response "
                        "(needs --engine_dir; 0 = do not wait).")
    p.add_argument("--retry", type=int, default=0, metavar="N",
                   help="On a retryable rejection (queue-full, "
                        "tenant-quota, degraded, draining, "
                        "tenant-quarantined, crash-loop) resubmit up "
                        "to N times with "
                        "bounded backoff, honoring the engine's "
                        "retry_after_s hint (resilience/retry.py "
                        "policy bounds the total via "
                        "SART_RETRY_DEADLINE). Needs a verdict: "
                        "--socket, or --engine_dir with --wait. "
                        "Default 0 (no retry).")
    return p


def _outcome_exit(rec: dict, echo: bool = True) -> int:
    """Exit code for a verdict/outcome record; ``echo=False`` defers
    the stdout JSON to the caller (the --retry loop prints only the
    FINAL record, not every rejected attempt)."""
    if rec.get("verdict") == "rejected":
        reason = rec.get("reason")
        if echo:
            print(json.dumps(rec))
        return (EXIT_INPUT_ERROR if reason == REASON_MALFORMED
                else EXIT_INFRASTRUCTURE)
    outcome = rec.get("outcome") or {}
    if echo:
        print(json.dumps(rec))
    state = rec.get("state")
    if state == "interrupted":
        return EXIT_INTERRUPTED
    if not outcome:
        return EXIT_OK  # accepted, not waited for
    status = outcome.get("status")
    if status == REQ_COMPLETED:
        return EXIT_OK
    if status in ("partial", "shed-deadline"):
        return EXIT_PARTIAL
    return EXIT_INFRASTRUCTURE  # failed / unknown


def submit_main(argv: Optional[List[str]] = None) -> int:
    parser = build_submit_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as err:
        raise SystemExit(1 if err.code else 0) from None
    if (args.engine_dir is None) == (args.socket is None):
        print("sartsolve submit: exactly one of --engine_dir or "
              "--socket is required.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    if args.request_file is not None:
        try:
            with open(args.request_file) as f:
                payload_text = f.read()
        except OSError as err:
            print(err, file=sys.stderr)
            return EXIT_INPUT_ERROR
    else:
        if not args.req_id:
            print("sartsolve submit: --id is required without a "
                  "request file.", file=sys.stderr)
            return EXIT_INPUT_ERROR
        payload = {"id": args.req_id, "tenant": args.tenant,
                   "time_range": args.time_range}
        if args.deadline is not None:
            payload["deadline_s"] = args.deadline
        if args.trace is not None:
            payload["trace"] = args.trace
        payload_text = json.dumps(payload)
    if args.geometry is not None:
        # validate + canonicalize the record HERE, client-side, then
        # inline it: the payload is self-contained (the engine and its
        # journal replay never need the client's file)
        from sartsolver_tpu_torch.config import SartInputError
        from sartsolver_tpu_torch.operators.geometry import load_geometry

        try:
            record = load_geometry(args.geometry)
        except SartInputError as err:
            print(err, file=sys.stderr)
            return EXIT_INPUT_ERROR
        try:
            payload = json.loads(payload_text)
        except ValueError:
            payload = None
        if isinstance(payload, dict):
            payload["geometry"] = record.to_dict()
            payload_text = json.dumps(payload)
    if args.trace is not None and args.request_file is not None:
        # propagate the caller's trace id into a file payload too; an
        # unparseable file falls through to the local validation below,
        # which produces the polite input-error message
        try:
            payload = json.loads(payload_text)
            if isinstance(payload, dict):
                payload["trace"] = args.trace
                payload_text = json.dumps(payload)
        except ValueError:
            pass
    # local validation: a malformed request fails HERE with the polite
    # input-error exit, before it ever reaches the engine
    try:
        req = parse_request(payload_text)
    except RequestError as err:
        print(err, file=sys.stderr)
        return EXIT_INPUT_ERROR

    if args.retry < 0:
        print("sartsolve submit: --retry must be >= 0.", file=sys.stderr)
        return EXIT_INPUT_ERROR
    if args.retry and args.engine_dir is not None and args.wait <= 0:
        print("sartsolve submit: --retry needs a verdict to judge — "
              "use --socket, or --engine_dir with --wait.",
              file=sys.stderr)
        return EXIT_INPUT_ERROR

    if args.retry:
        from sartsolver_tpu_torch.engine.request import RETRYABLE_REASONS
        from sartsolver_tpu_torch.resilience.faults import site_seed
        from sartsolver_tpu_torch.resilience.retry import RetryPolicy

        import numpy as np

        # backpressure etiquette (docs/SERVING.md §3): a lame-duck or
        # saturated engine tells clients how long to back off; the
        # shared retry policy bounds the total (SART_RETRY_DEADLINE)
        # and supplies the jittered floor when no hint arrives
        policy = RetryPolicy.from_env()
        rng = np.random.default_rng(
            [site_seed("submit.retry"), os.getpid()]
        )
        start = time.monotonic()
        for attempt in range(args.retry + 1):
            rec, code = _submit_attempt(args, req, payload_text)
            reason = (rec or {}).get("reason")
            retryable = (rec is not None
                         and rec.get("verdict") == "rejected"
                         and reason in RETRYABLE_REASONS)
            if (not retryable or attempt >= args.retry
                    or time.monotonic() - start >= policy.deadline):
                if rec is not None:
                    print(json.dumps(rec))
                return code
            hint = float(rec.get("retry_after_s") or 0.0)
            delay = max(hint, policy.backoff(attempt + 1, rng))
            print(f"sartsolve submit: rejected ({reason}); retry "
                  f"{attempt + 1}/{args.retry} in {delay:.1f}s",
                  file=sys.stderr)
            time.sleep(delay)
        return EXIT_INFRASTRUCTURE  # pragma: no cover - loop returns

    rec, code = _submit_attempt(args, req, payload_text)
    if rec is not None:
        print(json.dumps(rec))
    return code


def _submit_attempt(args, req, payload_text):
    """One submission round trip. Returns ``(record, exit_code)`` —
    record is the verdict/outcome JSON to print (None when the failure
    already printed its own stderr message)."""
    if args.socket:
        import socket as socketmod

        if not hasattr(socketmod, "AF_UNIX"):
            print("sartsolve submit: AF_UNIX sockets unavailable on "
                  "this platform; use --engine_dir.", file=sys.stderr)
            return None, EXIT_INFRASTRUCTURE
        try:
            sock = socketmod.socket(socketmod.AF_UNIX,
                                    socketmod.SOCK_STREAM)
            sock.settimeout(10.0)
            sock.connect(args.socket)
            sock.sendall(payload_text.encode())
            sock.shutdown(socketmod.SHUT_WR)
            chunks = []
            while True:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                chunks.append(chunk)
            sock.close()
        except OSError as err:
            print(f"sartsolve submit: socket submit failed: {err}",
                  file=sys.stderr)
            return None, EXIT_INFRASTRUCTURE
        try:
            rec = json.loads(b"".join(chunks).decode())
        except ValueError:
            print("sartsolve submit: unreadable engine reply.",
                  file=sys.stderr)
            return None, EXIT_INFRASTRUCTURE
        return rec, _outcome_exit(rec, echo=False)

    ingest = os.path.join(args.engine_dir, "ingest")
    responses = os.path.join(args.engine_dir, "responses")
    # fleet awareness: when --engine_dir is a fleet dir (it holds a
    # routing.json), resolve this tenant's affinity worker. Resolution
    # happens here — inside the per-attempt path — so every --retry
    # attempt re-reads the table and follows a failover that moved the
    # tenant's shard between attempts. A down worker (or torn table)
    # falls back to the controller intake dir, which routes centrally.
    from sartsolver_tpu_torch.engine import routing as fleet_routing

    routing = fleet_routing.read_routing(args.engine_dir)
    if routing is not None:
        row = fleet_routing.resolve_worker(routing, req.tenant)
        if (row is not None and row.get("state") == "up"
                and row.get("ingest_dir")):
            ingest = row["ingest_dir"]
        elif routing.get("ingest_dir"):
            ingest = routing["ingest_dir"]
        responses = routing.get("responses_dir") or responses
    if not os.path.isdir(ingest):
        print(f"sartsolve submit: no engine ingest dir at {ingest} "
              "(is `sartsolve serve` running with this --engine_dir?).",
              file=sys.stderr)
        return None, EXIT_INFRASTRUCTURE
    t_submit = time.time()
    final = os.path.join(ingest, f"{req.id}.json")
    try:
        # atomic rename publish: the engine's ingest scan only picks up
        # `*.json`, and atomicio's tmp name (`<id>.json.<pid>.tmp`)
        # never matches, so a torn submit is invisible to the scan.
        # fsync'd so a machine crash can't admit a truncated request.
        atomicio.write_atomic(final, payload_text, fsync=True)
    except OSError as err:
        print(f"sartsolve submit: submit failed: {err}", file=sys.stderr)
        return None, EXIT_INFRASTRUCTURE
    if args.wait <= 0:
        rec = {"id": req.id, "state": "submitted"}
        if args.trace is not None:
            rec["trace"] = args.trace
        return rec, EXIT_OK
    resp_path = os.path.join(responses, f"{req.id}.json")
    deadline = time.monotonic() + args.wait
    while time.monotonic() < deadline:
        try:
            with open(resp_path) as f:
                rec = json.loads(f.read())
        except (OSError, ValueError):
            rec = None
        # only responses written AFTER this submit count — a stale
        # record from an earlier submission of the same id (e.g. the
        # duplicate-rejection flow) must not read as this one's outcome
        if rec and rec.get("unix", 0) >= t_submit - 0.05:
            if (rec.get("verdict") == "rejected"
                    or rec.get("state") in ("done", "interrupted")):
                return rec, _outcome_exit(rec, echo=False)
        time.sleep(0.1)
    print(f"sartsolve submit: no outcome for {req.id!r} within "
          f"{args.wait:g}s.", file=sys.stderr)
    return None, EXIT_INFRASTRUCTURE
