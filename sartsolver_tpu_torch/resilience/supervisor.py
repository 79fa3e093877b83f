"""Supervised serve: keep the resident engine alive across crashes.

Counterpart of ``sartsolver_tpu/resilience/supervisor.py``, host-only: it
imports neither torch nor JAX, so the supervisor never holds a CUDA context
on the card its worker runs on, and it outlives whatever wedges or kills
the worker's. It spawns the port's worker, ``python -m
sartsolver_tpu_torch.cli serve``, and its events, files and exit codes are
the JAX supervisor's.

``serve --supervised`` (docs/SERVING.md §9) turns the serve
process from a single point of failure into a self-healing pair: this
module is the *supervisor* — a small parent process that
spawns the real serve worker and keeps it alive across every abnormal
exit (watchdog ``os._exit(3)``, SDC quarantine, OOM kill, segfault,
``kill -9``). An unhandled exception in the worker (a sticky CUDA error
among them) exits 1, which is final here, as an ``XlaRuntimeError`` is for
the JAX supervisor. The escalation ladder sits one level above the watchdog's
(docs/RESILIENCE.md §10):

- **Restart with bounded exponential backoff** — each consecutive crash
  doubles the respawn delay (``--restart_backoff`` base, capped at
  ``--restart_backoff_max``); a worker that stayed alive longer than
  the crash-loop window resets the streak. Durable engine state
  (engine/state.py) + journal replay make the restart cheap and
  exactly-once.
- **Crash-loop circuit breaker** — ``--crash_loop_threshold`` crashes
  inside a sliding ``--crash_loop_window`` open the breaker:
  **lame-duck mode**. The supervisor stops burning restarts, serves
  ``/healthz`` = 503 (``crash-loop``) on the worker's ``--http_port``,
  and *journals-but-refuses* admissions: every request landing in the
  ingest dir gets a machine-readable ``crash-loop`` rejection response
  (with a ``retry_after_s`` hint — the remaining breaker window) and a
  record in ``supervisor.jsonl``, until the window clears and the
  breaker half-opens into one more restart.
- **Deliberate exits are final** — worker exit 0 (idle), 4 (drained
  after SIGTERM) and 1 (flag/config error: restarting would loop
  pointlessly) end the supervisor with the same code.

SIGTERM/SIGINT at the supervisor forwards ONE SIGTERM to the worker for
a graceful drain (journal + state checkpoint land; exit 4); a second
signal SIGKILLs the worker and dies by the signal.

Observability: every restart increments
``engine_restarts_total{reason=...}`` and lame-duck flips the
``engine_crash_loop`` gauge — both live in the supervisor's registry,
exposed as a Prometheus textfile at ``<engine_dir>/supervisor.prom``
and on the lame-duck ``/metrics`` endpoint. Restart events and mirrored
worker crash-bundle reasons land in the flight ring and the durable
``<engine_dir>/supervisor.jsonl``; entering lame duck writes a
supervisor crash bundle (``supervisor.crash.json``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from collections import deque
from typing import List, Optional

from sartsolver_tpu_torch.engine import routing as fleet_routing
from sartsolver_tpu_torch.obs import flight as obs_flight
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.utils import atomicio

# supervisor.jsonl / fleet.jsonl size-based rotation knob: past this
# many bytes the log is compacted to its newest half-limit tail. A
# supervisor that survives weeks of crash-loops must bound its own
# disk, same reasoning as the engine's journal rotation. 0 disables.
DEFAULT_ROTATE_BYTES = 256 * 1024


def _rotate_limit() -> int:
    try:
        return int(os.environ.get("SART_SUPERVISOR_ROTATE_BYTES")
                   or DEFAULT_ROTATE_BYTES)
    except ValueError:
        return DEFAULT_ROTATE_BYTES


def rotate_events(path: str, limit: int) -> int:
    """Size-based event-log rotation: once ``path`` passes ``limit``
    bytes, atomically rewrite it down to its newest ~``limit/2`` tail
    of whole lines (oldest records are the ones already mirrored to
    every other surface). Returns bytes reclaimed, 0 when nothing
    happened. Rotation failure is silent by design — the log keeps
    growing rather than the supervisor dying over housekeeping."""
    if not limit or limit <= 0:
        return 0
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if size <= limit:
        return 0
    try:
        with open(path, errors="replace") as f:
            lines = f.readlines()
    except OSError:
        return 0
    keep: List[str] = []
    budget = limit // 2
    kept = 0
    for line in reversed(lines):
        if kept + len(line) > budget and keep:
            break
        keep.append(line)
        kept += len(line)
    keep.reverse()
    try:
        # durable: rotated event log (atomic rename — every reader sees
        # a complete file; fsync'd so the kept tail survives a crash)
        atomicio.write_atomic(path, "".join(keep), fsync=True)
    except OSError:
        return 0
    return max(0, size - kept)


def classify_exit(returncode: int) -> str:
    """A worker exit's machine-readable restart reason (the
    ``engine_restarts_total`` label and event vocabulary): ``signal:
    SIGKILL``-style for signal deaths, ``infrastructure`` for the
    documented exit 3, ``exit:N`` otherwise."""
    if returncode < 0:
        try:
            return f"signal:{signal.Signals(-returncode).name}"
        except ValueError:
            return f"signal:{-returncode}"
    if returncode == 3:
        return "infrastructure"
    return f"exit:{returncode}"


class CrashLoopBreaker:
    """Sliding-window crash counter: ``threshold`` crashes inside
    ``window_s`` seconds opens the breaker (lame duck) until the oldest
    crash ages out of the window."""

    def __init__(self, threshold: int, window_s: float):
        self.threshold = max(1, int(threshold))
        self.window_s = float(window_s)
        self.crashes: deque = deque()

    def record(self, now: float) -> None:
        self.crashes.append(float(now))
        self._expire(now)

    def _expire(self, now: float) -> None:
        while self.crashes and now - self.crashes[0] > self.window_s:
            self.crashes.popleft()

    def open(self, now: float) -> bool:
        self._expire(now)
        return len(self.crashes) >= self.threshold

    def remaining_s(self, now: float) -> float:
        """Seconds until the breaker would close (0 when closed)."""
        self._expire(now)
        if len(self.crashes) < self.threshold:
            return 0.0
        # closes when the crash that keeps the count at threshold ages out
        oldest_needed = self.crashes[len(self.crashes) - self.threshold]
        return max(0.0, oldest_needed + self.window_s - now)


def restart_backoff(streak: int, base: float, cap: float) -> float:
    """Respawn delay before consecutive-crash number ``streak`` (1-based):
    exponential from ``base``, capped at ``cap``."""
    if streak <= 0:
        return 0.0
    return min(float(base) * (2.0 ** (streak - 1)), float(cap))


class Supervisor:
    """One supervised serve worker's parent process."""

    def __init__(
        self,
        worker_argv: List[str],
        *,
        engine_dir: str,
        backoff_base: float = 1.0,
        backoff_max: float = 30.0,
        crash_loop_window: float = 60.0,
        crash_loop_threshold: int = 5,
        max_restarts: int = 0,
        http_port: Optional[int] = None,
        poll_interval: float = 0.2,
    ):
        self.worker_argv = list(worker_argv)
        self.engine_dir = engine_dir
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.max_restarts = max(0, int(max_restarts))
        self.http_port = http_port
        self.poll_interval = float(poll_interval)
        self.breaker = CrashLoopBreaker(crash_loop_threshold,
                                        crash_loop_window)
        self.restarts = 0
        self.streak = 0  # consecutive fast crashes (backoff exponent)
        self.lame_ducks = 0
        self.lame_rejected = 0
        self._proc: Optional[subprocess.Popen] = None
        self._stop = False
        self._signame: Optional[str] = None
        self._forwarded = False
        # the intake/verdict dirs exist from the first instant: a client
        # must be able to submit (and read a rejection) even while the
        # worker is still coming up — or crash-looping before it ever
        # managed to create them
        for sub in ("", "ingest", "responses"):
            os.makedirs(os.path.join(engine_dir, sub), exist_ok=True)
        self.events_path = os.path.join(engine_dir, "supervisor.jsonl")  # durable: supervisor events
        self.rotate_bytes = _rotate_limit()
        self.prom_path = os.path.join(engine_dir, "supervisor.prom")
        self.bundle_path = os.path.join(engine_dir,
                                        "supervisor.crash.json")
        registry = obs_metrics.get_registry()
        self._crash_loop_gauge = registry.gauge("engine_crash_loop")
        self._crash_loop_gauge.set(0.0)

    # ---- events / metrics ------------------------------------------------

    def _event(self, kind: str, **data) -> None:
        """One supervisor event, fanned out to every surface: stderr
        (the operator's live view), the flight ring (crash-bundle
        tail), the durable supervisor.jsonl, and the Prometheus
        textfile (best-effort — a full disk must not kill the
        supervisor, it is the thing that survives)."""
        rec = {"unix": round(time.time(), 3), "kind": str(kind)}
        rec.update(data)
        detail = " ".join(f"{k}={v}" for k, v in data.items())
        print(f"sartsolve supervisor: {kind}"
              + (f" {detail}" if detail else ""), file=sys.stderr,
              flush=True)
        obs_flight.record_event(f"supervisor.{kind}", **data)
        # getattr: drills construct bare instances via __new__ with only
        # the paths set — rotation simply stays off there
        rotate_events(self.events_path, getattr(self, "rotate_bytes", 0))
        try:
            # flush+fsync like the journal/state appends: the
            # supervisor is the component that survives the crash, so
            # its record of the crash must survive it too
            atomicio.append_line(self.events_path,
                                 json.dumps(rec) + "\n")
        except OSError:
            pass
        self._write_prom()

    def _write_prom(self) -> None:
        from sartsolver_tpu_torch.obs.sinks import PromSink

        try:
            PromSink(self.prom_path).write(
                obs_metrics.get_registry().snapshot(blocking=False)
            )
        except OSError:
            pass

    def _restart_ctr(self, reason: str):
        return obs_metrics.get_registry().counter(
            "engine_restarts_total", reason=reason
        )

    # ---- signals ---------------------------------------------------------

    def _handler(self, signum, _frame) -> None:
        name = signal.Signals(signum).name
        if self._stop:
            # second signal: SIGKILL the worker, die by the signal
            proc = self._proc
            if proc is not None and proc.poll() is None:
                try:
                    proc.kill()
                except OSError:
                    pass
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self._stop = True
        self._signame = name
        sys.stderr.write(
            f"sartsolve supervisor: received {name} — forwarding "
            "SIGTERM to the worker for one graceful drain. Send again "
            "to abort immediately.\n"
        )
        sys.stderr.flush()

    def _install_signals(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, self._handler)

    # ---- worker lifecycle ------------------------------------------------

    def _spawn(self) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "sartsolver_tpu_torch.cli", "serve",
               *self.worker_argv]
        proc = subprocess.Popen(cmd)  # stdout/stderr inherited
        self._proc = proc
        self._forwarded = False
        self._event("worker-spawn", pid=proc.pid,
                    spawn=self.restarts + 1)
        return proc

    def _wait(self, proc: subprocess.Popen) -> int:
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc
            if self._stop and not self._forwarded:
                self._forwarded = True
                try:
                    proc.send_signal(signal.SIGTERM)
                    self._event("sigterm-forwarded", pid=proc.pid,
                                signal=self._signame)
                except OSError:
                    pass
            time.sleep(self.poll_interval)

    def _sleep(self, seconds: float) -> None:
        """Interruptible backoff sleep (a stop request cuts it short)."""
        deadline = time.monotonic() + seconds
        while not self._stop and time.monotonic() < deadline:
            time.sleep(min(self.poll_interval,
                           max(deadline - time.monotonic(), 0.0)))

    def _mirror_crash_bundle(self, spawned_unix: float) -> None:
        """Fold the dead worker's crash bundle (when it managed to write
        one) into the supervisor's event stream, so triage starts from
        supervisor.jsonl whatever killed the worker."""
        path = os.path.join(self.engine_dir, "engine.crash.json")
        try:
            if os.path.getmtime(path) < spawned_unix - 1.0:
                return  # a previous incarnation's bundle
            with open(path) as f:
                bundle = json.load(f)
        except (OSError, ValueError):
            return
        self._event("worker-crash-bundle",
                    reason=str(bundle.get("reason", "?")), path=path)

    # ---- lame duck -------------------------------------------------------

    def _lame_duck_status(self) -> dict:
        now = time.monotonic()
        return obs_flight.status_snapshot(
            blocking=False,
            supervisor={
                "lame_duck": True,
                "restarts": self.restarts,
                "breaker_remaining_s": round(
                    self.breaker.remaining_s(now), 1),
                "rejected": self.lame_rejected,
            },
        )

    def _reject_ingest(self, remaining_s: float) -> int:
        """The journal-but-refuse half of lame duck: every request file
        is answered with a byte-stable ``crash-loop`` rejection (plus
        the retry hint) and recorded — never silently dropped, never
        queued into a pool that cannot serve it."""
        from sartsolver_tpu_torch.engine.request import REASON_CRASH_LOOP

        ingest = os.path.join(self.engine_dir, "ingest")
        responses = os.path.join(self.engine_dir, "responses")
        try:
            names = sorted(os.listdir(ingest))
        except OSError:
            return 0
        n = 0
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(ingest, name)
            rid = os.path.splitext(name)[0]
            try:
                with open(path) as f:
                    payload = json.load(f)
                if isinstance(payload, dict) and payload.get("id"):
                    rid = str(payload["id"])
            except (OSError, ValueError):
                pass  # reject under the file stem; id unknowable
            # never clobber a completed id's recorded outcome: a
            # resubmission during lame duck is a duplicate, and the
            # engine's contract is that the original response survives —
            # the submitter resolves from it, no rejection needed
            try:
                with open(os.path.join(responses, f"{rid}.json")) as f:
                    prev = json.load(f)
            except (OSError, ValueError):
                prev = None
            if prev and prev.get("state") == "done":
                try:
                    os.unlink(path)
                except OSError:
                    pass
                self._event("lame-duck-duplicate", id=rid)
                continue
            rec = {"unix": round(time.time(), 3), "id": rid,
                   "verdict": "rejected", "reason": REASON_CRASH_LOOP,
                   "retry_after_s": round(max(remaining_s, 1.0), 1)}
            try:
                os.makedirs(responses, exist_ok=True)
                atomicio.write_json_atomic(
                    os.path.join(responses, f"{rid}.json"), rec,
                    fsync=True,
                )
            except OSError:
                continue  # leave the request file for the next pass
            try:
                os.unlink(path)
            except OSError:
                pass
            self.lame_rejected += 1
            obs_metrics.get_registry().counter(
                "engine_shed_total", reason=REASON_CRASH_LOOP
            ).inc()
            self._event("lame-duck-reject", id=rid,
                        retry_after_s=rec["retry_after_s"])
            n += 1
        return n

    def _lame_duck(self, last_reason: str) -> None:
        """Breaker open: hold restarts, answer 503s and crash-loop
        rejections until the sliding window clears."""
        self.lame_ducks += 1
        self._crash_loop_gauge.set(1.0)
        now = time.monotonic()
        remaining = self.breaker.remaining_s(now)
        self._event("lame-duck-enter",
                    crashes=len(self.breaker.crashes),
                    window_s=self.breaker.window_s,
                    remaining_s=round(remaining, 1),
                    last_reason=last_reason)
        obs_flight.write_crash_bundle(
            self.bundle_path,
            f"crash-loop: {len(self.breaker.crashes)} crashes in "
            f"{self.breaker.window_s:g}s (last: {last_reason}); "
            f"lame duck for {remaining:.1f}s",
        )
        http = None
        if self.http_port is not None:
            from sartsolver_tpu_torch.engine.httpd import EngineHTTPServer
            from sartsolver_tpu_torch.engine.request import REASON_CRASH_LOOP

            registry = obs_metrics.get_registry()

            def detail() -> str:
                left = self.breaker.remaining_s(time.monotonic())
                return (f"crash-loop breaker open; retry in "
                        f"{left:.1f}s")

            try:
                http = EngineHTTPServer(
                    self.http_port,
                    metrics_snapshot=lambda: registry.snapshot(
                        blocking=False),
                    health=lambda: (REASON_CRASH_LOOP, detail()),
                    ready=lambda: (REASON_CRASH_LOOP, detail()),
                    status=self._lame_duck_status,
                )
                http.start()
                self._event("lame-duck-endpoint", port=http.port)
            except OSError as err:
                # the dead worker's socket may linger in TIME_WAIT;
                # lame duck still rejects via the responses dir
                self._event("lame-duck-endpoint-failed", error=str(err))
                http = None
        try:
            while not self._stop:
                now = time.monotonic()
                remaining = self.breaker.remaining_s(now)
                if remaining <= 0:
                    break
                self._reject_ingest(remaining)
                time.sleep(min(self.poll_interval, remaining))
        finally:
            if http is not None:
                http.stop()
        self._crash_loop_gauge.set(0.0)
        self.breaker.crashes.clear()
        self.streak = 0
        self._event("lame-duck-exit", rejected=self.lame_rejected)

    # ---- main loop -------------------------------------------------------

    def run(self) -> int:
        self._install_signals()
        obs_flight.install()
        self._event("start",
                    backoff=self.backoff_base,
                    backoff_max=self.backoff_max,
                    window_s=self.breaker.window_s,
                    threshold=self.breaker.threshold,
                    max_restarts=self.max_restarts or "unlimited")
        try:
            while True:
                spawned_unix = time.time()
                t_spawn = time.monotonic()
                proc = self._spawn()
                rc = self._wait(proc)
                lifetime = time.monotonic() - t_spawn
                reason = classify_exit(rc)
                if rc in (0, 4):
                    # clean idle exit / graceful drain (ours or an
                    # operator's direct SIGTERM at the worker): done
                    self._event("worker-done", code=rc,
                                lifetime_s=round(lifetime, 1))
                    return rc
                if rc == 1:
                    # flag/config error: a restart would re-fail
                    # identically forever — surface it instead
                    self._event("worker-config-error", code=rc)
                    return 1
                if self._stop:
                    # we asked for a drain and the worker died anyway
                    # (second signal, or it crashed mid-drain): stop
                    self._event("worker-died-draining", code=rc,
                                reason=reason)
                    return 4 if rc < 0 else rc
                self._mirror_crash_bundle(spawned_unix)
                self.restarts += 1
                self._restart_ctr(reason).inc()
                now = time.monotonic()
                self.breaker.record(now)
                # a worker that survived the whole window was healthy:
                # the next crash starts a fresh backoff ladder
                self.streak = (1 if lifetime > self.breaker.window_s
                               else self.streak + 1)
                self._event("worker-crash", code=rc, reason=reason,
                            lifetime_s=round(lifetime, 1),
                            restarts=self.restarts,
                            window_crashes=len(self.breaker.crashes))
                if self.max_restarts and self.restarts >= self.max_restarts:
                    self._event("restart-budget-exhausted",
                                restarts=self.restarts)
                    return 3
                if self.breaker.open(now):
                    self._lame_duck(reason)
                    if self._stop:
                        return 4
                    continue  # half-open: one fresh spawn
                delay = restart_backoff(self.streak, self.backoff_base,
                                        self.backoff_max)
                if delay > 0:
                    self._event("backoff", delay_s=round(delay, 2),
                                streak=self.streak)
                    self._sleep(delay)
                if self._stop:
                    return 4
        finally:
            obs_flight.uninstall()
            self._write_prom()


class FleetController:
    """M supervised serve workers + tenant-affinity routing +
    journal-backed failover (docs/SERVING.md §10).

    Layout under ``fleet_dir``::

        routing.json        atomically-published routing table
        fleet.jsonl         controller events (rotated like supervisor.jsonl)
        ingest/             controller intake (client fallback routing)
        responses/          SHARED verdict/outcome files (all workers)
        outputs/            SHARED solution files (all workers)
        workers/w<k>/       each worker's own engine dir (journal, state)

    Each worker is a normal ``sartsolve serve`` process pinned to its
    shard: ``--worker_index k --fleet_size M`` arms the admission
    affinity check (``wrong-worker`` sheds misrouted tenants), and the
    shared responses/outputs dirs mean a client polls ONE place no
    matter which worker — or which worker's *survivor* — solved its
    request.

    Failover is journal-backed: when a worker dies abnormally the
    controller replays its journal shard, appends a ``handoff`` marker
    per accepted-but-uncompleted request to the DEAD worker's journal
    (marker first: once durable, a restart of that worker will never
    re-drive the id), then re-stages each payload — ``handoff`` flag
    set so affinity admits it — into a surviving worker's ingest dir.
    The dedup watermark + shared responses dir carry the exactly-once
    story across the handoff, with :func:`~sartsolver_tpu_torch.engine.
    protocol.needs_restage` as the shared recovery gate (the JAX package's
    crash-point model checker enumerates a crash at every effect boundary
    of this dance).
    """

    def __init__(
        self,
        worker_argv: List[str],
        *,
        fleet_dir: str,
        size: int = 3,
        base_port: Optional[int] = None,
        backoff_base: float = 0.5,
        backoff_max: float = 10.0,
        max_restarts: int = 0,
        poll_interval: float = 0.1,
    ):
        self.worker_argv = list(worker_argv)
        self.fleet_dir = fleet_dir
        self.size = max(1, int(size))
        self.base_port = None if base_port is None else int(base_port)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.max_restarts = max(0, int(max_restarts))
        self.poll_interval = float(poll_interval)
        self.restarts = 0
        self._stop = False
        self._signame: Optional[str] = None
        self._forwarded = False
        self.ingest_dir = os.path.join(fleet_dir, "ingest")
        self.responses_dir = os.path.join(fleet_dir, "responses")
        self.outputs_dir = os.path.join(fleet_dir, "outputs")
        self.events_path = os.path.join(fleet_dir, "fleet.jsonl")  # durable: fleet events
        self.rotate_bytes = _rotate_limit()
        for d in (fleet_dir, self.ingest_dir, self.responses_dir,
                  self.outputs_dir):
            os.makedirs(d, exist_ok=True)
        self.workers: List[dict] = []
        for k in range(self.size):
            wdir = os.path.join(fleet_dir, "workers", f"w{k}")
            os.makedirs(os.path.join(wdir, "ingest"), exist_ok=True)
            self.workers.append({
                "index": k, "dir": wdir, "proc": None, "state": "down",
                "spawns": 0, "streak": 0, "next_spawn": 0.0,
                "t_spawn": 0.0, "done": False,
            })

    # ---- events / plumbing -----------------------------------------------

    def _event(self, kind: str, **data) -> None:
        rec = {"unix": round(time.time(), 3), "kind": str(kind)}
        rec.update(data)
        detail = " ".join(f"{k}={v}" for k, v in data.items())
        print(f"sartsolve fleet: {kind}"
              + (f" {detail}" if detail else ""), file=sys.stderr,
              flush=True)
        obs_flight.record_event(f"fleet.{kind}", **data)
        rotate_events(self.events_path, getattr(self, "rotate_bytes", 0))
        try:
            atomicio.append_line(self.events_path,
                                 json.dumps(rec) + "\n")
        except OSError:
            pass

    def _journal(self, k: int):
        from sartsolver_tpu_torch.engine.journal import RequestJournal

        return RequestJournal(
            os.path.join(self.workers[k]["dir"], "journal.jsonl")
        )

    def _worker_port(self, k: int) -> Optional[int]:
        return None if self.base_port is None else self.base_port + k

    def _alive(self, k: int) -> bool:
        proc = self.workers[k]["proc"]
        return (self.workers[k]["state"] == "up" and proc is not None
                and proc.poll() is None)

    def _ready(self, k: int) -> bool:
        """Best-effort ``/readyz`` poll (portless fleets count every
        alive worker as ready — the ingest backlog still load-balances)."""
        port = self._worker_port(k)
        if port is None:
            return True
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=0.5) as r:
                return r.status == 200
        except Exception:  # noqa: BLE001 - a dead endpoint is "not ready"
            return False

    def _publish_routing(self) -> None:
        rows = [
            {"index": w["index"],
             "ingest_dir": os.path.join(w["dir"], "ingest"),
             "http_port": self._worker_port(w["index"]),
             "state": w["state"]}
            for w in self.workers
        ]
        fleet_routing.publish_routing(
            self.fleet_dir, rows, responses_dir=self.responses_dir,
            ingest_dir=self.ingest_dir,
        )

    # ---- worker lifecycle ------------------------------------------------

    def _spawn(self, k: int) -> None:
        w = self.workers[k]
        cmd = [sys.executable, "-m", "sartsolver_tpu_torch.cli", "serve",
               "--engine_dir", w["dir"],
               "--responses_dir", self.responses_dir,
               "--outputs_dir", self.outputs_dir,
               "--worker_index", str(k),
               "--fleet_size", str(self.size)]
        port = self._worker_port(k)
        if port is not None:
            cmd += ["--http_port", str(port)]
        cmd += self.worker_argv
        env = dict(os.environ)
        # per-worker metric identity: every engine series the worker
        # registers carries worker=w<k> (obs/metrics.py default labels)
        env["SART_WORKER_ID"] = f"w{k}"
        proc = subprocess.Popen(cmd, env=env)  # stdout/stderr inherited
        w["proc"] = proc
        w["state"] = "up"
        w["spawns"] += 1
        w["t_spawn"] = time.monotonic()
        self._event("worker-spawn", pid=proc.pid, spawn=w["spawns"],
                    worker=k)

    def _pick_survivor(self, exclude: int) -> Optional[int]:
        """The failover/fallback target: an alive worker, ready ones
        first, least ingest backlog breaking ties."""
        alive = [w["index"] for w in self.workers
                 if w["index"] != exclude and self._alive(w["index"])]
        if not alive:
            return None
        ready = [k for k in alive if self._ready(k)]
        pool = ready or alive

        def backlog(k: int) -> int:
            try:
                return len(os.listdir(
                    os.path.join(self.workers[k]["dir"], "ingest")))
            except OSError:
                return 0

        return min(pool, key=lambda k: (backlog(k), k))

    def _failover(self, k: int) -> None:
        """Re-drive a dead worker's accepted-but-uncompleted journal
        entries on a survivor (handoff marker FIRST — see the class
        docstring for the crash-ordering argument)."""
        w = self.workers[k]
        w["state"] = "down"
        self._publish_routing()
        journal = self._journal(k)
        _completed, pending, _handed = journal.replay_full()
        if not pending:
            return
        target = self._pick_survivor(exclude=k)
        if target is None:
            # nobody to hand off to: the respawned worker replays its
            # own journal — same exactly-once story, just slower
            self._event("handoff-skipped", worker=k,
                        pending=len(pending))
            return
        target_ingest = os.path.join(self.workers[target]["dir"],
                                     "ingest")
        for req in pending:
            journal.handoff(req.id, target, trace_id=req.trace)
            payload = req.to_dict()
            payload["handoff"] = True
            # a partial solution from the dead worker's interrupted
            # attempt is removed so the survivor writes it fresh
            # (byte-identical re-drive; same contract as single-worker
            # journal replay) — safe because pending means no completed
            # marker exists anywhere for this id
            try:
                os.unlink(os.path.join(self.outputs_dir,
                                       f"{req.id}.h5"))
            except OSError:
                pass
            # durable: failover re-stage (fsync'd atomic publish)
            atomicio.write_json_atomic(
                os.path.join(target_ingest, f"{req.id}.json"),
                payload, fsync=True,
            )
            self._event("handoff", id=req.id, source=k, target=target)

    def _recover(self) -> None:
        """Controller-restart recovery: finish any handoff a previous
        incarnation's crash interrupted. The crash may have landed
        between the handoff marker and the re-stage publish — the
        shared gate :func:`~sartsolver_tpu_torch.engine.protocol.
        needs_restage` re-stages exactly when no other copy of the
        story exists anywhere in the fleet."""
        from sartsolver_tpu_torch.engine.protocol import needs_restage

        replays = [self._journal(w["index"]).replay_full()
                   for w in self.workers]
        completed_anywhere: set = set()
        for completed, _pending, _handed in replays:
            completed_anywhere.update(completed)
        restaged = 0
        for w in self.workers:
            _completed, _pending, handed = replays[w["index"]]
            for rid, story in handed.items():
                target = story.get("target")
                if target is None or not 0 <= int(target) < self.size:
                    continue
                target = int(target)
                t_ingest = os.path.join(self.workers[target]["dir"],
                                        "ingest")
                staged = os.path.exists(
                    os.path.join(t_ingest, f"{rid}.json"))
                pending_ids = {req.id for req in replays[target][1]}
                if not needs_restage(
                        completed_anywhere=rid in completed_anywhere,
                        pending_on_target=rid in pending_ids,
                        staged_on_target=staged):
                    continue
                req = story.get("request")
                payload = req.to_dict() if req is not None else {"id": rid}
                payload["handoff"] = True
                try:
                    os.unlink(os.path.join(self.outputs_dir,
                                           f"{rid}.h5"))
                except OSError:
                    pass
                # durable: failover re-stage (recovery pass)
                atomicio.write_json_atomic(
                    os.path.join(t_ingest, f"{rid}.json"), payload,
                    fsync=True,
                )
                restaged += 1
                self._event("handoff-restage", id=rid,
                            source=w["index"], target=target)
        if restaged:
            self._event("recovery", restaged=restaged)

    # ---- controller intake -----------------------------------------------

    def _pump_intake(self) -> int:
        """Route requests dropped in the fleet-level ingest dir (the
        routing table's client fallback) to their tenant-affinity
        worker — or, when that worker is down, to a survivor with the
        handoff flag set so admission accepts them there."""
        try:
            names = sorted(os.listdir(self.ingest_dir))
        except OSError:
            return 0
        n = 0
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.ingest_dir, name)
            try:
                with open(path) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                continue  # torn mid-write; picked up next pass
            tenant = "default"
            if isinstance(payload, dict):
                tenant = str(payload.get("tenant") or "default")
            k = fleet_routing.tenant_worker(tenant, self.size)
            if not self._alive(k):
                target = self._pick_survivor(exclude=k)
                if target is None:
                    return n  # nobody up; keep the file, retry next loop
                if isinstance(payload, dict):
                    payload = {**payload, "handoff": True}
                k = target
            dst = os.path.join(self.workers[k]["dir"], "ingest", name)
            try:
                # durable: routed intake (fsync'd atomic publish into
                # the worker's ingest, then the fleet copy is dropped)
                atomicio.write_json_atomic(dst, payload, fsync=True)
                os.unlink(path)
            except OSError:
                continue
            n += 1
        if n:
            self._event("intake-routed", requests=n)
        return n

    # ---- signals / main loop ---------------------------------------------

    def _handler(self, signum, _frame) -> None:
        name = signal.Signals(signum).name
        if self._stop:
            for w in self.workers:
                proc = w["proc"]
                if proc is not None and proc.poll() is None:
                    try:
                        proc.kill()
                    except OSError:
                        pass
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self._stop = True
        self._signame = name
        sys.stderr.write(
            f"sartsolve fleet: received {name} — forwarding SIGTERM "
            "to every worker for one graceful drain. Send again to "
            "abort immediately.\n"
        )
        sys.stderr.flush()

    def run(self) -> int:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, self._handler)
        obs_flight.install()
        self._event("start", size=self.size, fleet_dir=self.fleet_dir)
        exit_code = 0
        try:
            self._recover()
            for w in self.workers:
                self._spawn(w["index"])
            self._publish_routing()
            while True:
                if self._stop and not self._forwarded:
                    self._forwarded = True
                    for w in self.workers:
                        proc = w["proc"]
                        if proc is not None and proc.poll() is None:
                            try:
                                proc.send_signal(signal.SIGTERM)
                            except OSError:
                                pass
                    self._event("sigterm-forwarded",
                                signal=self._signame)
                self._pump_intake()
                now = time.monotonic()
                for w in self.workers:
                    if w["done"]:
                        continue
                    proc = w["proc"]
                    if proc is None:
                        if not self._stop and now >= w["next_spawn"]:
                            self._spawn(w["index"])
                            self._publish_routing()
                        continue
                    rc = proc.poll()
                    if rc is None:
                        continue
                    lifetime = now - w["t_spawn"]
                    reason = classify_exit(rc)
                    w["proc"] = None
                    if rc in (0, 4) or (self._stop and rc != 1):
                        # clean idle exit / graceful drain — final
                        w["done"] = True
                        w["state"] = "down"
                        self._event("worker-done", worker=w["index"],
                                    code=rc)
                        self._publish_routing()
                        continue
                    if rc == 1:
                        self._event("worker-config-error",
                                    worker=w["index"], code=rc)
                        self._stop = True
                        exit_code = 1
                        continue
                    self.restarts += 1
                    self._event("worker-crash", code=rc, reason=reason,
                                worker=w["index"],
                                lifetime_s=round(lifetime, 1),
                                restarts=self.restarts)
                    self._failover(w["index"])
                    if (self.max_restarts
                            and self.restarts >= self.max_restarts):
                        self._event("restart-budget-exhausted",
                                    restarts=self.restarts)
                        self._stop = True
                        exit_code = 3
                        continue
                    w["streak"] = (1 if lifetime > 30.0
                                   else w["streak"] + 1)
                    w["next_spawn"] = now + restart_backoff(
                        w["streak"], self.backoff_base, self.backoff_max
                    )
                running = any(
                    w["proc"] is not None and w["proc"].poll() is None
                    for w in self.workers
                )
                if all(w["done"] for w in self.workers):
                    break
                if self._stop and not running and all(
                        w["done"] or w["proc"] is None
                        for w in self.workers):
                    break
                time.sleep(self.poll_interval)
        finally:
            obs_flight.uninstall()
        if exit_code:
            return exit_code
        if self._signame is not None:
            return 4
        self._event("fleet-done", restarts=self.restarts)
        return 0


def supervisor_main(args, worker_argv: List[str]) -> int:
    """`sartsolve serve --supervised` entry (engine/cli.py): ``args`` is
    the parsed serve namespace (supervision knobs), ``worker_argv`` the
    original argv with ``--supervised`` stripped — the exact command the
    worker runs under."""
    sup = Supervisor(
        worker_argv,
        engine_dir=args.engine_dir,
        backoff_base=args.restart_backoff,
        backoff_max=args.restart_backoff_max,
        crash_loop_window=args.crash_loop_window,
        crash_loop_threshold=args.crash_loop_threshold,
        max_restarts=args.max_restarts,
        http_port=args.http_port,
    )
    return sup.run()


__all__ = ["Supervisor", "FleetController", "CrashLoopBreaker",
           "classify_exit", "restart_backoff", "supervisor_main",
           "rotate_events", "DEFAULT_ROTATE_BYTES"]
