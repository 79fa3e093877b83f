"""The serve loop: ingest, admission, dispatch, journal, drain.

Counterpart of ``sartsolver_tpu/engine/server.py``. Every frame is solved
through the port's :class:`~sartsolver_tpu_torch.sched.ContinuousBatcher`
on the resident solver, so on the card through the hand-written fused sweep
that ``ops/fused_sweep.py:plan_sweep`` picks for B = ``lanes`` (a geometry
request: the implicit projector). The solve runs on the serve loop's thread
only. The socket thread, the HTTP thread and the watchdog launch no CUDA
work and read no device tensor: they admit payloads (host JSON, the
journal) and read host state through ``stale_read``, so a scrape never
synchronizes the device. A kernel that fails fails the request or the
process, loudly: there is no switch to the CPU or to the plain sweep.

:class:`EngineServer` ties the engine together (docs/SERVING.md):

- **Ingest** — a file-watch directory (``<engine_dir>/ingest/``; one
  JSON request per file, atomic-rename submitted) polled between
  cycles, plus an optional local AF_UNIX socket served from a side
  thread (same admission path, synchronous verdict reply).
- **Admission** — :class:`~sartsolver_tpu_torch.engine.admission.
  AdmissionController`; every verdict lands in a response file
  (``<engine_dir>/responses/<id>.json``) a submitter can poll.
- **Journal** — accepted -> dispatched -> completed markers, fsync'd
  before the engine acts on them; replayed on restart (completed
  requests are never re-run, accepted-but-unfinished ones are, with
  byte-identical outputs).
- **Dispatch** — each cycle drains the queue through ONE continuous-
  batcher run over the resident solver's lanes: requests are co-batched
  frame-wise, deadlines ride the stream items and shed at stride
  boundaries (sched/scheduler.py), results route back to per-request
  writers in frame order.
- **Degradation** — a device OOM halves the lane count (sticky, like
  the CLI's group ladder) and flips admission into degraded load-shed
  mode; per-frame failures become FAILED rows; a request whose frames
  keep failing moves its tenant toward quarantine.
- **Drain** — SIGTERM (resilience/shutdown.py) stops intake
  (rejections say ``draining``), finishes what the batcher already
  holds, journals the rest as accepted, and exits 4; ``kill -9``
  recovery is the journal's job.
"""

from __future__ import annotations

import itertools
import json
import os
import socket as socketmod
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from sartsolver_tpu_torch.config import SartInputError
from sartsolver_tpu_torch.engine import request as reqmod
from sartsolver_tpu_torch.engine.admission import AdmissionController
from sartsolver_tpu_torch.engine.journal import RequestJournal
from sartsolver_tpu_torch.engine.protocol import needs_republish, uncounted_completed
from sartsolver_tpu_torch.engine.request import Request, RequestError, parse_request
from sartsolver_tpu_torch.engine.session import (
    ResidentSession,
    SessionCache,
    absolute_deadline,
)
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.obs import trace as obs_trace
from sartsolver_tpu_torch.resilience import failures, shutdown, watchdog
from sartsolver_tpu_torch.utils import atomicio
from sartsolver_tpu_torch.resilience.failures import (
    DEADLINE_EXCEEDED,
    DIVERGED,
    EXIT_INPUT_ERROR,
    EXIT_INTERRUPTED,
    EXIT_OK,
    FRAME_FAILED,
    SDC_DETECTED,
    FrameFailure,
    failed_row,
    status_name,
)

_TERMINAL_FRAME_STATUSES = (DIVERGED, FRAME_FAILED, SDC_DETECTED)


class _ActiveRequest:
    """One dispatched request's in-cycle bookkeeping."""

    __slots__ = ("req", "deadline", "expected", "got", "by_status",
                 "writer", "t_dispatch", "deadline_missed", "output",
                 "t_accepted", "session")

    def __init__(self, req: Request, expected: int,
                 deadline: Optional[float], output: str,
                 t_accepted: Optional[float] = None, session=None):
        self.req = req
        # the leased ResidentSession this request solved on (None for
        # pre-attach finishes) — _finish must flush the writer against
        # the SAME session, not whatever the cache holds by then
        self.session = session
        self.deadline = deadline
        self.expected = int(expected)
        self.got = 0
        self.by_status: Dict[str, int] = {}
        self.writer = None  # lazy SolutionWriter
        self.t_dispatch = time.perf_counter()
        self.deadline_missed = False
        self.output = output
        # acceptance time.monotonic(): end-to-end latency (queue wait
        # included) anchors here — the SLO clock the client experiences
        self.t_accepted = (time.monotonic() if t_accepted is None
                           else float(t_accepted))

    @property
    def done(self) -> bool:
        return self.got >= self.expected


class EngineServer:
    """One resident serve process's request lifecycle owner."""

    def __init__(
        self,
        session: ResidentSession,
        *,
        engine_dir: str,
        lanes: int = 2,
        admission: Optional[AdmissionController] = None,
        poll_interval: float = 0.2,
        socket_path: Optional[str] = None,
        default_deadline_s: Optional[float] = None,
        idle_exit: float = 0.0,
        max_cycle_requests: int = 8,
        telemetry=None,
        http_port: Optional[int] = None,
        slo_ms: Optional[float] = None,
        journal_rotate_bytes: int = 64 * 2 ** 20,
        response_ttl_s: float = 7 * 86400.0,
        trace_ttl_s: float = 86400.0,
        responses_dir: Optional[str] = None,
        outputs_dir: Optional[str] = None,
    ):
        if lanes < 1:
            raise ValueError("lanes must be >= 1.")
        # ``session`` may be a plain ResidentSession or a SessionCache
        # (multi-session residency, docs/SERVING.md §10); the cache is
        # leased per solve cycle, never touched at construction time
        self.session = session
        self._session_cache = (session if isinstance(session, SessionCache)
                               else None)
        self.engine_dir = engine_dir
        self.ingest_dir = os.path.join(engine_dir, "ingest")
        # fleet mode points every worker at SHARED responses/outputs
        # dirs (one poll surface for clients regardless of failover);
        # standalone serve keeps them under the engine dir
        self.outputs_dir = outputs_dir or os.path.join(engine_dir, "outputs")
        self.responses_dir = (responses_dir or
                              os.path.join(engine_dir, "responses"))  # durable: response
        for d in (engine_dir, self.ingest_dir, self.outputs_dir,
                  self.responses_dir):
            os.makedirs(d, exist_ok=True)
        self.journal = RequestJournal(os.path.join(engine_dir,
                                                   "journal.jsonl"))
        if self._session_cache is not None \
                and self._session_cache._on_event is None:
            # cache attach/evict events land in the journal (audit
            # record; replay skips them) and the event stream
            self._session_cache._on_event = self._cache_event
        # durable soft state (docs/SERVING.md §9): tenant quarantine,
        # lane ladder, SLO counters, dedup watermark — restored in run()
        from sartsolver_tpu_torch.engine.state import StateStore

        self.state = StateStore(os.path.join(engine_dir, "state.jsonl"))
        # retention knobs (satellite: unbounded append-only files are a
        # slow-motion outage): 0 disables the matching sweep/rotation
        self.journal_rotate_bytes = max(0, int(journal_rotate_bytes))
        self.response_ttl_s = max(0.0, float(response_ttl_s))
        self.trace_ttl_s = max(0.0, float(trace_ttl_s))
        self._last_sweep = 0.0
        # checkpointed by: _save_state
        self.admission = admission if admission is not None \
            else AdmissionController(on_event=self._event)
        if self.admission._on_event is None:
            self.admission._on_event = self._event
        self.lanes = int(lanes)  # checkpointed by: _save_state
        self.initial_lanes = int(lanes)
        self.poll_interval = float(poll_interval)
        self.socket_path = socket_path
        self.default_deadline_s = default_deadline_s
        self.idle_exit = float(idle_exit)
        self.max_cycle_requests = max(1, int(max_cycle_requests))
        self.telemetry = telemetry
        # --http_port: None/absent = no socket, no thread, nothing
        # imported (the disabled-path identity contract); the server is
        # constructed and started inside run()
        self.http_port = http_port
        self.http = None
        # --slo_ms: per-request latency target; the ok/breach counter
        # pair below is the error-budget burn accounting
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        # accepted-not-yet-dispatched:
        # (Request, accepted_monotonic, accepted_perf_counter) — the
        # perf_counter twin anchors the retroactive queue.wait trace span
        self._queue: List[Tuple[Request, float, float]] = []
        # one lock guards admission-state mutation + queue + journal +
        # response writes: the socket thread admits concurrently with
        # the serve loop, and EVERY AdmissionController mutation
        # (admit / note_dispatched / note_outcome / set_degraded) must
        # hold it — a lost queue_depth update would either wedge the
        # bounded queue at "full" or silently disable backpressure
        self._lock = threading.Lock()
        self._active_ids: List[str] = []
        # request id -> {"trace": ..., "span": ...}: every live (queued
        # or in-flight) request's trace id and CURRENT lifecycle span,
        # removed at completion. Mutations are GIL-atomic dict ops; the
        # status provider reads it lock-free (signal context) — a torn
        # view mis-states one request's span, never hangs a poke. This
        # is what lets a crash bundle name the requests that were in
        # flight when the process died, and where each one was.
        self._requests: Dict[str, dict] = {}
        self._draining = False
        self._cycles = 0
        # counted-outcome watermark (insertion-ordered): the ids whose
        # outcome counters (engine_requests_total, SLO ok/breach) have
        # reached — or are about to reach — a durable checkpoint. Rides
        # the state payload so replay can re-count exactly the journal-
        # completed ids a kill between the completed marker and the
        # next checkpoint left uncounted (chaos invariant 4: counter
        # continuity). checkpointed by: _save_state
        self._counted_ids: Dict[str, None] = {}
        # bounded: a serve-forever daemon must not grow a list one
        # entry per request for the process lifetime (the telemetry
        # sink and stdout get every event; this is just the recent tail)
        self.events: deque = deque(maxlen=256)
        self._sock = None
        self._sock_thread = None
        self._sock_stop = threading.Event()
        registry = obs_metrics.get_registry()
        self._queue_wait_hist = registry.histogram("engine_queue_wait_s")
        self._solve_hist = registry.histogram("engine_request_solve_s")
        self._latency_hist = registry.histogram(
            "engine_request_latency_s"
        )
        self._deadline_miss_ctr = registry.counter(
            "engine_deadline_miss_total"
        )
        self._requests_ctrs: Dict[str, object] = {}
        self._lanes_gauge = registry.gauge("engine_lanes")
        self._lanes_gauge.set(float(lanes))
        # the hand kernels' launch counts already made in this process:
        # each cycle's launches are added to kernel_launches_total
        self._launches_seen = obs_metrics.kernel_launches()
        if self.slo_ms is not None:
            registry.gauge("engine_slo_target_ms").set(self.slo_ms)

    # ---- events / status -------------------------------------------------

    def _event(self, message: str) -> None:
        self.events.append(str(message))
        if self.telemetry is not None:
            self.telemetry.record_event(message)
        print(f"sartsolve engine: {message}", flush=True)

    def _cache_event(self, kind: str, **data) -> None:
        """Session-cache attach/evict sink: one journal audit marker
        (replay skips it, compaction drops it) + one event line."""
        key = data.pop("key", "default")
        try:
            with self._lock:
                self.journal.session_event(kind, key, **data)
        except OSError as err:
            self._event(f"session journal marker failed: {err}")
        detail = " ".join(f"{k}={v}" for k, v in sorted(data.items()))
        self._event(f"{kind}: key={key}{' ' + detail if detail else ''}")

    def _lease_session(self, req: Request):
        """The ResidentSession this request solves on: the cache lease
        (attach-or-build under the byte budget) in fleet/cache mode, the
        one resident session otherwise."""
        if self._session_cache is not None:
            return self._session_cache.lease(req)
        return self.session

    def _requests_ctr(self, outcome: str):
        ctr = self._requests_ctrs.get(outcome)
        if ctr is None:
            ctr = obs_metrics.get_registry().counter(
                "engine_requests_total", outcome=outcome
            )
            self._requests_ctrs[outcome] = ctr
        return ctr

    def _set_span(self, req: Request, span: str) -> None:
        """Advance a live request's current lifecycle span (the status/
        crash-bundle attribution surface; GIL-atomic dict write)."""
        self._requests[req.id] = {"trace": req.trace, "span": span}

    def _clear_span(self, request_id: str) -> None:
        self._requests.pop(request_id, None)

    def _status(self) -> dict:
        """Engine view for the heartbeat line / SIGUSR1 status snapshot
        (watchdog.set_engine_status_provider): attributes a wedged
        daemon's stall to a request, not just a pipeline phase. Lock-
        free reads of GIL-atomic fields — this runs from the heartbeat
        write and from signal context."""
        adm = self.admission
        shed_total = 0
        for ctr in adm._shed_ctrs.values():
            shed_total += int(ctr.value)
        from sartsolver_tpu_torch.utils.locking import stale_read

        # live request table: id -> {trace, span}. The dict is mutated
        # by the serve loop (insert at admit, pop at finish); the
        # bounded-retry copy degrades to {} rather than raising out of a
        # heartbeat write or a signal-context poke.
        requests = stale_read(
            lambda: {rid: dict(info)
                     for rid, info in self._requests.items()},
            default={},
        )
        return {
            "queue_depth": int(adm.queue_depth),
            "admitted": int(adm._admitted_ctr.value),
            "shed": shed_total,
            "quarantined_tenants": adm.quarantined_tenants(),
            "active_requests": list(self._active_ids),
            "requests": requests,
            "lanes": int(self.lanes),
            "degraded": adm.degraded_reason,
            "draining": bool(self._draining),
            "cycles": int(self._cycles),
            "tenants": adm.tenant_view(),
        }

    # ---- responses -------------------------------------------------------

    def _read_response(self, key: str) -> Optional[dict]:
        try:
            with open(os.path.join(self.responses_dir,
                                   f"{key}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _respond(self, key: str, payload: dict) -> None:
        """Atomically publish a response record a submitter can poll."""
        path = os.path.join(self.responses_dir, f"{key}.json")
        # publish stamp, not replayed state: a republished response is
        # SUPPOSED to carry a fresh wall-clock (the submitter's poll
        # freshness anchor)  # sart-lint: disable=SL204
        payload = {"unix": round(time.time(), 3), **payload}
        delay = os.environ.get("SART_TEST_RESPONSE_DELAY")
        if delay:
            # chaos-harness crash window (mirrors SART_TEST_JOURNAL_DELAY):
            # a SIGKILL in here dies with the response not yet published —
            # replay must republish it from the journaled outcome. The
            # state rides the marker so the harness can target the
            # completion-response write specifically (the window where
            # the completed marker is durable but the response is not)
            sys.stderr.write(f"SART_RESPONSE_POINT {key} "
                             f"state={payload.get('state', 'none')}\n")
            sys.stderr.flush()
            time.sleep(float(delay))
        try:
            # fsync=True: the pre-atomicio publish skipped the tmp
            # fsync, so a crash straddling the rename could publish a
            # zero-length "atomic" response (found by the SL202 lint
            # while extracting this helper)
            atomicio.write_json_atomic(path, payload, fsync=True)
        except OSError as err:
            self._event(f"response write for {key!r} failed: {err}")

    # ---- admission (shared by ingest dir and socket) ---------------------

    def _admit_payload(self, payload, *, source: str) -> dict:
        """Parse + admit one raw payload under the engine lock; returns
        the response record (also published to the responses dir)."""
        try:
            req = parse_request(
                payload, default_deadline_s=self.default_deadline_s
            )
        except (RequestError, OSError, RuntimeError) as err:
            # RequestError: client bug. OSError/RuntimeError: a torn
            # read or the armed request.parse fault — the payload is
            # unusable either way; reject loudly, keep serving.
            rec = {"verdict": "rejected",
                   "reason": reqmod.REASON_MALFORMED,
                   "error": f"{type(err).__name__}: {err}",
                   "source": source}
            with self._lock:
                # socket-thread admissions have no checkpoint boundary
                # of their own; the serve loop saves once per ingest
                # batch, and the journal — not the shed counter — is
                # the correctness backbone  # sart-lint: disable=SL205
                self.admission.shed(reqmod.REASON_MALFORMED)
            return rec
        with self._lock:
            # same socket-thread path as above: the accepted marker
            # below is the durable record; the dedup watermark rides
            # the next serve-loop save  # sart-lint: disable=SL205
            reason = self.admission.admit(req, draining=self._draining)
            if reason is None:
                self._set_span(req, "queued")
                self.journal.accepted(req)
                self._queue.append((req, time.monotonic(),
                                    time.perf_counter()))
                rec = {"id": req.id, "verdict": "accepted",
                       "state": "pending", "tenant": req.tenant,
                       "trace": req.trace, "source": source}
            else:
                rec = {"id": req.id, "verdict": "rejected",
                       "reason": reason, "tenant": req.tenant,
                       "trace": req.trace, "source": source}
                # backpressure hint: clients of a loaded/draining engine
                # should back off, not hammer (`submit --retry` honors it)
                if reason == reqmod.REASON_TENANT_QUARANTINED:
                    hint = self.admission.quarantine_left_s(req.tenant)
                else:
                    hint = self._retry_after(reason)
                if hint:
                    rec["retry_after_s"] = round(float(hint), 1)
        obs_trace.request_instant(
            req.trace, "admission",
            verdict=("accepted" if reason is None else "rejected"),
            tenant=req.tenant, source=source,
            **({"reason": reason} if reason else {}),
        )
        if reason == reqmod.REASON_DUPLICATE:
            # idempotency, not amnesia: a resubmitted id must never
            # clobber the original's response record. A completed
            # original's outcome is re-published (the duplicate
            # submitter gets the recorded result, timestamp refreshed
            # for its poll); a still-pending original's record is left
            # untouched — the rejection reaches only this reply, and
            # both submitters resolve from the original's outcome.
            prev = self._read_response(req.id)
            if prev and prev.get("state") == "done":
                rec = dict(prev)
                rec["duplicate"] = True
                rec.pop("unix", None)
                self._respond(req.id, rec)
                rec = {"unix": round(time.time(), 3), **rec}
            return rec
        self._respond(req.id, rec)
        return rec

    def _scan_ingest(self) -> int:
        """Admit every request file currently in the ingest dir (sorted
        by name — submitters that need ordering encode it there)."""
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
                    payload = f.read()
            except OSError as err:
                self._event(f"unreadable request file {name!r}: {err}")
                payload = None
            if payload is not None:
                rec = self._admit_payload(payload, source=f"file:{name}")
            else:
                with self._lock:
                    self.admission.shed(reqmod.REASON_MALFORMED)
                rec = {"verdict": "rejected",
                       "reason": reqmod.REASON_MALFORMED,
                       "error": "unreadable request file"}
            if "id" not in rec:
                # unparseable payloads still get a response, keyed by
                # the file stem, so the submitter is never left polling
                self._respond(os.path.splitext(name)[0], rec)
            try:
                os.unlink(path)
            except OSError:
                pass
            n += 1
        return n

    # ---- socket ----------------------------------------------------------

    def _start_socket(self) -> None:
        if not self.socket_path or not hasattr(socketmod, "AF_UNIX"):
            return
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        sock = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
        sock.bind(self.socket_path)
        sock.listen(8)
        sock.settimeout(0.2)
        self._sock = sock
        self._sock_thread = threading.Thread(
            target=self._serve_socket, name="sart-engine-socket",
            daemon=True,
        )
        self._sock_thread.start()

    def _serve_socket(self) -> None:
        while not self._sock_stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socketmod.timeout:
                continue
            except OSError:
                return
            try:
                conn.settimeout(5.0)
                chunks = []
                while True:
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    chunks.append(chunk)
                payload = b"".join(chunks).decode("utf-8", "replace")
                rec = self._admit_payload(payload, source="socket")
                conn.sendall((json.dumps(rec) + "\n").encode())
            except Exception as err:  # noqa: BLE001 - keep the listener up
                self._event(f"socket request failed: {err}")
            finally:
                try:
                    conn.close()
                except Exception:
                    pass

    def _stop_socket(self) -> None:
        self._sock_stop.set()
        if self._sock_thread is not None:
            self._sock_thread.join(timeout=2)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self.socket_path:
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass

    # ---- durable soft state (engine/state.py; docs/SERVING.md §9) --------

    def _state_payload(self) -> dict:
        from sartsolver_tpu_torch.engine.state import capture_metrics

        # counted-outcome watermark, capped like the dedup watermark
        # (same knob): insertion order means the cap drops the OLDEST
        # ids — exactly the ones whose counters are longest-durable
        try:
            cap = int(os.environ.get("SART_STATE_SEEN_CAP", "100000"))
        except ValueError:
            cap = 100000
        counted = list(self._counted_ids)
        if cap > 0:
            counted = counted[-cap:]
        return {
            "lanes": int(self.lanes),
            "admission": self.admission.export_state(),
            "counted_ids": counted,
            "metrics": capture_metrics(obs_metrics.get_registry()),
        }

    def _save_state(self) -> bool:
        """Checkpoint the soft state (called at every mutation boundary:
        request outcome, lane halving, drain). Permanent failure is loud
        but not fatal — the journal is the correctness backbone, the
        checkpoint only makes the *next* crash cheaper. Returns whether
        the checkpoint landed (journal compaction must not drop
        completed ids whose watermark is durable nowhere)."""
        from sartsolver_tpu_torch.resilience.retry import RetriesExhausted

        try:
            # payload capture under the engine lock: the socket thread
            # admits concurrently, and export_state iterates the tenant
            # table the admit path inserts into
            with self._lock:
                payload = self._state_payload()
            self.state.save(payload)
            self.state.maybe_compact()
            return True
        except RetriesExhausted as err:
            obs_metrics.get_registry().counter(
                "engine_checkpoint_failures_total"
            ).inc()
            self._event(f"state checkpoint failed (soft state will be "
                        f"stale after a crash): {err}")
            return False

    def _restore_state(self) -> None:
        """Restore the previous incarnation's soft state (before journal
        replay): quarantined tenants stay quarantined, the degraded lane
        ladder stays engaged, SLO burn and queue-wait history continue
        through the registry merge."""
        from sartsolver_tpu_torch.engine.state import restore_metrics

        self.state.compact()  # drop superseded/torn records at startup
        payload = self.state.load()
        if payload is None:
            return
        self.admission.restore_state(payload.get("admission") or {})
        for rid in payload.get("counted_ids") or []:
            self._counted_ids[str(rid)] = None
        ckpt_lanes = int(payload.get("lanes") or 0)
        if 1 <= ckpt_lanes < self.lanes:
            # the OOM ladder is sticky across restarts: restarting into
            # the full lane count would re-OOM on the same pressure
            self.lanes = ckpt_lanes
            self._lanes_gauge.set(float(self.lanes))
        n = restore_metrics(obs_metrics.get_registry(),
                            payload.get("metrics"))
        quarantined = self.admission.quarantined_tenants()
        self._event(
            f"state restored from checkpoint (serial "
            f"{self.state.serial}): {len(quarantined)} quarantined "
            f"tenant(s){' ' + str(quarantined) if quarantined else ''}, "
            f"lanes={self.lanes}, {n} metric series merged"
        )

    # ---- disk retention --------------------------------------------------

    def _rotate_journal(self, *, startup: bool = False) -> None:
        """Completed-id compaction: on startup always (with rotation
        enabled), at runtime once the file passes the size knob. The
        checkpoint is saved FIRST so the dedup watermark covers every
        completed id the compaction is about to drop."""
        if not self.journal_rotate_bytes:
            return
        if not startup and self.journal.size() <= self.journal_rotate_bytes:
            return
        if not self._save_state():
            # the watermark did NOT land: compacting now would drop
            # completed ids that are durable nowhere, and a restart
            # could re-solve a resubmitted one — keep the fat journal
            self._event("journal compaction skipped: the state "
                        "checkpoint (dedup watermark) did not land")
            return
        with self._lock:
            reclaimed = self.journal.compact()
        if reclaimed:
            obs_metrics.get_registry().counter(
                "engine_journal_compactions_total"
            ).inc()
            self._event(
                f"journal compacted: {reclaimed} byte(s) of completed "
                "records reclaimed (dedup watermark in the state "
                "checkpoint)"
            )

    def _sweep_orphan_tmp(self) -> None:
        """Startup sweep for ``*.tmp`` debris a kill mid-atomic-write
        left behind (responses, traces, journal/state compaction tmps
        in the engine dir itself) — crash debris must not accumulate
        across supervised restarts. Counted into the same
        ``engine_retention_deleted_total{dir=}`` family as the TTL
        sweep so one dashboard covers both reclaim paths."""
        for label, directory in (
            ("engine", self.engine_dir),
            ("responses", self.responses_dir),
            ("traces", os.path.join(self.engine_dir, "traces")),
        ):
            removed = atomicio.sweep_orphans(directory)
            if removed:
                obs_metrics.get_registry().counter(
                    "engine_retention_deleted_total", dir=label
                ).inc(removed)
                self._event(
                    f"startup sweep: {removed} orphaned .tmp file(s) "
                    f"removed from {label}/"
                )

    def _sweep_retention(self) -> None:
        """TTL sweep for responses/ and traces/ — a resident engine must
        bound its own disk. Runs at most every 30 s; mtime-based, so a
        freshly (re)published response always survives its TTL."""
        now = time.monotonic()
        if now - self._last_sweep < 30.0:
            return
        self._last_sweep = now
        for ttl, directory, label in (
            (self.response_ttl_s, self.responses_dir, "responses"),
            (self.trace_ttl_s, os.path.join(self.engine_dir, "traces"),
             "traces"),
        ):
            if not ttl:
                continue
            try:
                names = os.listdir(directory)
            except OSError:
                continue
            cutoff = time.time() - ttl
            removed = 0
            for name in names:
                path = os.path.join(directory, name)
                try:
                    if os.path.getmtime(path) < cutoff:
                        os.unlink(path)
                        removed += 1
                except OSError:
                    continue
            if removed:
                obs_metrics.get_registry().counter(
                    "engine_retention_deleted_total", dir=label
                ).inc(removed)
                self._event(
                    f"retention sweep: {removed} expired file(s) "
                    f"removed from {label}/"
                )

    # ---- backpressure hints ----------------------------------------------

    def _retry_after(self, reason: str) -> Optional[float]:
        """The `retry_after_s` hint for a shed/reject response: how long
        a well-behaved client should back off before resubmitting
        (docs/SERVING.md §3). Derived from live pressure — queue depth
        times the observed mean request solve time for capacity sheds,
        the remaining cooldown for quarantine, a stable constant for a
        drain (the restart window)."""
        if reason in (reqmod.REASON_QUEUE_FULL, reqmod.REASON_DEGRADED,
                      reqmod.REASON_TENANT_QUOTA):
            est = 1.0
            if self._solve_hist.count:
                est = max(self._solve_hist.sum / self._solve_hist.count,
                          0.1)
            depth = max(1, int(self.admission.queue_depth))
            return round(min(max(depth * est, 1.0), 600.0), 1)
        if reason == reqmod.REASON_DRAINING:
            return 2.0
        return None

    # ---- replay ----------------------------------------------------------

    def _replay(self) -> None:
        completed, pending, handed_off = self.journal.replay_full()
        # a handed-off id is now another worker's story: this worker
        # must neither re-drive it (replay_full already excludes it
        # from pending) nor re-admit a resubmission of it — the
        # survivor owns the response, and a second acceptance here
        # would break exactly-once fleet-wide
        for rid in handed_off:
            self.admission.note_seen(rid)
        if handed_off:
            self._event(
                f"journal replay: {len(handed_off)} handed-off "
                "request(s) pinned as duplicates (survivor owns them)"
            )
        for rid, outcome in completed.items():
            self.admission.note_seen(rid)
            # the republish gate lives in engine/protocol.py next to
            # the effect-point table, and the crash-point model checker
            # (the JAX analysis/protocol.py) drives that same function over
            # every crash prefix — stale means missing OR still showing
            # the acceptance verdict (the kill landed after the
            # completed marker fsync'd but before the done response
            # replaced the pending one), age-gated by the retention TTL
            prev = self._read_response(rid) if outcome else None
            if needs_republish(outcome, prev,
                               response_ttl_s=self.response_ttl_s):
                self._respond(rid, {
                    "id": rid, "verdict": "accepted", "state": "done",
                    "trace": outcome.get("trace"), "outcome": outcome,
                    "republished": True,
                })
        # counter continuity (chaos invariant 4): a kill between the
        # completed marker and the next checkpoint restored a watermark
        # that does not cover some journal-completed ids — their
        # outcome/SLO increments died with the process, and replay used
        # to republish the response WITHOUT re-counting. Re-derive
        # exactly those increments from the journaled outcomes; no save
        # here (idempotent until _rotate_journal's startup checkpoint
        # absorbs the watermark).
        recounted = 0
        for rid, outcome in uncounted_completed(completed,
                                                self._counted_ids):
            self._requests_ctr(
                str(outcome.get("status") or "unknown")
            ).inc()
            if self.slo_ms is not None:
                latency = float(outcome.get("latency_s") or 0.0)
                name = ("engine_slo_breach_total"
                        if latency * 1e3 > self.slo_ms
                        else "engine_slo_ok_total")
                obs_metrics.get_registry().counter(
                    name, tenant=str(outcome.get("tenant") or "default")
                ).inc()
            self._counted_ids[rid] = None
            recounted += 1
        if recounted:
            self._event(
                f"journal replay: {recounted} completed outcome(s) "
                "re-counted (crashed before their checkpoint)"
            )
        if not completed and not pending:
            return
        for req in pending:
            # re-accepted ahead of new ingest, in acceptance order; a
            # partial output from the interrupted attempt is removed so
            # the re-run writes the file fresh (byte-identical replay)
            self.admission.note_seen(req.id)
            self.admission.queue_depth += 1
            self.admission._tenant(req.tenant).queued += 1
            self.admission._depth_gauge.set(
                float(self.admission.queue_depth)
            )
            self._set_span(req, "replayed")
            self._queue.append((req, time.monotonic(),
                                time.perf_counter()))
            out = os.path.join(self.outputs_dir, f"{req.id}.h5")
            try:
                os.unlink(out)
            except OSError:
                pass
        self._event(
            f"journal replay: {len(completed)} completed request(s) "
            f"skipped, {len(pending)} accepted-but-unfinished "
            "re-queued"
        )

    # ---- request finalization --------------------------------------------

    def _finish(self, ar: _ActiveRequest, outcome: str,
                error: Optional[str] = None) -> None:
        trace_id = ar.req.trace
        if ar.writer is not None:
            sess = ar.session if ar.session is not None else self.session
            self._set_span(ar.req, "io.write")
            with obs_trace.request_span(trace_id, "io.write",
                                        frames=ar.got):
                ar.writer.flush()
                sess.grid.write_hdf5(ar.output, "voxel_map")
        wall = time.perf_counter() - ar.t_dispatch
        self._solve_hist.observe(wall)
        latency = time.monotonic() - ar.t_accepted
        self._latency_hist.observe(latency)
        # per-tenant twins resolve through the registry's own cached
        # instrument lookup (GIL-atomic fast path, obs/metrics.py)
        registry = obs_metrics.get_registry()
        registry.histogram("engine_request_latency_s",
                           tenant=ar.req.tenant).observe(latency)
        if self.slo_ms is not None:
            # the error-budget counter pair: burn rate is
            # breach / (ok + breach), per tenant
            name = ("engine_slo_breach_total"
                    if latency * 1e3 > self.slo_ms
                    else "engine_slo_ok_total")
            registry.counter(name, tenant=ar.req.tenant).inc()
        if ar.deadline_missed:
            self._deadline_miss_ctr.inc()
        rec = {
            "status": outcome,
            "frames": ar.got,
            "by_status": dict(ar.by_status),
            "output": (os.path.relpath(ar.output, self.engine_dir)
                       if ar.writer is not None else None),
            "solve_s": round(wall, 3),
            "latency_s": round(latency, 3),
            "tenant": ar.req.tenant,
            "trace": trace_id,
        }
        if error:
            rec["error"] = error
        self._set_span(ar.req, "journal.completed")
        with self._lock:
            self.journal.completed(ar.req, rec)
            self.admission.note_outcome(ar.req, outcome)
        self._requests_ctr(outcome).inc()
        # checkpoint BEFORE the response write: the completed marker is
        # already durable, and a kill inside the response window must
        # not lose the outcome/SLO counters. A kill BEFORE this save is
        # covered too: the watermark below won't land, so the restart's
        # replay re-counts this id from its journaled outcome (chaos
        # invariant 4: counter continuity over every crash prefix)
        self._counted_ids[ar.req.id] = None
        self._save_state()
        self._respond(ar.req.id, {
            "id": ar.req.id, "verdict": "accepted", "state": "done",
            "trace": trace_id, "outcome": rec,
        })
        obs_trace.request_instant(trace_id, "request.done",
                                  outcome=outcome, frames=ar.got)
        self._write_request_trace(ar)
        if self.telemetry is not None:
            self.telemetry.record_event(
                f"request {ar.req.id} ({ar.req.tenant}): {outcome} "
                f"({ar.got} frame(s) in {wall:.3f}s) "
                f"trace={trace_id}"
            )
        self._clear_span(ar.req.id)
        if ar.req.id in self._active_ids:
            self._active_ids.remove(ar.req.id)

    def _write_request_trace(self, ar: _ActiveRequest) -> None:
        """With tracing active, publish the request's section of the
        trace buffer as a standalone Perfetto-loadable file
        (``<engine_dir>/traces/<id>.trace.json``) — one ``sartsolve
        submit`` round trip yields one trace. With tracing disabled
        (the default) this is a no-op: no directory, no file."""
        payload = obs_trace.request_trace(ar.req.trace)
        if payload is None:
            return
        traces_dir = os.path.join(self.engine_dir, "traces")
        path = os.path.join(traces_dir, f"{ar.req.id}.trace.json")
        try:
            os.makedirs(traces_dir, exist_ok=True)
            atomicio.write_json_atomic(path, payload, fsync=True)
        except OSError as err:
            self._event(
                f"trace write for {ar.req.id!r} failed: {err}"
            )

    # ---- the solve cycle -------------------------------------------------

    def _pop_cycle_batch(self) -> List[Tuple[Request, float, float]]:
        """Pop the next solve cycle off the queue (caller holds the
        lock). A cycle runs ONE batcher on ONE session, so in
        cache mode every request in it must lease the same session key
        (a request-attached geometry keys its own session): the cycle
        takes the head's key-mates, up to ``max_cycle_requests``; other
        keys keep their queue order for the next cycle. Under the
        default single-key routing this is exactly the old FIFO slice."""
        if not self._queue:
            return []
        if self._session_cache is None:
            batch = self._queue[: self.max_cycle_requests]
            del self._queue[: len(batch)]
            return batch
        head_key = self._session_cache.key_for(self._queue[0][0])
        batch, rest = [], []
        for item in self._queue:
            if (len(batch) < self.max_cycle_requests
                    and self._session_cache.key_for(item[0]) == head_key):
                batch.append(item)
            else:
                rest.append(item)
        self._queue[:] = rest
        return batch

    def _solve_cycle(
        self, batch: List[Tuple[Request, float, float]]
    ) -> None:
        from sartsolver_tpu_torch.sched import ContinuousBatcher

        now = time.monotonic()
        gens = []
        route: deque = deque()
        active: List[_ActiveRequest] = []
        for req, t_acc, t_acc_perf in batch:
            with self._lock:
                self.admission.note_dispatched(req)
            wait = now - t_acc
            self._queue_wait_hist.observe(wait)
            obs_metrics.get_registry().histogram(
                "engine_queue_wait_s", tenant=req.tenant
            ).observe(wait)
            # the queue-wait span is only known complete at dispatch:
            # emitted retroactively over [acceptance, now]
            obs_trace.request_complete(req.trace, "queue.wait",
                                       t_acc_perf, time.perf_counter(),
                                       tenant=req.tenant)
            deadline = absolute_deadline(req, t_acc)
            output = os.path.join(self.outputs_dir, f"{req.id}.h5")
            if deadline is not None and now > deadline:
                # queue wait alone blew the budget: shed WITHOUT
                # touching the solver (the load-shedding half of the
                # deadline contract)
                ar = _ActiveRequest(req, 0, deadline, output,
                                    t_accepted=t_acc)
                ar.deadline_missed = True
                obs_trace.request_instant(req.trace, "deadline.shed",
                                          where="queued")
                with self._lock:
                    self.journal.dispatched(req)
                self._finish(ar, reqmod.REQ_SHED_DEADLINE,
                             error="deadline passed while queued")
                continue
            self._set_span(req, "journal.dispatched")
            with self._lock:
                self.journal.dispatched(req)
            # per-REQUEST warning scope: a resident process must surface
            # the non-finite-pixel warning for every affected request,
            # not once per process lifetime (models/sart.py latch)
            from sartsolver_tpu_torch.models.sart import reset_nonfinite_warning

            reset_nonfinite_warning()
            self._set_span(req, "session.attach")
            try:
                with obs_trace.request_span(req.trace, "session.attach",
                                            time_range=req.time_range):
                    # cache mode: attach-or-build under the byte budget
                    # (a build failure fails THIS request, like a torn
                    # attach — the engine keeps serving)
                    sess = self._lease_session(req)
                    image = sess.attach(req)
            except (SartInputError,) + failures.RECOVERABLE_FRAME_ERRORS as err:
                ar = _ActiveRequest(req, 0, deadline, output,
                                    t_accepted=t_acc)
                self._finish(ar, reqmod.REQ_FAILED,
                             error=f"{type(err).__name__}: {err}")
                continue
            ar = _ActiveRequest(req, sess.n_frames(image),
                                deadline, output, t_accepted=t_acc,
                                session=sess)
            self._active_ids.append(req.id)
            if ar.expected == 0:
                self._finish(ar, reqmod.REQ_COMPLETED)
                continue
            self._set_span(req, "solve")
            active.append(ar)
            route.extend([ar] * ar.expected)
            gens.append(sess.frame_items(image, deadline,
                                         trace_id=req.trace))
        if not active:
            return

        # one batcher run per cycle, on the cycle's LAST leased session:
        # a batch shares one cache key under the default keying, and a
        # forced mid-batch eviction rebuilds the same key — the
        # deterministic frame solve keeps outputs byte-identical across
        # that churn (the eviction drill's assertion)
        session = active[-1].session or self.session
        nvoxel = session.nvoxel

        def add_row(ar: _ActiveRequest, row, status: int, ftime,
                    cam_times, iterations: int) -> None:
            if ar.writer is None:
                from sartsolver_tpu_torch.io.solution import SolutionWriter

                ar.writer = SolutionWriter(
                    ar.output, session.camera_names, nvoxel,
                )
            ar.writer.add(row, status, ftime, cam_times,
                          iterations=iterations)
            name = status_name(status)
            ar.by_status[name] = ar.by_status.get(name, 0) + 1
            ar.got += 1
            watchdog.beacon(watchdog.PHASE_FRAME_DONE)

        def on_result(ftime, cam_times, status, iterations, convergence,
                      fetcher, per_frame_ms) -> None:
            ar = route.popleft()
            row = fetcher() if callable(fetcher) else np.asarray(fetcher)
            add_row(ar, row, status, ftime, cam_times, iterations)
            if status == DEADLINE_EXCEEDED:
                ar.deadline_missed = True
            if self.telemetry is not None:
                self.telemetry.record_frame(
                    ftime, status, iterations, convergence,
                    per_frame_ms, "engine", trace=ar.req.trace,
                )
            if ar.done:
                self._finish_solved(ar)

        def on_failed(ftime, cam_times, err) -> None:
            ar = route.popleft()
            add_row(ar, failed_row(nvoxel), FRAME_FAILED, ftime,
                    cam_times, -1)
            if self.telemetry is not None:
                # FAILED rows carry the trace id too: a tenant's "my
                # request lost frames" triages from the artifact alone
                self.telemetry.record_frame(
                    ftime, FRAME_FAILED, -1, None, None, "engine",
                    error=type(err).__name__, trace=ar.req.trace,
                )
            if ar.done:
                self._finish_solved(ar)

        items = iter(itertools.chain.from_iterable(gens))
        interrupted = False
        while True:
            batcher = ContinuousBatcher(
                session.solver, lanes=self.lanes,
                on_result=on_result, on_failed=on_failed,
                stop_check=shutdown.stop_requested,
                on_event=self._event, isolate=True,
            )
            stats = batcher.run(items)
            interrupted = interrupted or stats.interrupted
            if stats.leftover is None:
                break
            # device OOM: halve the lane count (sticky, the CLI ladder's
            # semantics) and flip admission into degraded load-shed mode
            if self.lanes <= 1:
                # the ladder is exhausted: every un-emitted frame —
                # handed back by the scheduler AND still unread from the
                # stream — fails in order (per-frame isolation)
                for item in itertools.chain(stats.leftover, items):
                    if isinstance(item, FrameFailure):
                        on_failed(item.time, item.camera_times,
                                  item.error)
                    else:
                        on_failed(item[1], item[2], stats.oom_error)
                break
            self.lanes = max(self.lanes // 2, 1)
            self._lanes_gauge.set(float(self.lanes))
            with self._lock:
                self.admission.set_degraded(
                    f"device OOM; lanes halved to {self.lanes}"
                )
            # the ladder level is checkpointed: a crash mid-degradation
            # restarts at the halved lane count, not back into the OOM
            self._save_state()
            items = iter(itertools.chain(stats.leftover, items))
        # requests truncated by a mid-cycle stop request: leave them
        # journaled dispatched-but-not-completed — the restart replays
        # them from scratch (their partial outputs are removed then)
        if interrupted and route:
            truncated = []
            for ar in route:
                if ar.req.id not in truncated:
                    truncated.append(ar.req.id)
            for ar in active:
                if ar.req.id in truncated:
                    if ar.req.id in self._active_ids:
                        self._active_ids.remove(ar.req.id)
                    self._clear_span(ar.req.id)
                    self._respond(ar.req.id, {
                        "id": ar.req.id, "verdict": "accepted",
                        "state": "interrupted", "trace": ar.req.trace,
                    })
            self._event(
                f"stop request truncated the cycle; "
                f"{len(truncated)} request(s) left for journal replay"
            )
            route.clear()

    def _count_launches(self) -> None:
        """Fold the hand kernels' launches since the last cycle into
        ``kernel_launches_total{kernel=, plan=}`` (the metrics artifact and
        the scrape show which kernel served the frames). Host counters
        only: no device work."""
        self._launches_seen = obs_metrics.count_kernel_launches(
            obs_metrics.get_registry(), self._launches_seen)

    def _finish_solved(self, ar: _ActiveRequest) -> None:
        if ar.deadline_missed:
            outcome = reqmod.REQ_SHED_DEADLINE
        elif any(ar.by_status.get(status_name(s)) for s in
                 _TERMINAL_FRAME_STATUSES):
            outcome = reqmod.REQ_PARTIAL
        else:
            outcome = reqmod.REQ_COMPLETED
        self._finish(ar, outcome)

    # ---- main loop -------------------------------------------------------

    def run(self) -> int:
        """Serve until SIGTERM/SIGINT (exit 4) or, with ``idle_exit``
        set, until the queue has been empty that long (exit 0)."""
        # sweep BEFORE restore/replay: the orphan tmps are the previous
        # incarnation's in-flight atomic writes, definitionally dead
        self._sweep_orphan_tmp()
        # restore BEFORE replay: replay must see the restored dedup
        # watermark, and replayed work must run under the restored
        # quarantine/ladder state
        self._restore_state()
        self._replay()
        self._rotate_journal(startup=True)
        watchdog.set_engine_status_provider(self._status)
        idle_since = time.monotonic()
        exit_code = EXIT_OK
        try:
            self._start_socket()
            # bind with a short retry budget: after a crash the dead
            # worker's port can linger (TIME_WAIT / late close), and a
            # supervised respawn hitting that race must not read as a
            # permanent config error — the supervisor treats exit 1 as
            # final by design. A genuinely bad port still exits 1 once
            # the budget (SART_HTTP_BIND_RETRY_S, default 5 s) runs out.
            bind_budget = float(
                os.environ.get("SART_HTTP_BIND_RETRY_S", "5") or 0
            )
            bind_deadline = time.monotonic() + bind_budget
            while True:
                try:
                    self._start_http()
                    break
                except OSError as err:
                    if time.monotonic() >= bind_deadline:
                        # polite input-error exit (taxonomy parity with
                        # the flag validators), never a traceback + a
                        # misleading crash bundle
                        print(f"sartsolve serve: cannot bind "
                              f"--http_port {self.http_port}: {err}",
                              file=sys.stderr)
                        return EXIT_INPUT_ERROR
                    time.sleep(min(0.5, max(
                        bind_deadline - time.monotonic(), 0.05)))
            while True:
                if shutdown.stop_requested() and not self._draining:
                    self._draining = True
                    left = len(self._queue)
                    self._event(
                        f"stop requested ({shutdown.stop_signal()}); "
                        f"draining — {left} queued request(s) stay "
                        "journaled for the next serve"
                    )
                if self._draining:
                    exit_code = EXIT_INTERRUPTED
                    break
                if self._scan_ingest():
                    # admissions mutate checkpointed state too (dedup
                    # watermark, admitted/shed counters): one save per
                    # ingest batch keeps the accounting continuous
                    # across a crash before the first outcome
                    self._save_state()
                # self-throttled to every 30 s — and deliberately ahead
                # of the busy branch: a continuously loaded engine is
                # exactly the one whose responses/traces grow fastest
                self._sweep_retention()
                with self._lock:
                    batch = self._pop_cycle_batch()
                if batch:
                    self._cycles += 1
                    try:
                        self._solve_cycle(batch)
                    finally:
                        self._count_launches()
                    self._rotate_journal()
                    idle_since = time.monotonic()
                    continue
                if (self.idle_exit > 0
                        and time.monotonic() - idle_since
                        >= self.idle_exit):
                    self._event(
                        f"idle for {self.idle_exit:g}s with an empty "
                        "queue; exiting"
                    )
                    break
                time.sleep(self.poll_interval)
        finally:
            self._stop_socket()
            self._stop_http()
            watchdog.set_engine_status_provider(None)
            # final checkpoint: the drain/idle exit is a state boundary
            # too (queued-but-undispatched work stays journaled; its
            # tenants' state must survive into the next serve)
            self._save_state()
            if self._session_cache is not None:
                self._session_cache.close()
        return exit_code

    # ---- live pull endpoint (--http_port) --------------------------------

    def _health(self) -> Tuple[str, Optional[str]]:
        """/healthz is pure LIVENESS (docs/SERVING.md §9): the worker
        process answering at all means live — draining and degraded are
        readiness states, not liveness states. The supervisor's
        lame-duck endpoint answers ``crash-loop``/503 here instead,
        because there the serve worker is genuinely not alive."""
        return "live", None

    def _ready(self) -> Tuple[Optional[str], Optional[str]]:
        """/readyz READINESS: (None, None) = ready to admit; else a
        byte-stable machine-readable reason + human detail (lock-free
        field reads — scrape-path contract). External supervisors and
        the built-in one read the same vocabulary: ``draining``,
        ``degraded`` (here), ``crash-loop`` (the supervisor's)."""
        if self._draining:
            return reqmod.REASON_DRAINING, "stop requested; resubmit elsewhere"
        reason = self.admission.degraded_reason
        if reason is not None:
            return reqmod.REASON_DEGRADED, reason
        return None, None

    def _start_http(self) -> None:
        if self.http_port is None:
            return
        from sartsolver_tpu_torch.engine.httpd import EngineHTTPServer
        from sartsolver_tpu_torch.obs import flight as obs_flight

        registry = obs_metrics.get_registry()
        self.http = EngineHTTPServer(
            self.http_port,
            # blocking=False throughout: a scrape must never contend
            # with the solve path (the stale-read snapshot forms)
            metrics_snapshot=lambda: registry.snapshot(blocking=False),
            health=self._health,
            ready=self._ready,
            status=lambda: obs_flight.status_snapshot(blocking=False),
        )
        self.http.start()
        self._event(
            f"live endpoints on http://127.0.0.1:{self.http.port} "
            "(/metrics /healthz /readyz /status)"
        )

    def _stop_http(self) -> None:
        if self.http is not None:
            self.http.stop()
            self.http = None
