"""Live pull endpoints for the resident engine (docs/OBSERVABILITY.md §10).

Counterpart of ``sartsolver_tpu/engine/httpd.py``, host-only: it imports
neither torch nor JAX, and its records are the JAX engine's, field for field.

Opt-in via ``sartsolve serve --http_port``: a stdlib ``http.server`` in
one daemon thread exposing three read-only surfaces:

- ``/metrics`` — Prometheus text exposition rendered from the SAME
  registry snapshot and the SAME renderer as the ``SART_METRICS_PROM``
  textfile sink (:func:`sartsolver_tpu_torch.obs.sinks.render_prometheus`), so
  a scrape is family-for-family byte-equivalent to the textfile written
  from the same snapshot — pinned by tests/test_request_trace.py.
- ``/healthz`` — LIVENESS: the serve worker answering at all is
  ``live`` (200). The supervisor's lame-duck stand-in answers
  ``crash-loop`` (503) on the same path — there the worker is genuinely
  not alive (docs/SERVING.md §9).
- ``/readyz`` — READINESS: ``ready`` (200) or ``not-ready`` (503) with
  a byte-stable machine-readable ``reason`` (``draining`` /
  ``degraded`` / ``crash-loop``) — the signal an external load balancer
  or supervisor gates traffic on.
- ``/status`` — the SIGUSR1 status snapshot JSON
  (:func:`sartsolver_tpu_torch.obs.flight.status_snapshot`) with the engine
  section's active request ids, trace ids and current spans.

Contention contract: every handler reads ONLY the non-blocking /
stale-read snapshot forms (``blocking=False``, the signal-context
paths), so a scrape can never wait on a lock the solve path holds —
a slow scraper costs the run nothing. With ``--http_port`` unset (the
default) nothing here is imported at serve time: no socket, no thread,
no new files (the disabled-path identity contract).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple


class EngineHTTPServer:
    """The engine's scrape endpoint: bind, serve in a daemon thread.

    ``metrics_snapshot`` returns a registry snapshot list (non-blocking
    form); ``health`` returns ``(state, detail)`` — 200 for the live
    states (``live``/``ok``/``degraded``), 503 otherwise; ``ready``
    returns ``(reason, detail)`` with reason None = ready (200), else
    the byte-stable not-ready reason (503); ``status`` returns the
    status-snapshot record. ``port=0`` binds an ephemeral port (tests);
    :attr:`port` reports the bound one.
    """

    # health states answered 200; anything else (draining on a
    # legacy health callable, crash-loop from the supervisor) is 503
    LIVE_STATES = ("live", "ok", "degraded")

    def __init__(
        self,
        port: int,
        *,
        metrics_snapshot: Callable[[], list],
        health: Callable[[], Tuple[str, Optional[str]]],
        status: Callable[[], dict],
        ready: Optional[
            Callable[[], Tuple[Optional[str], Optional[str]]]
        ] = None,
        host: str = "127.0.0.1",
    ):
        self._metrics_snapshot = metrics_snapshot
        self._health = health
        self._ready = ready
        self._status = status
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # scrapes are machine traffic; stderr access logs would
            # drown the serve loop's event lines
            def log_message(self, *_args) -> None:
                pass

            def _send(self, code: int, body: bytes,
                      content_type: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 - stdlib casing
                try:
                    path = self.path.split("?", 1)[0].rstrip("/") or "/"
                    if path == "/metrics":
                        from sartsolver_tpu_torch.obs.sinks import (
                            render_prometheus,
                        )

                        body = render_prometheus(
                            outer._metrics_snapshot()
                        ).encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    elif path == "/healthz":
                        state, detail = outer._health()
                        rec = {"status": state}
                        if detail:
                            rec["detail"] = detail
                        code = (200 if state in outer.LIVE_STATES
                                else 503)
                        self._send(code,
                                   (json.dumps(rec) + "\n").encode(),
                                   "application/json")
                    elif path == "/readyz" and outer._ready is not None:
                        reason, detail = outer._ready()
                        if reason is None:
                            rec, code = {"status": "ready"}, 200
                        else:
                            rec, code = {"status": "not-ready",
                                         "reason": reason}, 503
                            if detail:
                                rec["detail"] = detail
                        self._send(code,
                                   (json.dumps(rec) + "\n").encode(),
                                   "application/json")
                    elif path == "/status":
                        body = (json.dumps(outer._status())
                                + "\n").encode()
                        self._send(200, body, "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as err:  # noqa: BLE001 - keep serving
                    # a failed render must cost the scraper an error,
                    # never the serve loop anything
                    try:
                        self._send(500, f"{err}\n".encode(),
                                   "text/plain")
                    except Exception:
                        pass

            do_HEAD = do_GET  # noqa: N815 - stdlib casing

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="sart-engine-http", daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2)


__all__ = ["EngineHTTPServer"]
