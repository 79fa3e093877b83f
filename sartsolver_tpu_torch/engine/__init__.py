"""Resident serving engine (docs/SERVING.md).

Counterpart of ``sartsolver_tpu/engine/``. The one-shot CLI pays the full
cold path (parse, ingest, build the solver, solve, exit) on every run; the
engine keeps the expensive state resident (the matrix on the device and the
solver over it) and serves *requests* against it with a fault-contained
lifecycle:

- :mod:`.request` — the request record, payload parsing, and the
  machine-readable admission/outcome vocabulary.
- :mod:`.routing` — tenant affinity and the fleet routing table.
- :mod:`.journal` — the crash-recoverable append-only request journal
  (accepted -> dispatched -> completed; idempotent replay).
- :mod:`.admission` — admission control: bounded queue, per-tenant
  quotas, failure quarantine, degraded-mode load shedding.
- :mod:`.state` / :mod:`.protocol` — the durable soft state and the
  declared effect points with the replay decisions.
- :mod:`.session` — the resident session (solver + geometry held across
  requests) and the byte-budgeted session cache.
- :mod:`.server` — the serve loop: file-watch ingest dir + local socket,
  deadline-aware dispatch through the continuous batcher, SIGTERM drain,
  journal replay on restart.
- :mod:`.httpd` — the 127.0.0.1 pull endpoints.
- :mod:`.cli` — ``serve`` / ``submit``.

The one-shot CLI imports nothing here: it runs the same with the engine
code present but unused.
"""

from sartsolver_tpu_torch.engine.request import Request, RequestError  # noqa: F401
