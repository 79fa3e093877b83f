"""Fleet routing table (docs/SERVING.md §10).

Counterpart of ``sartsolver_tpu/engine/routing.py``, host-only: it imports
neither torch nor JAX, and its records are the JAX engine's, field for field.

The controller publishes one small JSON document, ``routing.json``, at
the fleet root. It is the ONLY coupling between clients and the fleet
topology: ``sartsolve submit`` re-reads it on every retry attempt, so a
worker dying (and its requests being re-driven elsewhere) never strands
a retrying client on a dead ingest directory.

Schema (version 1)::

    {"version": 1, "size": 3, "unix": ...,
     "responses_dir": ".../responses",
     "workers": [{"index": 0, "ingest_dir": ".../workers/w0/ingest",
                  "http_port": 8601, "state": "up"}, ...]}

Tenant affinity is a pure function of the tenant name and the fleet
size (:func:`tenant_worker`): admission on each worker enforces it with
``REASON_WRONG_WORKER`` (retryable), so a client racing a stale routing
table is corrected, never silently served by the wrong shard. The
controller bypasses the check for failover re-drives via the request's
``handoff`` flag.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import List, Optional

from sartsolver_tpu_torch.utils import atomicio

ROUTING_VERSION = 1
ROUTING_BASENAME = "routing.json"


def tenant_worker(tenant: str, size: int) -> int:
    """The worker index a tenant's requests route to. CRC32 keeps the
    mapping stable across processes and languages (Python's ``hash`` is
    salted per process, which would scatter a tenant across the fleet
    on every controller restart)."""
    if size <= 1:
        return 0
    return zlib.crc32(str(tenant).encode("utf-8")) % int(size)


def routing_path(fleet_dir: str) -> str:
    return os.path.join(fleet_dir, ROUTING_BASENAME)


def publish_routing(fleet_dir: str, workers: List[dict], *,
                    responses_dir: Optional[str] = None,
                    ingest_dir: Optional[str] = None) -> str:
    """Atomically publish the routing table (fsync'd: a torn routing
    table would strand every retrying client at once). ``ingest_dir``
    is the controller's own intake — the client fallback when the
    affinity worker is down. Returns the published path."""
    path = routing_path(fleet_dir)  # durable: fleet routing table
    payload = {
        "version": ROUTING_VERSION,
        "size": len(workers),
        "unix": round(time.time(), 3),
        "responses_dir": responses_dir,
        "ingest_dir": ingest_dir,
        "workers": [
            {
                "index": int(w["index"]),
                "ingest_dir": w["ingest_dir"],
                "http_port": w.get("http_port"),
                "state": w.get("state", "up"),
            }
            for w in workers
        ],
    }
    atomicio.write_json_atomic(path, payload, fsync=True)
    return path


def read_routing(path_or_dir: str) -> Optional[dict]:
    """Read a routing table (either the file path or the fleet dir).
    Returns None when absent/torn — callers fall back to the direct
    single-worker addressing they were given."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = routing_path(path_or_dir)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(rec, dict) or rec.get("version") != ROUTING_VERSION:
        return None
    if not isinstance(rec.get("workers"), list):
        return None
    return rec


def resolve_worker(routing: dict, tenant: str) -> Optional[dict]:
    """The routing-table row tenant affinity selects, or None when the
    table is unusable. Failover does NOT change the answer — a dead
    worker's row stays (state "down") and its re-driven requests carry
    the handoff flag instead; clients keep submitting to the affinity
    target and the controller owns the redirection."""
    workers = routing.get("workers") or []
    size = int(routing.get("size") or len(workers))
    if size <= 0 or not workers:
        return None
    idx = tenant_worker(tenant, size)
    for row in workers:
        if int(row.get("index", -1)) == idx:
            return row
    return None


__all__ = [
    "ROUTING_BASENAME", "ROUTING_VERSION", "tenant_worker",
    "routing_path", "publish_routing", "read_routing", "resolve_worker",
]
