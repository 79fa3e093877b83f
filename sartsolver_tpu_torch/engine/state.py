"""Durable engine soft state: versioned, CRC-checksummed checkpoints.

Counterpart of ``sartsolver_tpu/engine/state.py``, host-only: it imports
neither torch nor JAX, and its records are the JAX engine's, field for field.

The request journal (engine/journal.py) makes accepted *work* durable,
but the engine also accumulates *soft* state that until now died with
the process: tenant quarantine streaks and cooldowns, the sticky
degraded lane ladder, SLO error-budget counters, and the admission
dedup watermark (ids ever seen). A crash therefore un-quarantined noisy
tenants, reset SLO burn to zero and — once the journal is compacted —
forgot which ids were already served. This module is the checkpoint
that keeps that state continuous across supervised restarts
(docs/SERVING.md §9).

File format (``<engine_dir>/state.jsonl``): append-only JSONL, one
self-delimited record per checkpoint::

    {"v": 1, "serial": N, "unix": ..., "crc": CRC32(state-json), "state": {...}}

- Every append is flush+fsync'd through the shared retry policy (named
  fault site ``state.checkpoint``); unlike the journal, *permanent*
  checkpoint failure degrades loudly (stale soft state after the next
  crash) instead of aborting — the journal is the correctness backbone,
  the checkpoint is an availability optimization.
- :meth:`StateStore.load` scans the file and returns the LAST record
  whose version matches and whose CRC validates. A torn tail (the
  process died mid-append) or a corrupt record therefore restores the
  previous consistent checkpoint, never garbage — pinned by the
  torn-tail property test in tests/test_selfheal.py.
- :meth:`StateStore.compact` rewrites the file down to its last valid
  record via atomic rename (tmp + ``os.replace``), bounding growth; the
  server compacts on startup and whenever the file passes
  ``SART_STATE_ROTATE_BYTES`` (default 256 KiB).

The ``state`` payload's ``metrics`` entry is a plain obs registry
snapshot subset (engine counter/histogram families); restore folds it
back with :meth:`~sartsolver_tpu_torch.obs.metrics.MetricsRegistry.
merge_snapshot` — the registry's cross-host merge semantics (counters
sum, histogram moments/buckets add) are exactly restart-continuity
semantics, so SLO burn and queue-wait history accumulate across
process incarnations instead of resetting.

Deterministic crash window for the chaos harness: with
``SART_TEST_CKPT_DELAY`` set, every append announces
``SART_CKPT_POINT pre-append`` on stderr and holds the pre-durability
window open so a SIGKILL lands deterministically mid-checkpoint.
"""

from __future__ import annotations

import json
import os
import sys
import time
import zlib
from typing import Optional, Tuple

from sartsolver_tpu_torch.resilience import faults
from sartsolver_tpu_torch.resilience.retry import retry_call
from sartsolver_tpu_torch.utils import atomicio

STATE_VERSION = 1

# Engine metric families carried by the checkpoint (counters and
# histograms only: both merge additively, which is what continuity
# means; gauges describe the live process and are re-set at startup).
STATE_METRIC_PREFIXES = ("engine_", "sched_deadline_shed_total")
STATE_METRIC_KINDS = ("counter", "histogram")


def _crc(state_json: str) -> int:
    return zlib.crc32(state_json.encode("utf-8"))


class StateStore:
    """Append-only checkpoint file with last-consistent-record restore."""

    def __init__(self, path: str):
        self.path = path  # durable: state checkpoint
        self.serial = 0
        self._last_record_bytes = 0

    # ---- write -----------------------------------------------------------

    def save(self, state: dict) -> None:
        """Durably append one checkpoint record (flush+fsync before
        returning, through the shared retry policy)."""
        self.serial += 1
        state_json = json.dumps(state, sort_keys=True)
        rec = {"v": STATE_VERSION, "serial": self.serial,
               "unix": round(time.time(), 3), "crc": _crc(state_json)}
        # the state payload is embedded as the already-serialized string's
        # object form so the CRC is computed over exactly the bytes the
        # loader re-serializes for verification (sort_keys canonicalizes)
        line = (json.dumps(rec)[:-1] + ', "state": ' + state_json + "}\n")
        delay = os.environ.get("SART_TEST_CKPT_DELAY")
        if delay:
            # chaos-harness crash window: a SIGKILL in here dies with the
            # record NOT yet durable — restore must read the previous one
            sys.stderr.write("SART_CKPT_POINT pre-append\n")
            sys.stderr.flush()
            time.sleep(float(delay))

        def write() -> None:
            faults.fire(faults.SITE_STATE_CHECKPOINT)
            atomicio.append_line(self.path, line)

        retry_call(write, site=faults.SITE_STATE_CHECKPOINT,
                   retry_on=(OSError,))
        self._last_record_bytes = len(line)

    # ---- read ------------------------------------------------------------

    def load(self) -> Optional[dict]:
        """The last consistent checkpoint's ``state`` payload, or None.

        Scans every line; a record only counts when its version matches
        and its CRC validates over the canonical re-serialization of the
        payload — a torn tail or a flipped byte silently falls back to
        the previous record (the "last consistent state" contract)."""
        rec = self._last_valid()
        return None if rec is None else rec[1]

    def _last_valid(self) -> Optional[Tuple[dict, dict]]:
        if not os.path.exists(self.path):
            return None
        best: Optional[Tuple[dict, dict]] = None
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return None
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn append
            if not isinstance(rec, dict) or rec.get("v") != STATE_VERSION:
                continue
            state = rec.get("state")
            if not isinstance(state, dict):
                continue
            if _crc(json.dumps(state, sort_keys=True)) != rec.get("crc"):
                continue  # corrupt record: keep the previous one
            best = (rec, state)
            self.serial = max(self.serial, int(rec.get("serial", 0)))
        return best

    # ---- rotation --------------------------------------------------------

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def compact(self) -> None:
        """Rewrite the file down to its last valid record (atomic
        rename). A store with no valid record is left untouched — an
        all-torn file still documents that something went wrong."""
        rec = self._last_valid()
        if rec is None:
            return
        full, state = rec
        state_json = json.dumps(state, sort_keys=True)
        header = {k: full[k] for k in ("v", "serial", "unix", "crc")}
        line = (json.dumps(header)[:-1] + ', "state": ' + state_json
                + "}\n")
        atomicio.write_atomic(self.path, line)

    def rotate_bytes(self) -> int:
        raw = os.environ.get("SART_STATE_ROTATE_BYTES", "262144")
        try:
            return max(int(raw), 0)
        except ValueError:
            print(f"sartsolve: ignoring malformed SART_STATE_ROTATE_BYTES="
                  f"{raw!r} (using 262144)", file=sys.stderr)
            return 262144

    def maybe_compact(self) -> None:
        limit = self.rotate_bytes()
        if not limit:
            return
        # the threshold scales with the record size: once one record
        # (a large dedup watermark) outgrows the byte knob, a pure
        # byte threshold would rewrite the whole file after EVERY
        # append — keep at least ~4 records between compactions so
        # write amplification stays bounded whatever the record size
        limit = max(limit, 4 * self._last_record_bytes)
        if self.size() > limit:
            self.compact()


# ---------------------------------------------------------------------------
# registry subset capture/restore
# ---------------------------------------------------------------------------

def capture_metrics(registry) -> list:
    """The checkpoint's metric payload: engine counter/histogram
    snapshots (additive kinds only — see STATE_METRIC_* above)."""
    out = []
    for snap in registry.snapshot():
        if snap.get("kind") not in STATE_METRIC_KINDS:
            continue
        name = snap.get("name", "")
        if any(name.startswith(p) for p in STATE_METRIC_PREFIXES):
            out.append(snap)
    return out


def restore_metrics(registry, snapshot) -> int:
    """Fold a checkpoint's metric payload into the (fresh) registry via
    the cross-host merge — counters sum and histogram moments/buckets
    add, which across process incarnations reads as continuity."""
    if not snapshot:
        return 0
    safe = [s for s in snapshot
            if isinstance(s, dict) and s.get("kind") in STATE_METRIC_KINDS]
    registry.merge_snapshot(safe)
    return len(safe)


__all__ = ["StateStore", "STATE_VERSION", "capture_metrics",
           "restore_metrics"]
