"""In-solve checkpoints: CRC-checksummed snapshots of a run at scheduler
stride boundaries.

The one-host part of ``sartsolver_tpu/resilience/podckpt.py``. At a stride
boundary the continuous batcher (``sched/scheduler.py``) exports what its
stride loop carries — the lanes' ``SchedState`` on the device (the iterates,
the momentum carries, the guard's step scale and recovery count, the
iteration counters), the host's lane bookkeeping and the reorder buffer —
and :class:`SolveCheckpointStore` appends it as one versioned record. A
later ``--resume`` restores the run at that stride instead of re-running
the Eq. 4 guess and every sweep since the last written row.

The file is append-only JSONL, one self-delimited record per checkpoint::

    {"v": 1, "serial": N, "unix": ..., "crc": CRC32(state-json), "state": {...}}

with the CRC32 over the ``sort_keys`` serialization of ``state``, so a torn
tail or a flipped byte falls back to the previous record. The serial is the
caller's stride counter. Arrays travel as base64 raw bytes with their dtype
and shape (:func:`encode_state`), so a restore is bit-exact: what makes a
resumed solve byte-identical to an undisturbed one. The file keeps the
newest :data:`KEEP_RECORDS` records (compacted by an atomic rewrite).

Appends go through the retry policy under the fault site
``solve.checkpoint``. A permanent failure warns on stderr and the run goes
on: a checkpoint is an availability optimization, the output file stays
the record of the run (a resume then falls back further, at worst to the
plain ``--resume``). ``SART_TEST_SOLVE_CKPT_DELAY`` (seconds) holds each
append's window open after announcing ``SART_SOLVE_CKPT_POINT pre-append
serial=N`` on stderr, so a drill can kill the run mid-checkpoint.

The per-host files of a multi-process pod (``<base>.h<k>of<n>.jsonl``) and
their consistency across hosts are not ported (ROADMAP queue A item 1: a
grid of ranks refuses ``--solve_ckpt_stride``); here a run is one process,
its file ``<base>`` itself, and :func:`newest_consistent_serial` reads that
one file.
"""

from __future__ import annotations

import base64
import json
import os
import sys
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from sartsolver_tpu_torch.resilience import faults
from sartsolver_tpu_torch.resilience.retry import RetriesExhausted, retry_call
from sartsolver_tpu_torch.utils import atomicio

SOLVE_CKPT_VERSION = 1

# valid records kept in the file: the newest (the resume point), one
# fallback stride (the torn-tail contract needs it) and one of slack
KEEP_RECORDS = 3


def _crc(state_json: str) -> int:
    return zlib.crc32(state_json.encode("utf-8"))


def encode_state(obj):
    """A state tree as a JSON-safe tree: ndarrays become ``{"__nd__":
    dtype, "shape": [...], "b64": ...}`` (raw little-endian bytes, so every
    float round-trips bit for bit), numpy scalars their Python values,
    dicts, lists and tuples recurse (tuples come back as lists). Keys must
    already be strings."""
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        return {"__nd__": arr.dtype.str, "shape": list(arr.shape),
                "b64": base64.b64encode(arr.tobytes()).decode("ascii")}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {k: encode_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_state(v) for v in obj]
    return obj


def decode_state(obj):
    """Inverse of :func:`encode_state`; the arrays come back writable."""
    if isinstance(obj, dict):
        if "__nd__" in obj:
            raw = base64.b64decode(obj["b64"])
            return np.frombuffer(raw, dtype=np.dtype(obj["__nd__"])).reshape(
                obj["shape"]).copy()
        return {k: decode_state(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_state(v) for v in obj]
    return obj


class SolveCheckpointStore:
    """The append-only checkpoint file of one run, with torn-tail and CRC
    fallback."""

    def __init__(self, path: str):
        self.path = path

    def save(self, serial: int, state: dict) -> bool:
        """Append the stride-``serial`` checkpoint, flushed and fsynced,
        through the retry policy (fault site ``solve.checkpoint``); count it
        in ``solve_ckpt_written_total`` and compact the file. A permanent
        failure warns on stderr and returns False: the run goes on."""
        state_json = json.dumps(encode_state(state), sort_keys=True)
        rec = {"v": SOLVE_CKPT_VERSION, "serial": int(serial),
               "unix": round(time.time(), 3), "crc": _crc(state_json)}
        # the payload embedded as the serialized string the CRC covers
        line = json.dumps(rec)[:-1] + ', "state": ' + state_json + "}\n"
        delay = os.environ.get("SART_TEST_SOLVE_CKPT_DELAY")
        if delay:
            # the drills' crash window: a kill in here dies with the record
            # not durable, and the resume falls back one stride
            sys.stderr.write(f"SART_SOLVE_CKPT_POINT pre-append serial={int(serial)}\n")
            sys.stderr.flush()
            time.sleep(float(delay))

        def write() -> None:
            faults.fire(faults.SITE_SOLVE_CHECKPOINT)
            atomicio.append_line(self.path, line)

        try:
            retry_call(write, site=faults.SITE_SOLVE_CHECKPOINT,
                       retry_on=(OSError, faults.InjectedFault))
        except RetriesExhausted as err:
            print(f"Warning: solve checkpoint serial {int(serial)} not written "
                  f"({err}); the run goes on, a resume falls back to an earlier "
                  "checkpoint.", file=sys.stderr)
            return False
        from sartsolver_tpu_torch.obs import metrics

        metrics.get_registry().counter("solve_ckpt_written_total").inc()
        self._maybe_compact()
        return True

    def _valid_records(self) -> Dict[int, Tuple[dict, dict]]:
        """serial -> (record, encoded state) of every valid record (a later
        duplicate wins)."""
        out: Dict[int, Tuple[dict, dict]] = {}
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return out
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a torn append
            if not isinstance(rec, dict) or rec.get("v") != SOLVE_CKPT_VERSION:
                continue
            state = rec.get("state")
            if not isinstance(state, dict):
                continue
            if _crc(json.dumps(state, sort_keys=True)) != rec.get("crc"):
                continue  # a corrupt record: fall back
            out[int(rec.get("serial", 0))] = (rec, state)
        return out

    def serials(self):
        """The valid serials, ascending."""
        return sorted(self._valid_records())

    def load(self, serial: int) -> Optional[dict]:
        """The decoded state of ``serial``, or None."""
        rec = self._valid_records().get(int(serial))
        return None if rec is None else decode_state(rec[1])

    def _maybe_compact(self) -> None:
        """Keep the newest :data:`KEEP_RECORDS` valid records (an atomic
        rewrite): the file stays the size of a few records, whatever the
        run's length."""
        recs = self._valid_records()
        if len(recs) <= KEEP_RECORDS:
            return
        lines = []
        for serial in sorted(recs)[-KEEP_RECORDS:]:
            rec, state = recs[serial]
            header = {k: rec[k] for k in ("v", "serial", "unix", "crc")}
            lines.append(json.dumps(header)[:-1] + ', "state": '
                         + json.dumps(state, sort_keys=True) + "}\n")
        try:
            atomicio.write_atomic(self.path, "".join(lines))
        except OSError:
            pass  # compaction is advisory; the next save retries


def newest_consistent_serial(path: str) -> Optional[int]:
    """The newest valid serial of the run's checkpoint file, or None: the
    one-host case of the JAX package's pod-wide intersection."""
    serials = SolveCheckpointStore(path).serials()
    return serials[-1] if serials else None


__all__ = ["SolveCheckpointStore", "SOLVE_CKPT_VERSION", "KEEP_RECORDS",
           "encode_state", "decode_state", "newest_consistent_serial"]
