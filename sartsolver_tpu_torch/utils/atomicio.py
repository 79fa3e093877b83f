"""Whole-file publishes by rename.

Counterpart of ``sartsolver_tpu/utils/atomicio.py``'s
:func:`write_atomic`, :func:`write_json_atomic` and :func:`append_line`.
A publish writes the data to
``<path>.<pid>.tmp``, optionally fsynced, then ``os.replace`` puts it in
place, so a reader (the node-exporter textfile collector, a trace viewer)
never sees a half-written file. With ``fsync=False`` (advisory files:
scrape textfiles, traces) a crash straddling the rename may publish a torn
file; the knob is explicit at every call site. :func:`append_line` appends
one record and syncs it before it returns.
"""

from __future__ import annotations

import json
import os


def write_atomic(path: str, data: str, *, fsync: bool = True) -> None:
    """Atomically publish ``data`` as the whole content of ``path``."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)


def write_json_atomic(path: str, payload: dict, *, fsync: bool = True) -> None:
    """:func:`write_atomic` for one JSON record (trailing newline)."""
    write_atomic(path, json.dumps(payload) + "\n", fsync=fsync)


def append_line(path: str, data: str, *, fsync: bool = True) -> None:
    """Durably append ``data`` (one JSONL record, caller-terminated) to
    ``path``: write, flush and fsync before returning."""
    with open(path, "a") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
