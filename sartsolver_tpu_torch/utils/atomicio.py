"""Whole-file publishes by rename.

Counterpart of ``sartsolver_tpu/utils/atomicio.py``'s
:func:`write_atomic`, :func:`write_json_atomic`, :func:`append_line` and
:func:`sweep_orphans`.
A publish writes the data to
``<path>.<pid>.tmp``, optionally fsynced, then ``os.replace`` puts it in
place, so a reader (the node-exporter textfile collector, a trace viewer)
never sees a half-written file. With ``fsync=False`` (advisory files:
scrape textfiles, traces) a crash straddling the rename may publish a torn
file; the knob is explicit at every call site. :func:`append_line` appends
one record and syncs it before it returns; a kill mid-write leaves only
``*.tmp`` debris, which :func:`sweep_orphans` removes at a serve process's
start.
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
    with open(path, "ab+") as f:
        # seal a torn tail first: a kill mid-append leaves a partial record
        # with no newline, and the next record appended onto it would make
        # one unparseable line of both. A lone newline turns the torn
        # prefix into a line of its own, which every reader skips.
        f.seek(0, os.SEEK_END)
        if f.tell() > 0:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                f.write(b"\n")
        f.write(data.encode("utf-8"))
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def sweep_orphans(directory: str, suffix: str = ".tmp") -> int:
    """Remove the ``*.tmp`` files a kill mid-publish left in ``directory``
    (not its subdirectories); returns how many. A missing or unreadable
    directory sweeps nothing."""
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    removed = 0
    for name in sorted(names):
        path = os.path.join(directory, name)
        if not name.endswith(suffix) or not os.path.isfile(path):
            continue
        try:
            os.unlink(path)
        except OSError:
            continue
        removed += 1
    return removed
