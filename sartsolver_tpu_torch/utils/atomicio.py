"""Durable writes: appends that sync, and whole-file publishes by rename.

Counterpart of ``sartsolver_tpu/utils/atomicio.py``. Every durable byte the
package writes goes through two primitives:

- :func:`append_line`: an append-only JSONL record (journal markers, state
  checkpoints, supervisor and fleet events), written, flushed and fsynced
  before it returns, so a ``kill -9`` at any instant leaves a consistent
  prefix and at most one torn final line, which every reader skips.
- :func:`write_atomic` / :func:`write_json_atomic`: a whole-file publish
  (responses, compactions, the routing table, scrape textfiles, traces):
  the data goes to ``<path>.<pid>.tmp``, optionally fsynced, then
  ``os.replace`` puts it in place. With ``fsync=True`` a crash never
  publishes a truncated file; with ``fsync=False`` (advisory files only) a
  crash straddling the rename may publish a torn one, which is why the knob
  is explicit at every call site. Either way a kill mid-write leaves only
  ``*.tmp`` debris, which :func:`sweep_orphans` removes at a serve
  process's start.

The SL2xx durability lint (``analysis/durability.py``) holds that writes to
``# durable:``-declared paths go through this module, and the crash-point
model checker (``analysis/protocol.py``) swaps the filesystem behind it with
:func:`use_fs` to tear the writes at every crash point. That is why all I/O
below goes through one small filesystem interface (:class:`_RealFS` in
production) instead of calling ``open`` at each site.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Iterator


class _RealFS:
    """The production backend: plain POSIX files."""

    def append(self, path: str, data: str, *, fsync: bool = True) -> None:
        with open(path, "ab+") as f:
            # seal a torn tail first: a kill mid-append leaves a partial
            # record with no newline, and the next record appended onto it
            # would make one unparseable line of both. A lone newline turns
            # the torn prefix into a line of its own, which every reader
            # skips.
            f.seek(0, os.SEEK_END)
            if f.tell() > 0:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
            f.write(data.encode("utf-8"))
            f.flush()
            if fsync:
                os.fsync(f.fileno())

    def write_atomic(self, path: str, data: str, *, fsync: bool = True) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)

    def remove(self, path: str) -> None:
        os.unlink(path)


_REAL_FS = _RealFS()
# The active backend. Rebinding is for the checker and tests, single-
# threaded by contract (use_fs below); production never swaps it.
_fs = _REAL_FS


def current_fs():
    """The active backend (the protocol checker's shim, or the real one)."""
    return _fs


@contextlib.contextmanager
def use_fs(fs) -> Iterator[None]:
    """Route every helper below through ``fs`` for the block (the crash-
    point model checker's shim). Not thread-safe: checker and tests only."""
    global _fs
    prev = _fs
    _fs = fs
    try:
        yield
    finally:
        _fs = prev


def append_line(path: str, data: str, *, fsync: bool = True) -> None:
    """Durably append ``data`` (one JSONL record, caller-terminated) to
    ``path``: write, flush and fsync before returning."""
    _fs.append(path, data, fsync=fsync)


def write_atomic(path: str, data: str, *, fsync: bool = True) -> None:
    """Atomically publish ``data`` as the whole content of ``path`` (tmp and
    rename). ``fsync=True``: the published file is never torn;
    ``fsync=False`` is for advisory files only."""
    _fs.write_atomic(path, data, fsync=fsync)


def write_json_atomic(path: str, payload: dict, *, fsync: bool = True) -> None:
    """:func:`write_atomic` for one JSON record (trailing newline)."""
    _fs.write_atomic(path, json.dumps(payload) + "\n", fsync=fsync)


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
            _fs.remove(path)
        except OSError:
            continue
        removed += 1
    return removed


__all__ = [
    "append_line", "write_atomic", "write_json_atomic", "sweep_orphans",
    "use_fs", "current_fs",
]
