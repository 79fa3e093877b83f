"""Named locks and the stale-read convention of the observability layer.

Counterpart of ``sartsolver_tpu/utils/locking.py``'s :func:`named_lock` and
:func:`stale_read`. Every lock of the metrics registry and the trace buffer
is made by :func:`named_lock`, which names the site
(``obs.metrics.registry``, ``obs.trace.buffer``) so that a lock-order
detector can key on it. The port does not have that detector yet
(``SART_LOCK_DEBUG``, ROADMAP queue A item 7): :func:`named_lock` returns a
plain ``threading.Lock``.

:func:`stale_read` is the bounded lock-free copy that the non-blocking
snapshot paths fall back on: a signal handler must never wait on a lock the
interrupted frame holds.
"""

from __future__ import annotations

import threading


def named_lock(name: str) -> threading.Lock:
    """A lock for the site ``name`` (dotted, e.g. ``obs.metrics.registry``):
    a plain ``threading.Lock``."""
    del name  # the site name keys the lock-order detector (queue A item 7)
    return threading.Lock()


def stale_read(fn, attempts: int = 4, default=None):
    """Bounded lock-free read for signal or crash context.

    ``fn`` copies a container another thread mutates. Each attempt is
    atomic or raises under the GIL (an insert racing the copy raises
    ``RuntimeError``), so retry a few times and settle for ``default``
    rather than hang or raise out of a status poke.
    """
    for _ in range(attempts):
        try:
            return fn()
        except RuntimeError:  # pragma: no cover - needs a mid-mutate race
            continue
    return default  # pragma: no cover - `attempts` consecutive races
