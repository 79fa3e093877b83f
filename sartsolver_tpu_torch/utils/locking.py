"""Named locks with an optional runtime lock-order detector.

Counterpart of ``sartsolver_tpu/utils/locking.py``. The host side runs a
prefetch worker, an async writer, the watchdog monitor, signal handlers and
the serving engine's threads over a handful of locked stores (the metrics
registry, the trace buffer, the flight ring, the fault registry, the
integrity layer). Every lock of those stores is made by :func:`named_lock`,
which has two personalities:

- **Production (default)**, ``SART_LOCK_DEBUG`` unset: a plain
  ``threading.Lock``. No wrapper, no bookkeeping, nothing imported beyond
  the standard library.
- **Debug (``SART_LOCK_DEBUG=1``)**: an :class:`_InstrumentedLock` feeding
  a process-global acquisition-order graph. Every blocking acquire taken
  while other named locks are held adds ``held -> wanted`` edges, keyed by
  the lock's *name* (two instances of one store share a node). An acquire
  whose new edge would close a cycle raises :class:`LockOrderViolation`
  *before it blocks*: the possible deadlock is reported from the order
  discipline alone, without the losing interleaving having to happen. The
  report carries both sides' stacks (this thread's, and the one recorded
  when the conflicting edge was first seen) and is mirrored into the
  flight ring (``obs/flight.py``) as a ``lock_order_violation`` event.
  Releases feed ``lock_hold_seconds{lock=<name>}`` histograms of the
  metrics registry (``obs/metrics.py``).

The switch is read when a lock is *created*: module-global locks latch the
mode at import, instance locks at construction. The detector is a drill
and triage tool, not a production mode: each instrumented acquire pays a
graph check.

Conventions the detector assumes (``lint`` SL1xx checks them statically,
``analysis/concurrency.py``):

- a non-blocking acquire (``acquire(blocking=False)``) skips the order
  check: an acquire that cannot block cannot deadlock. That is the
  signal-context snapshot pattern (obs/flight.py, obs/metrics.py);
- acquiring a lock *named the same* as one already held (the same instance
  included) is reported as a self-cycle: no code path of the package nests
  two locks of one store.

:func:`stale_read` is the bounded lock-free copy that the non-blocking
snapshot paths fall back on.
"""

from __future__ import annotations

import contextlib
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple


class LockOrderViolation(RuntimeError):
    """A blocking acquire would close a cycle in the acquisition-order
    graph (or re-enter a held lock name): a deadlock is possible under
    some interleaving, and this thread may be about to meet it."""


def debug_enabled() -> bool:
    """Whether ``SART_LOCK_DEBUG`` arms the detector (read on every call;
    :func:`named_lock` consults it when it creates a lock)."""
    from sartsolver_tpu_torch.utils import env_truthy

    return env_truthy("SART_LOCK_DEBUG")


# ---------------------------------------------------------------------------
# the order graph (debug mode only)
# ---------------------------------------------------------------------------

# The graph's own lock is a raw threading.Lock: instrumenting it would
# recurse, and it is only ever held for dict operations.
_graph_lock = threading.Lock()
#: name -> the names acquired while holding it (observed order edges)
_graph: Dict[str, Set[str]] = {}
#: (held name, acquired name) -> (thread name, stack text when first seen)
_edge_info: Dict[Tuple[str, str], Tuple[str, str]] = {}

_tls = threading.local()


def _held_stack() -> List[Tuple["_InstrumentedLock", float, int]]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _in_guard() -> bool:
    """True while this thread is inside the detector's own bookkeeping (the
    hold histogram, the flight event): instrumented locks acquired there
    behave raw, which breaks the recursion (observing a hold time takes the
    histogram's lock, whose release would observe a hold time ...)."""
    return getattr(_tls, "guard", False)


@contextlib.contextmanager
def suppress_instrumentation():
    """Run a block with the detector's bookkeeping off on this thread:
    instrumented locks acquire raw, and releases observe no hold time.

    A signal handler (the status snapshot, the crash bundle) takes only
    non-blocking acquires, but under ``SART_LOCK_DEBUG=1`` each release
    would record its hold time through a blocking registry acquire and
    bring back the self-deadlock the non-blocking contract rules out. The
    handler wraps itself in this guard instead. Guard-mode acquires push
    nothing on the hold stack, so their releases pop nothing and the
    interrupted frame's bookkeeping stays as it was."""
    prev = getattr(_tls, "guard", False)
    _tls.guard = True
    try:
        yield
    finally:
        _tls.guard = prev


def order_graph() -> Dict[str, Set[str]]:
    """A copy of the acquisition-order graph."""
    with _graph_lock:
        return {name: set(succ) for name, succ in _graph.items()}


def reset_order_state() -> None:
    """Drop every recorded edge (the hold stacks are per thread and left
    alone)."""
    with _graph_lock:
        _graph.clear()
        _edge_info.clear()


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """A path ``src -> ... -> dst`` in the edge graph, or None. The caller
    holds ``_graph_lock``. Iterative depth-first search: the graph is one
    node per lock name, but the depth must not depend on the drill."""
    if src == dst:
        return [src]
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _graph.get(node, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class _InstrumentedLock:
    """Debug-mode lock: order tracking and hold-time accounting around a
    raw ``threading.Lock``, with the part of its interface the package
    uses (``acquire``, ``release``, ``locked``, the context manager)."""

    def __init__(self, name: str):
        self.name = str(name)
        self._raw = threading.Lock()
        # release generation, bumped on every release. A hold-stack entry
        # records the generation it was acquired under; a release from
        # another thread (legal for threading.Lock) cannot reach the
        # acquirer's thread-local stack, and its entry would otherwise
        # linger and make up order edges and self-cycles. Entries whose
        # generation no longer matches are dropped lazily.
        self._gen = 0

    def _check_order(self, held) -> None:
        """Raise :class:`LockOrderViolation` where blocking on this lock
        could deadlock given the edges seen so far; else record the new
        ``held -> self`` edges. Runs before the acquire."""
        held[:] = [e for e in held if e[2] == e[0]._gen]
        for lock, _t0, _gen in held:
            if lock.name == self.name:
                self._violate(
                    held, [self.name, self.name],
                    "re-acquiring a lock name already held by this thread "
                    "(self-deadlock for the same instance; no code path of "
                    "the package nests two locks of one store)",
                )
        with _graph_lock:
            for lock, _t0, _gen in held:
                a, b = lock.name, self.name
                if b in _graph.get(a, ()):
                    continue
                back = _find_path(b, a)
                if back is not None:
                    cycle = [a] + back  # a -> b -> ... -> a
                    info = _edge_info.get((back[0], back[1])) if len(back) > 1 else None
                    self._violate(held, cycle, other=info)
                _graph.setdefault(a, set()).add(b)
                _edge_info[(a, b)] = (threading.current_thread().name,
                                      "".join(traceback.format_stack()[:-2]))

    def _violate(self, held, cycle, reason: str = "", other=None) -> None:
        names = " -> ".join(cycle)
        lines = [f"lock-order violation acquiring {self.name!r}: cycle {names}"]
        if reason:
            lines.append(reason)
        lines.append(f"this thread ({threading.current_thread().name}) holds: "
                     + (", ".join(e[0].name for e in held) or "<none>"))
        lines.append("this thread's acquire stack:\n"
                     + "".join(traceback.format_stack()[:-3]))
        if other is not None:
            other_thread, other_stack = other
            lines.append(f"conflicting order established by thread {other_thread!r} "
                         f"at:\n{other_stack}")
        msg = "\n".join(lines)
        # mirror into the flight ring (a crash bundle of a deadlock drill
        # names the cycle), under the guard so the ring's own instrumented
        # lock behaves raw here
        _tls.guard = True
        try:
            from sartsolver_tpu_torch.obs import flight

            flight.record_event("lock_order_violation",
                                message=f"cycle {names} acquiring {self.name}",
                                cycle=list(cycle), thread=threading.current_thread().name)
        except Exception:  # the report must never depend on the ring
            pass
        finally:
            _tls.guard = False
        raise LockOrderViolation(msg)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _in_guard():
            return self._raw.acquire(blocking, timeout)
        held = _held_stack()
        if blocking:
            # a non-blocking acquire cannot deadlock: the signal-context
            # snapshots rely on that and must not trip the detector
            self._check_order(held)
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            held.append((self, time.monotonic(), self._gen))
        return ok

    def release(self) -> None:
        held = _held_stack()
        t0 = None
        for i in range(len(held) - 1, -1, -1):
            lock, when, gen = held[i]
            if lock is self and gen == self._gen:
                t0 = when
                del held[i]
                break
        # bumped before the raw release: the next acquirer stamps its entry
        # with the new generation, and an entry left on another thread's
        # stack (a handoff released here) goes stale
        self._gen += 1
        self._raw.release()
        if t0 is not None and not _in_guard():
            self._record_hold(time.monotonic() - t0)

    def _record_hold(self, dt: float) -> None:
        _tls.guard = True
        try:
            from sartsolver_tpu_torch.obs import metrics

            metrics.get_registry().histogram("lock_hold_seconds", lock=self.name).observe(dt)
        except Exception:  # accounting must never hurt the run
            pass
        finally:
            _tls.guard = False

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<_InstrumentedLock {self.name!r} locked={self.locked()}>"


def named_lock(name: str):
    """A lock for the site ``name`` (dotted, e.g. ``obs.metrics.registry``).

    ``SART_LOCK_DEBUG`` unset: a plain ``threading.Lock``, nothing recorded.
    Set: an :class:`_InstrumentedLock` wired into the acquisition-order
    graph. The mode latches when the lock is made."""
    if debug_enabled():
        return _InstrumentedLock(name)
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
