"""Graceful preemption shutdown: SIGTERM/SIGINT -> stop flag -> exit 4.

On a shared accelerator pool the dominant "failure" is not a fault at all
but *preemption*: the scheduler sends SIGTERM and expects the process
gone within a deadline (SIGKILL follows). The reference binary dies
mid-write and leaves whatever the incremental flush happened to commit;
this module turns the same signal into a clean, resumable stop:

- The first SIGTERM/SIGINT sets a **stop-request flag** (and nothing
  else — the handler is async-signal-lean: one assignment plus a stderr
  note). The CLI frame loop polls :func:`stop_requested` at frame-group
  boundaries, drains the in-flight group and the async writer, flushes
  the solution file, prints the resilience summary, and exits with the
  documented ``EXIT_INTERRUPTED = 4`` — the output file is resumable
  with ``--resume``.
- A **second** signal aborts immediately: the handler restores the
  default disposition and re-raises the signal at the process, so it
  dies with the conventional ``128 + N`` status and no further draining
  (the solution file stays crash-consistent — the killdrill model).

Counterpart of ``sartsolver_tpu/resilience/shutdown.py`` for one
process: the multi-process agreement on the stop boundary comes with the
multi-GPU slice.

Handlers are installed by the CLI (``install``/``uninstall``; no-ops off
the main thread, where Python forbids ``signal.signal``). Library users
embedding the solver keep full control: nothing here runs at import.
"""

from __future__ import annotations

import signal
import sys
import threading
from typing import Dict, Optional

_HANDLED = (signal.SIGTERM, signal.SIGINT)

_state = {
    "stop": False,
    "signame": None,  # name of the first signal received
    "installed": False,
}
_previous: Dict[int, object] = {}


def stop_requested() -> bool:
    """True once a stop signal arrived (cheap enough to poll per frame)."""
    return _state["stop"]


def stop_signal() -> Optional[str]:
    """Name of the first stop signal received (``'SIGTERM'``), or None."""
    return _state["signame"]


def reset() -> None:
    """Clear the stop flag (a fresh run in the same process)."""
    _state["stop"] = False
    _state["signame"] = None


def _handler(signum, frame) -> None:
    name = signal.Signals(signum).name
    if _state["stop"]:
        # second signal: immediate abort — die by the signal so the
        # parent sees the conventional status, with no draining (the
        # incremental flush keeps the file crash-consistent)
        sys.stderr.write(
            f"sartsolve: second {name} — aborting immediately\n"
        )
        sys.stderr.flush()
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)
        return
    _state["stop"] = True
    _state["signame"] = name
    sys.stderr.write(
        f"sartsolve: received {name} — stopping at the next frame-group "
        "boundary (drain, flush, exit 4; file resumable with --resume). "
        "Send again to abort immediately.\n"
    )
    sys.stderr.flush()


def install() -> bool:
    """Install the graceful handlers; returns True when installed.

    Resets the stop flag (repeated in-process runs — tests — start
    clean). A no-op returning False off the main thread or when already
    installed."""
    reset()
    if _state["installed"]:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    for sig in _HANDLED:
        _previous[sig] = signal.signal(sig, _handler)
    _state["installed"] = True
    return True


def uninstall() -> None:
    """Restore the previous handlers (idempotent)."""
    if not _state["installed"]:
        return
    for sig, prev in _previous.items():
        try:
            signal.signal(sig, prev)
        except (ValueError, TypeError):  # pragma: no cover - teardown race
            pass
    _previous.clear()
    _state["installed"] = False


class installed:
    """Context manager pairing :func:`install`/:func:`uninstall`."""

    def __enter__(self) -> "installed":
        install()
        return self

    def __exit__(self, *exc) -> None:
        uninstall()
