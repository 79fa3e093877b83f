"""Deterministic fault-injection registry.

Counterpart of ``sartsolver_tpu/resilience/faults.py`` for the sites the
port arms. Every recovery path of the I/O pipeline is guarded by a *named
site*: a point in production code that consults this registry and, only
when a fault is armed for it, raises or corrupts data. With nothing armed a
site costs one dict lookup on a cold path; the solver's loops hold no site.

Arming faults:

- Environment: ``SART_FAULT=site:kind:prob[:count][,site:kind:prob...]``,
  parsed once on first use (:func:`reset` re-reads it). ``prob`` is the
  per-encounter trip probability, drawn from a per-site generator seeded by
  ``SART_FAULT_SEED`` (default 0) and the site's CRC32 — the JAX package's
  seeds, so one spec trips the same encounters in either package and in
  every run. ``count`` caps the trips (default unlimited): ``prob=1`` with
  a count fails exactly the first N encounters. A spec naming a site twice,
  an unknown site or kind, or a malformed number raises ``ValueError``.
- Programmatic: :func:`inject` / :func:`clear_faults`, or the
  :func:`injected` context manager.

Kinds:

- ``io``: the site raises :class:`InjectedIOError` (an ``OSError``): a torn
  read or write.
- ``error``: :class:`InjectedFault` (a ``RuntimeError``): a non-I/O
  failure of the runtime.
- ``nan``: a data site (:func:`corrupt`) gets its array NaN-poisoned;
  raising sites ignore it.
- ``corrupt``: a data site gets element 0 scaled by 256 and offset by 1
  (dtype kept): a finite change no NaN check sees. ``device.buffer``
  probes :func:`take_corrupt` and perturbs the resident matrix itself
  (``parallel/sharded.py``: an exponent bit of a float element flipped,
  an int8 code reflected); only the integrity layer (``--integrity``)
  detects it.
- ``oom``: :class:`InjectedOOM`, whose message carries the allocator's
  "out of memory" and XLA's ``RESOURCE_EXHAUSTED``: the OOM ladder
  (``resilience/degrade.py:is_resource_exhausted``) takes it for a device
  out-of-memory and halves as it does for ``torch.cuda.OutOfMemoryError``.
- ``hang``: the site sleeps in short steps until the hang watchdog
  (``resilience/watchdog.py``) interrupts it with an asynchronous
  ``WatchdogTimeout``, or until ``SART_HANG_RELEASE`` seconds (default 300)
  pass; it then raises :class:`InjectedFault`, so a drill without a
  watchdog fails instead of hanging.

Sites (``FAULT_SITES``): ``hdf5.frame_read`` (``io/image.py``, the
composite frame cache fill), ``hdf5.rtm_ingest`` (``parallel/multihost.py``,
one RTM row chunk), ``prefetch.next`` (``utils/prefetch.py``, one frame of
the worker), ``device.put`` (``parallel/sharded.py``, a frame group's
staging), ``solve.dispatch`` (``parallel/sharded.py``, a solve's entry),
``device.buffer`` (``parallel/sharded.py``, the resident matrix, probed at
each solve's entry), ``io.flush`` (``io/solution.py``, a flush of the
solution file) and ``solve.checkpoint`` (``resilience/podckpt.py``, the
append of an in-solve checkpoint record).
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Dict, Optional

import numpy as np

from sartsolver_tpu_torch.utils.locking import named_lock


def site_seed(site: str) -> int:
    """Stable per-site seed component (CRC32: ``hash(str)`` is salted per
    process, which would move a prob < 1 fault's trips from run to run)."""
    return zlib.crc32(site.encode())


SITE_FRAME_READ = "hdf5.frame_read"  # io/image.py: composite frame ingest
SITE_RTM_INGEST = "hdf5.rtm_ingest"  # parallel/multihost.py: RTM chunk read
SITE_PREFETCH = "prefetch.next"      # utils/prefetch.py: worker loop
SITE_DEVICE_PUT = "device.put"       # parallel/sharded.py: frame staging
SITE_SOLVE = "solve.dispatch"        # parallel/sharded.py: solve entry
SITE_FLUSH = "io.flush"              # io/solution.py: output flush
SITE_DEVICE_BUFFER = "device.buffer"  # parallel/sharded.py: resident RTM rot
SITE_SOLVE_CHECKPOINT = "solve.checkpoint"  # resilience/podckpt.py: ckpt append

FAULT_SITES = frozenset({
    SITE_FRAME_READ, SITE_RTM_INGEST, SITE_PREFETCH, SITE_DEVICE_PUT,
    SITE_SOLVE, SITE_FLUSH, SITE_DEVICE_BUFFER, SITE_SOLVE_CHECKPOINT,
})

FAULT_KINDS = ("io", "error", "nan", "hang", "oom", "corrupt")


class InjectedIOError(OSError):
    """An injected I/O fault (kind ``io``)."""


class InjectedFault(RuntimeError):
    """An injected non-I/O fault (kind ``error``)."""


class InjectedOOM(InjectedFault):
    """An injected device out-of-memory (kind ``oom``). An
    :class:`InjectedFault`, so per-frame isolation absorbs it once the
    ladder is exhausted; its message carries the markers
    ``resilience/degrade.py:is_resource_exhausted`` matches."""


@dataclasses.dataclass
class _Fault:
    site: str
    kind: str
    prob: float
    count: Optional[int]  # max trips; None = unlimited
    trips: int = 0
    encounters: int = 0
    rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(0))

    def should_trip(self) -> bool:
        self.encounters += 1
        if self.count is not None and self.trips >= self.count:
            return False
        # a draw on every encounter, tripped or capped, so one site's trip
        # pattern never depends on another's cap
        hit = self.prob >= 1.0 or self.rng.random() < self.prob
        if hit:
            self.trips += 1
        return hit


# site -> armed fault; None until read from the environment
_faults: Optional[Dict[str, _Fault]] = None
_lock = named_lock("resilience.faults")


def parse_fault_spec(spec: str) -> Dict[str, _Fault]:
    """Parse a ``SART_FAULT`` spec into armed faults (comma-separated
    ``site:kind:prob[:count]`` entries). Raises ``ValueError`` on an unknown
    site or kind, a malformed number or a site armed twice: a fault that
    never fires because of a typo would make a drill vacuous."""
    seed = int(os.environ.get("SART_FAULT_SEED", "0"))
    out: Dict[str, _Fault] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(f"Malformed SART_FAULT entry {entry!r}; expected "
                             "site:kind:prob[:count].")
        site, kind, prob_s = parts[0], parts[1], parts[2]
        if site not in FAULT_SITES:
            raise ValueError(f"Unknown fault site {site!r}; valid: "
                             f"{', '.join(sorted(FAULT_SITES))}.")
        if kind not in FAULT_KINDS:
            raise ValueError(f"Unknown fault kind {kind!r}; valid: "
                             f"{', '.join(FAULT_KINDS)}.")
        prob = float(prob_s)
        if not (0.0 < prob <= 1.0):
            raise ValueError(f"Fault probability must be in (0, 1], got {prob}.")
        count = int(parts[3]) if len(parts) == 4 else None
        if count is not None and count < 1:
            raise ValueError(f"Fault count must be >= 1, got {count}.")
        if site in out:
            raise ValueError(f"Fault site {site!r} armed twice in one spec; a site "
                             "holds one fault (arm different sites to combine drills).")
        out[site] = _Fault(site, kind, prob, count,
                           rng=np.random.default_rng([seed, site_seed(site)]))
    return out


def _active() -> Dict[str, _Fault]:
    global _faults
    if _faults is None:
        with _lock:
            if _faults is None:
                _faults = parse_fault_spec(os.environ.get("SART_FAULT", ""))
    return _faults


def inject(site: str, kind: str = "io", prob: float = 1.0,
           count: Optional[int] = None) -> None:
    """Arm a fault programmatically (the env spec's semantics)."""
    _active().update(parse_fault_spec(
        f"{site}:{kind}:{prob}" + (f":{count}" if count is not None else "")))


def clear_faults() -> None:
    """Disarm every fault, env- and programmatically armed alike."""
    global _faults
    with _lock:
        _faults = {}


def reset() -> None:
    """Forget all state; the next use re-reads ``SART_FAULT``."""
    global _faults
    with _lock:
        _faults = None


class injected:
    """Context manager arming a fault for its scope (tests)."""

    def __init__(self, site: str, kind: str = "io", prob: float = 1.0,
                 count: Optional[int] = None):
        self._args = (site, kind, prob, count)

    def __enter__(self):
        inject(*self._args)
        return self

    def __exit__(self, *exc):
        _active().pop(self._args[0], None)


def _hang(site: str, trip: int) -> None:
    """Block in short sleeps, so the watchdog's asynchronous
    ``WatchdogTimeout`` (delivered between bytecodes, each time a sleep
    returns) interrupts it promptly; after ``SART_HANG_RELEASE`` seconds
    raise, so a drill whose watchdog is off fails instead of hanging."""
    release = float(os.environ.get("SART_HANG_RELEASE", "300"))
    deadline = time.monotonic() + release
    while time.monotonic() < deadline:
        time.sleep(0.05)
    raise InjectedFault(f"injected hang at {site} (trip {trip}) released after "
                        f"{release}s (SART_HANG_RELEASE) without a watchdog interrupt")


def fire(site: str) -> None:
    """Raise the armed exception fault for ``site``, if it trips. ``nan``
    and ``corrupt`` faults never raise (they act through :func:`corrupt`)."""
    fault = _active().get(site)
    if fault is None or fault.kind in ("nan", "corrupt"):
        return
    if fault.should_trip():
        if fault.kind == "io":
            raise InjectedIOError(f"injected I/O fault at {site} (trip {fault.trips})")
        if fault.kind == "oom":
            raise InjectedOOM(
                f"injected RESOURCE_EXHAUSTED at {site} (trip {fault.trips}): "
                "out of memory while trying to allocate the dispatch buffers")
        if fault.kind == "hang":
            _hang(site, fault.trips)
        raise InjectedFault(f"injected fault at {site} (trip {fault.trips})")


def corrupt(site: str, array: np.ndarray) -> np.ndarray:
    """``array``, corrupted if a data-kind fault trips at ``site``: the input
    itself (no copy) when none does; a ``nan`` trip returns an fp64 copy
    with element 0 NaN, a ``corrupt`` trip a copy (dtype kept) with element
    0 scaled by 256 and offset by 1."""
    fault = _active().get(site)
    if fault is None or fault.kind not in ("nan", "corrupt") or not fault.should_trip():
        return array
    if fault.kind == "nan":
        poisoned = np.array(array, dtype=np.float64, copy=True)
        poisoned.reshape(-1)[0] = np.nan
        return poisoned
    perturbed = np.array(array, copy=True)
    flat = perturbed.reshape(-1)
    flat[0] = flat[0] * 256 + 1
    return perturbed


def take_corrupt(site: str) -> bool:
    """True where a ``corrupt`` fault trips at ``site``: for sites whose
    data lies on the device and that perturb it themselves (the resident
    matrix, ``device.buffer``)."""
    fault = _active().get(site)
    if fault is None or fault.kind != "corrupt":
        return False
    return fault.should_trip()


def fault_trips() -> Dict[str, int]:
    """Trip counts per armed site (telemetry, tests)."""
    return {site: f.trips for site, f in _active().items()}
