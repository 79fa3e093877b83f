"""Metrics registry: counters, gauges, histograms (host-side, stdlib-only).

Counterpart of ``sartsolver_tpu/obs/metrics.py``, whole: the same
instruments, bucket layout, snapshot format and merge rules, so that a
snapshot of either package reads, merges and diffs against the other's.

The vocabulary is the three instrument kinds every metrics system shares,
so one registry backs the ``--timing`` phase summary
(:class:`~sartsolver_tpu_torch.utils.timing.PhaseTimer` is a view over
``phase_seconds`` histograms), the ``--metrics_out`` JSONL artifact and the
``SART_METRICS_PROM`` Prometheus textfile. :meth:`MetricsRegistry.merge_snapshot`
defines how each kind combines across processes: counters sum, gauges keep
the max, histograms merge their moments and buckets.

Instruments are identified by ``(name, labels)``; handles are cached, so a
caller looks its instrument up once and pays one lock and one float update
per event afterwards. Snapshots list instruments first-registered-first;
instruments present only in a merged snapshot are appended in name order.

Concurrency: every lock comes from
:func:`sartsolver_tpu_torch.utils.locking.named_lock`, and ``snapshot``
takes ``blocking=False`` for signal context: a handler runs between
bytecodes of the main thread, which may hold the very lock a blocking
snapshot would wait on forever. The non-blocking path falls back to a
lock-free stale read: a torn multi-field view is acceptable for a status
dump, a hang is not.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterable, List, Optional, Tuple

from sartsolver_tpu_torch.utils.locking import named_lock, stale_read

# Fixed log-spaced bucket layout shared by EVERY histogram (four buckets
# per octave over 2^-17 .. 2^17 — ~7.6e-6 to ~1.3e5, which covers
# microsecond waits through day-long totals at ±~9% resolution when the
# estimate reports the geometric bucket midpoint). The layout is a
# module constant, never per-instrument, so bucket counts merge EXACTLY
# across hosts and artifact generations — the property the moments-only
# histogram already had and quantile estimates must keep. Bucket 0 is
# the underflow bucket (values at or below 2^-17, zero included); the
# last bucket is the overflow.
BUCKETS_PER_OCTAVE = 4
_BUCKET_MIN_EXP = -17
_BUCKET_MAX_EXP = 17
N_BUCKETS = (_BUCKET_MAX_EXP - _BUCKET_MIN_EXP) * BUCKETS_PER_OCTAVE + 2

# The quantiles every histogram estimates (snapshot keys / prom suffixes
# / `sartsolve metrics` summary fields).
QUANTILES = ((0.5, "p50"), (0.95, "p95"), (0.99, "p99"))


def bucket_index(value: float) -> int:
    """The fixed-layout bucket holding ``value``."""
    lo = 2.0 ** _BUCKET_MIN_EXP
    if not value > lo:  # zero/negative/NaN land in the underflow bucket
        return 0
    if math.isinf(value):  # floor(log2(inf)) would raise OverflowError
        return N_BUCKETS - 1
    idx = 1 + int(math.floor(
        (math.log2(value) - _BUCKET_MIN_EXP) * BUCKETS_PER_OCTAVE
    ))
    return min(max(idx, 1), N_BUCKETS - 1)


def bucket_upper(index: int) -> float:
    """Upper bound of bucket ``index`` (inf for the overflow bucket)."""
    if index >= N_BUCKETS - 1:
        return math.inf
    return 2.0 ** (_BUCKET_MIN_EXP + index / BUCKETS_PER_OCTAVE)


def bucket_mid(index: int) -> float:
    """Geometric midpoint of bucket ``index`` — the reported quantile
    estimate (halves the systematic overestimate of the upper bound;
    the overflow bucket has no midpoint and reports its lower bound)."""
    if index >= N_BUCKETS - 1:
        return bucket_upper(N_BUCKETS - 2)
    if index <= 0:
        return bucket_upper(0)
    return 2.0 ** (_BUCKET_MIN_EXP
                   + (index - 0.5) / BUCKETS_PER_OCTAVE)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    kind = "instrument"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = {str(k): str(v) for k, v in labels.items()}
        self._lock = named_lock("obs.metrics.instrument")

    def snapshot(self, blocking: bool = True) -> dict:
        """Instrument state as a JSON-serializable dict. With
        ``blocking=False`` (signal context) a held lock degrades to a
        lock-free stale read instead of a self-deadlock."""
        if self._lock.acquire(blocking=blocking):
            try:
                return self._snapshot_locked()
            finally:
                self._lock.release()
        # stale fallback: field reads are GIL-atomic; a torn multi-field
        # view only mis-states a histogram by one in-flight observation
        return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        raise NotImplementedError

    def merge(self, snap: dict) -> None:
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonically increasing count (events, bytes, frames)."""

    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, str]):
        super().__init__(name, labels)
        self.value = 0.0  # guarded by: self._lock

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("Counters only go up; use a Gauge.")
        with self._lock:
            self.value += amount

    def _snapshot_locked(self) -> dict:
        return {"kind": self.kind, "name": self.name, "labels": self.labels,
                "value": self.value}

    def merge(self, snap: dict) -> None:
        with self._lock:
            self.value += float(snap["value"])


class Gauge(_Instrument):
    """Last-set value (queue depths, ladder level)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, str]):
        super().__init__(name, labels)
        self.value = 0.0  # guarded by: self._lock

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def set_max(self, value: float) -> None:
        """High-water-mark update (queue-depth peaks): only raises the
        gauge. Submit-side-only ``set`` calls would leave the last
        enqueue's depth as the reported value — arbitrary, not the
        peak."""
        value = float(value)
        with self._lock:
            if value > self.value:
                self.value = value

    def _snapshot_locked(self) -> dict:
        return {"kind": self.kind, "name": self.name, "labels": self.labels,
                "value": self.value}

    def merge(self, snap: dict) -> None:
        # cross-host combine: the max is the conservative headline for
        # every gauge this package exports (deepest queue, highest ladder)
        with self._lock:
            self.value = max(self.value, float(snap["value"]))


class Histogram(_Instrument):
    """Distribution summary: count / sum / min / max + fixed buckets.

    Moments merge exactly across hosts, and so do the bucket counts —
    the bucket layout is the module-level constant above, never
    per-instrument, so fleet-wide agreement is structural. Quantiles
    (p50/p95/p99) are *estimates* derived from the buckets at snapshot
    time: the reported value is the holding bucket's geometric midpoint
    clamped into the observed [min, max] range (±~9% at four buckets
    per octave) — good enough for an SLO gate, exact at the extremes.
    """

    kind = "histogram"

    def __init__(self, name: str, labels: Dict[str, str]):
        super().__init__(name, labels)
        self.count = 0  # guarded by: self._lock
        self.sum = 0.0  # guarded by: self._lock
        self.min: Optional[float] = None  # guarded by: self._lock
        self.max: Optional[float] = None  # guarded by: self._lock
        # sparse fixed-layout bucket counts: index -> count
        self.buckets: Dict[int, int] = {}  # guarded by: self._lock

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bucket_index(value)
        with self._lock:
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def _buckets_copy(self) -> Dict[int, int]:
        # safe under the lock AND on the lock-free stale fallback
        # (signal context / the /metrics scrape): copying a dict that a
        # concurrent observe() is inserting into raises RuntimeError,
        # which must degrade to a bounded-retry stale read, never
        # propagate out of a status poke (utils/locking.stale_read —
        # the one stale-fallback convention)
        return stale_read(lambda: dict(self.buckets), default={})

    def _quantile_locked(self, q: float, buckets: Dict[int, int]
                         ) -> Optional[float]:
        # target mass is the BUCKETED count, not self.count: a merge
        # from a pre-bucket artifact generation raises count without
        # bucket mass, and scaling the target to it would push every
        # estimate to the max — estimate from the bucketed subsample
        total = sum(buckets.values())
        if not total:
            return None
        target = q * total
        cum = 0
        value = self.max
        for idx in sorted(buckets):
            cum += buckets[idx]
            if cum >= target:
                if idx >= N_BUCKETS - 1:
                    value = self.max  # overflow: only the max is known
                elif idx <= 0:
                    value = self.min  # underflow: only the min is known
                else:
                    value = bucket_mid(idx)
                break
        if self.min is not None and value is not None:
            value = max(value, self.min)
        if self.max is not None and value is not None:
            value = min(value, self.max)
        return value

    def _snapshot_locked(self) -> dict:
        # also runs WITHOUT the lock as the stale fallback of
        # _Instrument.snapshot(blocking=False): the bucket dict is the
        # one multi-element structure here, so it is copied through the
        # stale-read convention rather than iterated live
        buckets = self._buckets_copy()
        snap = {"kind": self.kind, "name": self.name,
                "labels": self.labels, "count": self.count,
                "sum": self.sum, "min": self.min, "max": self.max,
                "buckets": {str(k): v
                            for k, v in sorted(buckets.items())}}
        for q, key in QUANTILES:
            snap[key] = self._quantile_locked(q, buckets)
        return snap

    def merge(self, snap: dict) -> None:
        with self._lock:
            self.count += int(snap["count"])
            self.sum += float(snap["sum"])
            for attr, pick in (("min", min), ("max", max)):
                theirs = snap.get(attr)
                if theirs is None:
                    continue
                mine = getattr(self, attr)
                setattr(self, attr,
                        theirs if mine is None else pick(mine, theirs))
            # fixed layout -> bucket counts sum exactly; snapshots from
            # a pre-bucket artifact generation simply contribute none
            for key, n in (snap.get("buckets") or {}).items():
                idx = int(key)
                self.buckets[idx] = self.buckets.get(idx, 0) + int(n)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe, insertion-ordered instrument store."""

    def __init__(self, default_labels: Optional[Dict[str, str]] = None
                 ) -> None:
        self._lock = named_lock("obs.metrics.registry")
        # dict preserves insertion order — the snapshot/summary ordering
        self._instruments: Dict[Tuple[str, str, tuple], _Instrument] = {}  # guarded by: self._lock
        # folded into EVERY instrument's labels (explicit labels win):
        # fleet workers get their worker= identity here so one scrape of
        # merged worker registries stays attributable per shard
        self._default_labels = {str(k): str(v)
                                for k, v in (default_labels or {}).items()}

    def _get(self, cls, name: str, labels: Dict[str, str]) -> _Instrument:
        if self._default_labels:
            labels = {**self._default_labels, **labels}
        key = (cls.kind, name, _label_key(labels))
        # double-checked fast path: a dict get is GIL-atomic, and a miss
        # re-checks under the lock before inserting
        inst = self._instruments.get(key)  # sart-lint: disable=SL101
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = cls(name, labels)
                    self._instruments[key] = inst
        elif not isinstance(inst, cls):  # pragma: no cover - keyed by kind
            raise TypeError(
                f"{name} already registered as {inst.kind}, not {cls.kind}"
            )
        return inst

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self, blocking: bool = True) -> List[dict]:
        """Instrument states in registration order (JSON-serializable).

        ``blocking=False`` is the signal-context form (SIGUSR1 status
        handler, crash bundles): a registry or instrument lock held by
        the interrupted frame must degrade to a stale read, never a
        self-deadlock (the lock's owner cannot run until this handler
        returns)."""
        if self._lock.acquire(blocking=blocking):
            try:
                instruments = list(self._instruments.values())
            finally:
                self._lock.release()
        else:
            instruments = self._instruments_stale()
        return [inst.snapshot(blocking=blocking) for inst in instruments]

    def _instruments_stale(self) -> List[_Instrument]:
        # lock-free listing for signal context (the one stale-fallback
        # convention: utils/locking.stale_read)
        return stale_read(
            lambda: list(self._instruments.values()),
            default=[],
        )

    def merge_snapshot(self, snapshot: Iterable[dict]) -> None:
        """Fold another registry's snapshot into this one (multi-host
        aggregation): counters sum, gauges max, histograms merge moments.
        Instruments unknown locally are appended — in name order, after
        every locally-registered one (insertion-then-name)."""
        foreign = [dict(s) for s in snapshot]
        foreign.sort(key=lambda s: (s["name"], _label_key(s["labels"])))
        for snap in foreign:
            cls = _KINDS[snap["kind"]]
            inst = self._get(cls, snap["name"], snap["labels"])
            if inst.kind == "gauge" and inst.value == 0:
                # merging into a never-set gauge: adopt the value (the
                # max-combine would clamp negatives at the fresh 0);
                # counter/histogram merges into a fresh instrument are
                # already identity operations
                inst.set(float(snap["value"]))
            else:
                inst.merge(snap)


def _env_default_labels() -> Dict[str, str]:
    """Fleet worker identity: ``SART_WORKER_ID`` (set by the fleet
    controller on each spawned worker) labels every instrument with
    ``worker=`` so per-worker series stay distinguishable when scraped
    or folded fleet-wide. Unset (standalone serve, tests, bench
    baselines) adds nothing — series names stay byte-stable."""
    worker = os.environ.get("SART_WORKER_ID")
    return {"worker": worker} if worker else {}


# Process-wide default registry. The CLI resets it at the start of every
# run so artifacts account one run, not the process lifetime; library
# modules grab handles from it lazily.
_default = MetricsRegistry(default_labels=_env_default_labels())
_default_lock = named_lock("obs.metrics.default")


def get_registry() -> MetricsRegistry:
    return _default


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh default registry (per-run accounting) and return
    it. Handles cached from the old registry keep working — they just
    accumulate into an object nothing reads anymore — so a reset can
    never corrupt a concurrent writer; per-run components cache their
    handles after the CLI's reset."""
    global _default
    with _default_lock:
        _default = MetricsRegistry(default_labels=_env_default_labels())
    return _default
