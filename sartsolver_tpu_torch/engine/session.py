"""Resident session: solver + geometry held in memory across requests.

Counterpart of ``sartsolver_tpu/engine/session.py``. The one-shot CLI's
cold path (validate -> ingest -> build the solver) runs ONCE, at ``serve``
startup, through the same two functions the CLI's run calls
(``cli.py:index_inputs`` and ``cli.py:build_solver``), so a served request
solves with the CLI's solver, plan and reduction order. Every request
afterwards only selects frames out of the already-indexed image files and
solves them on the resident solver's lanes. One device only: the grid of
ranks' lockstep is exactly what a per-request service cannot promise.

The device is the CLI's: ``--use_cpu`` is the fp64 parity profile on the
CPU, ``--device cpu`` the fp32 profile through the kernels' plain versions,
and otherwise the session runs on ``cuda`` and fails where there is none.
On the card the solver loads the fused sweep's library (building it if
needed) while it is built, and ``serve`` runs one discarded stride at its
lanes (:meth:`ResidentSession.warm_up`), so the build and the first
launches are paid before the server says ready, never by the first request.

Requests are solved with independent frames (the continuous batcher's
lanes carry no cross-frame warm state), which is what makes crash replay
byte-identical: re-running an interrupted request from its journaled
payload reproduces the exact output bytes of an uninterrupted run, whatever
order or lane assignment the scheduler picks.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from sartsolver_tpu_torch.config import parse_time_intervals
from sartsolver_tpu_torch.engine.request import Request
from sartsolver_tpu_torch.resilience import faults
from sartsolver_tpu_torch.resilience.failures import FrameFailure


def _held_storage(obj, seen: dict, depth: int = 0) -> None:
    """Collect the distinct device storages ``obj`` references (tensors in
    NamedTuples, containers and plain objects, a few levels deep) into
    ``seen`` (storage pointer -> bytes)."""
    import torch

    if depth > 4 or obj is None:
        return
    if isinstance(obj, torch.Tensor):
        store = obj.untyped_storage()
        seen[(obj.device.type, store.data_ptr())] = store.nbytes()
        return
    if isinstance(obj, (str, bytes, int, float, bool, np.ndarray)):
        return
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (tuple, list)):
        items = obj
    elif hasattr(obj, "__dict__"):
        items = vars(obj).values()
    else:
        return
    for item in items:
        _held_storage(item, seen, depth + 1)


class ResidentSession:
    """The warm state one serve process holds for its lifetime."""

    def __init__(self, *, solver, grid, opts, camera_names: List[str],
                 sorted_image_files, rtm_frame_masks, npixel: int, nvoxel: int,
                 max_cached_frames: int = 100, operator: str = "dense",
                 device=None):
        self.solver = solver
        self.grid = grid
        self.opts = opts
        self.camera_names = camera_names
        self.sorted_image_files = sorted_image_files
        self.rtm_frame_masks = rtm_frame_masks
        self.npixel = int(npixel)
        self.nvoxel = int(nvoxel)
        self.max_cached_frames = int(max_cached_frames)
        # the operator's kind: "dense", "tileskip", "lowrank" or "implicit"
        self.operator = operator
        self.device = device
        # seconds of the build by part (:meth:`build`): the CUDA context,
        # the kernel libraries' load, the rest (the ingest and the solver)
        self.build_split = {}

    # ---- construction ----------------------------------------------------

    @classmethod
    def build(cls, args, geometry=None) -> "ResidentSession":
        """Build the session from a parsed solve-flag namespace: the CLI's
        pre-flight gate, ingest and solver construction, minus the frame
        loop. ``geometry`` (a validated record dict or ``GeometryRecord``)
        replaces the matrix files with the matrix-free implicit operator
        (the per-request attach route); ``args.geometry`` (``--geometry
        FILE``) does the same for the whole process."""
        from sartsolver_tpu_torch.cli import build_solver, index_inputs
        from sartsolver_tpu_torch.config import SartInputError
        from sartsolver_tpu_torch.device import resolve_device
        from sartsolver_tpu_torch.resilience.failures import RunSummary

        record = None
        if geometry is not None:
            from sartsolver_tpu_torch.operators.geometry import (
                GeometryRecord, parse_geometry,
            )

            record = (geometry if isinstance(geometry, GeometryRecord)
                      else parse_geometry(geometry))
            if getattr(args, "laplacian_file", None):
                raise SartInputError(
                    "beta_laplace smoothing is not supported by the "
                    "implicit (matrix-free) operator; drop --laplacian_file "
                    "or materialize the matrix.")
        from sartsolver_tpu_torch.ops import _build

        t0 = time.perf_counter()
        try:
            device = resolve_device("cpu" if args.use_cpu else args.device)
        except RuntimeError as err:
            raise SartInputError(str(err)) from None
        if device.type == "cuda":
            # the CUDA context before the ingest's first upload, so that its
            # cost is told apart from the ingest's
            import torch

            torch.zeros(1, device=device)
            torch.cuda.synchronize(device)
        t_context = time.perf_counter()
        loaded = dict(_build.load_seconds)
        inputs = index_inputs(args, geometry_record=record)
        setup = build_solver(args, inputs, device, summary=RunSummary(), on_event=print)
        kernel_load = sum(v for k, v in _build.load_seconds.items() if k not in loaded)
        solver = setup.solver
        operator = solver.operator_kind
        if operator == "dense" and setup.tile_occupancy is not None:
            operator = "tileskip"
        session = cls(
            solver=solver, grid=setup.grid, opts=setup.opts,
            camera_names=list(inputs.camera_names),
            sorted_image_files=inputs.sorted_image_files,
            rtm_frame_masks=inputs.rtm_frame_masks,
            npixel=inputs.npixel, nvoxel=inputs.nvoxel,
            max_cached_frames=args.max_cached_frames, operator=operator,
            device=device,
        )
        session.build_split = dict(
            cuda_init_s=t_context - t0, kernel_load_s=kernel_load,
            ingest_s=time.perf_counter() - t_context - kernel_load)
        print(
            f"engine: session resident — mesh={'x'.join(map(str, setup.ranks.shape))} "
            f"device={device} operator={operator} rtm_dtype={setup.storage} "
            f"compute={setup.opts.dtype} npixel={inputs.npixel} "
            f"nvoxel={inputs.nvoxel} resident_bytes={session.nbytes()}",
            flush=True,
        )
        return session

    # ---- accounting ------------------------------------------------------

    def nbytes(self) -> int:
        """The device storage the session holds: the stored matrix (its
        whole ingest buffer where a block-sparse matrix was compacted in
        place), its scales, the ray stats, the Laplacian, the factors or
        the implicit operator's ray table. 0 once closed."""
        problem = getattr(self.solver, "problem", None)
        if problem is None:
            return 0
        seen: dict = {}
        _held_storage(problem, seen)
        return int(sum(seen.values()))

    # ---- per-request attachment ------------------------------------------

    def attach(self, request: Request):
        """Bind a request to the resident geometry: index its composite
        frames out of the already-opened image files.

        Named fault site ``session.attach``: an armed fault models a
        torn frame-index read / a request whose selection cannot be
        served — the request FAILS (and counts toward its tenant's
        quarantine streak) while the session and every other request
        keep running. Returns a :class:`CompositeImage` over the
        request's time range."""
        faults.fire(faults.SITE_SESSION_ATTACH)
        from sartsolver_tpu_torch.io.image import CompositeImage

        intervals = parse_time_intervals(request.time_range)
        return CompositeImage(
            self.sorted_image_files, self.rtm_frame_masks, intervals,
            self.npixel, max_cache_size=self.max_cached_frames,
        )

    def frame_items(
        self, image, deadline: Optional[float],
        trace_id: Optional[str] = None,
    ) -> Iterator[Tuple]:
        """The request's scheduler-stream items: ``(frame, time,
        camera_times, deadline, trace_id)`` tuples (``deadline`` is the
        absolute ``time.monotonic()`` budget the lane sweep sheds
        against, or None; ``trace_id`` routes the scheduler's per-stride
        spans onto the request's trace track). Frame reads retry under
        the shared policy first (the CLI prefetcher's contract — a
        transient NFS blip costs one backoff, not the frame); a
        *permanent* failure degrades to an ordered
        :class:`FrameFailure` item — per-frame isolation, like the
        CLI's prefetcher."""
        from sartsolver_tpu_torch.resilience.retry import retry_call

        for i in range(len(image)):
            try:
                frame = retry_call(
                    lambda i=i: image.frame(i),
                    site=faults.SITE_FRAME_READ, retry_on=(OSError,),
                )
                ftime = image.frame_time(i)
                cam_times = image.camera_frame_time(i)
            except Exception as err:  # noqa: BLE001 - isolate frame reads
                try:
                    ftime = image.frame_time(i)
                    cam_times = image.camera_frame_time(i)
                except Exception:
                    ftime, cam_times = float("nan"), []
                yield FrameFailure(None, ftime, cam_times, err)
                continue
            yield (np.asarray(frame), ftime, cam_times, deadline, trace_id)

    def warm_up(self, lanes: int) -> float:
        """One stride of the resident solver at ``lanes`` lanes on a flat
        frame, its result discarded: the kernels' first launches (module
        loads, the sweep's scratch at B = ``lanes``) are paid here, before
        the server says ready, and not by the first request. Fresh lanes,
        so no request's solve sees it; the batcher and its metrics are not
        touched. Returns its seconds."""
        import time

        import torch

        t0 = time.perf_counter()
        lane_state = self.solver.sched_lanes(lanes)
        flat = np.ones(self.npixel)
        self.solver.sched_step(lane_state, [(b, flat) for b in range(lanes)])
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def n_frames(self, image) -> int:
        return len(image)

    def close(self) -> None:
        """Let go of every device reference the session holds (the solver's
        problem, its lanes and sweep scratch go with it) and return the
        cached blocks to the card, so an eviction really frees memory."""
        close = getattr(self.solver, "close", None)
        if close is not None:
            close()
        self.solver = None
        if self.device is not None and self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# multi-session residency
# ---------------------------------------------------------------------------


def session_key(npixel: int, nvoxel: int, dtype, mesh_shape) -> str:
    """The cache key of a dense session: two sessions share one entry
    exactly when shapes, dtype and mesh shape agree."""
    mesh = "x".join(str(int(m)) for m in (mesh_shape or ()))
    return f"{int(npixel)}x{int(nvoxel)}:{dtype}:{mesh or '-'}"


def session_nbytes(session) -> int:
    """Resident footprint. Precedence: an explicit ``nbytes`` attribute
    (the resident session's count of the device storage it holds; test
    stubs pin their own number) -> the dense RTM estimate
    ``npixel * nvoxel * itemsize``."""
    explicit = getattr(session, "nbytes", None)
    if explicit is not None:
        return int(explicit() if callable(explicit) else explicit)
    opts = getattr(session, "opts", None)
    try:
        item = np.dtype(
            getattr(opts, "rtm_dtype", None) or getattr(opts, "dtype", None)
        ).itemsize
    except TypeError:
        item = 4
    return int(session.npixel) * int(session.nvoxel) * int(item)


class SessionCache:
    """Byte-budgeted LRU of warm :class:`ResidentSession` entries.

    One worker serves a tenant population: each distinct key holds at most
    one warm ``(matrix, solver)`` entry. ``SART_SESSION_BYTES`` bounds the
    resident total; building past the budget evicts least-recently-attached
    entries (closing their solvers, which frees their device memory) until
    the new entry fits. A rebuilt entry with a previously-seen key is
    counted in ``session_cache_compile_reuse_total`` (the JAX counter's
    name: the port's kernels are built once a process, whatever the key).

    Counters (deliberately NOT ``engine_``-prefixed: cache state dies
    with the process, so the metrics must reset with the cold cache
    instead of riding the state checkpoint):
    ``session_cache_{hits,misses,evictions}_total`` and the
    ``session_resident_bytes`` gauge.

    ``SART_TEST_EVICT_EVERY=N`` (test hook) force-evicts the target
    entry every Nth attach, making every Nth request pay a full
    rebuild — byte-identity of the solutions across that churn is the
    eviction-correctness drill's whole assertion.
    """

    DEFAULT_BYTES = 2 * 2**30

    def __init__(self, builder: Callable[[str], "ResidentSession"], *,
                 byte_budget: Optional[int] = None,
                 key_for: Optional[Callable] = None,
                 on_event: Optional[Callable] = None):
        self._builder = builder
        if byte_budget is None:
            byte_budget = int(
                os.environ.get("SART_SESSION_BYTES")
                or self.DEFAULT_BYTES)
        self.byte_budget = int(byte_budget)
        self._key_for = key_for
        self._on_event = on_event
        self._entries: "OrderedDict[str, object]" = OrderedDict()
        self._built_keys: set = set()
        self._attaches = 0
        self._evict_every = int(
            os.environ.get("SART_TEST_EVICT_EVERY") or 0)

    # ---- bookkeeping -----------------------------------------------------

    def _registry(self):
        from sartsolver_tpu_torch.obs import metrics as obs_metrics

        return obs_metrics.get_registry()

    def _emit(self, kind: str, **data) -> None:
        if self._on_event is not None:
            self._on_event(kind, **data)

    def _update_gauge(self) -> None:
        self._registry().gauge("session_resident_bytes").set(
            float(self.resident_bytes()))

    def resident_bytes(self) -> int:
        return sum(session_nbytes(s) for s in self._entries.values())

    def keys(self) -> List[str]:
        return list(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    # ---- the cache proper ------------------------------------------------

    def key_for(self, request: Request) -> str:
        """The request's session key. With one RTM resident per worker
        (the serve CLI today) every tenant maps to the default key; a
        ``key_for`` hook routes requests onto their own sessions."""
        if self._key_for is not None:
            return str(self._key_for(request))
        return "default"

    def get(self, key: str = "default"):
        """The keyed warm session, building (and budget-evicting) on a
        miss. LRU order is attach order — ``get`` touches."""
        reg = self._registry()
        sess = self._entries.get(key)
        if sess is not None:
            reg.counter("session_cache_hits_total").inc()
            self._entries.move_to_end(key)
            return sess
        reg.counter("session_cache_misses_total").inc()
        if key in self._built_keys:
            reg.counter("session_cache_compile_reuse_total").inc()
        sess = self._builder(key)
        self._entries[key] = sess
        self._built_keys.add(key)
        self._emit("session-attach", key=key,
                   bytes=session_nbytes(sess))
        self._shrink_to_budget(protect=key)
        self._update_gauge()
        return sess

    def seed(self, key: str, session) -> None:
        """Pre-warm an entry built OUTSIDE the cache: serve startup
        builds the default session eagerly so flag/input errors surface
        before the first request ever arrives."""
        self._entries[key] = session
        self._built_keys.add(key)
        self._update_gauge()

    def lease(self, request: Request):
        """Per-request entry point: resolve the request's session,
        honoring the forced-eviction test hook."""
        self._attaches += 1
        key = self.key_for(request)
        if self._evict_every and self._attaches % self._evict_every == 0:
            self.evict(key, reason="test-forced")
        return self.get(key)

    def evict(self, key: str, *, reason: str = "budget") -> bool:
        sess = self._entries.pop(key, None)
        if sess is None:
            return False
        self._registry().counter("session_cache_evictions_total").inc()
        self._emit("session-evict", key=key, reason=reason,
                   bytes=session_nbytes(sess))
        close = getattr(sess, "close", None)
        if close is not None:
            close()
        self._update_gauge()
        return True

    def _shrink_to_budget(self, protect: str) -> None:
        # never evict the entry just built: a single session larger
        # than the budget stays resident alone rather than thrashing
        while (self.byte_budget > 0
               and self.resident_bytes() > self.byte_budget
               and len(self._entries) > 1):
            victim = next(k for k in self._entries if k != protect)
            self.evict(victim, reason="budget")

    def close(self) -> None:
        for key in list(self._entries):
            self.evict(key, reason="shutdown")


def absolute_deadline(request: Request,
                      accepted_monotonic: float) -> Optional[float]:
    """A request's absolute ``time.monotonic()`` deadline, anchored at
    acceptance (queue wait counts against the budget — that is what
    makes queue saturation shed instead of serving stale work)."""
    if request.deadline_s is None:
        return None
    return accepted_monotonic + float(request.deadline_s)


__all__ = [
    "ResidentSession", "SessionCache", "absolute_deadline",
    "session_key", "session_nbytes",
]
