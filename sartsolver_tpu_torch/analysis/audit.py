"""Launch audit: per-iteration counts of the hot entry points.

The torch twin of the JAX package's compile audit
(``sartsolver_tpu/analysis/audit.py``). Eager PyTorch compiles no program
whose HLO could be read, so the audit runs each registered entry
(:mod:`~sartsolver_tpu_torch.analysis.registry`) through the port's real
entry point, the solver's ``solve_batch`` (which runs
``models/sart.py:solve_normalized_batch``), for K and then 2K iterations
with ``conv_tolerance=1e-30`` so that no frame stops, and takes the
per-iteration counts as the difference over K:

- aten ops, counted by a ``TorchDispatchMode`` (every op on the CPU and on
  CUDA, with its dtypes and sizes, no profiler needed);
- host syncs: ``aten::_local_scalar_dense`` (``.item()``, ``bool()`` of a
  tensor), a device-to-host copy, and on CUDA the ops whose output size
  the host must read (``nonzero``, ``masked_select``, ``unique``);
- copies and dtype conversions by size (``clone``, ``copy_``,
  ``_to_copy``), and the largest fp64 tensor;
- the calls of the hand kernels' wrappers (``registry.opaque``) and the
  collectives of ``parallel/comm.py`` (``registry.region``), each one
  opaque event: what runs inside (the plain version's steps on the CPU,
  the output allocations and host staging on the card) is not the loop's;
- on the card, the launches by plan (``ops/fused_sweep.py:
  launches_by_plan``) and a ``torch.profiler`` pass over the CUDA kernels
  of the port's own sources (``ops/csrc/*.cu``), which must agree.

Beside the invariants, and not gated: the aten ops and the elements
converted per iteration (the OS cycle's upcast of reduced-precision
storage shows there as a number).

Entries that need a grid of ranks (``min_ranks``) run in a group of their
own (:func:`run_launch_audit` starts two ranks over gloo on the CPU,
``python -m sartsolver_tpu_torch.analysis.audit --rank ...``), or in the
caller's group (:func:`run_grid_entries`). An entry whose configuration the
port refuses on a grid is reported ``refused`` with the refusal's words.

``hlo.py`` and the op-histogram and cost goldens have no twin: eager
PyTorch has no compiled module to pin.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from sartsolver_tpu_torch.analysis import registry
from sartsolver_tpu_torch.analysis.registry import AuditEntry, AuditShape, resolve

# the audit's iteration count K (the entry runs K, then 2K iterations)
AUDIT_ITERATIONS = 4
# ops that make the host wait for the device (their output size is data)
_CUDA_SYNC_OPS = ("nonzero", "masked_select", "unique", "_unique", "_unique2",
                  "unique_consecutive", "unique_dim")
_COPY_OPS = ("clone", "copy_", "_to_copy", "_copy_from", "_copy_from_and_resize")
# CUDA kernels that belong to fused_sweep.cu, by calls of each plan (PERF.md
# section 6: one_read 2 kernels a call, tensor_core 4, two_read 5)
KERNELS_PER_CALL = {"one_read": 2, "tensor_core": 4, "two_read": 5}


@dataclasses.dataclass
class EntryReport:
    """Audit outcome for one registered entry."""

    name: str
    status: str  # ok | violation | refused | error
    violations: List[str] = dataclasses.field(default_factory=list)
    detail: str = ""
    per_iteration: Dict[str, object] = dataclasses.field(default_factory=dict)
    shape: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def failed(self) -> bool:
        return self.status in ("violation", "error")

    def format(self) -> str:
        lines = [f"[{self.status}] {self.name}" + (f" — {self.detail}" if self.detail else "")]
        if self.per_iteration and not self.failed:
            it = self.per_iteration
            lines.append(
                f"    per iteration: {it['aten_ops']:g} aten ops, {it['host_syncs']:g} host "
                f"sync(s), launches {it['launches']}, collectives {it['collectives']}, "
                f"{it['elements_converted']:g} elements converted, largest fp64 "
                f"{it['f64_max_elems']}")
        lines += [f"    {v}" for v in self.violations]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _make_counter():
    """The dispatch mode (built on first use: the module imports no torch)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.inside = []  # the kinds of the opaque events entered
            self.ops = 0
            self.inside_ops = 0
            self.syncs = 0
            self.inside_syncs = collections.Counter()  # by the event's kind
            self.sized = collections.Counter()  # (kind, op, elements)
            self.events = collections.Counter()  # ("launch"|"collective", name)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            op = func.overloadpacket.__name__
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            cuda = any(t.is_cuda for t in ins + outs)
            sync = op == "_local_scalar_dense" or (cuda and op in _CUDA_SYNC_OPS)
            if op in _COPY_OPS and ins:
                src = ins[1] if op == "copy_" and len(ins) > 1 else ins[0]
                dst = ins[0] if op == "copy_" else (outs[0] if outs else src)
                sync = sync or (src.is_cuda and dst.device.type == "cpu")
                if not self.inside:
                    kind = "convert" if src.dtype != dst.dtype else "copy"
                    self.sized[(kind, op, dst.numel())] += 1
            if self.inside:
                self.inside_ops += 1
                self.inside_syncs[self.inside[-1]] += int(sync)
                return out
            self.ops += 1
            self.syncs += int(sync)
            for t in outs:
                if t.dtype == torch.float64:
                    self.sized[("f64", op, t.numel())] += 1
            return out

        @contextlib.contextmanager
        def region(self, kind, name):
            self.events[(kind, name)] += 1
            self.inside.append(kind)
            try:
                yield
            finally:
                self.inside.pop()

    return _Counter()


_KERNEL_RE = re.compile(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(")


def hand_kernel_names() -> frozenset:
    """The CUDA kernels defined in the port's own sources (ops/csrc/*.cu)."""
    import glob

    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "ops", "csrc")
    names = set()
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu"))):
        with open(path, encoding="utf-8") as f:
            names.update(_KERNEL_RE.findall(f.read()))
    return frozenset(names)


def _is_hand_kernel(name: str, names) -> bool:
    if "at::native" in name:
        return False
    return any(re.search(rf"(^|[\s:]){n}\s*[<(]", name) for n in names)


def _launch_counters() -> Dict[str, int]:
    """The wrappers' launch counts (they move only on the card)."""
    from sartsolver_tpu_torch.operators import implicit
    from sartsolver_tpu_torch.ops import fused_sweep as fs

    out = {f"fused_sweep:{plan}": n for plan, n in fs.fused_sweep.launches_by_plan.items()}
    out.update(sharded_sweep_bp=fs.sharded_sweep_bp.launches,
               sharded_sweep_finish=fs.sharded_sweep_finish.launches,
               implicit_forward=implicit.implicit_forward.launches,
               implicit_back=implicit.implicit_back.launches)
    return out


def _trace_kernels(prof, names) -> collections.Counter:
    """The hand kernels among the profiler's CUDA activity records, read
    from its exported trace: the event tree of ``prof.events()`` leaves out
    a kernel it cannot tie to its launch, which drops a run's kernels at
    random."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
    kernels = collections.Counter()
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "kernel" and _is_hand_kernel(name, names):
            kernels[name.removeprefix("void ").replace("(anonymous namespace)::", "")
                    .split("(")[0]] += 1
    return kernels


def _count(run, k: int, profile: bool, names) -> dict:
    """One run of ``k`` iterations under the counter (and the profiler)."""
    import torch

    from sartsolver_tpu_torch.parallel import comm

    counter = _make_counter()
    before = _launch_counters()
    by_kind = dict(comm.stats["by_kind"])
    prof_ctx = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity, profile as _profile

        torch.cuda.synchronize()
        prof_ctx = _profile(activities=[ProfilerActivity.CUDA])
    with prof_ctx as prof:
        registry._hook = counter.region
        try:
            with counter:
                run(k)
        finally:
            registry._hook = None
        if profile:
            torch.cuda.synchronize()
    kernels = _trace_kernels(prof, names) if profile else collections.Counter()
    after = _launch_counters()
    return dict(
        ops=counter.ops, inside_ops=counter.inside_ops, syncs=counter.syncs,
        inside_syncs=counter.inside_syncs, sized=counter.sized, events=counter.events,
        plans=collections.Counter({k2: after[k2] - before[k2] for k2 in after}),
        collectives=collections.Counter({k2: n - by_kind.get(k2, 0)
                                         for k2, n in comm.stats["by_kind"].items()}),
        kernels=kernels)


def _per(a, b, k: int):
    """Per-iteration difference of two counts (an int where it divides)."""
    d = b - a
    return d // k if d % k == 0 else d / k


def _sub(big: collections.Counter, small: collections.Counter) -> collections.Counter:
    out = collections.Counter(big)
    out.subtract(small)
    return collections.Counter({k: v for k, v in out.items() if v})


def measure_entry(entry: AuditEntry, run, shape: AuditShape, *, k: int = AUDIT_ITERATIONS,
                  device: str = "cpu", profile: bool = False) -> EntryReport:
    """Run ``run`` for ``k`` and ``2k`` iterations and check the entry's
    invariants on the per-iteration counts."""
    names = hand_kernel_names() if profile else frozenset()
    run(1)  # warm-up: first-call work (a kernel's load, a cache) is not the loop's
    one = _count(run, k, profile, names)
    two = _count(run, 2 * k, profile, names)
    cuda = device == "cuda"
    loop = _sub(two["sized"], one["sized"])
    # a sync inside a kernel's wrapper is the loop's on the card (its plain
    # version's on the CPU is not); inside a collective it is the gloo host
    # staging, the collective's own cost, reported apart
    syncs = _per(one["syncs"] + (one["inside_syncs"]["launch"] if cuda else 0),
                 two["syncs"] + (two["inside_syncs"]["launch"] if cuda else 0), k)
    events = _sub(two["events"], one["events"])
    launches = {name: _per(0, n, k) for (kind, name), n in sorted(events.items())
                if kind == "launch"}
    collectives = {kind: _per(one["collectives"].get(kind, 0),
                              two["collectives"].get(kind, 0), k)
                   for kind in sorted(set(two["collectives"]) | set(entry.loop_collective_budget))}
    f64 = max((n for (kind, _op, n), c in loop.items() if kind == "f64" and c > 0), default=0)
    converted = sum(n * c for (kind, _op, n), c in loop.items() if kind == "convert")
    sized = {}
    for kind, bound in (("copy", entry.loop_copy_threshold),
                        ("convert", entry.loop_convert_threshold)):
        thr = resolve(bound, shape)
        sized[kind] = 0 if thr is None else _per(0, sum(
            c for (k2, _op, n), c in loop.items() if k2 == kind and c > 0 and n >= thr), k)
    it = dict(aten_ops=_per(one["ops"], two["ops"], k), host_syncs=syncs,
              matrix_copies=sized["copy"], matrix_converts=sized["convert"],
              launches=launches, collectives=collectives, f64_max_elems=f64,
              elements_converted=_per(0, converted, k),
              syncs_inside_collectives=_per(one["inside_syncs"]["collective"],
                                            two["inside_syncs"]["collective"], k),
              ops_inside_launches=_per(one["inside_ops"], two["inside_ops"], k))
    out: List[str] = []
    if cuda:
        plans = _sub(two["plans"], one["plans"])
        it["launches_by_plan"] = {name: _per(0, n, k) for name, n in sorted(plans.items())}
        if profile:
            kern = _sub(two["kernels"], one["kernels"])
            it["cuda_kernels"] = {name: _per(0, n, k) for name, n in sorted(kern.items())}
            out += _agreement(it, launches)
    out += check_invariants(entry, it, shape, loop, cuda=cuda)
    rep = EntryReport(entry.name, "violation" if out else "ok", out, per_iteration=it,
                      shape=dataclasses.asdict(shape))
    rep.shape.update(device=device, iterations=[k, 2 * k])
    return rep


def _agreement(it: dict, launches: dict) -> List[str]:
    """The port's launch counts against the profiler's CUDA kernels: both
    zero or both not; the fused sweep's calls exactly its plans' kernels
    (``KERNELS_PER_CALL``); any other wrapper at least one kernel a call."""
    kernels = sum(it["cuda_kernels"].values())
    plans = it["launches_by_plan"]
    fused = {name.split(":", 1)[1]: n for name, n in plans.items()
             if name.startswith("fused_sweep:") and n}
    counted = sum(plans.values())
    if counted and not kernels:
        return [f"launch counters moved ({plans}) but the profiler saw no CUDA kernel of "
                "the port's sources (a vacuous pass is a failure)"]
    if kernels and not counted:
        return [f"the profiler saw {it['cuda_kernels']} but no launch was counted"]
    if set(launches) == {"fused_sweep"}:
        want = sum(n * KERNELS_PER_CALL[plan] for plan, n in fused.items())
        if kernels != want:
            return [f"{kernels} CUDA kernel(s) an iteration against {fused} calls "
                    f"({want} by the plans' kernels a call)"]
    elif kernels < counted:
        return [f"{kernels} CUDA kernel(s) an iteration for {counted} counted launch(es)"]
    return []


def check_invariants(entry: AuditEntry, it: dict, shape: AuditShape, loop, *,
                     cuda: bool = False) -> List[str]:
    """Violations of ``entry``'s declarations by the per-iteration counts
    ``it`` (``loop``: the sized ops of the extra iterations)."""
    out: List[str] = []
    if entry.requires_iterations and not it["aten_ops"] and not it["launches"]:
        out.append("no work per iteration: the loop ran nothing (every loop invariant "
                   "would pass vacuously)")
    if cuda and entry.hand_launches and not any(it.get("launches_by_plan", {}).values()):
        out.append(f"no launch of a hand kernel per iteration on the card (declared "
                   f"{dict(entry.hand_launches)})")
    if it["launches"] != dict(entry.hand_launches):
        out.append(f"hand-kernel calls per iteration {it['launches']} != declared "
                   f"{dict(entry.hand_launches)}")
    if it["host_syncs"] > entry.host_sync_budget:
        out.append(f"{it['host_syncs']} host sync(s) per iteration exceed the budget "
                   f"{entry.host_sync_budget}")
    bound = resolve(entry.f64_max_elems, shape)
    if bound is not None and it["f64_max_elems"] > bound:
        out.append(f"an fp64 tensor of {it['f64_max_elems']} elements per iteration "
                   f"(bound {bound}: an accidental promotion doubles the bytes)")
    for kind, thr in (("copy", entry.loop_copy_threshold),
                      ("convert", entry.loop_convert_threshold)):
        thr = resolve(thr, shape)
        if thr is None:
            continue
        bad = sorted((op, n) for (k2, op, n), c in loop.items()
                     if k2 == kind and c > 0 and n >= thr)
        if bad:
            out.append(f"matrix-sized {kind} inside the iteration (>= {thr} elements): "
                       + ", ".join(f"{op}[{n}]" for op, n in bad[:4]))
    for kind, budget in entry.loop_collective_budget.items():
        got = it["collectives"].get(kind, 0)
        if got > budget:
            out.append(f"per-iteration `{kind}` count {got} exceeds the declared "
                       f"budget {budget}")
    return out


# ---------------------------------------------------------------------------
# the context the builders read
# ---------------------------------------------------------------------------


class AuditContext:
    """What a builder needs: the device, the host matrix ``H`` [P, V] fp32
    (by default the seeded fixture of ``registry.AUDIT_P x AUDIT_V``), the
    frames ``B`` and the fused entries' ``storage``, the geometry record of
    the matrix-free entry, and on a grid the :class:`RankGrid`. Solvers are
    built once per configuration and shared by the entries."""

    def __init__(self, device: str = "cpu", H=None, *, B: int = 1, storage: str = "float32",
                 geometry=None, grid=None, seed: int = 7):
        self.device = device
        if H is None:
            rng = np.random.default_rng(seed)
            H = rng.random((registry.AUDIT_P, registry.AUDIT_V)).astype(np.float32)
        self.H = H
        self.B = B
        self.storage = storage
        self.geometry = geometry
        self.grid = grid
        self.seed = seed
        self._solvers: Dict[tuple, object] = {}
        self._frames: Dict[object, np.ndarray] = {}
        self._device_H = None

    @property
    def shape(self) -> AuditShape:
        P, V = self.H.shape
        return AuditShape(P, V, self.B, 1 if self.grid is None else self.grid.n_pix)

    def frames(self) -> np.ndarray:
        """``B`` positive frames ``H @ f`` of seeded positive ``f`` (the
        product on the card when there is one)."""
        if self.B not in self._frames:
            rng = np.random.default_rng(self.seed + 1)
            f = rng.random((self.B, self.H.shape[1])).astype(np.float32) + 0.5
            if self.device == "cuda" and self.grid is None:
                import torch

                fit = self._matrix("float32") @ torch.as_tensor(f.T, device="cuda")
                self._frames[self.B] = fit.T.double().cpu().numpy()
            else:
                self._frames[self.B] = np.asarray(f @ self.H.T, np.float64)
        return self._frames[self.B]

    def _matrix(self, storage: str):
        """The matrix as the solver takes it: the host array on the CPU; on
        the card one fp32 upload, shared (bf16 cast and int8 quantized from
        it on the card)."""
        import torch

        if self.device != "cuda" or self.grid is not None:
            return self.H  # a grid's solver slices its block from the host matrix
        if self._device_H is None:
            self._device_H = torch.as_tensor(self.H, device="cuda")
        return self._device_H.to(torch.bfloat16) if storage == "bfloat16" else self._device_H

    def batch_runner(self, opts, *, storage: str = "float32", sparse: bool = False,
                     operator: Optional[str] = None, guarded: bool = False):
        """``run(k)``: the solver's ``solve_batch`` over ``B`` frames from the
        Eq. 4 guess, ``opts`` with ``max_iterations=k`` and
        ``conv_tolerance=1e-30``. The solver is this configuration's:
        ``storage``, ``opts.os_subsets``, ``sparse`` (half the tile columns
        occupied), ``operator`` (``"implicit"``: the geometry record;
        ``"lowrank"``: the sparse core plus a rank-8 fill), on the grid when
        there is one. ``guarded``: dispatched through
        ``resilience/degrade.py:dispatch_guarded`` with a live ladder."""
        from sartsolver_tpu_torch.config import SolverOptions
        from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

        rtm_dtype = None if storage == "float32" else storage
        build_opts = SolverOptions(rtm_dtype=rtm_dtype, os_subsets=opts.os_subsets,
                                   sparse_rtm="auto" if sparse else "off")
        key = (storage, opts.os_subsets, sparse, operator)

        def make():
            kw = dict(opts=build_opts, device=self.device, grid=self.grid)
            if operator == "implicit":
                return DistributedSARTSolver(operator=self._implicit(), **kw)
            if operator == "lowrank":
                return DistributedSARTSolver(operator=self._lowrank(), **kw)
            if sparse:
                return DistributedSARTSolver(self._half_dark(), **kw)
            return DistributedSARTSolver(self._matrix(storage), **kw)

        if key not in self._solvers:
            self._solvers[key] = make()
        solver = self._solvers[key]
        # the matrix's frames (the sparse and factored entries' too: any
        # positive measurement will do for counting)
        G = self._implicit_frames(solver) if operator == "implicit" else self.frames()
        base = dataclasses.replace(opts, rtm_dtype=rtm_dtype, conv_tolerance=1e-30)

        def run(k: int):
            solver.opts = dataclasses.replace(base, max_iterations=k)
            if guarded:
                from sartsolver_tpu_torch.resilience.degrade import (
                    GroupSizeLadder, dispatch_guarded,
                )

                ladder = GroupSizeLadder(2)
                res, err = dispatch_guarded(lambda: solver.solve_batch(G), ladder=ladder)
                if err is not None or ladder.events:
                    raise RuntimeError(f"guarded dispatch tripped: {err}")
                return res
            return solver.solve_batch(G)

        return run

    def _half_dark(self):
        """The matrix with its second half of voxel columns exactly zero:
        half the tile columns occupied (the JAX sparse entries' 50%)."""
        if not hasattr(self, "_dark"):
            H = np.array(self.H, np.float32)
            H[:, H.shape[1] // 2:] = 0.0
            self._dark = H
        return self._dark

    def _implicit(self):
        from sartsolver_tpu_torch.operators.geometry import Camera, GeometryRecord
        from sartsolver_tpu_torch.operators.implicit import ImplicitOperator

        rec = self.geometry
        if rec is None:
            # the JAX sharded entry's record: one 8x16 camera over an
            # (8, 8, 16) grid, AUDIT_P rays and AUDIT_V voxels
            rec = GeometryRecord(
                grid_shape=(8, 8, 16), origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0),
                cameras=(Camera(name="cam0", rows=8, cols=16, position=(-20.0, 4.1, 8.2),
                                target=(4.0, 4.0, 8.0), pitch=0.9),))
        return ImplicitOperator(rec)

    def _implicit_frames(self, solver) -> np.ndarray:
        """``B`` frames of the geometry: the projector's forward product of
        seeded positive ``f`` (the kernel on the card)."""
        import torch

        from sartsolver_tpu_torch.operators.implicit import implicit_forward

        key = ("implicit", self.B)
        if key not in self._frames:
            rays, spec = solver.problem.rtm, solver.problem.operator_spec
            rng = np.random.default_rng(self.seed + 1)
            f = rng.random((self.B, spec.nvoxel)).astype(np.float32) + 0.5
            fit = implicit_forward(rays, torch.as_tensor(f, device=rays.device), spec)
            self._frames[key] = fit.double().cpu().numpy()[:, :solver.npixel]
        return self._frames[key]

    def _lowrank(self):
        from sartsolver_tpu_torch.operators.lowrank import LowRankOperator, split_sparse_core

        rng = np.random.default_rng(self.seed)
        S, occ = split_sparse_core(self._half_dark(), epsilon=0.0)
        P, V = S.shape
        u = (0.01 * rng.standard_normal((P, 8))).astype(np.float32)
        v = rng.standard_normal((V, 8)).astype(np.float32)
        return LowRankOperator(S, u, v, occupancy=occ)

    def close(self) -> None:
        for solver in self._solvers.values():
            solver.close()
        self._solvers.clear()
        self._frames.clear()
        self._device_H = None


# ---------------------------------------------------------------------------
# running the registry
# ---------------------------------------------------------------------------


def run_entry(entry: AuditEntry, ctx: AuditContext, *, k: int = AUDIT_ITERATIONS,
              profile: bool = False) -> EntryReport:
    """Audit one entry in ``ctx`` (refused entries report their words)."""
    why = entry.refusal() if entry.refusal is not None else None
    if why:
        return EntryReport(entry.name, "refused", detail=why)
    try:
        run = entry.build(ctx)
        return measure_entry(entry, run, ctx.shape, k=k, device=ctx.device, profile=profile)
    except Exception as err:  # sart-lint: disable=SL006 -- an entry that cannot run IS the finding, reported as status "error"
        return EntryReport(entry.name, "error",
                           detail=f"build/run failed: {type(err).__name__}: {err}")


def run_grid_entries(grid, ctx: Optional[AuditContext] = None, *,
                     names: Optional[Sequence[str]] = None, k: int = AUDIT_ITERATIONS,
                     profile: bool = False) -> List[EntryReport]:
    """The entries of ``min_ranks > 1`` that the port runs, in the caller's
    process group over ``grid`` (every rank calls this alike)."""
    reg = registry.load_registered_entries()
    ctx = ctx or AuditContext(grid=grid)
    ctx.grid = grid
    wanted = [n for n in (names or sorted(reg)) if reg[n].min_ranks > 1
              and not (reg[n].refusal and reg[n].refusal())]
    try:
        return [run_entry(reg[n], ctx, k=k, profile=profile) for n in wanted]
    finally:
        ctx.close()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _grid_reports(names: Sequence[str], ranks: int, timeout: float = 300.0) -> List[EntryReport]:
    """Run ``names`` in a ``ranks``-rank gloo group of fresh processes on
    the CPU (the twin of the JAX auditor's virtual CPU devices)."""
    import subprocess
    import tempfile

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="sart-audit-") as tmp:
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks),
                   PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "sartsolver_tpu_torch.analysis.audit", "--rank-out",
             tmp, ",".join(names)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(ranks)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0] or "")
        except subprocess.TimeoutExpired:
            logs.append(f"timed out after {timeout:g} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        path = os.path.join(tmp, "reports.json")
        if any(p.returncode for p in procs) or not os.path.exists(path):
            detail = f"the {ranks}-rank group failed: " + " | ".join(
                (log.strip().splitlines() or ["no output"])[-1] for log in logs)
            return [EntryReport(n, "error", detail=detail) for n in names]
        with open(path, encoding="utf-8") as f:
            return [EntryReport(**r) for r in json.load(f)]


def run_launch_audit(*, entries: Optional[Sequence[str]] = None,
                     ctx: Optional[AuditContext] = None, k: int = AUDIT_ITERATIONS,
                     profile: bool = False, grid_ranks: int = 2) -> List[EntryReport]:
    """Audit every registered (or the named) entry: the single-rank ones in
    ``ctx`` (default: the CPU fixture), the grid ones in a ``grid_ranks``
    group of their own, the refused ones by their words."""
    reg = registry.load_registered_entries()
    names = list(entries) if entries is not None else sorted(reg)
    ctx = ctx or AuditContext()
    reports: Dict[str, EntryReport] = {}
    grid_names = []
    try:
        for name in names:
            entry = reg.get(name)
            if entry is None:
                reports[name] = EntryReport(name, "error",
                                            detail=f"unknown entry; registered: {sorted(reg)}")
            elif entry.min_ranks > 1 and not (entry.refusal and entry.refusal()):
                grid_names.append(name)
            else:
                reports[name] = run_entry(entry, ctx, k=k, profile=profile)
    finally:
        ctx.close()
    if grid_names:
        for rep in _grid_reports(grid_names, grid_ranks):
            reports[rep.name] = rep
    return [reports[n] for n in names]


def _rank_main(out_dir: str, names: str) -> int:
    """One rank of :func:`_grid_reports`' group."""
    import torch

    from sartsolver_tpu_torch.parallel import comm
    from sartsolver_tpu_torch.parallel.mesh import make_grid

    torch.set_num_threads(1)
    comm.initialize("cpu")
    try:
        grid = make_grid(int(os.environ["WORLD_SIZE"]), 1)
        reports = run_grid_entries(grid, names=names.split(","))
        if grid.is_primary:
            with open(os.path.join(out_dir, "reports.json"), "w", encoding="utf-8") as f:
                json.dump([dataclasses.asdict(r) for r in reports], f)
    finally:
        comm.shutdown()
    return 0


__all__ = [
    "AUDIT_ITERATIONS", "AuditContext", "EntryReport", "KERNELS_PER_CALL",
    "check_invariants", "hand_kernel_names", "measure_entry", "run_entry",
    "run_grid_entries", "run_launch_audit",
]


if __name__ == "__main__":  # pragma: no cover - one rank of _grid_reports
    if len(sys.argv) == 4 and sys.argv[1] == "--rank-out":
        sys.exit(_rank_main(sys.argv[2], sys.argv[3]))
    print("usage: python -m sartsolver_tpu_torch.analysis.audit --rank-out DIR ENTRIES",
          file=sys.stderr)
    sys.exit(2)
