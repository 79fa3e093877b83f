"""Launch-audit registry: the hot entry points register here.

Counterpart of ``sartsolver_tpu/analysis/registry.py``. The modules that own
the solver's hot loops (``models/sart.py``, ``ops/fused_sweep.py``,
``operators/``, ``parallel/sharded.py``, ``resilience/degrade.py``) register
a *builder* at import time under the JAX entry's name: a callable that takes
an :class:`~sartsolver_tpu_torch.analysis.audit.AuditContext` and returns a
runner, ``run(iterations)``, which drives the port's real entry point for
that many iterations. The auditor (``analysis/audit.py``) runs each entry
for K and 2K iterations under a dispatch mode and checks the per-iteration
counts against the invariants declared here.

The XLA invariants have torch twins:

- ``requires_iterations`` (JAX ``requires_while_loop``): the audit must see
  work in each iteration; on the card, at least one launch of a hand kernel
  for every entry that declares one (``hand_launches``).
- ``f64_max_elems`` (JAX ``allow_f64``): the largest fp64 tensor an
  iteration may create. The precise ``||Hf||^2`` (``models/sart.py:
  _sumsq``) is fp64 at ``[B, P]`` on purpose, so the default bound is
  vector-sized; a matrix-sized promotion trips it.
- ``loop_copy_threshold`` / ``loop_convert_threshold``: no op of the
  iteration produces a copy, or a dtype conversion, of that many elements
  or more (None skips).
- ``loop_collective_budget``: per-iteration collectives by kind
  (``all-reduce``, ``all-gather``), counted by ``parallel/comm.py``.
- ``host_sync_budget`` (what the JAX ``while`` loop guarantees): the host
  syncs an iteration may make; 1, the done flag.
- ``hand_launches``: the exact calls of the hand kernels' wrappers per
  iteration, by wrapper (on the card each is broken down by plan and by
  the CUDA kernels the profiler saw).
- ``min_ranks`` (JAX ``min_devices``): ranks of the grid the entry needs;
  such an entry runs in a group of its own (``analysis/audit.py``).
- ``refusal``: where the port refuses the entry's configuration (on a grid
  of ranks), a callable returning the refusal's words; the entry is then
  reported ``refused`` with them, never ``ok`` and never skipped.

Bounds that depend on the audited shape are callables of an
:class:`AuditShape` (:func:`matrix`, :func:`rank_block`, :func:`vector`).
``min_donated_args`` (donation) and the cost goldens have no meaning in
eager PyTorch and are not ported.

:func:`opaque` marks a hand kernel's wrapper, and :func:`region` a
collective: while the auditor counts, each call is one opaque event, and
the ops inside it (the plain version's steps on the CPU, the output
allocations and host staging on the card) are not the loop's.

This module is imported by the hot modules, so it stays dependency-free
(no torch, no numpy).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Mapping, Optional, Union


@dataclasses.dataclass(frozen=True)
class AuditShape:
    """The audited problem: ``P`` pixel rows and ``V`` voxels of the whole
    matrix, ``B`` frames, over ``ranks`` ranks along the pixel axis."""

    P: int
    V: int
    B: int = 1
    ranks: int = 1


Bound = Union[None, int, Callable[[AuditShape], int]]


def matrix(s: AuditShape) -> int:
    """The matrix's elements."""
    return s.P * s.V


def rank_block(s: AuditShape) -> int:
    """One rank's block of the matrix (the sharded entries' bound)."""
    return (s.P // s.ranks) * s.V


def vector(s: AuditShape) -> int:
    """The largest per-frame vector of the batch, ``[B, max(P, V)]``."""
    return s.B * max(s.P, s.V)


def resolve(bound: Bound, shape: AuditShape) -> Optional[int]:
    return bound(shape) if callable(bound) else bound


NO_COLLECTIVES = {"all-reduce": 0, "all-gather": 0}


@dataclasses.dataclass(frozen=True)
class AuditEntry:
    """One registered hot entry point and its declared invariants (module
    docstring)."""

    name: str
    build: Callable[[object], Callable[[int], object]]
    description: str
    requires_iterations: bool = True
    f64_max_elems: Bound = vector
    loop_copy_threshold: Bound = matrix
    loop_convert_threshold: Bound = matrix
    loop_collective_budget: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: dict(NO_COLLECTIVES))
    host_sync_budget: int = 1
    hand_launches: Mapping[str, int] = dataclasses.field(default_factory=dict)
    min_ranks: int = 1
    refusal: Optional[Callable[[], Optional[str]]] = None


AUDIT_REGISTRY: Dict[str, AuditEntry] = {}

# The CPU fixture's shape: small, tile-aligned (pixels % 8, voxels % 128),
# the JAX audit's (sartsolver_tpu/analysis/registry.py:AUDIT_P, AUDIT_V).
AUDIT_P, AUDIT_V = 128, 1024

# Modules whose import runs the registrations.
ENTRY_MODULES = (
    "sartsolver_tpu_torch.models.sart",
    "sartsolver_tpu_torch.operators.implicit",
    "sartsolver_tpu_torch.operators.lowrank",
    "sartsolver_tpu_torch.ops.fused_sweep",
    "sartsolver_tpu_torch.parallel.sharded",
    "sartsolver_tpu_torch.resilience.degrade",
)


def register_audit_entry(name: str, *, description: str, **invariants):
    """Decorator: register ``builder`` as audit entry ``name``."""

    def deco(builder):
        if name in AUDIT_REGISTRY:
            raise ValueError(f"duplicate audit entry {name!r}")
        AUDIT_REGISTRY[name] = AuditEntry(name=name, build=builder,
                                          description=description, **invariants)
        return builder

    return deco


def load_registered_entries() -> Dict[str, AuditEntry]:
    """Import the hot modules (running their registrations) and return the
    registry. An import error propagates: an unimportable hot module is an
    audit failure, not something to skip."""
    import importlib

    for mod in ENTRY_MODULES:
        importlib.import_module(mod)
    return dict(AUDIT_REGISTRY)


# ---- the auditor's hook -----------------------------------------------------

# Set by the auditor while it counts: a callable (kind, name) -> context
# manager. None otherwise, and then region() and opaque() cost one check.
_hook: Optional[Callable[[str, str], object]] = None


def region(kind: str, name: str):
    """A context for one opaque event of ``kind`` (``launch``,
    ``collective``) named ``name``: the auditor's, or a null context."""
    hook = _hook
    return contextlib.nullcontext() if hook is None else hook(kind, name)


def opaque(name: str):
    """Decorator for a hand kernel's wrapper: each call is one opaque
    launch event named ``name`` while the auditor counts."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _hook is None:
                return fn(*args, **kwargs)
            with _hook("launch", name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
