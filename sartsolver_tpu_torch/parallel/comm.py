"""Collectives over a grid of ranks, in a fixed order.

Counterpart of the ``lax.psum`` and ``lax.all_gather`` calls the JAX solver
makes under ``shard_map``, and of ``jax.distributed.initialize``. Each
collective names an axis of a :class:`~sartsolver_tpu_torch.parallel.mesh.
RankGrid` (``'pixels'``, ``'voxels'`` or ``'world'``) and is a no-op where
that axis has one rank (or no grid is given): the one-device path launches
nothing new.

Sums are taken in a fixed order: :func:`all_reduce_sum` gathers every
rank's operand of the axis and adds them in the axis's rank order, so every
rank holds the same bytes, and every run of the same grid the same bytes
again. The stop test depends on that: the Eq. 5 metric and the fp64 norms
are reduced, then every rank decides from the same value. (A library
all-reduce's order depends on its algorithm and chunking; ring reductions
sum each chunk in another order.) The cost is ``n`` operands received
instead of one reduced one, small at the sizes the solver reduces: ``[B,
V_local]`` once an iteration on a pixel-sharded grid, ``[B, P_local]`` on a
voxel-sharded one, and a few ``[B]`` scalars.

Backends: ``nccl`` where every rank of a host has a card of its own, else
``gloo`` (the CPU, and ranks sharing one card: NCCL refuses two ranks on
one device). gloo's collectives are run on host tensors here: a CUDA
operand is copied into pinned host memory, gathered on the host and copied
back to its device, explicitly, whatever the installed torch's gloo would
take; under NCCL a host operand (a few scalars) goes through the rank's
card the same way. A failing collective raises, and so does one that waits
past ``COLLECTIVE_TIMEOUT_S`` for a peer; nothing falls back to one rank or
to the CPU.

``stats`` counts the collectives a rank ran, their bytes (its own operand)
and their wall seconds, the wait for peers included; a CUDA operand's
stream is synchronized first, and that wait for the device's queued work
is counted apart (``device_wait_seconds``). ``stats["by_kind"]`` counts
them by kind (``all-reduce``, ``all-gather``), the keys of the launch
audit's collective budgets (``analysis/registry.py``).
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import List

import torch
import torch.distributed as dist

from sartsolver_tpu_torch.analysis import registry as audit_registry
from sartsolver_tpu_torch.parallel.mesh import WORLD_AXIS

stats = {"calls": 0, "bytes": 0, "seconds": 0.0, "device_wait_seconds": 0.0,
         "by_kind": {"all-reduce": 0, "all-gather": 0}}


def reset_stats() -> None:
    stats.update(calls=0, bytes=0, seconds=0.0, device_wait_seconds=0.0,
                 by_kind={"all-reduce": 0, "all-gather": 0})


def pick_backend(device_type: str) -> str:
    """``nccl`` where the ranks are on CUDA and each rank of this host has a
    card of its own (``LOCAL_WORLD_SIZE`` at most the cards it sees), else
    ``gloo``."""
    if device_type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if dist.is_nccl_available() and local <= torch.cuda.device_count() else "gloo"


# seconds a rank waits in one collective (gloo) before the run fails: a
# dead peer ends its grid's run instead of hanging it
COLLECTIVE_TIMEOUT_S = 600


def initialize(device_type: str) -> str:
    """The process group from the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``: what
    ``torchrun`` sets), on the backend :func:`pick_backend` gives; a no-op
    returning the backend where the group exists. On CUDA the rank's
    device is ``cuda:LOCAL_RANK`` modulo the cards it sees (ranks sharing a
    card all use it)."""
    if dist.is_initialized():
        return dist.get_backend()
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        from sartsolver_tpu_torch.config import SartInputError

        raise SartInputError(
            "--multihost initializes torch.distributed from the launcher's "
            f"environment, which lacks {', '.join(missing)}; launch with "
            "torchrun (python -m torch.distributed.run --nproc_per_node N ...).")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % max(torch.cuda.device_count(), 1))
    backend = pick_backend(device_type)
    dist.init_process_group(backend=backend, init_method="env://",
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return backend


def shutdown() -> None:
    """Tear the process group down (every rank, at the end of a run)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _axis(grid, axis: str):
    """``(process group, extent)`` of ``axis``; extent 1 where there is
    nothing to do."""
    if grid is None:
        return None, 1
    return grid.group(axis), grid.size(axis)


def _host_staged(grid, x: torch.Tensor) -> bool:
    return x.is_cuda and (grid is None or grid.backend != "nccl")


def all_gather_parts(x: torch.Tensor, axis: str, grid,
                     kind: str = "all-gather") -> List[torch.Tensor]:
    """Every rank's ``x`` along ``axis``, in the axis's rank order, on
    ``x``'s device (``[x]`` where the axis has one rank). ``kind`` is the
    collective this gather serves, for ``stats["by_kind"]``."""
    group, n = _axis(grid, axis)
    if n == 1:
        return [x]
    stats["by_kind"][kind] += 1
    with audit_registry.region("collective", kind):
        return _gather(x, group, n, grid)


def _gather(x: torch.Tensor, group, n: int, grid) -> List[torch.Tensor]:
    src = x.contiguous()
    if src.is_cuda:
        t0 = time.perf_counter()
        torch.cuda.current_stream(src.device).synchronize()
        stats["device_wait_seconds"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    if _host_staged(grid, src):
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        src = host
    elif grid.backend == "nccl" and not src.is_cuda:  # NCCL takes CUDA tensors only
        src = src.to(torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    if src.device != x.device:
        parts = [p.to(x.device, non_blocking=x.is_cuda) for p in parts]
    stats["calls"] += 1
    stats["bytes"] += x.numel() * x.element_size()
    stats["seconds"] += time.perf_counter() - t0
    return parts


def all_reduce_sum(x: torch.Tensor, axis: str, grid) -> torch.Tensor:
    """``x`` summed over ``axis``, the operands added in rank order (the
    same bytes on every rank); ``x`` itself where the axis has one rank."""
    parts = all_gather_parts(x, axis, grid, "all-reduce")
    if len(parts) == 1:
        return x
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def all_reduce_max(x: torch.Tensor, axis: str, grid) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``axis``."""
    parts = all_gather_parts(x, axis, grid, "all-reduce")
    if len(parts) == 1:
        return x
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p)
    return acc


def all_gather(x: torch.Tensor, axis: str, grid, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated on ``dim`` in rank
    order (the JAX ``all_gather(..., tiled=True)``)."""
    parts = all_gather_parts(x, axis, grid)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def world_flags(value: int, grid) -> List[int]:
    """One int from every rank of the world, in rank order (a one-int
    all-gather; ``[value]`` on a grid of one rank)."""
    parts = all_gather_parts(torch.tensor([int(value)], dtype=torch.int64), WORLD_AXIS, grid)
    return [int(p.item()) for p in parts]
