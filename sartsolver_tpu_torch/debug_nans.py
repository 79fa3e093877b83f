"""``--debug_nans``: abort a solve at the first NaN it keeps.

The JAX CLI's ``--debug_nans`` sets ``jax_debug_nans``: a NaN in the output
of a compiled device program aborts the run with ``FloatingPointError``.
PyTorch has no such switch, so a solve run with ``debug_nans=True``
(``DistributedSARTSolver(..., debug_nans=True)``, the solver core's keyword)
checks the values it keeps at its step boundaries instead: the start of a
solve (guess, set-up projection, observation back-projection), each
iteration's kept iterate, projection and Eq. 5 metric, and a scheduler
lane's state after its refill. These are the values the JAX programs
return, so the port raises on the runs where the JAX CLI raises: a
candidate that the divergence guard rolls back is never kept and never
checked, and a NaN pixel that the masks leave out of the solve is not a
result of the solve. (A continuous-batching lane keeps its measurement in
its state, so a NaN pixel there is one, as in the JAX scheduler, whose
stride returns that state.)

Off, the solver calls none of this: no device op, no host sync. On, each
check is one host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor


def row_flags(x: Tensor) -> Tensor:
    """``[B]`` bools: the rows of ``x`` that hold a NaN, queued on the
    device without a sync."""
    return torch.isnan(x).flatten(1).any(dim=1)


def first_nan(*values: Tuple[str, Optional[Tensor]]) -> Optional[str]:
    """The name of the first ``(name, tensor)`` pair whose tensor holds a
    NaN, else None. One host sync; None tensors are skipped."""
    named = [(name, v) for name, v in values if v is not None]
    flags = torch.stack([torch.isnan(v).any() for _, v in named]).cpu()
    return named[int(flags.to(torch.int8).argmax())][0] if flags.any() else None


def fail(what: str, where: str) -> None:
    """Raise the ``FloatingPointError`` of a NaN in ``what`` at ``where``
    (the step: an iteration, a scheduler stride's step, a solve's start)."""
    raise FloatingPointError(f"NaN in {what} at {where} (--debug_nans)")


def check(where: str, *values: Tuple[str, Optional[Tensor]]) -> None:
    """Raise ``FloatingPointError`` naming the first of ``values`` (``(what,
    tensor)`` pairs) that holds a NaN and the step ``where``."""
    what = first_nan(*values)
    if what is not None:
        fail(what, where)
