"""Adaptive OOM degradation: a batch-halving ladder on dispatch failure.

Counterpart of ``sartsolver_tpu/resilience/degrade.py``. A dispatch that
dies with a device out-of-memory is rarely a reason to lose frames: the same
frames usually solve at a smaller frame-group size. The CLI's grouped
batch loop consults a :class:`GroupSizeLadder` around every dispatch (and
takes over from the continuous-batching scheduler after its OOM):

- an OOM **halves** the current group size and re-solves the *same* frames
  at the reduced size: no frame is skipped, no row reordered;
- the reduction **sticks** for the rest of the run (the memory did not come
  back; re-probing the old size would fail every group) and is reported in
  one summary line;
- at group size 1 the ladder is exhausted and the error propagates.

``torch.cuda.OutOfMemoryError`` takes the role of XLA's
``RESOURCE_EXHAUSTED``; the text markers catch allocator messages raised as
plain ``RuntimeError``. After an OOM the allocator's cached blocks are
released before the re-dispatch, so the halved group does not fail again on
fragmentation.

Telemetry, as in the JAX module: the ladder's level is the
``frame_group_size`` gauge and each halving ticks
``oom_degradations_total``; every dispatch is a ``solve.dispatch`` trace
span.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.obs import trace as obs_trace

# Substrings marking a device allocation failure in an error's text (the
# CUDA caching allocator's "CUDA out of memory", XLA's RESOURCE_EXHAUSTED).
_OOM_MARKERS = ("resource_exhausted", "out of memory")


def is_resource_exhausted(err: BaseException) -> bool:
    """True when ``err`` is a device out-of-memory."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    text = str(err).lower()
    return any(marker in text for marker in _OOM_MARKERS)


class GroupSizeLadder:
    """Current frame-group size plus the halving history.

    ``on_event`` (optional) receives one human-readable line per halving.
    """

    def __init__(self, size: int,
                 on_event: Optional[Callable[[str], None]] = None):
        if size < 1:
            raise ValueError("Group size must be positive.")
        self.size = int(size)
        self.events: List[Tuple[int, int]] = []  # (from, to) per halving
        self._on_event = on_event
        registry = obs_metrics.get_registry()
        self._size_gauge = registry.gauge("frame_group_size")
        self._oom_counter = registry.counter("oom_degradations_total")
        self._size_gauge.set(self.size)

    def note_oom(self, err: BaseException) -> bool:
        """Record an OOM at the current size. True when the ladder halved
        (the caller re-dispatches the same frames at ``self.size``), False
        when already at 1 (exhausted)."""
        if self.size <= 1:
            return False
        new = self.size // 2
        self.events.append((self.size, new))
        if self._on_event is not None:
            self._on_event(
                f"device OOM at frame-group size {self.size} "
                f"({type(err).__name__}); re-solving the same frames at "
                f"{new} — the reduction sticks for the rest of the run"
            )
        self.size = new
        self._size_gauge.set(new)
        self._oom_counter.inc()
        return True

    def summary(self) -> Optional[str]:
        """One summary line, or None when the ladder never tripped."""
        if not self.events:
            return None
        path = " -> ".join(
            [str(self.events[0][0])] + [str(new) for _, new in self.events]
        )
        return (
            f"oom degradation: frame-group size {path} "
            f"({len(self.events)} event(s); reduced size kept for the "
            "rest of the run)"
        )


def dispatch_guarded(dispatch: Callable[[], object], *,
                     ladder: Optional[GroupSizeLadder] = None):
    """Run one dispatch (a ``solve.dispatch`` beacon and trace span) with
    OOM classification for the ladder.

    Returns ``(result, None)`` on success and ``(None, err)`` after an OOM
    that halved the ladder (the caller re-stacks the same frames at
    ``ladder.size`` and dispatches again). Every other error, and an OOM
    with the ladder exhausted or absent, propagates unchanged.
    """
    from sartsolver_tpu_torch.resilience import watchdog

    watchdog.beacon(watchdog.PHASE_DISPATCH)
    try:
        with obs_trace.span("solve.dispatch"):
            return dispatch(), None
    except RuntimeError as err:  # torch.cuda.OutOfMemoryError is one
        if (ladder is not None and is_resource_exhausted(err)
                and ladder.note_oom(err)):
            torch.cuda.empty_cache()  # a no-op where CUDA never started
            return None, err
        raise


# ---- launch-audit registration (analysis/registry.py) -----------------------
# The batched solve of a 2x1 grid dispatched through dispatch_guarded with a
# live ladder (nothing trips): the counts must be sharded_batch's.

from sartsolver_tpu_torch.analysis.registry import (  # noqa: E402
    rank_block as _rank_block,
    register_audit_entry as _register_audit_entry,
)


@_register_audit_entry(
    "guarded_dispatch",
    description="2x1 grid's batched solve dispatched through the availability layer "
                "(watchdog beacon and OOM ladder armed, nothing tripped)",
    loop_copy_threshold=_rank_block,
    loop_convert_threshold=_rank_block,
    loop_collective_budget={"all-reduce": 2, "all-gather": 0},
    min_ranks=2,
)
def _audit_guarded_dispatch(ctx):
    from sartsolver_tpu_torch.config import SolverOptions

    return ctx.batch_runner(SolverOptions(fused_sweep="off"), guarded=True)
