"""Solver status codes, input errors, time-range parsing and solver options.

A copy of the JAX package's ``sartsolver_tpu/config.py`` restricted to what
the one-device solve and ``lint``'s severity overrides use. The flag semantics, defaults and messages
follow the reference CLI (``source/arguments.cpp``); invalid values raise
``ValueError`` here and the CLI turns them into exit(1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

# Solver status codes (reference source/sartsolver.cpp:16-17).
SUCCESS = 0
MAX_ITERATIONS_EXCEEDED = -1
# Beyond the reference's two codes: the in-solve divergence guard
# (SolverOptions.divergence_recovery) exhausted its rollback and
# relaxation-halving ladder for this frame, or the frame's input was not
# finite; the solution row holds the last finite iterate (zero for bad input).
DIVERGED = -2


class SartInputError(ValueError):
    """A problem with the user's inputs (flags or input-file contents).

    The CLI converts exactly this (plus the HDF5 reader's OSError/KeyError) into the
    reference's polite message + exit(1); any other exception is an
    internal bug and tracebacks loudly."""


def parse_time_intervals(time_string: str) -> List[Tuple[float, float, float, float]]:
    """Parse a multi-interval time-range string.

    Grammar (reference source/arguments.cpp:12-79):
    ``start:stop[:step[:threshold]],...`` — e.g. ``"20.5:40.1, 45.2:51:15:0.05"``.
    A trailing ``,`` is allowed. An empty string means "all times":
    ``[(0, inf, 0, 0)]``. ``step == 0`` means auto-derive; ``threshold == 0``
    means "use the step".

    Validation: 2..4 fields per interval, ``start >= 0``, ``stop > start``,
    ``step <= stop - start``, ``threshold <= step``.
    """
    if not time_string:
        return [(0.0, math.inf, 0.0, 0.0)]

    intervals: List[Tuple[float, float, float, float]] = []
    segments = time_string.split(",")
    for pos, interval_string in enumerate(segments):
        if not interval_string.strip():
            if pos == len(segments) - 1:
                continue  # trailing "," is allowed (arguments.cpp:24)
            raise SartInputError(
                f"Unable to recognize a time interval in {interval_string}."
            )
        fields = interval_string.split(":")
        if len(fields) < 2:
            raise SartInputError(
                f"Unable to recognize a time interval in {interval_string}."
            )
        if len(fields) > 4:
            raise SartInputError(
                f"Too many values in a time interval: {interval_string}."
            )
        try:
            start = float(fields[0])
            stop = float(fields[1])
            step = float(fields[2]) if len(fields) > 2 else 0.0
            threshold = float(fields[3]) if len(fields) > 3 else 0.0
        except ValueError as err:
            raise SartInputError(
                f"Unable to convert {interval_string} to the time interval."
            ) from err

        if start < 0:
            raise SartInputError("Time limits must be positive.")
        if stop <= start:
            raise SartInputError(
                "The upper limit of the time interval must be higher than the lower one."
            )
        if step > (stop - start):
            raise SartInputError("Time step must be less or equal to the time interval.")
        if threshold > step:
            raise SartInputError(
                "Synchronization threshold must be less or equal to the time step."
            )
        intervals.append((start, stop, step, threshold))

    if not intervals:
        raise SartInputError(f"Unable to recognize a time interval in {time_string}.")
    return intervals


# Static-analysis severity levels (analysis/rules.py) in decreasing order;
# "off" is accepted in overrides to disable a rule entirely.
LINT_SEVERITIES = ("error", "warning", "info")


def parse_severity_overrides(spec: str) -> dict:
    """Parse a ``lint --severity`` override string.

    Grammar: comma-separated ``RULE=LEVEL`` pairs, e.g.
    ``"SL004=error,SL003=off"``; levels are :data:`LINT_SEVERITIES` plus
    ``off``. Empty string -> no overrides. Invalid specs raise
    :class:`SartInputError` (the lint CLI converts it into the same polite
    message + exit(1) contract as the solver CLI's flag validation).
    """
    overrides: dict = {}
    if not spec:
        return overrides
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        rule, sep, level = part.partition("=")
        rule, level = rule.strip(), level.strip()
        if not sep or not rule or not level:
            raise SartInputError(
                f"Unable to parse severity override {part!r}; expected "
                "RULE=LEVEL, e.g. 'SL004=error'."
            )
        if not (rule.startswith("SL") and rule[2:].isdigit()
                and len(rule) == 5):
            # catch typos at parse time (the lint CLI additionally checks
            # the id against the registered rule set) — a silently
            # ignored override would let the user believe a rule was
            # disabled when it was not
            raise SartInputError(
                f"Unknown rule id {rule!r} in severity override; rule ids "
                "look like 'SL004' (see `sartsolve lint --list-rules`)."
            )
        if level not in LINT_SEVERITIES + ("off",):
            raise SartInputError(
                f"Unknown severity {level!r} for rule {rule}; valid: "
                f"{', '.join(LINT_SEVERITIES + ('off',))}."
            )
        overrides[rule] = level
    return overrides


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Validated solver parameters.

    Defaults and ranges follow the reference CLI (source/arguments.cpp:96-133)
    and solver setters (source/sartsolver.cpp:61-123). Extensions beyond the
    reference's parameter set:

    - ``dtype``: compute dtype. ``"float32"`` mirrors the reference's CUDA
      path (device fp32 + global-max measurement normalization,
      sartsolver_cuda.cpp:146-150); ``"float64"`` mirrors its CPU path.
    - ``guess_floor``: the CUDA path clamps any initial solution to
      ``>= 1e-7`` for both solver variants (sartsolver_cuda.cpp:180).
    - ``log_epsilon``: EPSILON_LOG_CUDA (sart_kernels.cu:18).
    - ``normalize``: divide the measurement by its global max (fp32 range
      guard for ``||Hf||^2``, sartsolver_cuda.cpp:146-150).
    - ``mask_negative_guess``: the CUDA initial guess excludes negative
      (saturated) measurements (sart_kernels.cu:34).
    - ``fused_sweep``: ``"auto"`` runs every iteration through the fused
      sweep (ops/fused_sweep.py) when the compute dtype is fp32 and declines
      quietly otherwise; ``"on"`` raises where it cannot engage; ``"off"``
      runs the two-matmul sweep.
    - ``precise_convergence``: accumulate the Eq. 5 metric's ``||Hf||^2``
      in fp64 so the ``|dC| < tol`` stall crossing does not drift with the
      summation order; False gives the reference CUDA path's fp32 dot.
    - ``rtm_dtype``: the stored matrix's dtype (None: the compute dtype).
      ``"bfloat16"`` halves the bytes each sweep reads; ``"int8"`` stores
      per-voxel-scaled codes (``models/sart.py:quantize_rtm``), solves the
      quantized system, needs fp32 compute and the fused sweep.
    - ``schedule_stride``: continuous batching (``sched/``) returns control
      to the host every this many iterations, so the scheduler can retire
      converged lanes and backfill them from the frame queue. Only the
      scheduler reads it.
    - ``relaxation_decay``: iteration k of a frame steps by ``relaxation *
      decay**k`` (1.0, the default, is the reference's fixed relaxation).
    - ``momentum``: ``"nesterov"`` extrapolates the iterate before each
      sweep (additively for the linear solver, multiplicatively for the log
      solver), with gradient-based restart; ``"off"`` is the plain update.
    - ``os_subsets``: ordered-subsets SART. Each outer iteration cycles
      the update over this many interleaved pixel-row subsets (subset t is
      rows ``t::os_subsets``), each with a fresh residual, its own ray
      density and mask, then projects the final iterate once in full for
      the Eq. 5 test. Must divide the pixel extent. 1 (the default) is the
      classic sweep; with ``fused_sweep="auto"`` the subset cycle replaces
      the fused sweep, and ``"on"`` is refused.
    - ``divergence_recovery``: with R > 0 an iteration whose ``||Hf||^2``
      or metric is not finite, or whose ``||Hf||^2`` exceeds
      ``divergence_threshold * max(||g||^2, 1)``, is rolled back and the
      frame's step halved, up to R times; then the frame stops with status
      ``DIVERGED``. A frame whose input is not finite is ``DIVERGED`` at
      iteration 0 with a zero solution. 0 disables the guard.

    The three step writers compose in one product, the JAX package's
    precedence contract (``sartsolver_tpu/config.py:189-207``): iteration k
    steps by ``relaxation * decay**k * ascale``, where ``ascale`` is the
    guard's per-frame scale (halved at each rollback, never reset, and k
    advances through a rollback). Momentum writes no step: a restart resets
    only its own state, and a rollback resets it too.
    """

    ray_density_threshold: float = 1.0e-6
    ray_length_threshold: float = 1.0e-6
    conv_tolerance: float = 1.0e-5
    beta_laplace: float = 2.0e-2
    relaxation: float = 1.0
    max_iterations: int = 2000
    logarithmic: bool = False

    dtype: str = "float32"
    guess_floor: float = 1.0e-7
    log_epsilon: float = 1.0e-7
    normalize: bool = True
    mask_negative_guess: bool = True
    fused_sweep: str = "auto"
    precise_convergence: bool = True

    rtm_dtype: str | None = None
    schedule_stride: int = 16

    relaxation_decay: float = 1.0
    momentum: str = "off"
    divergence_recovery: int = 0
    divergence_threshold: float = 1.0e4
    os_subsets: int = 1

    # The in-solve ABFT integrity check (``--integrity``): each iteration
    # holds sum(H f) against rho . f (and, on the two-matmul path, sum(H^T
    # w) against lambda . w) within resilience/integrity.py:abft_tolerance;
    # a frame that trips freezes with status SDC_DETECTED (-4).
    integrity: bool = False

    # Block-sparse RTM mode (``--sparse_rtm``): "off" (default) is the
    # dense solver. "auto" builds a lossless tile-occupancy index (exact-
    # zero 8 x 128 tiles only, ``ops/sparse.py``) and runs the sweep over
    # the occupied voxel tile columns alone (``models/sart.py``): the
    # matrix the card keeps holds those columns only, so bytes and FLOPs
    # scale with occupancy. A number in [0, 1) is a relative threshold:
    # tiles whose every entry satisfies |H_ij| <= eps * max|H| are zeroed
    # before rho, lambda and the Eq. 6 masks are taken, so the solve is
    # self-consistent with the thresholded operator. "auto" declines
    # quietly where the sparse sweep cannot engage (fp64 compute, no
    # index); a number raises there instead.
    sparse_rtm: str = "off"
    # The factored RTM (``--lowrank_rtm``): "off" (default), "auto" (the
    # quality gate picks the rank, declining loudly to dense where none
    # passes) or a positive integer rank (a rank that fails the gate
    # raises before anything is staged): H ~= S + U V^T, a tile-thresholded
    # sparse core plus a randomized-SVD factorization of the residual
    # (operators/lowrank.py). Its products replace the fused sweep, so an
    # explicit fused_sweep='on' conflicts.
    lowrank_rtm: str = "off"

    @classmethod
    def cpu_parity(cls, *, logarithmic: bool = False, **kw) -> "SolverOptions":
        """Options replicating the reference's fp64 CPU path: no
        normalization, unmasked initial guess, no guess floor (linear).

        The log-path epsilon is 1e-30, the value the JAX package uses in
        place of the reference's 1e-100 (sartsolver.cpp:14); it plays the
        same role (guards the 0/0 ratio on masked voxels)."""
        kw.setdefault("dtype", "float64")
        kw.setdefault("normalize", False)
        kw.setdefault("mask_negative_guess", False)
        kw.setdefault("guess_floor", 1.0e-30 if logarithmic else 0.0)
        kw.setdefault("log_epsilon", 1.0e-30)
        return cls(logarithmic=logarithmic, **kw)

    def sparse_epsilon(self) -> float | None:
        """The relative block-sparse threshold this option set requests:
        ``None`` when sparse mode is off, ``0.0`` for ``"auto"``
        (lossless: exact-zero tiles only), else the parsed value."""
        if self.sparse_rtm == "off":
            return None
        if self.sparse_rtm == "auto":
            return 0.0
        return float(self.sparse_rtm)

    def sparse_explicit(self) -> bool:
        """An explicit numeric ``sparse_rtm`` threshold was requested:
        inability to engage the sparse sweep raises instead of quietly
        running dense (the fused_sweep='on' contract, applied here)."""
        return self.sparse_rtm not in ("off", "auto")

    def lowrank_rank(self) -> int | str | None:
        """The requested factorization rank: ``None`` when the low-rank
        backend is off, the string ``"auto"`` for gate-driven rank
        selection, else the pinned positive integer."""
        if self.lowrank_rtm == "off":
            return None
        if self.lowrank_rtm == "auto":
            return "auto"
        return int(self.lowrank_rtm)

    def lowrank_explicit(self) -> bool:
        """A pinned integer ``lowrank_rtm`` rank was requested: inability
        to engage the factored operator raises instead of quietly running
        dense (the fused_sweep='on' contract)."""
        return self.lowrank_rtm not in ("off", "auto")

    def __post_init__(self) -> None:
        if self.ray_density_threshold < 0:
            raise ValueError("Ray density threshold must be non-negative.")
        if self.ray_length_threshold < 0:
            raise ValueError("Ray length threshold must be non-negative.")
        if self.conv_tolerance < 0:
            # 0 disables the early stop (|dC| < 0.0 is never true)
            raise ValueError("Convolution tolerance must be non-negative.")
        if self.beta_laplace < 0:
            raise ValueError("Attribute beta_laplace must be non-negative.")
        if not (0 < self.relaxation <= 1.0):
            raise ValueError("Attribute relaxation must be within (0, 1] interval.")
        if not (0 < self.relaxation_decay <= 1.0):
            raise ValueError(
                "Attribute relaxation_decay must be within (0, 1] interval."
            )
        if self.max_iterations <= 0:
            raise ValueError("Attribute max_iterations must be positive.")
        if self.os_subsets < 1:
            raise ValueError(
                "Attribute os_subsets must be >= 1 (1 disables ordered-"
                "subsets cycling)."
            )
        if self.momentum not in ("off", "nesterov"):
            raise ValueError("Attribute momentum must be 'off' or 'nesterov'.")
        if self.os_subsets > 1 and self.fused_sweep == "on":
            raise ValueError(
                "Attribute os_subsets > 1 runs the subset-cycle sweep "
                "(one subset per update); an explicit fused_sweep="
                f"'{self.fused_sweep}' cannot be honored there — use "
                "'auto' or 'off'."
            )
        if self.dtype not in ("float32", "float64"):
            raise ValueError("dtype must be 'float32' or 'float64'.")
        if self.rtm_dtype not in (None, "float32", "float64", "bfloat16", "int8"):
            raise ValueError(
                "rtm_dtype must be None, 'float32', 'float64', 'bfloat16' "
                "or 'int8'."
            )
        if self.rtm_dtype == "int8" and self.dtype != "float32":
            raise ValueError("rtm_dtype='int8' requires dtype='float32'.")
        if self.fused_sweep not in ("auto", "on", "off"):
            raise ValueError("fused_sweep must be 'auto', 'on' or 'off'.")
        if self.divergence_recovery < 0:
            raise ValueError(
                "Attribute divergence_recovery must be >= 0 (0 disables "
                "the in-solve divergence guard)."
            )
        if self.divergence_threshold <= 1:
            raise ValueError(
                "Attribute divergence_threshold must be > 1 (a multiple "
                "of the measurement norm)."
            )
        if self.schedule_stride < 1:
            raise ValueError(
                "Attribute schedule_stride must be >= 1 (iterations "
                "between scheduler control returns)."
            )
        if self.sparse_rtm not in ("auto", "off"):
            try:
                eps = float(self.sparse_rtm)
            except ValueError:
                raise ValueError(
                    "Attribute sparse_rtm must be 'auto', 'off' or a "
                    "relative threshold in [0, 1), "
                    f"{self.sparse_rtm!r} given."
                ) from None
            if not (0.0 <= eps < 1.0) or not math.isfinite(eps):
                raise ValueError(
                    "Attribute sparse_rtm threshold must lie in [0, 1) "
                    f"(a fraction of max|H|), {self.sparse_rtm!r} given."
                )
        if self.sparse_rtm != "off" and self.fused_sweep == "on":
            raise ValueError(
                "Attribute sparse_rtm engages the block-sparse sweep, which "
                "picks its own kernel plan over the occupied columns; an "
                f"explicit fused_sweep='{self.fused_sweep}' cannot be "
                "honored there — use 'auto' or 'off'."
            )
        if self.lowrank_rtm not in ("auto", "off"):
            try:
                rank = int(self.lowrank_rtm)
            except ValueError:
                raise ValueError(
                    "Attribute lowrank_rtm must be 'auto', 'off' or a "
                    "positive integer factorization rank, "
                    f"{self.lowrank_rtm!r} given."
                ) from None
            if rank < 1:
                raise ValueError(
                    "Attribute lowrank_rtm rank must be >= 1, "
                    f"{self.lowrank_rtm!r} given."
                )
        if self.lowrank_rtm != "off" and self.fused_sweep == "on":
            raise ValueError(
                "Attribute lowrank_rtm engages the factored "
                "(S + U V^T) sweep, which replaces the Pallas kernel; "
                f"an explicit fused_sweep='{self.fused_sweep}' cannot "
                "be honored there — use 'auto' or 'off'."
            )
        if self.lowrank_rtm != "off" and self.sparse_explicit():
            raise ValueError(
                "Attributes lowrank_rtm and an explicit sparse_rtm "
                "threshold both claim the stored matrix: the factored "
                "backend already tile-thresholds its sparse core — "
                "drop one of the two."
            )
