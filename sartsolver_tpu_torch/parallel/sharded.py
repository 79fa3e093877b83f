"""Upload once, solve many frames: the solver object of the CLI's loops.

Counterpart of ``sartsolver_tpu/parallel/sharded.py``: the matrix is
uploaded once (:func:`~sartsolver_tpu_torch.models.sart.make_problem`),
then frames are solved in batches (:meth:`DistributedSARTSolver.solve_batch`),
in warm-started chains (:meth:`~DistributedSARTSolver.solve_chain`) or as
continuous-batching lanes (:meth:`~DistributedSARTSolver.sched_lanes` and
:meth:`~DistributedSARTSolver.sched_step`). It takes ``device=`` and, where
the JAX class takes a mesh, ``grid=``.

On a grid of ranks (``parallel/mesh.py:RankGrid``, more than one rank)
each rank's solver holds its padded block of the matrix, the block the JAX
mesh of the same shape puts on the device at the rank's coordinates
(:func:`grid_block`), the block's ``ShardedLaplacian`` (the halo
partition) and the ray stats reduced over the grid. Every rank calls each
solve with the same frames; the collectives sit in the solver core's seams
(``models/sart.py``), so statuses and iterations are equal on every rank.
A rank's frames are its pixel block (``local=True``: the caller hands only
the rank's rows, and the frames' max and ``||g||^2`` are combined over the
pixel axis); its vectors are its voxel block (:attr:`width`); a result's
solution is gathered over the voxel axis when the result is made, so the
writer's fetch is local. A grid runs the dense matrix through the classic
sweep and the batch and chain loops: what it refuses is
:func:`grid_refusal`'s, each with its words.

Frames arrive as host arrays in physical units and are normalized on the
host (:func:`~sartsolver_tpu_torch.models.sart.prepare_measurement`).
Results stay on the device: their scalars come back in one packed copy,
their solutions when fetched. Uploads are ``device.put`` trace spans and
fetches ``result.fetch{what=...}`` spans, as in the JAX module; each is
also a hang-watchdog beacon (``device.put``, ``result.fetch``), as is each
solve's entry (``solve.dispatch``).

With ``opts.integrity`` the solver keeps a snapshot of the ray stats taken
at upload: :meth:`DistributedSARTSolver.verify_ray_stats` holds it against
the ingest's sums, :meth:`DistributedSARTSolver.reaudit_ray_stats`
recomputes the stats from the resident matrix and compares bit for bit
(the reductions run in the same order on every call). The fault site
``device.buffer`` (kind ``corrupt``) perturbs the resident matrix in place
at a solve's entry, the stats left stale.

``tile_occupancy=`` (the ingest's block-sparse index, with
``opts.sparse_rtm``; for a host matrix without one the solver indexes the
matrix's fp32 values itself, as the JAX solver does) keeps only the occupied tile columns of the matrix on
the device (``models/sart.py:make_problem``, in place in the ingest's
buffer); the solver's vectors stay ``[V]``. The ``device.buffer``
corruption and the re-audit act on that matrix, the one the sweeps read.

``operator=`` (in place of ``rtm``) takes a projection operator
(``operators/``): a dense or tile-skip operator unwraps onto the matrix
path; the factored operator (``LowRankOperator``, ``H ~= S + U V^T``) stages
the occupied columns of its sparse core and its factors
(``models/sart.py:make_lowrank_problem``); the matrix-free one
(``ImplicitOperator``) stages the ``[P, 6]`` ray table
(``make_implicit_problem``), its products the hand-written projector on the
card. Their restrictions are the JAX solver's, each a ``SartInputError``
with its words (``sartsolver_tpu/parallel/sharded.py:710-935``); the port
has one device, so the mesh and multi-process refusals do not arise.

For the in-solve checkpoints (``--solve_ckpt_stride``),
:meth:`DistributedSARTSolver.export_sched_lanes` takes every field of the
lanes' :class:`~sartsolver_tpu_torch.models.sart.SchedState` to the host bit
for bit, beside the per-lane fp64 norms, under a signature of the solver's
configuration; :meth:`DistributedSARTSolver.restore_sched_lanes` stages such
a snapshot as live lanes, or refuses one whose signature differs.

Ordered subsets (``os_subsets > 1``) accept what the JAX solver accepts:
that solver pads the pixel rows to a multiple of ``ROW_ALIGN`` with zero
rows whose measurements are -1 (masked), and ``os_subsets`` must divide the
padded extent. Where it does not divide the pixel count itself, this solver
pads the same way (a zero row adds nothing to any product, sum or ray
stat, and a masked pixel nothing to a residual), so its subsets hold the
JAX subsets' rows; otherwise it uploads the matrix as given.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sartsolver_tpu_torch.config import MAX_ITERATIONS_EXCEEDED, SartInputError, SolverOptions
from sartsolver_tpu_torch.device import resolve_device
from sartsolver_tpu_torch.models.sart import (
    SchedState,
    SolveResult,
    _scatter_cols,
    compute_ray_stats,
    compute_ray_stats_int8,
    make_implicit_problem,
    make_lowrank_problem,
    make_problem,
    prepare_measurement,
    resolve_fused,
    sched_step_normalized,
    solve_chain_normalized,
    solve_normalized_batch,
    torch_dtype,
)
from sartsolver_tpu_torch.obs import trace as obs_trace
from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep
from sartsolver_tpu_torch.resilience import faults, watchdog


# the JAX solver's pixel-row alignment on one device
# (sartsolver_tpu/parallel/mesh.py:ROW_ALIGN)
ROW_ALIGN = 8


def os_padded_rows(npixel: int, os_subsets: int) -> int:
    """The pixel rows the solver holds: ``npixel``, or for ordered subsets
    that do not divide it the JAX solver's padded extent ``ceil(npixel /
    ROW_ALIGN) * ROW_ALIGN``. Raises ValueError, with the JAX solver's
    message, where ``os_subsets`` does not divide the padded extent (as the
    JAX solver does, even where it divides ``npixel``)."""
    if os_subsets <= 1:
        return npixel
    padded = -(-npixel // ROW_ALIGN) * ROW_ALIGN
    if padded % os_subsets:
        raise ValueError(
            f"os_subsets={os_subsets} must divide the (per-shard, padded) "
            f"pixel extent {padded}."
        )
    return npixel if npixel % os_subsets == 0 else padded


def grid_refusal(opts: SolverOptions, grid, *, operator=None, debug_nans: bool = False,
                 tile_occupancy=None, geometry: bool = False) -> Optional[str]:
    """Why a grid of ``grid.world > 1`` ranks cannot run these options
    (each refusal its own words), None where it can. The grid runs the
    dense stored matrix through the classic sweep; what decides per rank,
    or keeps state a rank cannot share, is refused rather than left to
    desynchronize the ranks' collectives."""
    if grid is None or grid.world <= 1:
        return None
    kind = getattr(operator, "kind", "dense")
    if kind == "implicit" or geometry:
        return ("Argument geometry is single-process: the implicit operator's rays "
                "are staged whole per host; drop --multihost or materialize the matrix.")
    if kind == "lowrank":
        return ("Argument lowrank_rtm factors the whole matrix in one process; a grid "
                "of more than one rank runs the dense matrix — drop --lowrank_rtm or "
                "run one rank.")
    # an explicit rank or threshold refuses with the JAX ingest gates' words
    # at the grid's process count; 'auto' declines there (a warning) and the
    # grid runs the dense matrix
    if opts.lowrank_explicit():
        from sartsolver_tpu_torch.operators.lowrank import lowrank_static_decline_reason

        reason = lowrank_static_decline_reason(opts, grid.world, n_voxel_shards=grid.n_vox)
        return f"Argument lowrank_rtm={opts.lowrank_rtm}: {reason}."
    if tile_occupancy is not None:
        return (f"Argument sparse_rtm={opts.sparse_rtm}: the block-sparse tile skip "
                "runs on one rank; a grid of more than one rank runs the dense "
                "matrix — use --sparse_rtm off or one rank.")
    if opts.sparse_explicit():
        from sartsolver_tpu_torch.ops.sparse import static_decline_reason

        return f"Argument sparse_rtm={opts.sparse_rtm}: {static_decline_reason(opts, grid.world)}."
    if opts.os_subsets > 1:
        return (f"Argument os_subsets={opts.os_subsets} runs the subset cycle on one "
                "rank; a grid of more than one rank runs the classic sweep "
                "(--os_subsets 1).")
    if opts.integrity:
        return ("Argument integrity escalates per rank (re-solve, re-audit, "
                "quarantine), which would desynchronize a grid's collectives; drop "
                "--integrity or run one rank.")
    if debug_nans:
        return ("Argument debug_nans aborts the rank that sees a NaN, leaving its "
                "peers waiting in a collective; drop --debug_nans or run one rank.")
    if opts.rtm_dtype == "int8" and grid.n_pix > 1:
        # the JAX package's words (sartsolver_tpu/parallel/multihost.py:160-169)
        return ("rtm_dtype='int8' across processes needs a voxel-major mesh "
                "(pixel axis unsharded) so per-column maxima stay process-local; "
                "use --voxel_shards N (pixels=1) or fp32/bfloat16 storage.")
    return None


def grid_loop_refusal(what: str) -> str:
    """Why ``what`` (a loop or a state the grid does not share) is refused
    on a grid of more than one rank."""
    return (f"{what} runs on one rank; a grid of ranks runs the classic grouped loop "
            "(solve_batch, solve_chain).")


def grid_block(host: np.ndarray, grid, npixel: int, nvoxel: int) -> np.ndarray:
    """``grid``'s rank's padded block of the full matrix ``host`` ``[npixel,
    nvoxel]`` (zero in the padding): the block the JAX mesh of the same
    shape puts on the device at the rank's coordinates
    (``sartsolver_tpu/parallel/sharded.py:431-432``)."""
    rb, cb = grid.blocks(npixel, nvoxel)
    p, v = grid.coords
    part = host[p * rb:(p + 1) * rb, v * cb:(v + 1) * cb]
    block = np.zeros((rb, cb), host.dtype)
    block[:part.shape[0], :part.shape[1]] = part
    return block


def _pad_rows(rtm, rows: int):
    """``rtm`` [P, V] (a host array or a tensor) with zero rows appended up
    to ``rows``."""
    extra = rows - rtm.shape[0]
    if isinstance(rtm, torch.Tensor):
        return torch.cat([rtm, rtm.new_zeros((extra, rtm.shape[1]))])
    rtm = np.asarray(rtm)
    return np.concatenate([rtm, np.zeros((extra, rtm.shape[1]), rtm.dtype)])


class DeviceSolveResult:
    """Batch result whose solution stays on the device.

    ``solution_norm`` [B, V] is the normalized solution (the next chain's
    warm start, never visiting the host) and ``fitted_norm`` its loop-exit
    ``H @ solution``; status, iterations and convergence come back in one
    packed device-to-host copy on first access, the solutions in one more
    (:meth:`fetch_solutions`), denormalized on the host in fp64. On a grid
    ``solution_norm`` and ``fitted_norm`` are the rank's blocks, and
    ``full`` [B, nvoxel] the solution gathered over the voxel axis when the
    result was made (on the main thread: the writer's fetch is then a local
    copy and runs no collective).
    """

    def __init__(self, res: SolveResult, norms, fitted_norm: torch.Tensor,
                 full: Optional[torch.Tensor] = None):
        self.solution_norm = res.solution
        self.fitted_norm = fitted_norm
        self.full = res.solution if full is None else full
        self.norms = np.asarray(norms, np.float64)  # [B]
        # fp64 holds the int32 counts and either compute dtype exactly
        self._packed = torch.stack([res.status.double(), res.iterations.double(),
                                    res.convergence.double()])
        self._scalars: Optional[tuple] = None
        self._host: Optional[np.ndarray] = None

    def _fetch_scalars(self) -> tuple:
        if self._scalars is None:
            watchdog.beacon(watchdog.PHASE_FETCH)
            with obs_trace.span("result.fetch", what="scalars"):
                packed = self._packed.cpu().numpy()
            self._scalars = (packed[0].astype(np.int32), packed[1].astype(np.int32),
                             packed[2])
        return self._scalars

    @property
    def status(self) -> np.ndarray:
        return self._fetch_scalars()[0]

    @property
    def iterations(self) -> np.ndarray:
        return self._fetch_scalars()[1]

    @property
    def convergence(self) -> np.ndarray:
        return self._fetch_scalars()[2]

    def fetch_solutions(self) -> np.ndarray:
        """[B, V] fp64 solutions in physical units; one copy, cached."""
        if self._host is None:
            watchdog.beacon(watchdog.PHASE_FETCH)
            with obs_trace.span("result.fetch", what="solution"):
                sol = self.full.double().cpu().numpy()
            self._host = sol * self.norms[:, None]
        return self._host


class SchedLaneState:
    """Host handle of the continuous-batching lanes: the device
    :class:`~sartsolver_tpu_torch.models.sart.SchedState` plus what the device
    does not carry, each occupant's fp64 measurement norm.

    Made by :meth:`DistributedSARTSolver.sched_lanes`, advanced by
    :meth:`DistributedSARTSolver.sched_step`; the scheduler (``sched/``)
    decides retirement and backfill on top.
    """

    def __init__(self, state: SchedState, lanes: int):
        self.state = state
        self.lanes = int(lanes)
        self.norms = np.ones(self.lanes, np.float64)  # per-lane occupant norm
        self._scalars: Optional[tuple] = None

    def scalars(self):
        """``(done bool[B], status int32[B], iters int32[B], conv f64[B],
        it int32[B])``: one packed device-to-host copy per stride, cached
        until the next step."""
        if self._scalars is None:
            st = self.state
            watchdog.beacon(watchdog.PHASE_FETCH)
            with obs_trace.span("result.fetch", what="sched_scalars"):
                packed = torch.stack([st.done.double(), st.status.double(),
                                      st.iters.double(), st.conv.double(),
                                      st.it.double()]).cpu().numpy()
            self._scalars = (packed[0] > 0.5, packed[1].astype(np.int32),
                             packed[2].astype(np.int32), packed[3],
                             packed[4].astype(np.int32))
        return self._scalars

    def lane_solution_fetcher(self, b: int):
        """Zero-argument callable resolving lane ``b``'s solution in physical
        units. The row and its norm are taken now: the next backfill puts
        another frame in the lane."""
        row = self.state.f[b].clone()
        norm = float(self.norms[b])

        def fetch():
            watchdog.beacon(watchdog.PHASE_FETCH)
            with obs_trace.span("result.fetch", what="sched_lane"):
                return row.double().cpu().numpy() * norm
        return fetch


class DistributedSARTSolver:
    """Upload-once, solve-many-frames solver on one device.

    ``rtm`` [P, V] is a host array or a tensor, stored as
    ``opts.rtm_dtype`` (int8: quantized where it lies, or already int8
    codes with their scales ``rtm_scale`` [V]); a tensor already on
    ``device`` in the stored dtype (the chunked ingest's,
    ``parallel/multihost.py``) is used as it is (with ``tile_occupancy``,
    the block-sparse index, compacted in place to its occupied columns).
    ``npixel`` (default the
    matrix's rows) is the pixel count of a matrix that already holds the
    ordered-subsets padding rows. ``laplacian`` a
    :class:`~sartsolver_tpu_torch.ops.laplacian.LaplacianCOO` on ``device``.
    On the card the fused sweep's CUDA extension is built (if needed) and
    loaded here, so an extension that fails to build or load fails the
    construction and never a frame's dispatch. :meth:`close` (or leaving a
    ``with`` block) releases the device copy of the matrix.
    ``debug_nans=True``: every solve raises ``FloatingPointError`` at the
    first NaN it keeps (``debug_nans.py``).

    ``grid=`` (a ``parallel/mesh.py:RankGrid`` of more than one rank) makes
    this rank's solver one of the grid's (module docstring): every rank of
    the grid constructs it and calls each solve, with the same arguments.
    ``rtm`` is then the full host matrix, or (with ``npixel`` and
    ``nvoxel`` given) this rank's padded block from the striped ingest.

    Named fault sites (``resilience/faults.py``): ``solve.dispatch`` and
    ``device.buffer`` at the entry of every solve and scheduler stride,
    ``device.put`` where a frame group or a stride's refills are staged.
    """

    def __init__(self, rtm=None, laplacian=None, *, opts: SolverOptions, device="cuda",
                 debug_nans: bool = False, rtm_scale=None,
                 npixel: Optional[int] = None, tile_occupancy=None, operator=None,
                 grid=None, nvoxel: Optional[int] = None):
        self.device = resolve_device(device)
        self.opts = opts
        self.debug_nans = debug_nans
        self.dtype = torch_dtype(opts.dtype)
        self.operator_kind = "dense"
        # the fused sweep's implementation: the kernel's wrapper; the plain
        # version only where a check holds the two against each other
        # (utils/fused_parity.py, chip_smoke.py)
        self.sweep_fn = fused_sweep
        self.grid = grid if grid is not None and grid.world > 1 else None
        if self.grid is not None:
            self._init_grid(rtm, laplacian, operator, rtm_scale, npixel, nvoxel,
                            tile_occupancy)
            return
        if operator is not None:
            if rtm is not None:
                raise ValueError("Pass either a matrix (rtm) or operator=, not both.")
            if operator.kind in ("implicit", "lowrank"):
                self._init_operator(operator, laplacian)
                return
            # a dense or tile-skip operator: its matrix, and its index
            if tile_occupancy is None:
                tile_occupancy = operator.tile_occupancy()
            rtm = operator.payload()
        elif rtm is None:
            raise ValueError("DistributedSARTSolver needs a matrix (rtm) or operator=.")
        held = np.shape(rtm)[0]
        npixel = held if npixel is None else int(npixel)
        # the rows the device holds: npixel, or the OS cycle's padded extent
        self.rows = os_padded_rows(npixel, opts.os_subsets)
        if held == npixel and self.rows != npixel:
            rtm = _pad_rows(rtm, self.rows)
        elif held != self.rows:
            raise ValueError(f"rtm of {held} rows for {npixel} pixels: {self.rows} "
                             "rows expected.")
        if (tile_occupancy is None and opts.sparse_epsilon() is not None
                and not isinstance(rtm, torch.Tensor)):
            # a host matrix: its index of the fp32 values, on the padded
            # grid the ingest's index covers, a band of rows at a time
            from sartsolver_tpu_torch.ops.sparse import accumulate_tile_max
            from sartsolver_tpu_torch.parallel.multihost import make_tile_stats

            host = np.asarray(rtm)
            tile_occupancy = accumulate_tile_max(
                make_tile_stats(npixel, host.shape[1]),
                host if host.dtype == np.float32 else host.astype(np.float32),
            ).occupancy(opts.sparse_epsilon())
        if laplacian is not None:
            # the Laplacian's staging, a device.put of the JAX solver's
            # construction (a hang here aborts the run, outside any frame)
            watchdog.beacon(watchdog.PHASE_STAGE)
            faults.fire(faults.SITE_DEVICE_PUT)
        with obs_trace.span("device.put"):
            self.problem = make_problem(rtm, laplacian, opts=opts, device=self.device,
                                        rtm_scale=rtm_scale, tile_occupancy=tile_occupancy)
            if self.device.type == "cuda" and (resolve_fused(opts)
                                               or self.problem.occupancy is not None):
                from sartsolver_tpu_torch.ops import _build

                _build.load("fused_sweep")
        self.npixel, self.nvoxel = npixel, self.problem.ray_density.shape[0]
        # the integrity layer's upload-time ray stats (host copies)
        self._ray_stats_snapshot = self._ray_stats_now() if opts.integrity else None

    def _init_grid(self, rtm, laplacian, operator, rtm_scale, npixel, nvoxel,
                   tile_occupancy) -> None:
        """This rank's share of a grid's solver: the refusals, the padded
        block staged (sliced from a full host matrix, or handed over as the
        striped ingest's block), the block's halo Laplacian and the ray
        stats reduced over the grid (``sartsolver_tpu/parallel/sharded.py:
        431-432, 642``)."""
        from sartsolver_tpu_torch.ops.laplacian import shard_laplacian_halo
        from sartsolver_tpu_torch.parallel.mesh import padded_extents

        opts, grid = self.opts, self.grid
        refusal = grid_refusal(opts, grid, operator=operator, debug_nans=self.debug_nans,
                               tile_occupancy=tile_occupancy)
        if refusal:
            raise SartInputError(refusal)
        if rtm is None:
            raise ValueError("DistributedSARTSolver needs a matrix (rtm) or operator=.")
        self.npixel = int(np.shape(rtm)[0] if npixel is None else npixel)
        self.nvoxel = int(np.shape(rtm)[1] if nvoxel is None else nvoxel)
        self.padded_npixel, self.padded_nvoxel = padded_extents(
            self.npixel, self.nvoxel, grid.n_pix, grid.n_vox)
        self.rows, self.cols_held = grid.blocks(self.npixel, self.nvoxel)
        v = grid.coords[1]
        if nvoxel is not None and tuple(np.shape(rtm)) == (self.rows, self.cols_held):
            block = rtm  # the striped ingest's padded block
            if opts.rtm_dtype == "int8" and rtm_scale is None:
                raise ValueError("An int8 block needs its scales (rtm_scale).")
        else:
            if tuple(np.shape(rtm)) != (self.npixel, self.nvoxel):
                raise ValueError(
                    f"rtm of shape {tuple(np.shape(rtm))}: the full [{self.npixel}, "
                    f"{self.nvoxel}] matrix or this rank's [{self.rows}, "
                    f"{self.cols_held}] block expected.")
            host = np.asarray(rtm.cpu() if isinstance(rtm, torch.Tensor) else rtm)
            block = grid_block(host, grid, self.npixel, self.nvoxel)
            if rtm_scale is not None:  # codes given whole: the block's scales
                c0 = v * self.cols_held
                part = np.asarray(rtm_scale, np.float32)[c0:c0 + self.cols_held]
                rtm_scale = np.ones(self.cols_held, np.float32)
                rtm_scale[:len(part)] = part
        lap = None
        if laplacian is not None:
            watchdog.beacon(watchdog.PHASE_STAGE)
            faults.fire(faults.SITE_DEVICE_PUT)
            lap = shard_laplacian_halo(laplacian, grid.n_vox, self.cols_held, v,
                                       dtype=self.dtype, device=self.device)
        with obs_trace.span("device.put"):
            self.problem = make_problem(block, lap, opts=opts, device=self.device,
                                        rtm_scale=rtm_scale, grid=grid)
            if self.device.type == "cuda" and resolve_fused(opts):
                from sartsolver_tpu_torch.ops import _build

                _build.load("fused_sweep")
        self._ray_stats_snapshot = None

    def _init_operator(self, operator, laplacian) -> None:
        """The factored or the matrix-free operator's construction, behind
        the JAX solver's restrictions (``_init_lowrank``, ``_init_implicit``):
        the rows padded with zero rows (inert) where the ordered subsets
        need it, the problem staged, its ray stats those of the products
        the sweeps run."""
        opts = self.opts
        implicit = operator.kind == "implicit"
        if implicit:
            if opts.rtm_dtype == "int8":
                raise SartInputError(
                    "rtm_dtype='int8' quantizes a materialized matrix; the "
                    "implicit (matrix-free) operator has none — drop "
                    "--rtm_dtype int8 or materialize the matrix.")
            if opts.integrity:
                raise SartInputError(
                    "integrity=True re-audits a resident matrix; the "
                    "implicit (matrix-free) operator holds none — drop "
                    "--integrity or materialize the matrix.")
            if opts.sparse_epsilon() is not None and opts.sparse_explicit():
                raise SartInputError(
                    f"Argument sparse_rtm={opts.sparse_rtm}: the block-"
                    "sparse tile skip indexes a materialized matrix; the "
                    "implicit (matrix-free) operator has none.")
            if opts.fused_sweep in ("on", "interpret"):
                raise SartInputError(
                    f"fused_sweep='{opts.fused_sweep}' forces the Pallas "
                    "matrix sweep, which needs a materialized matrix; the "
                    "implicit operator traces its own panel loop — use "
                    "fused_sweep='auto' or 'off'.")
            if laplacian is not None:
                raise SartInputError(
                    "beta_laplace smoothing is not supported by the "
                    "implicit (matrix-free) operator.")
        else:
            if opts.integrity:
                raise SartInputError(
                    "integrity=True certifies a single stored-matrix "
                    "contraction; the factored (lowrank) operator composes "
                    "S + U V^T products — drop --integrity or materialize "
                    "the matrix.")
            if opts.sparse_epsilon() is not None and opts.sparse_explicit():
                raise SartInputError(
                    f"Argument sparse_rtm={opts.sparse_rtm}: the factored "
                    "(lowrank) operator already tile-thresholds its sparse "
                    "core — drop the explicit threshold.")
            if opts.fused_sweep in ("on", "interpret"):
                raise SartInputError(
                    f"fused_sweep='{opts.fused_sweep}' forces the Pallas "
                    "matrix sweep; the factored (lowrank) operator traces "
                    "its own composed sweep — use fused_sweep='auto' or "
                    "'off'.")
            if laplacian is not None:
                raise SartInputError(
                    "beta_laplace smoothing is not supported by the "
                    "factored (lowrank) operator.")
        self.operator_kind = operator.kind
        self.npixel, self.nvoxel = int(operator.npixel), int(operator.nvoxel)
        self.rows = os_padded_rows(self.npixel, opts.os_subsets)
        with obs_trace.span("device.put"):
            if implicit:
                from sartsolver_tpu_torch.operators.implicit import divisor_panel

                rays = operator.payload()
                if self.rows != self.npixel:
                    rays = _pad_rows(rays, self.rows)
                spec = operator.spec(padded_nvoxel=self.nvoxel,
                                     panel_voxels=divisor_panel(self.nvoxel))
                if self.device.type == "cuda":
                    from sartsolver_tpu_torch.ops import _build

                    _build.load("implicit")
                self.problem = make_implicit_problem(rays, spec, opts=opts,
                                                     device=self.device)
            else:
                S = operator.payload()
                u, v = operator.factors()
                if self.rows != self.npixel:
                    S, u = _pad_rows(S, self.rows), _pad_rows(u, self.rows)
                self.problem = make_lowrank_problem(
                    S, u, v, operator.solver_spec(), opts=opts, device=self.device,
                    occupancy=operator.tile_occupancy())
        self._ray_stats_snapshot = None

    # ---- numerical integrity ---------------------------------------------

    def _ray_stats_now(self):
        """``(rho [V], lambda [rows])`` of the resident matrix on the host,
        by the functions the upload used (deterministic reductions)."""
        problem = self._live_problem()
        dtype = torch_dtype(self.opts.dtype)
        if problem.rtm_scale is not None:
            dens, length = compute_ray_stats_int8(problem.rtm, problem.rtm_scale,
                                                  dtype=dtype)
        else:
            dens, length = compute_ray_stats(problem.rtm, dtype=dtype)
        dens = _scatter_cols(dens, problem.cols, problem.ray_density.shape[0])
        return dens.cpu().numpy().copy(), length.cpu().numpy().copy()

    # the bit of a float element a device.buffer corruption flips: its
    # exponent's top bit
    _EXPONENT_TOP_BIT = {torch.float32: (torch.int32, 30), torch.bfloat16: (torch.int16, 14),
                         torch.float64: (torch.int64, 62)}

    def _maybe_corrupt_resident(self) -> None:
        """The ``device.buffer`` corrupt fault: a trip changes element [0, 0]
        of the resident matrix in place while the ray stats stay those of
        the upload — resident bit rot, which the ABFT check and the
        re-audit exist to catch. int8 codes become ``127 - code`` (the JAX
        package's); a float element has its exponent's top bit flipped, as
        a single-event upset would. (The JAX package's float recipe, ``x *
        256 + 1``, moves ``sum(H f)`` of the e2e world, 8192 x 65536, by
        about 6e-6 of itself, under the check's band of 2.1e-3: there only
        the re-audit sees it.) One dict lookup when nothing is armed."""
        if not faults.take_corrupt(faults.SITE_DEVICE_BUFFER):
            return
        rtm = self._live_problem().rtm
        if rtm.numel() == 0:
            return
        if rtm.dtype == torch.int8:
            rtm[0, 0] = 127 - rtm[0, 0]
        else:
            itype, bit = self._EXPONENT_TOP_BIT[rtm.dtype]
            rtm[0:1, 0:1].view(itype).bitwise_xor_(1 << bit)

    def verify_ray_stats(self, ingest_stats) -> list:
        """The upload-time rho/lambda against the ingest's sums
        (:class:`~sartsolver_tpu_torch.resilience.integrity.IngestStats`):
        a description of each mismatch, empty where they agree. Needs
        ``opts.integrity``."""
        from sartsolver_tpu_torch.resilience import integrity

        if self._ray_stats_snapshot is None:
            raise ValueError("verify_ray_stats needs SolverOptions.integrity=True (the "
                             "upload-time rho/lambda snapshot is not kept otherwise).")
        dens, length = self._ray_stats_snapshot
        return integrity.verify_ray_stats(ingest_stats, dens[:self.nvoxel],
                                          length[:self.npixel],
                                          rtm_dtype=self.opts.rtm_dtype)

    def reaudit_ray_stats(self) -> list:
        """rho/lambda recomputed from the resident matrix against the
        upload-time snapshot, bit for bit: any difference is resident bit
        rot. A description of each mismatch, empty where clean. One pass
        over the matrix; needs ``opts.integrity``."""
        if self._ray_stats_snapshot is None:
            raise ValueError("reaudit_ray_stats needs SolverOptions.integrity=True.")
        out = []
        for name, now, ref in zip(("ray_density", "ray_length"), self._ray_stats_now(),
                                  self._ray_stats_snapshot):
            if not np.array_equal(now, ref):
                diff = np.flatnonzero(now != ref)
                out.append(f"{name}: {diff.size} element(s) changed since upload "
                           f"(first at index {int(diff[0])})")
        return out

    @property
    def tile_occupancy(self):
        """The block-sparse index the solver runs on, None where it runs
        dense (sparse off, or 'auto' declined)."""
        return self._live_problem().occupancy

    def close(self) -> None:
        """Release the device copy of the problem; results stay valid."""
        self.problem = None

    def __enter__(self) -> "DistributedSARTSolver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _live_problem(self):
        if self.problem is None:
            raise ValueError(
                "This solver has been closed (close() released its device "
                "memory); build a new DistributedSARTSolver."
            )
        return self.problem

    @property
    def grid_shape(self) -> tuple:
        """``(pixel shards, voxel shards)`` of the solver's grid."""
        return (1, 1) if self.grid is None else self.grid.shape

    @property
    def width(self) -> int:
        """The voxel columns this solver's vectors hold: ``nvoxel``, or on a
        grid the rank's padded block of them."""
        return self.nvoxel if self.grid is None else self.cols_held

    def local_pixel_range(self):
        """``(offset, count)`` of the logical pixel rows this rank holds
        (``parallel/multihost.py:process_pixel_range``)."""
        from sartsolver_tpu_torch.parallel.multihost import process_pixel_range

        return process_pixel_range(self.grid, self.npixel)

    def _stage_frames(self, measurements, local: bool = False):
        """Normalize B host frames as prepare_measurement does: ``(g [B,
        rows], msq [B])`` on the device and the norms [B] on the host. On a
        grid ``g`` is the rank's pixel block. ``local=True`` (a grid only):
        ``measurements`` hold just the rank's logical rows
        (:meth:`local_pixel_range`); the max and the masked ``||g||^2`` of
        each frame are combined over the grid's pixel axis, in rank order
        (``sartsolver_tpu/parallel/sharded.py:1243-1303``)."""
        G = np.asarray(measurements, np.float64)
        want = self.local_pixel_range()[1] if local else self.npixel
        if local and self.grid is None:
            raise ValueError("local measurement staging needs a grid of ranks.")
        if G.ndim != 2 or G.shape[1] != want:
            raise ValueError(f"Measurements must be [B, {want}], got {G.shape}.")
        if local:
            gs, msqs, norms = self._local_norms(G)
        else:
            gs, msqs, norms = zip(*(prepare_measurement(row, self.opts) for row in G))
            gs = self._pad_frames(np.stack(gs))
        watchdog.beacon(watchdog.PHASE_STAGE)
        faults.fire(faults.SITE_DEVICE_PUT)
        with obs_trace.span("device.put"):
            g = torch.as_tensor(gs, device=self.device).to(self.dtype)
            msq = torch.as_tensor(np.asarray(msqs), device=self.device).to(self.dtype)
        return g, msq, np.asarray(norms, np.float64)

    def _local_norms(self, G: np.ndarray):
        """``(g [B, rows], msq [B], norm [B])`` of frames of which this rank
        holds its logical rows ``G``: prepare_measurement's norm (the finite
        maximum) and masked ``||g||^2``, each combined over the pixel axis."""
        from sartsolver_tpu_torch.parallel import comm
        from sartsolver_tpu_torch.parallel.mesh import PIXEL_AXIS

        lmax = np.where(np.isfinite(G), G, 0.0).max(axis=1, initial=0.0)
        lsum = np.sum(np.where(G > 0, G, 0.0) ** 2, axis=1)
        gmax = comm.all_reduce_max(torch.as_tensor(lmax), PIXEL_AXIS, self.grid).numpy()
        gsum = comm.all_reduce_sum(torch.as_tensor(lsum), PIXEL_AXIS, self.grid).numpy()
        norms = np.where(gmax > 0, gmax, 1.0) if self.opts.normalize else np.ones(len(G))
        msqs = gsum / norms ** 2
        msqs = np.where(msqs > 0, msqs, 1.0)
        g = np.full((G.shape[0], self.rows), -1.0)
        g[:, :G.shape[1]] = G / norms[:, None]
        return g, msqs, norms

    def _pad_frames(self, g: np.ndarray) -> np.ndarray:
        """Normalized frames [B, npixel] with the padded rows' -1 (masked);
        on a grid, the rank's block of rows of them."""
        if self.grid is not None:
            full = np.full((g.shape[0], self.padded_npixel), -1.0)
            full[:, :self.npixel] = g
            r0 = self.grid.coords[0] * self.rows
            return full[:, r0:r0 + self.rows]
        if self.rows == self.npixel:
            return g
        return np.concatenate([g, np.full((g.shape[0], self.rows - self.npixel), -1.0)],
                              axis=1)

    def _result(self, res: SolveResult, norms, fitted: torch.Tensor) -> DeviceSolveResult:
        """The device result; on a grid with the solution gathered over the
        voxel axis (every rank, here on the main thread)."""
        full = None
        if self.grid is not None:
            from sartsolver_tpu_torch.parallel import comm
            from sartsolver_tpu_torch.parallel.mesh import VOXEL_AXIS

            full = comm.all_gather(res.solution, VOXEL_AXIS, self.grid, dim=1)[:, :self.nvoxel]
        return DeviceSolveResult(res, norms, fitted_norm=fitted, full=full)

    def _no_grid(self, what: str) -> None:
        if self.grid is not None:
            raise ValueError(grid_loop_refusal(what))

    def _enter(self):
        """A solve's entry: the dispatch beacon, the ``solve.dispatch`` and
        ``device.buffer`` sites; the live problem."""
        watchdog.beacon(watchdog.PHASE_DISPATCH)
        faults.fire(faults.SITE_SOLVE)
        self._maybe_corrupt_resident()
        return self._live_problem()

    def _host_seed(self, f0, norms: np.ndarray) -> torch.Tensor:
        """Host seeds ``f0`` [B, V] in physical units, normalized by each
        frame's norm, on the device (on a grid the rank's columns, zero in
        the padding)."""
        f0 = np.asarray(f0, np.float64).reshape(len(norms), -1)
        if f0.shape[1] != self.nvoxel:
            raise ValueError(f"f0 must be [B, {self.nvoxel}], got {f0.shape}.")
        seed = f0 / norms[:, None]
        if self.grid is not None:
            full = np.zeros((len(norms), self.padded_nvoxel))
            full[:, :self.nvoxel] = seed
            c0 = self.grid.coords[1] * self.cols_held
            seed = full[:, c0:c0 + self.cols_held]
        return torch.as_tensor(seed, device=self.device).to(self.dtype)

    def solve_batch(self, measurements, f0=None, *, local: bool = False) -> DeviceSolveResult:
        """Solve B independent frames [B, P] in one batched loop, each from
        the Eq. 4 guess, or from the host seeds ``f0`` [B, V] in physical
        units (a resumed run's warm start). The caller pads a short tail if
        it wants a fixed batch size. ``local``: see :meth:`_stage_frames`."""
        problem = self._enter()
        g, msq, norms = self._stage_frames(measurements, local)
        if f0 is None:
            seed = torch.zeros((g.shape[0], self.width), dtype=self.dtype,
                               device=self.device)
        else:
            seed = self._host_seed(f0, norms)
        res, fitted = solve_normalized_batch(
            problem, g, msq, seed, opts=self.opts, use_guess=f0 is None,
            return_fitted=True, device=self.device, debug_nans=self.debug_nans,
            sweep_fn=self.sweep_fn,
        )
        return self._result(res, norms, fitted)

    def solve_chain(self, measurements, f0=None, *,
                    warm: Optional[DeviceSolveResult] = None,
                    local: bool = False) -> DeviceSolveResult:
        """Solve K warm-chained frames [K, P]: each frame from the previous
        one's solution. Frame 0 seeds from ``warm`` (a previous result of
        this solver: its last frame's solution and loop-exit ``fitted``,
        still on the device), else from the host seed ``f0`` [V] in
        physical units (a resumed run's last row; its projection is taken
        anew), else from the Eq. 4 guess. Per frame equal to K serial
        solves. ``warm`` and ``f0`` together raise ``ValueError``."""
        if warm is not None and f0 is not None:
            raise ValueError("Pass either warm= (device) or f0= (host), not both.")
        problem = self._enter()
        g, msq, norms = self._stage_frames(measurements, local)
        rescale = np.ones(len(norms))
        rescale[1:] = norms[:-1] / norms[1:]
        if f0 is not None:
            seed, fitted0 = self._host_seed(f0, norms[:1]), None
        elif warm is None:
            seed = torch.zeros((1, self.width), dtype=self.dtype, device=self.device)
            fitted0 = None
        else:
            rescale[0] = warm.norms[-1] / norms[0]
            seed, fitted0 = warm.solution_norm[-1:], warm.fitted_norm[-1:]
        res, fitted = solve_chain_normalized(
            problem, g, msq, seed, torch.as_tensor(rescale, device=self.device),
            opts=self.opts, use_guess_first=warm is None and f0 is None, fitted0=fitted0,
            device=self.device, debug_nans=self.debug_nans, sweep_fn=self.sweep_fn,
        )
        return self._result(res, norms, fitted)

    def solve(self, measurement, f0=None) -> SolveResult:
        """One frame [P], the B = 1 case of :meth:`solve_batch`: the
        solution [V] fp64 in physical units on the host, and the status,
        iterations and convergence as Python numbers."""
        res = self.solve_batch(np.asarray(measurement)[None, :],
                               None if f0 is None else np.asarray(f0)[None, :])
        return SolveResult(res.fetch_solutions()[0], int(res.status[0]),
                           int(res.iterations[0]), float(res.convergence[0]))

    # ---- continuous batching (sched/) -----------------------------------

    def sched_lanes(self, lanes: int) -> SchedLaneState:
        """Fresh, all-inert lane state for :meth:`sched_step`: ``g = -1``
        (every pixel masked), ``f = 1`` (log-safe), ``msq = 1``, done; with
        the guard, step scale 1 and no recovery spent; with momentum, ``f_prev
        = 1`` (the inert iterate), ``fitted_prev = 0`` (the linear classic
        sweep only) and ``t = 1``. The log variant's ``obs`` is ``[B, os,
        V]`` with ordered subsets, else ``[B, V]``."""
        self._live_problem()
        self._no_grid("the continuous-batching scheduler")
        B = int(lanes)
        if B < 1:
            raise ValueError("Lane count must be positive.")
        kw = dict(dtype=self.dtype, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        n_os = self.opts.os_subsets
        obs_shape = (B, n_os, self.nvoxel) if n_os > 1 else (B, self.nvoxel)
        state = SchedState(
            g=torch.full((B, self.rows), -1.0, **kw),
            msq=torch.ones(B, **kw),
            f=torch.ones((B, self.nvoxel), **kw),
            fitted=torch.zeros((B, self.rows), **kw),
            conv=torch.zeros(B, **kw),
            it=torch.zeros(B, **i32),
            done=torch.ones(B, dtype=torch.bool, device=self.device),
            status=torch.full((B,), MAX_ITERATIONS_EXCEEDED, **i32),
            iters=torch.zeros(B, **i32),
            obs=torch.zeros(obs_shape, **kw) if self.opts.logarithmic else None,
        )
        if self.opts.divergence_recovery:
            state = state._replace(ascale=torch.ones(B, **kw), recov=torch.zeros(B, **i32))
        if self.opts.momentum != "off":
            state = state._replace(
                f_prev=torch.ones((B, self.nvoxel), **kw), tk=torch.ones(B, **kw),
                fitted_prev=(None if self.opts.logarithmic or n_os > 1
                             else torch.zeros((B, self.rows), **kw)))
        return SchedLaneState(state, B)

    def sched_step(self, lane_state: SchedLaneState, refills) -> None:
        """Advance the lanes one stride. ``refills`` is a list of ``(lane,
        measurement)`` pairs, full frames [P] in physical units, normalized
        as :meth:`solve_batch` normalizes them and loaded before the stride
        runs; an empty list is a pure drain stride. The new state is
        committed only after the stride ran: a failed dispatch leaves the
        previous state intact."""
        problem = self._enter()
        B = lane_state.lanes
        norms = lane_state.norms.copy()
        refill = np.zeros(B, bool)
        g_new = msq_new = None
        if refills:
            g_stage = np.full((B, self.rows), -1.0)
            msq_stage = np.ones(B)
            for b, meas in refills:
                meas = np.asarray(meas, np.float64)
                if meas.shape != (self.npixel,):
                    raise ValueError(f"Refill measurement for lane {b} has shape "
                                     f"{meas.shape}, expected ({self.npixel},).")
                if refill[b]:
                    raise ValueError(f"Lane {b} refilled twice in one stride.")
                g_stage[b, :self.npixel], msq_stage[b], norms[b] = prepare_measurement(
                    meas, self.opts)
                refill[b] = True
            watchdog.beacon(watchdog.PHASE_STAGE)
            faults.fire(faults.SITE_DEVICE_PUT)
            with obs_trace.span("device.put"):
                g_new = torch.as_tensor(g_stage, device=self.device).to(self.dtype)
                msq_new = torch.as_tensor(msq_stage, device=self.device).to(self.dtype)
        new_state = sched_step_normalized(
            problem, lane_state.state, g_new, msq_new, refill, opts=self.opts,
            device=self.device, debug_nans=self.debug_nans,
        )
        lane_state.state = new_state
        lane_state.norms = norms
        lane_state._scalars = None

    # ---- in-solve checkpoints (resilience/podckpt.py) ----------------------

    def _sched_ckpt_sig(self) -> str:
        """The configuration signature stored in a solve checkpoint
        (``sartsolver_tpu/parallel/sharded.py:_sched_ckpt_sig``, naming this
        package): a resume under other solver knobs would restore lane state
        whose meaning changed (dtype, storage, momentum carries, subset
        stacking, the held shapes), so the restore refuses instead."""
        opts = self.opts
        return "|".join(str(v) for v in (
            "torch", opts.dtype, opts.rtm_dtype, opts.momentum, int(opts.logarithmic),
            opts.os_subsets, opts.schedule_stride, int(opts.divergence_recovery > 0),
            self.rows, self.nvoxel,
        ))

    def export_sched_lanes(self, lane_state: SchedLaneState) -> dict:
        """Host snapshot of the lanes for a solve checkpoint: every
        ``SchedState`` field copied to the host bit for bit (None where its
        variant is off), the per-lane fp64 norms and the signature."""
        st = lane_state.state
        return {
            "sig": self._sched_ckpt_sig(),
            "lanes": int(lane_state.lanes),
            "norms": np.asarray(lane_state.norms, np.float64).copy(),
            "state": {name: (None if getattr(st, name) is None
                             else getattr(st, name).cpu().numpy().copy())
                      for name in SchedState._fields},
        }

    def restore_sched_lanes(self, exported: dict, kill_lanes=()) -> SchedLaneState:
        """Stage an :meth:`export_sched_lanes` snapshot as live lanes, in the
        dtypes and on the device :meth:`sched_lanes` gives them.
        ``kill_lanes`` are reset to the inert lane first: lanes whose
        occupant the killed run already retired and wrote. Raises
        ValueError where the snapshot's signature is not this solver's."""
        self._live_problem()
        self._no_grid("a solve checkpoint's restore")
        if exported.get("sig") != self._sched_ckpt_sig():
            raise ValueError(
                "Solve checkpoint does not match this solver configuration "
                f"(checkpoint {exported.get('sig')!r}, solver {self._sched_ckpt_sig()!r}).")
        B = int(exported["lanes"])
        st = {k: (None if v is None else np.array(v, copy=True))
              for k, v in exported["state"].items()}
        norms = np.array(exported["norms"], np.float64, copy=True)
        inert = {"g": -1.0, "msq": 1, "f": 1, "fitted": 0, "conv": 0, "it": 0,
                 "done": True, "status": MAX_ITERATIONS_EXCEEDED, "iters": 0,
                 "obs": 0, "ascale": 1, "recov": 0, "f_prev": 1, "fitted_prev": 0, "tk": 1}
        for b in kill_lanes:
            for name, value in inert.items():
                if st.get(name) is not None:
                    st[name][b] = value
            norms[b] = 1.0
        # the signature fixes every field's dtype and shape
        fields = {name: None if st.get(name) is None
                  else torch.from_numpy(st[name]).to(self.device)
                  for name in SchedState._fields}
        lanes = SchedLaneState(SchedState(**fields), B)
        lanes.norms = norms
        return lanes


# ---- launch-audit registration (analysis/registry.py) -----------------------
# The JAX package's sharded entries (sartsolver_tpu/parallel/sharded.py:
# 2002-2260), on a 2x1 grid of ranks. Those whose options the grid refuses
# report the refusal's words (grid_refusal, grid_loop_refusal).

from sartsolver_tpu_torch.analysis.registry import (  # noqa: E402
    rank_block as _rank_block,
    register_audit_entry as _register_audit_entry,
)

from sartsolver_tpu_torch.parallel.mesh import RankGrid  # noqa: E402

_AUDIT_GRID = RankGrid(2, 1)
_SHARDED = dict(loop_copy_threshold=_rank_block, loop_convert_threshold=_rank_block,
                min_ranks=_AUDIT_GRID.world)


@_register_audit_entry(
    "sharded_batch",
    description="2x1 grid's batched solve (fp32, two-matmul path): the back "
                "projection's and the Eq. 5 metric's all-reduce an iteration",
    loop_collective_budget={"all-reduce": 2, "all-gather": 0}, **_SHARDED,
)
def _audit_sharded_batch(ctx):
    return ctx.batch_runner(SolverOptions(fused_sweep="off"))


@_register_audit_entry(
    "sharded_fused_batch",
    description="2x1 grid's batched solve through the split sweep (fp32): the "
                "partial back projection, its all-reduce, then the finish",
    loop_collective_budget={"all-reduce": 2, "all-gather": 0},
    hand_launches={"sharded_sweep_bp": 1, "sharded_sweep_finish": 1}, **_SHARDED,
)
def _audit_sharded_fused_batch(ctx):
    return ctx.batch_runner(SolverOptions(fused_sweep="on"))


def _refused(**opts_kw):
    """A refusal: grid_refusal's words for the options on the audit grid."""
    geometry = opts_kw.pop("geometry", False)
    return lambda: grid_refusal(SolverOptions(**opts_kw), _AUDIT_GRID, geometry=geometry)


for _name, _what, _refusal in (
    ("sharded_integrity_batch", "2x1 grid's batched solve with the in-solve ABFT check",
     _refused(integrity=True)),
    ("sharded_sched_step", "continuous-batching scheduler stride on a 2x1 grid",
     lambda: grid_loop_refusal("the continuous-batching scheduler")),
    ("sharded_sparse_panel_sweep", "2x1 grid's block-sparse loop",
     _refused(sparse_rtm="0")),
    ("sharded_implicit_batch", "2x1 grid's matrix-free loop", _refused(geometry=True)),
    ("sharded_lowrank_batch", "2x1 grid's factored (S + U V^T) loop",
     _refused(lowrank_rtm="4")),
):
    _register_audit_entry(_name, description=_what, refusal=_refusal,
                          loop_collective_budget={"all-reduce": 2, "all-gather": 0},
                          **_SHARDED)(_audit_sharded_batch)
del _name, _what, _refusal
