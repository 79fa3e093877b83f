"""Constrained SART on one device, in PyTorch.

Counterpart of ``sartsolver_tpu/models/sart.py`` for the one-device dense
solve: the linear (Eq. 2) and logarithmic (Eq. 3) solvers with the optional
Laplacian penalty, the Eq. 4 initial guess, the Eq. 5 stop test and the
Eq. 6 masks. Frames of a batch are independent: each has its own masks,
convergence metric and status, and a converged frame freezes while the rest
go on.

Each loop iteration runs one sweep. With ``fused_sweep`` engaged (fp32
compute, ``"auto"`` or ``"on"``) the sweep is one call of
:func:`~sartsolver_tpu_torch.ops.fused_sweep.fused_sweep` — the hand-written
kernel on CUDA tensors, its plain version on CPU tensors. Otherwise it is the
two-matmul path (the fp64 profile and ``fused_sweep="off"``).

The matrix is stored as fp32, fp64, bf16 or int8 codes with per-voxel
scales (``opts.rtm_dtype``). The fused sweep takes fp32, bf16 and int8; int8
needs it. Outside the loop every projection goes through the context's
``bp_any``/``fp_any`` seams: plain products (upcast block by block for
reduced-precision floats), or the quantized-vector integer projections for
int8, as in the JAX package.

The JAX ``lax.while_loop`` is a Python loop here; the stop test reads one
flag from the device per iteration. So is the JAX ``lax.scan`` of the
warm-start chain (:func:`solve_chain_normalized`). The continuous-batching
stride (:func:`sched_step_normalized`) runs the batched loop's body over
lanes that each start, stop and refill on their own.

Three solver variants ride the same body, each off by default and then
adding no op to it:

- ``relaxation_decay``: iteration k steps by ``relaxation * decay**k``. The
  linear update folds the factor into the pixel weights; the log update
  takes it as its exponent, per frame (the kernel's ``alpha_lane``).
- ``momentum="nesterov"``: the sweep runs at an extrapolated point (FISTA
  with gradient restart); the linear solver extrapolates ``H f`` too, the
  log solver projects the extrapolated point once per iteration.
- ``divergence_recovery``: the in-solve guard. A frame whose iteration goes
  non-finite or explodes is rolled back and its step halved, up to R times,
  then stops ``DIVERGED``; a frame whose input is not finite stops
  ``DIVERGED`` at iteration 0 with a zero solution.

``os_subsets > 1`` replaces the sweep by the ordered-subsets cycle
(:meth:`_SweepContext.run_os_sweep`): each iteration updates against the
interleaved pixel-row subsets ``t::os`` in turn, each with a fresh residual,
then projects the final iterate once in full. Its products are the plain
ones of :mod:`~sartsolver_tpu_torch.ops.os_subsets` on every storage (int8
included, whose codes are upcast exactly a block at a time), and it composes
with the three variants above as the sweep does.

With ``debug_nans=True`` every path checks the values it keeps for NaN at
its step boundaries and raises ``FloatingPointError``
(:mod:`~sartsolver_tpu_torch.debug_nans`).

On a grid of ranks (``problem.grid``, ``parallel/mesh.py``) the problem is
the rank's padded block and the JAX solver's ``_psum`` sites become the
fixed-order sums of ``parallel/comm.py``: the ray stats (rho over the
pixel axis, lambda over the voxel axis), every back projection outside the
loop over the pixel axis (``bp_any``) and every forward projection over
the voxel axis (``fp_any``), the penalty through the halo table
(``ops/laplacian.py:sharded_penalty``), ``||Hf||^2`` of the rank's rows
over the pixel axis before the stop test, the restart test and the guard's
non-finite counts. The fused sweep on a pixel-sharded grid is split at the
all-reduce (:meth:`_SweepContext.run_grid_sweep`); on a voxel-major grid it
runs on the column block and ``fitted`` is summed over the voxel axis.
Every rank takes its stop decision from the same bytes.

``opts.sparse_rtm`` (``"auto"`` or a threshold) runs the block-sparse
RTM: :func:`make_problem` takes the matrix's tile-occupancy index
(``ops/sparse.py``), keeps only the occupied 128-column tile columns of the
matrix on the device, one column-compacted ``[P, V_occ]`` matrix (in place
where it was handed a tensor), zeroes the tiles a nonzero threshold drops,
and takes the ray stats of that matrix. Every product of the solve then
reads the compacted matrix: the fused sweep is the hand-written kernel on
it (the vectors gathered at the occupied columns, ``f_new`` scattered
back, the rest given the elementwise update with ``bp = 0``, the JAX
package's "base update"), as are the projections outside the loop and the
OS cycle's strided subsets. An all-zero column's back-projection is exactly
zero and it adds nothing to ``fitted``, so at threshold 0 the solve is the
dense one up to the products' summation order. With no occupied column the
sweep is skipped and ``fitted`` is 0. The engagement rules and their
messages are the JAX package's (``sartsolver_tpu/models/sart.py:1057-1185``):
``"auto"`` declines quietly, a threshold raises.

An operator problem (``problem.operator_spec``; ``operators/``) runs its
own products and never the fused sweep, as the JAX solver's
(``sartsolver_tpu/models/sart.py:852-1075, 1198-1230``): the factored
``H ~= S + U V^T`` (:func:`make_lowrank_problem`: S's occupied columns,
its factors dequantized once per context) through ``torch.matmul``, the
matrix-free operator (:func:`make_implicit_problem`: the ``[P, 6]`` ray
table) through the projector of ``operators/implicit.py``. Both take the
loops, the variants and the OS cycle (subset ``t``: rows ``t::os`` of S and
U, or of the rays); the Laplacian, the ABFT check and ``fused_sweep='on'``
are refused with the JAX messages.

``opts.integrity`` adds the in-solve ABFT check
(``sartsolver_tpu/models/sart.py:1672-1708``): every iteration holds
``sum(H f)`` — on the fused sweep, the kernel's own ``fitted`` output;
after an OS cycle, its exact full projection — against ``rho . f`` per
frame, and on the two-matmul path ``sum(H^T w)`` against ``lambda . w``,
within :func:`~sartsolver_tpu_torch.resilience.integrity.abft_tolerance`.
A frame that trips freezes on its entering iterate and stops with status
``SDC_DETECTED``; a finite mismatch outranks the divergence guard's
rollback. The tripped frames join ``done``, so the loops still read one
device flag per iteration. Where a record is asked for
(:func:`record_abft_worst`), :func:`abft_worst_ratio` reports the largest
residual over its band the checks saw.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from sartsolver_tpu_torch import debug_nans as nanchk
from sartsolver_tpu_torch.config import (
    DIVERGED,
    MAX_ITERATIONS_EXCEEDED,
    SUCCESS,
    SolverOptions,
)
from sartsolver_tpu_torch.device import check_on, resolve_device
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.operators.implicit import (
    ImplicitSpec,
    implicit_back,
    implicit_forward,
    implicit_ray_stats,
    implicit_subset_density,
)
from sartsolver_tpu_torch.operators.lowrank import (
    LowRankSpec,
    lowrank_back,
    lowrank_forward,
    lowrank_ray_stats,
    lowrank_subset_density,
)
from sartsolver_tpu_torch.ops.fused_sweep import (
    _update_reference,
    fused_sweep,
    sharded_sweep_bp,
    sharded_sweep_bp_reference,
    sharded_sweep_finish,
    sharded_sweep_finish_reference,
)
from sartsolver_tpu_torch.ops.laplacian import (
    LaplacianCOO,
    ShardedLaplacian,
    coo_matvec,
    sharded_penalty,
)
from sartsolver_tpu_torch.parallel import comm
from sartsolver_tpu_torch.parallel.mesh import PIXEL_AXIS, VOXEL_AXIS
from sartsolver_tpu_torch.ops.os_subsets import (
    os_subset_back,
    os_subset_forward,
    os_subset_pixels,
    os_subset_rows,
)
from sartsolver_tpu_torch.ops.projection import (
    _quantize_sym,
    _sym_codes,
    _sym_scale,
    back_project,
    forward_project,
    int8_back_project,
    int8_forward_project,
)
from sartsolver_tpu_torch.resilience.failures import SDC_DETECTED

# The JAX package's smallest positive constant (its TPU build emulates fp64
# with fp32 range). Kept although this card has real fp64: the log floors
# and epsilons below must clamp exactly as the reference solver does.
MIN_POSITIVE = 1.2e-37

# The sweep path the most recently built solver loop runs, in the JAX
# package's vocabulary (``sartsolver_tpu/models/sart.py:FUSED_ENGAGEMENT``):
# "compiled" for the CUDA kernel, "plain" for the kernel's plain version
# (CPU tensors, where the JAX package would run its Pallas interpreter),
# "off" for the two-matmul sweep, "os-subset" for the ordered-subsets
# cycle; None before any solve. Observability only: ``--timing`` prints it.
FUSED_ENGAGEMENT = {"last": None}

SweepFn = Callable[..., Tuple[Tensor, Tensor]]

# The largest ABFT residual over its band, per device, over every solve
# with the integrity check built while a record is kept: a device scalar,
# read by abft_worst_ratio (one copy, on demand). Off by default, so the
# check computes its trip bits and nothing else.
_ABFT_WORST: dict = {}
_ABFT_RECORD = {"on": False}


def record_abft_worst(on: bool = True) -> None:
    """Start a new record of the largest ABFT residual over its band
    (``on``), or stop keeping one (the record stays readable). A measure of
    the band's margin for the smoke run and the tests, not part of the
    check."""
    if on:
        _ABFT_WORST.clear()
    _ABFT_RECORD["on"] = bool(on)


def abft_worst_ratio() -> float:
    """The largest ``|s_a - s_b| / (tol * (max(|s_a|, |s_b|) + 1))`` an
    integrity check met on a live frame (a trip is > 1) since
    :func:`record_abft_worst` started the record; 0.0 where none ran."""
    return max((float(t) for t in _ABFT_WORST.values()), default=0.0)


def _note_abft(kit) -> None:
    if kit.integrity and kit.abft_worst is not None:
        dev = kit.abft_worst.device
        prev = _ABFT_WORST.get(dev)
        _ABFT_WORST[dev] = (kit.abft_worst if prev is None
                            else torch.maximum(prev, kit.abft_worst))


class SARTProblem(NamedTuple):
    """Device-resident problem state."""

    rtm: Tensor  # [P, V], opts.rtm_dtype or opts.dtype
    ray_density: Tensor  # [V], per-voxel column sums
    ray_length: Tensor  # [P], per-pixel row sums
    laplacian: Optional[LaplacianCOO]
    # per-voxel dequantization scales of int8 codes (H_ij = rtm_scale[j] *
    # rtm[i, j]); None for float storage
    rtm_scale: Optional[Tensor] = None  # [V] ([V_occ] block-sparse), fp32
    # block-sparse: the tile index the problem was built with, and the
    # voxel columns ``rtm`` (then [P, V_occ]) and ``rtm_scale`` hold, or
    # None where every column is occupied; ray_density stays [V]
    occupancy: Optional[object] = None  # ops/sparse.py:TileOccupancy
    cols: Optional[Tensor] = None  # [V_occ] int64, ascending
    # the factored operator H ~= S + U V^T (operators/lowrank.py): ``rtm``
    # holds the occupied columns of the sparse core S (``cols`` names them,
    # None where every column is), these the skinny factors (int8 codes
    # with their per-rank-component scales, row 0 U's, row 1 V's)
    factor_u: Optional[Tensor] = None  # [P, r]
    factor_v: Optional[Tensor] = None  # [V, r]
    factor_scale: Optional[Tensor] = None  # [2, r], fp32
    # the operator's spec: None for a stored matrix, a LowRankSpec for the
    # factored operator, an ImplicitSpec for the matrix-free one (``rtm``
    # then the packed [P, 6] fp32 ray table)
    operator_spec: Optional[object] = None
    # a grid of more than one rank (parallel/mesh.py:RankGrid): ``rtm`` is
    # this rank's padded block, the ray stats its block's (reduced over the
    # grid), ``laplacian`` its ops/laplacian.py:ShardedLaplacian; None on
    # one device
    grid: Optional[object] = None


class SolveResult(NamedTuple):
    solution: Tensor  # [B, V] (or [V] from solve)
    status: Tensor  # int32: SUCCESS / MAX_ITERATIONS_EXCEEDED / DIVERGED
    iterations: Tensor  # int32: completed iterations
    convergence: Tensor  # final Eq. 5 metric C^k


def _storage_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16, "int8": torch.int8}[name]


def storage_dtype(opts: SolverOptions) -> torch.dtype:
    """The stored matrix's dtype: ``opts.rtm_dtype``, else the compute dtype."""
    return torch_dtype(opts.rtm_dtype or opts.dtype)


def _tiny(value: float) -> float:
    return MIN_POSITIVE if 0.0 < value < MIN_POSITIVE else value


def compute_ray_stats(rtm: Tensor, *, dtype: torch.dtype, grid=None) -> Tuple[Tensor, Tensor]:
    """Per-voxel ray density and per-pixel ray length (sartsolver.cpp:38-56).
    On a ``grid`` of ranks (``rtm`` the rank's block) the column sums are
    summed over the pixel axis and the row sums over the voxel axis
    (``sartsolver_tpu/models/sart.py:313-323``)."""
    return _grid_stats(rtm.sum(dim=0, dtype=dtype), rtm.sum(dim=1, dtype=dtype), grid)


def _grid_stats(dens: Tensor, length: Tensor, grid) -> Tuple[Tensor, Tensor]:
    return (comm.all_reduce_sum(dens, PIXEL_AXIS, grid),
            comm.all_reduce_sum(length, VOXEL_AXIS, grid))


# int8 x int8 contractions accumulate in int32: |codes| <= 127 on both sides
# bounds the contraction extent at 2^31 / 127^2 (~133k); enforced in
# make_problem.
INT8_MAX_CONTRACTION = (2**31 - 1) // (127 * 127)

# elements of a matrix quantized or reduced at once: its fp32 or int32
# temporaries stay at 64 MiB (a whole-matrix int32 cast of the e2e world's
# codes would be 2 GiB beside their 0.5 GiB)
_CHUNK_ELEMENTS = 1 << 24


def _row_chunks(n_rows: int, n_cols: int):
    step = max(1, _CHUNK_ELEMENTS // max(n_cols, 1))
    return [(r0, min(r0 + step, n_rows)) for r0 in range(0, n_rows, step)]


def quantize_rtm(rtm) -> Tuple[Tensor, Tensor]:
    """Per-voxel (column) symmetric int8 quantization of an RTM, where it
    lies: ``(codes int8 [P, V], scale fp32 [V])`` with ``H ~= scale[None, :]
    * codes`` and ``|codes| <= 127`` — the JAX package's ``quantize_rtm``,
    code for code. Taken a block of rows at a time (the recipe is
    elementwise once the column maxima are known)."""
    x = torch.as_tensor(rtm)
    P, V = x.shape
    amax = torch.zeros(V, dtype=torch.float32, device=x.device)
    for r0, r1 in _row_chunks(P, V):
        amax = torch.maximum(amax, x[r0:r1].float().abs().amax(dim=0))
    scale = _sym_scale(amax)
    codes = torch.empty((P, V), dtype=torch.int8, device=x.device)
    for r0, r1 in _row_chunks(P, V):
        codes[r0:r1] = _sym_codes(x[r0:r1].float(), scale)
    return codes, scale


def compute_ray_stats_int8(codes: Tensor, scale: Tensor, *, dtype: torch.dtype,
                           grid=None) -> Tuple[Tensor, Tensor]:
    """Ray stats of ``H = scale * codes``: column sums of the codes in
    int32, times the scale; row sums as the codes against the scales. Both
    a block of rows at a time (the int32 sums are exact in any order). On
    a ``grid``, reduced as :func:`compute_ray_stats` reduces them
    (``sartsolver_tpu/models/sart.py:386-398``)."""
    s = scale.to(dtype)
    colsum = torch.zeros(codes.shape[1], dtype=torch.int32, device=codes.device)
    length = torch.empty(codes.shape[0], dtype=dtype, device=codes.device)
    for r0, r1 in _row_chunks(*codes.shape):
        colsum += codes[r0:r1].sum(dim=0, dtype=torch.int32)
        length[r0:r1] = codes[r0:r1].to(dtype) @ s
    return _grid_stats(s * colsum.to(dtype), length, grid)


def _subset_colsums(rtm: Tensor, n: int, dtype: torch.dtype,
                    scale: Optional[Tensor]) -> Tensor:
    """``[n, V]`` column sums of the interleaved row subsets ``t::n`` (the
    OS cycle's per-subset ray densities), a block of rows at a time; int8
    codes sum in int32 (exact) and are scaled after."""
    P, V = rtm.shape
    step = max(n, _CHUNK_ELEMENTS // max(V, 1) // n * n)
    acc = torch.zeros((n, V), dtype=torch.int32 if scale is not None else dtype,
                      device=rtm.device)
    for r0 in range(0, P, step):
        acc += rtm[r0:r0 + step].reshape(-1, n, V).sum(dim=0, dtype=acc.dtype)
    return scale[None, :] * acc.to(dtype) if scale is not None else acc


def _span(name: str):
    """A ``torch.profiler`` range around one part of the OS cycle while a
    profiler records (it splits an iteration's device time by part), else
    nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def sparse_reasons(opts: SolverOptions, occupancy, shape, storage: str) -> list:
    """Why the block-sparse sweep cannot engage on a matrix of ``shape``
    stored as ``storage`` with ``occupancy`` (the JAX package's reasons and
    messages, ``sartsolver_tpu/models/sart.py:1093-1147``); empty where it
    can. The JAX package's panel alignment and static-unroll cap do not
    apply: the port skips whole 128-column tile columns at any shape."""
    reasons = []
    if occupancy is None:
        reasons.append("no tile-occupancy index was supplied (build one at "
                       "ingest, or via models.sart.make_sparse_problem)")
    if opts.dtype != "float32" or storage not in ("float32", "bfloat16", "int8"):
        reasons.append(f"dtype={opts.dtype} / rtm dtype={storage} (the sparse "
                       "panel sweep computes in fp32 over fp32/bfloat16/int8 "
                       "storage)")
    if opts.divergence_recovery and opts.logarithmic and opts.os_subsets == 1:
        reasons.append("divergence_recovery on the logarithmic solver (the "
                       "panel closures cannot carry the per-frame traced "
                       "exponent)")
    if occupancy is not None and not (
            occupancy.cols >= shape[1]
            and -(-occupancy.cols // occupancy.tile_cols)
            == -(-shape[1] // occupancy.tile_cols)
            and -(-occupancy.rows // occupancy.tile_rows)
            >= -(-shape[0] // occupancy.tile_rows)):
        reasons.append(f"the occupancy index covers [{occupancy.rows}, "
                       f"{occupancy.cols}] and cannot drive this "
                       f"[{shape[0]}, {shape[1]}] matrix")
    return reasons


def resolve_sparse(opts: SolverOptions, occupancy, shape, storage: str) -> bool:
    """Whether the block-sparse sweep engages: ``"auto"`` declines quietly
    where :func:`sparse_reasons` names a reason, an explicit threshold
    raises ValueError naming them; an engaged index is verified (its
    digest) first."""
    if opts.sparse_epsilon() is None:
        return False
    reasons = sparse_reasons(opts, occupancy, shape, storage)
    if reasons:
        if opts.sparse_explicit():
            raise ValueError(
                f"sparse_rtm='{opts.sparse_rtm}' requested but the block-sparse "
                "sweep cannot engage: " + "; ".join(reasons) + ".")
        return False
    occupancy.verify()
    return True


def compact_columns_(mat: Tensor, cols: Tensor) -> Tensor:
    """``mat[:, cols]`` written over the front of ``mat``'s own storage:
    ``[R, V]`` contiguous to a ``[R, len(cols)]`` view of it, ``cols``
    ascending. In row-major order a row's destination never lies past its
    source, so rows are gathered by ascending blocks, each straight into
    its destination where that ends before the block's source begins (the
    blocks grow as the gap does), else one row through a one-row
    temporary. No matrix-sized buffer is allocated."""
    R, V = mat.shape
    n = cols.numel()
    if n == V:
        return mat
    flat = mat.view(-1)
    r0 = 0
    while r0 < R:
        r1 = min(R, (r0 * V) // max(n, 1)) if n else R
        if r1 <= r0:
            r1 = r0 + 1
            row = mat[r0].index_select(0, cols)
            flat[r0 * n:r1 * n].copy_(row)
        else:
            torch.index_select(mat[r0:r1], 1, cols,
                               out=flat[r0 * n:r1 * n].view(r1 - r0, n))
        r0 = r1
    return flat[:R * n].view(R, n)


def zero_dropped_tiles_(mat: Tensor, keep: np.ndarray, tile_rows: int,
                        tile_cols: int) -> None:
    """Zero in place every tile of ``mat`` ``[R, V]`` whose entry of
    ``keep`` (bool ``[>= ceil(R / tile_rows), ceil(V / tile_cols)]``) is
    False (``ops/sparse.py:threshold_matrix`` semantics, where ``mat``
    lies): a block of whole tile rows at a time, by a broadcast multiply
    with the 0/1 tile mask."""
    R, V = mat.shape
    n_tr = -(-R // tile_rows)
    keep = np.asarray(keep, bool)[:n_tr]
    if keep.all():
        return
    main = V // tile_cols * tile_cols
    step = max(1, (1 << 24) // max(V * tile_rows, 1)) * tile_rows
    for r0 in range(0, R, step):
        r1 = min(R, r0 + step)
        t0, t1 = r0 // tile_rows, -(-r1 // tile_rows)
        if not (~keep[t0:t1]).any():
            continue
        k = keep[t0:t1]
        m = torch.as_tensor(k, device=mat.device).to(mat.dtype)
        rows = mat[r0:r1]
        full = (r1 - r0) // tile_rows * tile_rows
        for a, b, sel in ((0, full, slice(0, full // tile_rows)),
                          (full, r1 - r0, slice(full // tile_rows, full // tile_rows + 1))):
            if b <= a:
                continue
            blk = rows[a:b].unflatten(0, (-1, min(tile_rows, b - a)))
            mk = m[sel]
            if main:
                blk[:, :, :main].unflatten(2, (main // tile_cols, tile_cols)).mul_(
                    mk[:, None, :main // tile_cols, None])
            if main < V:
                blk[:, :, main:].mul_(mk[:, None, -1:])


def _scatter_cols(x: Tensor, cols: Optional[Tensor], nvoxel: int) -> Tensor:
    """``x`` ``[..., V_occ]`` spread into zeros ``[..., nvoxel]`` at
    ``cols`` (``x`` itself where ``cols`` is None)."""
    if cols is None:
        return x
    out = torch.zeros(x.shape[:-1] + (nvoxel,), dtype=x.dtype, device=x.device)
    return out.index_copy_(-1, cols, x)


def make_problem(rtm, laplacian: Optional[LaplacianCOO] = None, *,
                 opts: SolverOptions, device="cuda",
                 rtm_scale=None, tile_occupancy=None, grid=None) -> SARTProblem:
    """Upload the RTM (a host array or a tensor) in the storage dtype and
    compute its ray stats in the compute dtype. ``laplacian`` must already
    live on ``device``.

    Float storage: the stats are taken from ``rtm`` as given, before any
    cast, where it lies; a host matrix stored in another dtype is cast on
    the host, so only the stored matrix is uploaded. (The CLI hands over an
    already-rounded bf16 matrix, so its stats are those of the stored
    matrix, as the JAX CLI's are.)

    int8 storage: ``rtm`` is quantized where it lies (a host array on the
    host, so the card only ever holds the 1-byte codes), or it is already
    int8 codes and ``rtm_scale`` [V] their scales. The stats are those of
    the quantized matrix.

    ``tile_occupancy`` (an ``ops/sparse.py:TileOccupancy`` of the matrix,
    with ``opts.sparse_rtm`` on): where the block-sparse sweep engages
    (:func:`resolve_sparse`), only the occupied tile columns are kept —
    compacted in place (:func:`compact_columns_`) when ``rtm`` is a tensor,
    which then becomes the problem's storage, else into a new array — the
    tiles a nonzero threshold drops are zeroed, and the stats are those of
    that matrix (``ray_density`` spread back to [V], zero elsewhere).

    ``grid`` (a ``parallel/mesh.py:RankGrid`` of more than one rank):
    ``rtm`` is this rank's padded block, int8 codes come with their scales
    (the block's columns), ``laplacian`` is the block's
    ``ShardedLaplacian``, and the ray stats are reduced over the grid.
    """
    dev = resolve_device(device)
    dtype = torch_dtype(opts.dtype)
    sdt = storage_dtype(opts)
    if grid is not None and grid.world == 1:
        grid = None
    if laplacian is not None:
        check_on(dev, laplacian=laplacian.loc_vals if isinstance(laplacian, ShardedLaplacian)
                 else laplacian.vals)
    if np.ndim(rtm) != 2:
        raise ValueError(f"rtm must be [P, V], got shape {np.shape(rtm)}.")
    nvoxel = np.shape(rtm)[1]
    occ = (tile_occupancy if resolve_sparse(opts, tile_occupancy, np.shape(rtm),
                                            _storage_name(sdt)) else None)
    in_place = isinstance(rtm, torch.Tensor)
    cols = None

    def compact(x: Tensor, own: bool) -> Tensor:
        """The occupied columns of ``x`` (the tile mask's dropped tiles
        zeroed), in place where ``own``."""
        nonlocal cols
        idx = torch.as_tensor(occ.occupied_columns(nvoxel), device=x.device)
        x = compact_columns_(x, idx) if own else x.index_select(1, idx)
        col_tiles = np.flatnonzero(occ.mask.any(axis=0))
        zero_dropped_tiles_(x, occ.mask[:, col_tiles], occ.tile_rows, occ.tile_cols)
        cols = idx if idx.numel() < nvoxel else None
        return x
    if sdt == torch.int8:
        if max(np.shape(rtm)) > INT8_MAX_CONTRACTION:
            raise ValueError(
                f"rtm_dtype='int8': RTM extent {max(np.shape(rtm))} exceeds "
                f"the int32-accumulation bound {INT8_MAX_CONTRACTION} of the "
                "integer projections (int8_back_project); use fp32/bfloat16 "
                "storage."
            )
        if rtm_scale is None:
            codes, scale = quantize_rtm(rtm)
        else:
            codes = torch.as_tensor(rtm)
            scale = torch.as_tensor(rtm_scale)
            if codes.dtype != torch.int8:
                raise ValueError(
                    "rtm_scale implies pre-quantized int8 codes; got a "
                    f"{codes.dtype} matrix."
                )
            if scale.shape != (codes.shape[1],):
                raise ValueError(
                    f"rtm_scale of shape {tuple(scale.shape)} does not fit "
                    f"rtm {tuple(codes.shape)}: [{codes.shape[1]}] expected."
                )
        codes = codes.to(dev).contiguous()
        scale = scale.to(dev, torch.float32)
        if occ is not None:
            codes = compact(codes, in_place or rtm_scale is None)
            if cols is not None:
                scale = scale.index_select(0, cols.to(dev))
        cols = None if cols is None else cols.to(dev)
        dens, length = compute_ray_stats_int8(codes, scale, dtype=dtype, grid=grid)
        return SARTProblem(codes, _scatter_cols(dens, cols, nvoxel), length, laplacian,
                           scale, occupancy=occ, cols=cols, grid=grid)
    if rtm_scale is not None:
        raise ValueError("rtm_scale is only valid with rtm_dtype='int8'.")
    rtm = torch.as_tensor(rtm)
    if occ is not None:
        rtm = compact(rtm.contiguous(), in_place and rtm.is_contiguous())
    if rtm.dtype == sdt or rtm.device.type == dev.type:
        rtm = rtm.to(dev)  # stored as given, or already there
    cols = None if cols is None else cols.to(dev)
    dens, length = compute_ray_stats(rtm, dtype=dtype, grid=grid)
    return SARTProblem(rtm.to(dev, sdt).contiguous(),
                       _scatter_cols(dens.to(dev), cols, nvoxel),
                       length.to(dev), laplacian, occupancy=occ, cols=cols, grid=grid)


def make_sparse_problem(rtm, laplacian: Optional[LaplacianCOO] = None, *,
                        opts: SolverOptions, device="cuda"):
    """:func:`make_problem` plus the block-sparse tile-occupancy pass of a
    host matrix (``sartsolver_tpu/models/sart.py:make_sparse_problem``):
    returns ``(problem, occupancy)``, ``(problem, None)`` when sparse mode
    is off. The index is of the fp32 values given (with bf16 or int8
    storage a tile whose every entry rounds to zero stays marked occupied,
    a missed skip, never a skipped live tile); a nonzero threshold zeroes
    the dropped tiles on the host first, as the JAX function does, so an
    int8 matrix is quantized from the thresholded values. The chunked
    ingest's equivalent is ``parallel/multihost.py``'s ``tile_stats=``."""
    eps = opts.sparse_epsilon()
    if eps is None:
        return make_problem(rtm, laplacian, opts=opts, device=device), None
    from sartsolver_tpu_torch.ops.sparse import build_tile_occupancy, threshold_matrix

    mat = np.asarray(rtm, np.float32)
    occ = build_tile_occupancy(mat, epsilon=eps)
    if eps > 0:
        mat = threshold_matrix(mat, occ)
    return make_problem(mat, laplacian, opts=opts, device=device,
                        tile_occupancy=occ), occ


def make_implicit_problem(rays, spec: ImplicitSpec, *, opts: SolverOptions,
                          device="cuda") -> SARTProblem:
    """The matrix-free problem (``sartsolver_tpu/models/sart.py:
    make_implicit_problem``): the packed ``[P, 6]`` ray table staged fp32 as
    ``rtm``, rho and lambda from the projector the sweeps use (on the card
    the kernel). int8 storage is refused: there is no matrix to quantize."""
    dev = resolve_device(device)
    if (opts.rtm_dtype or "") == "int8":
        raise ValueError(
            "rtm_dtype='int8' quantizes a stored matrix; the implicit "
            "operator stores no matrix (its rays stay fp32). Drop "
            "rtm_dtype or use a materialized RTM."
        )
    rays = torch.as_tensor(np.asarray(rays, np.float32), device=dev).contiguous()
    dens, length = implicit_ray_stats(rays, spec, dtype=torch_dtype(opts.dtype))
    return SARTProblem(rays, dens, length, None, operator_spec=spec)


def make_lowrank_problem(s_matrix, u, v, spec: LowRankSpec, *, opts: SolverOptions,
                         device="cuda", occupancy=None) -> SARTProblem:
    """The factored problem (``sartsolver_tpu/models/sart.py:
    make_lowrank_problem``): ``s_matrix`` [P, V] the sparse core S on the
    host, ``u`` [P, r] and ``v`` [V, r] its factors. Only the columns of S
    that can hold a nonzero are staged, ``[P, V_occ]`` (those of
    ``occupancy``'s tile columns with a kept tile, the split's index; else
    the occupied panels of ``spec``), with their index as the problem's
    ``cols``: the others are exactly zero, so every product is unchanged.
    S is stored as ``opts.rtm_dtype`` (bf16 applies to S only, the factors
    stay fp32); int8 quantizes S per voxel and each factor per rank
    component, on the host. rho and lambda are those of the composed
    (for int8, the quantized) operator."""
    dev = resolve_device(device)
    dtype = torch_dtype(opts.dtype)
    S = np.asarray(s_matrix, np.float32)
    P, V = S.shape
    u = torch.as_tensor(np.asarray(u, np.float32))
    v = torch.as_tensor(np.asarray(v, np.float32))
    if u.shape != (P, spec.rank) or v.shape != (V, spec.rank) or V != spec.nvoxel:
        raise ValueError(
            f"factor shapes {tuple(u.shape)} / {tuple(v.shape)} do not "
            f"match the [{P}, {V}] core at rank {spec.rank} (spec nvoxel "
            f"{spec.nvoxel})."
        )
    cols = (occupancy.occupied_columns(V) if occupancy is not None
            else spec.occupied_columns())
    if cols is not None and len(cols) == V:
        cols = None
    core = torch.as_tensor(S)
    if cols is not None:  # a threaded gather (numpy's column indexing is serial)
        core = core.index_select(1, torch.as_tensor(cols))
    cols_dev = None if cols is None else torch.as_tensor(cols, device=dev)
    if (opts.rtm_dtype or "") == "int8":
        if max(P, V) > INT8_MAX_CONTRACTION:
            raise ValueError(
                f"rtm_dtype='int8': RTM extent {max(P, V)} exceeds the "
                f"int32-accumulation bound {INT8_MAX_CONTRACTION} of the "
                "integer projections; use fp32/bfloat16 storage."
            )
        codes, scale = quantize_rtm(core)
        u_codes, su = _quantize_sym(u, dim=0)
        v_codes, sv = _quantize_sym(v, dim=0)
        fscale = torch.cat([su, sv], dim=0).to(dev)  # [2, r]
        codes, scale = codes.to(dev), scale.to(dev)
        u_dev, v_dev = u_codes.to(dev), v_codes.to(dev)
        dens, length = lowrank_ray_stats(
            codes, u_dev.float() * fscale[0], v_dev.float() * fscale[1], scale=scale,
            cols=cols_dev, dtype=dtype)
        return SARTProblem(codes, dens, length, None, scale, cols=cols_dev,
                           factor_u=u_dev, factor_v=v_dev, factor_scale=fscale,
                           operator_spec=spec)
    staged = core.to(storage_dtype(opts)).to(dev).contiguous()
    u_dev, v_dev = u.to(dev), v.to(dev)
    dens, length = lowrank_ray_stats(staged, u_dev, v_dev, cols=cols_dev, dtype=dtype)
    return SARTProblem(staged, dens, length, None, cols=cols_dev, factor_u=u_dev,
                       factor_v=v_dev, operator_spec=spec)


def resolve_fused(opts: SolverOptions) -> bool:
    """Whether the loop runs through the fused sweep: fp32 compute over
    fp32, bf16 or int8 storage, with ``"auto"`` or ``"on"``. The fp64
    profile and fp64 storage decline — quietly for ``"auto"``, with a
    ValueError for ``"on"``. The ordered-subsets cycle (``os_subsets > 1``)
    replaces the fused sweep under ``"auto"`` (``SolverOptions`` refuses it
    with ``"on"``). So does the log solver with
    ``divergence_recovery``, as in the JAX package
    (``sartsolver_tpu/models/sart.py:_resolve_fused``): the guard's per-frame
    step scale enters the log update as its exponent, which the JAX kernel's
    literal-constant closure cannot carry."""
    if opts.fused_sweep == "off" or opts.os_subsets > 1:
        return False
    if opts.divergence_recovery and opts.logarithmic:
        if opts.fused_sweep == "on":
            raise ValueError(
                "fused_sweep='on' requested but divergence_recovery is enabled "
                "on the logarithmic solver; the per-frame relaxation scale "
                "cannot enter the fused kernel's literal exponent. Use "
                "fused_sweep='auto'/'off' or the linear solver."
            )
        return False
    storage = opts.rtm_dtype or opts.dtype
    if opts.dtype != "float32" or storage not in ("float32", "bfloat16", "int8"):
        if opts.fused_sweep == "on":
            raise ValueError(
                f"fused_sweep='on' requested but dtype={opts.dtype} / rtm "
                f"dtype={storage}; the fused sweep computes in fp32 (fp32, "
                "bfloat16 or quantized int8 RTM storage)."
            )
        return False
    return True


def _refuse_for_operator(opts: SolverOptions, problem: SARTProblem, lowrank: bool) -> None:
    """The JAX solver core's refusals for an operator problem
    (``sartsolver_tpu/models/sart.py:903-945, 1070-1085, 1198-1230``): the
    Laplacian, the in-solve ABFT check, an explicit ``fused_sweep='on'``
    and (matrix-free) an explicit block-sparse threshold, each with its
    message."""
    backend = "factored (lowrank)" if lowrank else "implicit (matrix-free)"
    if problem.laplacian is not None:
        raise ValueError(
            f"beta_laplace smoothing is not supported by the {backend} "
            "operator; drop the Laplacian or use a materialized RTM."
        )
    if opts.integrity:
        if lowrank:
            raise ValueError(
                "integrity=True (in-solve ABFT) is not supported by the "
                "factored (lowrank) operator: the checksum tolerance model "
                "certifies a single stored-matrix contraction, not the "
                "composed S + U V^T products. Disable integrity or use a "
                "materialized RTM."
            )
        raise ValueError(
            "integrity=True (in-solve ABFT) is not supported by the implicit "
            "operator: the checksummed identities certify a STORED matrix "
            "against corruption, and the matrix-free projector stores none. "
            "Disable integrity or use a materialized RTM."
        )
    if not lowrank and opts.sparse_explicit():
        raise ValueError(
            f"sparse_rtm='{opts.sparse_rtm}' requested but the operator is "
            "implicit (matrix-free): there is no stored matrix to "
            "tile-index. Use sparse_rtm='auto'/off or a materialized RTM."
        )
    if opts.fused_sweep == "on":
        if lowrank:
            raise ValueError(
                "fused_sweep='on' requested but the operator is factored "
                "(lowrank); the composed S + U V^T sweep replaces the fused "
                "kernel. Use fused_sweep='auto'/'off'."
            )
        raise ValueError(
            "fused_sweep='on' requested but the operator is implicit "
            "(matrix-free); the slab projector replaces the fused sweep. "
            "Use fused_sweep='auto'/'off'."
        )


@functools.lru_cache(maxsize=8)
def _sparse_plan(occupancy) -> Tuple[float, int, int]:
    """``(occupancy fraction, tile columns, tiles a sweep skips)`` of an
    index, taken once per index (a context is built per solve and stride)."""
    col_any = occupancy.mask.any(axis=0)
    return (occupancy.occupancy_fraction(), len(col_any),
            int((~col_any).sum()) * occupancy.grid_shape[0])


class _SweepContext:
    """Masks, inverse ray stats, the penalty and one iteration's sweep."""

    def __init__(self, problem: SARTProblem, opts: SolverOptions,
                 sweep_fn: SweepFn, debug_nans: bool = False):
        self.opts = opts
        self.debug_nans = debug_nans
        self.dtype = torch_dtype(opts.dtype)
        self.rtm = problem.rtm
        self.lap = problem.laplacian
        self.beta = opts.beta_laplace
        self.eps = _tiny(opts.log_epsilon)
        # an operator backend (the factored or the matrix-free one) runs its
        # own products and never the fused sweep
        spec = problem.operator_spec
        self.lowrank = spec if isinstance(spec, LowRankSpec) else None
        self.implicit = spec if isinstance(spec, ImplicitSpec) else None
        self.fused = False if spec is not None else resolve_fused(opts)
        self.sweep_fn = sweep_fn
        self.os = int(opts.os_subsets)
        # block-sparse: the problem holds the occupied columns (cols None:
        # every column is); an explicit threshold over a problem built
        # without an index raises here, as the JAX solver does
        self.sparse = problem.occupancy
        self.cols = problem.cols
        self.nvoxel = problem.ray_density.shape[0]
        # a grid of ranks: the collective seams below sum over its axes
        self.grid = problem.grid
        self.pixel_sharded = self.grid is not None and self.grid.n_pix > 1
        if self.grid is not None and (spec is not None or self.sparse is not None
                                      or self.os > 1 or opts.integrity or debug_nans):
            raise ValueError(
                "A grid of ranks runs the dense stored matrix through the classic "
                "sweep: no operator backend, block-sparse index, ordered subsets, "
                "integrity check or NaN debugging.")
        if spec is not None:
            _refuse_for_operator(opts, problem, self.lowrank is not None)
        elif self.sparse is None and opts.sparse_explicit():
            resolve_sparse(opts, None, problem.rtm.shape, _storage_name(problem.rtm.dtype))
        if self.sparse is not None and self.os == 1:
            self.fused = True  # the hand kernel over the occupied columns
        kind = ("os-subset" if self.os > 1 else "off" if not self.fused
                else "compiled" if self.rtm.is_cuda and sweep_fn is fused_sweep
                else "plain")
        if self.pixel_sharded and self.fused:
            # the sweep split at the all-reduce (ops/fused_sweep.py)
            kind = "split" if self.rtm.is_cuda and sweep_fn is fused_sweep else "split-plain"
        if spec is not None:
            kind = ("lowrank" if self.lowrank is not None else "implicit") + (
                "-os" if self.os > 1 else "")
        FUSED_ENGAGEMENT["last"] = (kind if self.sparse is None else
                                    "os-subset-sparse" if self.os > 1 else f"sparse-{kind}")
        self._skip_ctr = None
        if self.sparse is not None:
            self._note_sparse()
        # int8 codes: the loop's kernel (or the OS cycle's products)
        # dequantizes them exactly; the projections outside it quantize
        # their vector operand
        self.scale = None
        if problem.rtm.dtype == torch.int8:
            if problem.rtm_scale is None:
                raise ValueError(
                    "int8 RTM needs SARTProblem.rtm_scale; build the problem "
                    "with make_problem(..., opts with rtm_dtype='int8')."
                )
            # (the factored operator's products upcast S's codes exactly)
            if not self.fused and self.os == 1 and self.lowrank is None:
                raise ValueError(
                    "rtm_dtype='int8' requires the fused sweep, but it "
                    f"resolved off (fused_sweep='{opts.fused_sweep}'). Use "
                    "fused_sweep='auto'/'on', or fp32/bfloat16 storage."
                )
            self.scale = problem.rtm_scale.to(self.dtype)
        if self.lowrank is not None:
            # the factors dequantized once, here (O(r (P + V)) elements)
            u, v = problem.factor_u, problem.factor_v
            if problem.factor_scale is not None:
                u = u.to(self.dtype) * problem.factor_scale[0].to(self.dtype)[None, :]
                v = v.to(self.dtype) * problem.factor_scale[1].to(self.dtype)[None, :]
            self.u, self.v = u.to(self.dtype), v.to(self.dtype)

        dens, length = problem.ray_density, problem.ray_length
        self.vmask = dens > opts.ray_density_threshold  # [V]
        self.safe_dens = torch.where(self.vmask, dens, torch.ones_like(dens))
        self.inv_density = torch.where(
            self.vmask, opts.relaxation / self.safe_dens,
            torch.zeros_like(dens),
        ).to(self.dtype)
        lmask = length > opts.ray_length_threshold  # [P]
        self.inv_length = torch.where(
            lmask, 1 / torch.where(lmask, length, torch.ones_like(length)),
            torch.zeros_like(length),
        ).to(self.dtype)
        self.vm = self.vmask.to(self.dtype)[None, :]
        if self.os > 1:
            # per-subset ray densities and masks: a sub-step normalizes by
            # its own subset's column sums and never updates a voxel that
            # its subset barely sees or that is masked globally
            P = problem.rtm.shape[0]
            if P % self.os:
                raise ValueError(
                    f"os_subsets={self.os} must divide the (per-shard, "
                    f"padded) pixel extent {P}."
                )
            if self.lowrank is not None:
                # subset t of S + U V^T: S's rows t::os and U's rows t::os
                dens_sub = lowrank_subset_density(
                    problem.rtm, self.u, self.v, None, self.os, scale=self.scale,
                    cols=self.cols, dtype=self.dtype)
            elif self.implicit is not None:
                dens_sub = implicit_subset_density(problem.rtm, self.implicit, self.os,
                                                   dtype=self.dtype)
            else:
                dens_sub = _scatter_cols(
                    _subset_colsums(problem.rtm, self.os, self.dtype, self.scale),
                    self.cols, self.nvoxel)
            self.vmask_sub = (dens_sub > opts.ray_density_threshold) & self.vmask[None, :]
            self.inv_density_sub = torch.where(
                self.vmask_sub,
                opts.relaxation / torch.where(self.vmask_sub, dens_sub, torch.ones_like(dens_sub)),
                torch.zeros_like(dens_sub),
            ).to(self.dtype)
        self.os_nan_rows = None  # [os, B] with debug_nans: NaN rows after each sub-step

        dev = dens.device
        self.scheduled = opts.relaxation_decay != 1.0
        self.decay = torch.tensor(opts.relaxation_decay, dtype=self.dtype, device=dev)
        self.relax = torch.tensor(opts.relaxation, dtype=self.dtype, device=dev)
        self.momentum = opts.momentum != "off"
        # only the linear classic sweep extrapolates H f by linearity (the
        # OS cycle recomputes every subset residual)
        self.carry_fit = self.momentum and not opts.logarithmic and self.os == 1
        self.mom_floor = torch.tensor(_tiny(max(opts.log_epsilon, 1e-30)),
                                      dtype=self.dtype, device=dev)
        self.recovery = int(opts.divergence_recovery)
        # the in-solve ABFT check: the band over the matrix as held (the
        # padded rows included, as the JAX solver's padded extent is)
        self.integrity = bool(opts.integrity)
        self.bp_chk = None  # the two-matmul sweep's back-projection checksums
        if self.integrity:
            from sartsolver_tpu_torch.resilience.integrity import abft_tolerance

            self.abft_tol = abft_tolerance(opts.dtype, opts.rtm_dtype,
                                           problem.rtm.shape[0], problem.rtm.shape[1])
            self.dens = dens.to(self.dtype)
            self.length_row = length.to(self.dtype)[None, :]
            self.abft_worst = (torch.zeros((), dtype=self.dtype, device=dev)
                               if _ABFT_RECORD["on"] else None)

    def _note_sparse(self) -> None:
        """The sparse plan's gauges (``ops/fused_sweep.py:_sparse_trace_obs``
        of the JAX package): the occupancy, the tile columns and their
        width; the counter of the tiles each sweep skips is advanced by
        :meth:`_count_skipped`."""
        occ = self.sparse
        path = "sparse_os" if self.os > 1 else "sparse_panel"
        fraction, n_tile_cols, self._skip_tiles = _sparse_plan(occ)
        reg = obs_metrics.get_registry()
        reg.gauge("rtm_tile_occupancy").set(fraction)
        reg.gauge("fused_panel_count", path=path).set(n_tile_cols)
        reg.gauge("fused_panel_voxels", path=path).set(occ.tile_cols)
        self._skip_ctr = reg.counter("sparse_tiles_skipped_total", path=path)

    def _count_skipped(self) -> None:
        if self._skip_ctr is not None:
            self._skip_ctr.inc(self._skip_tiles)

    def gather(self, x: Tensor) -> Tensor:
        """``x`` ``[..., V]`` at the occupied columns (``x`` itself when
        the problem holds every column)."""
        return x if self.cols is None else x.index_select(-1, self.cols)

    def spread(self, x: Tensor) -> Tensor:
        """``x`` ``[..., V_occ]`` back in ``[..., V]``, zero elsewhere."""
        return _scatter_cols(x, self.cols, self.nvoxel)

    def decay_factor(self, it: Tensor) -> Tensor:
        """``decay ** it`` [B] for the iterations ``it`` [B] each frame has
        completed: one op, the same for the batched loop (every frame at the
        loop's count) and the stride (each lane at its own), so the two
        agree byte for byte."""
        return torch.pow(self.decay, it.to(self.dtype))

    def pixel_sum(self, x: Tensor) -> Tensor:
        """``x`` summed over the grid's pixel axis (``x`` on one rank)."""
        return comm.all_reduce_sum(x, PIXEL_AXIS, self.grid)

    def voxel_sum(self, x: Tensor) -> Tensor:
        """``x`` summed over the grid's voxel axis (``x`` on one rank)."""
        return comm.all_reduce_sum(x, VOXEL_AXIS, self.grid)

    def bp_any(self, w: Tensor) -> Tensor:
        """``H^T w`` on whatever the problem stores: the one back-projection
        seam of every path outside the fused loop (block-sparse: over the
        occupied columns, zero elsewhere; the factored and the matrix-free
        operators: their own products, in the compute dtype). On a grid the
        rank's product is summed over the pixel axis (the JAX solver's
        ``_psum(bp_any(w), axis_name)``, ``sartsolver_tpu/models/sart.py:
        1386``): the guess, ``obs`` and the two-matmul sweep get the
        globally reduced back projection of the rank's voxel block."""
        return self.pixel_sum(self._bp_local(w))

    def _bp_local(self, w: Tensor) -> Tensor:
        if self.lowrank is not None:
            return lowrank_back(self.rtm, self.u, self.v, w, scale=self.scale,
                                cols=self.cols, accum_dtype=self.dtype)
        if self.implicit is not None:
            return implicit_back(self.rtm, w, self.implicit, accum_dtype=self.dtype)
        if self.rtm.shape[1] == 0:
            return torch.zeros(w.shape[:-1] + (self.nvoxel,), dtype=w.dtype, device=w.device)
        if self.scale is not None:
            return self.spread(int8_back_project(self.rtm, self.scale, w))
        return self.spread(back_project(self.rtm, w))

    def fp_any(self, f: Tensor) -> Tensor:
        """``H f`` on whatever the problem stores: the forward seam; on a
        grid the rank's product summed over the voxel axis (the rank's
        pixel rows, complete)."""
        return self.voxel_sum(self._fp_local(f))

    def _fp_local(self, f: Tensor) -> Tensor:
        if self.lowrank is not None:
            return lowrank_forward(self.rtm, self.u, self.v, f, scale=self.scale,
                                   cols=self.cols, accum_dtype=self.dtype)
        if self.implicit is not None:
            return implicit_forward(self.rtm, f, self.implicit, accum_dtype=self.dtype)
        if self.rtm.shape[1] == 0:
            return torch.zeros(f.shape[:-1] + (self.rtm.shape[0],), dtype=f.dtype,
                               device=f.device)
        if self.scale is not None:
            return int8_forward_project(self.rtm, self.scale, self.gather(f))
        return forward_project(self.rtm, self.gather(f))

    def subset_forward(self, t: int, x: Tensor) -> Tensor:
        """``H_t x`` of the OS cycle's subset ``t`` (rows ``t::os``): fp32
        for a stored matrix (``ops/os_subsets.py``); the factored operator's
        S rows and U rows ``t::os``, or the ray rows ``t::os`` through the
        projector, in the compute dtype (the JAX cycle's ``subset_fwd``)."""
        n = self.os
        rows = os_subset_rows(self.rtm, t, n)
        if self.lowrank is not None:
            return lowrank_forward(rows, os_subset_rows(self.u, t, n), self.v, x,
                                   scale=self.scale, cols=self.cols, accum_dtype=self.dtype)
        if self.implicit is not None:
            return implicit_forward(rows, x, self.implicit, accum_dtype=self.dtype)
        return os_subset_forward(rows, self.gather(x), self.scale)

    def subset_back(self, t: int, w: Tensor) -> Tensor:
        """``H_t^T w`` of subset ``t``, ``[B, V]`` (see :meth:`subset_forward`)."""
        n = self.os
        rows = os_subset_rows(self.rtm, t, n)
        if self.lowrank is not None:
            return lowrank_back(rows, os_subset_rows(self.u, t, n), self.v, w,
                                scale=self.scale, cols=self.cols, accum_dtype=self.dtype)
        if self.implicit is not None:
            return implicit_back(rows, w, self.implicit, accum_dtype=self.dtype)
        return self.spread(os_subset_back(rows, w, self.scale))

    def compute_penalty(self, x: Tensor) -> Tensor:
        """``beta * L @ x`` per frame (zeros without a Laplacian); on a grid
        the rank's voxel block of it, through the halo partition."""
        if isinstance(self.lap, ShardedLaplacian):
            return self.beta * sharded_penalty(self.lap, x, self.grid)
        return self.beta * coo_matvec(self.lap, x)

    def initial_guess(self, g: Tensor) -> Tensor:
        """Eq. 4: ``H^T g / rho`` on unmasked voxels; the fp32 profile
        excludes negative measurements (sart_kernels.cu:34)."""
        if self.opts.mask_negative_guess:
            g = torch.where(g > 0, g, torch.zeros_like(g))
        accum = self.bp_any(g)
        return torch.where(self.vmask[None, :], accum / self.safe_dens[None, :],
                           torch.zeros_like(accum))

    def make_obs(self, g: Tensor, meas_mask: Tensor) -> Tensor:
        """Log variant's observation back-projection, once per measurement."""
        zero = torch.zeros_like(g)
        obs = self.bp_any(torch.where(meas_mask, g, zero) * self.inv_length)
        return torch.where(self.vmask[None, :], obs, torch.zeros_like(obs))

    def make_obs_sub(self, g: Tensor, meas_mask: Tensor) -> Tensor:
        """The OS cycle's per-subset observations ``[B, os, V]``: subset t's
        back-projection of the measurement, masked by its own voxel mask;
        once per measurement, as :meth:`make_obs`."""
        outs = []
        for t in range(self.os):
            g_t = os_subset_pixels(g, t, self.os)
            w_t = (torch.where(os_subset_pixels(meas_mask, t, self.os), g_t,
                               torch.zeros_like(g_t))
                   * os_subset_pixels(self.inv_length, t, self.os)[None, :])
            obs_t = self.subset_back(t, w_t)
            outs.append(torch.where(self.vmask_sub[t][None, :], obs_t, torch.zeros_like(obs_t)))
        return torch.stack(outs, dim=1)

    def log_exponent(self, B: int, dk: Optional[Tensor], ascale: Optional[Tensor]):
        """The log update's exponent ``relaxation * dk * ascale``: ``[B, 1]``,
        or the plain float when neither factor is on."""
        if dk is None and ascale is None:
            return self.opts.relaxation
        exponent = self.relax.expand(B)
        if dk is not None:
            exponent = exponent * dk
        if ascale is not None:
            exponent = exponent * ascale
        return exponent[:, None]

    def run_os_sweep(self, f: Tensor, dk: Optional[Tensor], ascale: Optional[Tensor],
                     g: Tensor, meas_mask: Tensor, obs_sub: Optional[Tensor]
                     ) -> Tuple[Tensor, Tensor]:
        """``(f_upd, fitted_upd)``: one outer iteration of the ordered-subsets
        cycle (``sartsolver_tpu/models/sart.py:run_os_sweep``). Sub-step t
        updates against the rows ``t::os`` with a fresh residual at the
        iterate the sub-steps before it left, its own inverse density (or
        observation) and mask; ``dk`` and ``ascale`` compose as in
        :meth:`run_sweep`; the Laplacian penalty is taken at the current
        iterate and scaled by ``1/os``, so a cycle applies the classic
        iteration's strength. Then one exact full forward projection of the
        final iterate: for int8 the subset products interleaved back, never
        the quantized-vector projection."""
        n = self.os
        pen_scale = 1.0 / n
        exponent = eps = None
        if self.opts.logarithmic:
            exponent = self.log_exponent(f.shape[0], dk, ascale)
            eps = torch.tensor(self.eps, dtype=self.dtype, device=f.device)
        nan_rows = []
        self._count_skipped()
        for t in range(n):
            m_t = os_subset_pixels(meas_mask, t, n)
            il_t = os_subset_pixels(self.inv_length, t, n)[None, :]
            with _span("os_subset_forward"):
                fitted_t = self.subset_forward(t, f)
            if self.opts.logarithmic:
                w = torch.where(m_t, fitted_t, torch.zeros_like(fitted_t)) * il_t
                with _span("os_subset_back"):
                    fit = self.subset_back(t, w)
                # the fp32 products widen to the compute dtype before the
                # ratio, as the JAX cycle's fp64 epsilon widens them
                fit = torch.where(self.vmask_sub[t][None, :], fit,
                                  torch.zeros_like(fit)).to(self.dtype)
                obs_t = obs_sub[:, t].to(self.dtype)
                f_new = f * ((obs_t + eps) / (fit + eps)) ** exponent
                if self.lap is not None:
                    f_new = f_new * torch.exp(-(self.compute_penalty(torch.log(f)) * pen_scale))
            else:
                g_t = os_subset_pixels(g, t, n)
                w = torch.where(m_t, g_t - fitted_t, torch.zeros_like(g_t)) * il_t
                if dk is not None:
                    w = w * dk[:, None]
                if ascale is not None:
                    w = w * ascale[:, None]
                with _span("os_subset_back"):
                    bp = self.subset_back(t, w)
                upd = f + self.inv_density_sub[t][None, :] * bp
                if self.lap is not None:
                    upd = upd - self.compute_penalty(f) * pen_scale
                f_new = torch.clamp_min(upd, 0)
            f = f_new
            if self.debug_nans:
                nan_rows.append(nanchk.row_flags(f))
        if self.debug_nans:
            self.os_nan_rows = torch.stack(nan_rows)
        with _span("os_full_forward"):
            if self.scale is not None:
                parts = [self.subset_forward(t, f) for t in range(n)]
                fitted = torch.stack(parts, dim=2).reshape(f.shape[0], self.rtm.shape[0])
            else:
                fitted = self.fp_any(f)
        return f, fitted

    def check_kept(self, where: str, f: Tensor, fitted: Tensor, conv: Tensor) -> None:
        """``debug_nans`` on an iteration's kept iterate, projection and
        Eq. 5 metric (nothing when off); an OS iterate names the first
        sub-step whose result held the NaN."""
        if not self.debug_nans:
            return
        what = nanchk.first_nan(("the iterate", f), ("the forward projection", fitted),
                                ("the Eq. 5 metric", conv))
        if what is None:
            return
        if what == "the iterate":
            step = "the sweep"
            if self.os > 1:
                step = "the OS cycle"
                hit = (self.os_nan_rows & torch.isnan(f).any(dim=1)[None, :]).any(dim=1)
                if bool(hit.any()):
                    step = f"OS sub-step {int(hit.to(torch.int8).argmax())}"
            what = f"the iterate after {step}"
        nanchk.fail(what, where)

    def run_fused(self, w: Tensor, f: Tensor, aux, **kw):
        """One call of the fused sweep; int8 codes carry their scale.
        Block-sparse: the kernel runs on the compacted matrix with ``f`` and
        the aux panels gathered at the occupied columns; every other column
        takes the update with ``bp = 0`` (the JAX package's base update,
        ``ops/fused_sweep.py:561-566``: the penalty still moves it), and the
        kernel's columns are scattered over it. No occupied column: no
        launch, ``fitted = 0``."""
        if self.scale is not None:
            kw["scale"] = self.scale[None, :]
        self._count_skipped()
        if self.grid is not None:
            return self.run_grid_sweep(w, f, aux, **kw)
        if self.cols is None:
            return self.sweep_fn(self.rtm, w, f, aux, **kw)
        base = _update_reference(f, torch.zeros_like(f), aux,
                                 logarithmic=kw["logarithmic"], alpha=kw.get("alpha", 1.0),
                                 eps=kw.get("eps", 0.0), alpha_lane=kw.get("alpha_lane"))
        if self.cols.numel() == 0:
            return base, torch.zeros_like(w)
        f_occ, fitted = self.sweep_fn(self.rtm, w, self.gather(f),
                                      [self.gather(a) for a in aux], **kw)
        return base.index_copy_(1, self.cols, f_occ), fitted

    def run_grid_sweep(self, w: Tensor, f: Tensor, aux, **kw):
        """The fused sweep on a grid of ranks. Pixel-sharded: the sweep
        split at the all-reduce — the rank's partial back projection
        (:func:`~sartsolver_tpu_torch.ops.fused_sweep.sharded_sweep_bp`),
        its sum over the pixel axis, then the update and the forward
        product of the rank's rows (``sharded_sweep_finish``); voxel-major:
        the fused sweep on the rank's column block. Either way the rank's
        ``fitted`` is then summed over the voxel axis. The plain versions
        run where ``sweep_fn`` is not the kernel's wrapper."""
        if self.pixel_sharded:
            kernel = self.sweep_fn is fused_sweep
            bp_fn = sharded_sweep_bp if kernel else sharded_sweep_bp_reference
            finish_fn = sharded_sweep_finish if kernel else sharded_sweep_finish_reference
            bp = self.pixel_sum(bp_fn(self.rtm, w))
            f_new, fitted = finish_fn(self.rtm, f, bp, aux, **kw)
        else:
            f_new, fitted = self.sweep_fn(self.rtm, w, f, aux, **kw)
        return f_new, self.voxel_sum(fitted)

    def run_sweep(self, f: Tensor, fitted: Tensor, penalty: Tensor,
                  g: Tensor, meas_mask: Tensor, obs: Optional[Tensor],
                  dk: Optional[Tensor] = None, ascale: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Optional[Tensor]]:
        """``(f_upd, fitted_upd or None)``: one iteration's update; the
        fused sweep also returns ``H f_upd``. ``dk`` [B] is the schedule's
        ``decay**k`` and ``ascale`` [B] the guard's step scale, each None
        when its variant is off (``sartsolver_tpu/models/sart.py:1705-1780``):
        the linear update folds both into ``w``; the log update takes
        ``relaxation * dk * ascale`` as its exponent, through the kernel's
        ``alpha_lane`` when fused (the guard keeps the log solver off the
        fused sweep, see :func:`resolve_fused`)."""
        opts = self.opts
        pen = [penalty] if self.lap is not None else []
        if opts.logarithmic:
            w = torch.where(meas_mask, fitted, torch.zeros_like(fitted)) * self.inv_length
            if self.fused:
                kw = {}
                if dk is not None:
                    kw["alpha_lane"] = (self.relax * dk)[:, None]
                return self.run_fused(
                    w, f, [self.vm, obs] + pen, logarithmic=True,
                    alpha=float(opts.relaxation), eps=self.eps, **kw,
                )
            fit = self.bp_any(w)
            if self.integrity:  # the raw product: the identity holds for all of H^T w
                self.bp_chk = (fit.sum(dim=1), (self.length_row * w).sum(dim=1))
            fit = torch.where(self.vmask[None, :], fit, torch.zeros_like(fit))
            eps = torch.tensor(self.eps, dtype=self.dtype, device=f.device)
            ratio = ((obs + eps) / (fit + eps)) ** self.log_exponent(f.shape[0], dk, ascale)
            return f * ratio * torch.exp(-penalty), None
        w = torch.where(meas_mask, g - fitted, torch.zeros_like(g)) * self.inv_length
        if dk is not None:
            # linear in w: the step factor folds into the pixel weights
            # (inv_density keeps the base relaxation)
            w = w * dk[:, None]
        if ascale is not None:
            w = w * ascale[:, None]
        if self.fused:
            return self.run_fused(
                w, f, [self.inv_density[None, :]] + pen, logarithmic=False,
            )
        bp = self.bp_any(w)
        if self.integrity:
            self.bp_chk = (bp.sum(dim=1), (self.length_row * w).sum(dim=1))
        return torch.clamp_min(f + self.inv_density[None, :] * bp - penalty, 0), None

    def abft_residual(self, s_a: Tensor, s_b: Tensor) -> Tuple[Tensor, Tensor]:
        """``(tripped [B], ratio [B])``: ``ratio`` is ``|s_a - s_b|`` over the
        band ``tol * (max(|s_a|, |s_b|) + 1)``, and a frame trips where it is
        above 1 or not a number. So an infinite residual trips too (the JAX
        check's ``err <= band`` holds for inf against an infinite band,
        which lets an overflowed product pass; its contract is that a
        non-finite residual trips)."""
        band = torch.maximum(s_a.abs(), s_b.abs()).add_(1.0).mul_(self.abft_tol)
        ratio = (s_a - s_b).abs_().div_(band)
        return ~(ratio <= 1.0), ratio

    def abft_check(self, f_new: Tensor, fitted_new: Tensor, done: Tensor) -> Tensor:
        """[B] live frames whose iteration broke an ABFT identity
        (``sartsolver_tpu/models/sart.py:abft_check``): the forward check
        on every path, the back-projection check after a two-matmul
        sweep. Where a record is kept (``abft_worst``), also folds the
        largest residual ratio of the live frames into it."""
        tripped, ratio = self.abft_residual(fitted_new.sum(dim=1), f_new @ self.dens)
        if self.bp_chk is not None:
            t_bp, r_bp = self.abft_residual(*self.bp_chk)
            tripped, ratio = tripped | t_bp, torch.maximum(ratio, r_bp)
            self.bp_chk = None
        live = ~done
        if self.abft_worst is not None:
            # fmax: a ratio that is not a number (a trip) leaves the record as is
            self.abft_worst = torch.fmax(
                self.abft_worst, torch.where(live, ratio, torch.zeros_like(ratio)).amax())
        return live & tripped

    def extrapolate(self, f: Tensor, f_prev: Tensor, tk: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor]:
        """``(y, beta [B, 1], t_next [B])``: the Nesterov/FISTA point —
        additive for the linear solver, multiplicative (log space, floored)
        for the log solver (``sartsolver_tpu/models/sart.py:1590-1606``)."""
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        beta = ((tk - 1.0) / t_next).to(self.dtype)[:, None]
        if self.opts.logarithmic:
            floor = self.mom_floor
            y = torch.clamp_min(
                f * (torch.clamp_min(f, floor) / torch.clamp_min(f_prev, floor)) ** beta,
                floor)
        else:
            y = f + beta * (f - f_prev)
        return y, beta, t_next

    def momentum_tk(self, y: Tensor, f_new: Tensor, f: Tensor, t_next: Tensor,
                    reset: Optional[Tensor]) -> Tensor:
        """The next t_k: 1 where the update moved against the extrapolation
        (gradient restart) or where ``reset`` (a rollback), else ``t_next``.
        A restart never touches the step scale."""
        rs = self.voxel_sum(((y - f_new) * (f_new - f)).sum(dim=1)) > 0
        if reset is not None:
            rs = rs | reset
        return torch.where(rs, torch.ones_like(t_next), t_next).to(self.dtype)

    def iterate(self, f: Tensor, fitted: Tensor, done: Tensor, g: Tensor,
                meas_mask: Tensor, obs: Optional[Tensor], msq: Tensor,
                dk: Optional[Tensor] = None, ascale: Optional[Tensor] = None,
                mom: Optional[tuple] = None) -> "_Step":
        """One iteration of every frame, done frames frozen, with the Eq. 5
        metric ``C^k`` of the new iterate. The one loop body of the batched
        solve and the scheduler's stride. ``mom`` is the momentum state
        ``(f_prev, fitted_prev or None, tk)``: the sweep then runs at the
        extrapolated point ``y`` (the penalty taken there too), while the
        frozen frames keep ``f``. With ``os_subsets > 1`` the OS cycle
        replaces the sweep (``obs`` is then ``[B, os, V]``); it computes
        every subset residual at ``y`` itself, so no projection of ``y``."""
        opts = self.opts
        base, fitted_base, y, t_next = f, fitted, None, None
        if mom is not None:
            f_prev, fitted_prev, tk = mom
            y, beta, t_next = self.extrapolate(f, f_prev, tk)
            base = y
        if self.os > 1:
            f_upd, fitted_upd = self.run_os_sweep(base, dk, ascale, g, meas_mask, obs)
        else:
            if mom is not None and opts.logarithmic:
                fitted_base = self.fp_any(y)  # no linearity: one projection
            elif mom is not None:
                fitted_base = fitted + beta * (fitted - fitted_prev)  # H y, exactly
            penalty = self.compute_penalty(torch.log(base) if opts.logarithmic else base)
            f_upd, fitted_upd = self.run_sweep(base, fitted_base, penalty, g, meas_mask, obs,
                                               dk, ascale)
        frozen = done[:, None]
        f_new = torch.where(frozen, f, f_upd)  # converged frames freeze
        if fitted_upd is None:
            fitted_new = self.fp_any(f_new)
        else:
            fitted_new = torch.where(frozen, fitted, fitted_upd)
        # each rank's ||Hf||^2 of its pixel rows, then one sum over the
        # pixel axis: every rank takes its stop decision from the same bytes
        fsq = self.pixel_sum(_sumsq(fitted_new, self.dtype, opts.precise_convergence))
        conv = (msq - fsq) / msq
        tripped = None
        if self.integrity:
            tripped = self.abft_check(f_new, fitted_new, done)
            if self.recovery:
                # a non-finite checksum is the divergence guard's to classify
                tripped = tripped & (torch.isfinite(fsq) & torch.isfinite(conv))
            # a tripped frame freezes on its entering state, the last
            # iterate whose checksums held
            rows = tripped[:, None]
            f_new = torch.where(rows, f, f_new)
            fitted_new = torch.where(rows, fitted, fitted_new)
        return _Step(f_new, fitted_new, fsq, conv, y, t_next, tripped)

    def guard(self, step: "_Step", f: Tensor, fitted: Tensor, conv_prev: Tensor,
              done: Tensor, msq: Tensor, ascale: Tensor, recov: Tensor):
        """The divergence guard on one iteration
        (``sartsolver_tpu/models/sart.py:1991-2010``): the candidate is judged
        before it is kept. Returns ``(f_new, fitted_new, conv, ascale,
        recov, bad, exhausted)``: a bad frame keeps its entering state and,
        unless its R recoveries are spent (``exhausted``), halves its step."""
        opts = self.opts
        fsq, conv = step.fsq, step.conv
        bad = ~done & (~(torch.isfinite(fsq) & torch.isfinite(conv))
                       | (fsq > opts.divergence_threshold * torch.clamp_min(msq, 1.0)))
        if step.tripped is not None:
            bad = bad & ~step.tripped  # a finite SDC mismatch outranks the rollback
        exhausted = bad & (recov >= self.recovery)
        rows = bad[:, None]
        f_new = torch.where(rows, f, step.f)
        fitted_new = torch.where(rows, fitted, step.fitted)
        conv = torch.where(bad, conv_prev, conv)
        if step.tripped is not None:
            conv = torch.where(step.tripped, conv_prev, conv)
        ascale = torch.where(bad & ~exhausted, ascale * 0.5, ascale)
        return f_new, fitted_new, conv, ascale, recov + bad.to(torch.int32), bad, exhausted

    def input_bad(self, g: Tensor, f: Tensor, msq: Tensor) -> Tensor:
        """[B] frames whose measurement, start or ``||g||^2`` is not finite:
        no iterate of theirs can be rolled back to."""
        if self.grid is None:
            return ((~torch.isfinite(g)).any(dim=1) | (~torch.isfinite(f)).any(dim=1)
                    | ~torch.isfinite(msq))
        # the counts of non-finite values over the grid (the JAX gbad/fbad)
        gbad = self.pixel_sum((~torch.isfinite(g)).sum(dim=1))
        fbad = self.voxel_sum((~torch.isfinite(f)).sum(dim=1))
        return (gbad > 0) | (fbad > 0) | ~torch.isfinite(msq)


class _Step(NamedTuple):
    """One iteration's candidate: the new iterate and its projection, its
    ``||Hf||^2`` and metric, and (momentum) the extrapolated point and the
    next FISTA t."""

    f: Tensor
    fitted: Tensor
    fsq: Tensor
    conv: Tensor
    y: Optional[Tensor]
    t_next: Optional[Tensor]
    tripped: Optional[Tensor] = None  # [B] the ABFT check's trips (integrity on)


def _floor_start(f0: Tensor, opts: SolverOptions) -> Tensor:
    """The floors of a start that is not the solver's own loop exit: the
    guess floor, and for the log variant a positive iterate (a zero voxel
    is log(0) in the penalty and never recovers)."""
    if opts.guess_floor > 0:
        f0 = torch.clamp_min(f0, _tiny(opts.guess_floor))
    if opts.logarithmic:
        f0 = torch.clamp_min(f0, _tiny(max(opts.guess_floor, opts.log_epsilon)))
    return f0


def _sumsq(x: Tensor, dtype: torch.dtype, precise: bool) -> Tensor:
    """``sum(x**2, axis=1)`` in ``dtype``. ``precise``: accumulated in fp64
    and rounded — the Eq. 5 stall test flips on one-ulp changes of
    ``||Hf||^2``, so its sum must not drift with the summation order (the
    JAX package's x64 branch); otherwise the reference CUDA path's plain
    dot (sartsolver_cuda.cpp:253)."""
    if not precise:
        return (x * x).sum(dim=1)
    x64 = x.to(torch.float64)
    return (x64 * x64).sum(dim=1).to(dtype)


def solve_normalized_batch(
    problem: SARTProblem,
    g: Tensor,  # [B, P]
    msq: Tensor,  # [B]
    f0: Tensor,  # [B, V]
    *,
    opts: SolverOptions,
    use_guess: bool,
    fitted0: Optional[Tensor] = None,
    return_fitted: bool = False,
    device="cuda",
    sweep_fn: SweepFn = fused_sweep,
    debug_nans: bool = False,
) -> "SolveResult | Tuple[SolveResult, Tensor]":
    """Solver core on pre-normalized measurements: B independent frames in
    one loop.

    ``g``/``f0`` are divided by each frame's norm; ``msq`` is the normalized
    ``||g||^2`` with non-positive measurements excluded. ``fitted0`` (only
    with ``use_guess=False``) is a carried ``H @ f0`` — a warm start's
    loop-exit projection — which replaces the setup forward projection.
    ``return_fitted=True`` also returns the loop-exit ``fitted == H @
    solution`` ``[B, P]``. ``sweep_fn`` is the fused sweep's implementation;
    only tests and the chip smoke run set it, to the plain version.
    ``debug_nans=True`` raises ``FloatingPointError`` at the first NaN the
    solve keeps (``sartsolver_tpu_torch/debug_nans.py``).

    The variants (``sartsolver_tpu/models/sart.py:1894-2066``, without the
    integrity check): the OS cycle in place of the sweep, with the log
    variant's per-subset observations; the schedule factor of the loop's
    count; the momentum state ``(f_prev, fitted_prev, t_k)``, started at
    ``(f0, fitted0, 1)``; the divergence guard's per-frame step scale,
    recovery count and DIVERGED latch, a rolled-back frame never passing
    the stall test on its unchanged metric, and a restart OR'd with a
    rollback; and the guard's pre-flight check, which stops a frame with a
    non-finite measurement, start or ``||g||^2`` as DIVERGED at iteration
    0 with a zero solution.
    """
    dev = resolve_device(device)
    check_on(dev, rtm=problem.rtm, rtm_scale=problem.rtm_scale, g=g, msq=msq,
             f0=f0, fitted0=fitted0)
    dtype = torch_dtype(opts.dtype)
    B = g.shape[0]
    kit = _SweepContext(problem, opts, sweep_fn, debug_nans)
    g = g.to(dtype)
    meas_mask = g >= 0  # [B, P]

    if fitted0 is not None and use_guess:
        raise ValueError(
            "fitted0 carries a warm start's forward projection; it cannot "
            "be combined with use_guess=True."
        )
    if use_guess:
        f0 = kit.initial_guess(g)
    if fitted0 is None or opts.logarithmic:
        # A linear carried warm start skips the guess floor: it is this
        # solver's own loop-exit solution, and flooring it would break the
        # exact fitted0 == H @ f0 pair. The log variant floors every start.
        f0 = _floor_start(f0, opts)
    f = f0.to(dtype)
    fitted = kit.fp_any(f) if fitted0 is None else fitted0.to(dtype)

    tol = torch.tensor(opts.conv_tolerance, dtype=dtype, device=dev)
    msq = msq.to(dtype)
    obs = None
    if opts.logarithmic:
        obs = kit.make_obs_sub(g, meas_mask) if kit.os > 1 else kit.make_obs(g, meas_mask)

    conv_prev = torch.zeros(B, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), opts.max_iterations, dtype=torch.int32, device=dev)
    ascale = recov = diverged = mom = None
    if kit.recovery:
        # pre-flight: a frame with a non-finite input has no good iterate
        bad_in = kit.input_bad(g, f, msq)
        rows = bad_in[:, None]
        f = torch.where(rows, torch.zeros_like(f), f)
        fitted = torch.where(rows, torch.zeros_like(fitted), fitted)
        done, diverged = bad_in, bad_in
        iters = torch.where(bad_in, torch.zeros_like(iters), iters)
        ascale = torch.ones(B, dtype=dtype, device=dev)
        recov = torch.zeros(B, dtype=torch.int32, device=dev)
    if debug_nans:
        nanchk.check("the start of the solve",
                     ("the guess" if use_guess else "the warm start", f),
                     ("the set-up projection", fitted), ("the observation back-projection", obs))
    if kit.momentum:  # t_1 = 1: the first iteration extrapolates nothing
        mom = (f, fitted if kit.carry_fit else None, torch.ones(B, dtype=dtype, device=dev))
    sdc = torch.zeros_like(done) if kit.integrity else None
    it = 0
    while it < opts.max_iterations and not bool(done.all()):
        dk = (kit.decay_factor(torch.full((B,), it, dtype=torch.int32, device=dev))
              if kit.scheduled else None)
        step = kit.iterate(f, fitted, done, g, meas_mask, obs, msq, dk, ascale, mom)
        f_new, fitted_new, conv, tripped = step.f, step.fitted, step.conv, step.tripped
        if tripped is not None:
            conv = torch.where(tripped, conv_prev, conv)
        bad = None
        if kit.recovery:
            f_new, fitted_new, conv, ascale, recov, bad, exhausted = kit.guard(
                step, f, fitted, conv_prev, done, msq, ascale, recov)
        kit.check_kept(f"iteration {it + 1}", f_new, fitted_new, conv)
        if it >= 1:  # Eq. 5 stall test, from the second iteration on
            newly = ~done & (torch.abs(conv - conv_prev) < tol)
            if bad is not None:  # a rolled-back metric is not a stall
                newly &= ~bad
        else:
            newly = torch.zeros_like(done)
        if tripped is not None:  # a frozen SDC frame's metric is not a stall
            newly = newly & ~tripped
        ended = newly
        if kit.recovery:
            ended = newly | exhausted
            diverged = diverged | exhausted
        if tripped is not None:
            ended = ended | tripped
            sdc = sdc | tripped
        iters = torch.where(ended, torch.full_like(iters, it + 1), iters)
        if kit.momentum:
            reset = bad if tripped is None else (tripped if bad is None else bad | tripped)
            mom = (f, fitted if kit.carry_fit else None,
                   kit.momentum_tk(step.y, f_new, f, step.t_next, reset))
        f, fitted, conv_prev, done = f_new, fitted_new, conv, done | ended
        it += 1
    status = torch.where(
        done, torch.full_like(iters, SUCCESS),
        torch.full_like(iters, MAX_ITERATIONS_EXCEEDED),
    )
    if diverged is not None:
        status = torch.where(diverged, torch.full_like(iters, DIVERGED), status)
    if sdc is not None:
        status = torch.where(sdc, torch.full_like(iters, SDC_DETECTED), status)
        _note_abft(kit)
    res = SolveResult(f, status, iters, conv_prev)
    return (res, fitted) if return_fitted else res


def solve_chain_normalized(
    problem: SARTProblem,
    g: Tensor,  # [K, P]
    msq: Tensor,  # [K]
    f0: Tensor,  # [1, V] seed of frame 0 (ignored when guessing)
    rescale: Tensor,  # [K] warm-start renormalization factors
    *,
    opts: SolverOptions,
    use_guess_first: bool,
    fitted0: Optional[Tensor] = None,
    device="cuda",
    debug_nans: bool = False,
    sweep_fn: SweepFn = fused_sweep,
) -> Tuple[SolveResult, Tensor]:
    """K warm-chained frames, each a B = 1 solve of
    :func:`solve_normalized_batch`: frame 0 from the Eq. 4 guess (or the
    seed ``f0``), each next frame from the previous frame's solution and
    loop-exit ``fitted``, both times ``rescale[k]`` (``norm_{k-1} /
    norm_k``; ``rescale[0]`` rescales the seed and ``fitted0``). The ops of
    the CLI's serial warm start, so the frames equal K serial solves.

    Returns ``(SolveResult with a leading K axis, fitted [1, P] of the last
    frame)``: ``solution[-1]`` and that ``fitted`` seed a following chain.
    """
    if use_guess_first and fitted0 is not None:
        raise ValueError(
            "fitted0 carries a warm start's forward projection; it cannot "
            "be combined with use_guess_first=True."
        )
    rescale = rescale.to(torch_dtype(opts.dtype))

    def one(k, f_start, fit_start, use_guess):
        return solve_normalized_batch(
            problem, g[k:k + 1], msq[k:k + 1], f_start, opts=opts,
            use_guess=use_guess, fitted0=fit_start, return_fitted=True,
            device=device, debug_nans=debug_nans, sweep_fn=sweep_fn,
        )

    if use_guess_first:
        res, fit = one(0, torch.zeros_like(f0), None, True)
    else:
        res, fit = one(0, f0 * rescale[0],
                       None if fitted0 is None else fitted0 * rescale[0], False)
    parts = [res]
    for k in range(1, g.shape[0]):
        res, fit = one(k, res.solution * rescale[k], fit * rescale[k], False)
        parts.append(res)
    return SolveResult(*(torch.cat(field) for field in zip(*parts))), fit


class SchedState(NamedTuple):
    """Lane state carried across scheduler strides, on the device.

    Every leading dimension is the fixed lane count B. Inert lanes (never
    filled, or retired and awaiting backfill) hold ``done=True`` with
    placeholder data (``g=-1``: every pixel masked; ``f=1``: log-safe;
    ``msq=1``): their sweeps still run (fixed shape) and the ``done``
    freeze discards every result, as the batched loop does for converged
    frames. The variants' per-lane state is None while its variant is off.
    """

    g: Tensor  # [B, P] normalized measurement (-1 rows: inert)
    msq: Tensor  # [B] normalized ||g||^2 (1 for inert lanes)
    f: Tensor  # [B, V] current iterate
    fitted: Tensor  # [B, P] H @ f
    conv: Tensor  # [B] previous convergence metric C^k
    it: Tensor  # [B] int32, iterations completed by the current occupant
    done: Tensor  # [B] bool, frozen (converged, capped, diverged or inert)
    status: Tensor  # [B] int32, SUCCESS / MAX_ITERATIONS_EXCEEDED / DIVERGED
    iters: Tensor  # [B] int32, iteration count latched at retirement
    obs: Optional[Tensor]  # [B, V] log variant's observation ([B, os, V] with OS); None linear
    ascale: Optional[Tensor] = None  # [B] the guard's step scale
    recov: Optional[Tensor] = None  # [B] int32, the guard's recoveries spent
    f_prev: Optional[Tensor] = None  # [B, V] momentum: the previous iterate
    fitted_prev: Optional[Tensor] = None  # [B, P] its projection (linear)
    tk: Optional[Tensor] = None  # [B] momentum: FISTA t_k


def sched_step_normalized(
    problem: SARTProblem,
    state: SchedState,
    g_new: Optional[Tensor],  # [B, P] normalized rows for refilled lanes
    msq_new: Optional[Tensor],  # [B]
    refill,  # [B] host bools: lanes to (re)load before stepping
    *,
    opts: SolverOptions,
    device="cuda",
    debug_nans: bool = False,
) -> SchedState:
    """One scheduler stride: load the ``refill`` lanes, then run at most
    ``opts.schedule_stride`` iterations of every lane that is not done.

    A refilled lane starts as a frame of the batched ``use_guess`` path
    does, with the same ops: the Eq. 4 guess, its floors, its forward
    projection and, for the log variant, ``obs`` (taken for every lane and
    kept for the refilled ones); its momentum and guard state start over,
    and the guard's pre-flight check runs on the refilled lanes only (with
    ``os_subsets > 1`` ``obs`` holds the per-subset observations ``[B, os,
    V]``). The host knows ``refill``, so a stride with no refill
    (``g_new``/``msq_new`` may be None) skips that part.

    Each lane runs its own stall test from its own second iteration, its own
    schedule factor and guard, and stops at ``max_iterations``; ``iters``
    and ``status`` are latched once, after the loop, for the lanes that
    stopped in it. The loop ends early once every lane is done. The
    returned state is built from new tensors: ``state`` itself is never
    written.
    """
    dev = resolve_device(device)
    dtype = torch_dtype(opts.dtype)
    kit = _SweepContext(problem, opts, fused_sweep, debug_nans)
    refill = np.asarray(refill, bool)
    if refill.any():
        check_on(dev, g_new=g_new, msq_new=msq_new)
        lanes = torch.as_tensor(refill, device=dev)
        rows = lanes[:, None]
        g = torch.where(rows, g_new.to(dtype), state.g)
        msq = torch.where(lanes, msq_new.to(dtype), state.msq)
        f0 = _floor_start(kit.initial_guess(g), opts).to(dtype)
        fitted0 = kit.fp_any(f0)
        obs = state.obs
        if opts.logarithmic and kit.os > 1:
            obs = torch.where(lanes[:, None, None], kit.make_obs_sub(g, g >= 0), state.obs)
        elif opts.logarithmic:
            obs = torch.where(rows, kit.make_obs(g, g >= 0), state.obs)
        f = torch.where(rows, f0, state.f)
        fitted = torch.where(rows, fitted0, state.fitted)
        done = state.done & ~lanes
        status = torch.where(lanes, torch.full_like(state.status, MAX_ITERATIONS_EXCEEDED),
                             state.status)
        iters = torch.where(lanes, torch.full_like(state.iters, opts.max_iterations),
                            state.iters)
        extra = {}
        if kit.recovery:
            extra["ascale"] = torch.where(lanes, torch.ones_like(state.ascale), state.ascale)
            extra["recov"] = torch.where(lanes, torch.zeros_like(state.recov), state.recov)
            bad_in = lanes & kit.input_bad(g, f, msq)
            f = torch.where(bad_in[:, None], torch.zeros_like(f), f)
            fitted = torch.where(bad_in[:, None], torch.zeros_like(fitted), fitted)
            done = done | bad_in
            status = torch.where(bad_in, torch.full_like(status, DIVERGED), status)
            iters = torch.where(bad_in, torch.zeros_like(iters), iters)
        if kit.momentum:  # the lane's FISTA sequence starts over at its guess
            extra["f_prev"] = torch.where(rows, f0, state.f_prev)
            if kit.carry_fit:
                extra["fitted_prev"] = torch.where(rows, fitted0, state.fitted_prev)
            extra["tk"] = torch.where(lanes, torch.ones_like(state.tk), state.tk)
        state = state._replace(
            g=g, msq=msq, f=f, fitted=fitted,
            conv=torch.where(lanes, torch.zeros_like(state.conv), state.conv),
            it=torch.where(lanes, torch.zeros_like(state.it), state.it),
            done=done, status=status, iters=iters, obs=obs, **extra,
        )
        if debug_nans:  # the lanes' state is the stride's result, measurements too
            nanchk.check("the refill of a scheduler stride", ("the lanes' measurements", g),
                         ("the guess", state.f), ("the set-up projection", state.fitted),
                         ("the observation back-projection", obs))

    g, msq, obs = state.g, state.msq, state.obs
    meas_mask = g >= 0
    tol = torch.tensor(opts.conv_tolerance, dtype=dtype, device=dev)
    f, fitted, conv_prev, itl, done = state.f, state.fitted, state.conv, state.it, state.done
    ascale, recov = state.ascale, state.recov
    mom = (state.f_prev, state.fitted_prev, state.tk) if kit.momentum else None
    # A lane that is live at step s has run it + s iterations, so its stall
    # test is armed from step 1 on (at step 0 only if it >= 1) and it hits
    # the batched loop's `it < max_iterations` exit at step cap_step. Each
    # step then launches few more small ops than the batched loop's.
    armed = state.it >= 1
    cap_step = opts.max_iterations - 1 - state.it
    converged = torch.zeros_like(done)
    diverged = torch.zeros_like(done) if kit.recovery else None
    sdc = torch.zeros_like(done) if kit.integrity else None
    step = 0
    while step < opts.schedule_stride and not bool(done.all()):
        dk = kit.decay_factor(itl) if kit.scheduled else None
        out = kit.iterate(f, fitted, done, g, meas_mask, obs, msq, dk, ascale, mom)
        f_new, fitted_new, conv, tripped = out.f, out.fitted, out.conv, out.tripped
        if tripped is not None:
            conv = torch.where(tripped, conv_prev, conv)
        live = ~done
        bad = None
        if kit.recovery:
            f_new, fitted_new, conv, ascale, recov, bad, exhausted = kit.guard(
                out, f, fitted, conv_prev, done, msq, ascale, recov)
            live_ok = live & ~bad  # a rolled-back metric is not a stall
        else:
            live_ok = live
        if tripped is not None:  # nor is a frozen SDC lane's
            live_ok = live_ok & ~tripped
        kit.check_kept(f"step {step + 1} of a scheduler stride", f_new, fitted_new, conv)
        newly = live_ok & (torch.abs(conv - conv_prev) < tol)
        if step == 0:
            newly &= armed
        converged |= newly
        ended = newly
        if kit.recovery:
            diverged |= exhausted
            ended = newly | exhausted
        if tripped is not None:
            sdc |= tripped
            ended = ended | tripped
        if kit.momentum:
            reset = bad if tripped is None else (tripped if bad is None else bad | tripped)
            mom = (f, fitted if kit.carry_fit else None,
                   kit.momentum_tk(out.y, f_new, f, out.t_next, reset))
        itl = itl + live
        f, fitted = f_new, fitted_new
        conv_prev, done = conv, done | ended | (cap_step <= step)
        step += 1
    stopped = done & ~state.done
    status = torch.where(converged, torch.full_like(state.status, SUCCESS), state.status)
    if kit.recovery:
        status = torch.where(diverged, torch.full_like(status, DIVERGED), status)
    if sdc is not None:
        status = torch.where(sdc, torch.full_like(status, SDC_DETECTED), status)
        _note_abft(kit)
    iters = torch.where(stopped, itl, state.iters)
    if mom is not None:
        state = state._replace(f_prev=mom[0], fitted_prev=mom[1], tk=mom[2])
    return state._replace(f=f, fitted=fitted, conv=conv_prev, it=itl, done=done,
                          status=status, iters=iters, ascale=ascale, recov=recov)


# the once-per-run latch of the non-finite-pixel warning
# (sartsolver_tpu/models/sart.py:2682-2707)
_NONFINITE_WARN_STATE = {"latched": False}


def reset_nonfinite_warning() -> None:
    """Re-arm the once-per-run non-finite-pixel warning. Called at the start
    of every CLI run and of every serving-engine request, so a resident
    process warns once per unit of user-visible work, not once per process
    (Python's own filter would show a ``warnings.warn`` once per location)."""
    _NONFINITE_WARN_STATE["latched"] = False


def _warn_nonfinite(n_bad: int) -> None:
    if _NONFINITE_WARN_STATE["latched"]:
        return
    _NONFINITE_WARN_STATE["latched"] = True
    # warn_explicit with a throwaway registry: Python's per-location dedup
    # never latches, so the latch above is the only gate
    warnings.warn_explicit(
        f"measurement frames contain {n_bad} non-finite pixel(s); they "
        "are excluded from normalization, ||g||^2 and the solve",
        RuntimeWarning, __file__, 0, registry={},
    )


def prepare_measurement(measurement, opts: SolverOptions):
    """Host fp64 pre-step (sartsolver_cuda.cpp:138-194): returns
    ``(g64_normalized, msq, norm)``.

    ``norm`` is the measurement's max (1.0 when normalization is off or the
    frame is dark); ``msq`` the normalized ``||g||^2`` over positive
    measurements, remapped to 1.0 for a dark frame so the stop test still
    terminates. Non-finite pixels are excluded from ``norm`` (a NaN-poisoned
    frame still denormalizes by a finite factor) and, as non-positive
    measurements, from the solve's mask, with a warning; each call counts
    them into the ``nonfinite_pixels_total`` counter. They stay
    non-finite in ``g`` (and a +inf pixel makes ``msq`` infinite), so the
    divergence guard's pre-flight check sees them
    (``sartsolver_tpu/models/sart.py:2742-2752``). The warning is shown once
    a run or a served request (:func:`reset_nonfinite_warning`).
    """
    g64 = np.asarray(measurement, dtype=np.float64)
    n_bad = int(np.count_nonzero(~np.isfinite(g64)))
    if n_bad:
        obs_metrics.get_registry().counter("nonfinite_pixels_total").inc(n_bad)
        _warn_nonfinite(n_bad)
    if opts.normalize:
        norm = float(np.max(g64[np.isfinite(g64)], initial=0.0))
        if norm <= 0:
            norm = 1.0
    else:
        norm = 1.0
    msq = float(np.sum(np.where(g64 > 0, g64, 0.0) ** 2)) / (norm * norm)
    if msq <= 0:
        msq = 1.0
    return g64 / norm, msq, norm


def solve(problem: SARTProblem, measurement, f0=None, *, opts: SolverOptions,
          device="cuda", sweep_fn: SweepFn = fused_sweep) -> SolveResult:
    """Solve one frame on a full problem. ``measurement`` [P] and ``f0``
    [V] are host arrays in physical units; the result is on ``device``."""
    dev = resolve_device(device)
    dtype = torch_dtype(opts.dtype)
    g64, msq, norm = prepare_measurement(measurement, opts)
    g = torch.as_tensor(g64, device=dev).to(dtype)
    nvoxel = problem.ray_density.shape[0]
    use_guess = f0 is None
    if use_guess:
        f0 = torch.zeros(nvoxel, dtype=dtype, device=dev)
    else:
        f0 = torch.as_tensor(np.asarray(f0, np.float64) / norm, device=dev).to(dtype)
    res = solve_normalized_batch(
        problem, g[None, :], torch.tensor([msq], dtype=dtype, device=dev),
        f0[None, :], opts=opts, use_guess=use_guess, device=dev,
        sweep_fn=sweep_fn,
    )
    scale = torch.tensor(norm, dtype=dtype, device=dev)
    return SolveResult(res.solution[0] * scale, res.status[0],
                       res.iterations[0], res.convergence[0])
