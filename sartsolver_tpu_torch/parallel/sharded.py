"""Upload once, solve many frames: the solver object of the CLI's loops.

Counterpart of ``sartsolver_tpu/parallel/sharded.py`` on one device: the
matrix is uploaded once (:func:`~sartsolver_tpu_torch.models.sart.make_problem`),
then frames are solved in batches (:meth:`DistributedSARTSolver.solve_batch`),
in warm-started chains (:meth:`~DistributedSARTSolver.solve_chain`) or as
continuous-batching lanes (:meth:`~DistributedSARTSolver.sched_lanes` and
:meth:`~DistributedSARTSolver.sched_step`). It takes ``device=`` where the
JAX class takes a mesh; the multi-GPU slice extends it.

Frames arrive as host arrays in physical units and are normalized on the
host (:func:`~sartsolver_tpu_torch.models.sart.prepare_measurement`).
Results stay on the device: their scalars come back in one packed copy,
their solutions when fetched. Uploads are ``device.put`` trace spans and
fetches ``result.fetch{what=...}`` spans, as in the JAX module.

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

from sartsolver_tpu_torch.config import MAX_ITERATIONS_EXCEEDED, SolverOptions
from sartsolver_tpu_torch.device import resolve_device
from sartsolver_tpu_torch.models.sart import (
    SchedState,
    SolveResult,
    make_problem,
    prepare_measurement,
    sched_step_normalized,
    solve_chain_normalized,
    solve_normalized_batch,
    torch_dtype,
)
from sartsolver_tpu_torch.obs import trace as obs_trace


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
    (:meth:`fetch_solutions`), denormalized on the host in fp64.
    """

    def __init__(self, res: SolveResult, norms, fitted_norm: torch.Tensor):
        self.solution_norm = res.solution
        self.fitted_norm = fitted_norm
        self.norms = np.asarray(norms, np.float64)  # [B]
        # fp64 holds the int32 counts and either compute dtype exactly
        self._packed = torch.stack([res.status.double(), res.iterations.double(),
                                    res.convergence.double()])
        self._scalars: Optional[tuple] = None
        self._host: Optional[np.ndarray] = None

    def _fetch_scalars(self) -> tuple:
        if self._scalars is None:
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
            with obs_trace.span("result.fetch", what="solution"):
                sol = self.solution_norm.double().cpu().numpy()
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
            with obs_trace.span("result.fetch", what="sched_lane"):
                return row.double().cpu().numpy() * norm
        return fetch


class DistributedSARTSolver:
    """Upload-once, solve-many-frames solver on one device.

    ``rtm`` [P, V] is a host array or a tensor, stored as
    ``opts.rtm_dtype`` (int8: quantized where it lies); ``laplacian`` a :class:`~sartsolver_tpu_torch.ops.laplacian.LaplacianCOO`
    on ``device``. :meth:`close` (or leaving a ``with`` block) releases the
    device copy of the matrix. ``debug_nans=True``: every solve raises
    ``FloatingPointError`` at the first NaN it keeps (``debug_nans.py``).
    """

    def __init__(self, rtm, laplacian=None, *, opts: SolverOptions, device="cuda",
                 debug_nans: bool = False):
        self.device = resolve_device(device)
        self.opts = opts
        self.debug_nans = debug_nans
        self.dtype = torch_dtype(opts.dtype)
        npixel = np.shape(rtm)[0]
        # the rows the device holds: npixel, or the OS cycle's padded extent
        self.rows = os_padded_rows(npixel, opts.os_subsets)
        if self.rows != npixel:
            rtm = _pad_rows(rtm, self.rows)
        with obs_trace.span("device.put"):
            self.problem = make_problem(rtm, laplacian, opts=opts, device=self.device)
        self.npixel, self.nvoxel = npixel, self.problem.rtm.shape[1]

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

    def _stage_frames(self, measurements):
        """Normalize B host frames [B, P] as prepare_measurement does:
        ``(g [B, P], msq [B])`` on the device and the norms [B] on the host."""
        G = np.asarray(measurements, np.float64)
        if G.ndim != 2 or G.shape[1] != self.npixel:
            raise ValueError(f"Measurements must be [B, {self.npixel}], got {G.shape}.")
        gs, msqs, norms = zip(*(prepare_measurement(row, self.opts) for row in G))
        with obs_trace.span("device.put"):
            g = torch.as_tensor(self._pad_frames(np.stack(gs)),
                                device=self.device).to(self.dtype)
            msq = torch.as_tensor(np.asarray(msqs), device=self.device).to(self.dtype)
        return g, msq, np.asarray(norms, np.float64)

    def _pad_frames(self, g: np.ndarray) -> np.ndarray:
        """Normalized frames [B, npixel] with the padded rows' -1 (masked)."""
        if self.rows == self.npixel:
            return g
        return np.concatenate([g, np.full((g.shape[0], self.rows - self.npixel), -1.0)],
                              axis=1)

    def solve_batch(self, measurements) -> DeviceSolveResult:
        """Solve B independent frames [B, P] in one batched loop, each from
        the Eq. 4 guess. The caller pads a short tail if it wants a fixed
        batch size."""
        problem = self._live_problem()
        g, msq, norms = self._stage_frames(measurements)
        seed = torch.zeros((g.shape[0], self.nvoxel), dtype=self.dtype, device=self.device)
        res, fitted = solve_normalized_batch(
            problem, g, msq, seed, opts=self.opts, use_guess=True,
            return_fitted=True, device=self.device, debug_nans=self.debug_nans,
        )
        return DeviceSolveResult(res, norms, fitted_norm=fitted)

    def solve_chain(self, measurements, *,
                    warm: Optional[DeviceSolveResult] = None) -> DeviceSolveResult:
        """Solve K warm-chained frames [K, P]: each frame from the previous
        one's solution. Frame 0 seeds from ``warm`` (a previous result of
        this solver: its last frame's solution and loop-exit ``fitted``,
        still on the device), else from the Eq. 4 guess. Per frame equal to
        K serial solves."""
        problem = self._live_problem()
        g, msq, norms = self._stage_frames(measurements)
        rescale = np.ones(len(norms))
        rescale[1:] = norms[:-1] / norms[1:]
        if warm is None:
            seed = torch.zeros((1, self.nvoxel), dtype=self.dtype, device=self.device)
            fitted0 = None
        else:
            rescale[0] = warm.norms[-1] / norms[0]
            seed, fitted0 = warm.solution_norm[-1:], warm.fitted_norm[-1:]
        res, fitted = solve_chain_normalized(
            problem, g, msq, seed, torch.as_tensor(rescale, device=self.device),
            opts=self.opts, use_guess_first=warm is None, fitted0=fitted0,
            device=self.device, debug_nans=self.debug_nans,
        )
        return DeviceSolveResult(res, norms, fitted_norm=fitted)

    # ---- continuous batching (sched/) -----------------------------------

    def sched_lanes(self, lanes: int) -> SchedLaneState:
        """Fresh, all-inert lane state for :meth:`sched_step`: ``g = -1``
        (every pixel masked), ``f = 1`` (log-safe), ``msq = 1``, done; with
        the guard, step scale 1 and no recovery spent; with momentum, ``f_prev
        = 1`` (the inert iterate), ``fitted_prev = 0`` (the linear classic
        sweep only) and ``t = 1``. The log variant's ``obs`` is ``[B, os,
        V]`` with ordered subsets, else ``[B, V]``."""
        self._live_problem()
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
        problem = self._live_problem()
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
