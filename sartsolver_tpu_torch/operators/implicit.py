"""Matrix-free geometry-driven projection (the implicit operator).

Counterpart of ``sartsolver_tpu/operators/implicit.py``. The dense solver
stores ``H`` as a ``[npixel, nvoxel]`` matrix; this module never does: each
entry ``H[p, v]`` is the length of ray ``p``'s segment inside voxel ``v``'s
axis-aligned box, a pure function of the packed ray table (``[P, 6]``:
origin xyz, unit direction xyz) and the regular grid, recomputed on the fly
by the slab method. A resident session holds the rays, O(P) bytes.

Two versions of the same products:

- on a CUDA tensor, the hand-written kernel ``ops/csrc/implicit.cu``
  (:func:`_kernel_project`), which visits only the cells a ray can cross:
  the forward walks each ray's x-slabs, y rows and z cells in voxel-id
  order (one launch); the back gives a block a brick of 128 cells, culls
  the rays by index boxes over 32 and 1024 consecutive rays and then by
  the exact slab test against the brick widened by one cell, and sums the
  survivors in ray order (two launches). Each entry is computed in
  registers and applied to up to eight batch rows; no atomics;
- on a CPU tensor, the plain version: :func:`panel_lengths` rebuilds a
  ``[P, panel]`` block of entries with the JAX function's arithmetic, step
  for step, and a matrix product contracts it, a chunk of columns at a time.

A CUDA tensor never takes the plain version, and a CPU tensor never the
kernel. The entries of the two are the same floats (the kernel writes the
corner and slab arithmetic with round-to-nearest intrinsics, so no step is
contracted); the sums agree within their summation order. The kernel's
candidate cells may exceed the nonzero ones, never miss one: each range is
estimated, widened by one cell and then extended while the next cell out
can still hold a segment, a test that is monotone in the cell index under
the kernel's rounded arithmetic, so the margin holds at any coordinate
magnitude. :func:`candidate_cells` and :func:`tile_survivors` repeat that
choice in plain torch for the tests and chip_smoke.py's count of the pairs
evaluated; nothing on the main path calls them.
``implicit_forward.launches`` and ``implicit_back.launches`` count the
entry points' calls on the card; ray stats and the ordered-subsets
densities run through the same two (all-ones and subset-indicator
operands).

Masking conventions are the JAX package's: zero-padded ray rows (direction
norm 0) and padding columns (``vox >= grid_voxels``) project to zero.

The port's solver holds no padding columns: it builds its spec with
``padded_nvoxel`` = the grid's voxel count and a panel that divides it
(:func:`divisor_panel`), where the JAX solver pads to a multiple of 128 with
inert zero columns. The compile-audit registration of the JAX module has no
counterpart here.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import hashlib
import json
from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from sartsolver_tpu_torch.analysis.registry import opaque as _audit_opaque
from sartsolver_tpu_torch.operators.base import ProjectionOperator
from sartsolver_tpu_torch.operators.geometry import GeometryRecord

# the JAX package's voxel-column alignment (sartsolver_tpu/parallel/mesh.py)
COL_ALIGN = 128

# Slab-method guards. EPS: a direction component smaller than this is
# treated as axis-parallel (the ray never crosses that axis's planes);
# BIG stands in for +inf so the min/max plane algebra stays finite in fp32.
_EPS = 1e-7
_BIG = 1e30

# Panel ceiling of the spec: the JAX package's, 1024 columns.
_MAX_PANEL = 1024


def padded_size(n: int, align: int) -> int:
    return -(-n // align) * align


@dataclasses.dataclass(frozen=True)
class ImplicitSpec:
    """The implicit projection's static record (the JAX package's fields
    and checks). ``nvoxel`` is the voxel extent the solver's vectors carry;
    ``grid_voxels = nx*ny*nz`` the logical grid — columns in between are
    padding and project to zero."""

    grid_shape: Tuple[int, int, int]
    origin: Tuple[float, float, float]
    spacing: Tuple[float, float, float]
    nvoxel: int
    grid_voxels: int
    panel_voxels: int
    version: int = 1

    def __post_init__(self):
        nx, ny, nz = self.grid_shape
        if nx * ny * nz != self.grid_voxels:
            raise ValueError(
                f"ImplicitSpec grid_shape {self.grid_shape} does not "
                f"multiply out to grid_voxels={self.grid_voxels}"
            )
        if self.grid_voxels > self.nvoxel:
            raise ValueError(
                f"ImplicitSpec nvoxel={self.nvoxel} smaller than the "
                f"grid ({self.grid_voxels} voxels)"
            )
        if self.panel_voxels < 1 or self.nvoxel % self.panel_voxels:
            raise ValueError(
                f"ImplicitSpec panel_voxels={self.panel_voxels} must "
                f"divide nvoxel={self.nvoxel}"
            )

    @property
    def n_panels(self) -> int:
        return self.nvoxel // self.panel_voxels


def pick_implicit_panel(padded_nvoxel: int) -> int:
    """Largest lane-aligned panel width (multiple of COL_ALIGN, at most
    ``_MAX_PANEL``) that divides the padded voxel extent."""
    if padded_nvoxel < 1 or padded_nvoxel % COL_ALIGN:
        raise ValueError(
            f"padded nvoxel {padded_nvoxel} is not a multiple of "
            f"{COL_ALIGN}"
        )
    for cand in range(min(_MAX_PANEL, padded_nvoxel), 0, -COL_ALIGN):
        if padded_nvoxel % cand == 0:
            return cand
    return COL_ALIGN  # unreachable: COL_ALIGN always divides


def divisor_panel(nvoxel: int) -> int:
    """The largest divisor of ``nvoxel`` up to ``_MAX_PANEL``: the panel of
    the spec the port's solver builds over unpadded voxels."""
    for cand in range(min(_MAX_PANEL, nvoxel), 0, -1):
        if nvoxel % cand == 0:
            return cand
    raise ValueError(f"nvoxel {nvoxel} must be positive")


def panel_lengths(rays: Tensor, start: int, spec: ImplicitSpec,
                  width: Optional[int] = None) -> Tensor:
    """The plain version's entries: ``[P, width]`` ray/voxel intersection
    lengths for voxel columns ``[start, start + width)`` (``width`` default
    the spec's panel), in the rays' dtype — the JAX function's arithmetic,
    one elementwise operation at a time, on any device."""
    width = spec.panel_voxels if width is None else int(width)
    dtype, dev = rays.dtype, rays.device
    _, ny, nz = spec.grid_shape
    vox = start + torch.arange(width, dtype=torch.int64, device=dev)
    # flat voxel id -> (ix, iy, iz), x slowest / z fastest
    ix = vox // (ny * nz)
    iy = (vox // nz) % ny
    iz = vox % nz
    idx = torch.stack([ix, iy, iz], dim=-1).to(dtype)  # [width, 3]
    origin = torch.tensor(spec.origin, dtype=dtype, device=dev)
    spacing = torch.tensor(spec.spacing, dtype=dtype, device=dev)
    lo = origin + idx * spacing  # box corners
    hi = lo + spacing
    o = rays[:, None, :3]  # [P, 1, 3]
    d = rays[:, None, 3:]
    # slab method: entry/exit distances against each axis's plane pair
    parallel = d.abs() < _EPS
    one = torch.ones_like(d)
    inv = one / torch.where(parallel, one, d)
    t1 = (lo[None] - o) * inv  # [P, width, 3]
    t2 = (hi[None] - o) * inv
    near = torch.minimum(t1, t2)
    far = torch.maximum(t1, t2)
    # axis-parallel rays: half-open [lo, hi), so a ray riding a shared face
    # belongs to one cell
    between = (o >= lo[None]) & (o < hi[None])
    big = torch.tensor(_BIG, dtype=dtype, device=dev)
    near = torch.where(parallel, torch.where(between, -big, big), near)
    far = torch.where(parallel, torch.where(between, big, -big), far)
    # the ray starts at its origin: matter behind the camera never counts
    tmin = torch.clamp_min(near.amax(dim=-1), 0.0)
    tmax = far.amin(dim=-1)
    seg = torch.clamp_min(tmax - tmin, 0.0)
    live = (rays[:, 3:] * rays[:, 3:]).sum(dim=-1) > 0.5  # [P]
    in_grid = vox < spec.grid_voxels  # [width]
    return seg * live[:, None].to(dtype) * in_grid[None, :].to(dtype)


def _column_chunks(spec: ImplicitSpec):
    """``(start, width)`` of the plain version's column chunks: whole
    panels, as many as fit in ``_MAX_PANEL`` columns (the entries do not
    depend on the chunking)."""
    step = spec.panel_voxels * max(1, _MAX_PANEL // spec.panel_voxels)
    return [(s, min(step, spec.nvoxel - s)) for s in range(0, spec.nvoxel, step)]


def _forward_reference(rays: Tensor, x: Tensor, spec: ImplicitSpec,
                       dt: torch.dtype) -> Tensor:
    out = torch.zeros(x.shape[:-1] + (rays.shape[0],), dtype=dt, device=x.device)
    for s, n in _column_chunks(spec):
        out += x[..., s:s + n].to(dt) @ panel_lengths(rays, s, spec, n).to(dt).T
    return out


def _back_reference(rays: Tensor, w: Tensor, spec: ImplicitSpec,
                    dt: torch.dtype) -> Tensor:
    out = torch.empty(w.shape[:-1] + (spec.nvoxel,), dtype=dt, device=w.device)
    for s, n in _column_chunks(spec):
        out[..., s:s + n] = w.to(dt) @ panel_lengths(rays, s, spec, n).to(dt)
    return out


# ---- the kernel (ops/csrc/implicit.cu) --------------------------------------

_ARGTYPES = (
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,  # which, dtype, rays, P
     ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]  # x, B, V
    + [ctypes.c_longlong] * 3  # ny, nz, grid_voxels
    + [ctypes.c_float] * 6  # origin, spacing
    + [ctypes.c_void_p] * 3  # part, out, stream
)
_KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1}


def _kernel_project(which: int, rays: Tensor, x: Tensor, spec: ImplicitSpec) -> Tensor:
    """One call of the C entry point: ``x`` ``[B, V]`` forward (``which``
    0) to ``[B, P]``, or ``[B, P]`` back (1) to ``[B, V]``, in ``x``'s
    dtype (fp32 or fp64). Raises RuntimeError where the kernel refuses or
    fails."""
    from sartsolver_tpu_torch.ops import _build

    lib = _build.load("implicit")
    fn, size_fn = lib.sart_implicit_project, lib.sart_implicit_scratch_elems
    if fn.argtypes is None:  # once per loaded library
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        size_fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
        size_fn.restype = ctypes.c_longlong
    rays = rays.contiguous()
    x = x.contiguous()
    P, V, B = rays.shape[0], spec.nvoxel, x.shape[0]
    out = torch.empty((B, P if which == 0 else V), dtype=x.dtype, device=x.device)
    part = torch.empty(int(size_fn(which, P, V, B)), dtype=x.dtype, device=x.device)
    _, ny, nz = spec.grid_shape
    origin = [float(np.float32(c)) for c in spec.origin]
    spacing = [float(np.float32(c)) for c in spec.spacing]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(which, _KERNEL_DTYPES[x.dtype], rays.data_ptr(), P, x.data_ptr(), B, V,
                 ny, nz, spec.grid_voxels, *origin, *spacing, part.data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        name = "implicit_forward" if which == 0 else "implicit_back"
        raise RuntimeError(f"{name}: CUDA kernel failed with cudaError_t {err}.")
    return out


def _check(rays: Tensor, x: Tensor, spec: ImplicitSpec, extent: int, what: str) -> None:
    if rays.ndim != 2 or rays.shape[1] != 6:
        raise ValueError(f"rays must be the packed [P, 6] table, got {tuple(rays.shape)}.")
    if rays.dtype != torch.float32:
        raise ValueError(f"rays must be fp32 (the staged ray table), got {rays.dtype}.")
    if x.shape[-1] != extent:
        raise ValueError(f"{what} extent {x.shape[-1]} != {extent}")
    if x.device != rays.device:
        raise ValueError("rays and the operand must be on one device.")


def _project(which: int, rays: Tensor, x: Tensor, spec: ImplicitSpec,
             dt: torch.dtype) -> Tensor:
    """The product on ``x`` ``[..., extent]`` in ``dt``: the kernel on a
    CUDA tensor (counted), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        ref = _forward_reference if which == 0 else _back_reference
        return ref(rays, x, spec, dt)
    if x.device.type != "cuda":
        raise ValueError(f"implicit projection: unsupported device {x.device}.")
    if dt not in _KERNEL_DTYPES:
        raise ValueError(f"implicit projection: the kernel sums in fp32 or fp64, not {dt}.")
    lead = x.shape[:-1]
    out = _kernel_project(which, rays, x.to(dt).reshape(-1, x.shape[-1]), spec)
    counter = implicit_forward if which == 0 else implicit_back
    counter.launches += 1
    return out.reshape(lead + out.shape[-1:])


@_audit_opaque("implicit_forward")
def implicit_forward(rays: Tensor, solution: Tensor, spec: ImplicitSpec, *,
                     accum_dtype: Optional[torch.dtype] = None) -> Tensor:
    """``fitted = H @ f`` without ``H``: rays ``[P, 6]`` fp32; solution
    ``[V]`` or ``[B, V]`` -> ``[P]`` or ``[B, P]`` in ``accum_dtype``
    (default fp32, as the JAX function's)."""
    _check(rays, solution, spec, spec.nvoxel, "solution voxel")
    return _project(0, rays, solution, spec, accum_dtype or torch.float32)


@_audit_opaque("implicit_back")
def implicit_back(rays: Tensor, pixel_values: Tensor, spec: ImplicitSpec, *,
                  accum_dtype: Optional[torch.dtype] = None) -> Tensor:
    """``H^T @ w`` without ``H``: rays ``[P, 6]``; pixel_values ``[P]`` or
    ``[B, P]`` -> ``[V]`` or ``[B, V]`` in ``accum_dtype`` (default fp32)."""
    _check(rays, pixel_values, spec, rays.shape[0], "pixel")
    return _project(1, rays, pixel_values, spec, accum_dtype or torch.float32)


def implicit_ray_stats(rays: Tensor, spec: ImplicitSpec, *,
                       dtype: torch.dtype = torch.float32) -> Tuple[Tensor, Tensor]:
    """``(ray_density [V], ray_length [P])`` for the Eq. 6 masks: column
    and row sums of the entries, in ``dtype``. On the card the back and the
    forward projection of all-ones operands."""
    if rays.device.type == "cpu":
        dens = torch.empty(spec.nvoxel, dtype=dtype)
        length = torch.zeros(rays.shape[0], dtype=dtype)
        for s, n in _column_chunks(spec):
            panel = panel_lengths(rays, s, spec, n).to(dtype)
            dens[s:s + n] = panel.sum(dim=0)
            length += panel.sum(dim=1)
        return dens, length
    ones_p = torch.ones((1, rays.shape[0]), dtype=dtype, device=rays.device)
    ones_v = torch.ones((1, spec.nvoxel), dtype=dtype, device=rays.device)
    return (implicit_back(rays, ones_p, spec, accum_dtype=dtype)[0],
            implicit_forward(rays, ones_v, spec, accum_dtype=dtype)[0])


def implicit_subset_density(rays: Tensor, spec: ImplicitSpec, n_subsets: int, *,
                            dtype: torch.dtype = torch.float32) -> Tensor:
    """Per-subset ray density ``[n_subsets, V]`` for OS-SART: subset ``t``
    is ray rows ``t::n_subsets``, the dense stacking's interleave. On the
    card the back projection of the subsets' indicator rows."""
    npix = rays.shape[0]
    if npix % n_subsets:
        raise ValueError(
            f"{npix} pixel rows not divisible into {n_subsets} subsets"
        )
    if rays.device.type == "cpu":
        dens = torch.empty((n_subsets, spec.nvoxel), dtype=dtype)
        for s, n in _column_chunks(spec):
            panel = panel_lengths(rays, s, spec, n).to(dtype)
            dens[:, s:s + n] = panel.reshape(npix // n_subsets, n_subsets, n).sum(dim=0)
        return dens
    pick = torch.arange(npix, dtype=torch.int64, device=rays.device) % n_subsets
    w = (pick[None, :] == torch.arange(n_subsets, dtype=torch.int64,
                                       device=rays.device)[:, None]).to(dtype)
    return implicit_back(rays, w, spec, accum_dtype=dtype)


def materialize_rtm(rays, spec: ImplicitSpec, *, device="cpu") -> np.ndarray:
    """The dense ``[npixel, grid_voxels]`` fp32 matrix the projector applies,
    built panel by panel by :func:`panel_lengths` on ``device`` (the plain
    version's entries, which are the kernel's). Tests and the dense twins
    of the chip run only; never on a hot path."""
    rays = torch.as_tensor(np.asarray(rays, np.float32), device=device)
    out = np.empty((rays.shape[0], spec.grid_voxels), np.float32)
    for s, n in _column_chunks(spec):
        if s >= spec.grid_voxels:
            break
        block = panel_lengths(rays, s, spec, n)[:, :spec.grid_voxels - s]
        # the host matrix assembled a panel at a time (tests and the dense
        # twins only, never a hot path)
        out[:, s:s + block.shape[1]] = block.cpu().numpy()  # sart-lint: disable=SL002
    return out


# ---- the kernel's traversal in plain torch (tests and chip_smoke only) ------
#
# ops/csrc/implicit.cu evaluates only candidate cells; these functions repeat
# its choice operation for operation (fp32, no step contracted) so that the
# CPU tests can hold the candidates against every nonzero entry and
# chip_smoke.py can count the pairs the kernel evaluates. Nothing on the
# main path calls them.

_CHUNK = 32  # rays under one index box (the back's cull)
_SUPER = 32  # chunks under one super box
_THREADS = 128  # cells of a back block's brick
_EMPTY = 2**31 - 1  # an empty index range: [_EMPTY, -1]
_BRICKS_A_STEP = 256  # bricks tile_survivors tests at once (its memory)


def _fp32(x, dev) -> Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


class _Walk:
    """The ray table and the grid as the kernel holds them (``load_ray``,
    ``Grid``), with its per-axis steps on tensors of rays."""

    def __init__(self, rays: Tensor, spec: ImplicitSpec):
        dev = rays.device
        rays = rays.to(torch.float32)
        self.n = tuple(int(c) for c in spec.grid_shape)
        self.org = [_fp32(c, dev) for c in spec.origin]
        self.sp = [_fp32(c, dev) for c in spec.spacing]
        self.isp = [_fp32(1.0, dev) / sp for sp in self.sp]
        self.big = _fp32(_BIG, dev)
        self.o = [rays[:, a] for a in range(3)]
        self.d = [rays[:, 3 + a] for a in range(3)]
        self.par = [d.abs() < _EPS for d in self.d]
        one = _fp32(1.0, dev)
        self.inv = [one / torch.where(p, one, d) for p, d in zip(self.par, self.d)]
        d2 = _fp32(0.0, dev)
        for d in self.d:
            d2 = d2 + d * d
        self.live = d2 > 0.5

    def take(self, idx: Tensor) -> "_Walk":
        """The same walk restricted to rays ``idx`` (with repeats)."""
        w = copy.copy(self)
        for k in ("o", "d", "par", "inv"):
            setattr(w, k, [t[idx] for t in getattr(self, k)])
        w.live = self.live[idx]
        return w

    def cell_lo(self, a: int, i: Tensor) -> Tensor:
        return self.org[a] + i.to(torch.float32) * self.sp[a]

    def slab_t(self, a: int, i: Tensor):
        lo = self.cell_lo(a, i)
        hi = lo + self.sp[a]
        return (lo - self.o[a]) * self.inv[a], (hi - self.o[a]) * self.inv[a]

    def narrow(self, a: int, i: Tensor, w0: Tensor, w1: Tensor):
        """``(ok, u0, u1)``: the window of cell ``i`` inside ``(w0, w1)``."""
        lo = self.cell_lo(a, i)
        hi = lo + self.sp[a]
        between = (self.o[a] >= lo) & (self.o[a] < hi)
        t1, t2 = self.slab_t(a, i)
        par = self.par[a]
        n = torch.where(par, torch.where(between, -self.big, self.big), torch.minimum(t1, t2))
        f = torch.where(par, torch.where(between, self.big, -self.big), torch.maximum(t1, t2))
        u0, u1 = torch.maximum(w0, n), torch.minimum(w1, f)
        return u0 < u1, u0, u1

    def window(self, c0, c1):
        """``(ok, t0, t1)``: the rays' t-window inside cells ``[c0[a],
        c1[a]]`` of every axis (``window`` of the kernel)."""
        dev = self.o[0].device
        t0 = torch.zeros_like(self.o[0])
        t1 = torch.full_like(self.o[0], _BIG)
        ok = self.live.clone()
        for a in range(3):
            i0 = torch.as_tensor(c0[a], device=dev).expand_as(t0)
            i1 = torch.as_tensor(c1[a], device=dev).expand_as(t0)
            par = self.par[a]
            lo = self.cell_lo(a, i0)
            hi = self.cell_lo(a, i1) + self.sp[a]
            ok &= ~par | ((self.o[a] >= lo) & (self.o[a] < hi))
            a1, a2 = self.slab_t(a, i0)
            b1, b2 = self.slab_t(a, i1)
            lo_t = torch.minimum(torch.minimum(a1, a2), torch.minimum(b1, b2))
            hi_t = torch.maximum(torch.maximum(a1, a2), torch.maximum(b1, b2))
            t0 = torch.where(par, t0, torch.maximum(t0, lo_t))
            t1 = torch.where(par, t1, torch.minimum(t1, hi_t))
        return ok & (t0 < t1), t0, t1

    def ray_window(self):
        if min(self.n) < 1:
            z = torch.zeros_like(self.o[0])
            return torch.zeros_like(self.live), z, z
        return self.window((0, 0, 0), tuple(n - 1 for n in self.n))

    def reach(self, a: int, i: Tensor, w0: Tensor, w1: Tensor, down: bool) -> Tensor:
        lo = self.cell_lo(a, i)
        hi = lo + self.sp[a]
        on_par = (self.o[a] < hi) if down else (self.o[a] >= lo)
        t1, t2 = self.slab_t(a, i)
        rising = self.inv[a] > 0
        far_ok = torch.maximum(t1, t2) > w0
        near_ok = torch.minimum(t1, t2) < w1
        res = torch.where(rising == down, far_ok, near_ok)
        return torch.where(self.par[a], on_par, res)

    def clamp_index(self, e: Tensor, n: int, widen: int) -> Tensor:
        top = float(np.float32(n) + np.float32(1.0))
        i = torch.floor(torch.clamp(e, min=-2.0, max=top)).to(torch.int64) + widen
        return torch.clamp(i, 0, n - 1)

    def axis_range(self, a: int, w0: Tensor, w1: Tensor):
        """``(i0, i1)``: the kernel's ``axis_range`` — estimated, widened by
        one cell, extended while ``reach`` holds."""
        n, o, d, org, isp = self.n[a], self.o[a], self.d[a], self.org[a], self.isp[a]
        e_par = (o - org) * isp
        p0 = o + d * w0
        p1 = o + d * w1
        e0 = torch.where(self.par[a], e_par, (torch.minimum(p0, p1) - org) * isp)
        e1 = torch.where(self.par[a], e_par, (torch.maximum(p0, p1) - org) * isp)
        i0 = self.clamp_index(e0, n, -1)
        i1 = self.clamp_index(e1, n, 1)
        # the plain traversal's widening ends on the data (tests and the
        # chip run's checks only; the kernel widens on the device)
        while True:
            m = (i0 > 0) & self.reach(a, i0 - 1, w0, w1, True)
            if not bool(m.any()):  # sart-lint: disable=SL002
                break
            i0 = torch.where(m, i0 - 1, i0)
        while True:
            m = (i1 < n - 1) & self.reach(a, i1 + 1, w0, w1, False)
            if not bool(m.any()):  # sart-lint: disable=SL002
                break
            i1 = torch.where(m, i1 + 1, i1)
        return i0, i1


def _steps(lo: Tensor, hi: Tensor):
    """For ranges ``[lo, hi]`` (empty where ``hi < lo``): ``(which, index)``
    of every element, range by range in order."""
    count = torch.clamp_min(hi - lo + 1, 0)
    which = torch.repeat_interleave(torch.arange(len(lo), dtype=torch.int64, device=lo.device),
                                    count)
    start = torch.cumsum(count, 0) - count
    pos = torch.arange(len(which), dtype=torch.int64, device=lo.device) - start[which]
    return which, lo[which] + pos


def candidate_cells(rays: Tensor, spec: ImplicitSpec) -> Tensor:
    """The forward kernel's walk: ``[N, 5]`` int64 rows ``(ray, ix, iy, iz0,
    iz1)``, the z cells ``[iz0, iz1]`` of row ``(ix, iy)`` that the kernel
    evaluates for ``ray``, in its order (rays ascending, then voxel ids). A
    dead row or a ray that misses the grid has no rows. Every nonzero entry
    lies in a row (tests/test_torch_implicit_traversal.py)."""
    walk = _Walk(rays, spec)
    ok, t0, t1 = walk.ray_window()
    ray = torch.nonzero(ok).flatten()
    wx = walk.take(ray)
    x0, x1 = wx.axis_range(0, t0[ray], t1[ray])
    # every x-slab of every ray
    k, ix = _steps(x0, x1)
    ray, w = ray[k], wx.take(k)
    keep, w0, w1 = w.narrow(0, ix, t0[ray], t1[ray])
    ray, ix, w0, w1, w = ray[keep], ix[keep], w0[keep], w1[keep], w.take(torch.nonzero(keep).flatten())
    y0, y1 = w.axis_range(1, w0, w1)
    # every y row of every slab
    k, iy = _steps(y0, y1)
    ray, ix, w = ray[k], ix[k], w.take(k)
    keep, u0, u1 = w.narrow(1, iy, w0[k], w1[k])
    idx = torch.nonzero(keep).flatten()
    ray, ix, iy, u0, u1, w = ray[idx], ix[idx], iy[idx], u0[idx], u1[idx], w.take(idx)
    z0, z1 = w.axis_range(2, u0, u1)
    # each expansion keeps its ranges in order: rays ascending, then ix, iy
    return torch.stack([ray, ix, iy, z0, z1], dim=1)


def candidate_pairs(rows: Tensor, spec: ImplicitSpec) -> Tuple[Tensor, Tensor]:
    """``(ray, voxel)`` of every pair :func:`candidate_cells`' rows name."""
    _, ny, nz = spec.grid_shape
    k, iz = _steps(rows[:, 3], rows[:, 4])
    r = rows[k]
    return r[:, 0], (r[:, 1] * ny + r[:, 2]) * nz + iz


def pick_brick(grid_shape) -> Tuple[int, int, int]:
    """The back kernel's brick (``pick_brick``): ``_THREADS`` cells, grown
    by doubling the axis with the fewest cells that the grid still exceeds
    (ties: z, y, x)."""
    e = [1, 1, 1]
    while e[0] * e[1] * e[2] < _THREADS:
        best = -1
        for a in (2, 1, 0):
            if e[a] < grid_shape[a] and (best < 0 or e[a] < e[best]):
                best = a
        if best < 0:
            break
        e[best] *= 2
    return tuple(e)


def ray_boxes(rays: Tensor, spec: ImplicitSpec) -> Tensor:
    """``ray_boxes_kernel``'s per-ray index boxes, ``[P, 6]`` int64 ``(x0,
    x1, y0, y1, z0, z1)``; empty ``(_EMPTY, -1)`` for a dead or missing ray."""
    walk = _Walk(rays, spec)
    ok, t0, t1 = walk.ray_window()
    box = torch.tensor([_EMPTY, -1] * 3, dtype=torch.int64,
                       device=rays.device).repeat(rays.shape[0], 1)
    ray = torch.nonzero(ok).flatten()
    w = walk.take(ray)
    for a in range(3):
        i0, i1 = w.axis_range(a, t0[ray], t1[ray])
        box[ray, 2 * a], box[ray, 2 * a + 1] = i0, i1
    return box


def _union(boxes: Tensor, group: int) -> Tensor:
    """The index boxes' unions over consecutive groups of ``group``."""
    g = boxes.reshape(-1, group, 6)
    return torch.stack([g[:, :, k].amin(1) if k % 2 == 0 else g[:, :, k].amax(1)
                        for k in range(6)], dim=1)


def _overlap(boxes: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """``[bricks, boxes]``: whether each box meets each brick's cells
    ``[lo, hi]`` (the kernel's ``overlaps``)."""
    hit = torch.ones((len(lo), len(boxes)), dtype=torch.bool, device=boxes.device)
    for a in range(3):
        hit &= (boxes[None, :, 2 * a] <= hi[:, None, a]) & (boxes[None, :, 2 * a + 1] >= lo[:, None, a])
    return hit


def tile_survivors(rays: Tensor, spec: ImplicitSpec, *, pairs: bool = False) -> dict:
    """The back kernel's cull: per brick (in block order, z fastest) the
    rays that survive its chunk test and its exact slab test against the
    brick widened by one cell, and the cells each evaluates them for.

    Returns ``brick`` (its extent), ``survivors`` ``[n_bricks]`` counts,
    ``cells`` ``[n_bricks]`` (the brick's cells inside the grid),
    ``chunk_tests`` and ``ray_tests`` (the cull's work), and with ``pairs``
    ``[M, 2]`` ``(brick, ray)`` rows of every survivor, rays ascending in
    each brick. ``pairs evaluated = (survivors * cells).sum()``."""
    dev = rays.device
    n = [int(c) for c in spec.grid_shape]
    e = pick_brick(n)
    nb = [-(-n[a] // e[a]) for a in range(3)]
    P = rays.shape[0]
    boxes = ray_boxes(rays, spec)
    n_chunks = -(-P // _CHUNK)
    pad = n_chunks * _CHUNK - P
    padded = torch.cat([boxes, boxes.new_tensor([_EMPTY, -1] * 3).repeat(pad, 1)])
    cbox = _union(padded, _CHUNK)
    n_super = -(-n_chunks // _SUPER)
    sbox = _union(torch.cat([cbox, cbox.new_tensor([_EMPTY, -1] * 3).repeat(
        n_super * _SUPER - n_chunks, 1)]), _SUPER)
    walk = _Walk(rays, spec)
    n_bricks = nb[0] * nb[1] * nb[2]
    bid = torch.arange(n_bricks, dtype=torch.int64, device=dev)
    corner = torch.stack([(bid // (nb[1] * nb[2])) * e[0], ((bid // nb[2]) % nb[1]) * e[1],
                          (bid % nb[2]) * e[2]], dim=1)
    top = torch.tensor(n, device=dev)
    c0 = torch.clamp_min(corner - 1, 0)
    c1 = torch.minimum(corner + torch.tensor(e, device=dev), top - 1)
    cells = torch.clamp(torch.minimum(corner + torch.tensor(e, device=dev), top) - corner,
                        min=0).prod(dim=1)
    survivors = torch.zeros(n_bricks, dtype=torch.int64, device=dev)
    chunk_tests = ray_tests = 0
    found = []
    for s in range(0, n_bricks, _BRICKS_A_STEP):
        b = bid[s:s + _BRICKS_A_STEP]
        lo, hi = c0[b], c1[b]
        # the kernel tests every super box, then the chunks of those that
        # pass; a chunk's box lies inside its super box's, so a chunk that
        # passes has a super box that passes
        chunk_tests += len(b) * n_super + _SUPER * int(_overlap(sbox, lo, hi).sum())
        kb, kc = torch.nonzero(_overlap(cbox, lo, hi), as_tuple=True)
        ray = (kc[:, None] * _CHUNK + torch.arange(_CHUNK, dtype=torch.int64,
                                                   device=dev)).flatten()
        kb = kb.repeat_interleave(_CHUNK)
        inside = ray < P
        kb, ray = kb[inside], ray[inside]
        ray_tests += len(ray)
        ok, _, _ = walk.take(ray).window(tuple(lo[kb, a] for a in range(3)),
                                         tuple(hi[kb, a] for a in range(3)))
        kb, ray = b[kb[ok]], ray[ok]
        survivors += torch.bincount(kb, minlength=n_bricks)
        if pairs:
            order = torch.argsort(kb * P + ray)
            found.append(torch.stack([kb[order], ray[order]], dim=1))
    out = dict(brick=e, survivors=survivors, cells=cells, chunk_tests=chunk_tests,
               ray_tests=ray_tests)
    if pairs:
        out["pairs"] = torch.cat(found) if found else torch.zeros((0, 2), dtype=torch.int64)
    return out


def brick_of(vox: Tensor, spec: ImplicitSpec) -> Tensor:
    """The back kernel's brick (block) index of each voxel id."""
    _, ny, nz = spec.grid_shape
    e = pick_brick(spec.grid_shape)
    nb = [-(-int(c) // e[a]) for a, c in enumerate(spec.grid_shape)]
    ix, iy, iz = vox // (ny * nz), (vox // nz) % ny, vox % nz
    return ((ix // e[0]) * nb[1] + iy // e[1]) * nb[2] + iz // e[2]


def pair_lengths(rays: Tensor, ray: Tensor, vox: Tensor, spec: ImplicitSpec) -> Tensor:
    """The entries ``H[ray[m], vox[m]]`` of given pairs, ``[M]``: the
    arithmetic of :func:`panel_lengths`, step for step, on pairs instead of
    a panel (chip_smoke.py's count of the nonzero entries of a world too
    large to materialize)."""
    dtype, dev = rays.dtype, rays.device
    _, ny, nz = spec.grid_shape
    ix = vox // (ny * nz)
    iy = (vox // nz) % ny
    iz = vox % nz
    idx = torch.stack([ix, iy, iz], dim=-1).to(dtype)  # [M, 3]
    origin = torch.tensor(spec.origin, dtype=dtype, device=dev)
    spacing = torch.tensor(spec.spacing, dtype=dtype, device=dev)
    lo = origin + idx * spacing
    hi = lo + spacing
    o = rays[ray, :3]
    d = rays[ray, 3:]
    parallel = d.abs() < _EPS
    one = torch.ones_like(d)
    inv = one / torch.where(parallel, one, d)
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    near = torch.minimum(t1, t2)
    far = torch.maximum(t1, t2)
    between = (o >= lo) & (o < hi)
    big = torch.tensor(_BIG, dtype=dtype, device=dev)
    near = torch.where(parallel, torch.where(between, -big, big), near)
    far = torch.where(parallel, torch.where(between, big, -big), far)
    tmin = torch.clamp_min(near.amax(dim=-1), 0.0)
    tmax = far.amin(dim=-1)
    seg = torch.clamp_min(tmax - tmin, 0.0)
    live = (d * d).sum(dim=-1) > 0.5
    return seg * live.to(dtype) * (vox < spec.grid_voxels).to(dtype)


def reset_launch_counts() -> None:
    """Set the kernel's launch counts to 0."""
    implicit_forward.launches = 0
    implicit_back.launches = 0


reset_launch_counts()


class ImplicitOperator(ProjectionOperator):
    """Geometry-driven matrix-free operator: the whole state is a
    :class:`~sartsolver_tpu_torch.operators.geometry.GeometryRecord`."""

    kind = "implicit"

    def __init__(self, record: GeometryRecord, *, dtype=np.float32):
        self.record = record
        self._dtype = np.dtype(dtype)

    @property
    def npixel(self) -> int:
        return self.record.npixel

    @property
    def nvoxel(self) -> int:
        return self.record.nvoxel

    def payload(self) -> np.ndarray:
        """The packed ``[npixel, 6]`` ray table (pixel rows in the
        repo-wide camera order): what the solver stages in place of the
        RTM block."""
        return np.ascontiguousarray(
            self.record.build_rays().astype(self._dtype)
        )

    def spec(self, *, padded_nvoxel: Optional[int] = None,
             panel_voxels: Optional[int] = None) -> ImplicitSpec:
        if padded_nvoxel is None:
            padded_nvoxel = padded_size(self.record.nvoxel, COL_ALIGN)
        if panel_voxels is None:
            panel_voxels = pick_implicit_panel(padded_nvoxel)
        return ImplicitSpec(
            grid_shape=self.record.grid_shape,
            origin=self.record.origin,
            spacing=self.record.spacing,
            nvoxel=int(padded_nvoxel),
            grid_voxels=self.record.nvoxel,
            panel_voxels=int(panel_voxels),
            version=self.record.version,
        )

    def resident_nbytes(self) -> int:
        """Bytes of the staged ray table: O(npixel), not O(npixel x
        nvoxel)."""
        return self.record.npixel * 6 * self._dtype.itemsize

    def cache_key(self) -> str:
        blob = json.dumps(self.record.to_dict(), sort_keys=True)
        digest = hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12]
        return (
            f"implicit:{self.npixel}x{self.nvoxel}:"
            f"{self._dtype.name}:{digest}"
        )

    def materialize(self) -> np.ndarray:
        return materialize_rtm(self.payload(), self.spec())


__all__ = [
    "ImplicitOperator", "ImplicitSpec", "divisor_panel", "implicit_back",
    "implicit_forward", "implicit_ray_stats", "implicit_subset_density",
    "materialize_rtm", "panel_lengths", "pick_implicit_panel",
]


# ---- launch-audit registration (analysis/registry.py) -----------------------
from sartsolver_tpu_torch.analysis.registry import register_audit_entry  # noqa: E402


@register_audit_entry(
    "implicit_sweep",
    description="matrix-free (geometry-driven) loop: the projector's back and "
                "forward products replace both matrix contractions; nothing "
                "matrix-sized exists, so nothing matrix-sized may be copied",
    hand_launches={"implicit_back": 1, "implicit_forward": 1},
)
def _audit_implicit_sweep(ctx):
    from sartsolver_tpu_torch.config import SolverOptions

    return ctx.batch_runner(SolverOptions(fused_sweep="off"), operator="implicit")
