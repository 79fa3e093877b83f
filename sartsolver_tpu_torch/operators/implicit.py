"""Matrix-free geometry-driven projection (the implicit operator).

Counterpart of ``sartsolver_tpu/operators/implicit.py``. The dense solver
stores ``H`` as a ``[npixel, nvoxel]`` matrix; this module never does: each
entry ``H[p, v]`` is the length of ray ``p``'s segment inside voxel ``v``'s
axis-aligned box, a pure function of the packed ray table (``[P, 6]``:
origin xyz, unit direction xyz) and the regular grid, recomputed on the fly
by the slab method. A resident session holds the rays, O(P) bytes.

Two versions of the same products:

- on a CUDA tensor, the hand-written kernel ``ops/csrc/implicit.cu``
  (:func:`_kernel_project`): each entry computed in registers and applied to
  up to eight batch rows, no panel in memory; deterministic (no atomics);
- on a CPU tensor, the plain version: :func:`panel_lengths` rebuilds a
  ``[P, panel]`` block of entries with the JAX function's arithmetic, step
  for step, and a matrix product contracts it, a chunk of columns at a time.

A CUDA tensor never takes the plain version, and a CPU tensor never the
kernel. The entries of the two are the same floats (the kernel writes the
corner and slab arithmetic with round-to-nearest intrinsics, so no step is
contracted); the sums agree within their summation order.
``implicit_forward.launches`` and ``implicit_back.launches`` count the
kernel's launches; ray stats and the ordered-subsets densities run through
the same two (all-ones and subset-indicator operands).

Masking conventions are the JAX package's: zero-padded ray rows (direction
norm 0) and padding columns (``vox >= grid_voxels``) project to zero.

The port's solver holds no padding columns: it builds its spec with
``padded_nvoxel`` = the grid's voxel count and a panel that divides it
(:func:`divisor_panel`), where the JAX solver pads to a multiple of 128 with
inert zero columns. The compile-audit registration of the JAX module has no
counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

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


def implicit_forward(rays: Tensor, solution: Tensor, spec: ImplicitSpec, *,
                     accum_dtype: Optional[torch.dtype] = None) -> Tensor:
    """``fitted = H @ f`` without ``H``: rays ``[P, 6]`` fp32; solution
    ``[V]`` or ``[B, V]`` -> ``[P]`` or ``[B, P]`` in ``accum_dtype``
    (default fp32, as the JAX function's)."""
    _check(rays, solution, spec, spec.nvoxel, "solution voxel")
    return _project(0, rays, solution, spec, accum_dtype or torch.float32)


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
    pick = torch.arange(npix, device=rays.device) % n_subsets
    w = (pick[None, :] == torch.arange(n_subsets, device=rays.device)[:, None]).to(dtype)
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
        out[:, s:s + block.shape[1]] = block.cpu().numpy()
    return out


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
