"""The grid of ranks and its partition arithmetic.

Counterpart of ``sartsolver_tpu/parallel/mesh.py``. The reference
distributes the RTM by pixel row blocks across MPI ranks (main.cpp:67-68);
the JAX package makes that a device mesh with the axes ``'pixels'`` and
``'voxels'``. Here the mesh's devices are ranks of ``torch.distributed``:
rank ``r`` of a ``P x V`` grid sits at ``(r // V, r % V)``, where the JAX
mesh puts device ``r`` of ``jax.devices()[:P*V].reshape(P, V)``, and holds
the block of the matrix that device holds.

Blocks are equal: the pixel axis is zero-padded to a multiple of ``P *
ROW_ALIGN`` and the voxel axis to a multiple of ``V * COL_ALIGN``, the JAX
package's padding unchanged, so a rank's padded block is the JAX device's
block element for element. Padded rows have ``ray_length == 0`` and
measurements of -1 (masked, Eq. 6), padded columns ``ray_density == 0``: the
padding is inert.

:class:`RankGrid` holds a rank's coordinates and the two sub-groups of
``torch.distributed`` its collectives run over: the ranks of its voxel
column (the pixel axis, the back projection's sum) and those of its pixel
row (the voxel axis, the forward projection's sum). A grid of one rank
needs no process group at all.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

PIXEL_AXIS = "pixels"
VOXEL_AXIS = "voxels"
WORLD_AXIS = "world"

# the JAX package's block alignment (its TPU tiles), kept so that a rank's
# padded block equals the JAX device's block
ROW_ALIGN = 8
COL_ALIGN = 128


def row_block_partition(npixel: int, nshards: int) -> List[Tuple[int, int]]:
    """``(offset, count)`` per shard: the reference's MPI split with the
    remainder spread over the first shards (main.cpp:67-68)."""
    base, rem = divmod(npixel, nshards)
    return [(rank * base + min(rank, rem), base + (1 if rank < rem else 0))
            for rank in range(nshards)]


def padded_size(n: int, nshards: int) -> int:
    """The smallest multiple of ``nshards`` that is at least ``n``."""
    return ((n + nshards - 1) // nshards) * nshards


def pad_pixel_axis(rtm: np.ndarray, nshards: int) -> np.ndarray:
    """``rtm`` with zero rows appended up to a multiple of ``nshards``."""
    target = padded_size(rtm.shape[0], nshards)
    if target == rtm.shape[0]:
        return rtm
    return np.concatenate([rtm, np.zeros((target - rtm.shape[0], rtm.shape[1]), rtm.dtype)])


def pad_measurement(g: np.ndarray, nshards: int, target: Optional[int] = None) -> np.ndarray:
    """``g`` with -1 (masked everywhere) appended up to ``target``, by
    default a multiple of ``nshards``."""
    if target is None:
        target = padded_size(g.shape[0], nshards)
    if target == g.shape[0]:
        return g
    return np.concatenate([g, np.full(target - g.shape[0], -1.0, dtype=g.dtype)])


def padded_extents(npixel: int, nvoxel: int, n_pix: int, n_vox: int) -> Tuple[int, int]:
    """``(padded rows, padded columns)`` of the whole matrix on a grid."""
    return (padded_size(npixel, n_pix * ROW_ALIGN), padded_size(nvoxel, n_vox * COL_ALIGN))


def fused_would_engage(opts, npixel: int, nvoxel: int, n_vox: int, batch: int = 1, *,
                       device_type: str = "cuda") -> bool:
    """Whether the fused sweep runs the per-rank block of a voxel-major
    grid of ``n_vox`` ranks. On CUDA the port's kernel runs wherever the
    options let the fused sweep engage and the plan its shape takes has no
    refusal (``ops/fused_sweep.py:plan_refusal``); on the CPU the answer is
    the JAX package's for a CPU backend: its ``'auto'`` never engages
    there."""
    from sartsolver_tpu_torch.models.sart import resolve_fused
    from sartsolver_tpu_torch.ops.fused_sweep import plan_refusal, plan_sweep

    try:
        if not resolve_fused(opts):
            return False
    except ValueError:
        return False
    if device_type != "cuda":
        return opts.fused_sweep == "on"
    rows, cols = padded_extents(npixel, nvoxel, 1, n_vox)
    storage = opts.rtm_dtype or opts.dtype
    block = cols // n_vox
    return plan_refusal(plan_sweep(rows, block, batch, storage), rows, block, batch,
                        storage) is None


def choose_mesh_shape(n_devices: int, npixel: int, nvoxel: int, opts, batch: int = 1, *,
                      device_type: str = "cuda") -> Tuple[int, int]:
    """``(pixel shards, voxel shards)`` of a grid chosen for ``n_devices``
    ranks: voxel-major ``(1, N)`` where the fused sweep runs the per-rank
    block (one forward-projection sum an iteration), else the reference's
    row blocks ``(N, 1)`` (``sartsolver_tpu/parallel/mesh.py:74``)."""
    if n_devices <= 1:
        return 1, 1
    if fused_would_engage(opts, npixel, nvoxel, n_devices, batch, device_type=device_type):
        return 1, n_devices
    return n_devices, 1


class RankGrid:
    """This rank's place on a ``n_pix x n_vox`` grid of ranks.

    ``coords`` is ``(p, v)``; :meth:`group` gives the process group of an
    axis (None where the axis has one rank, or the world group), and
    :meth:`size` its extent. ``backend`` is the process group's backend
    (``"gloo"``, ``"nccl"``, or None for a grid of one rank)."""

    def __init__(self, n_pix: int, n_vox: int, *, rank: int = 0, backend: Optional[str] = None,
                 pixel_group=None, voxel_group=None):
        self.n_pix, self.n_vox = int(n_pix), int(n_vox)
        self.rank = int(rank)
        self.coords = divmod(self.rank, self.n_vox)
        self.backend = backend
        self._groups = {PIXEL_AXIS: pixel_group, VOXEL_AXIS: voxel_group}

    @property
    def shape(self) -> Tuple[int, int]:
        return self.n_pix, self.n_vox

    @property
    def world(self) -> int:
        return self.n_pix * self.n_vox

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def size(self, axis: str) -> int:
        return {PIXEL_AXIS: self.n_pix, VOXEL_AXIS: self.n_vox, WORLD_AXIS: self.world}[axis]

    def group(self, axis: str):
        return None if axis == WORLD_AXIS else self._groups[axis]

    def layout(self) -> str:
        """The JAX CLI's name for the grid's layout."""
        if self.world == 1:
            return "single-device"
        return ("voxel-major" if self.n_pix == 1 else "pixel-major" if self.n_vox == 1
                else "2-D")

    def blocks(self, npixel: int, nvoxel: int) -> Tuple[int, int]:
        """``(rows, columns)`` of this rank's padded block."""
        rows, cols = padded_extents(npixel, nvoxel, self.n_pix, self.n_vox)
        return rows // self.n_pix, cols // self.n_vox

    def row_range(self, npixel: int) -> Tuple[int, int]:
        """``(first, count)`` of the logical pixel rows this rank holds
        (``count`` 0 for a block of padding rows only)."""
        rb = self.blocks(npixel, 1)[0]
        r0 = self.coords[0] * rb
        return min(r0, npixel), max(0, min(npixel - r0, rb))

    def col_range(self, nvoxel: int) -> Tuple[int, int]:
        """``(first, count)`` of the logical voxel columns this rank holds."""
        cb = self.blocks(1, nvoxel)[1]
        c0 = self.coords[1] * cb
        return min(c0, nvoxel), max(0, min(nvoxel - c0, cb))


def make_grid(n_pix: int, n_vox: int = 1) -> RankGrid:
    """This rank's :class:`RankGrid` of ``n_pix x n_vox`` ranks over the
    initialized process group (a grid of one rank needs none). The grid
    covers every rank of the world: a larger grid raises ``SartInputError``
    with the JAX package's words (ranks are its devices), and so does a
    smaller one. Every rank calls this, in the same order: the sub-groups
    are made collectively."""
    import torch.distributed as dist

    from sartsolver_tpu_torch.config import SartInputError

    n = n_pix * n_vox
    world_up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if world_up else 1
    if n > world:
        raise SartInputError(f"Mesh {n_pix}x{n_vox} needs {n} devices, have {world}.")
    if n < world:
        raise SartInputError(
            f"Mesh {n_pix}x{n_vox} covers {n} of the world's {world} ranks; a "
            "multi-process grid must give every rank a block (set --pixel_shards "
            "and --voxel_shards to multiply to the world size).")
    if world == 1:
        return RankGrid(1, 1, backend=dist.get_backend() if world_up else None)
    rank = dist.get_rank()
    pixel_group = voxel_group = None
    for v in range(n_vox):  # the ranks of voxel column v: a pixel-axis group
        g = dist.new_group([p * n_vox + v for p in range(n_pix)]) if n_pix > 1 else None
        if rank % n_vox == v:
            pixel_group = g
    for p in range(n_pix):  # the ranks of pixel row p: a voxel-axis group
        g = dist.new_group([p * n_vox + v for v in range(n_vox)]) if n_vox > 1 else None
        if rank // n_vox == p:
            voxel_group = g
    return RankGrid(n_pix, n_vox, rank=rank, backend=dist.get_backend(),
                    pixel_group=pixel_group, voxel_group=voxel_group)
