"""Voxel grids: RTM voxel index <-> regular 3-D grid cells.

A copy of ``sartsolver_tpu/io/voxelgrid.py``.

Mirrors the reference's polymorphic grid (voxelgrid.cpp): a flat
``voxel_map`` over an ``nx*ny*nz`` grid (-1 = no voxel), stitched from
multiple segment files with per-file re-offsetting, plus Cartesian and
cylindrical (r, phi, z; periodic phi) point lookups, and an output
round-trip of the map into the solution file.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

from sartsolver_tpu_torch.io import h5
import numpy as np

from sartsolver_tpu_torch.config import SartInputError

CARTESIAN = 0
CYLINDRICAL = 1


def get_coordinate_system_hdf5(filename: str, group_name: str) -> int:
    """Sniff the coordinate system attribute (voxelgrid.cpp:19-39);
    defaults to Cartesian when absent."""
    with h5.File(filename, "r") as f:
        group = f[group_name]
        if "coordinate_system" in group.attrs:
            cs = group.attrs["coordinate_system"]
            if isinstance(cs, bytes):
                cs = cs.decode()
            return CYLINDRICAL if str(cs).lower() == "cylindrical" else CARTESIAN
    return CARTESIAN


class BaseVoxelGrid:
    coordsys: int = CARTESIAN

    def __init__(self) -> None:
        self.nx = self.ny = self.nz = 0
        self.xmin = self.ymin = self.zmin = 0.0
        self.xmax = self.ymax = self.zmax = 1.0
        self.dx = self.dy = self.dz = 0.0
        self.nvox = 0
        self.voxmap: Optional[np.ndarray] = None

    # -- IO ---------------------------------------------------------------
    def read_hdf5(self, filenames: Sequence[str], group_name: str) -> None:
        """Stitch segment voxel maps (voxelgrid.cpp:41-110).

        Note the reference's segment offset here is ``max(value)+1`` per file
        (voxelgrid.cpp:94-96), unlike the consistency checker which uses the
        ``nvoxel`` attribute (hdf5files.cpp:200) — equal for well-formed
        files; we keep each site's own rule.
        """
        with h5.File(filenames[0], "r") as f:
            group = f[group_name]
            self.nx = int(group.attrs["nx"])
            self.ny = int(group.attrs["ny"])
            self.nz = int(group.attrs["nz"])
            self.xmin = float(group.attrs.get("xmin", 0.0))
            self.xmax = float(group.attrs.get("xmax", 1.0))
            self.ymin = float(group.attrs.get("ymin", 0.0))
            self.ymax = float(group.attrs.get("ymax", 1.0))
            self.zmin = float(group.attrs.get("zmin", 0.0))
            self.zmax = float(group.attrs.get("zmax", 1.0))

        self.voxmap = np.full(self.nx * self.ny * self.nz, -1, dtype=np.int64)
        nvoxel_prev = 0
        for filename in filenames:
            with h5.File(filename, "r") as f:
                group = f[group_name]
                i = np.asarray(group["i"], np.int64)
                j = np.asarray(group["j"], np.int64)
                k = np.asarray(group["k"], np.int64)
                value = np.asarray(group["value"], np.int64)
            flat = i * self.ny * self.nz + j * self.nz + k
            self.voxmap[flat] = value + nvoxel_prev
            nvoxel_prev += (int(value.max()) if value.size else -1) + 1
        self.nvox = nvoxel_prev

        self.dx = (self.xmax - self.xmin) / self.nx
        self.dy = (self.ymax - self.ymin) / self.ny
        self.dz = (self.zmax - self.zmin) / self.nz

    def write_hdf5(self, filename: str, group_name: str) -> None:
        """Round-trip the stitched map into the output file
        (voxelgrid.cpp:112-187): appended in place, or a new file where the
        run wrote no frame (h5py's mode "a")."""
        with h5.File(filename, "r+" if os.path.exists(filename) else "w") as f:
            group = f.create_group(group_name)
            for name, val in (
                ("nx", self.nx), ("ny", self.ny), ("nz", self.nz),
            ):
                group.attrs.create(name, val, dtype=np.uint64)
            for name, val in (
                ("xmin", self.xmin), ("xmax", self.xmax),
                ("ymin", self.ymin), ("ymax", self.ymax),
                ("zmin", self.zmin), ("zmax", self.zmax),
            ):
                group.attrs.create(name, val, dtype=np.float64)
            group.attrs["coordinate_system"] = (
                "cylindrical" if self.coordsys == CYLINDRICAL else "cartesian"
            )

            present = self.voxmap > -1
            flat = np.nonzero(present)[0]
            i = (flat // (self.ny * self.nz)).astype(np.int32)
            rem = flat % (self.ny * self.nz)
            j = (rem // self.nz).astype(np.int32)
            k = (rem % self.nz).astype(np.int32)
            group.create_dataset("i", data=i, dtype=np.int32)
            group.create_dataset("j", data=j, dtype=np.int32)
            group.create_dataset("k", data=k, dtype=np.int32)
            group.create_dataset(
                "value", data=self.voxmap[present].astype(np.int32), dtype=np.int32
            )

    # -- lookups ----------------------------------------------------------
    @property
    def voxel_map(self) -> np.ndarray:
        return self.voxmap

    @property
    def nvoxel(self) -> int:
        return self.nvox

    def voxel_index(self, x: float, y: float, z: float) -> int:
        raise NotImplementedError


class CartesianVoxelGrid(BaseVoxelGrid):
    coordsys = CARTESIAN

    def read_hdf5(self, filenames: Sequence[str], group_name: str) -> None:
        if get_coordinate_system_hdf5(filenames[0], group_name) == CYLINDRICAL:
            raise SartInputError("CartesianVoxelGrid cannot read cylindrical voxel map.")
        super().read_hdf5(filenames, group_name)

    def voxel_index(self, x: float, y: float, z: float) -> int:
        """Point -> voxel (voxelgrid.cpp:236-250).

        Indices are clamped to the last cell: when a cell width rounds
        below the exact span/n quotient, a coordinate just inside the
        upper bound can quotient to n — one past the axis, out-of-bounds
        UB in the reference's C++. The bounds check above already
        guarantees the point is inside the grid, so the clamp only
        corrects that half-ulp spill.
        """
        if self.voxmap is None:
            raise RuntimeError("Voxel map is not initialized.")
        if not (self.xmin <= x < self.xmax and self.ymin <= y < self.ymax
                and self.zmin <= z < self.zmax):
            return -1
        i = min(int((x - self.xmin) / self.dx), self.nx - 1)
        j = min(int((y - self.ymin) / self.dy), self.ny - 1)
        k = min(int((z - self.zmin) / self.dz), self.nz - 1)
        return int(self.voxmap[i * self.ny * self.nz + j * self.nz + k])


class CylindricalVoxelGrid(BaseVoxelGrid):
    coordsys = CYLINDRICAL

    def read_hdf5(self, filenames: Sequence[str], group_name: str) -> None:
        with h5.File(filenames[0], "r") as f:
            if "coordinate_system" not in f[group_name].attrs:
                raise SartInputError("CylindricalVoxelGrid cannot read Cartesian voxel map.")
        if get_coordinate_system_hdf5(filenames[0], group_name) == CARTESIAN:
            raise SartInputError("CylindricalVoxelGrid cannot read Cartesian voxel map.")
        super().read_hdf5(filenames, group_name)
        period = self.ymax - self.ymin
        if math.fmod(360.0, period) > 0.001:
            raise SartInputError(f"{period} is not a divisor of 360.")

    def voxel_index(self, x: float, y: float, z: float) -> int:
        """Point -> voxel in (r, phi, z) with periodic phi
        (voxelgrid.cpp:302-323). Grid axes: x=r, y=phi (degrees), z=z."""
        if self.voxmap is None:
            raise RuntimeError("Voxel map is not initialized.")
        r = math.sqrt(x * x + y * y)
        if not (self.xmin <= r < self.xmax and self.zmin <= z < self.zmax):
            return -1
        period = self.ymax - self.ymin
        phi = 180.0 / math.pi * math.atan2(y, x)
        # Wrap into the grid's own sector [ymin, ymin + period): the
        # reference wraps into [0, period) and then subtracts ymin
        # (voxelgrid.cpp:311-317), which for a sector grid with ymin > 0
        # makes angles below ymin produce a NEGATIVE angular index —
        # out-of-bounds UB in its C++, a silently wrong (wrapped-around)
        # cell here. Wrapping relative to ymin is identical for the
        # common ymin == 0 grids and correct for every sector.
        phi = math.fmod(phi - self.ymin, period)
        if phi < 0:
            phi += period
        if phi >= period:
            # a tiny negative fmod result plus period can round to exactly
            # period (half-ulp), which would index one past the last
            # angular cell — the angle is equivalent to the sector origin
            phi -= period
        # clamp: same half-ulp quotient spill as the Cartesian lookup
        # (e.g. ny=19, dy=fl(360/19) < 360/19 exactly, so phi just below
        # the period quotients to ny), plus the radial/z axes
        i = min(int((r - self.xmin) / self.dx), self.nx - 1)
        j = min(int(phi / self.dy), self.ny - 1)
        k = min(int((z - self.zmin) / self.dz), self.nz - 1)
        return int(self.voxmap[i * self.ny * self.nz + j * self.nz + k])


def make_voxel_grid(filenames: List[str], group_name: str) -> BaseVoxelGrid:
    """Factory following main.cpp:115-125."""
    coordsys = get_coordinate_system_hdf5(filenames[0], group_name)
    grid = CylindricalVoxelGrid() if coordsys == CYLINDRICAL else CartesianVoxelGrid()
    grid.read_hdf5(filenames, group_name)
    return grid
