"""Versioned geometry records: the implicit operator's whole input. A copy
of ``sartsolver_tpu/operators/geometry.py`` (host-only, numpy fp64), its
voxel grid over this package's ``io/voxelgrid.CartesianVoxelGrid``.

A geometry record is a small JSON document (docs/FORMATS.md §geometry)
that replaces a tens-of-GB materialized RTM for the matrix-free backend:
a regular Cartesian voxel grid plus a list of pinhole cameras. From it
the ray table — one ``(origin xyz, unit direction xyz)`` row per
detector pixel — is derived deterministically host-side, and the
line-integral projector (operators/implicit.py) computes ``H f`` /
``H^T w`` on the fly::

    {"format": "sart-geometry", "version": 1,
     "grid": {"shape": [nx, ny, nz],
              "origin": [x0, y0, z0],
              "spacing": [dx, dy, dz]},
     "cameras": [{"name": "camA", "rows": 3, "cols": 4,
                  "position": [...], "target": [...],
                  "up": [0, 0, 1], "pitch": 0.1}, ...]}

Pixel-row order is the repo-wide camera convention (io/hdf5files.py):
cameras sorted by name, row-major within each camera — so image files
line up with ray rows exactly as they line up with RTM rows. Every
camera pixel is live (the implicit path has no per-pixel mask; dead
pixels are expressed as negative measurements, Eq. 6, like padding).

``version`` is a hard gate: an unknown version fails loudly instead of
silently mis-tracing rays — the record is the session's entire operator
state, so schema drift must never be guessed through.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np

from sartsolver_tpu_torch.config import SartInputError

GEOMETRY_FORMAT = "sart-geometry"
GEOMETRY_VERSION = 1

_Vec3 = Tuple[float, float, float]


def _vec3(val, field: str) -> _Vec3:
    try:
        x, y, z = (float(v) for v in val)
    except (TypeError, ValueError) as err:
        raise SartInputError(
            f"Geometry field '{field}' must be a list of 3 numbers, "
            f"{val!r} given."
        ) from err
    if not all(np.isfinite((x, y, z))):
        raise SartInputError(
            f"Geometry field '{field}' must be finite, {val!r} given."
        )
    return (x, y, z)


@dataclasses.dataclass(frozen=True)
class Camera:
    """One pinhole camera: a ``rows x cols`` detector of ``pitch``-spaced
    pixel centers on the plane through ``target`` orthogonal to the view
    direction, every pixel's ray cast from ``position`` through its
    center."""

    name: str
    rows: int
    cols: int
    position: _Vec3
    target: _Vec3
    up: _Vec3 = (0.0, 0.0, 1.0)
    pitch: float = 1.0

    @property
    def npixel(self) -> int:
        return self.rows * self.cols

    def rays(self) -> np.ndarray:
        """``[rows*cols, 6]`` fp64 (origin xyz, unit direction xyz),
        row-major pixel order."""
        pos = np.asarray(self.position, np.float64)
        tgt = np.asarray(self.target, np.float64)
        view = tgt - pos
        vn = np.linalg.norm(view)
        view = view / vn
        up = np.asarray(self.up, np.float64)
        u = np.cross(view, up)
        u /= np.linalg.norm(u)
        v = np.cross(u, view)
        r = np.arange(self.rows, dtype=np.float64) - (self.rows - 1) / 2.0
        c = np.arange(self.cols, dtype=np.float64) - (self.cols - 1) / 2.0
        # pixel (r, c) center on the detector plane, row-major
        centers = (tgt[None, None]
                   + (r[:, None, None] * self.pitch) * v[None, None]
                   + (c[None, :, None] * self.pitch) * u[None, None])
        d = centers.reshape(-1, 3) - pos[None]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.broadcast_to(pos, d.shape)
        return np.concatenate([o, d], axis=1)


@dataclasses.dataclass(frozen=True)
class GeometryRecord:
    """One validated geometry record (hashable: tuples all the way)."""

    grid_shape: Tuple[int, int, int]
    origin: _Vec3
    spacing: _Vec3
    cameras: Tuple[Camera, ...]
    version: int = GEOMETRY_VERSION

    @property
    def npixel(self) -> int:
        return sum(c.npixel for c in self.cameras)

    @property
    def nvoxel(self) -> int:
        nx, ny, nz = self.grid_shape
        return nx * ny * nz

    @property
    def camera_names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.cameras)

    def build_rays(self) -> np.ndarray:
        """The full ``[npixel, 6]`` ray table, cameras in name order
        (the io/hdf5files.py row convention)."""
        return np.concatenate([c.rays() for c in self.cameras], axis=0)

    def frame_masks(self) -> Dict[str, np.ndarray]:
        """Per-camera frame masks for :class:`CompositeImage` — all-ones
        (every geometry pixel is a ray row)."""
        return {
            c.name: np.ones((c.rows, c.cols), dtype=np.int64)
            for c in self.cameras
        }

    def to_dict(self) -> dict:
        return {
            "format": GEOMETRY_FORMAT,
            "version": self.version,
            "grid": {
                "shape": list(self.grid_shape),
                "origin": list(self.origin),
                "spacing": list(self.spacing),
            },
            "cameras": [
                {
                    "name": c.name, "rows": c.rows, "cols": c.cols,
                    "position": list(c.position),
                    "target": list(c.target),
                    "up": list(c.up), "pitch": c.pitch,
                }
                for c in self.cameras
            ],
        }


def parse_geometry(payload) -> GeometryRecord:
    """Parse + validate a geometry payload (JSON text or dict). Raises
    :class:`SartInputError` on anything the author got wrong — same
    taxonomy as a flag error (exit 1 / REASON_MALFORMED), never an
    engine abort."""
    if isinstance(payload, (str, bytes)):
        try:
            payload = json.loads(payload)
        except ValueError as err:
            raise SartInputError(
                f"Geometry record is not valid JSON: {err}"
            ) from err
    if not isinstance(payload, dict):
        raise SartInputError(
            f"Geometry record must be a JSON object, got "
            f"{type(payload).__name__}."
        )
    if payload.get("format") != GEOMETRY_FORMAT:
        raise SartInputError(
            f"Geometry record format must be {GEOMETRY_FORMAT!r}, "
            f"{payload.get('format')!r} given."
        )
    version = payload.get("version")
    if version != GEOMETRY_VERSION:
        raise SartInputError(
            f"Geometry record version {version!r} is not supported "
            f"(this build reads version {GEOMETRY_VERSION})."
        )
    grid = payload.get("grid")
    if not isinstance(grid, dict):
        raise SartInputError("Geometry record needs a 'grid' object.")
    try:
        shape = tuple(int(n) for n in grid["shape"])
    except (KeyError, TypeError, ValueError) as err:
        raise SartInputError(
            "Geometry field 'grid.shape' must be 3 integers."
        ) from err
    if len(shape) != 3 or any(n < 1 for n in shape):
        raise SartInputError(
            f"Geometry field 'grid.shape' must be 3 positive integers, "
            f"{grid.get('shape')!r} given."
        )
    origin = _vec3(grid.get("origin", (0.0, 0.0, 0.0)), "grid.origin")
    spacing = _vec3(grid.get("spacing"), "grid.spacing")
    if any(s <= 0 for s in spacing):
        raise SartInputError(
            f"Geometry field 'grid.spacing' must be > 0, "
            f"{grid.get('spacing')!r} given."
        )
    cams_raw = payload.get("cameras")
    if not isinstance(cams_raw, list) or not cams_raw:
        raise SartInputError(
            "Geometry record needs a non-empty 'cameras' list."
        )
    cameras = []
    for i, cam in enumerate(cams_raw):
        if not isinstance(cam, dict):
            raise SartInputError(f"Geometry camera #{i} must be an object.")
        name = cam.get("name")
        if not isinstance(name, str) or not name:
            raise SartInputError(
                f"Geometry camera #{i} needs a non-empty string 'name'."
            )
        try:
            rows, cols = int(cam["rows"]), int(cam["cols"])
        except (KeyError, TypeError, ValueError) as err:
            raise SartInputError(
                f"Geometry camera {name!r} needs integer 'rows'/'cols'."
            ) from err
        if rows < 1 or cols < 1:
            raise SartInputError(
                f"Geometry camera {name!r}: rows/cols must be >= 1."
            )
        position = _vec3(cam.get("position"), f"cameras[{name}].position")
        target = _vec3(cam.get("target"), f"cameras[{name}].target")
        up = _vec3(cam.get("up", (0.0, 0.0, 1.0)), f"cameras[{name}].up")
        pitch = cam.get("pitch", 1.0)
        try:
            pitch = float(pitch)
        except (TypeError, ValueError) as err:
            raise SartInputError(
                f"Geometry camera {name!r}: 'pitch' must be a number."
            ) from err
        if not (pitch > 0 and np.isfinite(pitch)):
            raise SartInputError(
                f"Geometry camera {name!r}: 'pitch' must be > 0."
            )
        view = np.asarray(target, np.float64) - np.asarray(
            position, np.float64)
        if not np.linalg.norm(view) > 0:
            raise SartInputError(
                f"Geometry camera {name!r}: position and target coincide."
            )
        up_v = np.asarray(up, np.float64)
        if not np.linalg.norm(up_v) > 0:
            raise SartInputError(
                f"Geometry camera {name!r}: 'up' must be non-zero."
            )
        # tolerance, not == 0: a nearly-parallel up survives the exact
        # test but yields a numerically meaningless detector basis
        sin_angle = np.linalg.norm(np.cross(
            view / np.linalg.norm(view), up_v / np.linalg.norm(up_v)
        ))
        if sin_angle < 1e-9:
            raise SartInputError(
                f"Geometry camera {name!r}: 'up' is parallel to the view "
                "direction."
            )
        cameras.append(Camera(
            name=name, rows=rows, cols=cols, position=position,
            target=target, up=up, pitch=pitch,
        ))
    names = [c.name for c in cameras]
    if len(set(names)) != len(names):
        raise SartInputError("Geometry camera names must be unique.")
    # cameras sorted by name: the repo-wide pixel-row order convention
    cameras.sort(key=lambda c: c.name)
    return GeometryRecord(
        grid_shape=shape, origin=origin, spacing=spacing,
        cameras=tuple(cameras), version=int(version),
    )


def load_geometry(path: str) -> GeometryRecord:
    """Read + validate a geometry record file."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
    except OSError as err:
        raise SartInputError(
            f"Cannot read geometry record {path!r}: {err}"
        ) from err
    return parse_geometry(text)


def save_geometry(record: GeometryRecord, path: str) -> None:
    """Write a geometry record (round-trips through
    :func:`load_geometry`)."""
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(record.to_dict(), fh, indent=1, sort_keys=True)
        fh.write("\n")


class GeometryVoxelGrid:
    """The voxel-map surface the output writer needs, derived from a
    geometry record instead of an HDF5 ``rtm/voxel_map`` group: a full
    regular Cartesian grid (no holes — flat cell ``i*ny*nz + j*nz + k``
    IS voxel ``i*ny*nz + j*nz + k``), so the solution file's voxel-map
    round trip works identically for matrix-free sessions."""

    def __init__(self, record: GeometryRecord):
        from sartsolver_tpu_torch.io.voxelgrid import CartesianVoxelGrid

        nx, ny, nz = record.grid_shape
        ox, oy, oz = record.origin
        dx, dy, dz = record.spacing
        grid = CartesianVoxelGrid()
        grid.nx, grid.ny, grid.nz = nx, ny, nz
        grid.xmin, grid.ymin, grid.zmin = ox, oy, oz
        grid.xmax = ox + nx * dx
        grid.ymax = oy + ny * dy
        grid.zmax = oz + nz * dz
        grid.dx, grid.dy, grid.dz = dx, dy, dz
        grid.nvox = record.nvoxel
        grid.voxmap = np.arange(record.nvoxel, dtype=np.int64)
        self._grid = grid

    def __getattr__(self, name):
        return getattr(self._grid, name)


__all__ = [
    "GEOMETRY_FORMAT", "GEOMETRY_VERSION", "Camera", "GeometryRecord",
    "GeometryVoxelGrid", "load_geometry", "parse_geometry",
    "save_geometry",
]
