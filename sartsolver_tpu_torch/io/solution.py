"""Solution writer: buffered, incrementally-flushed HDF5 output.

The JAX package's ``SolutionWriter`` (``sartsolver_tpu/io/solution.py``)
without ``--resume``. Mirrors the reference's ``Solution`` (solution.cpp):
solutions, statuses and times are buffered per frame and flushed every
``max_cache_size`` frames and on close; the first flush creates extendible
chunked datasets (``solution/value [T, nvoxel]``, ``time``,
``time_<camera>``, ``iterations``, ``checksum``, ``status``), later flushes
extend and append. The schema, including the per-row checksum and the
``completed`` counter, is the JAX writer's, and so is the layout: chunked
datasets of unlimited length, with the JAX writer's chunk shapes and fill
values. Either package reads the other's files, and the JAX writer's
``--resume`` appends to a file this writer wrote.

Files go through :mod:`sartsolver_tpu_torch.io.h5`, which rewrites the
file whole on each flush through a temporary file renamed over it: a flush
is atomic, so the rows and the ``completed`` counter always agree. The cost
is a rewrite of the rows already written on every flush. A flush is the
named fault site ``io.flush``; a failed flush raises
:class:`~sartsolver_tpu_torch.resilience.failures.OutputWriteError` (the
CLI's infrastructure exit), the file keeping its last committed flush.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Sequence

from sartsolver_tpu_torch.io import h5
import numpy as np


def stripe_digest(array: np.ndarray) -> int:
    """CRC32 of an array's bytes (contiguous C layout) — the same digest as
    ``sartsolver_tpu/resilience/integrity.py:stripe_digest``."""
    return zlib.crc32(np.ascontiguousarray(array).tobytes()) & 0xFFFFFFFF


def row_checksum(row: np.ndarray) -> np.uint32:
    """CRC32 of one solution row's fp64 bytes, written beside
    ``solution/value``."""
    return np.uint32(stripe_digest(np.asarray(row, np.float64)))


class SolutionWriter:
    def __init__(
        self,
        filename: str,
        camera_names: Sequence[str],
        nvoxel: int,
        max_cache_size: int = 100,
    ):
        if nvoxel <= 0:
            raise ValueError("Argument nvoxel must be positive.")
        if max_cache_size <= 0:
            raise ValueError("Attribute max_cache_size must be positive.")
        self.filename = filename
        self.nvox = nvoxel
        self.max_cache_size = max_cache_size
        self.first_flush = True
        self._solutions: List[np.ndarray] = []
        self._status: List[int] = []
        self._iterations: List[int] = []
        self._checksums: List[np.uint32] = []
        self._time: List[float] = []
        self._camera_time: Dict[str, List[float]] = {name: [] for name in camera_names}

    def add(
        self,
        solution: np.ndarray,
        status: int,
        time: float,
        camera_time: Sequence[float],
        iterations: int = -1,
    ) -> None:
        """Buffer one frame's result (solution.cpp:44-58). ``camera_time``
        is ordered like the camera-name list; ``iterations`` (-1 = unknown)
        records the per-frame convergence cost beside the status code."""
        self._status.append(int(status))
        solution = np.asarray(solution, np.float64)
        self._solutions.append(solution)
        self._checksums.append(row_checksum(solution))
        self._time.append(float(time))
        self._iterations.append(int(iterations))
        for name, t in zip(self._camera_time, camera_time):
            self._camera_time[name].append(float(t))
        if len(self._solutions) >= self.max_cache_size:
            self.flush()

    def flush(self) -> None:
        """Write the buffered frames out. A failure is not retried in place
        (a flush retried blind could append twice): it is raised as
        ``OutputWriteError``."""
        if not self._solutions:
            return
        from sartsolver_tpu_torch.resilience import faults
        from sartsolver_tpu_torch.resilience.failures import OutputWriteError

        try:
            faults.fire(faults.SITE_FLUSH)
            if self.first_flush:
                self._create()
            else:
                self._update()
        except OSError as err:
            raise OutputWriteError(
                f"flush of {self.filename} failed ({err}); the file is "
                "resumable up to its last committed flush (--resume)"
            ) from err
        self.first_flush = False
        self._solutions.clear()
        self._status.clear()
        self._iterations.clear()
        self._checksums.clear()
        self._time.clear()
        for v in self._camera_time.values():
            v.clear()

    def close(self) -> None:
        self.flush()

    def __enter__(self) -> "SolutionWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _create(self) -> None:
        """First flush: new file with extendible datasets (solution.cpp:60-112).
        ``status`` is created last, as in the JAX writer."""
        n = len(self._solutions)
        with h5.File(self.filename, "w") as f:
            group = f.create_group("solution")
            group.create_dataset(
                "value", data=np.stack(self._solutions),
                maxshape=(None, self.nvox), chunks=(1, self.nvox),
                dtype=np.float64, fillvalue=0.0,
            )
            group.create_dataset(
                "time", data=np.asarray(self._time), maxshape=(None,),
                chunks=(n,), dtype=np.float64, fillvalue=0.0,
            )
            for name, times in self._camera_time.items():
                group.create_dataset(
                    f"time_{name}", data=np.asarray(times), maxshape=(None,),
                    chunks=(n,), dtype=np.float64, fillvalue=0.0,
                )
            group.create_dataset(
                "iterations", data=np.asarray(self._iterations, np.int32),
                maxshape=(None,), chunks=(n,), dtype=np.int32, fillvalue=-1,
            )
            group.create_dataset(
                "checksum", data=np.asarray(self._checksums, np.uint32),
                maxshape=(None,), chunks=(n,), dtype=np.uint32, fillvalue=0,
            )
            group.create_dataset(
                "status", data=np.asarray(self._status, np.int32),
                maxshape=(None,), chunks=(n,), dtype=np.int32, fillvalue=0,
            )
            group.attrs["completed"] = n

    def _update(self) -> None:
        """Later flushes: extend + append (solution.cpp:114-165)."""
        n = len(self._solutions)
        with h5.File(self.filename, "r+") as f:
            offset = f["solution/time"].shape[0]
            new_size = offset + n
            per_frame = [
                ("time", np.asarray(self._time)),
                ("status", np.asarray(self._status, np.int32)),
                ("iterations", np.asarray(self._iterations, np.int32)),
                ("checksum", np.asarray(self._checksums, np.uint32)),
            ] + [
                (f"time_{name}", np.asarray(times))
                for name, times in self._camera_time.items()
            ]
            for key, data in per_frame:
                dset = f[f"solution/{key}"]
                dset.resize((new_size,))
                dset[offset:] = data
            dset = f["solution/value"]
            dset.resize((new_size, self.nvox))
            dset[offset:] = np.stack(self._solutions)
            f["solution"].attrs["completed"] = new_size
