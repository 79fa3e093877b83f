"""Solution writer: buffered, incrementally-flushed HDF5 output.

The JAX package's ``SolutionWriter`` (``sartsolver_tpu/io/solution.py``).
Mirrors the reference's ``Solution`` (solution.cpp): solutions, statuses and
times are buffered per frame and flushed every ``max_cache_size`` frames and
on close; the first flush creates extendible chunked datasets
(``solution/value [T, nvoxel]``, ``time``, ``time_<camera>``, ``iterations``,
``checksum``, ``status``), later flushes extend and append. The schema,
including the per-row checksum and the ``completed`` counter, is the JAX
writer's, and so is the layout: chunked datasets of unlimited length, with
the JAX writer's chunk shapes and fill values. Either package reads the
other's files and resumes them (``--resume``).

Files go through :mod:`sartsolver_tpu_torch.io.h5`. The first flush writes
a new file whole (through a temporary renamed over the target, so it
appears complete or not at all); every later flush appends in place — the
new chunks, the chunk indexes and the datasets' extents, ``fsync``, then
the ``completed`` counter, ``fsync`` — so a flush costs its own rows, never
the rows already written. A flush killed half way leaves a file whose
counter still names its last committed flush: :func:`read_resume_state`
trusts the counter and the shortest dataset, checks every completed row's
CRC32, and the writer opened with ``resume=`` truncates a torn tail before
it appends. A flush is the named fault site ``io.flush``; a failed flush
raises :class:`~sartsolver_tpu_torch.resilience.failures.OutputWriteError`
(the CLI's infrastructure exit), the file keeping its last committed flush.
"""

from __future__ import annotations

import os
import sys
import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence

from sartsolver_tpu_torch.io import h5
import numpy as np


def stripe_digest(array: np.ndarray) -> int:
    """CRC32 of an array's bytes (contiguous C layout) — the same digest as
    ``sartsolver_tpu/resilience/integrity.py:stripe_digest``."""
    return zlib.crc32(np.ascontiguousarray(array).tobytes()) & 0xFFFFFFFF


def row_checksum(row: np.ndarray) -> np.uint32:
    """CRC32 of one solution row's fp64 bytes, written beside
    ``solution/value`` and verified on ``--resume``."""
    return np.uint32(stripe_digest(np.asarray(row, np.float64)))


def _crash_window(point: str) -> None:
    """Test hook: with ``SART_TEST_FLUSH_DELAY`` set, announce the named
    commit point on stderr (``SART_FLUSH_POINT <point>``) and sleep that
    many seconds inside it, so a kill drill can SIGKILL the process there:
    ``torn`` (the time dataset written, the others not yet) and
    ``pre-counter`` (the rows durable, the counter stale). Nothing when
    unset."""
    delay = os.environ.get("SART_TEST_FLUSH_DELAY")
    if delay:
        sys.stderr.write(f"SART_FLUSH_POINT {point}\n")
        sys.stderr.flush()
        time.sleep(float(delay))


class ResumeState(NamedTuple):
    """What a previous (possibly interrupted) run already produced."""

    times: np.ndarray  # [T] frame times already written
    last_solution: Optional[np.ndarray]  # warm start for the next frame


def read_resume_state(filename: str, camera_names: Sequence[str],
                      nvoxel: int, rows: Optional[int] = None) -> Optional[ResumeState]:
    """The frames a previous run of this output already wrote
    (``sartsolver_tpu/io/solution.py:read_resume_state``); with ``rows``,
    at most its first ``rows`` (a pod resumes from the prefix every host's
    file holds, and the writer then truncates the rest).

    None where the file does not exist, holds no solutions, or was cut in
    its first flush (``status`` is created last). ``SartInputError`` where
    it holds another voxel count or camera set, or where a completed row
    fails its stored CRC32 (the file is corrupt). A frame counts as
    completed only if every per-frame dataset holds it and the
    ``completed`` counter — the flush's last write — covers it."""
    from sartsolver_tpu_torch.config import SartInputError

    if not os.path.exists(filename):
        return None
    with h5.File(filename, "r") as f:
        if "solution" not in f or "value" not in f["solution"]:
            return None
        group = f["solution"]
        if "status" not in group or "time" not in group:
            return None  # torn first flush: start afresh
        value = group["value"]
        if value.shape[1] != nvoxel:
            raise SartInputError(
                f"Cannot resume into {filename}: it holds solutions of "
                f"{value.shape[1]} voxels, this problem has {nvoxel}.")
        expected = {f"time_{name}" for name in camera_names}
        have = {k for k in group if k.startswith("time_")}
        if expected != have:
            raise SartInputError(
                f"Cannot resume into {filename}: camera set mismatch "
                f"(file has {sorted(have)}, run has {sorted(expected)}).")
        per_frame = [value, group["time"], group["status"]]
        per_frame += [group[k] for k in ("iterations", "checksum") if k in group]
        completed = min(*(d.shape[0] for d in per_frame),
                        *(group[k].shape[0] for k in expected))
        if "completed" in group.attrs:
            completed = min(completed, int(group.attrs["completed"]))
        if rows is not None:
            completed = min(completed, rows)
        if "checksum" in group and completed:
            stored = np.asarray(group["checksum"][:completed], np.uint32)
            # slabs of whole chunks: each chunk is read once
            slab = max(1, (value.chunks or (completed,))[0])
            for a in range(0, completed, slab):
                b = min(a + slab, completed)
                rows = value[a:b, :]
                for i in range(a, b):
                    if np.uint32(stored[i]) != row_checksum(rows[i - a]):
                        raise SartInputError(
                            f"Cannot resume into {filename}: solution row "
                            f"{i} fails its stored checksum (the file is "
                            "corrupt); re-run without --resume or restore "
                            "the file.")
        times = group["time"][:completed]
        last = value[completed - 1, :] if completed else None
        return ResumeState(np.asarray(times), last)


class SolutionWriter:
    def __init__(
        self,
        filename: str,
        camera_names: Sequence[str],
        nvoxel: int,
        max_cache_size: int = 100,
        resume: "bool | ResumeState" = False,
    ):
        """``resume``: True (the file is inspected here) or the
        :class:`ResumeState` the caller read; a torn tail past the
        completed frames is truncated at once, so the appends continue
        from a consistent file."""
        if nvoxel <= 0:
            raise ValueError("Argument nvoxel must be positive.")
        if max_cache_size <= 0:
            raise ValueError("Attribute max_cache_size must be positive.")
        self.filename = filename
        self.nvox = nvoxel
        self.max_cache_size = max_cache_size
        state = (read_resume_state(filename, camera_names, nvoxel)
                 if resume is True else (resume or None))
        self.first_flush = state is None
        if state is not None:
            self._truncate_torn_tail(len(state.times))
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
        from sartsolver_tpu_torch.resilience import faults, watchdog
        from sartsolver_tpu_torch.resilience.failures import OutputWriteError

        watchdog.beacon(watchdog.PHASE_FLUSH)
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

    def _truncate_torn_tail(self, completed: int) -> None:
        """Shrink every per-frame dataset to the completed-frame count (a
        flush killed half way can leave them longer), in place."""
        with h5.File(self.filename, "r+") as f:
            group = f["solution"]
            for key in group:
                dset = group[key]
                if dset.shape[0] > completed:
                    dset.resize((completed,) + tuple(dset.shape[1:]))
            f.flush()
            group.attrs["completed"] = completed

    def _create(self) -> None:
        """First flush: new file with extendible datasets (solution.cpp:60-112),
        written whole and renamed into place, ``status`` created last as in
        the JAX writer."""
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
        """Later flushes: extend and append in place (solution.cpp:114-165).
        The commit points are the JAX writer's: the rows, the chunk indexes
        and the extents, ``fsync``; then the ``completed`` counter, ``fsync``
        (on close)."""
        n = len(self._solutions)
        with h5.File(self.filename, "r+") as f:
            group = f["solution"]
            offset = group["time"].shape[0]
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
            for i, (key, data) in enumerate(per_frame):
                if key not in group:  # a file from before the dataset
                    continue
                dset = group[key]
                dset.resize((new_size,))
                dset[offset:] = data
                if i == 0:
                    _crash_window("torn")  # time written, the rest not yet
            dset = group["value"]
            dset.resize((new_size, self.nvox))
            dset[offset:] = np.stack(self._solutions)
            f.flush()
            _crash_window("pre-counter")  # rows durable, counter stale
            group.attrs["completed"] = new_size
