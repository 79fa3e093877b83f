"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/sartsolver_tpu_torch/lib<name>-<hash>.so`` beside the
package, where ``<hash>`` covers the source and the compiler flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Nothing
here runs at import time: a machine without ``nvcc`` imports the package
and fails only when a kernel is asked for.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
all of them. A source that declares ``// sart-build-parts: N`` is compiled
as N objects at once, each with ``-DSART_PART=k`` (k = 1..N: a share of
its kernel instances, as the source defines them), and linked into its one
library.

A build inside a run announces itself to the hang watchdog (a ``build``
beacon before ``nvcc`` starts and one when it is done); ``nvcc`` itself
beacons nothing, so a cold build that outlasts ``SART_WATCHDOG_TIMEOUT``
(and the grace after it) aborts the run with exit 3. Build first (any run
on the card, ``load``, ``build_all``) or give the watchdog a timeout above
the build's half minute or so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sartsolver_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else the one under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); the CUDA kernels "
        "of sartsolver_tpu_torch are built on first use and need it."
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _parts(src: Path) -> int:
    """The parts ``src`` declares (``// sart-build-parts: N``), else 0."""
    found = re.search(rb"^// sart-build-parts: (\d+)$", src.read_bytes(), re.M)
    return int(found.group(1)) if found else 0


def _start_build(name: str):
    """Start compiling ``name`` unless its library exists; returns
    ``(processes, object paths, temp path, final path)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = CSRC / f"{name}.cu"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    n = _parts(src)
    if n:
        objs = [out.with_suffix(f".{os.getpid()}.part{k}.o") for k in range(1, n + 1)]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        cmds = [[nvcc_path(), *compile_flags, f"-DSART_PART={k}", "-c", "-o", str(obj),
                 str(src)] for k, obj in enumerate(objs, 1)]
    else:
        objs, cmds = [], [[nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    return procs, objs, tmp, out


def _finish_build(name: str, job) -> None:
    procs, objs, tmp, out = job
    logs = [proc.communicate()[0] for proc in procs]
    try:
        failed = [log for proc, log in zip(procs, logs) if proc.returncode != 0]
        if not failed and objs:
            link = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(link.stdout + link.stderr)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {name}.cu:\n" + "\n".join(failed))
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing


def build_all() -> None:
    """Compile every ``csrc/*.cu`` that is not built yet, in parallel."""
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        job = _start_build(src.stem)
        if job is not None:
            jobs[src.stem] = job
    errors = []
    for name, job in jobs.items():
        try:
            _finish_build(name, job)
        except RuntimeError as err:
            errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        from sartsolver_tpu_torch.resilience import watchdog

        job = _start_build(name)
        if job is not None:
            watchdog.beacon(watchdog.PHASE_BUILD)
            _finish_build(name, job)
            watchdog.beacon(watchdog.PHASE_BUILD)
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
