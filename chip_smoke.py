#!/usr/bin/env python3
"""Drive sartsolver_tpu_torch on one CUDA card and check what comes out.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the checkout itself (it imports the package beside
it), and exits non-zero without them. Phases, each printing one JSON line:

1. ``env``: torch and CUDA versions, the card's name and power limit.
2. ``build``: every ``csrc/*.cu`` of the package built with ``nvcc``, in
   parallel, into ``build/sartsolver_tpu_torch/``.
3. ``kernels``: the fused-sweep kernel against its plain PyTorch version on
   the card, for each storage type (B1/B2 fp32, B3 bf16, B4 int8 codes with
   their scales), linear and log, with and without the penalty, at the main
   path's shape (B = 1, 8192 x 65536) and at a ragged one (B = 3,
   1000 x 3001), each through the plan ``plan_sweep`` gives it; then every
   plan at the shapes that select it (``one_read`` at B = 3, ``tensor_core``
   at B = 8, 16, 19, 32 and ragged 1000 x 3008 x 19) and ``two_read`` forced
   where the new plans took over: max error within ``KERNEL_TOL`` of the
   output's max, two launches byte-identical, the plan's launch count
   advanced. Then B4 at the configuration of the three int8 Pallas probes
   under ``benchmarks/`` (8192 x 65536, B = 32, linear, no penalty; the
   direct-dot probe with scale 1 and ``invd = 1e-6``), checked the same way
   through ``tensor_core`` and forced ``two_read``. Then each row's kernel,
   plain-version and library times beside its bound, and the CUDA kernels
   one call launches with their device times (``torch.profiler``); the new
   plans timed in turns with forced ``two_read`` (old, new, new, old); the
   ``two_read`` / ``tensor_core`` crossover over B at 8192 x 65536 int8 and
   the ``two_read`` / ``one_read`` crossover over P, V and B in fp32.
4. ``solve``: the realistic-scale world of ``benchmarks/e2e_world.py``
   (2 cameras of 64 x 64, a 256 x 256 x 1 grid, a 2 GiB fp32 RTM, 32
   frames, 1% noise, a chain Laplacian) written to HDF5 by this script's own
   numpy code and the package's HDF5 writer, then the port's ``sartsolve``
   run in-process on the card for each ``--rtm_dtype`` (float32, bfloat16,
   int8): linear with the Laplacian over 8 frames, logarithmic over 4.
   Launch counts are zeroed just before and read just after; every frame's
   status must be 0 or the ``-m`` cap, its fitted-space error against the
   noiseless measurement within ``FIT_BOUND``, and each storage type's
   launches equal to its runs' iterations, by storage and by plan (fp32
   through ``one_read``, bf16 and int8 through ``two_read``). Each run's
   peak device memory and its fitted-space distance to the fp32 run are
   printed.
4b. ``batch``: the 32 frames of the world solved at once through the solver
   API (``solve_normalized_batch``, B = 32) with int8 storage and the
   Laplacian, so through ``tensor_core``: counts zeroed before and read
   after (one launch per loop iteration), statuses and fitted-space errors
   as above; then through the plain version: the same statuses, and over
   ``BATCH_CROSS_ITERATIONS`` iterations without the stall test each
   frame's fitted space within ``CROSS_TOL`` of the kernel's.
5. ``plain_crosscheck``: frame 0 solved through the kernel and through the
   plain version (the solver core's ``sweep_fn``): equal statuses,
   iteration counts at most 1 apart, fitted-space agreement within
   ``CROSS_TOL``.
6. ``profile``: frame 0 once more under ``torch.profiler`` for each storage
   type: device time by kernel, the solve's wall time and the device's idle
   share.

Then the kernel table as one JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# fp32 sums of up to 65536 terms taken in another order than cuBLAS's
KERNEL_TOL = 1e-5
# 1% measurement noise bounds how close a solution's projection can come to
# the noiseless data; the Laplacian's bias adds a little (the JAX package's
# own check, tests/test_cli.py, holds H @ solution to 5% of H @ f_true)
FIT_BOUND = 0.05
# kernel against plain version in fitted space: frame 0 of the main path,
# and the batched int8 solve
CROSS_TOL = 1e-3
# iterations of the batched solve's fixed-count comparison with the plain
# version (about where its frames converge)
BATCH_CROSS_ITERATIONS = 100
# (P, V) of the one_read / two_read crossover, each at B = 1 .. 4
ONE_READ_CROSSOVER_PV = ((1024, 65536), (2048, 65536), (4096, 65536), (5120, 65536),
                         (6144, 65536), (7168, 65536), (8192, 65536), (8192, 4096),
                         (8192, 1024), (1000, 3008))
MAX_ITERATIONS = 500  # -m cap of the main path's runs

# card -> (memory rate in B/s, fp32 rate outside the tensor cores in FLOP/s,
# bf16 dense tensor-core rate in FLOP/s); NVIDIA's data sheets, dense rates
# at the full power limit
PEAKS = {"PCIe": (2.0e12, 51e12, 756e12), "SXM": (3.35e12, 67e12, 989e12)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---- the e2e world (benchmarks/e2e_world.py, same seed and construction) --

def _write_voxel_map(group, nx, ny, cells, values):
    vm = group.create_group("voxel_map")
    for name, n in (("nx", nx), ("ny", ny), ("nz", 1)):
        vm.attrs.create(name, n, dtype=np.uint64)
    for name, val in (("xmin", 0.0), ("xmax", 4.0), ("ymin", 0.0),
                      ("ymax", 4.0), ("zmin", 0.0), ("zmax", 1.0)):
        vm.attrs.create(name, val, dtype=np.float64)
    vm.create_dataset("i", data=(cells // ny).astype(np.uint64))
    vm.create_dataset("j", data=(cells % ny).astype(np.uint64))
    vm.create_dataset("k", data=np.zeros_like(cells, np.uint64))
    vm.create_dataset("value", data=values.astype(np.int64))


def _write_rtm(path, camera, mask, block, nx, ny, cells, values):
    from sartsolver_tpu_torch.io import h5

    with h5.File(path, "w") as f:
        rtm = f.create_group("rtm")
        rtm.attrs["camera_name"] = camera
        rtm.attrs.create("npixel", block.shape[0], dtype=np.uint64)
        rtm.attrs.create("nvoxel", block.shape[1], dtype=np.uint64)
        rtm.create_dataset("frame_mask", data=mask)
        g = rtm.create_group("with_reflections")
        g.attrs.create("wavelength", 500.0, dtype=np.float64)
        g.attrs.create("is_sparse", 0, dtype=np.int64)
        g.create_dataset("value", data=block)
        _write_voxel_map(rtm, nx, ny, cells, values)


def _write_image(path, camera, frames, times):
    from sartsolver_tpu_torch.io import h5

    with h5.File(path, "w") as f:
        img = f.create_group("image")
        img.attrs["camera_name"] = camera
        img.attrs.create("wavelength", 500.0, dtype=np.float64)
        img.create_dataset("frame", data=np.asarray(frames, np.float64))
        img.create_dataset("time", data=np.asarray(times, np.float64))


def _write_laplacian(path, nvoxel, scale=0.1):
    from sartsolver_tpu_torch.io import h5

    # per voxel i: (i, i, 2s), then (i, i-1, -s) and (i, i+1, -s) where
    # they exist — the triplet order of tests/fixtures.py:write_laplacian_file
    i = np.arange(nvoxel)[:, None]
    rows, cols = np.broadcast_to(i, (nvoxel, 3)), i + np.array([0, -1, 1])
    vals = np.broadcast_to(np.array([2 * scale, -scale, -scale]), (nvoxel, 3))
    keep = (cols >= 0) & (cols < nvoxel)
    with h5.File(path, "w") as f:
        g = f.create_group("laplacian")
        g.attrs.create("nvoxel", nvoxel, dtype=np.uint64)
        g.create_dataset("i", data=rows[keep].astype(np.uint64))
        g.create_dataset("j", data=cols[keep].astype(np.uint64))
        g.create_dataset("value", data=vals[keep].astype(np.float32))


def write_world(outdir: str, nx: int = 256, ny: int = 256, cam=(64, 64),
                n_frames: int = 32) -> dict:
    """Write the e2e world; returns the file paths plus ``H`` [P, V] fp32,
    ``f_true`` [V] and ``scales`` [T]. The defaults are the realistic scale;
    tests call it smaller."""
    V = nx * ny
    npix_cam = cam[0] * cam[1]
    mask = np.ones(cam, np.int64)
    rng = np.random.default_rng(0)
    # banded response + diffuse reflection floor (reflections make the
    # matrix dense)
    ii = np.arange(2 * npix_cam, dtype=np.float32)[:, None] / (2 * npix_cam)
    jj = np.arange(V, dtype=np.float32)[None, :] / V
    H = rng.random((2 * npix_cam, V), dtype=np.float32) * 0.9 + 0.1
    H *= np.exp(-((ii - jj) ** 2) * 200.0) + 0.02

    cells = np.arange(V)
    half = V // 2
    paths = {k: os.path.join(outdir, f"{k}.h5") for k in (
        "rtm_a_seg1", "rtm_a_seg2", "rtm_b", "img_a", "img_b", "laplacian")}
    # camera A in two voxel segments (the stitching path), camera B whole
    _write_rtm(paths["rtm_a_seg1"], "camA", mask, H[:npix_cam, :half], nx, ny,
               cells[:half], np.arange(half))
    _write_rtm(paths["rtm_a_seg2"], "camA", mask, H[:npix_cam, half:], nx, ny,
               cells[half:], np.arange(half))
    _write_rtm(paths["rtm_b"], "camB", mask, H[npix_cam:], nx, ny, cells, np.arange(V))

    times = np.arange(n_frames) * 0.1
    f_true = rng.random(V, dtype=np.float32) * 1.5 + 0.5
    scales = 1.0 + 0.3 * np.sin(np.linspace(0, 2 * np.pi, n_frames))
    F = (f_true[:, None] * scales[None, :]).astype(np.float32)  # [V, T]
    G = H @ F
    G *= 1.0 + 0.01 * rng.standard_normal(G.shape).astype(np.float32)
    _write_image(paths["img_a"], "camA", G[:npix_cam].T.reshape(n_frames, *cam), times)
    _write_image(paths["img_b"], "camB", G[npix_cam:].T.reshape(n_frames, *cam), times)
    _write_laplacian(paths["laplacian"], V)
    return {"paths": paths, "H": H, "f_true": f_true, "scales": scales,
            "G": G, "times": times}


def run_cli(argv, device: str = "cuda"):
    """The port's CLI in-process; returns (exit code, per-frame ms)."""
    from sartsolver_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*argv, "--device", device])
    text = buf.getvalue()
    ms = [float(m) for m in re.findall(r"Processed in: ([0-9.eE+-]+) ms", text)]
    return rc, ms


def check_solution(path, world, n_frames: int, cap: int, device):
    """Schema, statuses and fitted-space errors of one solution file."""
    from sartsolver_tpu_torch.io import h5
    import torch

    with h5.File(path, "r") as f:
        sol = {k: f["solution"][k][:] for k in f["solution"]}
        has_map = "voxel_map" in f and f["voxel_map/value"].shape[0] == world["H"].shape[1]
    want = {"value", "time", "status", "iterations", "checksum", "time_camA", "time_camB"}
    if set(sol) != want or not has_map:
        raise AssertionError(f"solution schema {sorted(sol)}, voxel_map {has_map}")
    V = world["H"].shape[1]
    if sol["value"].shape != (n_frames, V) or not np.isfinite(sol["value"]).all():
        raise AssertionError(f"solution/value {sol['value'].shape} or not finite")
    ok = (sol["status"] == 0) | ((sol["status"] == -1) & (sol["iterations"] == cap))
    if not ok.all():
        raise AssertionError(f"statuses {sol['status']} iterations {sol['iterations']}")
    H = torch.as_tensor(world["H"], device=device)
    truth = torch.as_tensor(world["f_true"][:, None] * world["scales"][None, :n_frames],
                            dtype=torch.float32, device=device)
    fit = H @ torch.as_tensor(sol["value"].T, dtype=torch.float32, device=device)
    ref = H @ truth
    err = ((fit - ref).norm(dim=0) / ref.norm(dim=0)).cpu().numpy()
    if not (err <= FIT_BOUND).all():
        raise AssertionError(f"fitted-space errors {err} above {FIT_BOUND}")
    return sol, err


# ---- kernel checks and timing ---------------------------------------------

STORAGES = ("float32", "bfloat16", "int8")
VARIANT = {"float32": "B1/B2", "bfloat16": "B3", "int8": "B4"}
REPLACES = "sartsolver_tpu/ops/fused_sweep.py:829"
SOURCE = "sartsolver_tpu_torch/ops/csrc/fused_sweep.cu"
# the int8 Pallas probes: (name, TPU kernel, direct dot)
PROBES = (
    ("int8_dequant_probe", "benchmarks/int8_dequant_probe.py:17", False),
    ("int8_scratch_probe", "benchmarks/int8_scratch_probe.py:54", False),
    ("int8_direct_dot_probe", "benchmarks/int8_direct_dot_probe.py:30", True),
)


def _rand(g):
    import torch

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, generator=g, device="cuda") * (hi - lo) + lo
    return rand


def _sweep_inputs(P, V, B, logarithmic, with_pen, seed, storage="float32"):
    """Random sweep inputs on the card: ``(H, w, f, aux, scale)``, ``H`` in
    the storage dtype (int8 codes quantized from an fp32 draw, with their
    ``scale`` [1, V]; None for float storage)."""
    import torch

    from sartsolver_tpu_torch.models.sart import quantize_rtm

    rand = _rand(torch.Generator(device="cuda").manual_seed(seed))
    H = rand(P, V)
    scale = None
    if storage == "bfloat16":
        H = H.to(torch.bfloat16)
    elif storage == "int8":
        H, s = quantize_rtm(H)
        scale = s[None, :]
    w = rand(B, P, lo=0.0 if logarithmic else -0.5) / P
    f = rand(B, V, lo=0.1, hi=2.0)
    if logarithmic:  # obs is zero where the voxel mask is, as make_obs leaves it
        vm = (rand(1, V) > 0.1).float()
        aux = [vm, rand(B, V, lo=0.1) * vm]
    else:
        aux = [rand(1, V, hi=2.0)]
    if with_pen:
        aux.append(rand(B, V, lo=-0.01, hi=0.01))
    return H, w, f, aux, scale


def _probe_inputs(direct: bool, seed: int):
    """B4 at the int8 probes' configuration (8192 x 65536, B = 32, linear,
    no penalty). The dequant and scratch probes quantize ``0.1 + 0.9 U`` per
    voxel and take ``invd`` from the quantized column sums; the direct-dot
    probe feeds codes in [0, 127) with no scale (scale 1) and ``invd =
    1e-6``, from ``f = 0``."""
    import torch

    from sartsolver_tpu_torch.models.sart import quantize_rtm

    P, V, B = 8192, 65536, 32
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = _rand(g)
    if direct:
        H = torch.randint(0, 127, (P, V), generator=g, device="cuda", dtype=torch.int8)
        scale = torch.ones((1, V), device="cuda")
        invd = torch.full((1, V), 1e-6, device="cuda")
        f = torch.zeros((B, V), device="cuda")
    else:
        H, s = quantize_rtm(rand(P, V, lo=0.1, hi=1.0))
        scale = s[None, :]
        invd = 1.0 / (scale * H.sum(dim=0, dtype=torch.int32).float()[None, :])
        f = rand(B, V, lo=0.0, hi=2.0)
    w = rand(B, P, lo=-0.5, hi=1.0) / P
    return H, w, f, [invd], scale


def _check_kernel(H, w, f, aux, scale, kw, storage, plan=None, enforce=True):
    """Kernel against plain version through ``plan`` (None: the shape's
    own): (record, max_abs_err); raises on a failed check unless not
    ``enforce`` (a measurement-only variant)."""
    import torch

    from sartsolver_tpu_torch.ops.fused_sweep import (
        _sweep, fused_sweep, fused_sweep_reference, plan_sweep,
    )

    if plan is None:
        plan = plan_sweep(*H.shape, w.shape[0], storage)
    before = fused_sweep.launches_by_plan[plan]
    out1 = _sweep(H, w, f, aux, scale=scale, plan=plan, **kw)
    out2 = _sweep(H, w, f, aux, scale=scale, plan=plan, **kw)
    ref = fused_sweep_reference(H, w, f, aux, scale=scale, **kw)
    torch.cuda.synchronize()
    counted = fused_sweep.launches_by_plan[plan] - before
    identical = all(torch.equal(a, b) for a, b in zip(out1, out2))
    abs_err = max(float((a - r).abs().max()) for a, r in zip(out1, ref))
    rel = max(float((a - r).abs().max()) / float(r.abs().max())
              for a, r in zip(out1, ref))
    finite = all(bool(torch.isfinite(r).all()) for r in ref)
    passed = identical and counted == 2 and finite and rel <= KERNEL_TOL
    logarithmic = kw["logarithmic"]
    record = dict(storage=storage, plan=plan, shape=[*H.shape, w.shape[0]],
                  mode="log" if logarithmic else "linear",
                  pen=len(aux) > (2 if logarithmic else 1),
                  max_rel_err=rel, max_abs_err=abs_err, byte_identical=identical,
                  launches_counted=counted, ok=passed)
    if enforce and not passed:
        raise AssertionError(f"fused_sweep check failed: {record}")
    return record, abs_err


def _median_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _in_turns(old, new) -> tuple:
    """Median ms of two callables timed in turns, old, new, new, old:
    ``(old_ms, new_ms, turns)``, each the mean of its two medians."""
    turns = [_median_ms(old), _median_ms(new), _median_ms(new), _median_ms(old)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


def _device_profile(fn, calls: int = 5) -> dict:
    """From ``torch.profiler`` over ``calls`` calls of ``fn`` after one
    warm-up: the device time per call of each CUDA kernel it launches, and
    how many distinct kernels that is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return dict(ms_by_kernel=out, kernels_per_call=len(out))


def _bound(H, w, aux, scale, plan, rates) -> dict:
    """The least time of one sweep at this shape: its bytes (each input
    read once, each output written once) at the memory rate against its
    operations at the rate of their type (fp32 FMAs, or three bf16
    tensor-core products for ``tensor_core``)."""
    mem_rate, fp32_rate, bf16_rate = rates
    P, V = H.shape
    B = w.shape[0]
    vectors = B * P + B * V + sum(a.numel() for a in aux) + B * V + B * P
    if scale is not None:
        vectors += scale.numel()
    nbytes = H.element_size() * P * V + 4 * vectors
    flops = 4 * B * P * V
    if plan == "tensor_core":
        flops, rate, rate_name = 3 * flops, bf16_rate, "bf16 dense tensor cores, 3 products"
    else:
        rate, rate_name = fp32_rate, "fp32 outside the tensor cores"
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, flops / rate * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_rate=rate_name, bytes=nbytes, flops=flops)


def _timing(H, w, f, aux, scale, kw, rates, plan, versus=None) -> dict:
    """Kernel, plain-version and library times beside the bound. With
    ``versus`` (another plan) the two are timed in turns, old, new, new,
    old, and each reported as the mean of its two medians. The library
    yardstick is two ``torch.matmul`` around the update on an fp32 copy of
    the (dequantized) matrix made outside the timed window, so it reads 4
    bytes per element whatever the storage."""
    import torch

    from sartsolver_tpu_torch.ops.fused_sweep import _sweep, fused_sweep_reference

    P, V = H.shape
    B = w.shape[0]
    logarithmic, eps = kw["logarithmic"], kw.get("eps", 0.0)
    Hd = H.float() if scale is None else H.float() * scale

    def library():
        bp = torch.matmul(w, Hd)
        if logarithmic:
            f_new = f * ((aux[1] + eps) / (bp * aux[0] + eps))
        else:
            f_new = f + aux[0] * bp
            f_new = torch.clamp_min(f_new - aux[1] if len(aux) > 1 else f_new, 0)
        return torch.matmul(f_new, Hd.T)

    def kernel(name):
        return lambda: _sweep(H, w, f, aux, scale=scale, plan=name, **kw)

    if versus is None:
        ms, other = _median_ms(kernel(plan)), None
    else:
        old_ms, ms, turns = _in_turns(kernel(versus), kernel(plan))
        other = dict(plan=versus, ms=old_ms, turns_ms=turns,
                     device=_device_profile(kernel(versus)))
    out = dict(
        plan=plan, ms=ms, device=_device_profile(kernel(plan)),
        plain_ms=_median_ms(lambda: fused_sweep_reference(H, w, f, aux, scale=scale, **kw)),
        library_ms=_median_ms(library),
        **_bound(H, w, aux, scale, plan, rates),
        shape=[P, V, B], storage=str(H.dtype)[6:],
        mode="log" if logarithmic else "linear", pen=len(aux) > (2 if logarithmic else 1),
    )
    if other is not None:
        out["versus"] = dict(other, **_bound(H, w, aux, scale, versus, rates))
    del Hd
    return out


def kernel_phase(card: str):
    """Every check and timing of the fused sweep; returns ``(max_abs_err by
    row of the kernel table, timing by row)``."""
    import torch

    from sartsolver_tpu_torch.ops.fused_sweep import ONE_READ_MAX_B, _sweep

    alpha, eps = 0.7, 1e-7
    rates = PEAKS["PCIe" if "PCIe" in card else "SXM"]
    checks, errors = [], {}

    def check(P, V, B, logarithmic, with_pen, storage, key=None, plan=None):
        H, w, f, aux, scale = _sweep_inputs(P, V, B, logarithmic, with_pen, storage=storage,
                                            seed=P + V + B + 2 * logarithmic + with_pen)
        kw = dict(logarithmic=logarithmic, alpha=alpha, eps=eps)
        record, err = _check_kernel(H, w, f, aux, scale, kw, storage, plan=plan)
        checks.append(record)
        if key is not None:
            errors[key] = max(errors.get(key, 0.0), err)

    # each storage type through its own plan at the main and a ragged shape
    for storage in STORAGES:
        for P, V, B in ((8192, 65536, 1), (1000, 3001, 3)):
            for logarithmic in (False, True):
                for with_pen in (False, True):
                    check(P, V, B, logarithmic, with_pen, storage,
                          key=storage if P == 8192 else None)
    # every plan at the shapes that select it, and two_read where the new
    # plans took over
    for logarithmic in (False, True):
        check(8192, 65536, 3, logarithmic, True, "float32")
        check(8192, 65536, 1, logarithmic, True, "float32", plan="two_read")
        for B in (8, 16, 19, 32):
            check(8192, 65536, B, logarithmic, True, "int8")
        check(1000, 3008, 19, logarithmic, True, "int8")
    torch.cuda.empty_cache()

    # timing at the main path's shape and mode: B = 1, linear with the
    # Laplacian penalty (the 8-frame runs); fp32's log mode beside it; the
    # new plans in turns with forced two_read
    timing = {}
    for storage, logarithmic, with_pen in (("float32", False, True), ("float32", True, False),
                                           ("bfloat16", False, True), ("int8", False, True)):
        H, w, f, aux, scale = _sweep_inputs(8192, 65536, 1, logarithmic, with_pen, seed=7,
                                            storage=storage)
        kw = dict(logarithmic=logarithmic, alpha=1.0, eps=eps)
        key = storage if not logarithmic else "float32_log"
        if storage == "float32":
            timing[key] = _timing(H, w, f, aux, scale, kw, rates, "one_read",
                                  versus="two_read")
        else:
            timing[key] = _timing(H, w, f, aux, scale, kw, rates, "two_read")
        del H, w, f, aux, scale
        torch.cuda.empty_cache()

    # B4 at the three int8 probes' configuration: checked through
    # tensor_core and forced two_read, then timed in turns
    for k, (name, _, direct) in enumerate(PROBES):
        H, w, f, aux, scale = _probe_inputs(direct, seed=11 + k)
        kw = dict(logarithmic=False)
        record, err = _check_kernel(H, w, f, aux, scale, kw, "int8")
        old, _ = _check_kernel(H, w, f, aux, scale, kw, "int8", plan="two_read")
        checks += [dict(record, probe=name), dict(old, probe=name)]
        timing[name] = dict(_timing(H, w, f, aux, scale, kw, rates, "tensor_core",
                                    versus="two_read"),
                            max_abs_err=err,
                            max_rel_err=dict(tensor_core=record["max_rel_err"],
                                             two_read=old["max_rel_err"]))
        del H, w, f, aux, scale
        torch.cuda.empty_cache()

    def crossover(points, storage, with_pen, new):
        """Forced two_read against ``new`` in turns at each (P, V, B),
        linear."""
        out = []
        for P, V, B in points:
            H, w, f, aux, scale = _sweep_inputs(P, V, B, False, with_pen, seed=20 + B,
                                                storage=storage)

            def run(plan):
                return lambda: _sweep(H, w, f, aux, scale=scale, plan=plan,
                                      logarithmic=False)
            old_ms, new_ms, _ = _in_turns(run("two_read"), run(new))
            out.append({"P": P, "V": V, "B": B, "two_read_ms": old_ms, f"{new}_ms": new_ms})
            del H, w, f, aux, scale
            torch.cuda.empty_cache()
        return out

    # two_read against tensor_core over B, 8192 x 65536 int8, no penalty
    # (the probes' mode); two_read against one_read over P and B, fp32 with
    # the penalty (the main path's mode), at V = 65536 and at small V
    crossovers = dict(
        tensor_core=crossover([(8192, 65536, B) for B in (2, 4, 8, 16, 32)], "int8",
                              False, "tensor_core"),
        one_read=crossover([(P, V, B) for P, V in ONE_READ_CROSSOVER_PV
                            for B in range(1, ONE_READ_MAX_B + 1)],
                           "float32", True, "one_read"))

    from sartsolver_tpu_torch.ops import _build

    clusters = _build.load("fused_sweep").sart_one_read_clusters
    clusters.argtypes, clusters.restype = [ctypes.c_int], ctypes.c_int
    emit("kernels", list=[{"name": "fused_sweep", "status": "ok", "checks": checks,
                              "tolerance": KERNEL_TOL, "timing": timing,
                              "launches_per_iteration": 1}],
         crossover=crossovers, one_read_clusters={B: clusters(B) for B in (1, 3)},
         peak_mem_rate=rates[0], peak_fp32_rate=rates[1],
         peak_bf16_tensor_rate=rates[2],
         library_note="two torch.matmul on an fp32 copy of the dequantized "
                      "matrix: 4 bytes per element for every storage")
    return errors, timing


def batch_phase(world, lap, device="cuda") -> dict:
    """The world's 32 frames at once through the solver API with int8
    storage (B = 32, so the tensor_core plan), then through the plain
    version; returns the phase record."""
    import torch

    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.models.sart import (
        make_problem, prepare_measurement, solve_normalized_batch,
    )
    from sartsolver_tpu_torch.ops.fused_sweep import (
        fused_sweep, fused_sweep_reference, reset_launch_counts,
    )

    opts = SolverOptions(max_iterations=MAX_ITERATIONS, rtm_dtype="int8")
    problem = make_problem(world["H"], lap, opts=opts, device=device)
    G = world["G"]  # [P, T]
    T = G.shape[1]
    gs, msqs, norms = zip(*(prepare_measurement(G[:, t].astype(np.float64), opts)
                            for t in range(T)))
    g = torch.as_tensor(np.stack(gs), device=device).float()
    msq = torch.tensor(msqs, device=device).float()
    f0 = torch.zeros((T, world["H"].shape[1]), device=device)
    H = torch.as_tensor(world["H"], device=device)
    norm = torch.tensor(norms, device=device).float()[:, None]

    def run(fn, run_opts):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve_normalized_batch(problem, g, msq, f0, opts=run_opts, use_guess=True,
                                     device=device, sweep_fn=fn)
        torch.cuda.synchronize()
        return dict(wall_s=time.perf_counter() - t0,
                    by_plan=dict(fused_sweep.launches_by_plan),
                    iters=res.iterations.cpu().numpy(), status=res.status.cpu().numpy(),
                    fitted=H @ (res.solution * norm).T)

    def rel(a, b):
        return ((a - b).norm(dim=0) / b.norm(dim=0)).cpu().numpy()

    k, q = run(fused_sweep, opts), run(fused_sweep_reference, opts)
    by_plan, iters, status = k["by_plan"], k["iters"], k["status"]
    loops = int(iters.max())
    if by_plan["tensor_core"] != loops or sum(by_plan.values()) != loops:
        raise AssertionError(f"batch solve made {by_plan} launches for {loops} loop iterations")
    truth = torch.as_tensor(world["f_true"][:, None] * world["scales"][None, :T],
                            dtype=torch.float32, device=device)
    ref = H @ truth
    for name, r in (("kernel", k), ("plain", q)):
        ok = (r["status"] == 0) | ((r["status"] == -1) & (r["iters"] == MAX_ITERATIONS))
        err = rel(r["fitted"], ref)
        if not ok.all() or not bool(torch.isfinite(r["fitted"]).all()) \
                or not (err <= FIT_BOUND).all():
            raise AssertionError(f"batch {name} solve: statuses {r['status']} iterations "
                                 f"{r['iters']}, fitted-space errors {err} (bound {FIT_BOUND})")
        r["err"] = err
    if (status != q["status"]).any():
        raise AssertionError(f"batch kernel vs plain: statuses {status}/{q['status']}")
    # The stall test stops fp32 solves up to a few iterations apart when
    # their sums are taken in another order, so the kernel is held to the
    # plain version over a fixed count of iterations (no stall test)
    fixed = SolverOptions(max_iterations=BATCH_CROSS_ITERATIONS, rtm_dtype="int8",
                          conv_tolerance=0.0)
    kf, qf = run(fused_sweep, fixed), run(fused_sweep_reference, fixed)
    diff = rel(kf["fitted"], qf["fitted"])
    if (kf["iters"] != qf["iters"]).any() or not (diff <= CROSS_TOL).all():
        raise AssertionError(f"batch kernel vs plain over {BATCH_CROSS_ITERATIONS} "
                             f"iterations: {kf['iters']}/{qf['iters']}, fitted {diff}")
    apart = np.abs(iters.astype(np.int64) - q["iters"].astype(np.int64))
    record = dict(frames=T, storage="int8", loop_iterations=loops,
                  launches_by_plan=by_plan, wall_s=k["wall_s"],
                  ms_per_iteration=k["wall_s"] * 1e3 / loops,
                  iterations=iters.tolist(), status=status.tolist(),
                  fit_err_max=float(k["err"].max()), fit_err_min=float(k["err"].min()),
                  plain=dict(wall_s=q["wall_s"], iterations=q["iters"].tolist(),
                             iterations_apart_max=int(apart.max()),
                             fitted_rel_diff_max=float(rel(k["fitted"], q["fitted"]).max())),
                  fixed_iterations=dict(iterations=BATCH_CROSS_ITERATIONS, tolerance=CROSS_TOL,
                                        fitted_rel_diff_max=float(diff.max())))
    del problem, H
    torch.cuda.empty_cache()
    return record


def profile_solve(problem, g, opts) -> dict:
    """Frame 0 solved once more under ``torch.profiler``: device time by
    kernel against the wall time of the solve, so the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sartsolver_tpu_torch.models.sart import solve

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve(problem, g, opts=opts, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel, spans = {}, []
    for e in events:
        spans.append((e.time_range.start, e.time_range.end))
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_us, end = 0.0, None  # union of the device intervals
    for start, stop in sorted(spans):
        if end is None or start > end:
            busy_us += stop - start
            end = stop
        elif stop > end:
            busy_us += stop - end
            end = stop
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    busy_ms = busy_us / 1e3
    return dict(iterations=int(res.iterations), wall_ms=wall_ms, device_events=len(events),
                device_busy_ms=busy_ms,
                idle_share=(1.0 - busy_ms / wall_ms) if events else None,
                top_device_ms={k[:90]: v for k, v in top})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available.", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import sartsolver_tpu_torch

    if os.path.dirname(os.path.abspath(sartsolver_tpu_torch.__file__)) != \
            os.path.join(REPO, "sartsolver_tpu_torch"):
        print("chip_smoke: run it from a checkout of the repository.", file=sys.stderr)
        return 1
    from sartsolver_tpu_torch.models.sart import make_problem, solve
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.io.laplacian_io import read_laplacian
    from sartsolver_tpu_torch.ops import _build
    from sartsolver_tpu_torch.ops.fused_sweep import (
        fused_sweep, fused_sweep_reference, plan_sweep, reset_launch_counts,
    )
    from sartsolver_tpu_torch.ops.laplacian import make_laplacian

    t_start = time.perf_counter()
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi,
         device=card, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources=sorted(p.name for p in _build.CSRC.glob("*.cu")),
         into=os.path.relpath(_build.BUILD_DIR, REPO))

    errors, timing = kernel_phase(card)

    scratch = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        world = write_world(tmp)
        p = world["paths"]
        inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
        world_s = time.perf_counter() - t0

        # the main path, once per storage type: counts zeroed just before,
        # read just after
        cap = str(MAX_ITERATIONS)
        H_dev = torch.as_tensor(world["H"], device="cuda")
        runs, values = {}, {}
        reset_launch_counts()
        for storage in STORAGES:
            for name, flags, n_frames in (
                ("linear", ["-l", p["laplacian"], "-t", "0:0.75"], 8),
                ("log", ["-L", "-t", "0:0.35"], 4),
            ):
                out = os.path.join(tmp, f"solution_{storage}_{name}.h5")
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                rc, ms = run_cli(["-o", out, *inputs, "-m", cap, *flags,
                                  "--rtm_dtype", storage])
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() - base
                if rc != 0 or len(ms) != n_frames:
                    raise AssertionError(f"{storage} {name} run: exit {rc}, {len(ms)} frames")
                sol, err = check_solution(out, world, n_frames, MAX_ITERATIONS, "cuda")
                values[storage, name] = sol["value"]
                fp32 = values["float32", name]
                fit = H_dev @ torch.as_tensor(sol["value"].T, dtype=torch.float32,
                                              device="cuda")
                ref = H_dev @ torch.as_tensor(fp32.T, dtype=torch.float32, device="cuda")
                to_fp32 = ((fit - ref).norm(dim=0) / ref.norm(dim=0)).cpu().numpy()
                runs[f"{storage}_{name}"] = dict(
                    storage=storage, frames=n_frames, exit=rc, wall_s=wall, frame_ms=ms,
                    iterations=sol["iterations"].tolist(), status=sol["status"].tolist(),
                    fit_err=err.tolist(), fitted_distance_to_float32=to_fp32.tolist(),
                    peak_device_bytes=peak)
        launches = fused_sweep.launches
        by_storage = dict(fused_sweep.launches_by_storage)
        by_plan = dict(fused_sweep.launches_by_plan)
        iters = {st: sum(sum(r["iterations"]) for r in runs.values() if r["storage"] == st)
                 for st in STORAGES}
        # one launch per iteration: fp32 through its planned kernel, bf16
        # and int8 (B = 1) through two_read
        want_plan = {plan: 0 for plan in by_plan}
        for st in STORAGES:
            want_plan[plan_sweep(8192, 65536, 1, st)] += iters[st]
        if launches != sum(iters.values()) or by_plan != want_plan or any(
                by_storage[st] <= 0 or by_storage[st] != iters[st] for st in STORAGES):
            raise AssertionError(f"main path made {by_storage} / {by_plan} kernel launches "
                                 f"for {iters} iterations")
        emit("solve", world_seconds=world_s, max_iterations=MAX_ITERATIONS,
             fit_bound=FIT_BOUND, fused_sweep_launches=launches,
             launches_by_storage=by_storage, launches_by_plan=by_plan,
             iterations_by_storage=iters, runs=runs)
        del H_dev

        V = world["H"].shape[1]
        rows, cols, vals = read_laplacian(p["laplacian"], V)
        lap = make_laplacian(rows, cols, vals, nvoxel=V, device="cuda")
        batch = batch_phase(world, lap)
        emit("batch", **batch)

        # frame 0 of the linear run, through the kernel and the plain version
        opts = SolverOptions(max_iterations=MAX_ITERATIONS)
        problem = make_problem(world["H"], lap, opts=opts, device="cuda")
        g0 = world["G"][:, 0].astype(np.float64)
        cross = {}
        for name, fn in (("kernel", fused_sweep), ("plain", fused_sweep_reference)):
            t0 = time.perf_counter()
            res = solve(problem, g0, opts=opts, device="cuda", sweep_fn=fn)
            fitted = problem.rtm @ res.solution
            torch.cuda.synchronize()
            cross[name] = dict(status=int(res.status), iterations=int(res.iterations),
                               seconds=time.perf_counter() - t0, fitted=fitted)
        k, q = cross["kernel"], cross["plain"]
        diff = float((k["fitted"] - q["fitted"]).norm() / q["fitted"].norm())
        if (k["status"] != q["status"] or abs(k["iterations"] - q["iterations"]) > 1
                or diff > CROSS_TOL):
            raise AssertionError(f"kernel vs plain on frame 0: {k['status']}/{q['status']}, "
                                 f"{k['iterations']}/{q['iterations']}, fitted {diff}")
        emit("plain_crosscheck", tolerance=CROSS_TOL, fitted_rel_diff=diff,
             **{n: {kk: v for kk, v in c.items() if kk != "fitted"} for n, c in cross.items()})
        profiles = {"float32": profile_solve(problem, g0, opts)}
        del problem
        for storage in STORAGES[1:]:
            st_opts = SolverOptions(max_iterations=MAX_ITERATIONS, rtm_dtype=storage)
            st_problem = make_problem(world["H"], lap, opts=st_opts, device="cuda")
            profiles[storage] = profile_solve(st_problem, g0, st_opts)
            del st_problem
        emit("profile", **profiles)
        del lap, world

    def row(name, t, launches, err, variant, replaces=REPLACES):
        r = {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": t["library_ms"], "plan": t["plan"],
             "cuda_kernels_per_launch": t["device"]["kernels_per_call"],
             "bound_rate": t["bound_rate"], "variant": variant, "shape": t["shape"]}
        if "versus" in t:
            r["two_read_ms"] = t["versus"]["ms"]
            r["two_read_bound_ms"] = t["versus"]["bound_ms"]
        return r

    rows = [row("fused_sweep", timing["float32"], by_plan[timing["float32"]["plan"]],
                errors["float32"], "B1/B2")]
    for storage in STORAGES[1:]:
        rows.append(row(f"fused_sweep[{storage}]", timing[storage], by_storage[storage],
                        errors[storage], VARIANT[storage]))
    for name, replaces, _ in PROBES:
        rows.append(row(name, timing[name], batch["launches_by_plan"]["tensor_core"],
                        timing[name]["max_abs_err"], "B4 at the probe's B = 32", replaces))
    print(json.dumps({"kernels": rows}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
