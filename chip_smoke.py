#!/usr/bin/env python3
"""Drive sartsolver_tpu_torch on one CUDA card and check what comes out.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the checkout itself (it imports the package beside
it), and exits non-zero without them. Phases, each printing one JSON line:

1. ``env``: torch and CUDA versions, the card's name and power limit.
2. ``build``: every ``csrc/*.cu`` of the package built with ``nvcc``, in
   parallel, into ``build/sartsolver_tpu_torch/``.
3. ``kernels``: the fused-sweep kernel against its plain PyTorch version on
   the card, linear and log, with and without the penalty, at the main
   path's shape (B = 1, 8192 x 65536) and at a ragged one (B = 3,
   1000 x 3001): max error within ``KERNEL_TOL`` of the output's max, two
   launches byte-identical, the launch count advanced; then the kernel's,
   the plain version's and the library calls' times at the main path's
   shape beside its bound.
4. ``solve``: the realistic-scale world of ``benchmarks/e2e_world.py``
   (2 cameras of 64 x 64, a 256 x 256 x 1 grid, a 2 GiB fp32 RTM, 32
   frames, 1% noise, a chain Laplacian) written to HDF5 by this script's own
   numpy code and the package's HDF5 writer, then the port's ``sartsolve`` run in-process on the
   card: linear with the Laplacian over 8 frames, logarithmic over 4. Launch
   counts are zeroed just before and read just after; every frame's status
   must be 0 or the ``-m`` cap, and its fitted-space error against the
   noiseless measurement within ``FIT_BOUND``.
5. ``plain_crosscheck``: frame 0 solved through the kernel and through the
   plain version (the solver core's ``sweep_fn``): equal statuses,
   iteration counts at most 1 apart, fitted-space agreement within
   ``CROSS_TOL``.
6. ``profile``: frame 0 once more under ``torch.profiler``: device time by
   kernel, the solve's wall time and the device's idle share.

Then the kernel table as one JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
# kernel against plain version in fitted space, frame 0 of the main path
CROSS_TOL = 1e-3
MAX_ITERATIONS = 500  # -m cap of the main path's runs

# card -> (memory rate in B/s, fp32 rate outside the tensor cores in FLOP/s);
# NVIDIA's data sheets, dense rates at the full power limit
PEAKS = {"PCIe": (2.0e12, 51e12), "SXM": (3.35e12, 67e12)}


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

def _sweep_inputs(P, V, B, logarithmic, with_pen, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, generator=g, device="cuda") * (hi - lo) + lo

    H = rand(P, V)
    w = rand(B, P, lo=0.0 if logarithmic else -0.5) / P
    f = rand(B, V, lo=0.1, hi=2.0)
    if logarithmic:  # obs is zero where the voxel mask is, as make_obs leaves it
        vm = (rand(1, V) > 0.1).float()
        aux = [vm, rand(B, V, lo=0.1) * vm]
    else:
        aux = [rand(1, V, hi=2.0)]
    if with_pen:
        aux.append(rand(B, V, lo=-0.01, hi=0.01))
    return H, w, f, aux


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


def kernel_phase(card: str):
    import torch

    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, fused_sweep_reference

    alpha, eps = 0.7, 1e-7
    checks = []
    main_err = 0.0
    for P, V, B in ((8192, 65536, 1), (1000, 3001, 3)):
        for logarithmic in (False, True):
            for with_pen in (False, True):
                H, w, f, aux = _sweep_inputs(P, V, B, logarithmic, with_pen,
                                             seed=P + V + B + 2 * logarithmic + with_pen)
                kw = dict(logarithmic=logarithmic, alpha=alpha, eps=eps)
                before = fused_sweep.launches
                out1 = fused_sweep(H, w, f, aux, **kw)
                out2 = fused_sweep(H, w, f, aux, **kw)
                ref = fused_sweep_reference(H, w, f, aux, **kw)
                torch.cuda.synchronize()
                counted = fused_sweep.launches - before
                identical = all(torch.equal(a, b) for a, b in zip(out1, out2))
                abs_err = max(float((a - r).abs().max()) for a, r in zip(out1, ref))
                rel = max(float((a - r).abs().max()) / float(r.abs().max())
                          for a, r in zip(out1, ref))
                finite = all(bool(torch.isfinite(r).all()) for r in ref)
                passed = identical and counted == 2 and finite and rel <= KERNEL_TOL
                checks.append(dict(shape=[P, V, B], mode="log" if logarithmic else "linear",
                                   pen=with_pen, max_rel_err=rel, max_abs_err=abs_err,
                                   byte_identical=identical, launches_counted=counted,
                                   ok=passed))
                if not passed:
                    raise AssertionError(f"fused_sweep check failed: {checks[-1]}")
                if P == 8192:
                    main_err = max(main_err, abs_err)
                del H, w, f, aux, out1, out2, ref

    # timing at the main path's shape and mode: B = 1, linear with the
    # Laplacian penalty (the 8-frame run); the log mode beside it
    P, V, B = 8192, 65536, 1
    mem_rate, fp32_rate = PEAKS["PCIe" if "PCIe" in card else "SXM"]
    timing = {}
    for logarithmic, with_pen in ((False, True), (True, False)):
        H, w, f, aux = _sweep_inputs(P, V, B, logarithmic, with_pen, seed=7)
        kw = dict(logarithmic=logarithmic, alpha=1.0, eps=eps)

        def library():
            bp = torch.matmul(w, H)
            if logarithmic:
                f_new = f * ((aux[1] + eps) / (bp * aux[0] + eps))
            else:
                f_new = torch.clamp_min(f + aux[0] * bp - aux[1], 0)
            return torch.matmul(f_new, H.T)

        nbytes = 4 * (P * V + B * P + B * V + sum(a.numel() for a in aux) + B * V + B * P)
        flops = 4 * B * P * V
        bytes_ms, ops_ms = nbytes / mem_rate * 1e3, flops / fp32_rate * 1e3
        timing["log" if logarithmic else "linear"] = dict(
            ms=_median_ms(lambda: fused_sweep(H, w, f, aux, **kw)),
            plain_ms=_median_ms(lambda: fused_sweep_reference(H, w, f, aux, **kw)),
            library_ms=_median_ms(library),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, flops=flops,
        )
        del H, w, f, aux
    torch.cuda.empty_cache()
    emit("kernels", list=[{"name": "fused_sweep", "status": "ok", "checks": checks,
                              "tolerance": KERNEL_TOL, "timing_b1": timing,
                              "launches_per_iteration": 1,
                              "cuda_kernels_per_launch": 2}],
         peak_mem_rate=mem_rate, peak_fp32_rate=fp32_rate)
    return main_err, timing


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
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, fused_sweep_reference
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

    main_err, timing = kernel_phase(card)

    scratch = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        world = write_world(tmp)
        p = world["paths"]
        inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
        world_s = time.perf_counter() - t0

        # the main path: counts zeroed just before, read just after
        cap = str(MAX_ITERATIONS)
        fused_sweep.launches = 0
        runs = {}
        for name, flags, n_frames in (
            ("linear", ["-l", p["laplacian"], "-t", "0:0.75"], 8),
            ("log", ["-L", "-t", "0:0.35"], 4),
        ):
            out = os.path.join(tmp, f"solution_{name}.h5")
            t0 = time.perf_counter()
            rc, ms = run_cli(["-o", out, *inputs, "-m", cap, *flags])
            wall = time.perf_counter() - t0
            if rc != 0 or len(ms) != n_frames:
                raise AssertionError(f"{name} run: exit {rc}, {len(ms)} frames")
            sol, err = check_solution(out, world, n_frames, MAX_ITERATIONS, "cuda")
            runs[name] = dict(frames=n_frames, exit=rc, wall_s=wall, frame_ms=ms,
                              iterations=sol["iterations"].tolist(),
                              status=sol["status"].tolist(), fit_err=err.tolist())
        launches = fused_sweep.launches
        total_iters = sum(sum(r["iterations"]) for r in runs.values())
        if launches <= 0 or launches != total_iters:
            raise AssertionError(f"main path made {launches} kernel launches for "
                                 f"{total_iters} iterations")
        emit("solve", world_seconds=world_s, max_iterations=MAX_ITERATIONS,
             fit_bound=FIT_BOUND, fused_sweep_launches=launches, runs=runs)

        # frame 0 of the linear run, through the kernel and the plain version
        opts = SolverOptions(max_iterations=MAX_ITERATIONS)
        V = world["H"].shape[1]
        rows, cols, vals = read_laplacian(p["laplacian"], V)
        lap = make_laplacian(rows, cols, vals, nvoxel=V, device="cuda")
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
        emit("profile", **profile_solve(problem, g0, opts))
        del problem, lap, world

    lin = timing["linear"]
    print(json.dumps({"kernels": [{
        "name": "fused_sweep", "route": "cuda",
        "source": "sartsolver_tpu_torch/ops/csrc/fused_sweep.cu",
        "replaces": "sartsolver_tpu/ops/fused_sweep.py:829",
        "launches": launches, "max_abs_err": main_err,
        "ms": lin["ms"], "plain_ms": lin["plain_ms"], "bound_ms": lin["bound_ms"],
        "bound_by": lin["bound_by"], "library_ms": lin["library_ms"],
    }]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
