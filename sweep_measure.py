#!/usr/bin/env python3
"""Measurements of the fused sweep on one CUDA card that ``chip_smoke.py``
does not repeat on every run. Run from the root of a checkout:

``python3 sweep_measure.py ab OTHER``
    The fused sweep of this checkout against that of another checkout of
    the repository (for example the parent commit, unpacked with ``git
    archive``), at 8192 x 65536, B = 1, 4, 8, 16 and 32 (the CLI's frame,
    the int8 four-lane loop, the batch loops), and at ``chip_smoke.py``'s
    tall two_read rows (P past 8192: the tall world's shape, a tall and
    narrow matrix, the capacity demo's bf16 and int8 shapes), linear with
    the penalty (the CLI's main mode), for each storage type, with
    ``chip_smoke.py``'s timing inputs: through each checkout's own plan for
    the shape, and through forced ``two_read`` where the checkout can force
    a plan. Timed in turns,
    other, this, this, other, each turn a process of its own that imports
    its checkout's package: ms per call (CUDA events around the wrapper's
    call, so the host's work in the wrapper is counted) and device ms per
    call by CUDA kernel (``torch.profiler``).

``python3 sweep_measure.py split_ab OTHER``
    The pixel-sharded sweep's pair (``sharded_sweep_bp``,
    ``sharded_sweep_finish``) of this checkout against that of another
    checkout, at the 2x1 grid's block of ``chip_smoke.py``'s e2e world
    (4096 x 65536), B = 1 and 4, linear with the penalty, for each storage
    type, with ``chip_smoke.py``'s split inputs (the finish takes the plain
    reduced bp). Timed in turns, other, this, this, other, each turn a
    process of its own that imports its checkout's package: ms per call
    (CUDA events around the wrapper's call) and device ms per call by CUDA
    kernel (``torch.profiler``), and the host's microseconds a call (100
    calls queued without a wait); every turn's outputs held against the
    first turn's bit for bit (both checkouts sum in two_read's order).

``python3 sweep_measure.py split_variants``
    The split pair's cluster route built as shipped and with the
    measurement macros of ``csrc/fused_sweep.cu`` (``SART_SPLIT_BP_LANES``,
    the bp kernel's lanes a row group; ``SART_SPLIT_BP_STAGES``;
    ``SART_SPLIT_FWD_ROW_BYTES``, ``SART_SPLIT_FWD_STAGES``) into
    ``build/sweep_measure/`` (the other parts built once), each checked bit
    for bit against the shipped build and timed in turns with it at the 2x1
    block, B = 1, per storage: ms per call and device ms per call.

``python3 sweep_measure.py promotion``
    The ``tensor_core`` plan's error against the plain version at the three
    int8 probes' configuration (``chip_smoke.py``'s probe inputs), built as
    shipped and built with ``SART_TC_NO_PROMOTE`` (the tensor cores'
    accumulation chain left unpromoted) into ``build/sweep_measure/``.

``python3 sweep_measure.py sass``
    For each ``one_read`` kernel instance in the built library
    (``cuobjdump``): its registers and spills, and its count of each
    conversion, shared-memory and arithmetic instruction class of the SASS
    (``I2F*`` is the conversion unit the int8 path avoids).

``python3 sweep_measure.py threads``
    ``one_read`` for fp32 from B = 5 built as shipped (512 threads a CTA)
    and with ``SART_ONE_READ_FP32_WIDE_THREADS=256`` into
    ``build/sweep_measure/``, timed in turns (256, shipped, shipped, 256) at
    8192 x 65536, B = 5 and 8, linear with the penalty, each checked against
    the plain version.

``python3 sweep_measure.py phases``
    The ``one_read`` kernel built with ``SART_ONE_READ_PHASES`` into
    ``build/sweep_measure/``, run at 8192 x 65536, B = 1 and 4 (fp32 also
    8), linear with the penalty, for each storage type (``chip_smoke.py``'s timing inputs):
    per panel, the mean time thread 0 of a CTA spends in each phase of the
    panel loop (waiting for its slab, the bp pass, summing and pushing the
    CTA's partial, issuing the next slab's copies, waiting for the other
    ranks' partials, the update, the fitted pass), beside the shipped
    build's ms per call.

``python3 sweep_measure.py lds``
    Cycles a warp spends in one shared-memory load, for the access patterns
    the sweep kernels use: a 16-byte load that every lane reads at one
    address, 8 lanes of each quarter-warp at 8 neighbouring addresses (each
    quarter the same 8), 32 lanes at 32, each quarter-warp at one address,
    and a 4-byte load at 8 addresses (a small CUDA program written into
    ``build/sweep_measure/`` and built there).

``python3 sweep_measure.py accuracy``
    ``two_read`` and the plain version each against an fp64 product on a
    subset (64 pixel rows of fitted), at ``chip_smoke.py``'s tall rows
    (``TWO_READ_ROWS`` past P = 8192), linear with the penalty: fitted from
    each one's own f_new, so the error of the forward product alone; beside
    them the same product as one ``torch.matmul`` over all of V.

``python3 sweep_measure.py implicit_ab OTHER``
    The implicit projector (``implicit_forward``, ``implicit_back``) of
    this checkout against that of another checkout, on ``chip_smoke.py``'s
    geometry world (8192 rays x 65,536 voxels) and its wide world
    (``IMPLICIT_WIDE``, 131,072 x 1,048,576), B = 1 and 8, fp32: timed in
    turns, other, this, this, other, each turn a process of its own that
    imports its checkout's package (ms per call, CUDA events around the
    entry point), each turn's outputs held against the first turn's within
    ``chip_smoke.KERNEL_TOL``; then this checkout's ``-Xptxas -v`` report
    of ``ops/csrc/implicit.cu`` (registers, spills, shared memory).

``python3 sweep_measure.py implicit_cull``
    Where the implicit back projection's time goes, on both worlds of
    ``implicit_ab`` at B = 1 and 8: the shipped build against one built with
    ``SART_IMPLICIT_CULL_ONLY`` into ``build/sweep_measure/`` (the cull and
    the survivors' staging, no evaluation), timed in turns (cull only,
    shipped, shipped, cull only), and the shipped call's device ms by CUDA
    kernel (``ray_boxes_kernel`` and ``back_kernel``).

Each prints one JSON line per measurement, and the card's name and power
limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
REPS = 50
STORAGES = ("float32", "bfloat16", "int8")
AB_BATCHES = (1, 4, 8, 16, 32)
SPLIT_SHAPE = (4096, 65536)  # the 2x1 grid's block of the e2e world
SPLIT_BATCHES = (1, 4)
TALL_REPS = 20


def _turn(root: str) -> dict:
    """One turn of ``ab`` in this process: ``root``'s package, each storage
    type's ms and device ms by kernel."""
    import torch

    import chip_smoke  # this checkout's helpers: the script's directory leads sys.path

    sys.path.insert(0, root)  # ahead of it, so the package is root's
    from sartsolver_tpu_torch.ops import fused_sweep as mod

    if not os.path.abspath(mod.__file__).startswith(os.path.join(root, "")):
        raise SystemExit(f"sweep_measure: imported {mod.__file__}, not from {root}")
    out = {}
    cases = ([(storage, 8192, 65536, B) for storage in STORAGES for B in AB_BATCHES]
             + [row for row in chip_smoke.TWO_READ_ROWS if row[1] > 8192])
    for storage, P, V, B in cases:
        H, w, f, aux, scale = chip_smoke._sweep_inputs(P, V, B, False, True,
                                                       seed=7, storage=storage)
        calls = {"own_plan": lambda: mod.fused_sweep(H, w, f, aux, scale=scale,
                                                     logarithmic=False)}
        if hasattr(mod, "_sweep"):
            calls["two_read"] = lambda: mod._sweep(H, w, f, aux, scale=scale,
                                                   logarithmic=False, plan="two_read")
        reps = REPS if P <= 8192 else TALL_REPS
        rec = {name: dict(ms=chip_smoke._median_ms(call, reps=reps),
                          device=chip_smoke._device_profile(call, calls=5))
               for name, call in calls.items()}
        rec["own_plan"]["plan"] = (mod.plan_sweep(P, V, B, storage)
                                   if hasattr(mod, "plan_sweep") else "two_read")
        out[f"{storage}@B{B}" if P == 8192 else f"{storage}@{P}x{V}xB{B}"] = rec
        del H, w, f, aux, scale, calls
        torch.cuda.empty_cache()
    return out


def _split_turn(root: str, out_dir: str) -> dict:
    """One turn of ``split_ab`` in this process: ``root``'s split pair at
    the 2x1 block per storage and B, ms and device ms by kernel; the
    outputs saved under ``out_dir``."""
    import torch

    import chip_smoke

    sys.path.insert(0, root)
    from sartsolver_tpu_torch.ops import fused_sweep as mod

    if not os.path.abspath(mod.__file__).startswith(os.path.join(root, "")):
        raise SystemExit(f"sweep_measure: imported {mod.__file__}, not from {root}")
    P, V = SPLIT_SHAPE
    out = {}
    for storage in STORAGES:
        for B in SPLIT_BATCHES:
            H, w, f, aux, scale, bp_ref = chip_smoke._split_inputs(P, V, B, False, seed=7,
                                                                   storage=storage)
            kw = dict(logarithmic=False, alpha=0.7, eps=1e-7, scale=scale)
            calls = {"bp": lambda: mod.sharded_sweep_bp(H, w),
                     "finish": lambda: mod.sharded_sweep_finish(H, f, bp_ref, aux, **kw)}
            key = f"{storage}@B{B}"
            torch.save([calls["bp"]().cpu(), *[t.cpu() for t in calls["finish"]()]],
                       os.path.join(out_dir, f"{key}.pt"))
            out[key] = {name: dict(ms=chip_smoke._median_ms(call, reps=REPS),
                                   device=chip_smoke._device_profile(call, calls=5),
                                   host_us=_host_us(call))
                        for name, call in calls.items()}
            if hasattr(mod, "split_route"):
                out[key]["route"] = mod.split_route(P, V, B, storage)
            del H, w, f, aux, scale, bp_ref, calls
            torch.cuda.empty_cache()
    return out


SPLIT_VARIANTS = {
    "bp_lanes64": ["-DSART_SPLIT_BP_LANES=64"], "bp_lanes32": ["-DSART_SPLIT_BP_LANES=32"],
    "bp_stages4": ["-DSART_SPLIT_BP_STAGES=4"],
    "fwd_rows512_st2": ["-DSART_SPLIT_FWD_ROW_BYTES=512", "-DSART_SPLIT_FWD_STAGES=2"],
    "fwd_rows256_st4": ["-DSART_SPLIT_FWD_ROW_BYTES=256", "-DSART_SPLIT_FWD_STAGES=4"],
    "fwd_stages3": ["-DSART_SPLIT_FWD_STAGES=3"],
}


def _variant_libs(out_dir: str, variants: dict) -> dict:
    """``fused_sweep.cu`` linked once per variant: parts 1-5 as shipped,
    part 6 (the cluster route) with the variant's flags; all at once."""
    from sartsolver_tpu_torch.ops import _build

    src = str(_build.CSRC / "fused_sweep.cu")
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    jobs = {f"part{k}": [f"-DSART_PART={k}"] for k in range(1, 6)}
    jobs.update({f"p6_{name}": ["-DSART_PART=6", *extra] for name, extra in variants.items()})
    procs = {name: subprocess.Popen([_build.nvcc_path(), *flags, *extra, "-c", "-o",
                                     os.path.join(out_dir, f"{name}.o"), src])
             for name, extra in jobs.items()}
    if any(p.wait() != 0 for p in procs.values()):
        raise SystemExit("sweep_measure: a variant build failed")
    libs = {}
    for name in variants:
        path = os.path.join(out_dir, f"libfused_sweep-{name}.so")
        objs = [os.path.join(out_dir, f"part{k}.o") for k in range(1, 6)]
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", path, *objs,
                        os.path.join(out_dir, f"p6_{name}.o")], check=True)
        libs[name] = ctypes.CDLL(path)
    return libs


def split_variants() -> None:
    import torch

    import chip_smoke
    from sartsolver_tpu_torch.ops import _build
    from sartsolver_tpu_torch.ops import fused_sweep as fs

    out_dir = os.path.join(REPO, "build", "sweep_measure")
    os.makedirs(out_dir, exist_ok=True)
    shipped = _build.load("fused_sweep")
    libs = _variant_libs(out_dir, SPLIT_VARIANTS)
    P, V = SPLIT_SHAPE
    try:
        for storage in STORAGES:
            H, w, f, aux, scale, bp_ref = chip_smoke._split_inputs(P, V, 1, False, seed=7,
                                                                   storage=storage)
            kw = dict(logarithmic=False, alpha=0.7, eps=1e-7, scale=scale)
            calls = {"bp": lambda: fs.sharded_sweep_bp(H, w),
                     "finish": lambda: fs.sharded_sweep_finish(H, f, bp_ref, aux, **kw)}
            want = {name: call() for name, call in calls.items()}
            for name, lib in libs.items():
                which = "bp" if name.startswith("bp") else "finish"

                def timed(lib_):
                    def call():
                        _build._loaded["fused_sweep"] = lib_
                        return calls[which]()
                    return call
                got = timed(lib)()
                same = (torch.equal(got, want[which]) if which == "bp" else
                        all(torch.equal(a, b) for a, b in zip(got, want[which])))
                base_ms, ms, turns = chip_smoke._in_turns(timed(shipped), timed(lib))
                print(json.dumps({"storage": storage, "variant": name, "call": which,
                                  "same_bytes": same, "shipped_ms": base_ms, "ms": ms,
                                  "turns_ms": turns,
                                  "device": chip_smoke._device_profile(timed(lib))}),
                      flush=True)
            _build._loaded["fused_sweep"] = shipped
            del H, w, f, aux, scale, bp_ref, calls, want
            torch.cuda.empty_cache()
    finally:
        _build._loaded["fused_sweep"] = shipped


def _host_us(call, n: int = 100) -> float:
    """Microseconds of host work a call: ``n`` calls queued back to back
    (the card runs behind them), timed on the host clock to the last
    return."""
    import time

    import torch

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def split_ab(other: str) -> None:
    import tempfile

    import torch

    other = os.path.abspath(other)
    builds = [_build_in(other, "fused_sweep"), _build_in(REPO, "fused_sweep")]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("sweep_measure: a build failed")
    turns = []
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        for k, (name, root) in enumerate((("other", other), ("this", REPO), ("this", REPO),
                                          ("other", other))):
            out_dir = os.path.join(tmp, str(k))
            os.makedirs(out_dir)
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "_split_turn",
                                  root, out_dir], capture_output=True, text=True, check=True)
            turns.append((name, json.loads(res.stdout.strip().splitlines()[-1])))
            print(json.dumps({"turn": name, "root": root, **turns[-1][1]}), flush=True)
            for key in turns[0][1]:
                a = torch.load(os.path.join(tmp, "0", f"{key}.pt"))
                b = torch.load(os.path.join(out_dir, f"{key}.pt"))
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    raise SystemExit(f"sweep_measure: {key}: turn {k}'s bytes differ")
    summary = {}
    for key in turns[0][1]:
        for call in ("bp", "finish"):
            row = {n: statistics.mean(t[key][call]["ms"] for m, t in turns if m == n)
                   for n in ("other", "this")}
            row["this_over_other"] = row["this"] / row["other"]
            row["kernels_per_call"] = {n: t[key][call]["device"]["kernels_per_call"]
                                       for n, t in turns[:2]}
            row["host_us"] = {n: statistics.mean(t[key][call]["host_us"] for m, t in turns
                                                 if m == n) for n in ("other", "this")}
            row["route"] = turns[1][1][key].get("route")
            summary[f"{key}_{call}"] = row
    print(json.dumps({"split_ab_ms": summary}), flush=True)


def _build_in(root: str, name: str = "") -> subprocess.Popen:
    """Build ``root``'s CUDA sources (only ``csrc/<name>.cu`` if given)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from sartsolver_tpu_torch.ops import _build; "
            + (f"_build.load({name!r})" if name else "_build.build_all()"))
    return subprocess.Popen([sys.executable, "-c", code, root])


def ab(other: str) -> None:
    other = os.path.abspath(other)
    builds = [_build_in(other), _build_in(REPO)]  # both at once
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("sweep_measure: a build failed")
    turns = []
    for name, root in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "_turn", root],
                             capture_output=True, text=True, check=True)
        turns.append((name, json.loads(res.stdout.strip().splitlines()[-1])))
        print(json.dumps({"turn": name, "root": root, **turns[-1][1]}), flush=True)
    summary = {}
    for case in turns[0][1]:
        for call in ("own_plan", "two_read"):
            ms = {n: [t[case][call]["ms"] for m, t in turns
                      if m == n and call in t[case]] for n in ("other", "this")}
            if not all(ms.values()):
                continue
            row = {n: sum(v) / len(v) for n, v in ms.items()}
            row["this_over_other"] = row["this"] / row["other"]
            row["plans"] = {n: t[case][call].get("plan", call) for n, t in turns}
            summary[f"{case}_{call}"] = row
    print(json.dumps({"ab_ms": summary}), flush=True)


def promotion() -> None:
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke
    from sartsolver_tpu_torch.ops import _build

    out_dir = os.path.join(REPO, "build", "sweep_measure")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libfused_sweep-no-promote.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DSART_TC_NO_PROMOTE", "-o", path,
                    str(_build.CSRC / "fused_sweep.cu")], check=True)
    shipped = _build.load("fused_sweep")
    try:
        for build, lib in (("shipped", shipped), ("no_promote", ctypes.CDLL(path))):
            _build._loaded["fused_sweep"] = lib
            for k, (name, _, direct) in enumerate(chip_smoke.PROBES):
                H, w, f, aux, scale = chip_smoke._probe_inputs(direct, seed=11 + k)
                record, _ = chip_smoke._check_kernel(H, w, f, aux, scale,
                                                     dict(logarithmic=False), "int8",
                                                     plan="tensor_core", enforce=False)
                print(json.dumps({"build": build, "probe": name, **record}), flush=True)
                del H, w, f, aux, scale
                torch.cuda.empty_cache()
    finally:
        _build._loaded["fused_sweep"] = shipped


def threads() -> None:
    import torch

    import chip_smoke
    from sartsolver_tpu_torch.ops import _build
    from sartsolver_tpu_torch.ops.fused_sweep import _sweep

    out_dir = os.path.join(REPO, "build", "sweep_measure")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libfused_sweep-fp32-256.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                    "-DSART_ONE_READ_FP32_WIDE_THREADS=256", "-o", path,
                    str(_build.CSRC / "fused_sweep.cu")], check=True)
    libs = {"512": _build.load("fused_sweep"), "256": ctypes.CDLL(path)}
    try:
        for B in (5, 8):
            H, w, f, aux, scale = chip_smoke._sweep_inputs(8192, 65536, B, False, True, seed=7)
            kw = dict(logarithmic=False)
            rec = {"B": B}
            for name, lib in libs.items():
                _build._loaded["fused_sweep"] = lib
                record, _ = chip_smoke._check_kernel(H, w, f, aux, scale, kw, "float32",
                                                     plan="one_read", enforce=False)
                rec[f"check_{name}"] = record

            def timed(name):
                def call():
                    _build._loaded["fused_sweep"] = libs[name]
                    return _sweep(H, w, f, aux, scale=scale, plan="one_read", **kw)
                return call
            rec["ms_256"], rec["ms_512"], rec["turns_ms"] = chip_smoke._in_turns(
                timed("256"), timed("512"))
            print(json.dumps(rec), flush=True)
            del H, w, f, aux, scale
            torch.cuda.empty_cache()
    finally:
        _build._loaded["fused_sweep"] = libs["512"]


PHASES = ("wait", "bp", "push", "issue", "gather", "update", "fitted")
PANEL_BYTES = 64  # one_read's row segment


def phases() -> None:
    import torch

    import chip_smoke
    from sartsolver_tpu_torch.ops import _build
    from sartsolver_tpu_torch.ops.fused_sweep import STORAGE, _sweep

    out_dir = os.path.join(REPO, "build", "sweep_measure")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libfused_sweep-phases.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DSART_ONE_READ_PHASES", "-o",
                    path, str(_build.CSRC / "fused_sweep.cu")], check=True)
    shipped, measured = _build.load("fused_sweep"), ctypes.CDLL(path)
    read = measured.sart_one_read_phases
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    clusters = shipped.sart_one_read_clusters
    clusters.argtypes, clusters.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    P, V = 8192, 65536
    try:
        for storage in STORAGES:
            for B in (1, 4, 8) if storage == "float32" else (1, 4):
                H, w, f, aux, scale = chip_smoke._sweep_inputs(P, V, B, False, True, seed=7,
                                                               storage=storage)

                def call():
                    return _sweep(H, w, f, aux, scale=scale, logarithmic=False,
                                  plan="one_read")
                _build._loaded["fused_sweep"] = shipped
                shipped_ms = chip_smoke._median_ms(call)
                _build._loaded["fused_sweep"] = measured
                measured_ms = chip_smoke._median_ms(call)
                call()
                torch.cuda.synchronize()
                width = len(PHASES) + 2
                buf = (ctypes.c_ulonglong * (16 * 8 * width))()
                if read(buf) != width:
                    raise SystemExit("sweep_measure: no phase counters in the build")
                G = clusters(STORAGE[H.dtype], B)
                n_panels = V // (PANEL_BYTES // H.element_size())
                per_panel = {k: [] for k in PHASES}
                ghz = []
                for cta in range(G * 8):
                    row = buf[cta * width:(cta + 1) * width]
                    mine = -(-(n_panels - cta // 8) // G)
                    rate = row[-2] / row[-1]  # cycles per ns
                    ghz.append(rate)
                    for k, name in enumerate(PHASES):
                        per_panel[name].append(row[k] / rate / mine)
                print(json.dumps({
                    "storage": storage, "B": B, "shipped_ms": shipped_ms,
                    "measured_build_ms": measured_ms, "clusters": G,
                    "panels_per_cluster": -(-n_panels // G), "clock_ghz": statistics.mean(ghz),
                    "ns_per_panel": {k: statistics.mean(v) for k, v in per_panel.items()},
                    "ns_per_panel_max_cta": {k: max(v) for k, v in per_panel.items()},
                }), flush=True)
                del H, w, f, aux, scale
                torch.cuda.empty_cache()
    finally:
        _build._loaded["fused_sweep"] = shipped


LDS_SOURCE = r"""
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>
// every warp loops over shared loads of one pattern; the last two numbers
// printed are SM cycles per warp-load, from the kernel's time at the clock
template <int MODE>
__global__ void lds(float* out, int iters) {
  __shared__ __align__(16) float s[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) s[i] = i * 0.001f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int off = MODE == 0 ? 0 : MODE == 1 ? (lane & 7) * 4 : MODE == 2 ? lane * 4
                : MODE == 3 ? (lane >> 3) * 4 : (lane & 7);
  float4 a = make_float4(0, 0, 0, 0);
  float b = 0;
  for (int i = 0; i < iters; ++i) {
    const int o = (off + (i & 7) * 128) & 4095;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (MODE < 4) {
        const float4 q = *reinterpret_cast<const float4*>(s + ((o + u * 128) & 4095));
        a.x += q.x; a.y += q.y; a.z += q.z; a.w += q.w;
      } else {
        b += s[(o + u * 128) & 4095];
      }
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a.x + a.y + a.z + a.w + b;
}
template <int MODE>
void run(float* out, const char* name, double ghz) {
  const int iters = 2048, sms = 132;
  lds<MODE><<<sms, 1024>>>(out, iters);
  cudaDeviceSynchronize();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  lds<MODE><<<sms, 1024>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double loads = 32.0 * iters * 16;  // a block of 32 warps per SM
  printf("%s %.4f %.4f\n", name, ms, ms * 1e-3 * ghz * 1e9 / loads);
}
int main(int argc, char** argv) {
  const double ghz = atof(argv[1]);
  float* out;
  cudaMalloc(&out, 132 * 1024 * sizeof(float));
  run<0>(out, "lds128_one_address", ghz);
  run<1>(out, "lds128_8_addresses_each_quarter", ghz);
  run<2>(out, "lds128_32_addresses", ghz);
  run<3>(out, "lds128_one_address_per_quarter", ghz);
  run<4>(out, "lds32_8_addresses", ghz);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def lds() -> None:
    from sartsolver_tpu_torch.ops import _build

    out_dir = os.path.join(REPO, "build", "sweep_measure")
    os.makedirs(out_dir, exist_ok=True)
    src, exe = os.path.join(out_dir, "lds.cu"), os.path.join(out_dir, "lds")
    with open(src, "w") as f:
        f.write(LDS_SOURCE)
    subprocess.run([_build.nvcc_path(), "-O3", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-o", exe, src], check=True)
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    res = subprocess.run([exe, str(float(mhz) / 1e3)], capture_output=True, text=True, check=True)
    for line in res.stdout.splitlines():
        name, ms, cycles = line.split()
        print(json.dumps({"pattern": name, "ms": float(ms), "sm_clock_mhz": float(mhz),
                          "cycles_per_warp_load": float(cycles)}), flush=True)


def accuracy() -> None:
    import torch

    import chip_smoke
    from sartsolver_tpu_torch.ops.fused_sweep import _sweep, fused_sweep_reference

    for storage, P, V, B in (row for row in chip_smoke.TWO_READ_ROWS if row[1] > 8192):
        H, w, f, aux, scale = chip_smoke._sweep_inputs(P, V, B, False, True, seed=40 + B,
                                                       storage=storage)
        kw = dict(logarithmic=False)
        kernel = _sweep(H, w, f, aux, scale=scale, plan="two_read", **kw)
        plain = fused_sweep_reference(H, w, f, aux, scale=scale, **kw)
        rows = torch.arange(0, P, P // 64, device="cuda")
        Hr = H[rows].double() * (1.0 if scale is None else scale.double())

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())
        # the forward product as one library product over all of V (codes
        # against the operand f_new * scale)
        fwd = plain[0] if scale is None else plain[0] * scale
        one = fwd @ H.float().T
        one_vs_fp64 = rel(one[:, rows].double(), plain[0].double() @ Hr.T)
        del one
        print(json.dumps({
            "fitted_one_product_vs_fp64": one_vs_fp64,
            "storage": storage, "shape": [P, V, B],
            "f_new_kernel_vs_plain": rel(kernel[0].double(), plain[0].double()),
            "fitted_kernel_vs_plain": rel(kernel[1].double(), plain[1].double()),
            "fitted_kernel_vs_fp64": rel(kernel[1][:, rows].double(), kernel[0].double() @ Hr.T),
            "fitted_plain_vs_fp64": rel(plain[1][:, rows].double(), plain[0].double() @ Hr.T),
        }), flush=True)
        del H, w, f, aux, scale, kernel, plain, Hr
        torch.cuda.empty_cache()


def sass() -> None:
    import re
    from pathlib import Path

    from sartsolver_tpu_torch.ops import _build

    _build.load("fused_sweep")
    lib = str(_build.library_path("fused_sweep"))
    bin_dir = Path(_build.nvcc_path()).parent

    def run(*cmd):
        return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout

    def demangle(names):
        out = run(str(bin_dir / "cu++filt"), *names).splitlines()
        return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}

    usage, name = {}, None  # -res-usage: "Function NAME:" then "REG:n STACK:n ..."
    for line in run(str(bin_dir / "cuobjdump"), "-res-usage", lib).splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            usage[name] = dict(re.findall(r"(\w+):(\d+)", line))
            name = None
    counts, name = {}, None
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
    for line in run(str(bin_dir / "cuobjdump"), "-sass", lib).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = op.search(line)
        if name and "one_read" in name and m:
            c = counts.setdefault(name, {})
            c[m.group(1)] = c.get(m.group(1), 0) + 1
    names = demangle(sorted(counts))
    for mangled, c in sorted(counts.items()):
        keep = {k: v for k, v in c.items()
                if k.startswith("I2F") or k in ("PRMT", "FADD", "FFMA", "LDS", "LOP3", "SHF")}
        print(json.dumps({"kernel": names[mangled], "instructions": sum(c.values()),
                          "classes": keep, "resources": usage.get(mangled)}), flush=True)


IMPLICIT_REPS = {"geometry": 20, "wide": 3}  # a wide call of the other checkout may take 0.3 s


def _implicit_turn(root: str, out_dir: str) -> dict:
    """One turn of ``implicit_ab`` in this process: ``root``'s projector on
    both worlds, ms per call; the outputs saved under ``out_dir``."""
    import torch

    import chip_smoke

    sys.path.insert(0, root)
    from sartsolver_tpu_torch.operators import implicit as im

    if not os.path.abspath(im.__file__).startswith(os.path.join(root, "")):
        raise SystemExit(f"sweep_measure: imported {im.__file__}, not from {root}")
    out = {}
    worlds = {"geometry": {}, "wide": dict(chip_smoke.IMPLICIT_WIDE)}
    for world, kw in worlds.items():
        rec = chip_smoke.geometry_record(**kw)
        op = im.ImplicitOperator(rec)
        spec = op.spec(padded_nvoxel=rec.nvoxel, panel_voxels=im.divisor_panel(rec.nvoxel))
        rays = torch.as_tensor(op.payload()).cuda()
        g = torch.Generator(device="cuda").manual_seed(7)
        for which, fn in (("forward", im.implicit_forward), ("back", im.implicit_back)):
            for B in (1, 8):
                x = torch.rand((B, rec.nvoxel if which == "forward" else rec.npixel),
                               generator=g, device="cuda")
                key = f"{world}_{which}@B{B}"
                torch.save(fn(rays, x, spec).cpu(), os.path.join(out_dir, f"{key}.pt"))
                out[key] = chip_smoke._median_ms(lambda: fn(rays, x, spec),
                                                 reps=IMPLICIT_REPS[world])
    return out


def implicit_ab(other: str) -> None:
    import tempfile

    import torch

    import chip_smoke
    from sartsolver_tpu_torch.ops import _build

    other = os.path.abspath(other)
    builds = [_build_in(other, "implicit"), _build_in(REPO, "implicit")]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("sweep_measure: a build failed")
    turns = []
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        for k, (name, root) in enumerate((("other", other), ("this", REPO), ("this", REPO),
                                          ("other", other))):
            out_dir = os.path.join(tmp, str(k))
            os.makedirs(out_dir)
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "_implicit_turn",
                                  root, out_dir], capture_output=True, text=True, check=True)
            turns.append((name, json.loads(res.stdout.strip().splitlines()[-1])))
            print(json.dumps({"turn": name, "root": root, "ms": turns[-1][1]}), flush=True)
            for key in turns[0][1]:
                a = torch.load(os.path.join(tmp, "0", f"{key}.pt"))
                b = torch.load(os.path.join(out_dir, f"{key}.pt"))
                err = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                if err > chip_smoke.KERNEL_TOL:
                    raise SystemExit(f"sweep_measure: {key}: turn {k} differs by {err}")
    summary = {}
    for key in turns[0][1]:
        row = {n: statistics.mean(t[key] for m, t in turns if m == n) for n in ("other", "this")}
        row["this_over_other"] = row["this"] / row["other"]
        summary[key] = row
    print(json.dumps({"implicit_ab_ms": summary}), flush=True)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          os.path.join(REPO, "build", "implicit_ptxas.so"),
                          os.path.join(REPO, "sartsolver_tpu_torch", "ops", "csrc", "implicit.cu")],
                         capture_output=True, text=True, check=True)
    print(json.dumps({"implicit_ptxas": [ln.strip() for ln in res.stderr.splitlines()
                                          if "Compiling" in ln or "registers" in ln
                                          or "spill" in ln]}), flush=True)


def implicit_cull() -> None:
    import torch

    import chip_smoke
    from sartsolver_tpu_torch.operators import implicit as im
    from sartsolver_tpu_torch.ops import _build

    out_dir = os.path.join(REPO, "build", "sweep_measure")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libimplicit-cull-only.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DSART_IMPLICIT_CULL_ONLY", "-o",
                    path, str(_build.CSRC / "implicit.cu")], check=True)
    libs = {"shipped": _build.load("implicit"), "cull_only": ctypes.CDLL(path)}
    try:
        for world, kw in (("geometry", {}), ("wide", dict(chip_smoke.IMPLICIT_WIDE))):
            rec = chip_smoke.geometry_record(**kw)
            op = im.ImplicitOperator(rec)
            spec = op.spec(padded_nvoxel=rec.nvoxel, panel_voxels=im.divisor_panel(rec.nvoxel))
            rays = torch.as_tensor(op.payload()).cuda()
            for B in (1, 8):
                w = torch.rand((B, rec.npixel), device="cuda")

                def timed(name):
                    def call():
                        _build._loaded["implicit"] = libs[name]
                        return im.implicit_back(rays, w, spec)
                    return call
                cull_ms, ms, turns = chip_smoke._in_turns(timed("cull_only"), timed("shipped"))
                print(json.dumps({"world": world, "B": B, "back_ms": ms, "cull_only_ms": cull_ms,
                                  "turns_ms": turns,
                                  "device": chip_smoke._device_profile(timed("shipped"))}),
                      flush=True)
    finally:
        _build._loaded["implicit"] = libs["shipped"]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_measure: no CUDA device is available.", file=sys.stderr)
        return 1
    if argv[:1] == ["_turn"] and len(argv) == 2:
        print(json.dumps(_turn(argv[1])), flush=True)
        return 0
    if argv[:1] == ["_implicit_turn"] and len(argv) == 3:
        print(json.dumps(_implicit_turn(argv[1], argv[2])), flush=True)
        return 0
    if argv[:1] == ["_split_turn"] and len(argv) == 3:
        print(json.dumps(_split_turn(argv[1], argv[2])), flush=True)
        return 0
    sys.path.insert(0, REPO)
    import chip_smoke

    print(chip_smoke.nvidia_smi(), flush=True)
    if argv[:1] == ["ab"] and len(argv) == 2:
        ab(argv[1])
    elif argv[:1] == ["implicit_ab"] and len(argv) == 2:
        implicit_ab(argv[1])
    elif argv[:1] == ["split_ab"] and len(argv) == 2:
        split_ab(argv[1])
    elif argv == ["split_variants"]:
        split_variants()
    elif argv == ["implicit_cull"]:
        implicit_cull()
    elif argv == ["promotion"]:
        promotion()
    elif argv == ["sass"]:
        sass()
    elif argv == ["threads"]:
        threads()
    elif argv == ["phases"]:
        phases()
    elif argv == ["lds"]:
        lds()
    elif argv == ["accuracy"]:
        accuracy()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
