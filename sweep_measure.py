#!/usr/bin/env python3
"""Measurements of the fused sweep on one CUDA card that ``chip_smoke.py``
does not repeat on every run. Run from the root of a checkout:

``python3 sweep_measure.py ab OTHER``
    The ``two_read`` plan of this checkout against the fused sweep of
    another checkout of the repository (for example the parent commit,
    unpacked with ``git archive``), at 8192 x 65536, B = 1, linear with the
    penalty (the CLI's main mode), for each storage type, with
    ``chip_smoke.py``'s timing inputs. Timed in turns, other, this, this,
    other, each turn a process of its own that imports its checkout's
    package: ms per call (CUDA events around the wrapper's call, so the
    host's work in the wrapper is counted) and device ms per call by CUDA
    kernel (``torch.profiler``).

``python3 sweep_measure.py promotion``
    The ``tensor_core`` plan's error against the plain version at the three
    int8 probes' configuration (``chip_smoke.py``'s probe inputs), built as
    shipped and built with ``SART_TC_NO_PROMOTE`` (the tensor cores'
    accumulation chain left unpromoted) into ``build/sweep_measure/``.

Each prints one JSON line per measurement, and the card's name and power
limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
REPS = 50
STORAGES = ("float32", "bfloat16", "int8")


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
    for storage in STORAGES:
        H, w, f, aux, scale = chip_smoke._sweep_inputs(8192, 65536, 1, False, True, seed=7,
                                                       storage=storage)
        if storage == "float32" and hasattr(mod, "_sweep"):  # one_read is fp32's own plan
            def call():
                return mod._sweep(H, w, f, aux, scale=scale, logarithmic=False,
                                  plan="two_read")
        else:
            def call():
                return mod.fused_sweep(H, w, f, aux, scale=scale, logarithmic=False)
        out[storage] = dict(ms=chip_smoke._median_ms(call, reps=REPS),
                            device=chip_smoke._device_profile(call, calls=20))
        del H, w, f, aux, scale
        torch.cuda.empty_cache()
    return out


def _build_in(root: str) -> subprocess.Popen:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from sartsolver_tpu_torch.ops import _build; _build.build_all()")
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
    for storage in STORAGES:
        ms = {n: [t[storage]["ms"] for m, t in turns if m == n] for n in ("other", "this")}
        summary[storage] = {n: sum(v) / len(v) for n, v in ms.items()}
        summary[storage]["this_over_other"] = summary[storage]["this"] / summary[storage]["other"]
    print(json.dumps({"ab_two_read_ms": summary}), flush=True)


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


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_measure: no CUDA device is available.", file=sys.stderr)
        return 1
    if argv[:1] == ["_turn"] and len(argv) == 2:
        print(json.dumps(_turn(argv[1])), flush=True)
        return 0
    sys.path.insert(0, REPO)
    import chip_smoke

    print(chip_smoke.nvidia_smi(), flush=True)
    if argv[:1] == ["ab"] and len(argv) == 2:
        ab(argv[1])
    elif argv == ["promotion"]:
        promotion()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
