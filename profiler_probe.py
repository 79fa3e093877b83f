#!/usr/bin/env python3
"""How often the profiler's count of the hand kernels misses a launch.

The launch audit (``sartsolver_tpu_torch/analysis/audit.py``) holds the
fused sweep's counted calls against the CUDA kernels ``torch.profiler``
saw. This script repeats the audit's one profiled run (``audit._count``)
many times in a fresh process, on a seeded 8192 x 65536 matrix (the size
of ``chip_smoke.py``'s world), for the fused entries at fp32 B = 1, int8
B = 1 and bf16 B = 8, alternating K and 2K iterations, and counts the
sessions whose kernels are not the plan's kernels a call times the calls.

Run from the root of a checkout on a CUDA card:
``python3 profiler_probe.py [--sessions N]``. It prints one JSON object,
then the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CASES = (("int8_fused_sweep", "int8", 1, 1.0), ("fused_sweep", "float32", 1, 0.4),
         ("fused_sweep", "bfloat16", 8, 0.25))  # (entry, storage, B, share of the sessions)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sessions", type=int, default=200,
                        help="profiled runs of the first case (the others a share of it)")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profiler_probe.py needs a CUDA card", file=sys.stderr)
        return 1
    from sartsolver_tpu_torch.analysis import audit, registry
    from sartsolver_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    H = np.random.default_rng(7).random((8192, 65536), dtype=np.float32)
    reg = registry.load_registered_entries()
    ctx = audit.AuditContext("cuda", H)
    names = audit.hand_kernel_names()
    results = {}
    try:
        for name, storage, B, share in CASES:
            ctx.B, ctx.storage = B, storage
            run = reg[name].build(ctx)
            run(1)
            r = results[f"{name}/{storage}/B{B}"] = dict(sessions=0, misses=0, missed=[])
            for i in range(max(1, round(args.sessions * share))):
                k = audit.AUDIT_ITERATIONS * (1 + i % 2)
                c = audit._count(run, k, True, names)
                want = sum(n * audit.KERNELS_PER_CALL[p.split(":", 1)[1]]
                           for p, n in c["plans"].items() if p.startswith("fused_sweep:"))
                r["sessions"] += 1
                if sum(c["kernels"].values()) != want:
                    r["misses"] += 1
                    r["missed"].append(dict(iterations=k, want=want, kernels=dict(c["kernels"])))
    finally:
        ctx.close()
    print(json.dumps(dict(torch=torch.__version__, seconds=time.perf_counter() - t0,
                          results=results)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
