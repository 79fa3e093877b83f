"""Roofline accounting: an analytic sweep cost times a measured rate.

Counterpart of ``sartsolver_tpu/obs/roofline.py``'s :func:`device_peaks`,
:func:`sweep_cost_model` and :func:`utilization`. It combines the solver's
analytic per-iteration cost of a SART sweep (FLOPs and bytes) with a
measured iteration rate into achieved-against-peak fractions of the two
resources a sweep can saturate: the matrix units (``mxu_util``) and the
memory bandwidth (``hbm_util``). The arithmetic intensity against the
device's ridge intensity says which wall the program is against.

Device peaks come from a per-part table (the dense bf16 matrix peak and the
memory bandwidth per device) with environment overrides,
``SART_PEAK_MXU_TFLOPS`` and ``SART_PEAK_HBM_GBS``. The table keeps the JAX
package's TPU rows and adds the H100 SXM5. ``mxu_util`` keeps its key so
that artifacts of the two packages diff; against the bf16 peak it reads low
for fp32 sweeps, by design.

The JAX module's ``compiled_cost_numbers`` reads XLA's static cost model of
a compiled program; PyTorch has no such model, and the port has no
counterpart.

Standard library only, like :mod:`~sartsolver_tpu_torch.obs.schema`: a
benchmark harness may load it by file path.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

# Per-device peaks: substring of the lowercased device kind -> (dense bf16
# matrix TFLOP/s, memory GB/s). First match wins, most specific first. The
# H100 row is NVIDIA's H100 SXM5 data sheet (dense, no sparsity, at the
# full 700 W); it matches torch.cuda.get_device_name's
# "NVIDIA H100 80GB HBM3".
DEVICE_PEAKS: Tuple[Tuple[Tuple[str, ...], float, float], ...] = (
    (("h100 80gb hbm3", "h100 sxm"), 989.0, 3350.0),
    (("v5 lite", "v5e", "v5lite"), 197.0, 819.0),
    (("v5p",), 459.0, 2765.0),
    (("v6", "trillium"), 918.0, 1640.0),
    (("v4",), 275.0, 1228.0),
)

# Host fallbacks: the CPU as a "device". Rough figures: CPU runs are
# correctness runs, and their utilization numbers are only ever diffed
# against other CPU runs.
CPU_PEAK_TFLOPS = 0.5
CPU_PEAK_HBM_GBS = 50.0

# Unknown accelerator: the smallest part of the JAX table rather than an
# invented one (utilization reads high, which invites a second look).
DEFAULT_TFLOPS = 197.0
DEFAULT_HBM_GBS = 819.0


def device_peaks(platform: str, device_kind: str = "",
                 ndev: int = 1) -> Dict[str, object]:
    """Aggregate peak FLOP/s and memory bytes/s for ``ndev`` devices.

    ``SART_PEAK_MXU_TFLOPS`` / ``SART_PEAK_HBM_GBS`` (per device) override
    the table: for parts it does not know, derated cards (a power limit
    below 700 W), or a measured probe."""
    kind = (device_kind or "").lower()
    tflops, gbs, source = None, None, None
    for needles, t, g in DEVICE_PEAKS:
        if any(n in kind for n in needles):
            tflops, gbs, source = t, g, f"table:{needles[0]}"
            break
    if tflops is None:
        if (platform or "").lower() == "cpu":
            tflops, gbs, source = CPU_PEAK_TFLOPS, CPU_PEAK_HBM_GBS, "cpu"
        else:
            tflops, gbs, source = DEFAULT_TFLOPS, DEFAULT_HBM_GBS, "default"
    env_t = os.environ.get("SART_PEAK_MXU_TFLOPS")
    env_g = os.environ.get("SART_PEAK_HBM_GBS")
    if env_t:
        tflops, source = float(env_t), "env"
    if env_g:
        gbs, source = float(env_g), "env"
    ndev = max(int(ndev), 1)
    return {
        "mxu_flops_s": tflops * 1e12 * ndev,
        "hbm_bytes_s": gbs * 1e9 * ndev,
        "per_device_tflops": tflops,
        "per_device_hbm_gbs": gbs,
        "ndev": ndev,
        "source": source,
        "device_kind": device_kind or platform,
    }


def sweep_cost_model(npixel: int, nvoxel: int, batch: int,
                     itemsize: int, reads: int) -> Tuple[float, float]:
    """Analytic per-iteration cost of one SART sweep.

    FLOPs: the forward projection (``f @ H^T``) and the back projection
    (``w @ H``) are each ``batch x npixel x nvoxel`` MACs (2 FLOPs);
    everything else is O(npixel + nvoxel). Bytes: the RTM streams from
    memory ``reads`` times per iteration (1 fused, 2 two-matmul) and
    dominates; the per-frame vectors ride along at fp32."""
    flops = 4.0 * batch * npixel * nvoxel
    vec_bytes = 4.0 * batch * (npixel + nvoxel)
    bytes_per_iter = float(reads) * npixel * nvoxel * itemsize + vec_bytes
    return flops, bytes_per_iter


def utilization(flops_per_iter: float, bytes_per_iter: float,
                iter_s: float, peaks: Dict[str, object]) -> dict:
    """Achieved-against-peak fractions of the two rooflines at ``iter_s``
    iterations per second. ``bound`` compares the program's arithmetic
    intensity (FLOPs per byte) with the device's ridge intensity (peak
    FLOP/s per peak byte/s): below the ridge memory bandwidth is the wall,
    above it the matrix units are."""
    peak_f = float(peaks["mxu_flops_s"])
    peak_b = float(peaks["hbm_bytes_s"])
    achieved_f = float(flops_per_iter) * float(iter_s)
    achieved_b = float(bytes_per_iter) * float(iter_s)
    ai = (float(flops_per_iter) / float(bytes_per_iter)
          if bytes_per_iter else 0.0)
    ridge = peak_f / peak_b if peak_b else 0.0
    return {
        "flops_per_iter": round(float(flops_per_iter), 1),
        "bytes_per_iter": round(float(bytes_per_iter), 1),
        "achieved_tflops": round(achieved_f / 1e12, 6),
        "achieved_gbs": round(achieved_b / 1e9, 3),
        "mxu_util": round(achieved_f / peak_f, 6) if peak_f else 0.0,
        "hbm_util": round(achieved_b / peak_b, 6) if peak_b else 0.0,
        "arithmetic_intensity": round(ai, 3),
        "ridge_intensity": round(ridge, 3),
        "bound": "hbm" if ai < ridge else "mxu",
        "peaks": {
            "per_device_tflops": peaks["per_device_tflops"],
            "per_device_hbm_gbs": peaks["per_device_hbm_gbs"],
            "ndev": peaks["ndev"],
            "source": peaks["source"],
        },
    }
