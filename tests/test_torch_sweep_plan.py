"""Which plan of the fused sweep each shape and storage gets, and the refusal
of a forced plan whose preconditions fail.

``plan_sweep`` is pure arithmetic on ``(P, V, B, storage)``, so its rule is
pinned here on the CPU; the kernels themselves are held against the plain
version on the card (``test_torch_kernel_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from sartsolver_tpu_torch.ops.fused_sweep import (
    ONE_READ_MAX_B, ONE_READ_MAX_P, ONE_READ_MIN_P, TENSOR_CORE_MIN_B, V_MULTIPLE, _sweep,
    fused_sweep, fused_sweep_reference, plan_refusal, plan_sweep,
)

MIN_B = TENSOR_CORE_MIN_B


@pytest.mark.parametrize("P, V, B, storage, plan", [
    # the e2e world's fp32 B = 1 (the CLI's main path)
    (8192, 65536, 1, "float32", "one_read"),
    # the int8 probes' B = 32
    (8192, 65536, 32, "int8", "tensor_core"),
    # fp32 with P past the one-read limit
    (ONE_READ_MAX_P + 1, 65536, 1, "float32", "two_read"),
    (16384, 65536, 1, "float32", "two_read"),
    # bf16 and int8 at B = 1
    (8192, 65536, 1, "bfloat16", "two_read"),
    (8192, 65536, 1, "int8", "two_read"),
    # edges of the one-read limit: P, B, V in whole 16-column panels
    (ONE_READ_MAX_P, 16, ONE_READ_MAX_B, "float32", "one_read"),
    (8192, 65536, ONE_READ_MAX_B + 1, "float32", "two_read"),
    (8192, 65536 - V_MULTIPLE, 1, "float32", "one_read"),
    (8192, 65536 - 1, 1, "float32", "two_read"),
    # the lower edge of P, where one_read stops beating two_read
    (ONE_READ_MIN_P, 16, 1, "float32", "one_read"),
    (ONE_READ_MIN_P, 65536, ONE_READ_MAX_B, "float32", "one_read"),
    (ONE_READ_MIN_P - 1, 65536, 1, "float32", "two_read"),
    (4096, 65536, 1, "float32", "two_read"),
    (1, 16, 1, "float32", "two_read"),
    (1000, 3008, 3, "float32", "two_read"),
    (1000, 3001, 3, "float32", "two_read"),
    # edges of the tensor-core rule: the crossover batch, V in 16-code runs
    (8192, 65536, MIN_B, "int8", "tensor_core"),
    (8192, 65536, MIN_B - 1, "int8", "two_read"),
    (8192, 65536 + 8, 32, "int8", "two_read"),
    (1000, 3008, 19, "int8", "tensor_core"),
    (1000, 3001, 19, "int8", "two_read"),
    (8192, 65536, 4096, "int8", "tensor_core"),
    # the tensor cores take int8 codes only; one_read fp32 only
    (8192, 65536, 32, "bfloat16", "two_read"),
    (8192, 65536, 32, "float32", "two_read"),
    (8192, 65536, 2, "bfloat16", "two_read"),
])
def test_plan_of_each_shape(P, V, B, storage, plan):
    assert plan_sweep(P, V, B, storage) == plan
    assert plan_refusal(plan, P, V, B, storage) is None


def test_crossover_batch_is_above_the_main_path():
    """The CLI solves one frame at a time: int8 at B = 1 stays two_read."""
    assert 1 < TENSOR_CORE_MIN_B <= 32


def _cpu_inputs(P, V, B, storage, seed=0):
    rng = np.random.default_rng(seed)
    H = torch.from_numpy(rng.uniform(0.0, 1.0, (P, V)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.5, 1.0, (B, P)).astype(np.float32) / P)
    f = torch.from_numpy(rng.uniform(0.1, 2.0, (B, V)).astype(np.float32))
    aux = [torch.from_numpy(rng.uniform(0.0, 2.0, (1, V)).astype(np.float32))]
    scale = None
    if storage == "int8":
        H = torch.from_numpy(rng.integers(-127, 128, (P, V)).astype(np.int8))
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, (1, V)).astype(np.float32) / 127)
    elif storage == "bfloat16":
        H = H.to(torch.bfloat16)
    return H, w, f, aux, scale


@pytest.mark.parametrize("plan, P, V, B, storage, match", [
    ("one_read", 64, 256, 1, "int8", "one_read takes fp32 storage, not int8"),
    ("one_read", 64, 256, 1, "bfloat16", "one_read takes fp32 storage, not bfloat16"),
    ("one_read", 64, 256, ONE_READ_MAX_B + 1, "float32", "one_read needs B <= 4"),
    ("one_read", 64, 250, 1, "float32", "V a multiple of 16"),
    ("one_read", ONE_READ_MAX_P + 1, 16, 1, "float32", "P <= 8192"),
    ("tensor_core", 64, 256, 32, "float32", "tensor_core takes int8 codes, not float32"),
    ("tensor_core", 64, 256, 32, "bfloat16", "tensor_core takes int8 codes"),
    ("tensor_core", 64, 250, 32, "int8", "tensor_core needs V a multiple of 16"),
    ("tensor_core", 64, 264, 32, "int8", "tensor_core needs V a multiple of 16"),
    ("fastest", 64, 256, 1, "float32", "unknown plan 'fastest'"),
])
def test_wrapper_refuses_a_forced_plan_whose_preconditions_fail(plan, P, V, B, storage,
                                                                match):
    H, w, f, aux, scale = _cpu_inputs(P, V, B, storage)
    calls = dict(fused_sweep.launches_by_plan)
    with pytest.raises(ValueError, match=match):
        _sweep(H, w, f, aux, logarithmic=False, scale=scale, plan=plan)
    assert fused_sweep.launches_by_plan == calls


@pytest.mark.parametrize("plan, storage, B", [
    ("two_read", "float32", 1), ("two_read", "int8", 32), ("one_read", "float32", 3),
    ("tensor_core", "int8", 1), ("tensor_core", "int8", 19),
])
def test_a_forced_plan_on_cpu_tensors_runs_the_plain_version(plan, storage, B):
    """A plan that may run is checked, then CPU tensors take the plain
    version as always: no launch is counted."""
    H, w, f, aux, scale = _cpu_inputs(48, 256, B, storage, seed=1)
    calls = fused_sweep.launches
    got = _sweep(H, w, f, aux, logarithmic=False, scale=scale, plan=plan)
    want = fused_sweep_reference(H, w, f, aux, logarithmic=False, scale=scale)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert fused_sweep.launches == calls


def test_launch_counts_by_plan_cover_every_plan():
    assert set(fused_sweep.launches_by_plan) == {"two_read", "one_read", "tensor_core"}
