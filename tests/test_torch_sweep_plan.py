"""Which plan of the fused sweep each shape and storage gets, and the refusal
of a forced plan whose preconditions fail.

``plan_sweep`` is pure arithmetic on ``(P, V, B, storage)``, so its rule is
pinned here on the CPU; the kernels themselves are held against the plain
version on the card (``test_torch_kernel_gpu.py``, ``chip_smoke.py``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from sartsolver_tpu_torch.ops.fused_sweep import (
    ONE_READ_MAX_B, ONE_READ_MAX_P, ONE_READ_MIN_P,
    ONE_READ_V_MULTIPLE, TENSOR_CORE_MIN_B, _sweep, fused_sweep, fused_sweep_reference,
    plan_refusal, plan_sweep,
)

MIN_B = TENSOR_CORE_MIN_B["int8"]
BF16_MIN_B = TENSOR_CORE_MIN_B["bfloat16"]
FP32_MIN_P = ONE_READ_MIN_P["float32"]
FP32_MAX_B = ONE_READ_MAX_B["float32"]
MAX_B = ONE_READ_MAX_B["int8"]  # bf16 and int8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("P, V, B, storage, plan", [
    # the e2e world's fp32 B = 1 (the CLI's main path)
    (8192, 65536, 1, "float32", "one_read"),
    # the int8 probes' B = 32
    (8192, 65536, 32, "int8", "tensor_core"),
    # fp32 with P past the one-read limit
    (ONE_READ_MAX_P + 1, 65536, 1, "float32", "two_read"),
    (16384, 65536, 1, "float32", "two_read"),
    # bf16 and int8 at B = 1: the CLI's reduced-storage runs read H once
    (8192, 65536, 1, "bfloat16", "one_read"),
    (8192, 65536, 1, "int8", "one_read"),
    # edges of the one-read limit: P, B, V in whole 16-column panels
    (ONE_READ_MAX_P, 16, FP32_MAX_B, "float32", "one_read"),
    (8192, 65536, FP32_MAX_B + 1, "float32", "two_read"),
    (8192, 65536 - ONE_READ_V_MULTIPLE["float32"], 1, "float32", "one_read"),
    (8192, 65536 - 1, 1, "float32", "two_read"),
    # the lower edge of P, where one_read stops beating two_read
    (FP32_MIN_P, 16, 1, "float32", "one_read"),
    (FP32_MIN_P, 65536, FP32_MAX_B, "float32", "one_read"),
    (FP32_MIN_P - 1, 65536, 1, "float32", "two_read"),
    (FP32_MIN_P - 1, 65536, FP32_MAX_B, "float32", "two_read"),
    (4096, 65536, 1, "float32", "one_read"),
    (4096, 65536, FP32_MAX_B, "float32", "one_read"),
    (1, 16, 1, "float32", "two_read"),
    (1000, 3008, 3, "float32", "two_read"),
    (1000, 3001, 3, "float32", "two_read"),
    # edges of the tensor-core rule: the crossover batch (past one_read's
    # B, so the two never compete), V in 16-code runs
    (8192, 65536, MIN_B, "int8", "tensor_core"),
    (8192, 65536, MIN_B - 1, "int8", "one_read"),
    (ONE_READ_MIN_P["int8"], 65536, MIN_B - 1, "int8", "one_read"),
    (ONE_READ_MIN_P["int8"] - 1, 65536, MIN_B - 1, "int8", "two_read"),
    (1024, 65536, MIN_B, "int8", "tensor_core"),
    (8192, 65536, MAX_B + 1, "int8", "tensor_core"),
    (16384, 65536, MIN_B, "int8", "tensor_core"),
    (ONE_READ_MIN_P["int8"] - 1, 65536, MIN_B, "int8", "tensor_core"),
    (ONE_READ_MIN_P["int8"] - 1, 65536, MIN_B - 1, "int8", "two_read"),
    (8192, 65536 + 8, 32, "int8", "two_read"),
    (1000, 3008, 19, "int8", "tensor_core"),
    (1000, 3001, 19, "int8", "two_read"),
    (8192, 65536, 4096, "int8", "tensor_core"),
    # the tensor cores take bf16 and int8 storage; one_read at most B = 4
    # for them, 8 for fp32
    (8192, 65536, 32, "bfloat16", "tensor_core"),
    (8192, 65536, 32, "float32", "two_read"),
    (8192, 65536, 2, "bfloat16", "one_read"),
    # the batch loops' B = 8: fp32 one_read up to B = 8, then two_read; bf16
    # one_read up to B = 4, then tensor_core where V is in 16-element runs
    (8192, 65536, 8, "float32", "one_read"),
    (8192, 65536, 5, "float32", "one_read"),
    (8192, 65536, 9, "float32", "two_read"),
    (8192, 65536, 16, "float32", "two_read"),
    (8192, 65536 - 16, 8, "float32", "one_read"),
    (8192, 65536 - 8, 8, "float32", "two_read"),
    (8192, 65536, 4, "bfloat16", "one_read"),
    (8192, 65536, 5, "bfloat16", "tensor_core"),
    # bf16 on the tensor cores from B = 5, past its one_read's B = 4
    (8192, 65536, BF16_MIN_B - 1, "bfloat16", "one_read"),
    (8192, 65536, BF16_MIN_B, "bfloat16", "tensor_core"),
    (1024, 65536, BF16_MIN_B - 1, "bfloat16", "two_read"),
    (1024, 65536, BF16_MIN_B, "bfloat16", "tensor_core"),
    (1024, 65536, 4, "bfloat16", "two_read"),
    (16384, 65536, BF16_MIN_B, "bfloat16", "tensor_core"),
    (16384, 65536, BF16_MIN_B - 1, "bfloat16", "two_read"),
    (8192, 65536 - 16, 4, "bfloat16", "two_read"),
    (8192, 65536, 8, "bfloat16", "tensor_core"),
    (8192, 65536, 16, "bfloat16", "tensor_core"),
    (8192, 65536, 19, "bfloat16", "tensor_core"),
    (1000, 3008, 19, "bfloat16", "tensor_core"),
    (8192, 65536 - 8, 8, "bfloat16", "two_read"),
    (8192, 65536 + 8, 32, "bfloat16", "two_read"),
    (1000, 3001, 19, "bfloat16", "two_read"),
    (16384, 65536, 8, "bfloat16", "tensor_core"),
    (16384, 65536, 8, "float32", "two_read"),
])
def test_plan_of_each_shape(P, V, B, storage, plan):
    assert plan_sweep(P, V, B, storage) == plan
    assert plan_refusal(plan, P, V, B, storage) is None


# two_read's rows: fp32 past one_read's B = 8 on the e2e world's shape, and
# every matrix past one_read's P = 8192 (a taller world, a tall and narrow
# one, the capacity demo's bf16 and int8 shapes) at the batch sizes where no
# other plan applies
@pytest.mark.parametrize("P, V, B, storage", [
    (8192, 65536, 16, "float32"),
    (8192, 65536, 32, "float32"),
    (16384, 65536, 1, "float32"),
    (16384, 65536, 8, "float32"),
    (65536, 16384, 1, "float32"),
    (49152, 131072, 1, "bfloat16"),
    (49152, 131072, 2, "bfloat16"),
    (65536, 131072, 1, "int8"),
    (65536, 131072, 3, "int8"),
    (16384, 65536, 1, "bfloat16"),
    (16384, 65536, 1, "int8"),
])
def test_tall_matrices_and_wide_fp32_batches_take_two_read(P, V, B, storage):
    assert plan_sweep(P, V, B, storage) == "two_read"
    assert plan_refusal("two_read", P, V, B, storage) is None


def test_crossover_batch_is_above_the_main_path():
    """The CLI solves one frame at a time: bf16 and int8 at B = 1 never take
    the tensor cores."""
    for storage in ("bfloat16", "int8"):
        assert 1 < TENSOR_CORE_MIN_B[storage] <= 32
        assert plan_sweep(8192, 65536, 1, storage) != "tensor_core"


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_batch_loops_b8_reads_h_once_or_on_the_tensor_cores(storage):
    """At the batch loops' B = 8 on the e2e world's shape no storage is left
    on two_read: fp32 reads H once, bf16 and int8 run on the tensor cores;
    bf16 keeps one_read through B = 4."""
    want = {"float32": "one_read", "bfloat16": "tensor_core", "int8": "tensor_core"}
    assert plan_sweep(8192, 65536, 8, storage) == want[storage]
    for B in range(1, ONE_READ_MAX_B["bfloat16"] + 1):
        assert plan_sweep(ONE_READ_MIN_P["bfloat16"], 65536, B, "bfloat16") == "one_read"


def _reduced_storage_cases():
    """The one_read rule's edges for bf16 and int8: each storage's lower P
    edge and ONE_READ_MAX_P, V at and off its multiple, B at
    ONE_READ_MAX_B and one past it (the tensor cores')."""
    cases = []
    for st in ("bfloat16", "int8"):
        lo, m = ONE_READ_MIN_P[st], ONE_READ_V_MULTIPLE[st]
        past_b = "tensor_core"
        cases += [
            (lo, 65536, 1, st, "one_read"),
            (lo, 65536, 3, st, "one_read"),
            (lo, 65536, MAX_B, st, "one_read"),
            (lo - 1, 65536, 1, st, "two_read"),
            (ONE_READ_MAX_P, 65536, 1, st, "one_read"),
            (ONE_READ_MAX_P + 1, 65536, 1, st, "two_read"),
            (8192, m, 1, st, "one_read"),
            (8192, 65536 - m, 1, st, "one_read"),
            (8192, 65536 - m // 2, 1, st, "two_read"),
            (8192, 65536 - 1, 1, st, "two_read"),
            (8192, 65536, MAX_B + 1, st, past_b),
        ]
    return cases


@pytest.mark.parametrize("P, V, B, storage, plan", _reduced_storage_cases())
def test_one_read_edges_of_reduced_storage(P, V, B, storage, plan):
    assert plan_sweep(P, V, B, storage) == plan
    assert plan_refusal(plan, P, V, B, storage) is None


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_one_read_panel_is_64_bytes_of_each_storage(storage):
    """The panel's columns are one 64-byte row segment of the storage type,
    a whole number of the tensor cores' 16-code runs for int8."""
    itemsize = torch.empty((), dtype=getattr(torch, storage)).element_size()
    assert ONE_READ_V_MULTIPLE[storage] * itemsize == 64
    assert plan_refusal("one_read", 8192, ONE_READ_V_MULTIPLE[storage], 1, storage) is None
    assert ONE_READ_MIN_P[storage] <= ONE_READ_MAX_P


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
    ("one_read", 64, 288, 1, "int8", "V a multiple of 64 for int8"),
    ("one_read", 64, 272, 1, "bfloat16", "V a multiple of 32 for bfloat16"),
    ("one_read", 64, 256 - 1, 1, "int8", "V a multiple of 64 for int8"),
    ("one_read", 64, 256 - 16, 1, "bfloat16", "V a multiple of 32 for bfloat16"),
    ("one_read", 64, 256, MAX_B + 1, "int8", "one_read needs B <= 4"),
    ("one_read", 64, 256, MAX_B + 1, "bfloat16", "one_read needs B <= 4"),
    ("one_read", ONE_READ_MAX_P + 1, 256, 1, "bfloat16", "P <= 8192"),
    ("one_read", 64, 256, FP32_MAX_B + 1, "float32", "one_read needs B <= 8"),
    ("one_read", 64, 250, 1, "float32", "V a multiple of 16"),
    ("one_read", ONE_READ_MAX_P + 1, 16, 1, "float32", "P <= 8192"),
    ("tensor_core", 64, 256, 32, "float32",
     "tensor_core takes bf16 or int8 storage, not float32"),
    ("tensor_core", 64, 248, 32, "bfloat16", "tensor_core needs V a multiple of 16"),
    ("tensor_core", 64, 250, 8, "bfloat16", "tensor_core needs V a multiple of 16"),
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
    ("one_read", "bfloat16", 1), ("one_read", "int8", 4), ("one_read", "float32", 8),
    ("tensor_core", "int8", 1), ("tensor_core", "int8", 19),
    ("tensor_core", "bfloat16", 5), ("tensor_core", "bfloat16", 32),
    ("two_read", "bfloat16", 8),
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


def test_chip_smoke_reads_the_one_read_edge_from_a_crossover_table():
    """The edges chip_smoke.py prints: the smallest P at V = 65536 from
    which one_read beat two_read at every B of the table, and for each B
    timed beside tensor_core the smallest P from which it beat that too."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)

    def row(P, B, one, two, tc=None, V=65536):
        r = {"P": P, "V": V, "B": B, "one_read_ms": one, "two_read_ms": two}
        if tc is not None:
            r["tensor_core_ms"] = tc
        return r

    table = [row(4096, 1, 0.5, 0.6), row(4096, 2, 0.7, 0.6, tc=0.4),  # lost at B = 2
             row(6144, 1, 0.5, 0.8), row(6144, 2, 0.6, 0.9, tc=0.5),
             row(8192, 1, 0.6, 1.0), row(8192, 2, 0.7, 1.2, tc=0.8),
             row(8192, 1, 0.9, 0.1, V=1024)]                          # other V: not read
    assert chip_smoke.one_read_edge(table) == {"min_p": 6144,
                                               "over_tensor_core_min_p": {2: 8192}}
    table[3]["tensor_core_ms"] = 0.7
    assert chip_smoke.one_read_edge(table)["over_tensor_core_min_p"] == {2: 6144}
    table[4]["one_read_ms"] = 2.0                                     # lost at the top
    assert chip_smoke.one_read_edge(table)["min_p"] is None


def test_chip_smoke_reads_the_tensor_core_edge_from_a_crossover_table():
    """The smallest B from which tensor_core beat two_read at every larger
    B of the table; None where it lost at the largest."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)

    def row(B, two, tc):
        return {"P": 8192, "V": 65536, "B": B, "two_read_ms": two, "tensor_core_ms": tc}

    table = [row(2, 0.5, 0.7), row(4, 0.6, 0.5), row(5, 0.7, 0.8), row(8, 0.9, 0.8),
             row(16, 1.3, 0.8)]
    assert chip_smoke.tensor_core_edge(table) == 8
    table[2]["tensor_core_ms"] = 0.6
    assert chip_smoke.tensor_core_edge(table) == 4
    table[-1]["tensor_core_ms"] = 1.4
    assert chip_smoke.tensor_core_edge(table) is None
