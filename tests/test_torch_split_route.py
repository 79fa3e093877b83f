"""Which route the split sweep (``sharded_sweep_bp``, ``sharded_sweep_finish``)
takes on the card at each shape and storage, and how the launch audit holds
the pair to its route's CUDA kernels.

``split_route`` is pure arithmetic on ``(P, V, B, storage)``, so its rule is
pinned here on the CPU, as ``test_torch_sweep_plan.py`` pins ``plan_sweep``;
the kernel's own preconditions (``sart_split_route_ok``) are held against
it on the card (``test_torch_grid_gpu.py``), and both routes against
``two_read`` bit for bit there. Both routes sum in two_read's order: the
splits of P (``split_row_splits``, two_read's ``tr_shape``) are part of
the rule.
"""

import pytest
import torch

from sartsolver_tpu_torch.analysis.audit import KERNELS_PER_CALL, _agreement
from sartsolver_tpu_torch.ops import fused_sweep as fs
from sartsolver_tpu_torch.ops.fused_sweep import (
    SPLIT_MAX_B, SPLIT_MAX_ROW_SPLITS, split_route, split_row_splits,
)

STORAGES = ["float32", "bfloat16", "int8"]
ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


@pytest.mark.parametrize("P, V, S", [
    # the 2x1 grid's block of the e2e world: one split, one row group each
    (4096, 65536, 1),
    # the tall world's 2x1 block and the tall world whole
    (8192, 65536, 2), (16384, 65536, 4),
    # the audit grid's block: four splits fill the SMs at V = 16384
    (1024, 16384, 4),
    # the GPU tests' shapes
    (4096, 8192, 8), (9000, 65536, 3), (1000, 4000, 4), (777, 5008, 4),
    (257, 4000, 2), (1000, 3001, 4), (1000, 1008, 4),
    # past a cluster: 64 Ki rows in splits of at most 4096
    (65536, 16384, 16), (40000, 65536, 10),
    # one row
    (1, 1, 1), (1, 65536, 1),
])
def test_split_row_splits_are_two_reads(P, V, S):
    assert split_row_splits(P, V) == S


@pytest.mark.parametrize("P, V, B, storage, route", [
    # the grid's main path: the 2x1 block at B = 1, every storage
    (4096, 65536, 1, "float32", "cluster"),
    (4096, 65536, 1, "bfloat16", "cluster"),
    (4096, 65536, 1, "int8", "cluster"),
    # the batch edge
    (4096, 65536, SPLIT_MAX_B, "float32", "cluster"),
    (4096, 65536, SPLIT_MAX_B + 1, "float32", "two_read"),
    (4096, 65536, 32, "int8", "two_read"),
    # a row of 16 bytes: 4 fp32, 8 bf16, 16 int8 columns
    (1000, 4000, 1, "float32", "cluster"),
    (1000, 4001, 1, "float32", "two_read"),
    (1000, 4004, 1, "float32", "cluster"),
    (1000, 4004, 1, "bfloat16", "two_read"),
    (1000, 4008, 1, "bfloat16", "cluster"),
    (1000, 4008, 1, "int8", "two_read"),
    (1000, 4016, 1, "int8", "cluster"),
    # the splits of P: at most a cluster's 8
    (4096, 8192, 1, "float32", "cluster"),
    (32768, 65536, 1, "float32", "cluster"),
    (65536, 16384, 1, "float32", "two_read"),
    (40000, 65536, 1, "bfloat16", "two_read"),
])
def test_split_route(P, V, B, storage, route):
    assert split_route(P, V, B, storage) == route


@pytest.mark.parametrize("storage", STORAGES)
def test_split_route_is_its_three_conditions(storage):
    """The rule on a grid of shapes: the cluster route exactly where B <=
    SPLIT_MAX_B, a row is a multiple of 16 bytes and two_read's splits of P
    number at most SPLIT_MAX_ROW_SPLITS."""
    for P in (1, 63, 64, 257, 1000, 4096, 8192, 9000, 16384, 32768, 40000, 65536):
        for V in (1, 8, 129, 3001, 3008, 4000, 5008, 8192, 65536):
            for B in (1, 2, 3, 4, 5, 8, 32):
                want = (B <= SPLIT_MAX_B and V * ITEMSIZE[storage] % 16 == 0
                        and split_row_splits(P, V) <= SPLIT_MAX_ROW_SPLITS)
                assert (split_route(P, V, B, storage) == "cluster") == want


def test_split_kernels_per_call_cover_the_routes():
    assert fs.SPLIT_KERNELS_PER_CALL == {"cluster": 1, "two_read": 3}
    assert set(fs.SPLIT_ROUTES) == set(fs.SPLIT_KERNELS_PER_CALL)


def test_split_counts_by_route_start_at_zero():
    fs.reset_sharded_launch_counts()
    for wrapper in (fs.sharded_sweep_bp, fs.sharded_sweep_finish):
        assert wrapper.launches == 0
        assert wrapper.launches_by_route == {"two_read": 0, "cluster": 0}


def test_split_pair_on_the_cpu_counts_no_launch():
    """CPU tensors run the plain versions: no route is taken, nothing is
    counted."""
    fs.reset_sharded_launch_counts()
    H, w = torch.rand(64, 256), torch.rand(1, 64)
    bp = fs.sharded_sweep_bp(H, w)
    fs.sharded_sweep_finish(H, torch.rand(1, 256), bp, [torch.rand(1, 256)],
                            logarithmic=False)
    for wrapper in (fs.sharded_sweep_bp, fs.sharded_sweep_finish):
        assert wrapper.launches == 0 and not any(wrapper.launches_by_route.values())


def _it(plans, kernels):
    return {"launches_by_plan": plans, "cuda_kernels": kernels}


SPLIT = {"sharded_sweep_bp": 1, "sharded_sweep_finish": 1}


@pytest.mark.parametrize("plans, kernels, launches, ok", [
    # the grid's split sweep on the cluster route: 2 kernels an iteration
    ({"sharded_sweep_bp:cluster": 1, "sharded_sweep_finish:cluster": 1},
     {"split::bp_kernel<float, 1, 64>": 1, "split::finish_kernel<float, 1>": 1}, SPLIT, True),
    # the same calls with two_read's 6 kernels: not the cluster route's count
    ({"sharded_sweep_bp:cluster": 1, "sharded_sweep_finish:cluster": 1},
     {"two_read::transpose_w_kernel": 1, "two_read::bp_kernel<float, 1, true>": 1,
      "sum_partials_kernel": 2, "two_read::finish_kernel<float>": 1,
      "two_read::forward_kernel<float, 1, true>": 1}, SPLIT, False),
    # two_read's route: 3 kernels a call
    ({"sharded_sweep_bp:two_read": 1, "sharded_sweep_finish:two_read": 1},
     {"two_read::transpose_w_kernel": 1, "two_read::bp_kernel<float, 8, true>": 1,
      "sum_partials_kernel": 2, "two_read::finish_kernel<float>": 1,
      "two_read::forward_kernel<float, 8, true>": 1}, SPLIT, True),
    # a kernel missing from a call
    ({"sharded_sweep_bp:cluster": 1, "sharded_sweep_finish:cluster": 1},
     {"split::bp_kernel<float, 1, 64>": 1}, SPLIT, False),
    # the fused sweep's plans as before
    ({"fused_sweep:one_read": 1}, {"one_read::sweep_kernel<float, 1>": 1,
                                   "sum_partials_kernel": 1}, {"fused_sweep": 1}, True),
    ({"fused_sweep:two_read": 1}, {"two_read::bp_kernel<float, 16, true>": 1},
     {"fused_sweep": 1}, False),
    # counters moved, no kernel seen: a vacuous pass is a failure
    ({"sharded_sweep_bp:cluster": 1}, {}, {"sharded_sweep_bp": 1}, False),
], ids=["cluster", "cluster-with-6", "two_read", "cluster-missing", "one_read",
        "fused-short", "vacuous"])
def test_audit_holds_each_call_to_its_kernels(plans, kernels, launches, ok):
    assert (_agreement(_it(plans, kernels), launches) == []) is ok


def test_the_fused_plans_kernels_stay():
    assert KERNELS_PER_CALL == {"one_read": 2, "tensor_core": 4, "two_read": 5}
