"""The CUDA fused-sweep kernel against its plain version, on the card.

Needs a CUDA device and ``nvcc``: every test is marked ``gpu`` and skips
without a card. Run on the card with
``python -m pytest -q -m gpu tests/test_torch_kernel_gpu.py``. This file
imports no JAX, so it runs where only PyTorch is installed.

Every plan of ``plan_sweep`` is held against the plain version here: the
default plan of each shape, and each plan forced through ``_sweep`` (the
old ``two_read`` path at the shapes the new plans took over).
"""

import pytest
import torch

from sartsolver_tpu_torch.models.sart import quantize_rtm
from sartsolver_tpu_torch.ops.fused_sweep import (
    ONE_READ_MIN_P, PLANS, _kernel_call,
    _sweep, fused_sweep, fused_sweep_reference, plan_sweep,
)

ALPHA, EPS = 0.7, 1e-7


def _inputs(P, V, B, logarithmic, with_pen, seed, storage="float32"):
    """Random sweep inputs on the card; ``H`` in the storage dtype and, for
    int8, the codes' ``scale`` [1, V] (None otherwise)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, generator=g, device="cuda") * (hi - lo) + lo

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


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("shape", [(8192, 65536, 1), (1000, 3001, 3), (24, 256, 2)])
def test_kernel_matches_plain_version(shape, logarithmic, with_pen, storage):
    """Max error within 1e-5 of the output's max (fp32 sums taken in
    another order), repeat launches byte-identical, the counts advanced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    P, V, B = shape
    H, w, f, aux, scale = _inputs(P, V, B, logarithmic, with_pen, seed=P + V + B,
                                  storage=storage)
    kw = dict(alpha=ALPHA, eps=EPS) if logarithmic else {}
    before = fused_sweep.launches
    before_storage = fused_sweep.launches_by_storage[storage]
    out1 = fused_sweep(H, w, f, aux, logarithmic=logarithmic, scale=scale, **kw)
    out2 = fused_sweep(H, w, f, aux, logarithmic=logarithmic, scale=scale, **kw)
    ref = fused_sweep_reference(H, w, f, aux, logarithmic=logarithmic, scale=scale, **kw)
    torch.cuda.synchronize()
    assert fused_sweep.launches == before + 2
    assert fused_sweep.launches_by_storage[storage] == before_storage + 2
    for a, b, r in zip(out1, out2, ref):
        assert torch.equal(a, b)
        assert torch.isfinite(r).all()
        err = float((a - r).abs().max())
        assert err <= 1e-5 * float(r.abs().max()), err


@pytest.mark.gpu
def test_kernel_refuses_other_dtypes_and_layouts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, w, f, aux, _ = _inputs(64, 512, 2, False, False, seed=1)
    codes, scale = quantize_rtm(H)
    with pytest.raises(ValueError, match="fp32, bf16 or int8"):
        fused_sweep(H.half(), w, f, aux, logarithmic=False)
    with pytest.raises(ValueError, match="int8 codes need their scale.*missing"):
        fused_sweep(codes, w, f, aux, logarithmic=False)
    with pytest.raises(ValueError, match="only int8 codes.*given"):
        fused_sweep(H, w, f, aux, logarithmic=False, scale=scale[None, :])
    with pytest.raises(ValueError, match="fp32"):
        fused_sweep(codes, w, f, aux, logarithmic=False, scale=scale[None, :].double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_sweep(H.t().contiguous().t(), w, f, aux, logarithmic=False)


def _check_plan(plan, P, V, B, logarithmic, with_pen, storage, seed, expect_default):
    """``plan`` forced: within 1e-5 of the output's max, repeat launches
    byte-identical, the plan's count advanced by 2; ``expect_default``: the
    shape's own plan is ``plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert (plan_sweep(P, V, B, storage) == plan) == expect_default
    H, w, f, aux, scale = _inputs(P, V, B, logarithmic, with_pen, seed=seed, storage=storage)
    kw = dict(alpha=ALPHA, eps=EPS) if logarithmic else {}
    before = fused_sweep.launches_by_plan[plan]
    out1 = _sweep(H, w, f, aux, logarithmic=logarithmic, scale=scale, plan=plan, **kw)
    out2 = _sweep(H, w, f, aux, logarithmic=logarithmic, scale=scale, plan=plan, **kw)
    ref = fused_sweep_reference(H, w, f, aux, logarithmic=logarithmic, scale=scale, **kw)
    torch.cuda.synchronize()
    assert fused_sweep.launches_by_plan[plan] == before + 2
    for a, b, r in zip(out1, out2, ref):
        assert torch.equal(a, b)
        assert torch.isfinite(r).all()
        err = float((a - r).abs().max())
        assert err <= 1e-5 * float(r.abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("storage,shape", [
    (st, shape) for st in ("int8", "bfloat16")
    for shape in ((8192, 65536, 8), (8192, 65536, 16), (8192, 65536, 19), (8192, 65536, 32),
                  (1000, 3008, 19))] + [("bfloat16", (8192, 65536, 5))])
def test_tensor_core_plan_matches_plain_version(storage, shape, logarithmic, with_pen):
    """int8 codes and bf16 storage at large B on the tensor cores (bf16 from
    B = 5, where its one_read ends; 1000 x 3008 x 19: ragged P and B)."""
    _check_plan("tensor_core", *shape, logarithmic, with_pen, storage,
                seed=sum(shape) + 2 * logarithmic + with_pen, expect_default=True)


@pytest.mark.gpu
@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("storage,B", [(st, B) for st in ("float32", "bfloat16", "int8")
                                       for B in (1, 3, 4)]
                         + [("float32", 5), ("float32", 8)])
@pytest.mark.parametrize("PV", [(8192, 65536), (8191, 4096), ("edge", 4096), (1000, 3008)])
def test_one_read_plan_matches_plain_version(PV, storage, B, logarithmic, with_pen):
    """Every storage at small B through the cluster kernel (B = 4: int8's
    instance with two slabs; fp32 B = 5 and 8: two slabs, the next one issued
    at the top of a panel): the main shape (P at the plan's upper limit), a
    ragged P just under it, P at the storage's lower edge of the rule, and a
    small shape that the rule leaves to two_read (forced)."""
    P, V = PV
    if P == "edge":
        P = ONE_READ_MIN_P[storage]
    _check_plan("one_read", P, V, B, logarithmic, with_pen, storage,
                seed=P + V + B + 2 * logarithmic + with_pen,
                expect_default=P >= ONE_READ_MIN_P[storage])


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("logarithmic", [False, True])
def test_two_read_forced_at_the_new_plans_shapes(logarithmic, storage):
    """two_read stays covered where the other plans took over: every
    storage at the main shape (B = 1, one_read) and at the batch loops'
    B = 8 (fp32 one_read, bf16 and int8 tensor_core), bf16 and int8 also at
    the probes' B = 32 (tensor_core)."""
    _check_plan("two_read", 8192, 65536, 1, logarithmic, True, storage, seed=5 + logarithmic,
                expect_default=False)
    _check_plan("two_read", 8192, 65536, 8, logarithmic, True, storage, seed=7 + logarithmic,
                expect_default=False)
    if storage != "float32":
        _check_plan("two_read", 8192, 65536, 32, logarithmic, True, storage,
                    seed=6 + logarithmic, expect_default=False)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("shape", [(8192, 65536, 8), (1000, 3001, 8)])
def test_two_read_nb8_equals_two_calls_of_b4(shape, logarithmic, storage):
    """two_read's pass of 8 batch rows gives each row the bytes that a pass
    of 4 gives it: the batch changes no row's order of summation (the bp
    pass sums a split's rows in order, the forward pass a row's pieces, the
    splits follow from P and V alone). B = 8 forced against rows 0-3 and 4-7
    as two calls of B = 4, with per-row aux panels and the scheduled
    exponent per row."""
    _check_rows_in_calls(shape, logarithmic, storage, [slice(0, 4), slice(4, 8)])


def _check_rows_in_calls(shape, logarithmic, storage, parts):
    """B rows forced through two_read in one call, byte-equal to the same
    rows cut into ``parts`` (slices of the batch) as calls of their own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    P, V, B = shape
    H, w, f, aux, scale = _inputs(P, V, B, logarithmic, True, seed=P + V + logarithmic,
                                  storage=storage)
    aux = [a.expand(B, V).contiguous() for a in aux]
    kw = dict(logarithmic=logarithmic, scale=scale, eps=EPS)
    lanes = None
    if logarithmic:
        lanes = (0.9 - 0.01 * torch.arange(B, device="cuda", dtype=torch.float32))[:, None]
    whole = _sweep(H, w, f, aux, plan="two_read", alpha_lane=lanes, **kw)
    cut = [_sweep(H, w[r].contiguous(), f[r].contiguous(), [a[r].contiguous() for a in aux],
                  plan="two_read", alpha_lane=None if lanes is None else lanes[r].contiguous(),
                  **kw)
           for r in parts]
    torch.cuda.synchronize()
    for k in range(2):
        assert torch.equal(whole[k], torch.cat([c[k] for c in cut]))


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("shape", [(8192, 65536, 16), (8192, 65536, 32), (1000, 3001, 32),
                                   (9000, 3001, 16)])
def test_two_read_wide_batch_equals_halves(shape, logarithmic, storage):
    """B = 16 and 32 (one pass over H for every row) byte-equal to two calls
    of B / 2."""
    B = shape[2]
    _check_rows_in_calls(shape, logarithmic, storage, [slice(0, B // 2), slice(B // 2, B)])


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("shape", [(8192, 65536, 16), (8192, 65536, 32), (1000, 3001, 19)])
def test_two_read_wide_batch_equals_each_row_alone(shape, logarithmic, storage):
    """Every row of B = 16, 19 and 32 byte-equal to its own call at B = 1."""
    _check_rows_in_calls(shape, logarithmic, storage,
                         [slice(b, b + 1) for b in range(shape[2])])


# two_read's own shapes: fp32 past one_read's B = 8 (B = 16, 32, and 40:
# two batch passes of 32), P past one_read's 8192 (a taller world, a tall and
# narrow matrix, bf16 at B = 2 and int8 at B = 3), ragged P, V and B (V odd:
# element-wise loads of H); bf16 and int8 also at B = 16 and 32 forced
TWO_READ_SHAPES = [
    ("float32", (8192, 65536, 16)), ("float32", (8192, 65536, 32)),
    ("float32", (16384, 65536, 1)), ("float32", (16384, 65536, 8)),
    ("float32", (65536, 16384, 1)), ("float32", (1000, 3001, 40)),
    ("bfloat16", (16384, 65536, 2)), ("int8", (16384, 65536, 3)),
    ("bfloat16", (8192, 65536, 16)), ("int8", (8192, 65536, 32)),
] + [(st, shape) for st in ("float32", "bfloat16", "int8")
     for shape in ((9000, 3001, 3), (1000, 3001, 19), (1000, 3000, 5))]


@pytest.mark.gpu
@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("storage,shape", TWO_READ_SHAPES)
def test_two_read_plan_matches_plain_version(storage, shape, logarithmic, with_pen):
    P, V, B = shape
    _check_plan("two_read", P, V, B, logarithmic, with_pen, storage,
                seed=P + V + B + 2 * logarithmic + with_pen,
                expect_default=plan_sweep(P, V, B, storage) == "two_read")


@pytest.mark.gpu
def test_kernel_refuses_a_plan_whose_preconditions_fail():
    """At the C boundary (the Python check bypassed): cudaErrorInvalidValue
    (1) and no other plan run in its place; through the wrapper: ValueError."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, w, f, aux, _ = _inputs(64, 512, 9, False, False, seed=3)
    codes, scale = quantize_rtm(H)
    bf16 = H.to(torch.bfloat16)
    kw = dict(logarithmic=False, alpha=1.0, eps=0.0)
    refused = [  # (H, scale, B, V, plan)
        (H, None, 9, 512, "one_read"),                  # fp32: B = 9 > 8
        (H, None, 4, 500, "one_read"),                  # fp32: V % 16 != 0
        (H, None, 8, 500, "one_read"),                  # fp32, B = 8: V % 16 != 0
        (bf16, None, 4, 496, "one_read"),               # bf16: V % 32 != 0
        (bf16, None, 5, 512, "one_read"),               # bf16, B = 5 > 4
        (codes, scale[None, :], 4, 480, "one_read"),    # int8: V % 64 != 0
        (codes, scale[None, :], 5, 512, "one_read"),    # int8, B = 5 > 4
        (H, None, 5, 512, "tensor_core"),               # fp32 storage
        (codes, scale[None, :], 5, 500, "tensor_core"),  # V % 16 != 0
        (bf16, None, 8, 504, "tensor_core"),            # bf16: V % 16 != 0
        (H, None, 5, 512, 9),                           # no such plan
    ]
    for rtm, sc, B, V, plan in refused:
        code = PLANS.get(plan, plan)
        err, _, _ = _kernel_call(rtm[:, :V].contiguous(), w[:B].contiguous(),
                                 f[:B, :V].contiguous(), [a[:, :V].contiguous() for a in aux],
                                 scale=None if sc is None else sc[:, :V].contiguous(),
                                 plan_code=code, **kw)
        assert err == 1, (rtm.dtype, B, V, plan, err)
    with pytest.raises(ValueError, match="one_read needs B <= 8"):
        _sweep(H, w, f, aux, plan="one_read", **kw)
    with pytest.raises(ValueError, match="one_read needs B <= 4"):
        _sweep(bf16, w[:5].contiguous(), f[:5].contiguous(), aux, plan="one_read", **kw)
    with pytest.raises(ValueError, match="tensor_core needs V a multiple of 16"):
        _sweep(bf16[:, :504].contiguous(), w[:8].contiguous(), f[:8, :504].contiguous(),
               [a[:, :504].contiguous() for a in aux], plan="tensor_core", **kw)
    with pytest.raises(ValueError, match="V a multiple of 64 for int8"):
        _sweep(codes[:, :480].contiguous(), w[:4].contiguous(), f[:4, :480].contiguous(),
               [a[:, :480].contiguous() for a in aux], scale=scale[None, :480].contiguous(),
               plan="one_read", **kw)
    with pytest.raises(ValueError, match="tensor_core takes bf16 or int8"):
        _sweep(H, w, f, aux, plan="tensor_core", **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("alpha_rows", ["1", "B"])
@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("plan,storage,shape", [
    ("one_read", "float32", (8192, 65536, 1)), ("one_read", "bfloat16", (8192, 65536, 4)),
    ("one_read", "int8", (8192, 65536, 4)), ("one_read", "int8", (1000, 3008, 3)),
    ("two_read", "float32", (8192, 65536, 8)), ("two_read", "bfloat16", (8192, 65536, 8)),
    ("two_read", "int8", (1000, 3001, 3)), ("tensor_core", "int8", (8192, 65536, 8)),
    ("tensor_core", "int8", (1000, 3008, 19)),
    ("one_read", "float32", (8192, 65536, 8)), ("one_read", "float32", (8192, 65536, 5)),
    ("one_read", "float32", (8191, 4096, 8)), ("tensor_core", "bfloat16", (8192, 65536, 8)),
    ("tensor_core", "bfloat16", (8192, 65536, 32)), ("tensor_core", "bfloat16", (1000, 3008, 19)),
    ("two_read", "float32", (8192, 65536, 16)), ("two_read", "float32", (8192, 65536, 32)),
    ("two_read", "float32", (65536, 16384, 1)), ("two_read", "float32", (9000, 3001, 3)),
    ("two_read", "bfloat16", (1000, 3001, 19)), ("two_read", "int8", (16384, 65536, 3)),
])
def test_scheduled_log_update_matches_plain_version(plan, storage, shape, with_pen,
                                                    alpha_rows):
    """The scheduled log update (``alpha_lane``, one exponent per row, each
    row's distinct) on every plan: within 1e-5 of the output's max, repeat
    launches byte-identical, the plan's counts and its scheduled count
    advanced by 2; the exponent changes no plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    P, V, B = shape
    H, w, f, aux, scale = _inputs(P, V, B, True, with_pen, seed=P + B + with_pen,
                                  storage=storage)
    rows = 1 if alpha_rows == "1" else B
    lanes = (0.9 - 0.05 * torch.arange(rows, device="cuda", dtype=torch.float32))[:, None]
    kw = dict(logarithmic=True, eps=EPS, alpha=ALPHA, scale=scale, alpha_lane=lanes)
    before = fused_sweep.launches_by_plan[plan]
    before_sched = fused_sweep.scheduled_by_plan[plan]
    out1 = _sweep(H, w, f, aux, plan=plan, **kw)
    out2 = fused_sweep(H, w, f, aux, **kw) if plan_sweep(P, V, B, storage) == plan else \
        _sweep(H, w, f, aux, plan=plan, **kw)
    ref = fused_sweep_reference(H, w, f, aux, **kw)
    torch.cuda.synchronize()
    assert fused_sweep.launches_by_plan[plan] == before + 2
    assert fused_sweep.scheduled_by_plan[plan] == before_sched + 2
    for a, b, r in zip(out1, out2, ref):
        assert torch.equal(a, b)
        assert torch.isfinite(r).all()
        err = float((a - r).abs().max())
        assert err <= 1e-5 * float(r.abs().max()), err
    # the literal exponent is a different function: the lanes really reach the update
    lit = _sweep(H, w, f, aux, plan=plan, logarithmic=True, eps=EPS, alpha=ALPHA, scale=scale)
    assert not torch.equal(lit[0], out1[0])


@pytest.mark.gpu
def test_kernel_refuses_a_misshapen_alpha_lane():
    """At the C boundary: an exponent per row on the linear update, or of
    neither 1 nor B rows, is cudaErrorInvalidValue (1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, w, f, aux, _ = _inputs(64, 512, 4, True, False, seed=9)
    lanes = torch.ones((3, 1), device="cuda")
    err, _, _ = _kernel_call(H, w, f, aux, logarithmic=True, alpha=1.0, eps=EPS, scale=None,
                             plan_code=PLANS["two_read"], alpha_lane=lanes)
    assert err == 1
    err, _, _ = _kernel_call(H, w, f, aux[:1], logarithmic=False, alpha=1.0, eps=0.0,
                             scale=None, plan_code=PLANS["two_read"], alpha_lane=lanes[:1])
    assert err == 1
