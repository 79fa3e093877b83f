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
    ONE_READ_MIN_P, PLANS, _kernel_call, _sweep, fused_sweep, fused_sweep_reference,
    plan_sweep,
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
@pytest.mark.parametrize("shape", [(8192, 65536, 8), (8192, 65536, 16), (8192, 65536, 19),
                                   (8192, 65536, 32), (1000, 3008, 19)])
def test_tensor_core_plan_matches_plain_version(shape, logarithmic, with_pen):
    """int8 codes at large B on the tensor cores (1000 x 3008 x 19: ragged P
    and B)."""
    _check_plan("tensor_core", *shape, logarithmic, with_pen, "int8",
                seed=sum(shape) + 2 * logarithmic + with_pen, expect_default=True)


@pytest.mark.gpu
@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("PV", [(8192, 65536), (8191, 4096), (ONE_READ_MIN_P, 4096),
                                (1000, 3008)])
def test_one_read_plan_matches_plain_version(PV, B, logarithmic, with_pen):
    """fp32 at small B through the cluster kernel: the main shape (P at the
    plan's upper limit), a ragged P just under it, P at the rule's lower
    edge, and a small shape that the rule leaves to two_read (forced)."""
    _check_plan("one_read", *PV, B, logarithmic, with_pen, "float32",
                seed=sum(PV) + B + 2 * logarithmic + with_pen,
                expect_default=PV[0] >= ONE_READ_MIN_P)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["float32", "int8"])
@pytest.mark.parametrize("logarithmic", [False, True])
def test_two_read_forced_at_the_new_plans_shapes(logarithmic, storage):
    """The old path stays covered where the new plans took over: fp32 at the
    main shape (B = 1), int8 at the probes' B = 32."""
    B = 1 if storage == "float32" else 32
    _check_plan("two_read", 8192, 65536, B, logarithmic, True, storage, seed=5 + logarithmic,
                expect_default=False)


@pytest.mark.gpu
def test_kernel_refuses_a_plan_whose_preconditions_fail():
    """At the C boundary (the Python check bypassed): cudaErrorInvalidValue
    (1) and no other plan run in its place; through the wrapper: ValueError."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, w, f, aux, _ = _inputs(64, 512, 5, False, False, seed=3)
    codes, scale = quantize_rtm(H)
    kw = dict(logarithmic=False, alpha=1.0, eps=0.0)
    refused = [
        (H, w, None, PLANS["one_read"]),                       # B = 5 > 4
        (H[:, :500].contiguous(), w, None, PLANS["one_read"]),  # V % 16 != 0
        (H, w, None, PLANS["tensor_core"]),                    # fp32 storage
        (codes[:, :500].contiguous(), w, scale[None, :500].contiguous(),
         PLANS["tensor_core"]),                                # V % 16 != 0
        (codes, w, scale[None, :], PLANS["one_read"]),          # int8 storage
        (H, w, None, 9),                                       # no such plan
    ]
    for rtm, ww, sc, code in refused:
        V = rtm.shape[1]
        err, _, _ = _kernel_call(rtm, ww, f[:, :V].contiguous(),
                                 [a[:, :V].contiguous() for a in aux], scale=sc,
                                 plan_code=code, **kw)
        assert err == 1, (rtm.dtype, tuple(rtm.shape), code, err)
    with pytest.raises(ValueError, match="one_read needs B <= 4"):
        _sweep(H, w, f, aux, plan="one_read", **kw)
    with pytest.raises(ValueError, match="tensor_core takes int8 codes"):
        _sweep(H, w, f, aux, plan="tensor_core", **kw)
