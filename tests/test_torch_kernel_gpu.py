"""The CUDA fused-sweep kernel against its plain version, on the card.

Needs a CUDA device and ``nvcc``: every test is marked ``gpu`` and skips
without a card. Run on the card with
``python -m pytest -q -m gpu tests/test_torch_kernel_gpu.py``. This file
imports no JAX, so it runs where only PyTorch is installed.
"""

import pytest
import torch

from sartsolver_tpu_torch.models.sart import quantize_rtm
from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, fused_sweep_reference

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
