"""The numerics of the fused sweep's tensor-core plan, emulated on the CPU.

The plan (``csrc/fused_sweep.cu``, namespace ``tc``) splits each fp32
operand into three bf16 pieces, ``x_hi = bf16(x)``, ``x_mid = bf16(x -
x_hi)``, ``x_lo = bf16(x - x_hi - x_mid)``, multiplies each by the int8 codes
(exact in bf16) with products exact in fp32, and sums in fp32. The helper
below does the same in plain PyTorch; it is held against the JAX package's
Pallas kernel in interpret mode on int8 codes at B = 32, and the split
itself is held to recombine exactly.
"""

import numpy as np
import pytest
import torch

from sartsolver_tpu.ops.fused_sweep import fused_sweep as jax_fused_sweep

P, V, B = 64, 256, 32  # tile-aligned for the Pallas kernel; the probes' B
ALPHA, EPS = 0.7, 1e-7


def split3(x: torch.Tensor):
    """fp32 -> three bf16 pieces, as the kernel's ``split3``."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def split_contract(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ codes [K, N]`` as the tensor cores take it: each piece's
    products are exact in fp32 and every sum is fp32."""
    c = codes.to(torch.bfloat16).float()  # exact for |code| <= 127
    hi, mid, lo = split3(x)
    return (lo.float() @ c + mid.float() @ c) + hi.float() @ c


def split_sweep(codes, w, f, aux, scale, logarithmic):
    bp = split_contract(w, codes) * scale
    if logarithmic:
        vm, obs, *pen = aux
        f_new = f * ((obs + EPS) / (bp * vm + EPS)) ** ALPHA
        if pen:
            f_new = f_new * torch.exp(-pen[0])
    else:
        invd, *pen = aux
        f_new = f + invd * bp
        f_new = torch.clamp_min(f_new - pen[0] if pen else f_new, 0)
    return f_new, split_contract(f_new * scale, codes.T)


def _lin_update_int8(f_p, bp_p, s_p, invd_p, *pen_p):  # models/sart.py:1322-1324
    import jax.numpy as jnp

    upd = f_p + invd_p * (bp_p * s_p)
    if pen_p:
        upd = upd - pen_p[0]
    return jnp.maximum(upd, 0)


def _log_update_int8(f_p, bp_p, s_p, vm_p, obs_p, *pen_p):  # models/sart.py:1309-1311
    import jax.numpy as jnp

    ratio = ((obs_p + EPS) / (bp_p * s_p * vm_p + EPS)) ** ALPHA
    return f_p * ratio * jnp.exp(-pen_p[0]) if pen_p else f_p * ratio


@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
def test_split_sweep_matches_pallas_kernel_int8_b32(logarithmic, with_pen):
    rng = np.random.default_rng(5 + 2 * logarithmic + with_pen)
    codes = rng.integers(-127, 128, (P, V)).astype(np.int8)
    if logarithmic:
        codes = np.abs(codes).astype(np.int8)  # a ray-transfer matrix is non-negative
    scale = (rng.uniform(0.5, 1.5, (1, V)) / 127).astype(np.float32)
    w = rng.uniform(0.0 if logarithmic else -0.5, 1.0, (B, P)).astype(np.float32) / P
    f = rng.uniform(0.1, 2.0, (B, V)).astype(np.float32)
    if logarithmic:
        vm = (rng.uniform(size=(1, V)) > 0.1).astype(np.float32)
        aux = [vm, rng.uniform(0.1, 1.0, (B, V)).astype(np.float32) * vm]
    else:
        aux = [rng.uniform(0.0, 2.0, (1, V)).astype(np.float32)]
    if with_pen:
        aux.append(rng.uniform(-0.01, 0.01, (B, V)).astype(np.float32))
    want = jax_fused_sweep(codes, w, f, [scale] + aux,
                           _log_update_int8 if logarithmic else _lin_update_int8,
                           fwd_scale=0, interpret=True)
    t = torch.from_numpy
    got = split_sweep(t(codes), t(w), t(f), [t(a) for a in aux], t(scale), logarithmic)
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        # the same fp32 function, summed in another order: the kernel's
        # tolerance (1e-5 of the output's max) with room to spare
        np.testing.assert_allclose(g.numpy(), w_, rtol=0, atol=1e-6 * np.abs(w_).max())


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("decade", list(range(-30, 4)))
def test_split_recombines_exactly(decade, sign):
    """|x| in [10^decade, 10^(decade+1)), normal fp32: hi + mid + lo == x
    exactly in fp32, and each piece is at most half an ulp of the one above."""
    rng = np.random.default_rng(decade + 100)
    x = (sign * 10.0 ** rng.uniform(decade, decade + 1, 4096)).astype(np.float32)
    assert np.all(np.abs(x) >= np.finfo(np.float32).tiny)
    xt = torch.from_numpy(x)
    hi, mid, lo = split3(xt)
    back = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(back, xt)
    assert torch.all(mid.float().abs() <= hi.float().abs() * 2.0 ** -8)
    assert torch.all(lo.float().abs() <= mid.float().abs() * 2.0 ** -8)


def test_code_products_are_exact_in_fp32():
    """A bf16 piece times a code needs at most 8 + 8 significant bits."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1e3, 1e3, 4096).astype(np.float32))
    c = torch.from_numpy(rng.integers(-127, 128, 4096).astype(np.float32))
    for piece in split3(x):
        p32 = piece.float() * c
        assert torch.equal(p32.double(), piece.double() * c.double())
