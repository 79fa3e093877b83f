"""The fused sweep of sartsolver_tpu_torch against the JAX Pallas kernel.

On the CPU the wrapper runs its plain version (``fused_sweep_reference``);
it is held against the JAX ``fused_sweep`` in Pallas interpret mode with
update closures written exactly as ``models/sart.py`` writes them, and on
shapes the Pallas kernel refuses, against a numpy fp64 sweep. The CUDA
kernel itself is held against the plain version on the card, in
``test_torch_kernel_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from sartsolver_tpu.ops.fused_sweep import fused_sweep as jax_fused_sweep

from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, fused_sweep_reference

P, V = 24, 256  # tile-aligned for the Pallas kernel
ALPHA, EPS = 0.7, 1e-7


def _lin_update(f_p, bp_p, invd_p, *pen_p):  # models/sart.py:_lin_update
    import jax.numpy as jnp

    upd = f_p + invd_p * bp_p
    if pen_p:
        upd = upd - pen_p[0]
    return jnp.maximum(upd, 0)


def _log_update(f_p, bp_p, vm_p, obs_p, *pen_p):  # models/sart.py:_log_update
    import jax.numpy as jnp

    fit = bp_p * vm_p
    ratio = (obs_p + EPS) / (fit + EPS)
    ratio = ratio ** ALPHA
    return f_p * ratio * jnp.exp(-pen_p[0]) if pen_p else f_p * ratio


def _inputs(P, V, B, logarithmic, with_pen, aux_rows, seed=0):
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.0, 1.0, (P, V)).astype(np.float32)
    # the log update's weights are non-negative (fitted / ray length)
    w = rng.uniform(0.0 if logarithmic else -0.5, 1.0, (B, P)).astype(np.float32) / P
    f = rng.uniform(0.1, 2.0, (B, V)).astype(np.float32)
    rows = 1 if aux_rows == "1" else B
    if logarithmic:
        vm = (rng.uniform(size=(rows, V)) > 0.1).astype(np.float32)
        obs = rng.uniform(0.1, 1.0, (rows, V)).astype(np.float32)
        aux = [vm, obs]
    else:
        aux = [rng.uniform(0.0, 2.0, (rows, V)).astype(np.float32)]
    if with_pen:
        aux.append(rng.uniform(-0.01, 0.01, (rows, V)).astype(np.float32))
    return H, w, f, aux


def _torch_sweep(fn, H, w, f, aux, logarithmic):
    t = torch.as_tensor
    kw = dict(alpha=ALPHA, eps=EPS) if logarithmic else {}
    out = fn(t(H), t(w), t(f), [t(a) for a in aux], logarithmic=logarithmic, **kw)
    return [o.numpy() for o in out]


def _numpy_sweep(H, w, f, aux, logarithmic):
    """fp64 sweep, independent of both packages."""
    H, w, f = (np.asarray(a, np.float64) for a in (H, w, f))
    aux = [np.asarray(a, np.float64) for a in aux]
    bp = w @ H
    if logarithmic:
        vm, obs, *pen = aux
        f_new = f * ((obs + EPS) / (bp * vm + EPS)) ** ALPHA
        if pen:
            f_new = f_new * np.exp(-pen[0])
    else:
        invd, *pen = aux
        f_new = f + invd * bp - (pen[0] if pen else 0.0)
        f_new = np.maximum(f_new, 0.0)
    return f_new, f_new @ H.T


@pytest.mark.parametrize("aux_rows", ["1", "B"])
@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("B", [1, 3])
def test_plain_sweep_matches_pallas_kernel(B, logarithmic, with_pen, aux_rows):
    H, w, f, aux = _inputs(P, V, B, logarithmic, with_pen, aux_rows)
    want = jax_fused_sweep(H, w, f, aux, _log_update if logarithmic else _lin_update,
                           interpret=True)
    # the wrapper itself: CPU tensors take the plain version
    got = _torch_sweep(fused_sweep, H, w, f, aux, logarithmic)
    for g_, w_ in zip(got, want):
        # fp32 products summed in another order: a few ulp of the result
        np.testing.assert_allclose(g_, np.asarray(w_), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("B", [1, 3])
def test_plain_sweep_on_ragged_shapes(B, logarithmic, with_pen):
    """23 x 200 is refused by the Pallas kernel (8 x 128 tiles); the port
    takes any shape, checked against an fp64 numpy sweep."""
    H, w, f, aux = _inputs(23, 200, B, logarithmic, with_pen, "B", seed=1)
    got = _torch_sweep(fused_sweep_reference, H, w, f, aux, logarithmic)
    want = _numpy_sweep(H, w, f, aux, logarithmic)
    for g_, w_ in zip(got, want):
        # fp32 against fp64: relative to the output's scale
        np.testing.assert_allclose(g_, w_, rtol=1e-5, atol=1e-5 * np.abs(w_).max())


def test_wrapper_checks_its_inputs():
    H, w, f, aux = (torch.as_tensor(a) if not isinstance(a, list)
                    else [torch.as_tensor(x) for x in a]
                    for a in _inputs(P, V, 2, False, False, "1"))
    calls = fused_sweep.launches
    with pytest.raises(ValueError, match="fp32"):
        fused_sweep(H.double(), w.double(), f.double(), [a.double() for a in aux],
                    logarithmic=False)
    with pytest.raises(ValueError, match="fp32"):
        fused_sweep(H, w, f.double(), aux, logarithmic=False)
    with pytest.raises(ValueError, match="do not agree"):
        fused_sweep(H, w[:, :-1], f, aux, logarithmic=False)
    with pytest.raises(ValueError, match="aux panel"):
        fused_sweep(H, w, f, [aux[0][:, :-1]], logarithmic=False)
    with pytest.raises(ValueError, match="expected"):
        fused_sweep(H, w, f, aux, logarithmic=True)
    with pytest.raises(ValueError, match="unsupported device"):
        meta = [t.to("meta") for t in (H, w, f, aux[0])]
        fused_sweep(*meta[:3], [meta[3]], logarithmic=False)
    fused_sweep(H, w, f, aux, logarithmic=False)
    assert fused_sweep.launches == calls  # the plain version is no launch
