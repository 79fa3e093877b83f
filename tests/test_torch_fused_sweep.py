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


def _lin_update_int8(f_p, bp_p, s_p, invd_p, *pen_p):  # models/sart.py:1322-1324
    return _lin_update(f_p, bp_p * s_p, invd_p, *pen_p)


def _log_update_int8(f_p, bp_p, s_p, vm_p, obs_p, *pen_p):  # models/sart.py:1309-1311
    return _log_update(f_p, bp_p * s_p, vm_p, obs_p, *pen_p)


def _torch_sweep(fn, H, w, f, aux, logarithmic, scale=None):
    t = torch.as_tensor
    kw = dict(alpha=ALPHA, eps=EPS) if logarithmic else {}
    if scale is not None:
        kw["scale"] = t(scale)
    H = H if isinstance(H, torch.Tensor) else t(H)
    out = fn(H, t(w), t(f), [t(a) for a in aux], logarithmic=logarithmic, **kw)
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


# B = 8: the batch loops' batch (fp32 one_read, bf16 and int8 tensor_core on
# the card)
@pytest.mark.parametrize("aux_rows", ["1", "B"])
@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("B", [1, 3, 8])
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
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_plain_sweep_matches_pallas_kernel_reduced_storage(storage, B, logarithmic,
                                                           with_pen):
    """B3 (bf16 storage) and B4 (int8 codes with per-voxel scales): the
    Pallas kernel dequantizes exactly and computes in fp32, with the int8
    update closures of models/sart.py and fwd_scale=0; the port's wrapper
    takes the codes' scale as its own argument."""
    for g_, w_ in zip(*_reduced_storage_sweeps(storage, P, V, B, logarithmic, with_pen)):
        np.testing.assert_allclose(g_, np.asarray(w_), rtol=1e-6, atol=1e-7)


def _reduced_storage_sweeps(storage, P, V, B, logarithmic, with_pen):
    """(the port's wrapper, the interpreted Pallas kernel) on the same bf16
    or int8 sweep."""
    import jax.numpy as jnp

    H, w, f, aux = _inputs(P, V, B, logarithmic, with_pen, "1", seed=2)
    if storage == "bfloat16":
        jH, tH, scale = jnp.asarray(H, jnp.bfloat16), torch.from_numpy(H).to(torch.bfloat16), None
        want = jax_fused_sweep(jH, w, f, aux, _log_update if logarithmic else _lin_update,
                               interpret=True)
    else:
        rng = np.random.default_rng(3)
        codes = rng.integers(0, 128, (P, V)).astype(np.int8)
        scale = (rng.uniform(0.5, 1.5, (1, V)) / 127).astype(np.float32)
        jH, tH = codes, torch.from_numpy(codes)
        want = jax_fused_sweep(codes, w, f, [scale] + aux,
                               _log_update_int8 if logarithmic else _lin_update_int8,
                               fwd_scale=0, interpret=True)
    return _torch_sweep(fused_sweep, tH, w, f, aux, logarithmic, scale), want


def _assert_sum_close(got, want):
    """Within 1e-5 of the output's scale: the bar of long fp32 sums. A sum
    of n fp32 terms taken in one chain carries rounding of order
    sqrt(n) 2^-24 of its terms' magnitude, about 1e-6 for the 256 voxels of
    a fitted pixel or the 2048 pixels of the tall matrix's bp, in each
    implementation alone (torch's CPU GEMM takes one chain from 16 batch
    rows on), so two of them meet the B <= 8 tests' 1e-6 bar only by
    chance."""
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g_, w_, rtol=1e-5, atol=1e-5 * np.abs(w_).max())


# B = 16 and 32: fp32's batch loops past one_read (two_read on the card, one
# pass over H for every batch row)
@pytest.mark.parametrize("aux_rows", ["1", "B"])
@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("B", [16, 32])
def test_plain_sweep_matches_pallas_kernel_wide_batch(B, logarithmic, with_pen, aux_rows):
    H, w, f, aux = _inputs(P, V, B, logarithmic, with_pen, aux_rows)
    want = jax_fused_sweep(H, w, f, aux, _log_update if logarithmic else _lin_update,
                           interpret=True)
    _assert_sum_close(_torch_sweep(fused_sweep, H, w, f, aux, logarithmic), want)


@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("B", [16, 32])
@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_plain_sweep_matches_pallas_kernel_wide_batch_reduced_storage(storage, B, logarithmic,
                                                                      with_pen):
    _assert_sum_close(*_reduced_storage_sweeps(storage, P, V, B, logarithmic, with_pen))


# a tall matrix (P >> V): on the card P past one_read's 8192 runs two_read
# (a camera of more than about 90 x 90 pixels, the capacity demo's shapes)
TALL_P, TALL_V = 2048, 256


@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("B", [1, 3, 16])
def test_plain_sweep_matches_pallas_kernel_on_a_tall_matrix(B, logarithmic, with_pen):
    H, w, f, aux = _inputs(TALL_P, TALL_V, B, logarithmic, with_pen, "B", seed=6)
    want = jax_fused_sweep(H, w, f, aux, _log_update if logarithmic else _lin_update,
                           interpret=True)
    _assert_sum_close(_torch_sweep(fused_sweep, H, w, f, aux, logarithmic), want)


@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_plain_sweep_matches_pallas_kernel_on_a_tall_matrix_reduced_storage(
        storage, B, logarithmic):
    """bf16 at B = 1 and 2 and int8 at B = 1 to 3 run two_read on the card
    (the capacity demo's storage types); with the penalty."""
    _assert_sum_close(*_reduced_storage_sweeps(storage, TALL_P, TALL_V, B, logarithmic, True))


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


@pytest.mark.parametrize("logarithmic", [False, True])
@pytest.mark.parametrize("shape", [(8200, 40, 2), (24, 8300, 3), (8193, 8193, 1)])
def test_plain_sweep_in_blocks_matches_fp64(shape, logarithmic):
    """Past REFERENCE_BLOCK rows or columns the plain version walks H in
    blocks (panels of columns, each panel's bp summed over blocks of rows,
    the panels' forward products summed in order): the same sweep as an
    fp64 numpy one, at the tolerance of fp32 sums."""
    P_, V_, B = shape
    H, w, f, aux = _inputs(P_, V_, B, logarithmic, True, "B", seed=7)
    got = _torch_sweep(fused_sweep_reference, H, w, f, aux, logarithmic)
    want = _numpy_sweep(H, w, f, aux, logarithmic)
    _assert_sum_close(got, want)


def test_plain_sweep_in_one_block_is_one_product_each_way():
    """A matrix of one block each way takes one product each way: the bytes
    of w @ H and f_new @ H^T."""
    H, w, f, aux = (torch.as_tensor(a) if not isinstance(a, list)
                    else [torch.as_tensor(x) for x in a]
                    for a in _inputs(P, V, 3, False, True, "B", seed=8))
    f_new, fitted = fused_sweep_reference(H, w, f, aux, logarithmic=False)
    bp = w @ H
    want = torch.clamp_min(f + aux[0] * bp - aux[1], 0)
    assert torch.equal(f_new, want)
    assert torch.equal(fitted, want @ H.T)


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
    codes = torch.zeros(H.shape, dtype=torch.int8)
    scale = torch.ones((1, H.shape[1]))
    with pytest.raises(ValueError, match="need their scale.*missing"):
        fused_sweep(codes, w, f, aux, logarithmic=False)
    with pytest.raises(ValueError, match="only int8 codes.*given"):
        fused_sweep(H, w, f, aux, logarithmic=False, scale=scale)
    with pytest.raises(ValueError, match=r"\[1, 256\] expected"):
        fused_sweep(codes, w, f, aux, logarithmic=False, scale=scale[:, :-1])
    with pytest.raises(ValueError, match="fp32, bf16 or int8"):
        fused_sweep(H.half(), w, f, aux, logarithmic=False)
    with pytest.raises(ValueError, match="unsupported device"):
        meta = [t.to("meta") for t in (H, w, f, aux[0])]
        fused_sweep(*meta[:3], [meta[3]], logarithmic=False)
    fused_sweep(H, w, f, aux, logarithmic=False)
    assert fused_sweep.launches == calls  # the plain version is no launch


def _log_update_sched(f_p, bp_p, vm_p, obs_p, a_p, *pen_p):  # models/sart.py:1292-1307
    import jax.numpy as jnp

    fit = bp_p * vm_p
    ratio = ((obs_p + EPS) / (fit + EPS)) ** a_p
    return f_p * ratio * jnp.exp(-pen_p[0]) if pen_p else f_p * ratio


def _log_update_sched_int8(f_p, bp_p, s_p, vm_p, obs_p, a_p, *pen_p):
    return _log_update_sched(f_p, bp_p * s_p, vm_p, obs_p, a_p, *pen_p)


@pytest.mark.parametrize("alpha_rows", ["1", "B"])
@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_scheduled_log_update_matches_pallas_kernel(storage, with_pen, alpha_rows):
    """The scheduled log update: the port's exponent per row (``alpha_lane``
    [1, 1] or [B, 1]) against the JAX kernel's α aux panel ([1, V] or
    [B, V], the row's value in every column), for every storage type. One of
    the rows' exponents is 1, which both take as a power."""
    import jax.numpy as jnp

    B = 3
    H, w, f, aux = _inputs(P, V, B, True, with_pen, "B", seed=4)
    lanes = (np.array([[0.8]], np.float32) if alpha_rows == "1"
             else np.array([[0.9], [1.0], [0.73]], np.float32))
    panel = np.broadcast_to(lanes, (lanes.shape[0], V)).copy()
    jaux = aux[:2] + [panel] + aux[2:]
    scale = None
    if storage == "float32":
        tH = H
        want = jax_fused_sweep(H, w, f, jaux, _log_update_sched, interpret=True)
    elif storage == "bfloat16":
        tH = torch.from_numpy(H).to(torch.bfloat16)
        want = jax_fused_sweep(jnp.asarray(H, jnp.bfloat16), w, f, jaux, _log_update_sched,
                               interpret=True)
    else:
        rng = np.random.default_rng(5)
        tH = rng.integers(0, 128, (P, V)).astype(np.int8)
        scale = (rng.uniform(0.5, 1.5, (1, V)) / 127).astype(np.float32)
        want = jax_fused_sweep(tH, w, f, [scale] + jaux, _log_update_sched_int8,
                               fwd_scale=0, interpret=True)
        tH = torch.from_numpy(tH)
    t = torch.as_tensor
    got = fused_sweep(tH if isinstance(tH, torch.Tensor) else t(tH), t(w), t(f),
                      [t(a) for a in aux], logarithmic=True, eps=EPS,
                      scale=None if scale is None else t(scale), alpha_lane=t(lanes))
    for g_, w_ in zip(got, want):
        # fp32 products summed in another order: a few ulp of the result
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-6, atol=1e-7)


def test_alpha_lane_is_checked():
    H, w, f, aux = (torch.as_tensor(a) if not isinstance(a, list)
                    else [torch.as_tensor(x) for x in a]
                    for a in _inputs(P, V, 2, True, False, "1"))
    with pytest.raises(ValueError, match=r"alpha_lane of shape \(3, 1\)"):
        fused_sweep(H, w, f, aux, logarithmic=True, alpha_lane=torch.ones(3, 1))
    with pytest.raises(ValueError, match=r"\[1, 1\] or \[2, 1\]"):
        fused_sweep(H, w, f, aux, logarithmic=True, alpha_lane=torch.ones(2))
    with pytest.raises(ValueError, match="linear update folds"):
        fused_sweep(H, w, f, aux[:1], logarithmic=False, alpha_lane=torch.ones(2, 1))
    with pytest.raises(ValueError, match="fp32"):
        fused_sweep(H, w, f, aux, logarithmic=True,
                    alpha_lane=torch.ones(2, 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="one device"):
        fused_sweep(H, w, f, aux, logarithmic=True,
                    alpha_lane=torch.ones(2, 1, device="meta"))
