"""Reduced-precision RTM storage of sartsolver_tpu_torch against the JAX package.

int8 codes and scales, the int8 ray stats, the CLI's host ingest,
the exact int8 projections, the bf16 block-wise projections, and problems
built from every storage type (``make_problem``, ``problem_from_numpy``).
The same inputs, made from a numpy seed, go through both packages on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sartsolver_tpu.config import SolverOptions as JaxOptions
from sartsolver_tpu.models import sart as jsart
from sartsolver_tpu.ops import projection as jproj

from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.models import sart as tsart
from sartsolver_tpu_torch.models.convert import problem_from_numpy
from sartsolver_tpu_torch.ops import projection as tproj

P, V = 24, 256


def _matrix(seed, P=P, V=V):
    """A non-negative RTM with two all-zero columns and one row of zeros,
    plus a column whose scale is exactly 1 and whose values sit on the
    rounding ties (0.5, 1.5, 2.5, ...), where round-half-to-even matters."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.0, 1.0, (P, V)).astype(np.float32)
    H[:, :2] = 0.0
    H[3, :] = 0.0
    H[:, 5] = np.arange(P, dtype=np.float32) + 0.5
    H[0, 5] = 127.0
    return H


def _jax_opts(opts):
    return JaxOptions(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)})


@pytest.mark.parametrize("blocks", ["whole", "rows of 3"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rtm_matches_jax_code_for_code(seed, blocks, monkeypatch):
    """Codes and scales equal, quantized whole or a block of rows at a time
    (the recipe is elementwise once the column maxima are known)."""
    if blocks != "whole":
        monkeypatch.setattr(tsart, "_CHUNK_ELEMENTS", 3 * V)
    H = _matrix(seed)
    want_codes, want_scale = (np.asarray(a) for a in jsart.quantize_rtm(H))
    codes, scale = tsart.quantize_rtm(torch.from_numpy(H))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(scale.numpy(), want_scale)
    assert (scale.numpy()[:2] == 1.0).all() and scale.numpy()[5] == 1.0
    # the tie column: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 3.5 -> 4
    assert codes.numpy()[1:5, 5].tolist() == [2, 2, 4, 4]


def test_host_ingest_matches_jax_host_ingest(tmp_path, monkeypatch):
    """The port's CLI ingest (the whole fp32 matrix read on the host, then
    make_problem quantizing it there) against the JAX CLI's two-pass host
    ingest (``read_and_quantize_rtm``, numpy's ``rint``) on the fixture
    world's files: the same codes and scales."""
    import jax

    import fixtures as fx
    from sartsolver_tpu.io.hdf5files import categorize_input_files, sort_rtm_files
    from sartsolver_tpu.parallel.mesh import make_mesh
    from sartsolver_tpu.parallel.multihost import read_and_quantize_rtm

    from sartsolver_tpu_torch.io.raytransfer import read_rtm_block

    paths, H, *_ = fx.write_world(str(tmp_path))
    files, _ = categorize_input_files([paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"]])
    files = sort_rtm_files(files)
    P_, V_ = H.shape
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    codes, scale = read_and_quantize_rtm(files, "with_reflections", P_, V_, mesh,
                                         chunk_rows=3)
    monkeypatch.setattr(tsart, "_CHUNK_ELEMENTS", 3 * V_)
    host = read_rtm_block(files, "with_reflections", P_, V_)
    prob = tsart.make_problem(host, opts=SolverOptions(rtm_dtype="int8"), device="cpu")
    # the JAX buffers are padded to its tile alignment
    np.testing.assert_array_equal(prob.rtm.numpy(), np.asarray(codes)[:P_, :V_])
    np.testing.assert_array_equal(prob.rtm_scale.numpy(), np.asarray(scale)[:V_])


@pytest.mark.parametrize("blocks", ["whole", "rows of 5"])
def test_int8_ray_stats_match_jax(blocks, monkeypatch):
    """Density equal (int32 column sums, times the scale), length to 1e-6;
    taken a block of rows at a time or whole, the same."""
    if blocks != "whole":
        monkeypatch.setattr(tsart, "_CHUNK_ELEMENTS", 5 * V)
    H = _matrix(3)
    codes, scale = jsart.quantize_rtm(H)
    want = jsart.compute_ray_stats_int8(codes, scale, dtype=jnp.float32)
    got = tsart.compute_ray_stats_int8(torch.from_numpy(np.array(codes)),
                                       torch.from_numpy(np.array(scale)),
                                       dtype=torch.float32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)


@pytest.mark.parametrize("shape", [(P, V), (2100, 2500)])
@pytest.mark.parametrize("B", [1, 3])
def test_int8_projections_match_jax_exactly(B, shape):
    """The integer contraction is exact on both sides, so the projections
    are equal; 2100 x 2500 takes several exact partial sums each way."""
    rng = np.random.default_rng(B)
    H = _matrix(4, *shape)
    codes, scale = (np.array(a) for a in jsart.quantize_rtm(H))
    w = rng.uniform(-0.5, 1.0, (B, shape[0])).astype(np.float32)
    f = rng.uniform(0.0, 2.0, (B, shape[1])).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        tproj.int8_back_project(t(codes), t(scale), t(w)).numpy(),
        np.asarray(jsart.int8_back_project(codes, scale, w)))
    np.testing.assert_array_equal(
        tproj.int8_forward_project(t(codes), t(scale), t(f)).numpy(),
        np.asarray(jsart.int8_forward_project(codes, scale, f)))


@pytest.mark.parametrize("compute", [torch.float32, torch.float64])
def test_reduced_precision_projections_match_jax(compute, monkeypatch):
    """A bf16 matrix is upcast exactly, one block at a time: the result is
    the JAX package's mixed-dtype contraction, however many blocks."""
    monkeypatch.setattr(tproj, "PANEL_ELEMENTS", 7 * V)  # 7-row / 1-column blocks
    rng = np.random.default_rng(5)
    H = _matrix(5)
    Hb = jnp.asarray(H, jnp.bfloat16)
    Ht = torch.from_numpy(H).to(torch.bfloat16)
    np.testing.assert_array_equal(Ht.view(torch.int16).numpy(),
                                  np.asarray(Hb).view(np.int16))
    npd = np.float32 if compute == torch.float32 else np.float64
    w = rng.uniform(-0.5, 1.0, (3, P)).astype(npd)
    f = rng.uniform(0.0, 2.0, (3, V)).astype(npd)
    tol = 1e-6 if compute == torch.float32 else 1e-13
    got_b = tproj.back_project(Ht, torch.from_numpy(w))
    got_f = tproj.forward_project(Ht, torch.from_numpy(f))
    assert got_b.dtype == got_f.dtype == compute
    np.testing.assert_allclose(got_b.numpy(), np.asarray(
        jproj.back_project(Hb, w, accum_dtype=npd)), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(
        jproj.forward_project(Hb, f, accum_dtype=npd)), rtol=tol)


@pytest.mark.parametrize("given", ["host", "codes"])
def test_int8_problem_matches_jax(given):
    """make_problem quantizes a host matrix on the host, or takes codes with
    their scales; either way the codes, scales and stats are JAX's."""
    H = _matrix(6)
    opts = SolverOptions(rtm_dtype="int8")
    jprob = jsart.make_problem(H, None, opts=_jax_opts(opts))
    if given == "host":
        prob = tsart.make_problem(H, opts=opts, device="cpu")
    else:
        codes, scale = tsart.quantize_rtm(H)
        prob = tsart.make_problem(codes.numpy(), opts=opts, device="cpu",
                                  rtm_scale=scale.numpy())
    assert prob.rtm.dtype == torch.int8 and prob.rtm_scale.dtype == torch.float32
    np.testing.assert_array_equal(prob.rtm.numpy(), np.asarray(jprob.rtm))
    np.testing.assert_array_equal(prob.rtm_scale.numpy(), np.asarray(jprob.rtm_scale))
    np.testing.assert_array_equal(prob.ray_density.numpy(), np.asarray(jprob.ray_density))
    np.testing.assert_allclose(prob.ray_length.numpy(), np.asarray(jprob.ray_length),
                               rtol=1e-6)


def test_int8_problem_refusals():
    opts = SolverOptions(rtm_dtype="int8")
    huge = np.zeros((tsart.INT8_MAX_CONTRACTION + 1, 1), np.float32)
    with pytest.raises(ValueError, match="int32-accumulation"):
        tsart.make_problem(huge, opts=opts, device="cpu")
    H = _matrix(7)
    codes, scale = tsart.quantize_rtm(H)
    with pytest.raises(ValueError, match="pre-quantized int8 codes"):
        tsart.make_problem(H, opts=opts, device="cpu", rtm_scale=scale)
    with pytest.raises(ValueError, match="does not fit"):
        tsart.make_problem(codes, opts=opts, device="cpu", rtm_scale=scale[:-1])
    with pytest.raises(ValueError, match="only valid with rtm_dtype='int8'"):
        tsart.make_problem(H, opts=SolverOptions(), device="cpu", rtm_scale=scale)
    with pytest.raises(ValueError, match="dtype='float32'"):
        SolverOptions(rtm_dtype="int8", dtype="float64")


@pytest.mark.parametrize("given", ["float32", "bfloat16"])
def test_bf16_problem_matches_jax(given):
    """From an fp32 matrix the stats are taken before the cast (JAX's
    make_problem); from a bf16 matrix they are the stored matrix's (the
    JAX CLI's rule, which the port's CLI gets by handing over bf16)."""
    H = _matrix(8)
    opts = SolverOptions(rtm_dtype="bfloat16")
    src = H if given == "float32" else jnp.asarray(H, jnp.bfloat16)
    jprob = jsart.make_problem(src, None, opts=_jax_opts(opts))
    arg = H if given == "float32" else torch.from_numpy(H).to(torch.bfloat16)
    prob = tsart.make_problem(arg, opts=opts, device="cpu")
    assert prob.rtm.dtype == torch.bfloat16 and prob.rtm_scale is None
    np.testing.assert_array_equal(prob.rtm.view(torch.int16).numpy(),
                                  np.asarray(jprob.rtm).view(np.int16))
    for got, want in ((prob.ray_density, jprob.ray_density),
                      (prob.ray_length, jprob.ray_length)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_problem_from_numpy_reduced_storage(storage):
    """JAX's bf16 matrix crosses as its bits (no ml_dtypes in the port), its
    int8 codes with their scales; the problems equal the port's own."""
    H = _matrix(9)
    opts = SolverOptions(rtm_dtype=storage)
    jprob = jsart.make_problem(H, None, opts=_jax_opts(opts))
    rtm = np.asarray(jprob.rtm)
    scale = None if jprob.rtm_scale is None else np.asarray(jprob.rtm_scale)
    args = (np.asarray(jprob.ray_density), np.asarray(jprob.ray_length))
    got = problem_from_numpy(rtm, *args, opts=opts, device="cpu", rtm_scale=scale)
    own = tsart.make_problem(H, opts=opts, device="cpu")
    assert got.rtm.dtype == own.rtm.dtype
    assert torch.equal(got.rtm, own.rtm)
    if storage == "bfloat16":  # the uint16 view crosses as well
        bits = problem_from_numpy(rtm.view(np.uint16), *args, opts=opts, device="cpu")
        assert torch.equal(bits.rtm, own.rtm)
        with pytest.raises(ValueError, match="storage dtype"):
            problem_from_numpy(H, *args, opts=opts, device="cpu")
    else:
        assert torch.equal(got.rtm_scale, own.rtm_scale)
        with pytest.raises(ValueError, match="rtm_scale"):
            problem_from_numpy(rtm, *args, opts=opts, device="cpu")
        with pytest.raises(ValueError, match="storage dtype"):
            problem_from_numpy(H, *args, opts=opts, device="cpu", rtm_scale=scale)
