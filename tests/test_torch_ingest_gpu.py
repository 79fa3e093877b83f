"""The chunked RTM ingest and the I/O pipeline on the card.

Needs a CUDA device: every test is marked ``gpu`` and skips without a card.
Run on the card with
``python -m pytest -q --noconftest -m gpu tests/test_torch_ingest_gpu.py``.
This file imports no JAX and no h5py (the card's host has no HDF5
library): its worlds are written by ``chip_smoke.py``'s writer, the port's
``io/h5.py``.

- the stored matrix streamed to the card equals the same ingest on the
  CPU (the plain version, which the CPU tests hold against the JAX
  package) bit for bit, for fp32, bf16 and int8, at several chunk sizes,
  prefetch on and off, on the files as written and on a row-chunked copy;
- the ingest's device peak is the stored matrix plus one fp32 chunk and
  a few vectors;
- the solver loads the fused sweep's extension while it is constructed;
- the CLI on the card writes the same bytes at the defaults and with one
  chunk, prefetch off and a writer queue of one, and a transient
  ``hdf5.rtm_ingest`` fault recovers with the same file.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORAGES = ["float32", "bfloat16", "int8"]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _needs_card()
    cs = _chip_smoke()
    d = tmp_path_factory.mktemp("world")
    world = cs.write_world(str(d), nx=64, ny=48, cam=(24, 16), n_frames=12)
    world["chunked"] = cs.write_chunked_copy(world["paths"], str(d), rows=40)
    return world


def _sorted(files):
    return {"camA": [files["rtm_a_seg1"], files["rtm_a_seg2"]], "camB": [files["rtm_b"]]}


def _ingest(files, P, V, storage, device, **kw):
    from sartsolver_tpu_torch.parallel import multihost as mh

    if storage == "int8":
        return mh.read_and_quantize_rtm(_sorted(files), "with_reflections", P, V, device, **kw)
    return mh.read_and_shard_rtm(_sorted(files), "with_reflections", P, V, device,
                                 dtype=storage, **kw), None


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("chunk_rows", [1, 7, 100, None])
@pytest.mark.parametrize("layout", ["contiguous", "chunked"])
@pytest.mark.parametrize("prefetch", ["0", "1"])
def test_card_ingest_equals_cpu_ingest(world, storage, chunk_rows, layout, prefetch,
                                       monkeypatch):
    monkeypatch.setenv("SART_INGEST_PREFETCH", prefetch)
    files = world["paths"] if layout == "contiguous" else world["chunked"]
    P, V = world["H"].shape
    want, want_scale = _ingest(world["paths"], P, V, storage, "cpu")
    got, scale = _ingest(files, P, V, storage, "cuda", chunk_rows=chunk_rows)
    assert got.device.type == "cuda" and got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)
    if storage == "int8":
        assert torch.equal(scale.cpu(), want_scale)
    if storage == "float32":
        np.testing.assert_array_equal(got.cpu().numpy(), world["H"])


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
def test_card_ingest_padding_rows(world, storage):
    P, V = world["H"].shape
    want, _ = _ingest(world["paths"], P, V, storage, "cpu")
    got, _ = _ingest(world["paths"], P, V, storage, "cuda", chunk_rows=50, rows=P + 5)
    assert got.shape == (P + 5, V)
    assert torch.equal(got[:P].cpu(), want) and not got[P:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
def test_card_ingest_device_peak(world, storage):
    """The stored matrix, one fp32 staging chunk and the column vectors."""
    P, V = world["H"].shape
    chunk = 40
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    got, scale = _ingest(world["paths"], P, V, storage, "cuda", chunk_rows=chunk)
    peak = torch.cuda.max_memory_allocated() - mem0
    stored = got.numel() * got.element_size()
    assert peak <= stored + chunk * V * 4 + 4 * V * 4 + (2 << 20), (peak, stored)


@pytest.mark.gpu
def test_solver_loads_the_extension_at_construction(world):
    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.ops import _build
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

    P, V = world["H"].shape
    rtm, _ = _ingest(world["paths"], P, V, "float32", "cuda")
    _build._loaded.pop("fused_sweep", None)
    with DistributedSARTSolver(rtm, opts=SolverOptions(), device="cuda", npixel=P):
        assert "fused_sweep" in _build._loaded


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("loop", [[], ["--no_guess", "--batch_frames", "4"]])
def test_card_cli_same_file_however_the_pipeline_runs(world, tmp_path, monkeypatch,
                                                      storage, loop):
    cs = _chip_smoke()
    p = world["paths"]
    P = world["H"].shape[0]
    argv = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"],
            "-m", "200", "-l", p["laplacian"], "--rtm_dtype", storage, *loop]
    data = []
    for chunk, prefetch, queue in (("9", "1", "16"), (str(P), "0", "1")):
        monkeypatch.setenv("SART_INGEST_CHUNK_ROWS", chunk)
        monkeypatch.setenv("SART_INGEST_PREFETCH", prefetch)
        monkeypatch.setenv("SART_WRITER_QUEUE", queue)
        out = str(tmp_path / f"{chunk}_{prefetch}_{queue}.h5")
        rc, ms, _ = cs.run_cli(["-o", out, *argv])
        assert rc == 0 and len(ms) == world["G"].shape[1]
        cs.check_solution(out, world, len(ms), 200, "cuda")
        with open(out, "rb") as f:
            data.append(f.read())
    assert data[0] == data[1]


@pytest.mark.gpu
def test_card_rtm_ingest_fault_recovers(world, tmp_path, monkeypatch):
    from sartsolver_tpu_torch.resilience import faults

    cs = _chip_smoke()
    p = world["paths"]
    argv = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"],
            "-m", "200", "-t", "0:0.35"]
    monkeypatch.setenv("SART_RETRY_BASE_DELAY", "0.001")
    outs = []
    for spec in ("", "hdf5.rtm_ingest:io:1:2"):
        monkeypatch.setenv("SART_FAULT", spec)
        faults.reset()
        out = str(tmp_path / f"f{len(outs)}.h5")
        rc, ms, text = cs.run_cli(["-o", out, *argv])
        faults.reset()
        assert rc == 0 and len(ms) == 4
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and "2 recovered" not in text and "1 recovered" in text
