"""The block-sparse RTM (``--sparse_rtm``) on the card.

Needs a CUDA device: every test is marked ``gpu`` and skips without a card.
Run on the card with
``python -m pytest -q --noconftest -m gpu tests/test_torch_sparse_gpu.py``.
This file imports no JAX and no h5py: its world is ``chip_smoke.py``'s, its
top and bottom grid rows dark (``write_dark_world``).

- the compacted sweep (the occupied columns' matrix) launched on the card
  against its plain version, in each plan it takes (``one_read`` at B = 1,
  ``tensor_core`` for bf16 and int8 at B = 8, ``two_read`` for fp32 past
  B = 8), within 1e-5 of the output's max;
- the ingest's tile maxima taken on the card equal the host recipe's
  (``TileMaxStats.add`` of the stored values) for every storage and chunk
  size, NaN included;
- the peak device bytes of a sparse ingest and construction no higher
  than the dense one's, and the solve on the card through the kernel on
  the compacted matrix matching the dense solve.
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
def dark_world(tmp_path_factory):
    _needs_card()
    cs = _chip_smoke()
    d = tmp_path_factory.mktemp("dark_world")
    world = cs.write_world(str(d), nx=64, ny=64, cam=(32, 32), n_frames=8)
    return cs.write_dark_world(world, str(d / "dark"), 16)


@pytest.mark.gpu
@pytest.mark.parametrize("storage,B", [("float32", 1), ("bfloat16", 1), ("int8", 1),
                                       ("float32", 8), ("bfloat16", 8), ("int8", 8),
                                       ("float32", 16)])
@pytest.mark.parametrize("logarithmic", [False, True])
def test_compacted_sweep_against_the_plain_version(storage, B, logarithmic):
    """The kernel on a compacted matrix (8192 x 32768, the dark e2e world's
    occupied columns) in the plan ``plan_sweep`` gives it, against the plain
    version."""
    _needs_card()
    cs = _chip_smoke()
    from sartsolver_tpu_torch.ops.fused_sweep import plan_sweep

    P, V = 8192, 32768
    H, w, f, aux, scale = cs._sweep_inputs(P, V, B, logarithmic, True, seed=B + logarithmic,
                                           storage=storage)
    kw = dict(logarithmic=logarithmic, alpha=0.7, eps=1e-7)
    record, _ = cs._check_kernel(H, w, f, aux, scale, kw, storage)
    assert record["ok"] and record["plan"] == plan_sweep(P, V, B, storage)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("chunk_rows", [None, 37])
def test_card_tile_maxima_equal_the_host_recipe(dark_world, storage, chunk_rows):
    _needs_card()
    from sartsolver_tpu_torch.ops.sparse import TileMaxStats
    from sartsolver_tpu_torch.parallel import multihost as mh

    p = dark_world["paths"]
    files = {"camA": [p["rtm_a_seg1"], p["rtm_a_seg2"]], "camB": [p["rtm_b"]]}
    P, V = dark_world["H"].shape
    card = mh.make_tile_stats(P, V)
    if storage == "int8":
        codes, scale = mh.read_and_quantize_rtm(files, "with_reflections", P, V, "cuda",
                                                chunk_rows=chunk_rows, tile_stats=card)
        stored = codes.cpu().numpy().astype(np.float32) * scale.cpu().numpy()
    else:
        buf = mh.read_and_shard_rtm(files, "with_reflections", P, V, "cuda", dtype=storage,
                                    chunk_rows=chunk_rows, tile_stats=card)
        stored = buf.float().cpu().numpy()
    host = TileMaxStats(card.rows, card.cols)
    host.add(stored, 0, 0)
    np.testing.assert_array_equal(card.tile_max, host.tile_max)
    occ = card.occupancy(0.0)
    assert occ.occupancy_fraction() == pytest.approx(0.5)
    assert occ.digest == host.occupancy(0.0).digest


@pytest.mark.gpu
def test_card_tile_maxima_see_a_nan():
    _needs_card()
    from sartsolver_tpu_torch.ops.sparse import TileMaxStats
    from sartsolver_tpu_torch.parallel import multihost as mh

    x = torch.rand(40, 300, device="cuda")
    x[13, 257] = float("nan")
    stats = TileMaxStats(40, 300)
    mh._feed_tile_stats(stats, x, 0)
    with pytest.raises(ValueError, match="non-finite"):
        stats.occupancy(0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
def test_sparse_ingest_peak_no_higher_than_dense(dark_world, storage):
    """The ingest and the solver's construction, dense and sparse: the sparse
    peak no higher (the compaction happens in place in the ingest's buffer),
    the held matrix the occupied half."""
    _needs_card()
    cs = _chip_smoke()
    dense = cs._ingest_peak(dark_world, storage, "cuda", sparse=False)
    sparse = cs._ingest_peak(dark_world, storage, "cuda", sparse=True)
    P, V = dark_world["H"].shape
    assert sparse["held_shape"] == [P, V // 2]
    assert sparse["peak_device_bytes"] <= dense["peak_device_bytes"], (sparse, dense)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
def test_card_sparse_cli_matches_dense(dark_world, tmp_path, storage):
    """The CLI on the card at ``--sparse_rtm auto``: every launch on the
    compacted plan, one per iteration; statuses equal to the dense run's
    and the fitted distance within the script's bar."""
    _needs_card()
    cs = _chip_smoke()
    from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep, plan_sweep, reset_launch_counts

    p = dark_world["paths"]
    P, V = dark_world["H"].shape
    argv = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"], "-m", "300",
            "-l", p["laplacian"], "--chain_frames", "1", "--rtm_dtype", storage]
    sols = {}
    for mode in ("auto", "off"):
        out = str(tmp_path / f"{mode}.h5")
        reset_launch_counts()
        rc, ms, text = cs.run_cli(["-o", out, *argv, "--sparse_rtm", mode])
        assert rc == 0 and len(ms) == 8
        sol, _ = cs.check_solution(out, dark_world, 8, 300, "cuda")
        want = dict.fromkeys(fused_sweep.launches_by_plan, 0)
        want[plan_sweep(P, V // 2 if mode == "auto" else V, 1, storage)] = \
            int(sol["iterations"].sum())
        assert fused_sweep.launches_by_plan == want
        sols[mode] = sol
    np.testing.assert_array_equal(sols["auto"]["status"], sols["off"]["status"])
    dist = cs._fitted_distance(dark_world, sols["auto"]["value"], sols["off"]["value"], "cuda")
    assert (dist <= cs.SPARSE_FIT_TOL).all(), dist
