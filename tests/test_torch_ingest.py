"""The chunked RTM ingest of the port (``io/h5.py``, ``io/raytransfer.py``,
``parallel/multihost.py``) against full reads and the JAX package's ingest,
on the CPU over the fixture world (segmented and sparse cameras).

- ``io/h5.py``: row-range and ``read_direct`` reads of contiguous and
  chunked datasets (gzip and shuffle, written with h5py) equal the full
  read, and a row range decodes each chunk it meets once;
- ``read_rtm_block`` equals the JAX reader for row and column windows,
  with and without the sparse segments' cache, and fills ``out=``;
- ``read_and_shard_rtm`` / ``read_and_quantize_rtm`` at chunk sizes 1, 3,
  100 and the default, on the files as written and on a row-chunked gzip
  and shuffle copy: fp32 equals ``read_rtm_block``, bf16 its
  round-to-nearest-even, fp64 its widening, int8 codes and scales the JAX
  ``read_and_quantize_rtm``'s; no read asks for more than a chunk's rows;
  the sparse segment is read once for both int8 passes;
- the solver built on the streamed matrix solves as the one built on the
  host matrix;
- the CLI writes the same bytes in every frame loop and storage with one
  chunk, prefetch off and ``SART_WRITER_QUEUE=1``.
"""

import os

import h5py
import numpy as np
import pytest
import torch

import fixtures as fx
from sartsolver_tpu.io import hdf5files as jhf
from sartsolver_tpu.io.raytransfer import read_rtm_block as jax_read_rtm_block

from sartsolver_tpu_torch.cli import main as torch_main
from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.io import h5
from sartsolver_tpu_torch.io import raytransfer as rt
from sartsolver_tpu_torch.parallel import multihost as mh
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

NAME = "with_reflections"
RTM_KEYS = ("rtm_a1", "rtm_a2", "rtm_b")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("world")
    paths, H, *_ = fx.write_world(d, with_laplacian=True)
    return paths, H


def _files(paths):
    m, _ = jhf.categorize_input_files([paths[k] for k in RTM_KEYS])
    return jhf.sort_rtm_files(m)


def _rechunk(src, dst, rows=3):
    """A copy of an RTM file whose datasets are chunked (``rows`` rows a
    chunk), gzip-compressed and shuffled, as h5py writes them."""
    with h5py.File(src, "r") as fin, h5py.File(dst, "w") as fout:
        def copy(name, obj):
            if isinstance(obj, h5py.Group):
                grp = fout.require_group(name)
                for k, v in obj.attrs.items():
                    grp.attrs[k] = v
                return
            data = obj[()]
            if data.ndim:
                chunks = (min(rows, data.shape[0]),) + data.shape[1:]
                dset = fout.create_dataset(name, data=data, chunks=chunks,
                                           compression="gzip", shuffle=True)
            else:
                dset = fout.create_dataset(name, data=data)
            for k, v in obj.attrs.items():
                dset.attrs[k] = v
        fin.visititems(copy)
        for k, v in fin.attrs.items():
            fout.attrs[k] = v


@pytest.fixture(scope="module", params=["contiguous", "chunked"])
def layout(request, world, tmp_path_factory):
    """``(sorted files, H)``: the world's RTM files as written, or their
    row-chunked gzip and shuffle copies."""
    paths, H = world
    if request.param == "contiguous":
        return _files(paths), H
    d = tmp_path_factory.mktemp("chunked")
    copies = {}
    for k in RTM_KEYS:
        copies[k] = str(d / os.path.basename(paths[k]))
        _rechunk(paths[k], copies[k])
    return _files(copies), H


# ---------------------------------------------------------------------------
# io/h5.py

@pytest.mark.parametrize("kind", ["contiguous", "chunked", "gzip_shuffle", "partial"])
def test_h5_row_reads_match_full_reads(tmp_path, kind):
    a = np.random.default_rng(0).random((37, 11)).astype(np.float32)
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        if kind == "contiguous":
            f.create_dataset("d", data=a)
        elif kind == "chunked":
            f.create_dataset("d", data=a, chunks=(4, 5))
        elif kind == "gzip_shuffle":
            f.create_dataset("d", data=a, chunks=(4, 5), compression="gzip", shuffle=True)
        else:  # chunks never written read as the fill value
            f.create_dataset("d", shape=a.shape, dtype="f4", chunks=(4, 5), fillvalue=7)
            f["d"][8:12] = a[8:12]
    with h5py.File(path, "r") as f:
        want = f["d"][()]
    with h5.File(path) as f:
        d = f["d"]
        np.testing.assert_array_equal(d[:], want)
        for r0, r1 in [(0, 37), (3, 9), (8, 12), (36, 37), (5, 5)]:
            np.testing.assert_array_equal(d[r0:r1], want[r0:r1])
            buf = np.full((r1 - r0, 20), -1, np.float32)
            d.read_direct(buf[:, 3:14], (r0, r1))
            np.testing.assert_array_equal(buf[:, 3:14], want[r0:r1])
            assert (buf[:, :3] == -1).all() and (buf[:, 14:] == -1).all()
        np.testing.assert_array_equal(d[5], want[5])
        np.testing.assert_array_equal(d[-1, 2:4], want[-1, 2:4])
        with pytest.raises(IndexError):
            d.read_direct(np.empty((3, 11), np.float32), (35, 38))


def test_h5_row_range_decodes_each_chunk_once(tmp_path):
    a = np.arange(40 * 6, dtype=np.float64).reshape(40, 6)
    path = str(tmp_path / "c.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=a, chunks=(4, 3), compression="gzip", shuffle=True)
    with h5.File(path) as f:
        d = f["d"]
        for r0, r1, chunks in [(0, 40, 20), (3, 9, 6), (4, 8, 2), (39, 40, 2)]:
            h5.DECODE_STATS["chunks"] = 0
            out = np.empty((r1 - r0, 6))
            d.read_direct(out, (r0, r1))
            np.testing.assert_array_equal(out, a[r0:r1])
            assert h5.DECODE_STATS["chunks"] == chunks
            # every row chunk of 4 read as its own stripe: each chunk once
        h5.DECODE_STATS["chunks"] = 0
        for r0 in range(0, 40, 4):
            d[r0:r0 + 4]
        assert h5.DECODE_STATS["chunks"] == 20


def test_h5_port_writer_chunked_file_reads_by_rows(tmp_path):
    """The port's writer's chunked, unfiltered layout (what the card's
    chunked copy of the world uses) reads back by row ranges, and h5py
    agrees."""
    a = np.random.default_rng(1).random((70, 9)).astype(np.float32)
    path = str(tmp_path / "p.h5")
    with h5.File(path, "w") as f:
        f.create_dataset("d", data=a, chunks=(8, 9))
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["d"][()], a)
    with h5.File(path) as f:
        h5.DECODE_STATS["chunks"] = 0
        np.testing.assert_array_equal(f["d"][10:30], a[10:30])
        assert h5.DECODE_STATS["chunks"] == 3
        # whole-row unfiltered chunks go from the file into a column window
        buf = np.full((69, 12), -1, np.float32)
        f["d"].read_direct(buf[:, 1:10], (1, 70))
        np.testing.assert_array_equal(buf[:, 1:10], a[1:70])
        assert (buf[:, 0] == -1).all() and (buf[:, 10:] == -1).all()


# ---------------------------------------------------------------------------
# io/raytransfer.py

@pytest.mark.parametrize("window", [(0, 14, 0, None), (3, 5, 0, None), (6, 4, 2, 9),
                                    (13, 1, 15, 1), (0, 14, 4, 8), (7, 7, 8, 8)])
def test_read_rtm_block_matches_jax(layout, window):
    files, H = layout
    P, V = H.shape
    r0, n, c0, nc = window
    want = jax_read_rtm_block(files, NAME, n, V, r0, offset_voxel=c0, nvoxel_local=nc)
    got = rt.read_rtm_block(files, NAME, n, V, r0, offset_voxel=c0, nvoxel_local=nc)
    np.testing.assert_array_equal(got, want)
    width = nc or V - c0
    buf = np.full((n + 2, width + 3), 5.0, np.float32)
    rt.read_rtm_block(files, NAME, n, V, r0, offset_voxel=c0, nvoxel_local=nc,
                      out=buf[1:-1, 2:-1])
    np.testing.assert_array_equal(buf[1:-1, 2:-1], want)
    assert (buf[0] == 5).all() and (buf[:, :2] == 5).all() and (buf[:, -1] == 5).all()
    # row by row through the sparse segments' cache, against the JAX cache
    jcache, tcache = {}, {}
    win = dict(cache_rows=(r0, r0 + n), cache_cols=(c0, c0 + width))
    for k in range(r0, r0 + n):
        np.testing.assert_array_equal(
            rt.read_rtm_block(files, NAME, 1, V, k, offset_voxel=c0, nvoxel_local=nc,
                              sparse_cache=tcache, **win),
            jax_read_rtm_block(files, NAME, 1, V, k, offset_voxel=c0, nvoxel_local=nc,
                               sparse_cache=jcache, **win))


def test_sparse_cache_budget(world, monkeypatch):
    """Past SART_SPARSE_CACHE_MB a segment is read again by each call, with
    the same result."""
    paths, H = world
    files = _files(paths)
    P, V = H.shape
    monkeypatch.setenv("SART_SPARSE_CACHE_MB", "0")
    cache = {}
    rows = [rt.read_rtm_block(files, NAME, 1, V, k, sparse_cache=cache,
                              cache_rows=(0, P), cache_cols=(0, V)) for k in range(P)]
    np.testing.assert_array_equal(np.concatenate(rows), rt.read_rtm_block(files, NAME, P, V))
    assert all(v is None for k, v in cache.items() if isinstance(k, tuple))


# ---------------------------------------------------------------------------
# parallel/multihost.py

def _jax_codes(files, P, V, chunk_rows=3):
    import jax

    from sartsolver_tpu.parallel.mesh import make_mesh
    from sartsolver_tpu.parallel.multihost import read_and_quantize_rtm

    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    codes, scale = read_and_quantize_rtm(files, NAME, P, V, mesh, chunk_rows=chunk_rows)
    return np.asarray(codes)[:P, :V], np.asarray(scale)[:V]


@pytest.mark.parametrize("chunk_rows", [1, 3, 100, None])
def test_chunked_ingest_matches_full_read(layout, chunk_rows):
    """Every storage, streamed in chunks, is the host recipe's matrix bit
    for bit (the JAX test's chunk sizes, and the default)."""
    files, H = layout
    P, V = H.shape
    full = rt.read_rtm_block(files, NAME, P, V)
    np.testing.assert_array_equal(full, jax_read_rtm_block(files, NAME, P, V, 0))
    fp32 = mh.read_and_shard_rtm(files, NAME, P, V, "cpu", dtype="float32",
                                 chunk_rows=chunk_rows)
    assert fp32.dtype == torch.float32 and fp32.shape == (P, V)
    np.testing.assert_array_equal(fp32.numpy(), full)
    bf16 = mh.read_and_shard_rtm(files, NAME, P, V, "cpu", dtype="bfloat16",
                                 chunk_rows=chunk_rows)
    assert torch.equal(bf16, torch.from_numpy(full).to(torch.bfloat16))
    fp64 = mh.read_and_shard_rtm(files, NAME, P, V, "cpu", dtype=torch.float64,
                                 chunk_rows=chunk_rows, rows=16)
    np.testing.assert_array_equal(fp64.numpy()[:P], full.astype(np.float64))
    assert (fp64.numpy()[P:] == 0).all()
    codes, scale = mh.read_and_quantize_rtm(files, NAME, P, V, "cpu", chunk_rows=chunk_rows)
    want_codes, want_scale = _jax_codes(files, P, V)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(scale.numpy(), want_scale)


def test_two_pass_ingest_matches_device_quantization(world):
    """The two-pass codes equal the host matrix quantized whole
    (``quantize_rtm``), and the solver built on them solves as the one that
    quantizes the host matrix itself (the JAX test of the same name)."""
    from sartsolver_tpu_torch.models.sart import quantize_rtm

    paths, H = world
    files = _files(paths)
    P, V = H.shape
    codes, scale = mh.read_and_quantize_rtm(files, NAME, P, V, "cpu", chunk_rows=3)
    host = rt.read_rtm_block(files, NAME, P, V)
    want_codes, want_scale = quantize_rtm(torch.from_numpy(host))
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)
    opts = SolverOptions(rtm_dtype="int8", max_iterations=30, conv_tolerance=0.0)
    pre = DistributedSARTSolver(codes, None, opts=opts, device="cpu", rtm_scale=scale)
    dev = DistributedSARTSolver(host, None, opts=opts, device="cpu")
    assert torch.equal(pre.problem.rtm, dev.problem.rtm)
    assert torch.equal(pre.problem.ray_density, dev.problem.ray_density)
    g = (H.astype(np.float64) @ np.linspace(0.5, 2.0, V))[None, :]
    a, b = pre.solve_batch(g), dev.solve_batch(g)
    np.testing.assert_array_equal(a.fetch_solutions(), b.fetch_solutions())
    np.testing.assert_array_equal(a.iterations, b.iterations)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_streamed_matrix_solves_as_the_host_matrix(world, storage):
    """The solver on the streamed matrix (a tensor in its stored dtype,
    with the ordered-subsets padding rows already in it) equals the solver
    on the host matrix, byte for byte."""
    paths, H = world
    files = _files(paths)
    P, V = H.shape
    host = rt.read_rtm_block(files, NAME, P, V)
    g = (H.astype(np.float64) @ np.linspace(0.5, 2.0, V))[None, :]
    for os_subsets in (1, 4):  # 4 pads P = 14 to 16 rows
        opts = SolverOptions(rtm_dtype=None if storage == "float32" else storage,
                             os_subsets=os_subsets, max_iterations=30)
        rows = 16 if os_subsets == 4 else P
        dev = mh.read_and_shard_rtm(files, NAME, P, V, "cpu", dtype=storage, rows=rows)
        a = DistributedSARTSolver(dev, None, opts=opts, device="cpu", npixel=P)
        host_in = host if storage == "float32" else torch.from_numpy(host).to(torch.bfloat16)
        b = DistributedSARTSolver(host_in, None, opts=opts, device="cpu")
        assert a.rows == b.rows == rows and a.npixel == b.npixel == P
        assert torch.equal(a.problem.rtm, b.problem.rtm)
        np.testing.assert_array_equal(a.solve_batch(g).fetch_solutions(),
                                      b.solve_batch(g).fetch_solutions())
    with pytest.raises(ValueError, match="rows expected"):
        DistributedSARTSolver(dev, None, opts=SolverOptions(), device="cpu", npixel=13)


def test_ingest_host_allocation_is_bounded(world, monkeypatch):
    """No read asks for more rows than one chunk: the host never holds the
    matrix (the JAX test's spy)."""
    paths, H = world
    files = _files(paths)
    P, V = H.shape
    seen = []
    orig = mh.read_rtm_block

    def spy(files_, name, npixel_local, nvoxel_, offset, **kw):
        seen.append((npixel_local, kw["out"].shape))
        return orig(files_, name, npixel_local, nvoxel_, offset, **kw)

    monkeypatch.setattr(mh, "read_rtm_block", spy)
    mh.read_and_shard_rtm(files, NAME, P, V, "cpu", dtype="float32", chunk_rows=4)
    mh.read_and_quantize_rtm(files, NAME, P, V, "cpu", chunk_rows=4)
    assert seen and max(n for n, _ in seen) <= 4 < P
    assert all(shape == (n, V) for n, shape in seen)  # into a staging chunk
    assert len(seen) == 3 * 4  # ceil(14 / 4) chunks, three passes


def test_sparse_segment_read_once_for_both_passes(world, monkeypatch):
    paths, H = world
    files = _files(paths)
    P, V = H.shape
    loads = []
    orig = rt._load_sparse_segment

    def spy(*args):
        loads.append(args[1])
        return orig(*args)

    monkeypatch.setattr(rt, "_load_sparse_segment", spy)
    mh.read_and_quantize_rtm(files, NAME, P, V, "cpu", chunk_rows=2)
    assert loads == [paths["rtm_a2"]]  # camera A's sparse segment, once


def test_ingest_env_knobs_and_stats(world, monkeypatch):
    paths, H = world
    files = _files(paths)
    P, V = H.shape
    assert mh.default_chunk_rows(V) == (256 << 20) // (4 * V)
    assert mh.default_chunk_rows(1 << 30) == mh.ROW_ALIGN
    monkeypatch.setenv("SART_INGEST_CHUNK_ROWS", "5")
    monkeypatch.setenv("SART_INGEST_PREFETCH", "0")
    timings = {}
    mh.read_and_quantize_rtm(files, NAME, P, V, "cpu", timings=timings)
    assert set(timings) == {"colmax", "quantize"}
    for rec in timings.values():
        assert rec["chunks"] == 3 and rec["chunk_rows"] == 5 and rec["prefetch"] is False
        assert rec["bytes"] == P * V * 4 and rec["read_seconds"] <= rec["seconds"]
    monkeypatch.setenv("SART_INGEST_PREFETCH", "1")
    assert mh.prefetch_enabled()
    monkeypatch.setenv("SART_INGEST_CHUNK_ROWS", "0")
    with pytest.raises(ValueError, match="SART_INGEST_CHUNK_ROWS"):
        mh.read_and_shard_rtm(files, NAME, P, V, "cpu", dtype="float32")


def test_ingest_hooks_and_refusals(world):
    paths, H = world
    files = _files(paths)
    P, V = H.shape
    with pytest.raises(ValueError, match="read_and_quantize_rtm"):
        mh.read_and_shard_rtm(files, NAME, P, V, "cpu", dtype="int8")
    # tile_stats= is the block-sparse index's hook (tests/test_torch_sparse.py
    # holds it against the JAX package): the tile maxima of the values
    # stored, on the matrix padded to whole 8 x 128 tiles
    from sartsolver_tpu_torch.ops.sparse import build_tile_occupancy

    tiles = mh.make_tile_stats(P, V)
    mh.read_and_shard_rtm(files, NAME, P, V, "cpu", dtype="float32", tile_stats=tiles,
                          chunk_rows=3)
    padded = np.zeros((tiles.rows, tiles.cols), np.float32)
    padded[:P, :V] = H
    assert tiles.occupancy(0.0) == build_tile_occupancy(padded)
    tiles = mh.make_tile_stats(P, V)
    codes, scale = mh.read_and_quantize_rtm(files, NAME, P, V, "cpu", tile_stats=tiles)
    padded[:P, :V] = codes.numpy().astype(np.float32) * scale.numpy()
    assert tiles.occupancy(0.0) == build_tile_occupancy(padded)
    # ingest_stats= is the integrity layer's hook (tests/test_torch_integrity.py
    # holds it against the JAX package): the sums of the values stored
    from sartsolver_tpu_torch.resilience.integrity import IngestStats

    stats = IngestStats(P, V)
    mh.read_and_shard_rtm(files, NAME, P, V, "cpu", dtype="float32", ingest_stats=stats)
    np.testing.assert_allclose(stats.finish().colsum,
                               H.astype(np.float32).astype(np.float64).sum(axis=0))
    stats = IngestStats(P, V)
    codes, scale = mh.read_and_quantize_rtm(files, NAME, P, V, "cpu", ingest_stats=stats)
    dequantized = codes.numpy().astype(np.float64) * scale.numpy().astype(np.float64)
    np.testing.assert_allclose(stats.finish().rowsum, dequantized.sum(axis=1))
    np.testing.assert_allclose(stats.rowabs, np.abs(dequantized).sum(axis=1))


def test_rtm_bytes_counter(world):
    from sartsolver_tpu_torch.obs import metrics as obs_metrics

    paths, H = world
    files = _files(paths)
    P, V = H.shape
    obs_metrics.reset_registry()
    mh.read_and_quantize_rtm(files, NAME, P, V, "cpu", chunk_rows=3)
    got = obs_metrics.get_registry().counter("bytes_ingested_total", source="rtm").value
    assert got == 2 * P * V * 4  # both passes, fp32 chunks


# ---------------------------------------------------------------------------
# the CLI: the same file however the pipeline is set

LOOPS = {"chain": [], "serial": ["--chain_frames", "1"],
         "classic": ["--no_guess", "--batch_frames", "3", "--no_continuous_batching"],
         "scheduler": ["--no_guess", "--batch_frames", "3"]}


@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_cli_file_is_the_same_however_the_pipeline_runs(world, tmp_path, monkeypatch,
                                                         loop, storage):
    """Chunks of 3 rows, prefetch on, the default writer queue against one
    chunk, prefetch off, a queue of one: byte-identical files."""
    paths, H = world
    argv = [*(paths[k] for k in (*RTM_KEYS, "img_a", "img_b")), "--device", "cpu",
            "-m", "40", "-c", "1e-12", "-l", paths["laplacian"], "-b", "0.001",
            "--rtm_dtype", storage, *LOOPS[loop]]
    data = []
    for chunk, prefetch, queue in (("3", "1", "16"), (str(H.shape[0]), "0", "1")):
        monkeypatch.setenv("SART_INGEST_CHUNK_ROWS", chunk)
        monkeypatch.setenv("SART_INGEST_PREFETCH", prefetch)
        monkeypatch.setenv("SART_WRITER_QUEUE", queue)
        out = str(tmp_path / f"{chunk}_{prefetch}_{queue}.h5")
        assert torch_main(["-o", out, *argv]) == 0
        with open(out, "rb") as f:
            data.append(f.read())
    assert data[0] == data[1]
