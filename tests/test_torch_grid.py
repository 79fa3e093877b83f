"""The grid of ranks' arithmetic and its one-process parts, against the JAX package.

No process group is started here (``tests/test_torch_grid_mp.py`` runs the
grids over gloo):

- the partition and its padding (``parallel/mesh.py``) against the JAX
  package's, and a rank's padded block against the JAX device's shard of
  the same mesh shape;
- the halo partition of the Laplacian against the JAX
  ``shard_laplacian_halo``, and ``sharded_penalty`` (its all-gather played
  by the other shards' export values) against the JAX ``sharded_penalty``
  under ``shard_map`` and against ``coo_matvec``: a row adds its local
  triplets, then its halo triplets, so the split changes only the order of
  a row's sum, within 1e-12 in fp64;
- the split sweep's plain version, its partial back projections summed in
  shard order, against the JAX ``sharded_panel_sweep`` under ``shard_map``
  on an 8-shard pixel mesh (fp32 within rtol 1e-4 / atol 1e-5, the JAX
  test's tolerance), and at one rank against the fused sweep's plain
  version bit for bit;
- the refusals of a grid of more than one rank, each with its words, and
  the mesh choice;
- the end-of-run telemetry merge against the JAX ``aggregate_snapshots``;
- the parity protocol's fp64 witness (``utils/fused_parity.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from sartsolver_tpu.ops import laplacian as jlap
from sartsolver_tpu.ops.fused_sweep import sharded_panel_sweep
from sartsolver_tpu.parallel import mesh as jmesh
from sartsolver_tpu.parallel import shard_map

from sartsolver_tpu_torch.config import SartInputError, SolverOptions
from sartsolver_tpu_torch.ops import fused_sweep as fs
from sartsolver_tpu_torch.ops import laplacian as tlap
from sartsolver_tpu_torch.parallel import comm, mesh, multihost
from sartsolver_tpu_torch.parallel.sharded import grid_block, grid_refusal

GRIDS = [(2, 1), (1, 2), (2, 2), (4, 1), (1, 4)]


@pytest.mark.parametrize("npixel,nshards", [(100, 8), (17, 4), (8, 8), (7, 3), (14, 2)])
def test_partition_and_padding_match_jax(npixel, nshards):
    assert mesh.row_block_partition(npixel, nshards) == jmesh.row_block_partition(
        npixel, nshards)
    assert mesh.padded_size(npixel, nshards) == jmesh.padded_size(npixel, nshards)
    rng = np.random.default_rng(npixel)
    rtm = rng.random((npixel, 5))
    np.testing.assert_array_equal(mesh.pad_pixel_axis(rtm, nshards),
                                  jmesh.pad_pixel_axis(rtm, nshards))
    g = rng.random(npixel)
    np.testing.assert_array_equal(mesh.pad_measurement(g, nshards),
                                  jmesh.pad_measurement(g, nshards))
    np.testing.assert_array_equal(mesh.pad_measurement(g, nshards, target=npixel + 9),
                                  jmesh.pad_measurement(g, nshards, target=npixel + 9))
    assert (mesh.ROW_ALIGN, mesh.COL_ALIGN) == (jmesh.ROW_ALIGN, jmesh.COL_ALIGN)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_rank_block_is_the_jax_device_block(grid):
    """Each rank's padded block (``grid_block``) is the shard the JAX mesh
    of the same shape puts on the device at the rank's coordinates, and the
    rank's logical rows and columns are the unpadded part of it."""
    n_pix, n_vox = grid
    npixel, nvoxel = 37, 300
    H = np.random.default_rng(1).random((npixel, nvoxel))
    rows, cols = jmesh.padded_size(npixel, n_pix * 8), jmesh.padded_size(nvoxel, n_vox * 128)
    padded = np.zeros((rows, cols))
    padded[:npixel, :nvoxel] = H
    jm = jmesh.make_mesh(n_pix, n_vox)
    arr = jax.device_put(padded, NamedSharding(jm, P("pixels", "voxels")))
    devices = list(np.asarray(jm.devices).ravel())
    for shard in arr.addressable_shards:
        r = devices.index(shard.device)
        g = mesh.RankGrid(n_pix, n_vox, rank=r)
        np.testing.assert_array_equal(grid_block(H, g, npixel, nvoxel), np.asarray(shard.data))
        (r0, nr), (c0, nc) = g.row_range(npixel), g.col_range(nvoxel)
        rb, cb = g.blocks(npixel, nvoxel)
        assert (r0, c0) == (min(g.coords[0] * rb, npixel), min(g.coords[1] * cb, nvoxel))
        np.testing.assert_array_equal(np.asarray(shard.data)[:nr, :nc],
                                      H[r0:r0 + nr, c0:c0 + nc])


def test_rank_pixel_runs_and_local_capability():
    """14 pixels over 4 row blocks of 8 (padded to 32): ranks 2 and 3 hold
    padding only, so per-rank staging is off; over 2 it is on."""
    g = mesh.RankGrid(4, 1, rank=2)
    assert multihost.process_pixel_range(g, 14) == (14, 0)
    assert multihost.process_pixel_runs(g, 14) == []
    assert not multihost.all_processes_local_capable(g, 14)
    g = mesh.RankGrid(2, 2, rank=3)
    assert g.coords == (1, 1)
    assert multihost.process_pixel_range(g, 14) == (8, 6)
    assert multihost.process_pixel_runs(g, 14) == [(8, 6)]
    assert multihost.all_processes_local_capable(g, 14)
    assert multihost.process_pixel_range(None, 14) == (0, 14)


def _random_laplacian(seed=3, S=4, vb=32, nnz=300):
    rng = np.random.default_rng(seed)
    V = S * vb
    rows = rng.integers(0, V, nnz)
    cols = np.clip(rows + rng.integers(-40, 41, nnz), 0, V - 1)
    return rows, cols, rng.standard_normal(nnz), V


@pytest.mark.parametrize("S", [2, 4])
def test_halo_partition_matches_jax(S):
    rows, cols, vals, V = _random_laplacian(S=S, vb=128 // S * 2)
    vb = V // S
    jslap = jlap.shard_laplacian_halo(jlap.make_laplacian(rows, cols, vals, dtype="float64"),
                                      S, vb, np.float64)
    order = np.argsort(rows, kind="stable")  # the port keeps each row's stored order
    parts, n_export = tlap.halo_partition(rows[order], cols[order], vals[order], S, vb)
    assert n_export == jslap.export_idx.shape[1]
    for s, part in enumerate(parts):
        for (mine_r, mine_c, mine_v), (jr, jc, jv) in (
                (part["loc"], (jslap.rows_loc, jslap.cols_loc, jslap.vals_loc)),
                (part["halo"], (jslap.rows_halo, jslap.gidx_halo, jslap.vals_halo))):
            n = len(mine_r)
            # the same triplets; the JAX order is the stored one, the port's
            # row-grouped with each row's order kept
            key = lambda r, c, v: sorted(zip(r.tolist(), c.tolist(), v.tolist()))  # noqa: E731
            assert key(mine_r, mine_c, mine_v) == key(np.asarray(jr[s][:n]),
                                                      np.asarray(jc[s][:n]),
                                                      np.asarray(jv[s][:n]))
            assert not np.asarray(jv[s][n:]).any()  # the rest is JAX's padding
        np.testing.assert_array_equal(part["export"],
                                      np.asarray(jslap.export_idx[s][:len(part["export"])]))


def _port_penalties(lap, S, vb, x, dtype, monkeypatch):
    """Every shard's ``sharded_penalty`` of ``x`` [B, S*vb], the export table
    the all-gather would bring made from every shard's block."""
    slaps = [tlap.shard_laplacian_halo(lap, S, vb, s, dtype=dtype) for s in range(S)]
    blocks = [x[:, s * vb:(s + 1) * vb] for s in range(S)]
    table = torch.cat([b[:, sl.export_idx] for b, sl in zip(blocks, slaps)], dim=1)
    monkeypatch.setattr(comm, "all_gather", lambda part, axis, grid, dim=-1: table)
    return torch.cat([tlap.sharded_penalty(sl, b, object()) for sl, b in zip(slaps, blocks)],
                     dim=1)


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_penalty_matches_jax_and_coo_matvec(S, monkeypatch):
    rows, cols, vals, V = _random_laplacian(seed=S, S=S, vb=64)
    vb = V // S
    x = np.random.default_rng(5).standard_normal((2, V))
    lap = tlap.make_laplacian(rows, cols, vals, nvoxel=V, dtype=torch.float64)
    got = _port_penalties(lap, S, vb, torch.as_tensor(x), torch.float64, monkeypatch).numpy()
    whole = tlap.coo_matvec(lap, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, whole, rtol=1e-12, atol=1e-12)

    jslap = jlap.shard_laplacian_halo(jlap.make_laplacian(rows, cols, vals, dtype="float64"),
                                      S, vb, np.float64)
    want = jax.jit(shard_map(
        lambda sl, xb: jlap.sharded_penalty(type(jslap)(*(a[0] for a in sl)), xb, "voxels"),
        mesh=jmesh.make_mesh(1, S),
        in_specs=(type(jslap)(*(P("voxels", None),) * 7), P(None, "voxels")),
        out_specs=P(None, "voxels"), check_vma=False,
    ))(jslap, x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-12)


def test_block_diagonal_laplacian_gathers_nothing(monkeypatch):
    S, vb = 4, 16
    idx = np.arange(S * vb)
    lap = tlap.make_laplacian(idx, idx, np.ones(S * vb), nvoxel=S * vb)
    slap = tlap.shard_laplacian_halo(lap, S, vb, 2)
    assert slap.n_export == 0 and slap.halo_gidx.shape[1] == 0

    def no_gather(*a, **k):
        raise AssertionError("a block-diagonal Laplacian gathers nothing")
    monkeypatch.setattr(comm, "all_gather", no_gather)
    x = torch.rand(2, vb)
    torch.testing.assert_close(tlap.sharded_penalty(slap, x, object()), x)


def _split_sweep_over_shards(H, w, f, aux, n, **kw):
    """The pixel-sharded sweep's plain version over ``n`` row blocks: each
    block's partial bp, their sum in shard order (the all-reduce), then each
    block's finish; ``(f_new, fitted)``, the shards' fitted concatenated."""
    rb = H.shape[0] // n
    blocks = [slice(s * rb, (s + 1) * rb) for s in range(n)]
    partials = [fs.sharded_sweep_bp(H[b], w[:, b]) for b in blocks]
    bp = partials[0]
    for part in partials[1:]:
        bp = bp + part
    outs = [fs.sharded_sweep_finish(H[b], f, bp, aux, **kw) for b in blocks]
    for f_new, _ in outs[1:]:
        assert torch.equal(f_new, outs[0][0])  # every shard updates alike
    return outs[0][0], torch.cat([fit for _, fit in outs], dim=1)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_split_sweep_plain_matches_jax_sharded_panel_sweep(storage):
    """As ``tests/test_sharded_fused.py:42`` calls the JAX panel scan: an
    8-shard pixel mesh, 8 rows a shard, the linear update; int8 codes with
    their scale (the JAX ``fwd_scale`` contract)."""
    rng = np.random.default_rng(3)
    Pn, V, B = 64, 256, 2
    H = rng.uniform(0.1, 1.0, (Pn, V)).astype(np.float32)
    w = rng.standard_normal((B, Pn)).astype(np.float32)
    f = rng.uniform(0.1, 1.0, (B, V)).astype(np.float32)
    invd = rng.uniform(0.5, 1.5, (1, V)).astype(np.float32)
    scale = None
    if storage == "int8":
        scale = np.maximum(H.max(axis=0), 1e-30) / 127.0
        H = np.clip(np.rint(H / scale), -127, 127).astype(np.int8)
        scale = scale.astype(np.float32)[None, :]

    def update_fn(f_p, bp_p, *a):
        if scale is not None:
            s_p, invd_p = a
            return jnp.maximum(f_p + invd_p * (bp_p * s_p), 0)
        return jnp.maximum(f_p + a[0] * bp_p, 0)

    aux_j = [invd] if scale is None else [scale, invd]
    fn = jax.jit(shard_map(
        lambda r, w_, f_, *a: sharded_panel_sweep(
            r, w_, f_, list(a), update_fn, axis_name="pixels", panel_voxels=128,
            fwd_scale=None if scale is None else 0),
        mesh=jmesh.make_mesh(8, 1),
        in_specs=(P("pixels", None), P(None, "pixels"), P(None, None))
        + (P(None, None),) * len(aux_j),
        out_specs=(P(None, None), P(None, "pixels")), check_vma=False,
    ))
    jf, jfit = fn(H, w, f, *aux_j)

    t = torch.as_tensor
    got_f, got_fit = _split_sweep_over_shards(
        t(H), t(w), t(f), [t(invd)], 8, logarithmic=False,
        scale=None if scale is None else t(scale))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_fit.numpy(), np.asarray(jfit), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("logarithmic", [False, True], ids=["linear", "log"])
def test_split_sweep_plain_at_one_rank_is_the_fused_plain_version(logarithmic):
    g = torch.Generator().manual_seed(4)
    H = torch.rand(300, 9000, generator=g)
    w = torch.rand(3, 300, generator=g)
    f = torch.rand(3, 9000, generator=g) + 0.1
    aux = ([torch.rand(1, 9000, generator=g).round(), torch.rand(3, 9000, generator=g)]
           if logarithmic else [torch.rand(1, 9000, generator=g)])
    aux.append(torch.rand(3, 9000, generator=g) * 0.01)
    kw = dict(logarithmic=logarithmic, alpha=0.7, eps=1e-7)
    pair = fs.sharded_sweep_finish(H, f, fs.sharded_sweep_bp(H, w), aux, **kw)
    one = fs.fused_sweep_reference(H, w, f, aux, **kw)
    assert all(torch.equal(a, b) for a, b in zip(pair, one))


def test_split_sweep_checks_its_operands():
    H, w = torch.rand(8, 16), torch.rand(2, 8)
    with pytest.raises(ValueError, match="do not agree"):
        fs.sharded_sweep_bp(H, torch.rand(2, 9))
    with pytest.raises(ValueError, match="fp32"):
        fs.sharded_sweep_bp(H, w.double())
    with pytest.raises(ValueError, match="must agree"):
        fs.sharded_sweep_finish(H, torch.rand(2, 16), torch.rand(1, 16), [torch.rand(1, 16)],
                                logarithmic=False)


def _grid(n_pix, n_vox):
    return mesh.RankGrid(n_pix, n_vox, backend="gloo")


# (options, grid, keyword, the words the refusal carries)
REFUSALS = [
    (dict(sparse_rtm="auto"), (2, 1), {}, "Argument sparse_rtm=auto"),
    (dict(lowrank_rtm="4"), (2, 1), {}, "Argument lowrank_rtm factors"),
    (dict(), (1, 2), dict(geometry=True), "Argument geometry is single-process"),
    (dict(os_subsets=2), (2, 1), {}, "Argument os_subsets=2"),
    (dict(integrity=True), (1, 2), {}, "Argument integrity"),
    (dict(), (2, 1), dict(debug_nans=True), "Argument debug_nans"),
    (dict(rtm_dtype="int8"), (2, 1), {}, "so per-column maxima stay process-local"),
    (dict(rtm_dtype="int8"), (2, 2), {}, "needs a voxel-major mesh"),
]


@pytest.mark.parametrize("opts,grid,kw,words", REFUSALS,
                         ids=[r[3].split()[1] if r[3].startswith("Arg") else r[3][:12]
                              for r in REFUSALS])
def test_grid_refusals(opts, grid, kw, words):
    assert words in grid_refusal(SolverOptions(**opts), _grid(*grid), **kw)
    # one rank runs what a grid refuses
    assert grid_refusal(SolverOptions(**opts), _grid(1, 1), **kw) is None


def test_grid_runs_int8_voxel_major_and_fp32_anywhere():
    for grid in GRIDS:
        assert grid_refusal(SolverOptions(), _grid(*grid)) is None
    assert grid_refusal(SolverOptions(rtm_dtype="int8"), _grid(1, 4)) is None


def test_make_grid_without_a_process_group():
    assert mesh.make_grid(1, 1).world == 1
    with pytest.raises(SartInputError, match=r"Mesh 2x1 needs 2 devices, have 1\."):
        mesh.make_grid(2, 1)
    with pytest.raises(SartInputError, match=r"Mesh 2x2 needs 4 devices, have 1\."):
        mesh.make_grid(2, 2)


def test_mesh_choice():
    """Voxel-major where the kernel runs the per-rank block (CUDA, fp32 at
    the e2e shape), the reference's row blocks otherwise (the CPU's 'auto',
    the fp64 profile); one rank is 1x1."""
    fp32, fp64 = SolverOptions(), SolverOptions.cpu_parity()
    assert mesh.choose_mesh_shape(1, 8192, 65536, fp32) == (1, 1)
    assert mesh.choose_mesh_shape(2, 8192, 65536, fp32, device_type="cuda") == (1, 2)
    assert mesh.choose_mesh_shape(4, 8192, 65536, fp32, device_type="cpu") == (4, 1)
    assert mesh.choose_mesh_shape(2, 8192, 65536, fp64, device_type="cuda") == (2, 1)
    off = dataclasses.replace(fp32, fused_sweep="off")
    assert mesh.choose_mesh_shape(2, 8192, 65536, off, device_type="cuda") == (2, 1)
    # the JAX package's CPU answer for 'auto' is the same row blocks
    assert jmesh.choose_mesh_shape(4, 8192, 65536, fp32) == (4, 1)


def test_telemetry_merge_matches_jax():
    from sartsolver_tpu.obs import run as jrun

    from sartsolver_tpu_torch.obs import metrics as tmetrics
    from sartsolver_tpu_torch.obs import run as trun

    snaps = []
    for k in range(3):
        reg = tmetrics.MetricsRegistry()
        reg.counter("frames_total").inc(4 + k)
        reg.gauge("device_peak_bytes").set(100.0 * (k + 1))
        reg.counter("retry_attempts_total", site="hdf5.frame_read").inc(k)
        snaps.append(reg.snapshot())
    bufs = [trun._encode_snapshot(s, 4096)[0] for s in snaps]

    def allgather(_buf):
        return np.stack(bufs)
    got = trun.aggregate_snapshots(snaps[0], allgather=allgather, max_bytes=4096)
    want = jrun.aggregate_snapshots(snaps[0], allgather=allgather, max_bytes=4096)
    assert got == want
    by = {(m["name"], tuple(sorted(m["labels"].items()))): m["value"] for m in got}
    assert by[("frames_total", ())] == 15 and by[("device_peak_bytes", ())] == 300.0
    assert trun.aggregate_snapshots(snaps[1]) == snaps[1]  # one process: as it is


def test_telemetry_finalize_on_a_grid(tmp_path):
    """Every rank aggregates; only the primary writes the artifact."""
    from sartsolver_tpu_torch.obs import metrics as tmetrics
    from sartsolver_tpu_torch.obs import run as trun

    out = tmp_path / "run.jsonl"
    calls = []
    for primary in (False, True):
        telem = trun.RunTelemetry(tmetrics.MetricsRegistry(), jsonl_path=str(out))
        telem.registry.counter("frames_total").inc(2)

        def allgather(buf):
            calls.append(primary)
            return np.stack([buf, buf])
        telem.finalize(multihost=True, primary=primary, allgather=allgather)
        assert out.exists() == primary
    assert calls == [False, True]
    metric = [ln for ln in out.read_text().splitlines() if '"frames_total"' in ln]
    assert metric and '"value": 4' in metric[0]


def test_parity_protocol_and_its_fp64_witness(monkeypatch):
    """On the CPU both paths run the plain version: no launch, no gap, and
    the same distance to the fp64 solve; a kernel path farther from fp64
    than ``FP64_RATIO`` times the plain path is refused."""
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
    from sartsolver_tpu_torch.utils import fused_parity as fp

    rng = np.random.default_rng(11)
    H = rng.random((48, 256), dtype=np.float32)
    G = np.stack([H @ (rng.random(256) + 0.5)] * 2) * [[1.0], [1.1]]
    opts = SolverOptions(max_iterations=6, conv_tolerance=0.0)
    solver = DistributedSARTSolver(H, opts=opts, device="cpu")
    reference = DistributedSARTSolver(H.astype(np.float64), opts=dataclasses.replace(
        opts, dtype="float64"), device="cpu")
    out = fp.measure_kernel_vs_plain(solver, G, reps=1, reference=reference)
    assert out["kernel_launches"] == out["plain_launches"] == 0
    assert out["parity_max_abs_diff"] == 0.0 and out["kernel_to_plain"] == 0.0
    assert out["kernel_to_fp64"] == out["plain_to_fp64"] > 0.0
    assert out["plain_to_fp64"] < fp.PARITY_RTOL

    solve = fp.solve_kernel_and_plain

    def far_kernel(*args, **kw):
        rec, sols = solve(*args, **kw)
        gap = fp.fp64_distances(reference, G, sols)["plain_to_fp64"]
        sols["kernel"] = sols["kernel"] + (fp.FP64_RATIO + 1.0) * gap * np.abs(
            sols["kernel"]).max()
        return rec, sols

    monkeypatch.setattr(fp, "solve_kernel_and_plain", far_kernel)
    with pytest.raises(ValueError, match="from fp64"):
        fp.measure_kernel_vs_plain(solver, G, reps=1, reference=reference)
