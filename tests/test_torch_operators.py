"""The port's operator layer (``sartsolver_tpu_torch/operators/``) against the
JAX package's, on the CPU.

Ports the one-device, non-serving cases of ``tests/test_operator.py``'s first
two layers: geometry records (round trip, the name-sorted pixel-row
convention, the ``BAD_RECORDS`` validation taxonomy, frame masks and the
voxel-map surface), the operator contract (identity, accounting and cache
keys of the dense, tile-skip and implicit operators, equal to the JAX
package's), the implicit spec and panel rules, the entries as ray segment
lengths (bit-equal to the JAX package's materialized matrix, on a world whose
rays ride the grid's faces too), the conversion of JAX operators
(``models/convert.py:operator_from_jax``), the options, the implicit
restrictions with the JAX messages, and ``sartsolve --geometry`` end to end
against the JAX CLI. The solver parity of the implicit operator is
``tests/test_torch_implicit.py``, the factored operator
``tests/test_torch_lowrank.py``, the card ``tests/test_torch_operators_gpu.py``.

Not ported here: the pixel- and voxel-sharded legs (the port runs one
device; queue A item 4) and the serving engine's session, ``submit
--geometry`` and serve legs (queue A item 5).
"""

import json
import os

import h5py
import numpy as np
import pytest
import torch

import fixtures as fx
import test_operator as T
from sartsolver_tpu.cli import main as jax_main
from sartsolver_tpu.config import SartInputError as JaxInputError
from sartsolver_tpu.config import SolverOptions as JaxOptions
from sartsolver_tpu.operators import (
    DenseOperator as JaxDense,
    ImplicitOperator as JaxImplicit,
    TileSkipOperator as JaxTileSkip,
)
from sartsolver_tpu.operators import geometry as jgeo
from sartsolver_tpu.operators import implicit as jimp
from sartsolver_tpu.ops import sparse as jsparse
from sartsolver_tpu.parallel.mesh import make_mesh
from sartsolver_tpu.parallel.sharded import DistributedSARTSolver as JaxSolver

from sartsolver_tpu_torch.cli import main as torch_main
from sartsolver_tpu_torch.config import SartInputError, SolverOptions
from sartsolver_tpu_torch.models.convert import operator_from_jax
from sartsolver_tpu_torch.operators import (
    DenseOperator,
    ImplicitOperator,
    TileSkipOperator,
)
from sartsolver_tpu_torch.operators import geometry as tgeo
from sartsolver_tpu_torch.operators import implicit as timp
from sartsolver_tpu_torch.ops import sparse as tsparse
from sartsolver_tpu_torch.ops.laplacian import make_laplacian
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

PARITY_RTOL = 2e-4

# rays along the grid's planes (tests/test_torch_operators_gpu.py:FACE_WORLD)
FACE_WORLD = {
    "format": "sart-geometry", "version": 1,
    "grid": {"shape": [8, 8, 4], "origin": [-0.3, 0.1, 0.0], "spacing": [0.7, 0.3, 1.1]},
    "cameras": [
        {"name": "c", "rows": 9, "cols": 9, "position": [-10.0, 1.3, 2.2],
         "target": [2.5, 1.3, 2.2], "up": [0, 0, 1], "pitch": 0.35},
        {"name": "d", "rows": 5, "cols": 7, "position": [1.1, -9.0, 0.0],
         "target": [1.1, 1.0, 0.0], "up": [0, 0, 1], "pitch": 0.3},
    ],
}


def _record():
    return tgeo.parse_geometry(json.loads(json.dumps(T.GEO_DICT)))


# ---- geometry records -------------------------------------------------------

def test_geometry_roundtrip(tmp_path):
    rec = _record()
    path = str(tmp_path / "geom.json")
    tgeo.save_geometry(rec, path)
    back = tgeo.load_geometry(path)
    assert back == rec
    assert ImplicitOperator(back).cache_key() == ImplicitOperator(rec).cache_key()
    np.testing.assert_array_equal(back.build_rays(), rec.build_rays())
    # either package reads the other's file, to the same record
    assert jgeo.load_geometry(path).to_dict() == rec.to_dict()
    jpath = str(tmp_path / "jgeom.json")
    jgeo.save_geometry(T._record(), jpath)
    assert tgeo.load_geometry(jpath) == rec
    with open(path) as a, open(jpath) as b:
        assert a.read() == b.read()


def test_geometry_cameras_sorted_by_name():
    shuffled = json.loads(json.dumps(T.GEO_DICT))
    shuffled["cameras"].reverse()
    rec = tgeo.parse_geometry(shuffled)
    assert rec.camera_names == ("camA", "camB")
    np.testing.assert_array_equal(rec.build_rays(), _record().build_rays())
    rays = rec.build_rays()
    assert rays.shape == (rec.npixel, 6)
    np.testing.assert_allclose(np.linalg.norm(rays[:, 3:], axis=1), 1.0, rtol=1e-12)
    # the JAX package's rays, byte for byte
    assert rays.tobytes() == jgeo.parse_geometry(shuffled).build_rays().tobytes()


@pytest.mark.parametrize("path,value,match", T.BAD_RECORDS,
                         ids=[m for *_, m in T.BAD_RECORDS])
def test_geometry_validation(path, value, match):
    payload = T._mutate(path, value)
    with pytest.raises(SartInputError, match=match) as got:
        tgeo.parse_geometry(payload)
    with pytest.raises(JaxInputError) as want:
        jgeo.parse_geometry(T._mutate(path, value))
    assert str(got.value) == str(want.value)


def test_geometry_rejects_non_json_and_unknown_version_text():
    with pytest.raises(SartInputError, match="JSON"):
        tgeo.parse_geometry("{not json")
    with pytest.raises(SartInputError, match="object"):
        tgeo.parse_geometry([1, 2, 3])
    with pytest.raises(SartInputError, match="Cannot read geometry record"):
        tgeo.load_geometry("/nonexistent/geom.json")


def test_geometry_frame_masks_and_voxel_grid(tmp_path):
    rec = _record()
    masks = rec.frame_masks()
    assert set(masks) == {"camA", "camB"}
    assert masks["camA"].shape == (3, 4) and masks["camA"].all()
    assert masks["camB"].shape == (2, 3) and masks["camB"].all()
    grid = tgeo.GeometryVoxelGrid(rec)
    assert grid.nvox == rec.nvoxel == 64
    np.testing.assert_array_equal(grid.voxmap, np.arange(64))
    assert (grid.nx, grid.ny, grid.nz) == (4, 4, 4)
    assert grid.xmax == pytest.approx(4.0)
    # the JAX package's grid, attribute for attribute
    jgrid = jgeo.GeometryVoxelGrid(T._record())
    for name in ("nx", "ny", "nz", "xmin", "xmax", "ymin", "ymax", "zmin", "zmax",
                 "dx", "dy", "dz", "nvox"):
        assert getattr(grid, name) == getattr(jgrid, name), name
    np.testing.assert_array_equal(grid.voxmap, jgrid.voxmap)


# ---- the operator contract --------------------------------------------------

def test_operator_identity_and_accounting():
    rec = _record()
    op = ImplicitOperator(rec)
    jop = JaxImplicit(T._record())
    H = op.materialize().astype(np.float64)
    assert op.kind == "implicit"
    assert op.shape == (18, 64)
    payload = op.payload()
    assert payload.shape == (18, 6) and payload.dtype == np.float32
    assert payload.tobytes() == jop.payload().tobytes()
    assert op.resident_nbytes() == 18 * 6 * 4 == 432 == jop.resident_nbytes()
    dense = DenseOperator(H.astype(np.float32))
    assert dense.resident_nbytes() == 18 * 64 * 4
    assert op.resident_nbytes() < dense.resident_nbytes() / 10
    key = op.cache_key()
    assert key.startswith("implicit:18x64:float32:")
    assert key == jop.cache_key() == ImplicitOperator(_record()).cache_key()
    moved = json.loads(json.dumps(T.GEO_DICT))
    moved["cameras"][0]["position"][0] -= 0.5
    assert ImplicitOperator(tgeo.parse_geometry(moved)).cache_key() != key
    assert dense.cache_key() != key
    assert dense.cache_key() == JaxDense(H.astype(np.float32)).cache_key()
    np.testing.assert_array_equal(dense.materialize(), H.astype(np.float32))
    shape_only = DenseOperator(npixel=18, nvoxel=64)
    assert shape_only.resident_nbytes() == 18 * 64 * 4
    with pytest.raises(ValueError, match="shape-only"):
        shape_only.payload()
    # the spec: the JAX operator's, field for field
    spec, jspec = op.spec(), jop.spec()
    assert dataclasses_equal(spec, jspec)
    assert spec.nvoxel == 128 and spec.n_panels == 1


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return (type(a).__name__ == type(b).__name__
            and dataclasses.asdict(a) == dataclasses.asdict(b))


def test_tileskip_operator_accounting():
    H = np.random.default_rng(3).random((16, 256)).astype(np.float32)
    H[:, 128:] = 0.0
    occ = tsparse.build_tile_occupancy(H)
    jocc = jsparse.build_tile_occupancy(H)
    op, jop = TileSkipOperator(H, occ), JaxTileSkip(H, jocc)
    assert op.kind == "tileskip"
    assert op.resident_nbytes() == jop.resident_nbytes()
    assert op.cache_key() == jop.cache_key()
    assert op.tile_occupancy() is occ
    with pytest.raises(TypeError, match="TileOccupancy"):
        TileSkipOperator(H, "not an index")


def test_implicit_spec_validation():
    for kw, match in (
            (dict(nvoxel=128, grid_voxels=65, panel_voxels=128, grid_shape=(4, 4, 4)),
             "multiply out"),
            (dict(nvoxel=128, grid_voxels=512, panel_voxels=128, grid_shape=(8, 8, 8)),
             "smaller than the"),
            (dict(nvoxel=128, grid_voxels=64, panel_voxels=96, grid_shape=(4, 4, 4)),
             "divide")):
        with pytest.raises(ValueError, match=match) as got:
            timp.ImplicitSpec(origin=(0, 0, 0), spacing=(1, 1, 1), **kw)
        with pytest.raises(ValueError) as want:
            jimp.ImplicitSpec(origin=(0, 0, 0), spacing=(1, 1, 1), **kw)
        assert str(got.value) == str(want.value)


def test_pick_implicit_panel():
    for n in (128, 1024, 2048, 1280, 65536, 3 * 128, 131072):
        assert timp.pick_implicit_panel(n) == jimp.pick_implicit_panel(n)
    assert timp.pick_implicit_panel(2048) == 1024
    assert 1280 % timp.pick_implicit_panel(1280) == 0
    with pytest.raises(ValueError, match="multiple"):
        timp.pick_implicit_panel(100)
    # the port's solver panel over unpadded voxels
    assert timp.divisor_panel(64) == 64
    assert timp.divisor_panel(65536) == 1024
    assert timp.divisor_panel(1021) == 1021  # prime, under the ceiling
    assert timp.divisor_panel(2 * 1031) == 2  # 1031 is prime, past it
    assert 3000 % timp.divisor_panel(3000) == 0 and timp.divisor_panel(3000) <= 1024


def test_matrix_entries_are_ray_segment_lengths():
    H = ImplicitOperator(_record()).materialize().astype(np.float64)
    assert (H >= 0).all()
    assert H.max() <= np.sqrt(3.0) + 1e-6
    chords = H.sum(axis=1)
    assert chords.max() <= np.sqrt(3.0) * 4 + 1e-6
    assert (chords > 0).sum() >= 12


@pytest.mark.parametrize("world", ["canonical", "faces"])
def test_entries_bit_equal_to_the_jax_package(world):
    """The plain version's entries are the JAX slab kernel's, bit for bit,
    on the canonical geometry and on one whose rays run parallel to the
    grid's axes along its faces (the half-open [lo, hi) rule)."""
    payload = T.GEO_DICT if world == "canonical" else FACE_WORLD
    rec = tgeo.parse_geometry(json.loads(json.dumps(payload)))
    jrec = jgeo.parse_geometry(json.loads(json.dumps(payload)))
    got, want = ImplicitOperator(rec).materialize(), JaxImplicit(jrec).materialize()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 20
    # any chunking of the columns gives the same entries
    op = ImplicitOperator(rec)
    spec = op.spec(padded_nvoxel=rec.nvoxel, panel_voxels=timp.divisor_panel(rec.nvoxel))
    np.testing.assert_array_equal(timp.materialize_rtm(op.payload(), spec), want)


def test_operator_from_jax():
    """The JAX package's operators carried across as numpy state."""
    jop = JaxImplicit(T._record())
    op = operator_from_jax(jop)
    assert isinstance(op, ImplicitOperator) and op.cache_key() == jop.cache_key()
    H = op.materialize()
    dense = operator_from_jax(JaxDense(H))
    assert isinstance(dense, DenseOperator) and dense.cache_key() == JaxDense(H).cache_key()
    assert operator_from_jax(JaxDense(npixel=3, nvoxel=5)).resident_nbytes() == 60
    Hs = H.copy()
    Hs[:, 32:] = 0.0
    jts = JaxTileSkip(Hs, jsparse.build_tile_occupancy(Hs))
    ts = operator_from_jax(jts)
    assert isinstance(ts, TileSkipOperator) and ts.cache_key() == jts.cache_key()
    with pytest.raises(ValueError, match="unknown operator kind"):
        operator_from_jax(type("Op", (), {"kind": "other"})())


# ---- options and restrictions -----------------------------------------------

@pytest.mark.parametrize("value", ["off", "auto", "4", "16"])
def test_lowrank_options_match_the_jax_package(value):
    a, b = SolverOptions(lowrank_rtm=value), JaxOptions(lowrank_rtm=value)
    assert a.lowrank_rank() == b.lowrank_rank()
    assert a.lowrank_explicit() == b.lowrank_explicit()


@pytest.mark.parametrize("kw", [dict(lowrank_rtm="0"), dict(lowrank_rtm="x"),
                                dict(lowrank_rtm="auto", fused_sweep="on"),
                                dict(lowrank_rtm="4", sparse_rtm="1e-8")])
def test_lowrank_option_refusals_match_the_jax_package(kw):
    with pytest.raises(ValueError) as got:
        SolverOptions(**kw)
    with pytest.raises(ValueError) as want:
        JaxOptions(**kw)
    assert str(got.value) == str(want.value)


# (the JAX suite's "voxel-sharded" leg waits for the port's meshes, queue A
# item 4; "fused-interpret" is no option of the port's)
RESTRICTION_LEGS = [
    ("int8", {"rtm_dtype": "int8"}, "int8"),
    ("integrity", {"integrity": True}, "integrity"),
    ("sparse-explicit", {"sparse_rtm": "1e-8"}, "block-"),
    ("fused-on", {"fused_sweep": "on"}, "fused_sweep"),
]


@pytest.mark.parametrize("name,kw,match", RESTRICTION_LEGS,
                         ids=[leg[0] for leg in RESTRICTION_LEGS])
def test_implicit_restrictions(name, kw, match):
    base = dict(max_iterations=5, conv_tolerance=1e-30)
    if "fused_sweep" not in kw:
        base["fused_sweep"] = "off"
    with pytest.raises(SartInputError, match=match) as got:
        DistributedSARTSolver(operator=ImplicitOperator(_record()),
                              opts=SolverOptions(**base, **kw), device="cpu")
    with pytest.raises(JaxInputError) as want:
        JaxSolver(operator=JaxImplicit(T._record()), opts=JaxOptions(**base, **kw),
                  mesh=make_mesh(1, 1))
    assert str(got.value) == str(want.value)


def test_implicit_rejects_laplacian_and_matrix_conflicts():
    op = ImplicitOperator(_record())
    opts = SolverOptions(max_iterations=5, conv_tolerance=0.0, fused_sweep="off")
    lap = make_laplacian(np.array([0]), np.array([0]), np.array([1.0], np.float32),
                         nvoxel=64, device="cpu")
    with pytest.raises(SartInputError, match="beta_laplace"):
        DistributedSARTSolver(operator=op, laplacian=lap, opts=opts, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        DistributedSARTSolver(op.materialize(), operator=op, opts=opts, device="cpu")
    with pytest.raises(ValueError, match="needs a matrix"):
        DistributedSARTSolver(opts=opts, device="cpu")
    # the solver core refuses an implicit problem with the Laplacian too
    from sartsolver_tpu_torch.models import sart as tsart

    spec = op.spec(padded_nvoxel=64, panel_voxels=64)
    problem = tsart.make_implicit_problem(op.payload(), spec, opts=opts, device="cpu")
    with pytest.raises(ValueError, match="beta_laplace"):
        tsart.solve_normalized_batch(
            problem._replace(laplacian=lap), torch.ones((1, 18)), torch.ones(1),
            torch.zeros((1, 64)), opts=opts, use_guess=True, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        tsart.make_implicit_problem(op.payload(), spec, opts=SolverOptions(
            rtm_dtype="int8"), device="cpu")


# ---- sartsolve --geometry against the JAX CLI -------------------------------

def _geometry_inputs(tmp_path):
    rec = T._record()
    geo_path = str(tmp_path / "geom.json")
    jgeo.save_geometry(rec, geo_path)
    paths, g = T._image_files_for(rec, str(tmp_path))
    return geo_path, paths, g


def _solution(path):
    with h5py.File(path, "r") as f:
        return {k: f["solution"][k][...] for k in f["solution"]}, f["voxel_map/value"][...]


def _rc(main, argv) -> int:
    """A CLI's exit code, whether it returns it or exits with it."""
    try:
        return main(argv)
    except SystemExit as err:
        return err.code


@pytest.mark.parametrize("flags", [[], ["-L"], ["--os_subsets", "3"],
                                   ["--no_guess", "--batch_frames", "2"]],
                         ids=["linear", "log", "os", "batch"])
def test_cli_geometry_against_the_jax_cli(tmp_path, flags, capsys):
    """``sartsolve --geometry`` of both packages on the same record and
    images (the JAX CLI at ``--pixel_shards 1``). In the fp64 profile
    (``--use_cpu``): equal statuses and iterations, solutions within 1e-8;
    in the fp32 profile equal statuses, fitted space within 5e-3 (fp32 stop
    iterations may differ where the stall test meets an exact-zero dC,
    ROADMAP §C items 2-4); the same voxel map; the port prints the JAX
    CLI's line."""
    geo_path, paths, _g = _geometry_inputs(tmp_path)
    common = ["--geometry", geo_path, "-m", "40", "-c", "1e-30", *flags, *paths]
    H = ImplicitOperator(_record()).materialize().astype(np.float64)
    for profile, extra in (("fp64", ["--use_cpu"]), ("fp32", [])):
        t_out, j_out = str(tmp_path / f"t{profile}.h5"), str(tmp_path / f"j{profile}.h5")
        dev = [] if extra else ["--device", "cpu"]
        assert torch_main(["-o", t_out, *dev, *extra, *common]) == 0
        out = capsys.readouterr().out
        assert ("implicit: ray table resident (432 bytes; a materialized RTM would "
                "stage 4608)") in out
        assert jax_main(["-o", j_out, "--pixel_shards", "1", "--fused_sweep", "off",
                         *extra, *common]) == 0
        (a, vm_a), (b, vm_b) = _solution(t_out), _solution(j_out)
        assert a["value"].shape == (2, 64)
        np.testing.assert_array_equal(a["status"], b["status"])
        np.testing.assert_allclose(a["time"], b["time"])
        np.testing.assert_array_equal(vm_a, vm_b)
        if profile == "fp64":
            np.testing.assert_array_equal(a["iterations"], b["iterations"])
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-8,
                                       atol=1e-8 * np.abs(b["value"]).max())
        else:
            fa, fb = a["value"] @ H.T, b["value"] @ H.T
            dist = np.linalg.norm(fa - fb, axis=1) / np.linalg.norm(fb, axis=1)
            assert dist.max() <= 5e-3, dist


@pytest.mark.parametrize("case", ["matrix-files", "camera-mismatch", "int8",
                                  "laplacian", "lowrank", "integrity"])
def test_cli_geometry_refusals_match_the_jax_cli(tmp_path, capsys, case):
    """Each refusal exits 1 in both CLIs with the same words."""
    geo_path, paths, _g = _geometry_inputs(tmp_path)
    argv = ["--geometry", geo_path, *paths]
    if case == "matrix-files":
        os.makedirs(tmp_path / "w")
        wpaths, *_ = fx.write_world(str(tmp_path / "w"), n_frames=2)
        argv = ["--geometry", geo_path, wpaths["rtm_a1"], *paths]
    elif case == "camera-mismatch":
        other = json.loads(json.dumps(T.GEO_DICT))
        other["cameras"][1]["name"] = "camC"
        with open(tmp_path / "geom2.json", "w") as f:
            json.dump(other, f)
        argv = ["--geometry", str(tmp_path / "geom2.json"), *paths]
    elif case == "int8":
        argv += ["--rtm_dtype", "int8"]
    elif case == "laplacian":
        lap = str(tmp_path / "lap.h5")
        fx.write_laplacian_file(lap, 64)
        argv += ["-l", lap]
    elif case == "lowrank":
        argv += ["--lowrank_rtm", "4"]
    elif case == "integrity":
        argv += ["--integrity"]
    capsys.readouterr()
    assert _rc(torch_main, ["-o", str(tmp_path / "t.h5"), "--device", "cpu", *argv]) == 1
    got = capsys.readouterr().err.strip().splitlines()
    assert _rc(jax_main, ["-o", str(tmp_path / "j.h5"), "--pixel_shards", "1", *argv]) == 1
    want = capsys.readouterr().err.strip().splitlines()
    assert got and want
    assert got[-1] == want[-1]
