"""The operator backends on the card: the implicit projector's CUDA kernel
and the factored and implicit CLI paths.

Needs a CUDA device: every test is marked ``gpu`` and skips without a card.
Run on the card with
``python -m pytest -q --noconftest -m gpu tests/test_torch_operators_gpu.py``.
This file imports no JAX and no h5py.

- the kernel (``ops/csrc/implicit.cu``) against the plain version computed
  on the CPU: every entry bit-equal, column by column and row by row (a
  forward of one-hot operands returns a column's entries, a back
  projection a row's), forward and back at B = 1, 3 and 8 on all rays and
  on the ordered subsets' rows ``t::os``, and the ray stats and
  ordered-subsets densities (os 3 and 4), within 1e-5 of the output's max,
  fp32 and fp64 sums, two calls byte-identical, each launch counted; on a
  world whose rays ride the grid's faces and run parallel to its axes, on a
  small copy of the chip run's geometry world, and on the lattice world
  (:func:`lattice_world`: a ray table built directly, rays through cell
  corners and along lattice lines, origins inside the grid and on its
  faces, rays pointing away, components just above and below the
  parallel threshold, dead rows);
- ``sartsolve --geometry`` and ``sartsolve --lowrank_rtm`` on the card
  against the dense CLI on the same matrix (the materialized geometry, the
  factored matrix's files): equal statuses, fitted distance within 5e-3.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5

# rays along the grid's planes: the centre column of camera "c" runs
# parallel to y at y = 1.3, on the face 0.1 + 4 * 0.3; camera "d"'s rows
# meet the z faces edge-on
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


# the lattice world's grid: its corners are exact in fp32 (origin and
# spacing are multiples of powers of two)
LATTICE_GRID = dict(shape=(6, 5, 4), origin=(-1.0, 0.5, 0.25), spacing=(0.5, 0.25, 1.0))


def lattice_world():
    """``(rays, spec)``: a ``[P, 6]`` fp32 ray table built directly, no
    camera, on :data:`LATTICE_GRID`, and its spec. Its rays are the cases a
    traversal can get wrong: through cell corners, along lattice lines and
    lattice diagonals (``d ~ (1, 1, 0)`` from a lattice point), origins
    inside the grid and on its faces, rays pointing away from it, rays
    parallel to an axis on the grid's faces, direction components just
    above and just below the parallel threshold (1e-7), and dead rows."""
    from sartsolver_tpu_torch.operators.implicit import ImplicitSpec

    org = np.array(LATTICE_GRID["origin"])
    sp = np.array(LATTICE_GRID["spacing"])
    n = np.array(LATTICE_GRID["shape"])

    def pt(i, j, k):  # lattice point (i, j, k), exact in fp32
        return org + np.array([i, j, k]) * sp

    eps = np.float32(1e-7)
    above = float(np.nextafter(eps, np.float32(1)))
    below = float(np.nextafter(eps, np.float32(0)))
    rows = []

    def ray(o, d, unit=True):
        d = np.asarray(d, np.float64)
        rows.append(np.concatenate([o, d / np.linalg.norm(d) if unit else d]))

    # through cell corners: lattice point to lattice point, from outside
    # the grid, on it and inside
    for a, b in (((-2, -2, -1), (8, 8, 5)), ((-2, -2, -1), (4, 2, 2)), ((0, 0, 0), (6, 5, 4)),
                 ((6, 5, 4), (0, 0, 0)), ((-1, 3, 2), (7, 1, 2)), ((3, -3, 2), (3, 8, 2)),
                 ((1, 1, -2), (5, 4, 6)), ((2, 2, 2), (4, 4, 0)), ((0, 5, 0), (6, 0, 4))):
        ray(pt(*a), pt(*b) - pt(*a))
    # along lattice lines (faces and edges of cells) and lattice diagonals
    for o, d in ((pt(-2, 2, 1), (1, 0, 0)), (pt(3, -1, 3), (0, 1, 0)), (pt(2, 3, -1), (0, 0, 1)),
                 (pt(-1, 0, 2), (1, 1, 0)), (pt(0, 0, 1), (1, 1, 0)), (pt(6, 5, 2), (-1, -1, 0)),
                 (pt(0, 2, 0), (1, 0, 1)), (pt(3, 0, 0), (0, 1, 1)), (pt(-1, -1, -1), (1, 1, 1)),
                 (pt(3, 2, 2), (-1, 1, 0))):
        ray(o, d)
    # axis-parallel on the grid's faces: the low faces belong to the grid,
    # the high ones do not (half-open cells)
    for o, d in ((pt(-2, 0, 0), (1, 0, 0)), (pt(-2, 5, 4), (1, 0, 0)), (pt(0, -2, 4), (0, 1, 0)),
                 (pt(6, 0, -1), (0, 0, 1)), (pt(0, 5, -1), (0, 0, 1)), (pt(3, 2, 4), (-1, 0, 0))):
        ray(o, d)
    # origins inside the grid and on its faces, every direction octant
    rng = np.random.default_rng(15)
    for o in (org + 0.37 * n * sp, org + 0.81 * n * sp, pt(0, 2.5, 1.5), pt(6, 2.5, 1.5),
              pt(3, 0, 2.2), pt(2.4, 5, 3.1), pt(1.5, 1.5, 0), pt(4, 2, 4)):
        for _ in range(4):
            ray(o, rng.normal(size=3))
    # pointing away from the grid
    for o, d in ((pt(-3, 2, 2), (-1, 0.1, 0)), (pt(9, 2, 2), (1, 0, 0.2)),
                 (pt(3, 2, 7), (0.1, 0.1, 1)), (pt(0, 0, 0), (-1, -1, -1))):
        ray(o, d)
    # components just above and just below the parallel threshold, from a
    # lattice face: the tiny slope is followed above it, ignored below
    for o in (pt(-2, 2, 1), pt(-2, 0, 3)):
        for t in (above, below, -above, -below):
            ray(o, (1.0, t, 0.0))
            ray(o, (1.0, 0.0, t))
            ray(o, (1.0, t, -t))
    # far away (a camera's distance) through a corner
    ray(pt(-200, 3, 2), pt(3, 2, 1) - pt(-200, 3, 2))
    # dead rows: zero padding and a direction of norm^2 0.5 (not above it)
    ray(np.zeros(3), np.zeros(3), unit=False)
    ray(pt(1, 1, 1), (0.5, 0.5, 0.0), unit=False)
    ray(pt(2, 2, 2), np.zeros(3), unit=False)
    rays = torch.as_tensor(np.asarray(rows), dtype=torch.float32)
    V = int(np.prod(n))
    spec = ImplicitSpec(grid_shape=LATTICE_GRID["shape"], origin=LATTICE_GRID["origin"],
                        spacing=LATTICE_GRID["spacing"], nvoxel=V, grid_voxels=V,
                        panel_voxels=V)
    return rays, spec


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


def _worlds():
    from sartsolver_tpu_torch.operators.geometry import parse_geometry

    cs = _chip_smoke()
    return {"face": parse_geometry(FACE_WORLD),
            "small": cs.geometry_record(16, 16, 8, cam=(16, 16))}


@pytest.fixture(scope="module")
def worlds():
    _needs_card()
    from sartsolver_tpu_torch.operators.implicit import ImplicitOperator, divisor_panel

    out = {}
    for name, rec in _worlds().items():
        op = ImplicitOperator(rec)
        spec = op.spec(padded_nvoxel=rec.nvoxel, panel_voxels=divisor_panel(rec.nvoxel))
        rays = torch.as_tensor(op.payload())
        out[name] = (rays, rays.cuda(), spec)
    rays, spec = lattice_world()
    out["lattice"] = (rays, rays.cuda(), spec)
    return out


WORLDS = ["face", "small", "lattice"]


def _close(got, want):
    got, want = got.cpu().double(), want.cpu().double()
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORLDS)
def test_entries_bit_equal(worlds, name):
    """Every entry: every column through one-hot forwards, every row
    through one-hot back projections."""
    from sartsolver_tpu_torch.operators import implicit as im

    rays, rays_d, spec = worlds[name]
    want = im.panel_lengths(rays, 0, spec, spec.nvoxel)  # [P, V] on the CPU
    P, V = want.shape
    for c0 in range(0, V, 256):
        pick = torch.arange(c0, min(c0 + 256, V))
        f = torch.zeros((len(pick), V), device="cuda")
        f[torch.arange(len(pick)), pick.cuda()] = 1.0
        got = im.implicit_forward(rays_d, f, spec)  # [b, P] = the entries of the columns
        assert torch.equal(got.cpu(), want[:, pick].T.contiguous()), (c0, pick[-1])
    for r0 in range(0, P, 256):
        pick = torch.arange(r0, min(r0 + 256, P))
        w = torch.zeros((len(pick), P), device="cuda")
        w[torch.arange(len(pick)), pick.cuda()] = 1.0
        got = im.implicit_back(rays_d, w, spec)  # [b, V] = the entries of the rows
        assert torch.equal(got.cpu(), want[pick]), (r0, pick[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORLDS)
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forward_and_back_against_the_plain_version(worlds, name, B, dtype):
    from sartsolver_tpu_torch.operators import implicit as im

    rays, rays_d, spec = worlds[name]
    rng = np.random.default_rng(B)
    f = torch.as_tensor(rng.uniform(0.0, 2.0, (B, spec.nvoxel)), dtype=dtype)
    w = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, rays.shape[0])), dtype=dtype)
    im.reset_launch_counts()
    fwd = im.implicit_forward(rays_d, f.cuda(), spec, accum_dtype=dtype)
    back = im.implicit_back(rays_d, w.cuda(), spec, accum_dtype=dtype)
    assert fwd.dtype == back.dtype == dtype
    assert im.implicit_forward.launches == im.implicit_back.launches == 1
    _close(fwd, im.implicit_forward(rays, f, spec, accum_dtype=dtype))
    _close(back, im.implicit_back(rays, w, spec, accum_dtype=dtype))
    # deterministic: the same bytes again
    assert torch.equal(fwd, im.implicit_forward(rays_d, f.cuda(), spec, accum_dtype=dtype))
    assert torch.equal(back, im.implicit_back(rays_d, w.cuda(), spec, accum_dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORLDS)
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_subset_rows_against_the_plain_version(worlds, name, B, dtype):
    """The ordered subsets' products (models/sart.py ``fp_rows`` /
    ``bp_rows``): forward and back on the rays ``t::os``."""
    from sartsolver_tpu_torch.operators import implicit as im

    rays, rays_d, spec = worlds[name]
    rng = np.random.default_rng(10 + B)
    for os_ in (3, 4):
        for t in range(os_):
            sub, sub_d = rays[t::os_], rays_d[t::os_]
            f = torch.as_tensor(rng.uniform(0.0, 2.0, (B, spec.nvoxel)), dtype=dtype)
            w = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, sub.shape[0])), dtype=dtype)
            fwd = im.implicit_forward(sub_d, f.cuda(), spec, accum_dtype=dtype)
            back = im.implicit_back(sub_d, w.cuda(), spec, accum_dtype=dtype)
            _close(fwd, im.implicit_forward(sub, f, spec, accum_dtype=dtype))
            _close(back, im.implicit_back(sub, w, spec, accum_dtype=dtype))
            assert torch.equal(fwd, im.implicit_forward(sub_d, f.cuda(), spec, accum_dtype=dtype))
            assert torch.equal(back, im.implicit_back(sub_d, w.cuda(), spec, accum_dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORLDS)
def test_ray_stats_and_subset_densities(worlds, name):
    from sartsolver_tpu_torch.operators import implicit as im

    rays, rays_d, spec = worlds[name]
    im.reset_launch_counts()
    dens, length = im.implicit_ray_stats(rays_d, spec)
    assert im.implicit_forward.launches == im.implicit_back.launches == 1
    want_d, want_l = im.implicit_ray_stats(rays, spec)
    _close(dens, want_d)
    _close(length, want_l)
    P = rays.shape[0]
    for n in (3, 4):
        rows = -(-P // n) * n
        padded = torch.cat([rays, rays.new_zeros((rows - P, 6))])
        got = im.implicit_subset_density(padded.cuda(), spec, n)
        _close(got, im.implicit_subset_density(padded, spec, n))


@pytest.mark.gpu
def test_cuda_tensor_never_takes_the_plain_version(worlds, monkeypatch):
    from sartsolver_tpu_torch.operators import implicit as im

    _rays, rays_d, spec = worlds["face"]

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(im, "_forward_reference", refuse)
    monkeypatch.setattr(im, "_back_reference", refuse)
    monkeypatch.setattr(im, "panel_lengths", refuse)
    f = torch.ones((2, spec.nvoxel), device="cuda")
    assert im.implicit_forward(rays_d, f, spec).shape == (2, rays_d.shape[0])
    im.implicit_ray_stats(rays_d, spec)


# ---- the CLI paths on the card against their dense twins ------------------

FIT_TOL = 5e-3


def _fit_distance(H, a, b):
    Ht = torch.as_tensor(H, device="cuda")
    fa = Ht @ torch.as_tensor(a.T, dtype=torch.float32, device="cuda")
    fb = Ht @ torch.as_tensor(b.T, dtype=torch.float32, device="cuda")
    return ((fa - fb).norm(dim=0) / fb.norm(dim=0)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [[], ["-L"], ["--no_guess", "--batch_frames", "3"],
                                   ["--os_subsets", "4"]],
                         ids=["linear", "log", "batch", "os"])
def test_geometry_cli_against_the_dense_twin(tmp_path, flags):
    _needs_card()
    cs = _chip_smoke()
    from sartsolver_tpu_torch.operators import implicit as im

    gw = cs.write_geometry_world(str(tmp_path), 16, 16, 8, cam=(16, 16), n_frames=4)
    im.reset_launch_counts()
    rc, _ms, text = cs.run_cli(["-o", str(tmp_path / "imp.h5"), "--geometry", gw["geometry"],
                                gw["paths"]["img_a"], gw["paths"]["img_b"], "-m", "200",
                                *flags])
    assert rc == 0, text
    assert "implicit: ray table resident" in text
    assert im.implicit_forward.launches > 0 and im.implicit_back.launches > 0
    rc, _ms, text = cs.run_cli(["-o", str(tmp_path / "dense.h5"), *gw["inputs"], "-m", "200",
                                *flags])
    assert rc == 0, text
    a, _ = cs.check_solution(str(tmp_path / "imp.h5"), gw, 4, 200, "cuda", fit_bound=None)
    b, _ = cs.check_solution(str(tmp_path / "dense.h5"), gw, 4, 200, "cuda", fit_bound=None)
    assert a["status"].tolist() == b["status"].tolist()
    assert _fit_distance(gw["H"], a["value"], b["value"]) <= FIT_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_lowrank_cli_against_dense(tmp_path, storage):
    _needs_card()
    cs = _chip_smoke()
    rw = cs.write_reflective_world(str(tmp_path), nx=64, ny=64, cam=(32, 32), n_frames=4)
    p = rw["paths"]
    inputs = [p["rtm_a_seg1"], p["rtm_a_seg2"], p["rtm_b"], p["img_a"], p["img_b"]]
    out = {}
    for mode in ("auto", "off"):
        rc, _ms, text = cs.run_cli(["-o", str(tmp_path / f"{mode}.h5"), *inputs, "-m", "200",
                                    "--rtm_dtype", storage, "--lowrank_rtm", mode])
        assert rc == 0, text
        if mode == "auto":
            assert "lowrank: factored operator H ~= S + U V^T rank=4" in text, text
        out[mode], _ = cs.check_solution(str(tmp_path / f"{mode}.h5"), rw, 4, 200, "cuda",
                                         fit_bound=None)
    assert out["auto"]["status"].tolist() == out["off"]["status"].tolist()
    assert _fit_distance(rw["H"], out["auto"]["value"], out["off"]["value"]) <= FIT_TOL
    rc, _ms, _text = cs.run_cli(["-o", str(tmp_path / "r2.h5"), *inputs, "--lowrank_rtm", "2"])
    assert rc == 1


@pytest.mark.gpu
@pytest.mark.parametrize("rank", ["auto", 4, 2])
def test_lowrank_gate_on_the_card_against_the_host(tmp_path, rank):
    """The factorization gate with its arithmetic on the card against the
    same gate on the host, on a small reflective world: the same decision
    (auto takes rank 4, rank 2 fails the Frobenius gate with the same
    words), the same core ``S`` bytes, ``U V^T`` within 1e-5 of the host
    factors' product."""
    from sartsolver_tpu_torch.config import SartInputError
    from sartsolver_tpu_torch.operators.lowrank import build_lowrank_operator

    _needs_card()
    H = _chip_smoke().write_reflective_world(str(tmp_path), nx=64, ny=64, cam=(32, 32),
                                             n_frames=2)["H"]
    if rank == 2:
        with pytest.raises(SartInputError, match="factorization gate") as card:
            build_lowrank_operator(H, rank=rank, device="cuda")
        with pytest.raises(SartInputError) as host:
            build_lowrank_operator(H, rank=rank, device="cpu")
        assert str(card.value).split(" = ")[0] == str(host.value).split(" = ")[0]
        return
    card, why_card = build_lowrank_operator(H, rank=rank, device="cuda")
    host, why_host = build_lowrank_operator(H, rank=rank, device="cpu")
    assert why_card is None and why_host is None and card.rank == host.rank == 4
    assert card.payload().tobytes() == host.payload().tobytes()
    (u, v), (hu, hv) = card.factors(), host.factors()
    got = u.astype(np.float64) @ v.T.astype(np.float64)
    want = hu.astype(np.float64) @ hv.T.astype(np.float64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
