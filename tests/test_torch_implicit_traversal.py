"""The implicit projector's traversal, on the CPU.

The kernel (``ops/csrc/implicit.cu``) evaluates only candidate cells: the
forward walks each ray's x-slabs, y rows and z cells, the back culls rays
per brick of cells. ``operators/implicit.py`` repeats that choice operation
for operation in plain torch (:func:`candidate_cells`,
:func:`tile_survivors`); nothing on the main path calls it. A cell the
traversal missed would be a silent wrong answer, so these tests hold the
candidates against every nonzero entry of the plain version
(:func:`panel_lengths`):

- on the ``face`` and ``small`` worlds of ``tests/test_torch_operators_gpu.py``
  and its ``lattice`` world (rays through corners and along lattice lines,
  components at the parallel threshold, dead rows), and on rays hypothesis
  draws under a fixed seed (tiny components, origins on faces and inside
  the grid, lattice crossings);
- the work cut on the chip run's geometry world (8192 rays x 65,536
  voxels): the forward's candidates at most ``FORWARD_MAX_FRACTION`` of V
  for any ray, the back's evaluations at most ``BACK_MAX_FRACTION`` of
  P x V;
- :func:`pair_lengths` gives the plain version's entries bit for bit (it
  counts the nonzero entries of a world too large to materialize).

This file imports no JAX.
"""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from sartsolver_tpu_torch.operators import implicit as im
from sartsolver_tpu_torch.operators.geometry import parse_geometry
from test_torch_operators_gpu import FACE_WORLD, LATTICE_GRID, lattice_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the work cut on the geometry world: the forward evaluates at most this
# share of the voxels for any ray (measured 0.0034), the back at most this
# share of all ray-voxel pairs (measured 0.0124)
FORWARD_MAX_FRACTION = 0.005
BACK_MAX_FRACTION = 0.02


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def _spec_of(rec):
    op = im.ImplicitOperator(rec)
    spec = op.spec(padded_nvoxel=rec.nvoxel, panel_voxels=im.divisor_panel(rec.nvoxel))
    return torch.as_tensor(op.payload()), spec


def _world(name):
    if name == "face":
        return _spec_of(parse_geometry(FACE_WORLD))
    if name == "small":
        return _spec_of(_chip_smoke().geometry_record(16, 16, 8, cam=(16, 16)))
    return lattice_world()


def _uncovered(rays, spec):
    """``(forward, back)``: the nonzero entries outside the forward's
    candidate cells, and those whose ray does not survive its voxel's
    brick, as ``[n, 2]`` (ray, voxel) rows; and the nonzero count."""
    H = im.panel_lengths(rays, 0, spec, spec.nvoxel)
    ray, vox = im.candidate_pairs(im.candidate_cells(rays, spec), spec)
    cand = torch.zeros_like(H, dtype=torch.bool)
    cand[ray, vox] = True
    fwd = torch.nonzero((H != 0) & ~cand)
    tiles = im.tile_survivors(rays, spec, pairs=True)
    alive = torch.zeros((len(tiles["survivors"]), rays.shape[0]), dtype=torch.bool)
    alive[tiles["pairs"][:, 0], tiles["pairs"][:, 1]] = True
    pr, pv = torch.nonzero(H, as_tuple=True)
    missed = ~alive[im.brick_of(pv, spec), pr]
    return fwd, torch.stack([pr[missed], pv[missed]], dim=1), int((H != 0).sum())


@pytest.mark.parametrize("name", ["face", "small", "lattice"])
def test_candidates_hold_every_nonzero_entry(name):
    rays, spec = _world(name)
    fwd, back, nnz = _uncovered(rays, spec)
    assert nnz > 0
    assert len(fwd) == 0, f"forward misses (ray, voxel) {fwd[:8].tolist()}"
    assert len(back) == 0, f"back misses (ray, voxel) {back[:8].tolist()}"


@pytest.mark.parametrize("name", ["face", "small", "lattice"])
def test_candidates_are_in_the_kernels_order(name):
    """Rows by ray, then voxel id; ranges inside the grid."""
    rays, spec = _world(name)
    rows = im.candidate_cells(rays, spec)
    nx, ny, nz = spec.grid_shape
    key = (rows[:, 0] * nx + rows[:, 1]) * ny + rows[:, 2]
    assert bool((key[1:] > key[:-1]).all())
    assert bool((rows[:, 3] <= rows[:, 4]).all())
    assert bool((rows[:, 3] >= 0).all()) and bool((rows[:, 4] < nz).all())
    # dead rows and rays that miss the grid have no candidates
    H = im.panel_lengths(rays, 0, spec, spec.nvoxel)
    dead = (rays[:, 3:] * rays[:, 3:]).sum(dim=1) <= 0.5
    assert not bool(torch.isin(torch.nonzero(dead).flatten(), rows[:, 0]).any())
    assert bool((H[dead] == 0).all())


@pytest.mark.parametrize("name", ["face", "small", "lattice"])
def test_pair_lengths_are_the_plain_entries(name):
    rays, spec = _world(name)
    H = im.panel_lengths(rays, 0, spec, spec.nvoxel)
    rng = np.random.default_rng(3)
    ray = torch.as_tensor(rng.integers(0, H.shape[0], 4000))
    vox = torch.as_tensor(rng.integers(0, H.shape[1], 4000))
    nz_r, nz_v = torch.nonzero(H, as_tuple=True)
    ray, vox = torch.cat([ray, nz_r]), torch.cat([vox, nz_v])
    assert torch.equal(im.pair_lengths(rays, ray, vox, spec), H[ray, vox])


def test_brick_of_matches_the_kernels_blocks():
    for shape, want in (((64, 64, 16), (4, 4, 8)), ((256, 256, 1), (8, 16, 1)),
                        ((128, 128, 64), (4, 4, 8)), ((6, 5, 4), (4, 8, 4)),
                        ((2, 2, 2), (2, 2, 2)), ((3, 1, 1), (4, 1, 1))):
        assert im.pick_brick(shape) == want, shape
    rays, spec = _world("small")
    e = im.pick_brick(spec.grid_shape)
    nb = [-(-n // k) for n, k in zip(spec.grid_shape, e)]
    tiles = im.tile_survivors(rays, spec)
    assert len(tiles["survivors"]) == nb[0] * nb[1] * nb[2]
    assert int(tiles["cells"].sum()) == spec.grid_voxels
    vox = torch.arange(spec.grid_voxels)
    assert torch.equal(torch.bincount(im.brick_of(vox, spec)), tiles["cells"])


_LATTICE = np.array(LATTICE_GRID["origin"]), np.array(LATTICE_GRID["spacing"])
_EPS32 = np.float32(1e-7)
_COMPONENTS = st.one_of(
    st.sampled_from([0.0, 1.0, -1.0, float(np.nextafter(_EPS32, np.float32(1))),
                     float(np.nextafter(_EPS32, np.float32(0))),
                     -float(np.nextafter(_EPS32, np.float32(1))), 3e-8, -6e-7, 2e-6]),
    st.floats(-1.0, 1.0, allow_nan=False, width=32))
_COORD = st.one_of(
    st.integers(-3, 8).map(float),  # a lattice plane
    st.floats(-3.0, 8.0, allow_nan=False, width=32),  # anywhere, inside or out
    st.integers(0, 6).map(lambda k: k + float(np.float32(1e-6))))  # just off a plane


@st.composite
def _ray(draw):
    org, sp = _LATTICE
    o = org + np.array([draw(_COORD) for _ in range(3)]) * sp
    d = np.array([draw(_COMPONENTS) for _ in range(3)])
    norm = np.linalg.norm(d)
    if norm > 0.5 and draw(st.booleans()):
        d = d / norm  # a unit direction; otherwise as drawn (dead if |d|^2 <= 0.5)
    return np.concatenate([o, d])


@settings(derandomize=True, max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_ray(), min_size=1, max_size=24))
def test_candidates_hold_drawn_rays(rows):
    _, spec = lattice_world()
    rays = torch.as_tensor(np.asarray(rows), dtype=torch.float32)
    fwd, back, _ = _uncovered(rays, spec)
    assert len(fwd) == 0 and len(back) == 0, (fwd[:4].tolist(), back[:4].tolist())


def test_work_cut_on_the_geometry_world():
    """The chip run's geometry world (two 64 x 64 cameras, a 64 x 64 x 16
    grid): the pairs the kernel evaluates, counted by the mirror."""
    rays, spec = _spec_of(_chip_smoke().geometry_record(64, 64, 16, cam=(64, 64)))
    P, V = rays.shape[0], spec.nvoxel
    rows = im.candidate_cells(rays, spec)
    per_ray = torch.bincount(rows[:, 0], weights=(rows[:, 4] - rows[:, 3] + 1).double(),
                             minlength=P)
    assert float(per_ray.max()) <= FORWARD_MAX_FRACTION * V
    tiles = im.tile_survivors(rays, spec)
    back = int((tiles["survivors"] * tiles["cells"]).sum())
    assert back <= BACK_MAX_FRACTION * P * V
    # every ray the cameras aim at the grid has candidates
    assert len(torch.unique(rows[:, 0])) >= P // 2
