"""Carry a problem across from the JAX package as numpy arrays.

``problem_from_numpy`` builds this package's :class:`SARTProblem` from the
leaves of a JAX ``SARTProblem`` (``np.asarray(jax_problem.rtm)`` and so on),
so the same problem runs through both packages. Only numpy crosses over:
nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.device import resolve_device
from sartsolver_tpu_torch.models.sart import SARTProblem, torch_dtype
from sartsolver_tpu_torch.ops.laplacian import make_laplacian


def problem_from_numpy(rtm, ray_density, ray_length, lap_rows=None,
                       lap_cols=None, lap_vals=None, *, opts: SolverOptions,
                       device="cuda") -> SARTProblem:
    """``rtm`` [P, V], ``ray_density`` [V] and ``ray_length`` [P], all in
    ``opts.dtype``; the Laplacian as COO triplets over ``[V, V]`` (all three
    or none). Raises ValueError on a shape or dtype that does not fit."""
    dev = resolve_device(device)
    want = np.dtype(opts.dtype)
    rtm = np.asarray(rtm)
    dens = np.asarray(ray_density)
    length = np.asarray(ray_length)
    if rtm.ndim != 2:
        raise ValueError(f"rtm must be [P, V], got shape {rtm.shape}.")
    P, V = rtm.shape
    if dens.shape != (V,) or length.shape != (P,):
        raise ValueError(
            f"ray_density {dens.shape} and ray_length {length.shape} do not "
            f"fit rtm {rtm.shape}: [{V}] and [{P}] expected."
        )
    for name, arr in (("rtm", rtm), ("ray_density", dens), ("ray_length", length)):
        if arr.dtype != want:
            raise ValueError(f"{name} is {arr.dtype}, but opts.dtype is {want}.")
    lap = (lap_rows, lap_cols, lap_vals)
    if any(x is None for x in lap) and not all(x is None for x in lap):
        raise ValueError("Pass all three Laplacian triplet arrays, or none.")
    laplacian = None
    if lap_rows is not None:
        rows, cols, vals = (np.asarray(x) for x in lap)
        if not rows.shape == cols.shape == vals.shape or rows.ndim != 1:
            raise ValueError("Laplacian triplet arrays must be 1-D of one length.")
        laplacian = make_laplacian(rows, cols, vals, nvoxel=V,
                                   dtype=torch_dtype(opts.dtype), device=dev)
    return SARTProblem(
        torch.tensor(rtm, device=dev),
        torch.tensor(dens, device=dev),
        torch.tensor(length, device=dev),
        laplacian,
    )
