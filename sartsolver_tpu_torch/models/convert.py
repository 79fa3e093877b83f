"""Carry a problem across from the JAX package as numpy arrays.

``problem_from_numpy`` builds this package's :class:`SARTProblem` from the
leaves of a JAX ``SARTProblem`` (``np.asarray(jax_problem.rtm)`` and so on),
so the same problem runs through both packages; ``operator_from_jax`` builds
this package's projection operator from a JAX package operator's numpy
state. Only numpy crosses over: nothing here imports JAX, nor
``ml_dtypes``.

A bf16 matrix crosses as its bit pattern: ``np.asarray`` of a JAX bf16
array has the dtype ``ml_dtypes.bfloat16``, which torch does not take, so
its bits are viewed as ``uint16`` (a caller may also pass that ``uint16``
view) and viewed back as ``torch.bfloat16`` here.
"""

from __future__ import annotations

import numpy as np
import torch

from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.device import resolve_device
from sartsolver_tpu_torch.models.sart import SARTProblem, storage_dtype, torch_dtype
from sartsolver_tpu_torch.ops.laplacian import make_laplacian


def _rtm_tensor(rtm: np.ndarray, opts: SolverOptions) -> torch.Tensor:
    """A host copy of the matrix as a tensor of the storage dtype, or
    ValueError."""
    want = storage_dtype(opts)
    if want == torch.bfloat16 and rtm.dtype.itemsize == 2 and rtm.dtype.name in (
            "bfloat16", "uint16"):
        return torch.tensor(rtm.view(np.uint16)).view(torch.bfloat16)
    if want != torch.bfloat16 and rtm.dtype == np.dtype(str(want).removeprefix("torch.")):
        return torch.tensor(rtm)
    raise ValueError(
        f"rtm is {rtm.dtype}, but the storage dtype (opts.rtm_dtype or "
        f"opts.dtype) is {str(want).removeprefix('torch.')}."
    )


def problem_from_numpy(rtm, ray_density, ray_length, lap_rows=None,
                       lap_cols=None, lap_vals=None, *, opts: SolverOptions,
                       device="cuda", rtm_scale=None) -> SARTProblem:
    """``rtm`` [P, V] in the storage dtype (``opts.rtm_dtype`` or
    ``opts.dtype``; int8 codes come with ``rtm_scale`` [V] fp32),
    ``ray_density`` [V] and ``ray_length`` [P] in ``opts.dtype``; the
    Laplacian as COO triplets over ``[V, V]`` (all three or none). Raises
    ValueError on a shape or dtype that does not fit."""
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
    for name, arr in (("ray_density", dens), ("ray_length", length)):
        if arr.dtype != want:
            raise ValueError(f"{name} is {arr.dtype}, but opts.dtype is {want}.")
    rtm_t = _rtm_tensor(rtm, opts)
    scale = None
    if rtm_t.dtype == torch.int8:
        scale = None if rtm_scale is None else np.asarray(rtm_scale)
        if scale is None or scale.shape != (V,) or scale.dtype != np.float32:
            raise ValueError(
                f"int8 codes need their rtm_scale, fp32 [{V}]; got "
                f"{None if scale is None else (scale.dtype, scale.shape)}."
            )
        scale = torch.tensor(scale, device=dev)
    elif rtm_scale is not None:
        raise ValueError("rtm_scale is only valid with rtm_dtype='int8'.")
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
        rtm_t.to(dev),
        torch.tensor(dens, device=dev),
        torch.tensor(length, device=dev),
        laplacian,
        scale,
    )


def operator_from_jax(op):
    """This package's projection operator (``operators/``) for a JAX package
    operator ``op``, from its numpy state, read by duck typing: the
    geometry record's dict (implicit), ``S``, ``U``, ``V`` and the tile
    index's payload (lowrank), the matrix and the index (tile-skip), the
    matrix or the shape (dense). Raises ValueError on another kind."""
    from sartsolver_tpu_torch.operators import (
        DenseOperator, ImplicitOperator, LowRankOperator, TileSkipOperator,
    )
    from sartsolver_tpu_torch.operators.geometry import parse_geometry
    from sartsolver_tpu_torch.ops.sparse import TileOccupancy

    def occupancy():
        return TileOccupancy.from_payload(op.tile_occupancy().to_payload())

    if op.kind == "implicit":
        return ImplicitOperator(parse_geometry(op.record.to_dict()))
    if op.kind == "lowrank":
        u, v = op.factors()
        return LowRankOperator(np.asarray(op.payload()), np.asarray(u), np.asarray(v),
                               occupancy=occupancy())
    if op.kind == "tileskip":
        return TileSkipOperator(np.asarray(op.payload()), occupancy())
    if op.kind == "dense":
        if getattr(op, "_rtm", None) is None:
            return DenseOperator(npixel=op.npixel, nvoxel=op.nvoxel, dtype=op._dtype)
        return DenseOperator(np.asarray(op.payload()))
    raise ValueError(f"unknown operator kind {op.kind!r}")
