"""Ray-transfer-matrix reader.

The JAX package's ``read_rtm_block`` (``sartsolver_tpu/io/raytransfer.py``)
restricted to what a one-device run needs: the whole matrix, or a block of
rows, read on the host. Matches the reference's
``RayTransferMatrix::read_hdf5`` (raytransfer.cpp:27-127):

- cameras (sorted order) advance the global *pixel* offset,
- segments within a camera advance the global *voxel* offset,
- sparse segments are COO scattered into the dense block (NumPy scatter),
- dense segments are hyperslab-read only for the rows in range.
"""

from __future__ import annotations

from typing import Dict, List

from sartsolver_tpu_torch.io import h5
import numpy as np

from sartsolver_tpu_torch.config import SartInputError


def _read_sparse_segment(group, filename: str, start_pixel: int,
                         start_voxel: int, nvoxel: int, dtype):
    """A sparse segment's triplets in global indices, bounds-checked."""
    pixel_index = np.asarray(group["pixel_index"], np.int64) + start_pixel
    voxel_index = np.asarray(group["voxel_index"], np.int64) + start_voxel
    value = np.asarray(group["value"], dtype)
    if voxel_index.size and (
        int(voxel_index.max()) >= nvoxel or int(voxel_index.min()) < 0
    ):
        raise SartInputError(
            f"Sparse RTM segment {filename} has voxel "
            f"indices outside [0, {nvoxel})."
        )
    return pixel_index, voxel_index, value


def read_rtm_block(
    sorted_matrix_files: Dict[str, List[str]],
    rtm_name: str,
    npixel_local: int,
    nvoxel: int,
    offset_pixel: int = 0,
    *,
    dtype=np.float32,
) -> np.ndarray:
    """Rows ``[offset_pixel, offset_pixel + npixel_local)`` of the global
    RTM, all ``nvoxel`` columns, as a host array."""
    if npixel_local <= 0 or nvoxel <= 0:
        raise ValueError("To read a ray-transfer block, its size must be non-zero.")

    mat = np.zeros((npixel_local, nvoxel), dtype=dtype)
    last_pixel = offset_pixel + npixel_local

    start_pixel = 0
    for filenames in sorted_matrix_files.values():
        with h5.File(filenames[0], "r") as f0:
            npixel_data = int(f0["rtm"].attrs["npixel"])

        if offset_pixel < start_pixel + npixel_data:
            start_voxel = 0
            for filename in filenames:
                with h5.File(filename, "r") as f:
                    rtm_group = f["rtm"]
                    nvoxel_data = int(rtm_group.attrs["nvoxel"])
                    group = rtm_group[rtm_name]
                    if int(group.attrs["is_sparse"]):
                        pix, vox, val = _read_sparse_segment(
                            group, filename, start_pixel, start_voxel,
                            nvoxel, dtype,
                        )
                        sel = (pix >= offset_pixel) & (pix < last_pixel)
                        mat[pix[sel] - offset_pixel, vox[sel]] = val[sel]
                    else:
                        dset = group["value"]
                        # rows of this camera's matrix that fall in our block
                        ipix_begin = max(offset_pixel - start_pixel, 0)
                        ipix_end = min(npixel_data, last_pixel - start_pixel)
                        pix_offset = max(start_pixel - offset_pixel, 0)
                        if ipix_end > ipix_begin:
                            rows = slice(pix_offset,
                                         pix_offset + ipix_end - ipix_begin)
                            mat[rows, start_voxel:start_voxel + nvoxel_data] = (
                                dset[ipix_begin:ipix_end, :]
                            )
                start_voxel += nvoxel_data

        start_pixel += npixel_data
        if last_pixel < start_pixel:
            break
    return mat
