"""Ray-transfer-matrix block reader.

The JAX package's ``read_rtm_block`` (``sartsolver_tpu/io/raytransfer.py``)
with its signature, matching the reference's
``RayTransferMatrix::read_hdf5`` (raytransfer.cpp:27-127):

- cameras (sorted order) advance the global *pixel* offset,
- segments within a camera advance the global *voxel* offset,
- sparse segments are COO scattered into the dense block (NumPy scatter),
- dense segments are read only for the rows and columns in range.

As in the JAX reader:

- **Column-range reads** (``offset_voxel`` / ``nvoxel_local``) read only the
  columns of a window.
- **One-pass sparse segments**: a ``sparse_cache`` dict, shared across the
  chunked calls of one ingest, holds each sparse segment's triplets once
  (filtered to the caller's ``cache_rows`` / ``cache_cols`` window, sorted
  by pixel), and every later chunk slices them by ``searchsorted``. A byte
  budget (``SART_SPARSE_CACHE_MB``, default 1024) guards host memory:
  segments past it are read again by each call.

Beyond it, ``out=`` fills a caller's buffer (possibly a column window of a
wider one) in place of a new array: a dense contiguous segment's rows go
from the file into the buffer in one copy (``io/h5.py``'s ``read_direct``),
and a chunked segment decodes only the chunks the rows meet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from sartsolver_tpu_torch.config import SartInputError
from sartsolver_tpu_torch.io import h5

# Payload bytes pulled from HDF5 by this process (dense data and sparse
# triplet arrays, counted once at read time; cached sparse slices add
# nothing): what the tests and the ingest's telemetry read.
READ_STATS = {"data_bytes": 0}

# Reserved sparse_cache key holding the running cached-bytes total (segment
# keys are tuples, so a str can never collide).
_CACHE_BYTES_KEY = "__cached_bytes__"


def _sparse_budget_bytes() -> int:
    try:
        return int(os.environ.get("SART_SPARSE_CACHE_MB", 1024)) << 20
    except ValueError:
        return 1024 << 20


def _load_sparse_segment(group, filename: str, start_pixel: int,
                         start_voxel: int, nvoxel: int, dtype):
    """A sparse segment's triplets in global indices, bounds-checked."""
    pixel_index = np.asarray(group["pixel_index"], np.int64) + start_pixel
    voxel_index = np.asarray(group["voxel_index"], np.int64) + start_voxel
    value = np.asarray(group["value"], dtype)
    READ_STATS["data_bytes"] += pixel_index.nbytes + voxel_index.nbytes + value.nbytes
    if voxel_index.size and (
        int(voxel_index.max()) >= nvoxel or int(voxel_index.min()) < 0
    ):
        raise SartInputError(
            f"Sparse RTM segment {filename} has voxel "
            f"indices outside [0, {nvoxel})."
        )
    return pixel_index, voxel_index, value


def _sparse_segment_window(group, filename: str, start_pixel: int,
                           start_voxel: int, nvoxel: int, dtype,
                           sparse_cache: Optional[dict],
                           cache_rows: Optional[Tuple[int, int]],
                           cache_cols: Optional[Tuple[int, int]]):
    """``((pix, vox, val), presorted)`` of one sparse segment, through the
    one-pass cache when there is one. Cache entries hold the triplets
    filtered to the caller's window and sorted by global pixel; ``None``
    marks a segment past the byte budget (read again by each call)."""
    if sparse_cache is None:
        return _load_sparse_segment(group, filename, start_pixel, start_voxel,
                                    nvoxel, dtype), False
    key = (filename, start_pixel, start_voxel)
    if key not in sparse_cache:
        pix, vox, val = _load_sparse_segment(group, filename, start_pixel,
                                             start_voxel, nvoxel, dtype)
        if cache_rows is not None:
            sel = (pix >= cache_rows[0]) & (pix < cache_rows[1])
            pix, vox, val = pix[sel], vox[sel], val[sel]
        if cache_cols is not None:
            sel = (vox >= cache_cols[0]) & (vox < cache_cols[1])
            pix, vox, val = pix[sel], vox[sel], val[sel]
        used = sparse_cache.get(_CACHE_BYTES_KEY, 0)
        nbytes = pix.nbytes + vox.nbytes + val.nbytes
        if nbytes + used > _sparse_budget_bytes():
            sparse_cache[key] = None  # over budget: read again per call
            # this call already holds the window's triplets; the unsorted
            # path below applies the full row and column masks
            return (pix, vox, val), False
        order = np.argsort(pix, kind="stable")
        sparse_cache[key] = (pix[order], vox[order], val[order], cache_rows, cache_cols)
        sparse_cache[_CACHE_BYTES_KEY] = used + nbytes
    entry = sparse_cache[key]
    if entry is not None:
        pix, vox, val, rows_win, cols_win = entry
        # a request outside the cached window bypasses the cache (it would
        # come back empty); callers pass one window per ingest
        if (rows_win is None or cache_rows == rows_win) and \
                (cols_win is None or cache_cols == cols_win):
            return (pix, vox, val), True
    return _load_sparse_segment(group, filename, start_pixel, start_voxel,
                                nvoxel, dtype), False


def read_rtm_block(
    sorted_matrix_files: Dict[str, List[str]],
    rtm_name: str,
    npixel_local: int,
    nvoxel: int,
    offset_pixel: int = 0,
    *,
    dtype=np.float32,
    offset_voxel: int = 0,
    nvoxel_local: Optional[int] = None,
    sparse_cache: Optional[dict] = None,
    cache_rows: Optional[Tuple[int, int]] = None,
    cache_cols: Optional[Tuple[int, int]] = None,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Rows ``[offset_pixel, offset_pixel + npixel_local)`` x columns
    ``[offset_voxel, offset_voxel + nvoxel_local)`` of the global RTM.

    ``nvoxel`` is the global voxel count (bounds checks, segment layout);
    ``nvoxel_local=None`` reads the full width. ``sparse_cache`` (a dict the
    caller owns, shared across chunked calls) enables the one-pass sparse
    path; ``cache_rows`` / ``cache_cols`` bound what it keeps: pass the
    caller's whole row and column window. ``out`` (``[npixel_local,
    ncols]`` of ``dtype``, each row contiguous) is filled and returned in
    place of a new array.
    """
    ncols = nvoxel - offset_voxel if nvoxel_local is None else nvoxel_local
    if npixel_local <= 0 or ncols <= 0 or nvoxel <= 0:
        raise ValueError("To read a ray-transfer block, its size must be non-zero.")
    if out is None:
        mat = np.zeros((npixel_local, ncols), dtype=dtype)
        zeroed = True
    else:
        mat = out
        if mat.shape != (npixel_local, ncols) or mat.dtype != np.dtype(dtype):
            raise ValueError(f"out= of {mat.shape} {mat.dtype} for a "
                             f"({npixel_local}, {ncols}) {np.dtype(dtype)} block.")
        zeroed = False
    last_pixel = offset_pixel + npixel_local
    last_voxel = offset_voxel + ncols

    start_pixel = 0
    for filenames in sorted_matrix_files.values():
        with h5.File(filenames[0], "r") as f0:
            npixel_data = int(f0["rtm"].attrs["npixel"])

        if offset_pixel < start_pixel + npixel_data:
            # rows of this camera's matrix that fall in the block
            ipix_begin = max(offset_pixel - start_pixel, 0)
            ipix_end = min(npixel_data, last_pixel - start_pixel)
            pix_offset = max(start_pixel - offset_pixel, 0)
            out_rows = slice(pix_offset, pix_offset + max(ipix_end - ipix_begin, 0))
            covered = offset_voxel  # columns of the window filled so far
            start_voxel = 0
            for filename in filenames:
                with h5.File(filename, "r") as f:
                    rtm_group = f["rtm"]
                    nvoxel_data = int(rtm_group.attrs["nvoxel"])
                    if (start_voxel + nvoxel_data <= offset_voxel
                            or start_voxel >= last_voxel):
                        start_voxel += nvoxel_data
                        continue  # segment entirely outside the column window
                    group = rtm_group[rtm_name]
                    # columns of this segment inside the window
                    col_lo = max(offset_voxel - start_voxel, 0)
                    col_hi = min(nvoxel_data, last_voxel - start_voxel)
                    out_cols = slice(start_voxel + col_lo - offset_voxel,
                                     start_voxel + col_hi - offset_voxel)
                    if int(group.attrs["is_sparse"]):
                        if not zeroed:
                            mat[out_rows, out_cols] = 0
                        (pix, vox, val), presorted = _sparse_segment_window(
                            group, filename, start_pixel, start_voxel, nvoxel,
                            dtype, sparse_cache, cache_rows, cache_cols,
                        )
                        if presorted:
                            lo, hi = np.searchsorted(pix, [offset_pixel, last_pixel])
                            pix, vox, val = pix[lo:hi], vox[lo:hi], val[lo:hi]
                            sel = (vox >= offset_voxel) & (vox < last_voxel)
                        else:
                            sel = ((pix >= offset_pixel) & (pix < last_pixel)
                                   & (vox >= offset_voxel) & (vox < last_voxel))
                        mat[pix[sel] - offset_pixel, vox[sel] - offset_voxel] = val[sel]
                    elif ipix_end > ipix_begin:
                        dset = group["value"]
                        dest = mat[out_rows, out_cols]
                        if col_lo == 0 and col_hi == dset.shape[1]:
                            dset.read_direct(dest, (ipix_begin, ipix_end))
                        else:  # a column window of the segment: its rows, then the columns
                            block = np.empty((ipix_end - ipix_begin, dset.shape[1]),
                                             dset.dtype)
                            dset.read_direct(block, (ipix_begin, ipix_end))
                            dest[...] = block[:, col_lo:col_hi]
                        READ_STATS["data_bytes"] += dest.size * dset.dtype.itemsize
                    covered = max(covered, start_voxel + col_hi)
                start_voxel += nvoxel_data
            if not zeroed and covered < last_voxel:
                mat[out_rows, covered - offset_voxel:] = 0  # columns no segment holds

        start_pixel += npixel_data
        if last_pixel <= start_pixel:
            break
    if not zeroed and start_pixel < last_pixel:
        mat[max(start_pixel - offset_pixel, 0):] = 0  # rows past the last camera
    return mat
