"""Input-file discovery, classification, sorting, and cross-validation.

A copy of ``sartsolver_tpu/io/hdf5files.py``.

Re-implements the pre-flight gate of the reference's ``hdf5files.cpp`` with
identical semantics and near-identical diagnostics. These checks are the
reference's de-facto correctness harness (it ships no tests): every rank runs
them before any heavy allocation (main.cpp:30-59).

File schemas (established by the reference's readers):

RTM file (one *segment* of one camera's ray-transfer matrix):
  /rtm                      attrs: camera_name (str), npixel, nvoxel (uint)
  /rtm/frame_mask           [H, W] int — camera pixels participating in the RTM
  /rtm/<name>               attrs: wavelength (float), is_sparse (int)
      dense:  value         [npixel, nvoxel] float32
      sparse: pixel_index, voxel_index [nnz] uint; value [nnz] float32
  /rtm/voxel_map            attrs: nx, ny, nz (+ optional extents,
                            coordinate_system); datasets i, j, k, value

Image file (one camera's frame series):
  /image                    attrs: camera_name (str), wavelength (float)
  /image/frame              [T, H, W] float
  /image/time               [T] float, sorted ascending
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from sartsolver_tpu_torch.io import h5
import numpy as np

from sartsolver_tpu_torch.config import SartInputError


def _read_str_attr(obj, name: str) -> str:
    v = obj.attrs[name]
    if isinstance(v, bytes):
        return v.decode()
    return str(v)


def categorize_input_files(
    input_files: Sequence[str],
) -> Tuple[List[str], List[str]]:
    """Split inputs into RTM and image files by root group (hdf5files.cpp:20-43)."""
    matrix_files: List[str] = []
    image_files: List[str] = []
    for filename in input_files:
        try:
            with h5.File(filename, "r") as f:
                if "rtm" in f:
                    matrix_files.append(filename)
                elif "image" in f:
                    image_files.append(filename)
                else:
                    raise SartInputError(
                        f"The file {filename} is neither an RTM file nor an image file."
                    )
        except OSError as err:
            raise SartInputError(f"Cannot open {filename}: {err}") from err
    return matrix_files, image_files


def check_group_attribute_consistency(
    files: Sequence[str], group: str, attributes: Sequence[str]
) -> None:
    """All files must agree on the given attributes of ``group``
    (hdf5files.hpp:20-64)."""
    ref_vals = None
    ref_file = None
    for filename in files:
        with h5.File(filename, "r") as f:
            if group not in f:
                raise SartInputError(f"No group {group} in {filename}.")
            vals = [np.asarray(f[group].attrs[a]).item() for a in attributes]
        if ref_vals is None:
            ref_vals, ref_file = vals, filename
        elif vals != ref_vals:
            raise SartInputError(
                f"Files {ref_file} and {filename} have different values of "
                f"attributes {list(attributes)} of group {group}."
            )


def _min_flat_voxel_index(f: h5.File) -> int:
    """Minimum flattened (i*ny*nz + j*nz + k) voxel-map index — the segment
    sort key (hdf5files.cpp:58-81)."""
    vmap = f["rtm/voxel_map"]
    ny = int(vmap.attrs["ny"])
    nz = int(vmap.attrs["nz"])
    i = np.asarray(vmap["i"], dtype=np.int64)
    j = np.asarray(vmap["j"], dtype=np.int64)
    k = np.asarray(vmap["k"], dtype=np.int64)
    flat = i * ny * nz + j * nz + k
    nx = int(vmap.attrs["nx"])
    return int(flat.min()) if flat.size else nx * ny * nz


def sort_rtm_files(files: Sequence[str]) -> Dict[str, List[str]]:
    """Group RTM files per camera, segments ordered by min flat voxel index;
    cameras ordered by name (C++ std::map iteration order — this ordering
    defines the global pixel axis, so it must match; hdf5files.cpp:46-103)."""
    per_camera: Dict[str, Dict[int, str]] = {}
    for filename in files:
        with h5.File(filename, "r") as f:
            camera = _read_str_attr(f["rtm"], "camera_name")
            key = _min_flat_voxel_index(f)
        per_camera.setdefault(camera, {})[key] = filename
    return {
        cam: [per_camera[cam][k] for k in sorted(per_camera[cam])]
        for cam in sorted(per_camera)
    }


def check_rtm_frame_consistency(sorted_matrix_files: Dict[str, List[str]]) -> None:
    """Same camera => identical frame masks across segments (hdf5files.cpp:106-143)."""
    for camera, filenames in sorted_matrix_files.items():
        if len(filenames) < 2:
            continue
        ref_mask = None
        for filename in filenames:
            with h5.File(filename, "r") as f:
                mask = np.asarray(f["rtm/frame_mask"], dtype=np.uint8)
            if ref_mask is None:
                ref_mask = mask
            elif not np.array_equal(mask, ref_mask):
                raise SartInputError(
                    f"RTM files for {camera} view have different frame masks."
                )


def _stitched_voxel_map(filenames: Sequence[str], camera: str) -> np.ndarray:
    """Stitch segment voxel maps with nvoxel re-offsetting; overlap is an
    error (hdf5files.cpp:162-201)."""
    with h5.File(filenames[0], "r") as f:
        vmap = f["rtm/voxel_map"]
        nx, ny, nz = (int(vmap.attrs[a]) for a in ("nx", "ny", "nz"))
    voxel_map = np.full(nx * ny * nz, -1, dtype=np.int64)
    nsource_prev = 0
    for filename in filenames:
        with h5.File(filename, "r") as f:
            nvox = int(f["rtm"].attrs["nvoxel"])
            vmap = f["rtm/voxel_map"]
            i = np.asarray(vmap["i"], dtype=np.int64)
            j = np.asarray(vmap["j"], dtype=np.int64)
            k = np.asarray(vmap["k"], dtype=np.int64)
            value = np.asarray(vmap["value"], dtype=np.int64)
        flat = i * ny * nz + j * nz + k
        taken = voxel_map[flat] >= 0
        if taken.any():
            t = int(np.argmax(taken))
            raise SartInputError(
                f"RTM segments for {camera} view have overlapping voxel maps "
                f"at element ({i[t]},{j[t]},{k[t]})."
            )
        voxel_map[flat] = value + nsource_prev
        nsource_prev += nvox
    return voxel_map


def check_rtm_voxel_consistency(sorted_matrix_files: Dict[str, List[str]]) -> None:
    """All cameras must share one stitched voxel map (hdf5files.cpp:146-218)."""
    ref_map = None
    ref_camera = None
    for camera, filenames in sorted_matrix_files.items():
        vm = _stitched_voxel_map(filenames, camera)
        if ref_map is None:
            ref_map, ref_camera = vm, camera
        elif not np.array_equal(vm, ref_map):
            raise SartInputError(
                f"RTM files for {camera} and {ref_camera} views have different "
                "voxel maps."
            )


def read_rtm_frame_masks(
    sorted_matrix_files: Dict[str, List[str]]
) -> Dict[str, np.ndarray]:
    """Per-camera flattened frame masks (hdf5files.cpp:221-244)."""
    masks: Dict[str, np.ndarray] = {}
    for camera, filenames in sorted_matrix_files.items():
        with h5.File(filenames[0], "r") as f:
            masks[camera] = np.asarray(f["rtm/frame_mask"], dtype=np.int64).ravel()
    return masks


def sort_image_files(files: Sequence[str]) -> Dict[str, str]:
    """Camera name -> image file; duplicates are an error
    (hdf5files.cpp:247-276). Keys sorted (std::map order)."""
    sorted_files: Dict[str, str] = {}
    for filename in files:
        with h5.File(filename, "r") as f:
            camera = _read_str_attr(f["image"], "camera_name")
        if camera in sorted_files:
            raise SartInputError(
                f"Image files {filename} and {sorted_files[camera]} share the "
                f"same diagnostic view: {camera}."
            )
        sorted_files[camera] = filename
    return {cam: sorted_files[cam] for cam in sorted(sorted_files)}


def check_rtm_image_consistency(
    sorted_matrix_files: Dict[str, List[str]],
    sorted_image_files: Dict[str, str],
    rtm_name: str,
    wavelength_threshold: float,
) -> None:
    """Camera sets must match; wavelengths within threshold; frame shapes
    must agree (hdf5files.cpp:279-346)."""
    for camera in sorted_matrix_files:
        if camera not in sorted_image_files:
            raise SartInputError(f"No image file for {camera} camera.")
    for camera in sorted_image_files:
        if camera not in sorted_matrix_files:
            raise SartInputError(f"No RTM file for {camera} camera.")

    first_cam = next(iter(sorted_matrix_files))
    with h5.File(sorted_matrix_files[first_cam][0], "r") as f:
        rtm_wavelength = float(f[f"rtm/{rtm_name}"].attrs["wavelength"])
    with h5.File(sorted_image_files[next(iter(sorted_image_files))], "r") as f:
        image_wavelength = float(f["image"].attrs["wavelength"])
    if abs(rtm_wavelength - image_wavelength) > wavelength_threshold:
        raise SartInputError(
            f"RTM wavelength ({rtm_wavelength} nm) is not within "
            f"{wavelength_threshold} nm threshold from image wavelength "
            f"({image_wavelength} nm)."
        )

    for camera, filenames in sorted_matrix_files.items():
        with h5.File(filenames[0], "r") as f:
            rtm_dims = f["rtm/frame_mask"].shape
        with h5.File(sorted_image_files[camera], "r") as f:
            image_dims = f["image/frame"].shape
        if image_dims[1] != rtm_dims[0] or image_dims[2] != rtm_dims[1]:
            raise SartInputError(
                f"RTM for {camera} view was calculated for resolution "
                f"{rtm_dims[1]}x{rtm_dims[0]}, but the camera image has "
                f"resolution {image_dims[2]}x{image_dims[1]}."
            )


def get_total_rtm_size(
    sorted_matrix_files: Dict[str, List[str]]
) -> Tuple[int, int]:
    """Global (npixel, nvoxel): pixel counts summed over cameras, voxel
    counts summed over the first camera's segments (hdf5files.cpp:349-389)."""
    npixel = 0
    for filenames in sorted_matrix_files.values():
        with h5.File(filenames[0], "r") as f:
            npixel += int(f["rtm"].attrs["npixel"])
    nvoxel = 0
    first = next(iter(sorted_matrix_files.values()))
    for filename in first:
        with h5.File(filename, "r") as f:
            nvoxel += int(f["rtm"].attrs["nvoxel"])
    return npixel, nvoxel
