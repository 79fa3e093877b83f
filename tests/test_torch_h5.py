"""The port's own HDF5 reader and writer (sartsolver_tpu_torch.io.h5)
against h5py: files h5py writes read back equal, files the port writes are
read by h5py equal, in both the library's default layout and its newest.
Chunked, extendible datasets the port writes are resized and appended to by
the HDF5 library, and a solution file the port's writer made is resumed by
the JAX package's writer."""

import os

import h5py
import numpy as np
import pytest

from sartsolver_tpu_torch.io import h5


def _write_with_h5py(path, libver):
    rng = np.random.default_rng(0)
    data = {
        "rtm/frame_mask": np.arange(12).reshape(3, 4),
        "rtm/with_reflections/value": rng.random((9, 7), dtype=np.float32),
        "image/frame": rng.random((4, 3, 2)),
        "image/time": np.linspace(0.0, 0.3, 4),
        "laplacian/i": np.arange(5, dtype=np.uint64),
        "solution/status": np.array([0, -1, 0], np.int32),
    }
    with h5py.File(path, "w", libver=libver) as f:
        for key, arr in data.items():
            f.create_dataset(key, data=arr)
        f["rtm"].attrs["camera_name"] = "camA"
        f["rtm"].attrs.create("npixel", 9, dtype=np.uint64)
        f["rtm/with_reflections"].attrs.create("wavelength", 500.0, dtype=np.float64)
        f["rtm/with_reflections"].attrs.create("is_sparse", 0, dtype=np.int64)
        f["rtm/frame_mask"].attrs["label"] = np.bytes_(b"fixed")
        # several symbol-table nodes; the newest format keeps up to 8 links
        # in the header and more in a fractal heap, which is not read
        n_many = 30 if libver == "earliest" else 8
        for i in range(n_many):
            f.create_dataset(f"many/d{i:02d}", data=np.full(2, i, np.int32))
        if libver == "earliest":  # the newest format's chunk indexes are not read
            chunked = np.arange(120.0).reshape(12, 10)
            f.create_dataset("chunked/gzip", data=chunked, chunks=(5, 4),
                             compression="gzip", shuffle=True)
            f.create_dataset("chunked/grow", data=np.arange(7), maxshape=(None,), chunks=(3,))
            data["chunked/gzip"] = chunked
            data["chunked/grow"] = np.arange(7)
        data.update({f"many/d{i:02d}": np.full(2, i, np.int32) for i in range(n_many)})
    return data


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_reads_what_h5py_writes(tmp_path, libver):
    path = str(tmp_path / "in.h5")
    data = _write_with_h5py(path, libver)
    with h5.File(path) as f:
        assert list(f) == sorted(["rtm", "image", "laplacian", "solution", "many"]
                                 + (["chunked"] if libver == "earliest" else []))
        for key, arr in data.items():
            got = np.asarray(f[key])
            assert got.dtype == arr.dtype and got.shape == arr.shape, key
            np.testing.assert_array_equal(got, arr, err_msg=key)
        np.testing.assert_array_equal(f["rtm/with_reflections/value"][2:5, :],
                                      data["rtm/with_reflections/value"][2:5, :])
        np.testing.assert_array_equal(f["image/frame"][1], data["image/frame"][1])
        assert f["rtm"].attrs["camera_name"] == "camA"
        assert int(f["rtm"].attrs["npixel"]) == 9
        assert f["rtm"].attrs["npixel"].dtype == np.uint64
        assert float(f["rtm/with_reflections"].attrs["wavelength"]) == 500.0
        assert f["rtm/frame_mask"].attrs["label"] == b"fixed"
        assert "rtm/voxel_map" not in f and "rtm/with_reflections" in f
        assert f["image/frame"].shape == (4, 3, 2)


def test_h5py_reads_what_it_writes(tmp_path):
    path = str(tmp_path / "out.h5")
    value = np.random.default_rng(1).random((3, 5))
    with h5.File(path, "w") as f:
        g = f.create_group("solution")
        g.create_dataset("value", data=value, maxshape=(None, 5), chunks=(1, 5))
        g.create_dataset("status", data=np.array([0, -1, 0], np.int32))
        g.create_dataset("checksum", data=np.array([1, 2, 3], np.uint32))
        for i in range(20):
            g.create_dataset(f"time_cam{i:02d}", data=np.arange(3.0) + i)
        g.attrs["completed"] = 3
        vm = f.create_group("voxel_map")
        vm.attrs.create("nx", 4, dtype=np.uint64)
        vm.attrs["coordinate_system"] = "cartesian"
        f.create_group("empty")
    with h5py.File(path, "r") as f:
        assert list(f) == ["empty", "solution", "voxel_map"]
        np.testing.assert_array_equal(f["solution/value"][:], value)
        np.testing.assert_array_equal(f["solution/status"][:], [0, -1, 0])
        assert f["solution/checksum"].dtype == np.uint32
        np.testing.assert_array_equal(f["solution/time_cam19"][:], np.arange(3.0) + 19)
        assert int(f["solution"].attrs["completed"]) == 3
        assert dict(f["voxel_map"].attrs) == {"nx": np.uint64(4),
                                              "coordinate_system": "cartesian"}
        assert len(f["empty"]) == 0


def test_read_write_appends_and_a_failed_block_leaves_the_file(tmp_path):
    """``"r+"`` appends in place to an extendible (chunked) dataset; a block
    that raises before the file closes leaves the file as it was; what the
    in-place writer does not do (resize a contiguous dataset, add an
    attribute) raises naming the operation."""
    path = str(tmp_path / "sol.h5")
    with h5.File(path, "w") as f:
        grp = f.create_group("solution")
        grp.create_dataset("time", data=np.arange(2.0), maxshape=(None,), chunks=(2,))
        grp.create_dataset("fixed", data=np.arange(2.0))
        grp.attrs["completed"] = 2
    with h5.File(path, "r+") as f:
        with pytest.raises(h5.H5FormatError, match="in-place resize of contiguous"):
            f["solution/fixed"].resize((4,))
        with pytest.raises(h5.H5FormatError, match="attribute 'other'"):
            f["solution"].attrs["other"] = 1
        d = f["solution/time"]
        d.resize((4,))
        d[2:] = [5.0, 6.0]
        f["solution"].attrs["completed"] = 4
    with pytest.raises(RuntimeError):
        with h5.File(path, "r+") as f:
            f["solution/time"][0] = -1.0
            raise RuntimeError("interrupted before close")
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["solution/time"][:], [0.0, 1.0, 5.0, 6.0])
        assert int(f["solution"].attrs["completed"]) == 4
    assert os.listdir(tmp_path) == ["sol.h5"]  # no temporary left behind
    with h5.File(path) as f, pytest.raises(OSError, match="read-only"):
        f["solution/time"][0] = 1.0


def test_refuses_what_it_cannot_read(tmp_path):
    not_h5 = tmp_path / "plain.txt"
    not_h5.write_text("not an HDF5 file")
    with pytest.raises(h5.H5FormatError, match="not an HDF5 file"):
        h5.File(str(not_h5))
    with pytest.raises(FileNotFoundError):
        h5.File(str(tmp_path / "missing.h5"))
    path = str(tmp_path / "compound.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("c", data=np.zeros(2, dtype=[("a", "<i4"), ("b", "<f8")]))
    with h5.File(path) as f, pytest.raises(h5.H5FormatError, match="datatype class 6"):
        f["c"]
    with h5.File(path) as f, pytest.raises(KeyError):
        f["nope"]
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("grow", data=np.arange(7), maxshape=(None,), chunks=(3,))
        for i in range(9):
            f.create_dataset(f"dense/d{i}", data=np.arange(2))
    with h5.File(path) as f, pytest.raises(h5.H5FormatError, match="chunk index"):
        f["grow"]
    with h5.File(path) as f, pytest.raises(h5.H5FormatError, match="dense link"):
        f["dense"]


@pytest.mark.parametrize("n_rows", [3, 64, 65, 200, 4100])
def test_chunked_datasets_extend_in_the_hdf5_library(tmp_path, n_rows):
    """The layout h5py's default format writes for an extendible dataset:
    chunked with unlimited rows and the fill value; the HDF5 library resizes
    it and appends into the port's chunk index (one node up to 64 chunks, a
    tree above: 4100 chunks take two levels), and the port reads the result,
    unwritten chunks as the fill value. Then the port appends in place, in
    flushes of several sizes (its leaves split and the root grows a level
    past 64 chunks), and the library reads and extends that file again."""
    path = str(tmp_path / "grow.h5")
    value = np.arange(n_rows * 4, dtype=np.float64).reshape(n_rows, 4)
    with h5.File(path, "w") as f:
        f.create_dataset("value", data=value, maxshape=(None, 4), chunks=(1, 4), fillvalue=0.0)
        f.create_dataset("it", data=np.arange(n_rows, dtype=np.int32), maxshape=(None,),
                         chunks=(7,), fillvalue=-1)
    with h5py.File(path, "r+") as f:
        assert f["value"].chunks == (1, 4) and f["value"].maxshape == (None, 4)
        assert f["it"].chunks == (7,) and f["it"].fillvalue == -1
        np.testing.assert_array_equal(f["value"][:], value)
        f["value"].resize((n_rows + 70, 4))
        f["value"][n_rows:] = -np.arange(280.0).reshape(70, 4)
        f["it"].resize((n_rows + 9,))
        f["it"][n_rows:n_rows + 5] = 100 + np.arange(5)
    with h5.File(path) as f:
        np.testing.assert_array_equal(f["value"][:], np.concatenate(
            [value, -np.arange(280.0).reshape(70, 4)]))
        np.testing.assert_array_equal(f["it"][:], np.r_[np.arange(n_rows), 100 + np.arange(5),
                                                         [-1] * 4])
        assert f["it"].chunks == (7,) and f["it"].maxshape == (None,)
    with h5.File(path, "r+") as f:  # the port keeps the layout, in place
        f["it"].resize((n_rows + 12,))
        with pytest.raises(ValueError, match="maxshape"):
            f["value"].resize((n_rows, 5))
    with h5py.File(path, "r") as f:
        assert f["it"].chunks == (7,) and f["it"][-1] == -1
        assert f["value"].maxshape == (None, 4)
    rng = np.random.default_rng(n_rows)
    value = np.concatenate([value, -np.arange(280.0).reshape(70, 4)])
    it = np.r_[np.arange(n_rows), 100 + np.arange(5), [-1] * 7]
    for step in (1, 5, 63, 66, 130):
        rows, its = rng.random((step, 4)), rng.integers(0, 9, step).astype(np.int32)
        with h5.File(path, "r+") as f:
            for name, new in (("value", rows), ("it", its)):
                d = f[name]
                n = d.shape[0]
                d.resize((n + step,) + d.shape[1:])
                d[n:] = new
        value, it = np.concatenate([value, rows]), np.r_[it, its]
        with h5py.File(path, "r+") as f:
            np.testing.assert_array_equal(f["value"][:], value)
            np.testing.assert_array_equal(f["it"][:], it)
            f["value"].resize((len(value) + 3, 4))
            f["value"][-3:] = 7.0
            f["it"].resize((len(it) + 3,))
            f["it"][-3:] = 7
        value, it = np.concatenate([value, np.full((3, 4), 7.0)]), np.r_[it, [7] * 3]
        with h5.File(path) as f:
            np.testing.assert_array_equal(f["value"][:], value)
            np.testing.assert_array_equal(f["it"][:], it)


def test_jax_writer_resumes_a_port_solution_file(tmp_path):
    """A solution file the port's SolutionWriter wrote is resumed and
    appended to by the JAX package's writer (``read_resume_state`` and
    ``SolutionWriter(resume=...)``, which resize every per-frame dataset),
    and both h5py and the port read every row back; the port reads the
    JAX-resumed file."""
    from sartsolver_tpu.io.solution import SolutionWriter as JaxWriter
    from sartsolver_tpu.io.solution import read_resume_state

    from sartsolver_tpu_torch.io.solution import SolutionWriter, row_checksum

    path, cams, V = str(tmp_path / "sol.h5"), ["camA", "camB"], 16
    rows = np.random.default_rng(1).random((9, V))
    with SolutionWriter(path, cams, V, max_cache_size=2) as w:
        for i in range(5):
            w.add(rows[i], 0, 0.1 * i, [0.1 * i, 0.1 * i + 0.01], iterations=i)
    with h5py.File(path, "r") as f:
        for key in f["solution"]:
            assert f["solution"][key].maxshape[0] is None, key
            assert f["solution"][key].chunks is not None, key
    state = read_resume_state(path, cams, V)
    np.testing.assert_array_equal(state.times, 0.1 * np.arange(5))
    np.testing.assert_array_equal(state.last_solution, rows[4])
    with JaxWriter(path, cams, V, max_cache_size=3, resume=state) as w:
        for i in range(5, 9):
            w.add(rows[i], -1, 0.1 * i, [0.1 * i, 0.1 * i + 0.01], iterations=i)
    want = dict(value=rows, status=[0] * 5 + [-1] * 4, iterations=np.arange(9),
                time=0.1 * np.arange(9), time_camB=0.1 * np.arange(9) + 0.01,
                checksum=[int(row_checksum(r)) for r in rows])
    for opener in (h5py.File, h5.File):
        with opener(path, "r") as f:
            for key, arr in want.items():
                np.testing.assert_array_equal(f["solution"][key][:], arr, err_msg=key)
            assert int(f["solution"].attrs["completed"]) == 9
