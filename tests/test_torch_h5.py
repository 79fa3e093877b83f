"""The port's own HDF5 reader and writer (sartsolver_tpu_torch.io.h5)
against h5py: files h5py writes read back equal, files the port writes are
read by h5py equal, in both the library's default layout and its newest."""

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
    path = str(tmp_path / "sol.h5")
    with h5.File(path, "w") as f:
        f.create_group("solution").create_dataset("time", data=np.arange(2.0))
    with h5.File(path, "r+") as f:
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
