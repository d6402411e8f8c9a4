"""The port's numpy HDF5 reader (point2cyl_torch/data/h5_reader.py) against
h5py, on the committed packs and on the layouts h5py writes by default."""

from __future__ import annotations

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from point2cyl_torch.data.h5_io import load_h5
from point2cyl_torch.data.h5_reader import read_datasets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same_as_h5py(path: str) -> None:
    got = read_datasets(path)
    with h5py.File(path, "r") as f:
        want = {key: f[key][()] for key in f if isinstance(f[key], h5py.Dataset)}
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype and got[key].shape == val.shape, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("split", ["train", "test"])
def test_reader_equals_h5py_on_the_ab_packs(split):
    assert_same_as_h5py(os.path.join(ROOT, "ab_data", f"{split}.h5"))


def test_reader_equals_h5py_on_default_layouts(tmp_path):
    """Contiguous, chunked with partial edge chunks, gzip with and without
    shuffle, never-written datasets, 1- to 4-byte and 8-byte types, a
    nested group (skipped) and enough names for several symbol nodes."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "layouts.h5")
    with h5py.File(path, "w") as f:
        f["contiguous"] = rng.normal(size=(5, 7))
        f.create_dataset("shuffled", data=rng.integers(-999, 999, (33, 17, 3)),
                         compression="gzip", shuffle=True, chunks=(8, 4, 3))
        f.create_dataset("edges", data=rng.normal(size=(300, 100, 3)).astype(np.float32),
                         compression="gzip", chunks=(7, 9, 2))
        f.create_dataset("uncompressed_chunks", data=rng.normal(size=(10, 11)),
                         chunks=(4, 4))
        f.create_dataset("unwritten_chunks", shape=(4, 4), dtype="f4", chunks=(2, 2))
        f.create_dataset("unwritten", shape=(4, 4), dtype="i2")
        f["bytes"] = rng.integers(0, 255, 9).astype(np.uint8)
        f.create_group("group")["inner"] = np.ones(3)
        for i in range(40):
            f[f"row{i}"] = np.full(2, i, np.int32)
    assert_same_as_h5py(path)


@pytest.mark.parametrize("case", ["big_endian", "strings", "latest_format"])
def test_reader_raises_on_what_it_does_not_take(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    with h5py.File(path, "w", libver="latest" if case == "latest_format" else "earliest") as f:
        if case == "big_endian":
            f["x"] = np.arange(4, dtype=">i4")
        elif case == "strings":
            f["x"] = np.array([b"ab", b"cd"])
        else:
            f["x"] = np.arange(4)
    with pytest.raises(NotImplementedError):
        read_datasets(path)


def test_load_h5_needs_no_h5py():
    """load_h5 reads a pack in a process where h5py cannot be imported."""
    code = ("import sys\nsys.modules['h5py'] = None\n"
            "from point2cyl_torch.data.h5_io import load_h5\n"
            f"ds = load_h5({os.path.join(ROOT, 'ab_data', 'test.h5')!r})\n"
            "print(ds.point_cloud.shape)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "(32, 1024, 3)"
    assert load_h5(os.path.join(ROOT, "ab_data", "test.h5")).extrusion_centers.shape \
        == (32, 8, 3)
