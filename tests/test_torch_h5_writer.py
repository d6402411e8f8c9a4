"""The port's numpy HDF5 writer (point2cyl_torch/data/h5_writer.py and the
writer half of data/h5_io.py) against h5py and the JAX package's
``save_h5`` / ``save_model_h5``: what the port writes, h5py, the port's
reader and JAX's loaders read as equal, key by key, to what JAX wrote."""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from point2cyl_torch.data import h5_io as tio
from point2cyl_torch.data.h5_reader import read_datasets
from point2cyl_torch.data.h5_writer import write_datasets
from point2cyl_torch.data.synthetic import generate_dataset
from point2cyl_tpu.data import h5_io as jio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def h5py_arrays(path: str) -> dict[str, np.ndarray]:
    with h5py.File(path, "r") as f:
        return {key: f[key][()] for key in f}


def assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, val in want.items():
        val = np.asarray(val)
        assert got[key].dtype == val.dtype and got[key].shape == val.shape, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)


def packed(with_optional: bool) -> tio.PackedDataset:
    """A pack whose arrays need JAX's dtype rule: int64 labels and counts,
    float64 points."""
    ds = generate_dataset(5, resolution=64, max_instances=4, num_sketch_points=8, seed=4)
    ds = dataclasses.replace(
        ds, point_cloud=ds.point_cloud.astype(np.float64),
        extrusion_labels=ds.extrusion_labels.astype(np.int64),
        n_instances=ds.n_instances.astype(np.int64))
    if not with_optional:
        ds = dataclasses.replace(ds, extrusion_operation=None, extrusion_centers=None,
                                 extrusion_extents=None, sketches=None,
                                 sketches_norms=None)
    return ds


@pytest.mark.parametrize("with_optional", [True, False])
def test_save_h5_file_equals_jax_file(tmp_path, with_optional):
    ds = packed(with_optional)
    ours, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    tio.save_h5(ours, ds)
    jio.save_h5(theirs, jio.PackedDataset(**dataclasses.asdict(ds)))
    want = h5py_arrays(theirs)
    assert len(want) == (12 if with_optional else 7)
    assert_same(h5py_arrays(ours), want)
    assert_same(read_datasets(ours), want)
    for load in (tio.load_h5, jio.load_h5):
        got = {k: v for k, v in dataclasses.asdict(load(ours)).items() if v is not None}
        assert_same(got, want)


@pytest.mark.parametrize("mesh_info,operation", [(False, False), (True, True)])
def test_save_model_h5_equals_jax(tmp_path, mesh_info, operation):
    """A single-model file with int64 faces and an empty label list: both
    writers' files read alike through both loaders. (JAX's writer takes no
    rank-0 array, h5py's gzip refuses one: n_instances and norm_factor
    have shape (1,) here, and the next test writes them as scalars.)"""
    rng = np.random.default_rng(1)
    model = {
        "point_cloud": rng.normal(size=(32, 3)), "normals": rng.normal(size=(32, 3)),
        "extrusion_labels": rng.integers(0, 3, 32), "extrusion_axes": rng.normal(size=(3, 3)),
        "extrusion_distances": rng.uniform(size=3), "n_instances": np.array([3]),
        "vertices": rng.normal(size=(8, 3)), "faces": rng.integers(0, 8, (12, 3)),
        "face_normals": rng.normal(size=(12, 3)).astype(np.float32),
        "face_extrusion_labels": np.zeros((0,), np.int64), "norm_factor": np.array([1.7]),
    }
    if operation:
        model["operation"] = rng.integers(0, 2, 32)
    ours, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    tio.save_model_h5(ours, model)
    jio.save_model_h5(theirs, model)
    assert_same(h5py_arrays(ours), h5py_arrays(theirs))
    want = jio.load_model_h5(theirs, mesh_info=mesh_info)
    assert ("operation" in want) == operation
    for got in (tio.load_model_h5(ours, mesh_info=mesh_info),
                jio.load_model_h5(ours, mesh_info=mesh_info)):
        assert_same(got, want)


def test_save_model_h5_writes_a_scalar_norm_factor(tmp_path):
    """``get_model``'s norm_factor is a scalar: the port stores it with
    rank 0, float32, and h5py and the port's loader read it back so (JAX's
    loader slices every dataset with ``[:]``, which a scalar refuses)."""
    model = {"point_cloud": np.ones((4, 3)), "normals": np.ones((4, 3)),
             "extrusion_labels": np.zeros(4, np.int64), "extrusion_axes": np.eye(3),
             "extrusion_distances": np.ones(3), "n_instances": 3,
             "vertices": np.eye(3), "faces": np.array([[0, 1, 2]]),
             "face_normals": np.ones((1, 3)), "face_extrusion_labels": np.zeros(1, int),
             "norm_factor": 1.7}
    path = str(tmp_path / "model.h5")
    tio.save_model_h5(path, model)
    assert h5py_arrays(path)["norm_factor"].shape == ()
    got = tio.load_model_h5(path, mesh_info=True)
    assert got["norm_factor"] == np.float32(1.7) and got["norm_factor"].shape == ()
    assert got["n_instances"].dtype == np.int32 and got["n_instances"] == 3


DTYPES = ["<i1", "<i2", "<i4", "<i8", "<u1", "<u2", "<u4", "<u8", "<f4", "<f8"]
# upper case sorts before lower case and a multi-byte letter after both in
# byte order: names are found by binary search over that order
NAMES = st.text(alphabet="aAbBzZ09_-.é", min_size=1, max_size=6).filter(
    lambda name: name != ".")


@st.composite
def datasets(draw) -> dict[str, np.ndarray]:
    names = draw(st.lists(NAMES, min_size=1, max_size=20, unique=True))
    out = {}
    for name in names:
        shape = tuple(draw(st.lists(st.integers(0, 3), min_size=0, max_size=4)))
        dtype = np.dtype(draw(st.sampled_from(DTYPES)))
        rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
        if dtype.kind == "f":
            arr = rng.normal(scale=1e3, size=shape).astype(dtype)
            arr.flat[::7] = np.inf
        else:
            info = np.iinfo(dtype)
            arr = rng.integers(info.min, info.max, size=shape, dtype=dtype, endpoint=True)
        out[name] = arr
    return out


@settings(max_examples=40, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(arrays=datasets())
def test_round_trip_through_h5py_and_the_reader(tmp_path, arrays):
    """Ranks 0-4, zero-length axes, every integer width, float32 and
    float64, 1-20 names (up to three symbol nodes): h5py and the port's
    reader give back each array with its dtype, shape and values."""
    path = str(tmp_path / "round.h5")
    write_datasets(path, arrays)
    assert os.path.getsize(path) == int.from_bytes(open(path, "rb").read()[40:48], "little")
    assert_same(h5py_arrays(path), arrays)
    assert_same(read_datasets(path), arrays)


def test_many_names_span_symbol_nodes(tmp_path):
    """200 names take 25 symbol nodes under one B-tree leaf; each is
    found by name."""
    arrays = {f"k{i:03d}": np.full((2,), i, np.int32) for i in range(200)}
    path = str(tmp_path / "many.h5")
    write_datasets(path, arrays)
    with h5py.File(path, "r") as f:
        assert list(f) == sorted(arrays)
        for name in ("k000", "k099", "k100", "k199"):
            assert int(f[name][0]) == int(name[1:])


@pytest.mark.parametrize("arrays,error", [
    ({"": np.zeros(1)}, ValueError), ({"a/b": np.zeros(1)}, ValueError),
    ({".": np.zeros(1)}, ValueError),
    ({"x": np.zeros(1, bool)}, NotImplementedError),
    ({"x": np.zeros(1, np.float16)}, NotImplementedError),
])
def test_writer_raises_on_what_it_does_not_write(tmp_path, arrays, error):
    with pytest.raises(error):
        write_datasets(str(tmp_path / "bad.h5"), arrays)


def test_save_h5_needs_no_h5py(tmp_path):
    """save_h5 writes, and load_h5 reads back, a pack in a process where
    h5py cannot be imported."""
    path = str(tmp_path / "pack.h5")
    code = ("import sys\nsys.modules['h5py'] = None\n"
            "from point2cyl_torch.data.h5_io import load_h5, save_h5\n"
            f"save_h5({path!r}, load_h5({os.path.join(ROOT, 'ab_data', 'test.h5')!r}))\n"
            f"print(load_h5({path!r}).sketches.shape)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "(32, 8, 2048, 4)"
    assert_same(h5py_arrays(path), h5py_arrays(os.path.join(ROOT, "ab_data", "test.h5")))
