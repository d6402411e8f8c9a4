"""The port's offline preprocessing (point2cyl_torch/data/preprocess.py)
against the JAX package's, on the CPU at a small size.

The models are Fusion 360 Gallery-style OBJ and JSON files written by
code: ``tests/test_preprocess.py``'s box and ``chip_smoke.py``'s set (joins
of 1-4 extrusions on axis-aligned and oblique axes, a two-profile
extrusion, a cut that splits faces, 9 and 10 instances, a tapered
extrusion), which the card's check preprocesses at full width. Every
array equals JAX's exactly: the draws are numpy's ``default_rng(seed)``
on both sides. The sketches go through the float32 sketch-plane rotation
(torch on one side, XLA on the other) and are held within 1e-6, their
unit max norm's float32 rounding.
"""

from __future__ import annotations

import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch

from chip_smoke import write_fusion_models
from point2cyl_torch.data import preprocess as tp
from point2cyl_torch.data.h5_io import load_h5
from point2cyl_tpu.data import preprocess as jp
from test_preprocess import make_fixture

NP, SK = 512, 16  # points and sketch points a model
SKETCH_ATOL = 1e-6


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fusion"))
    expected = write_fusion_models(root)
    make_fixture(root)  # tests/test_preprocess.py's box, "model"
    return root, dict(expected, model=1)


def assert_sample_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, val in want.items():
        val, out = np.asarray(val), np.asarray(got[key])
        assert out.dtype == val.dtype and out.shape == val.shape, key
        if key.startswith("sketches"):
            np.testing.assert_allclose(out, val, rtol=0, atol=SKETCH_ATOL, err_msg=key)
        else:
            np.testing.assert_array_equal(out, val, err_msg=key)


@pytest.mark.parametrize("k", [8, 10])
def test_preprocess_model_matches_jax(models, k):
    """Each model at --K 8 and 10: the same rejections (the tapered one at
    both, 9 and 10 instances at 8) and the same arrays."""
    root, expected = models
    for mid, n_inst in expected.items():
        got = tp.preprocess_model(root, mid, NP, k, SK, seed=3, device="cpu")
        want = jp.preprocess_model(root, mid, NP, k, SK, seed=3)
        if n_inst is None or n_inst > k:
            assert got is None and want is None, mid
            continue
        assert got["n_instances"] == n_inst, mid
        assert_sample_equal(got, want)


def test_build_dataset_matches_jax(models):
    root, expected = models
    ids = list(expected)
    ds_t, kept_t = tp.build_dataset(root, ids, NP, 8, SK, seed=1, device="cpu")
    ds_j, kept_j = jp.build_dataset(root, ids, NP, 8, SK, seed=1)
    assert kept_t == kept_j == [m for m, n in expected.items() if n is not None and n <= 8]
    assert_sample_equal(dataclasses.asdict(ds_t), dataclasses.asdict(ds_j))


def test_cli_writes_a_pack_jax_reads(models, tmp_path, capsys):
    """``python -m point2cyl_torch.data.preprocess --device cpu`` end to
    end: the kept/total line, and a pack that the port's reader, h5py
    and JAX's ``load_h5`` all read as ``build_dataset``'s arrays."""
    from point2cyl_tpu.data.h5_io import load_h5 as jax_load_h5

    root, expected = models
    out = str(tmp_path / "train.h5")
    kept = tp.cli_main(["--raw_dir", root, "--out", out, "--num_points", str(NP),
                        "--K", "10", "--num_sk_point", str(SK), "--seed", "2",
                        "--device", "cpu"])
    total = len(expected)
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"Preprocessed {len(kept)}/{total} models -> {out}")
    assert kept == [m for m, n in expected.items() if n is not None]
    ds, _ = jp.build_dataset(root, sorted(expected), NP, 10, SK, seed=2)
    want = {key: val for key, val in dataclasses.asdict(ds).items() if val is not None}
    for read in (load_h5, jax_load_h5):
        got = dataclasses.asdict(read(out))
        for key, val in want.items():
            stored = val.astype(np.int32 if np.issubdtype(val.dtype, np.integer)
                                else np.float32)
            assert got[key].dtype == stored.dtype, key
            atol = SKETCH_ATOL if key.startswith("sketches") else 0.0
            np.testing.assert_allclose(got[key], stored, rtol=0, atol=atol, err_msg=key)
    with h5py.File(out, "r") as f:
        assert sorted(f) == sorted(want)
        assert f["extrusion_labels"].compression is None  # written uncompressed


def test_cli_needs_the_card_unless_told(models, tmp_path, monkeypatch):
    root, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.cli_main(["--raw_dir", root, "--out", str(tmp_path / "x.h5")])
    assert not os.path.exists(tmp_path / "x.h5")
