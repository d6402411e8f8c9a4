"""Port serving (point2cyl_torch.serve) against the JAX serving path: the
decomposition from identical heads, and whole requests through both
InferenceSessions from the same weights."""

from __future__ import annotations

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.core.convert import backbone_state_dict_from_jax
from point2cyl_torch.serve import export as torch_export
from point2cyl_torch.serve.session import InferenceSession as TorchSession
from point2cyl_torch.train.steps import HeadOutputs as TorchHeads
from point2cyl_tpu.serve import InferenceSession, export_artifact
from point2cyl_tpu.serve.export import _decomposition
from point2cyl_tpu.train.steps import assemble_heads

from test_torch_backbone import CFG, K, clouds, jax_variables, torch_config

SK = 64  # sketch samples per instance, as tests/test_serve.py uses
GEO = ("centers", "extents", "scales")


def assert_axes_close(got, want):
    """Unit axes equal up to sign: |dot| > 1 - 1e-5."""
    dots = np.abs(np.sum(np.asarray(got) * np.asarray(want), axis=-1))
    assert dots.min() > 1.0 - 1e-5, dots.min()


@pytest.fixture(scope="module")
def weights():
    model, variables = jax_variables(11)
    sd = backbone_state_dict_from_jax(variables["params"], variables["batch_stats"])
    return model, variables, sd


@pytest.fixture(scope="module")
def artifacts(weights, tmp_path_factory):
    """The same weights as a JAX .p2cx and a port artifact, buckets (2, 4)."""
    _, variables, sd = weights
    d = tmp_path_factory.mktemp("torch_serve")
    jax_path, torch_path = str(d / "m.p2cx"), str(d / "m.p2ct")
    export_artifact(jax_path, variables, k=K, backbone_config=CFG,
                    buckets=(2, 4), num_sk_points=SK)
    torch_export.export_artifact(torch_path, sd, k=K, backbone_config=torch_config(),
                                 buckets=(2, 4), num_sk_points=SK)
    return jax_path, torch_path


@pytest.fixture(scope="module")
def sessions(artifacts):
    """(JAX session, port session on the CPU), shared so JAX compiles once."""
    return InferenceSession(artifacts[0]), TorchSession(artifacts[1], device="cpu")


def test_decomposition_from_identical_heads(weights):
    """JAX's heads, as numpy, through both _decomposition functions."""
    model, variables, _ = weights
    pts = clouds(21, 3)

    @jax.jit
    def jax_side(v, p):
        x_raw, w_raw = model.apply(v, p, train=False)
        heads = assemble_heads(x_raw, w_raw, True, True, k=K)
        return heads, _decomposition(heads, p, SK)

    heads_j, want = jax.device_get(jax_side(variables, jnp.asarray(pts)))
    heads_t = TorchHeads(*(torch.tensor(np.asarray(h)) for h in heads_j))
    got = torch_export._decomposition(heads_t, torch.from_numpy(pts), SK)
    for key in ("labels", "bb_labels", "found"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), key)
    assert got["found"].any()
    assert_axes_close(got["axes"].numpy(), want["axes"])
    for key in GEO:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, rtol=0, err_msg=key)
    # packing lays the float32 geometry out in the same 16-bit lanes
    same = {k: torch.tensor(np.asarray(want[k]))
            for k in ("axes", "centers", "extents", "scales", "found")}
    lanes = torch_export.pack_decomposition(same).numpy().view(np.uint16)
    np.testing.assert_array_equal(lanes, np.asarray(want["packed"]))


def test_pack_unpack_roundtrip_bitwise():
    rng = np.random.default_rng(12)
    out = {
        "axes": torch.from_numpy(rng.normal(size=(2, K, 3)).astype(np.float32)),
        "centers": torch.from_numpy(rng.normal(size=(2, K, 3)).astype(np.float32)),
        "extents": torch.from_numpy(rng.normal(size=(2, K, 2)).astype(np.float32)),
        "scales": torch.from_numpy(rng.uniform(size=(2, K)).astype(np.float32)),
        "found": torch.from_numpy(rng.uniform(size=(2, K)) > 0.5),
    }
    packed = torch_export.pack_decomposition(out)
    assert packed.shape == (2, K, 20)
    back = torch_export.unpack_decomposition(packed.numpy())
    for key, val in out.items():
        np.testing.assert_array_equal(back[key], val.numpy(), key)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_session_decompose_matches_jax_session(sessions, n):
    """Whole requests through both sessions; odd sizes chunk to the largest
    bucket and pad the tail (1 -> 2, 3 -> 4, 5 -> 4 + 2)."""
    jax_sess, sess = sessions
    pts = clouds(30 + n, n)
    want = jax_sess.decompose(pts)
    padded = sess.stats["padded"]
    got = sess.decompose(pts)
    assert sess.stats["padded"] == padded + 1
    assert got["labels"].dtype == np.int8 and got["axes"].shape == (n, K, 3)
    for key in ("labels", "bb_labels", "found"):
        np.testing.assert_array_equal(got[key], want[key], key)
    assert_axes_close(got["axes"], want["axes"])
    for key in GEO:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=0,
                                   err_msg=key)


def test_padding_rows_do_not_perturb_real_rows(weights, tmp_path):
    """One cloud through a single bucket of 4 (three zero rows ride along)
    equals the same cloud served unpadded."""
    _, _, sd = weights
    paths = {}
    for buckets in ((4,), (1,)):
        paths[buckets] = str(tmp_path / f"b{buckets[0]}.p2ct")
        torch_export.export_artifact(paths[buckets], sd, k=K,
                                     backbone_config=torch_config(),
                                     buckets=buckets, num_sk_points=SK)
    pts = clouds(40, 1)
    padded = TorchSession(paths[(4,)], device="cpu")
    got = padded.decompose(pts)
    assert padded.stats["padded"] == 3
    want = TorchSession(paths[(1,)], device="cpu").decompose(pts)
    for key in ("labels", "bb_labels", "found"):
        np.testing.assert_array_equal(got[key], want[key], key)
    for key in ("axes",) + GEO:
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0,
                                   err_msg=key)


def test_session_predict_matches_jax_session(sessions):
    jax_sess, sess = sessions
    pts = clouds(50, 3)
    want = jax_sess.predict(pts)
    got = sess.predict(pts)
    assert set(got) == {"normals", "w", "w_barrel", "w_base"}
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, atol=1e-4, rtol=0, err_msg=key)
    raw = sess.predict(pts[0], assemble=False)
    assert raw["x_raw"].shape == (CFG.num_points, 3)


def test_session_needs_the_card_by_default(artifacts):
    """InferenceSession(path) without device= raises where CUDA is absent."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSession(artifacts[1])


def test_benchmark_needs_the_card(sessions):
    sess = sessions[1]
    with pytest.raises(RuntimeError, match="CUDA"):
        sess.benchmark(batch=1, iters=1)


def test_decompose_requires_decomposition_artifact(weights, tmp_path):
    path = str(tmp_path / "heads.p2ct")
    meta = torch_export.export_artifact(path, weights[2], k=K,
                                        backbone_config=torch_config(), buckets=(1,))
    assert not meta["decomposition"]
    with pytest.raises(ValueError, match="decomposition"):
        TorchSession(path, device="cpu").decompose(clouds(1, 1))


def test_latent_artifacts_not_served(artifacts, tmp_path):
    """An artifact that claims sketch latents is refused, not served
    without them."""
    path = str(tmp_path / "latents.p2ct")
    with zipfile.ZipFile(artifacts[1]) as src, zipfile.ZipFile(path, "w") as dst:
        meta = json.loads(src.read("meta.json"))
        meta.update(with_latents=True, latent_size=32)
        dst.writestr("meta.json", json.dumps(meta))
        dst.writestr("weights.pt", src.read("weights.pt"))
    with pytest.raises(NotImplementedError):
        TorchSession(path, device="cpu")


def test_artifact_meta_keys_follow_jax(artifacts):
    """The port's meta has the JAX artifact's keys (torch_version in place
    of jax_version)."""
    jax_path, torch_path = artifacts
    metas = []
    for path in (jax_path, torch_path):
        with zipfile.ZipFile(path) as z:
            metas.append(json.loads(z.read("meta.json")))
    want = set(metas[0]) - {"jax_version"} | {"torch_version"}
    assert set(metas[1]) == want
