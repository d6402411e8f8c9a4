"""Port serving (point2cyl_torch.serve) against the JAX serving path: the
decomposition from identical heads, whole requests through both
InferenceSessions from the same weights, the sketch latents against the
JAX serving forward, and the export CLI."""

from __future__ import annotations

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.core.config import BackboneConfig as TorchConfig
from point2cyl_torch.core.convert import (backbone_state_dict_from_jax,
                                          encoder_state_dict_from_jax)
from point2cyl_torch.models.backbone import Backbone as TorchBackbone
from point2cyl_torch.models.implicit import ImplicitNet, PointNetEncoder
from point2cyl_torch.serve import export as torch_export
from point2cyl_torch.serve.session import InferenceSession as TorchSession
from point2cyl_torch.train.steps import HeadOutputs as TorchHeads
from point2cyl_tpu.serve import InferenceSession, export_artifact
from point2cyl_tpu.serve.export import _backbone_forward, _decomposition
from point2cyl_tpu.train.steps import assemble_heads

from test_torch_backbone import CFG, K, clouds, jax_variables, torch_config
from test_torch_implicit import jax_encoder

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
    """An artifact that claims sketch latents but holds no encoder weights
    is refused, not served without them."""
    path = str(tmp_path / "latents.p2ct")
    with zipfile.ZipFile(artifacts[1]) as src, zipfile.ZipFile(path, "w") as dst:
        meta = json.loads(src.read("meta.json"))
        meta.update(with_latents=True, latent_size=32)
        dst.writestr("meta.json", json.dumps(meta))
        dst.writestr("weights.pt", src.read("weights.pt"))
    with pytest.raises(ValueError, match="encoder"):
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


# ---- sketch latents ----------------------------------------------------------

L = 32  # latent width of the test's encoder


@pytest.fixture(scope="module")
def latent_artifact(weights, tmp_path_factory):
    """The JAX serving forward with a sketch encoder (random BN statistics)
    and a port artifact of the same weights, buckets (2, 4)."""
    _, variables, sd = weights
    _, enc_params, enc_stats = jax_encoder((L, 2, True), seed=15)
    path = str(tmp_path_factory.mktemp("torch_serve_latents") / "lat.p2ct")
    meta = torch_export.export_artifact(
        path, sd, k=K, backbone_config=torch_config(), buckets=(2, 4), num_sk_points=SK,
        encoder_state_dict=encoder_state_dict_from_jax(enc_params, enc_stats),
        encoder_latent=L)
    assert meta["with_latents"] and meta["latent_size"] == L
    _, fn = _backbone_forward(CFG, k=K, num_sk_points=SK, encoder_latent=L)
    jax_vars = {"backbone": variables,
                "encoder": {"params": enc_params, "batch_stats": enc_stats}}
    return path, jax.jit(fn), jax_vars


def test_session_serves_latents_matching_jax(latent_artifact, sessions):
    """Latents (n, K, L) within 1e-3 of the JAX serving forward's through
    the float16 pack and within 1e-5 with exact_latents; labels and
    geometry equal the same request through the artifact without the
    encoder, bit for bit."""
    path, fn, jax_vars = latent_artifact
    sess = TorchSession(path, device="cpu")
    pts = clouds(60, 3)
    want = jax.device_get(fn(jax_vars, jnp.asarray(pts)))
    got = sess.decompose(pts)
    exact = sess.decompose(pts, exact_latents=True)
    assert got["latents"].shape == (3, K, L) and got["latents"].dtype == np.float32
    np.testing.assert_array_equal(got["labels"], np.asarray(want["labels"]))
    np.testing.assert_allclose(got["latents"], want["latents"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(exact["latents"], want["latents"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got["latents"], axis=-1), 1.0, atol=1e-3)
    plain = sessions[1].decompose(pts)
    assert "latents" not in plain
    for key, val in plain.items():
        np.testing.assert_array_equal(got[key], val, key)
        np.testing.assert_array_equal(exact[key], val, key)


def test_pack_unpack_with_latents():
    """Geometry bit for bit beside float16 latents; the latents unpack to
    float32 equal to their float16 cast."""
    rng = np.random.default_rng(13)
    out = {
        "axes": torch.from_numpy(rng.normal(size=(2, K, 3)).astype(np.float32)),
        "centers": torch.from_numpy(rng.normal(size=(2, K, 3)).astype(np.float32)),
        "extents": torch.from_numpy(rng.normal(size=(2, K, 2)).astype(np.float32)),
        "scales": torch.from_numpy(rng.uniform(size=(2, K)).astype(np.float32)),
        "found": torch.from_numpy(rng.uniform(size=(2, K)) > 0.5),
        "latents": torch.from_numpy(rng.normal(size=(2, K, L)).astype(np.float32)),
    }
    packed = torch_export.pack_decomposition(out)
    assert packed.shape == (2, K, 20 + L)
    back = torch_export.unpack_decomposition(packed.numpy(), with_latents=True)
    for key, val in out.items():
        want = val.numpy()
        if key == "latents":
            want = want.astype(np.float16).astype(np.float32)
        np.testing.assert_array_equal(back[key], want, key)
    assert "latents" not in torch_export.unpack_decomposition(packed.numpy())


def test_artifact_without_latents_still_loads(artifacts):
    """An artifact in the layout written before latents were served
    (meta.json and weights.pt only) loads and serves geometry alone."""
    with zipfile.ZipFile(artifacts[1]) as z:
        assert sorted(z.namelist()) == ["meta.json", "weights.pt"]
        meta = json.loads(z.read("meta.json"))
    assert meta["with_latents"] is False and meta["latent_size"] is None
    art = torch_export.load_artifact(artifacts[1])
    assert art.encoder_weights is None
    sess = TorchSession(art, device="cpu")
    assert sess.encoder is None
    assert "latents" not in sess.decompose(clouds(61, 1), exact_latents=True)


def test_latents_need_the_decomposition(weights, tmp_path):
    with pytest.raises(ValueError, match="num_sk_points"):
        torch_export.export_artifact(
            str(tmp_path / "x.p2ct"), weights[2], k=K, backbone_config=torch_config(),
            encoder_state_dict=PointNetEncoder().state_dict())


def test_export_cli_round_trip(tmp_path, capsys):
    """The CLI restores a trainer logdir's backbone and an IGR logdir's
    encoder and writes an artifact that serves latents; without
    --im_logdir, or with one that holds no checkpoint, it writes geometry
    alone, equal bit for bit; --no_decomp writes heads only."""
    n, k = 128, 4
    logdir, im_logdir = tmp_path / "run", tmp_path / "igr"
    logdir.mkdir()
    im_logdir.mkdir()
    model = TorchBackbone(TorchConfig(num_points=n, output_sizes=(3, 2 * k)))
    model.reset_parameters(torch.Generator().manual_seed(16))
    torch.save({"model": model.state_dict()}, logdir / "model.pth")
    encoder = PointNetEncoder(256, 2, True)
    encoder.reset_parameters(torch.Generator().manual_seed(17))
    torch.save({"model_state_dict": ImplicitNet().state_dict(),
                "encoder_state_dict": encoder.state_dict()}, im_logdir / "model.pth")
    base = ["--logdir", str(logdir), "--num_point", str(n), "--K", str(k),
            "--num_sk_point", "16", "--buckets", "1", "2", "--device", "cpu"]
    paths = {name: str(tmp_path / f"{name}.p2ct") for name in ("lat", "geo", "heads")}
    meta = torch_export.cli_main(base + ["--out", paths["lat"], "--im_logdir",
                                         str(im_logdir)])
    assert meta["with_latents"] and meta["latent_size"] == 256
    assert capsys.readouterr().out.splitlines()[:2] == ["Restored backbone",
                                                        "Restored sketch encoder"]
    empty = tmp_path / "empty"
    empty.mkdir()
    geo = torch_export.cli_main(base + ["--out", paths["geo"], "--im_logdir", str(empty)])
    assert not geo["with_latents"] and geo["decomposition"]
    assert "WARNING: no encoder checkpoint" in capsys.readouterr().out
    heads = torch_export.cli_main(base + ["--out", paths["heads"], "--no_decomp"])
    assert not heads["decomposition"] and heads["buckets"] == [1, 2]
    art = torch_export.load_artifact(paths["lat"])
    for key, val in model.state_dict().items():
        assert torch.equal(art.weights[key], val), key
    for key, val in encoder.state_dict().items():
        assert torch.equal(art.encoder_weights[key], val), key
    pts = np.random.default_rng(18).normal(size=(3, n, 3)).astype(np.float32)
    got = TorchSession(paths["lat"], device="cpu").decompose(pts)
    assert got["latents"].shape == (3, k, 256)
    np.testing.assert_allclose(np.linalg.norm(got["latents"], axis=-1), 1.0, atol=1e-3)
    for key, val in TorchSession(paths["geo"], device="cpu").decompose(pts).items():
        np.testing.assert_array_equal(got[key], val, key)
