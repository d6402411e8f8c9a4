"""Port backbone (point2cyl_torch.models) against the JAX backbone, from
the same weights carried across by core/convert.py."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.core.config import BackboneConfig as TorchConfig
from point2cyl_torch.core.convert import backbone_state_dict_from_jax
from point2cyl_torch.models.backbone import Backbone as TorchBackbone
from point2cyl_torch.models.backbone import build_backbone
from point2cyl_torch.train.steps import assemble_heads as torch_assemble_heads
from point2cyl_tpu.core.config import BackboneConfig
from point2cyl_tpu.core.torch_compat import export_backbone
from point2cyl_tpu.models.backbone import Backbone
from point2cyl_tpu.train.steps import assemble_heads

K = 8
CFG = BackboneConfig(
    num_points=256,
    sa_npoints=(64, 16),
    sa_radii=(0.2, 0.4),
    sa_nsamples=(16, 16),
    sa_mlps=((16, 32), (32, 64)),
    sa_global_mlp=(64, 128),
    fp_mlps=((64,), (32,), (32, 32)),
    fc_width=32,
    output_sizes=(3, 2 * K),
    approx_neighbors=False,
)


def jax_variables(seed: int):
    """JAX init with non-trivial BN affine parameters and statistics."""
    model = Backbone(CFG)
    key = jax.random.key(seed)
    variables = model.init({"params": key, "sample": key, "dropout": key},
                           jnp.zeros((1, CFG.num_points, 3)), train=False)
    rng = np.random.default_rng(seed)

    def bn(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("bias", "mean") and "TorchBatchNorm" in str(path):
            return rng.normal(0.0, 0.1, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(bn, jax.device_get(variables["params"]))
    stats = jax.tree_util.tree_map_with_path(bn, jax.device_get(variables["batch_stats"]))
    return model, {"params": params, "batch_stats": stats}


def torch_config() -> TorchConfig:
    return TorchConfig.from_dict(dataclasses.asdict(CFG))


def clouds(seed: int, b: int) -> np.ndarray:
    pts = np.random.default_rng(seed).normal(size=(b, CFG.num_points, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    return pts.astype(np.float32)


def test_state_dict_from_jax_equals_export_backbone():
    """Same keys and values as the JAX package's reference export, and the
    port's model takes it with strict=True."""
    _, variables = jax_variables(0)
    sd = backbone_state_dict_from_jax(variables["params"], variables["batch_stats"])
    want = export_backbone(variables["params"], variables["batch_stats"])
    assert set(sd) == set(want)
    for key, val in want.items():
        assert tuple(sd[key].shape) == np.shape(val), key
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(val), key)
    model = TorchBackbone(torch_config())
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)


def test_reference_checkpoint_with_bn_counters_loads_strict():
    """A reference .pth also carries BatchNorm num_batches_tracked: it
    loads strictly and the counters are dropped."""
    _, variables = jax_variables(1)
    sd = backbone_state_dict_from_jax(variables["params"], variables["batch_stats"])
    for key in [k for k in sd if k.endswith("running_mean")]:
        sd[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(7)
    model = TorchBackbone(torch_config())
    model.load_state_dict(sd, strict=True)
    assert not any("num_batches_tracked" in k for k in model.state_dict())


@pytest.mark.parametrize("seed,b", [(0, 2), (3, 3)])
def test_backbone_eval_forward_matches_jax(seed, b):
    """x_raw and w_raw within 1e-4 of the JAX eval forward (exact
    neighbours on both sides; JAX's CPU path is XLA)."""
    model, variables = jax_variables(seed)
    pts = clouds(100 + seed, b)
    x_j, w_j = jax.jit(lambda v, p: model.apply(v, p, train=False))(
        variables, jnp.asarray(pts))
    sd = backbone_state_dict_from_jax(variables["params"], variables["batch_stats"])
    port = build_backbone(torch_config(), state_dict=sd, device="cpu")
    with torch.inference_mode():
        x_t, w_t = port(torch.from_numpy(pts))
    assert np.abs(np.asarray(x_j)).max() > 0.1  # a forward worth comparing
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-4, rtol=0)


def test_plain_impls_match_auto_on_cpu():
    """On the CPU "auto" routes to the plain versions: identical results."""
    _, variables = jax_variables(2)
    sd = backbone_state_dict_from_jax(variables["params"], variables["batch_stats"])
    plain_cfg = dataclasses.replace(torch_config(), fps_impl="plain",
                                    ballquery_impl="plain", knn_impl="plain")
    pts = torch.from_numpy(clouds(7, 2))
    with torch.inference_mode():
        auto = build_backbone(torch_config(), state_dict=sd, device="cpu")(pts)
        plain = build_backbone(plain_cfg, state_dict=sd, device="cpu")(pts)
    for a, p in zip(auto, plain):
        torch.testing.assert_close(a, p, rtol=0, atol=0)


def test_assemble_heads_matches_jax():
    rng = np.random.default_rng(4)
    x_raw = rng.normal(size=(2, 32, 3)).astype(np.float32)
    w_raw = rng.normal(size=(2, 32, 2 * K)).astype(np.float32)
    want = assemble_heads(jnp.asarray(x_raw), jnp.asarray(w_raw), True, True, k=K)
    got = torch_assemble_heads(torch.from_numpy(x_raw), torch.from_numpy(w_raw),
                               True, True, k=K)
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("dtype,builds", [
    ("bfloat16", True), ("float16", True), ("float64", False), ("int8", False),
    ("bf16", False),
])
def test_compute_dtypes_build_or_raise(dtype, builds):
    """JAX's low-precision compute dtypes build a backbone config, a
    trainer config and a backbone; any other name raises, as
    ``jnp.dtype`` would not cast it the same way."""
    from point2cyl_torch.core.config import TrainConfig

    if builds:
        cfg = dataclasses.replace(torch_config(), compute_dtype=dtype)
        assert TrainConfig(compute_dtype=dtype).compute_dtype == dtype
        assert TorchBackbone(cfg).fc1.compute_dtype == getattr(torch, dtype)
        return
    with pytest.raises(NotImplementedError):
        TorchConfig(compute_dtype=dtype)
    with pytest.raises(NotImplementedError):
        TrainConfig(compute_dtype=dtype)


def test_config_rejects_unknown_impl():
    with pytest.raises(ValueError):
        TorchConfig(fps_impl="pallas")


def test_builder_defaults_to_the_card():
    """Without device= the builder wants CUDA and raises where there is
    none; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_backbone(torch_config())
