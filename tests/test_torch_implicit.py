"""The port's implicit sketch networks (point2cyl_torch.models.implicit),
their weight conversion and restore, and the fitting metrics, against the
JAX package on the CPU at a small size.

Weights are drawn by the JAX package and carried across by
core/convert.py; inputs come from numpy seeds. The fitting metrics'
segment samples do not cross frameworks, so both sides take the
deterministic draw: the port with ``generator=None``, the JAX side
through a test-local wrapper of ``sketch_projection`` that passes
``key=None``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.core.checkpoint import restore_implicit_stack
from point2cyl_torch.core.convert import (encoder_state_dict_from_jax,
                                          implicit_state_dict_from_jax)
from point2cyl_torch.eval import metrics as TM
from point2cyl_torch.models.implicit import (ImplicitNet, PointNetEncoder, add_latent,
                                             sample_off_surface)
from point2cyl_tpu.core.torch_compat import export_encoder, export_implicit
from point2cyl_tpu.eval import metrics as JM
from point2cyl_tpu.models import implicit as JI
from point2cyl_tpu.ops import geometry as JG

NARROW = dict(d_in=2 + 16, hidden=(32,) * 4, skip_in=(2,))
FULL = dict(d_in=258)
ENCODERS = [(256, 2, True), (256, 4, False), (256, 7, False)]
ATOL = 1e-5  # float32 sums in another order; the SDFs reach |f| ~ 16


def jax_implicit(kw: dict, seed: int = 0):
    net = JI.ImplicitNet(**kw)
    variables = net.init(jax.random.key(seed), jnp.zeros((1, kw["d_in"])))
    return net, jax.device_get(variables["params"])


def jax_encoder(args: tuple, seed: int = 1):
    """A JAX encoder with BN affine parameters and running statistics drawn
    from a numpy seed (a fresh encoder's are 1 and 0)."""
    enc = JI.PointNetEncoder(*args)
    variables = enc.init(jax.random.key(seed), jnp.zeros((1, 16, 8)), train=False)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, np.shape(leaf)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "mean" or (name == "bias" and "BatchNorm" in str(path)):
            return rng.normal(0.0, 0.1, shape).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(draw, jax.device_get(variables["params"]))
    stats = jax.tree_util.tree_map_with_path(draw, jax.device_get(variables["batch_stats"]))
    return enc, params, stats


def port_implicit(kw: dict, params) -> ImplicitNet:
    net = ImplicitNet(**kw)
    net.load_state_dict(implicit_state_dict_from_jax(params), strict=True)
    return net


def port_encoder(args: tuple, params, stats) -> PointNetEncoder:
    enc = PointNetEncoder(*args)
    enc.load_state_dict(encoder_state_dict_from_jax(params, stats), strict=True)
    return enc.eval()


@pytest.mark.parametrize("kw,n", [(NARROW, 96), (FULL, 64)], ids=["narrow", "full"])
def test_implicit_net_matches_jax(kw, n):
    """Same keys and values as ``export_implicit``; the SDF within 1e-5 of
    JAX's (softplus beta=100 is the identity above beta x = 20 in torch,
    log1p(exp) in JAX: they differ by < 1e-10 there)."""
    net, params = jax_implicit(kw)
    sd = implicit_state_dict_from_jax(params)
    want_sd = export_implicit(params)
    assert set(sd) == set(want_sd)
    for key, val in want_sd.items():
        np.testing.assert_array_equal(sd[key].numpy(), val, key)
    x = np.random.default_rng(3).uniform(-1.5, 1.5, (n, kw["d_in"])).astype(np.float32)
    want = np.asarray(net.apply({"params": params}, x))
    got = port_implicit(kw, params)(torch.from_numpy(x))
    assert got.shape == (n, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)


def test_implicit_net_layout_and_geometric_init():
    """The reference's layer widths (the layer before the skip is
    hidden - d_in wide) and, from a seeded generator, the SDF of the
    unit circle at the start, the same for the same seed."""
    net = ImplicitNet(**FULL)
    assert net.lin3.weight.shape == (512 - 258, 512)
    assert net.lin4.weight.shape == (512, 512) and net.lin8.weight.shape == (1, 512)
    net.reset_parameters(torch.Generator().manual_seed(4))
    again = ImplicitNet(**FULL)
    again.reset_parameters(torch.Generator().manual_seed(4))
    for key, val in net.state_dict().items():
        assert torch.equal(val, again.state_dict()[key]), key
    assert float(net.lin8.bias.detach()) == -1.0
    assert bool((net.lin0.bias == 0).all())
    lat = torch.zeros(1, 256)
    ring = torch.tensor([[[np.cos(a), np.sin(a)] for a in np.linspace(0, 6, 32)]],
                        dtype=torch.float32)
    with torch.no_grad():
        far = net(add_latent(3.0 * ring, lat)).mean()
        near = net(add_latent(ring, lat)).abs().mean()
    assert float(far) > float(near)


@pytest.mark.parametrize("args", ENCODERS, ids=["sketch", "whole_pc", "whole_pc_axis"])
def test_encoder_matches_jax(args):
    """Keys and values equal ``export_encoder``'s, plus BatchNorm1d's
    ``num_batches_tracked``; loaded with strict=True; the latent within
    1e-5 of JAX's on 8-channel input (the encoder cuts it)."""
    enc, params, stats = jax_encoder(args)
    sd = encoder_state_dict_from_jax(params, stats)
    want_sd = export_encoder(params, stats)
    counts = {k for k in sd if k.endswith("num_batches_tracked")}
    assert set(sd) - counts == set(want_sd) and len(counts) == 5
    for key, val in want_sd.items():
        np.testing.assert_array_equal(sd[key].numpy(), val, key)
    port = port_encoder(args, params, stats)
    assert set(port.state_dict()) == set(sd)
    x = np.random.default_rng(5).normal(size=(3, 40, 8)).astype(np.float32)
    want = np.asarray(enc.apply({"params": params, "batch_stats": stats}, x, train=False))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_encoder_train_mode_counts_batches():
    enc = PointNetEncoder(16, 2, True)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 32, 4)).astype(np.float32))
    enc(x, train=True, momentum=0.5)
    assert int(enc.mlp2[7].num_batches_tracked) == 1
    assert not bool((enc.mlp1[1].running_mean == 0).all())
    with pytest.raises(RuntimeError, match="num_batches_tracked"):
        sd = enc.state_dict()
        del sd["mlp1.1.num_batches_tracked"]
        PointNetEncoder(16, 2, True).load_state_dict(sd, strict=True)


def test_add_latent_is_exact():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(3, 10, 2)).astype(np.float32)
    lat = rng.normal(size=(3, 5)).astype(np.float32)
    got = add_latent(torch.from_numpy(pts), torch.from_numpy(lat)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JI.add_latent(pts, lat)))
    np.testing.assert_array_equal(got[:, :, :5], np.broadcast_to(lat[:, None], (3, 10, 5)))


def test_sample_off_surface_shape_range_and_repeat():
    pts = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (2, 64, 2))
                           .astype(np.float32))
    draw = lambda seed: sample_off_surface(torch.Generator().manual_seed(seed), pts)  # noqa: E731
    out = draw(1)
    assert out.shape == (2, 64 + 8, 2)
    local = out[:, :64] - pts
    assert float(local.abs().max()) < 0.1 and float(local.std()) > 0.005
    glob = out[:, 64:]
    assert float(glob.abs().max()) <= 1.8 and float(glob.abs().max()) > 0.9
    assert torch.equal(out, draw(1)) and not torch.equal(out, draw(2))


def test_restore_implicit_stack_from_both_layouts(tmp_path):
    """``model.pth`` in the IGR layout and ``im_model.pth`` in the joint
    layout restore the same weights; no file gives None; a file in
    neither layout and mismatched keys raise."""
    kw = NARROW
    src_i = ImplicitNet(**kw)
    src_e = PointNetEncoder(16, 2, True)
    src_e.reset_parameters(torch.Generator().manual_seed(9))
    layouts = {"model": {"model_state_dict": src_i.state_dict(),
                         "encoder_state_dict": src_e.state_dict()},
               "im_model": {"implicit_net": src_i.state_dict(),
                            "pn_encoder": src_e.state_dict()}}
    assert restore_implicit_stack(str(tmp_path), ImplicitNet(**kw), None) is None
    for name, state in layouts.items():
        d = tmp_path / name
        d.mkdir()
        torch.save(state, d / f"{name}.pth")
        imp, enc = ImplicitNet(**kw), PointNetEncoder(16, 2, True)
        assert restore_implicit_stack(str(d), imp, enc) == name
        for got, want in ((imp, src_i), (enc, src_e)):
            for key, val in want.state_dict().items():
                assert torch.equal(got.state_dict()[key], val), key
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_implicit_stack(str(tmp_path / "model"), ImplicitNet(**kw),
                               PointNetEncoder(16, 7, False))
    torch.save({"model": src_i.state_dict()}, tmp_path / "model.pth")
    with pytest.raises(KeyError, match="neither implicit layout"):
        restore_implicit_stack(str(tmp_path), ImplicitNet(**kw), None)


# ---- the fitting metrics ---------------------------------------------------

B, N, K, S, L = 3, 96, 4, 16, 16


def draw_deterministically(monkeypatch, *targets):
    """Each ``(module, name)`` segment-drawing function, of either package,
    called with its key or generator None: the deterministic draw.
    Test-local wrappers; nothing of either package is edited."""
    for module, name in targets:
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda _draw, *a, _real=real, **kw: _real(None, *a, **kw))


def fitting_case(seed: int = 11) -> dict[str, np.ndarray]:
    """Points in the unit ball with labels 0..n-1 (each at least twice),
    random base/barrel labels; sample 0's instance 1 has no barrel point
    (an unfound segment), sample 1's slot 2 is invalid."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    pts *= (rng.uniform(0.2, 1.0, (B, N, 1)) / np.linalg.norm(pts, axis=-1,
                                                                keepdims=True))
    normals = rng.normal(size=(B, N, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    n_inst = np.array([3, K, 2])
    seg = np.stack([rng.integers(0, ni, N) for ni in n_inst]).astype(np.int32)
    for b in range(B):
        seg[b, :2 * n_inst[b]] = np.repeat(np.arange(n_inst[b]), 2)
    bb = rng.integers(0, 2, (B, N)).astype(np.int32)
    bb[0, seg[0] == 1] = 1
    axes = rng.normal(size=(B, K, 3)).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    lat = rng.normal(size=(B, K, L)).astype(np.float32)
    valid = np.ones((B, K), bool)
    valid[1, 2] = False
    valid[0, 3] = valid[2, 2:] = False
    return {"points": pts, "normals": normals, "seg": seg, "bb": bb, "axes": axes,
            "centers": rng.uniform(-0.3, 0.3, (B, K, 3)).astype(np.float32),
            "scales": rng.uniform(0.5, 1.5, (B, K)).astype(np.float32),
            "latents": lat / np.linalg.norm(lat, axis=-1, keepdims=True),
            "valid": valid}


def test_fitting_losses_match_jax(monkeypatch):
    """Both terms within 1e-5 of JAX's through the deterministic draw,
    with an unfound segment and an invalid slot; the global term's
    min over K never picks the 1e4 fill where a valid, found slot
    exists."""
    draw_deterministically(monkeypatch, (JM, "sketch_projection"))
    kw = dict(d_in=2 + L, hidden=(32,) * 4, skip_in=(2,))
    net, params = jax_implicit(kw, seed=12)
    c = fitting_case()
    found = JG.segment_masks(jnp.asarray(c["seg"]), jnp.asarray(c["bb"]), K).sum(-1) > 1
    assert not bool(found[0, 1])
    args = [c[k] for k in ("points", "normals", "seg", "bb", "axes", "centers", "scales",
                           "latents", "valid")]
    want = JM.fitting_losses(lambda x: net.apply({"params": params}, x),
                             jax.random.key(0), *map(jnp.asarray, args), S)
    got = TM.fitting_losses(port_implicit(kw, params), None,
                            *(torch.from_numpy(a) for a in args), S)
    for g, w in zip(got, want):
        assert g.shape == (B,) and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    assert float(got[1].max()) < 1e3


def test_fitting_losses_draw_from_the_generator():
    kw = dict(d_in=2 + L, hidden=(32,) * 4, skip_in=(2,))
    net = ImplicitNet(**kw)
    c = fitting_case()
    args = [torch.from_numpy(c[k]) for k in ("points", "normals", "seg", "bb", "axes",
                                              "centers", "scales", "latents", "valid")]
    draw = lambda seed: TM.fitting_losses(  # noqa: E731
        net, torch.Generator().manual_seed(seed), *args, S)
    a, b, other = draw(1), draw(1), draw(2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], other[0])
