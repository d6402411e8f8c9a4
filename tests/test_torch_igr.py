"""The port's IGR, latent, sketch and chamfer losses
(point2cyl_torch.losses.{igr,sketch}, point2cyl_torch.ops.chamfer)
against the JAX package on the CPU at a small size.

The IGR losses are held in value and in their second-order gradients:
the loss differentiates the SDF with respect to its input, so its
gradients with respect to the latents and the decoder's weights go
through a double backward of the decoder, held against ``jax.grad`` of
the JAX ``igr_losses``. The off-surface samples are drawn with numpy and
given to both sides.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.core.convert import implicit_state_dict_from_jax
from point2cyl_torch.losses import sketch as TS
from point2cyl_torch.losses.igr import igr_losses, latent_loss
from point2cyl_torch.models.implicit import ImplicitNet, sample_off_surface
from point2cyl_torch.ops.chamfer import chamfer_distances, chamfer_loss
from point2cyl_tpu.losses import igr as JIGR
from point2cyl_tpu.losses import sketch as JS
from point2cyl_tpu.models import implicit as JI
from point2cyl_tpu.ops import chamfer as JC

NARROW = dict(d_in=2 + 16, hidden=(32,) * 4, skip_in=(2,))
B, K, S, L = 2, 3, 40, 16
VALUE_ATOL = 1e-5
GRAD_RTOL = 1e-4  # of each tensor's largest entry


def jax_implicit(seed: int = 0):
    net = JI.ImplicitNet(**NARROW)
    params = net.init(jax.random.key(seed), jnp.zeros((1, NARROW["d_in"])))["params"]
    return net, jax.device_get(params)


def igr_case(seed: int, spread: float) -> dict[str, np.ndarray]:
    """Sketches of B x K instances with unit normals, unit latents, the
    numpy off-surface samples, and instance (1, 2) masked out."""
    rng = np.random.default_rng(seed)
    pts = (spread * rng.uniform(-1, 1, (B, K, S, 2))).astype(np.float32)
    nrm = rng.normal(size=(B, K, S, 2)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    lat = rng.normal(size=(B, K, L)).astype(np.float32)
    lat /= np.linalg.norm(lat, axis=-1, keepdims=True)
    off = np.concatenate([
        pts.reshape(B * K, S, 2) + 0.01 * rng.normal(size=(B * K, S, 2)),
        rng.uniform(-1.8, 1.8, (B * K, S // 8, 2))], axis=1).astype(np.float32)
    mask = np.ones((B, K), bool)
    mask[1, 2] = False
    return {"pts": pts, "nrm": nrm, "lat": lat, "off": off, "mask": mask}


def port_igr(implicit, c: dict, **kw):
    lat = torch.from_numpy(c["lat"]).requires_grad_()
    out = igr_losses(implicit, None, torch.from_numpy(c["pts"]), torch.from_numpy(c["nrm"]),
                     lat, torch.from_numpy(c["mask"]), off_pts=torch.from_numpy(c["off"]),
                     **kw)
    return out, lat


def beta_preactivations(implicit: ImplicitNet, x: torch.Tensor) -> torch.Tensor:
    """beta times every hidden layer's pre-activation on ``x``."""
    seen = []
    hooks = [getattr(implicit, f"lin{i}").register_forward_hook(
        lambda _m, _a, out: seen.append(out.detach().reshape(-1)))
        for i in range(implicit.num_layers - 2)]
    try:
        with torch.no_grad():
            implicit(x)
    finally:
        for h in hooks:
            h.remove()
    return implicit.beta * torch.cat(seen)


@pytest.mark.parametrize("spread", [1.0, 3.0], ids=["unit", "wide"])
def test_igr_losses_and_second_order_grads_match_jax(spread):
    """The four scalars within 1e-5 of JAX's, and the gradients with
    respect to the latents and every decoder weight within 1e-4 of each
    tensor's largest entry, against ``jax.grad``. The pre-activations lie
    on both sides of torch's softplus threshold (beta x = 20, above which
    ``F.softplus`` is the identity and JAX's log1p(exp) is not): there the
    first derivatives differ by < 3e-9 and the second by < 3e-7."""
    net, params = jax_implicit()
    c = igr_case(7, spread)

    def total(lat, p):
        out = JIGR.igr_losses(lambda x: net.apply({"params": p}, x), jax.random.key(0),
                              c["pts"], c["nrm"], lat, c["mask"], off_pts=c["off"])
        return out.total, out

    (_, want), (g_lat, g_par) = jax.value_and_grad(total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(c["lat"]), params)

    implicit = ImplicitNet(**NARROW)
    implicit.load_state_dict(implicit_state_dict_from_jax(params), strict=True)
    x = torch.cat([torch.from_numpy(c["lat"]).reshape(B * K, 1, L).expand(-1, S, -1),
                   torch.from_numpy(c["pts"]).reshape(B * K, S, 2)], -1)
    pre = beta_preactivations(implicit, x)
    assert bool((pre > 20).any()) and bool((pre < 20).any())

    got, lat = port_igr(implicit, c)
    for g, w, name in zip(got, want, ("total", "manifold", "eikonal", "sald")):
        np.testing.assert_allclose(g.item(), float(w), rtol=0, atol=VALUE_ATOL, err_msg=name)
    got.total.backward()
    pairs = [("latents", lat.grad, torch.from_numpy(np.array(g_lat)))]
    want_par = implicit_state_dict_from_jax(g_par)
    pairs += [(n, p.grad, want_par[n]) for n, p in implicit.named_parameters()]
    for name, g, w in pairs:
        scale = float(w.abs().max())
        assert scale > 0, name
        err = float((g - w).abs().max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)
    assert not bool(lat.grad[1, 2].any())  # the masked instance


@pytest.mark.parametrize("chunk", [4, 2, 1])
def test_igr_chunks_equal_no_chunking(chunk):
    """Checkpointed chunks of the largest divisor of B*K = 6 not above the
    request (4 -> 3, 2, 1): the values and the gradients with respect to
    the latents and the decoder's weights within 1e-6 of the unchunked
    ones (the second order goes through the recomputation)."""
    implicit = ImplicitNet(**NARROW)
    implicit.reset_parameters(torch.Generator().manual_seed(3))
    c = igr_case(8, 1.0)
    results = []
    for chunk_size in (None, chunk):
        implicit.zero_grad(set_to_none=True)
        out, lat = port_igr(implicit, c, chunk_size=chunk_size)
        out.total.backward()
        results.append((out, [lat.grad, *(p.grad for p in implicit.parameters())]))
    (want, want_g), (got, got_g) = results
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_igr_draws_off_surface_samples_from_the_generator():
    implicit = ImplicitNet(**NARROW)
    c = igr_case(9, 1.0)
    pts = torch.from_numpy(c["pts"])
    args = (pts, torch.from_numpy(c["nrm"]), torch.from_numpy(c["lat"]),
            torch.from_numpy(c["mask"]))
    drawn = igr_losses(implicit, torch.Generator().manual_seed(4), *args)
    given = igr_losses(implicit, None, *args, off_pts=sample_off_surface(
        torch.Generator().manual_seed(4), pts.reshape(B * K, S, 2)))
    other = igr_losses(implicit, torch.Generator().manual_seed(5), *args)
    assert all(torch.equal(a, b) for a, b in zip(drawn, given))
    assert not torch.equal(drawn.eikonal, other.eikonal)


@pytest.mark.parametrize("use_l2", [True, False], ids=["l2", "dot"])
def test_latent_loss_matches_jax(use_l2):
    c = igr_case(10, 1.0)
    gt = np.random.default_rng(11).normal(size=(B, K, L)).astype(np.float32)
    gt /= np.linalg.norm(gt, axis=-1, keepdims=True)
    want = JIGR.latent_loss(c["lat"], gt, c["mask"], use_l2)
    got = latent_loss(*map(torch.from_numpy, (c["lat"], gt, c["mask"])), use_l2)
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=VALUE_ATOL)


def points(seed: int, *shape: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("block_size", [None, 8, 16, 96], ids=["whole", "b8", "b16", "b96"])
def test_chamfer_distances_match_jax(block_size):
    """Nearest-neighbour squared distances within 1e-5 of JAX's, whole or
    over column blocks (a running minimum; M=48)."""
    a, b = points(1, 2, 40, 3), points(2, 2, 48, 3)
    want = JC.chamfer_distances(a, b, block_size=block_size)
    got = chamfer_distances(torch.from_numpy(a), torch.from_numpy(b), block_size=block_size)
    assert got.shape == (2, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=VALUE_ATOL)


def test_chamfer_block_size_must_divide_m():
    a, b = torch.zeros(1, 4, 2), torch.zeros(1, 48, 2)
    with pytest.raises(ValueError, match="must divide"):
        chamfer_distances(a, b, block_size=10)


def sketch_case():
    rng = np.random.default_rng(12)
    n = 24
    proj = rng.normal(size=(B, K, n, 2)).astype(np.float32)
    gt = rng.normal(size=(B, K, n, 2)).astype(np.float32)
    gt[0, 1, :5] = 0.0  # zero points the sketch loss leaves out
    soft = rng.normal(size=(B, K, n, 2)).astype(np.float32)
    labels = rng.integers(-1, K, (B, n)).astype(np.int32)  # -1: no instance
    bb = rng.integers(0, 2, (B, n)).astype(np.int32)
    w_barrel = rng.uniform(0, 1, (B, n, K)).astype(np.float32)
    return proj, gt, soft, labels, bb, w_barrel


SKETCH_LOSSES = {
    "chamfer_loss": lambda m, c: m[0](c[0].reshape(B * K, -1, 2), c[1].reshape(B * K, -1, 2)),
    "chamfer_loss_forward": lambda m, c: m[0](c[0].reshape(B * K, -1, 2),
                                              c[1].reshape(B * K, -1, 2), False),
    "sketch_loss": lambda m, c: m[1].sketch_loss(c[0], c[1]),
    "sketch_loss_masked": lambda m, c: m[1].sketch_loss_masked(c[0], c[1], c[4], c[3]),
    "weighted_chamfer_loss": lambda m, c: m[1].weighted_chamfer_loss(c[0], c[1], c[2], c[5]),
    "chamfer_eval": lambda m, c: m[1].chamfer_eval(c[0], c[1]),
}


@pytest.mark.parametrize("name", list(SKETCH_LOSSES))
def test_sketch_losses_match_jax(name):
    """``chamfer_loss`` (both directions and forward only) and the four
    sketch losses within 1e-5 of JAX's."""
    case = sketch_case()
    want = SKETCH_LOSSES[name]((JC.chamfer_loss, JS), case)
    got = SKETCH_LOSSES[name]((chamfer_loss, TS), [torch.from_numpy(a) for a in case])
    want, got = (w if isinstance(w, tuple) else (w,) for w in (want, got))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=VALUE_ATOL)
