"""Gradients through the port's kernel Functions (point2cyl_torch.ops)
against the JAX package's custom VJPs.

Inputs come from numpy with fixed seeds. On the CPU each autograd Function
runs its plain forward and its plain backward (the explicit scatters of
``ops/grouping.py``); the JAX side runs its Pallas kernels in interpret
mode, as ``tests/test_pallas_kernels.py`` does. The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``.

Tolerances: where JAX's kernel scatters through bf16 hi/lo one-hot
matmuls the port is held within 2e-4 (the bound JAX's own tests hold
that kernel to against its XLA gather); the port's Functions against
autograd of its own plain forward agree to float32 summation order
(1e-5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.ops import _build, cuda_ballquery, cuda_knn
from point2cyl_torch.ops.grouping import (ball_query_plain, group_scatter_plain,
                                          three_nn_backward_plain,
                                          three_nn_interpolate_plain,
                                          three_nn_weights_plain)
from point2cyl_tpu.ops.grouping import three_nn_interpolate as jax_three_nn
from point2cyl_tpu.ops.pallas_ballquery import (ball_query_grouped, ball_query_pallas,
                                                sa_grouped_exact)
from point2cyl_tpu.ops.pallas_knn import three_nn_interpolate_pallas


def _sphere(rng, shape):
    pts = rng.normal(size=shape).astype(np.float32)
    return pts / np.linalg.norm(pts, axis=-1, keepdims=True)


def _leaf(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy()).requires_grad_()


def test_ball_query_plain_equals_pallas_idx_kernel():
    """Item 2 at N <= 1024 (the exact path of ``_ballquery_kernel``): the
    plain version and the wrapper's CPU route equal it index for index."""
    rng = np.random.default_rng(31)
    pts = _sphere(rng, (3, 512, 3))
    q = pts[:, :128].copy()
    want = np.asarray(ball_query_pallas(0.2, 32, jnp.asarray(pts), jnp.asarray(q),
                                        tile_q=64, interpret=True))
    got = ball_query_plain(0.2, 32, torch.from_numpy(pts), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    routed = cuda_ballquery.ball_query(0.2, 32, torch.from_numpy(pts), torch.from_numpy(q))
    np.testing.assert_array_equal(routed.numpy(), want)


def test_sa1_scatter_plain_matches_pallas_vjp():
    """Item 4 on JAX's own indices: JAX's N > 1024 selection is blocked and
    not the port's, so the port's plain scatter takes the indices JAX's
    forward picked, and must give JAX's custom-VJP cotangents."""
    rng = np.random.default_rng(32)
    b, n, s, ns = 2, 2048, 64, 32
    pts = _sphere(rng, (b, n, 3))
    q = pts[:, :s].copy()
    w = rng.normal(size=(b, s, ns, 3)).astype(np.float32)
    pts_j, q_j, w_j = map(jnp.asarray, (pts, q, w))
    idx, _ = ball_query_grouped(0.4, ns, pts_j, q_j, 32, True)

    def loss(xyz, ctr):
        _, g = ball_query_grouped(0.4, ns, xyz, ctr, 32, True)
        return jnp.sum(g * w_j)

    d_xyz, d_ctr = jax.grad(loss, argnums=(0, 1))(pts_j, q_j)
    got = group_scatter_plain(torch.from_numpy(np.asarray(idx).copy()), torch.from_numpy(w), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(d_xyz), atol=2e-4, rtol=0)
    np.testing.assert_allclose(-w.sum(axis=2), np.asarray(d_ctr), atol=2e-4, rtol=0)


def test_ball_query_grouped_function_matches_autograd_of_plain():
    """BallQueryGrouped's explicit backward equals autograd through the
    plain gather, for the cloud and the centres."""
    rng = np.random.default_rng(33)
    pts = _sphere(rng, (2, 1536, 3))
    q = pts[:, :48].copy()
    w = torch.from_numpy(rng.normal(size=(2, 48, 16, 3)).astype(np.float32))
    x1, c1 = _leaf(pts), _leaf(q)
    idx, g1 = cuda_ballquery.ball_query_grouped(0.3, 16, x1, c1)
    (g1 * w).sum().backward()
    x2, c2 = _leaf(pts), _leaf(q)
    idx2, g2 = cuda_ballquery.ball_query_grouped_plain(0.3, 16, x2, c2)
    (g2 * w).sum().backward()
    assert not idx.requires_grad
    torch.testing.assert_close(idx, idx2, rtol=0, atol=0)
    torch.testing.assert_close(g1, g2, rtol=0, atol=0)
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c1.grad, c2.grad, rtol=1e-5, atol=1e-5)


def test_sa_grouped_exact_function_matches_pallas_vjp():
    """Item 6: SAGroupedExact on the CPU (plain forward and scatter) gives
    JAX's custom-VJP cotangents for the cloud, the features and the
    centres; at N=512 both sides select exactly, so the indices agree."""
    rng = np.random.default_rng(34)
    b, n, s, ns, c = 2, 512, 64, 32, 16
    pts = _sphere(rng, (b, n, 3))
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    q = pts[:, :s].copy()
    w = rng.normal(size=(b, s, ns, 3 + c)).astype(np.float32)
    pts_j, f_j, q_j, w_j = map(jnp.asarray, (pts, feats, q, w))

    def loss(xyz, f, ctr):
        _, g = sa_grouped_exact(0.4, ns, xyz, f, ctr, 32, 16, True)
        return jnp.sum(g * w_j)

    want = jax.grad(loss, argnums=(0, 1, 2))(pts_j, f_j, q_j)
    idx_j, _ = sa_grouped_exact(0.4, ns, pts_j, f_j, q_j, 32, 16, True)
    xt, ft, qt = _leaf(pts), _leaf(feats), _leaf(q)
    idx, g = cuda_ballquery.sa_grouped_exact(0.4, ns, xt, ft, qt)
    (g * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    for got, ref in zip((xt.grad, ft.grad, qt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=0)


def test_sa_grouped_exact_function_matches_autograd_of_plain():
    rng = np.random.default_rng(35)
    pts = _sphere(rng, (2, 256, 3))
    feats = rng.normal(size=(2, 256, 8)).astype(np.float32)
    q = pts[:, :32].copy()
    w = torch.from_numpy(rng.normal(size=(2, 32, 16, 11)).astype(np.float32))
    leaves1 = (_leaf(pts), _leaf(feats), _leaf(q))
    (cuda_ballquery.sa_grouped_exact(0.4, 16, *leaves1)[1] * w).sum().backward()
    leaves2 = (_leaf(pts), _leaf(feats), _leaf(q))
    (cuda_ballquery.sa_grouped_exact_plain(0.4, 16, *leaves2)[1] * w).sum().backward()
    for a, b in zip(leaves1, leaves2):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def test_sa_grouped_exact_function_feats_only():
    """With only the features needing a gradient (SA2 in a train step),
    the backward gives d_feats and leaves the coordinates alone."""
    rng = np.random.default_rng(36)
    pts = torch.from_numpy(_sphere(rng, (1, 128, 3)))
    feats = _leaf(rng.normal(size=(1, 128, 4)).astype(np.float32))
    _, g = cuda_ballquery.sa_grouped_exact(0.5, 8, pts, feats, pts[:, :16])
    g.sum().backward()
    assert pts.grad is None and feats.grad is not None
    assert feats.grad.abs().sum() > 0


@pytest.mark.parametrize("b,n,s,c", [(2, 64, 16, 8), (2, 256, 32, 16)])
def test_three_nn_function_matches_pallas_vjp(b, n, s, c):
    """Item 8: ThreeNNInterpolate's ``W^T g`` on the CPU against JAX's
    custom VJP (interpret mode) and against jax.grad of the XLA path.
    The Pallas kernel quantises distances (weights off by up to 2^-13
    relative), so against it 1e-3 relative and 2e-3 absolute; against XLA,
    which weights exact distances as the port does, 1e-4."""
    rng = np.random.default_rng(37 + n)
    src = rng.normal(size=(b, s, 3)).astype(np.float32)
    dst = rng.normal(size=(b, n, 3)).astype(np.float32)
    feats = rng.normal(size=(b, s, c)).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(three_nn_interpolate_pallas(
        jnp.asarray(dst), jnp.asarray(src), f, 1e-8, 8, True) ** 2))(jnp.asarray(feats))
    want_xla = jax.grad(lambda f: jnp.sum(jax_three_nn(
        jnp.asarray(dst), jnp.asarray(src), f) ** 2))(jnp.asarray(feats))
    ft = _leaf(feats)
    (cuda_knn.three_nn_interpolate(torch.from_numpy(dst), torch.from_numpy(src), ft)
     ** 2).sum().backward()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_xla), atol=1e-4, rtol=1e-4)


def test_three_nn_function_cat_slice_cotangent_matches_pallas_vjp():
    """Item 8 as FP2 runs it: the interpolated features are concatenated
    after the destination's own, so ThreeNNInterpolate's cotangent is a
    slice of the concatenation's gradient (not contiguous, row stride
    C_dst + C). Its ``W^T g`` equals JAX's custom VJP (interpret mode) of
    the same concatenation, to the tolerances of the test above, and
    autograd of the plain version to float32 summation order."""
    rng = np.random.default_rng(41)
    b, n, s, c_dst, c = 2, 96, 24, 8, 12
    src = rng.normal(size=(b, s, 3)).astype(np.float32)
    dst = rng.normal(size=(b, n, 3)).astype(np.float32)
    feats = rng.normal(size=(b, s, c)).astype(np.float32)
    own = rng.normal(size=(b, n, c_dst)).astype(np.float32)
    cot = rng.normal(size=(b, n, c_dst + c)).astype(np.float32)

    def jax_loss(f):
        out = three_nn_interpolate_pallas(jnp.asarray(dst), jnp.asarray(src), f, 1e-8, 8,
                                          True)
        return jnp.sum(jnp.concatenate([jnp.asarray(own), out], -1) * jnp.asarray(cot))

    want = jax.grad(jax_loss)(jnp.asarray(feats))
    seen = []
    ft, fp = _leaf(feats), _leaf(feats)
    out = cuda_knn.three_nn_interpolate(torch.from_numpy(dst), torch.from_numpy(src), ft)
    out.register_hook(lambda g: seen.append(g) or g)
    torch.cat([torch.from_numpy(own), out], -1).mul(torch.from_numpy(cot)).sum().backward()
    plain = three_nn_interpolate_plain(torch.from_numpy(dst), torch.from_numpy(src), fp)
    torch.cat([torch.from_numpy(own), plain], -1).mul(torch.from_numpy(cot)).sum().backward()
    assert not seen[0].is_contiguous() and seen[0].stride(1) == c_dst + c
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want), atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(ft.grad, fp.grad, rtol=1e-5, atol=1e-6)


def test_three_nn_function_matches_autograd_of_plain():
    rng = np.random.default_rng(38)
    src = torch.from_numpy(rng.normal(size=(2, 24, 3)).astype(np.float32))
    dst = torch.from_numpy(rng.normal(size=(2, 96, 3)).astype(np.float32))
    feats = rng.normal(size=(2, 24, 5)).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(2, 96, 5)).astype(np.float32))
    f1, f2 = _leaf(feats), _leaf(feats)
    out1 = cuda_knn.three_nn_interpolate(dst, src, f1)
    out2 = three_nn_interpolate_plain(dst, src, f2)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)
    (out1 * g).sum().backward()
    (out2 * g).sum().backward()
    torch.testing.assert_close(f1.grad, f2.grad, rtol=1e-5, atol=1e-6)


def test_three_nn_backward_plain_is_transpose_of_weights():
    """``three_nn_backward_plain`` is W^T g for the dense (N, S) weight
    matrix the 3 nearest sources span."""
    rng = np.random.default_rng(39)
    src = torch.from_numpy(rng.normal(size=(1, 10, 3)).astype(np.float32))
    dst = torch.from_numpy(rng.normal(size=(1, 40, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1, 40, 6)).astype(np.float32))
    idx, w = three_nn_weights_plain(dst, src)
    dense = torch.zeros(40, 10).scatter_add_(1, idx[0], w[0])
    torch.testing.assert_close(three_nn_backward_plain(idx, w, g, 10)[0], dense.t() @ g[0],
                               rtol=1e-5, atol=1e-6)


def test_functions_save_nothing_under_inference_mode(monkeypatch):
    """A serving forward under inference_mode launches no backward, keeps
    no weights and carries no graph; CPU tensors never reach the build."""
    def no_build(*args, **kwargs):
        raise AssertionError("the kernel library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "function", no_build)
    rng = np.random.default_rng(40)
    pts = torch.from_numpy(_sphere(rng, (1, 2048, 3)))
    feats = torch.from_numpy(rng.normal(size=(1, 2048, 4)).astype(np.float32))
    with torch.inference_mode():
        _, g1 = cuda_ballquery.ball_query_grouped(0.3, 8, pts, pts[:, :16])
        _, g2 = cuda_ballquery.sa_grouped_exact(0.3, 8, pts, feats, pts[:, :16])
        out = cuda_knn.three_nn_interpolate(pts, pts[:, :16], feats[:, :16])
    assert all(t.grad_fn is None for t in (g1, g2, out))


@pytest.mark.parametrize("launch", [
    lambda t: cuda_ballquery.ball_query_kernel(0.4, 4, t, t[:, :4]),
    lambda t: cuda_ballquery.ball_query_grouped_backward_kernel(
        torch.zeros(1, 4, 4, dtype=torch.int32), torch.zeros(1, 4, 4, 3), 16),
    lambda t: cuda_ballquery.sa_grouped_backward_kernel(
        torch.zeros(1, 4, 4, dtype=torch.int32), torch.zeros(1, 4, 4, 7), 16),
    lambda t: cuda_knn.three_nn_backward_kernel(
        torch.zeros(1, 16, 3, dtype=torch.int32), torch.zeros(1, 16, 3), t, 4),
])
def test_training_kernel_launchers_reject_cpu_tensors(launch, monkeypatch):
    """Asked for a training kernel with CPU tensors, a launcher raises
    before it builds anything."""
    def no_build(*args, **kwargs):
        raise AssertionError("the kernel library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.zeros(1, 16, 3))
