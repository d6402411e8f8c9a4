"""Port neighbour ops (point2cyl_torch.ops) against the JAX package.

Inputs come from numpy with fixed seeds and go through the port's plain
PyTorch versions (what its kernel wrappers run for CPU tensors) and their
JAX counterparts: the XLA functions and the Pallas kernels in interpret
mode. The CUDA kernels themselves run only on the card (chip_smoke.py
holds each one against these plain versions there).
"""

from __future__ import annotations

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.ops import _build, cuda_ballquery, cuda_fps, cuda_knn
from point2cyl_torch.ops.grouping import (ball_query_plain, sample_and_group,
                                          three_nn_interpolate_plain)
from point2cyl_torch.ops.sampling import farthest_point_sample_plain
from point2cyl_tpu.ops.grouping import ball_query as jax_ball_query
from point2cyl_tpu.ops.grouping import sample_and_group as jax_sample_and_group
from point2cyl_tpu.ops.grouping import three_nn_interpolate as jax_three_nn
from point2cyl_tpu.ops.pallas_ballquery import (ball_query_grouped_pallas,
                                                ball_query_pallas,
                                                sa_grouped_exact_pallas)
from point2cyl_tpu.ops.pallas_knn import three_nn_interpolate_pallas
from point2cyl_tpu.ops.sampling import farthest_point_sample as jax_fps


def _sphere(rng, shape):
    pts = rng.normal(size=shape).astype(np.float32)
    return pts / np.linalg.norm(pts, axis=-1, keepdims=True)


@pytest.mark.parametrize("b,n,npoint", [(3, 96, 32), (2, 1024, 128)])
def test_fps_plain_matches_jax_indices(b, n, npoint):
    """Indices equal (bitwise), start_idx=0 as in serving."""
    pts = np.random.default_rng(1).normal(size=(b, n, 3)).astype(np.float32)
    got = farthest_point_sample_plain(torch.from_numpy(pts), npoint, 0)
    want = np.asarray(jax_fps(jnp.asarray(pts), npoint, start_idx=0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_plain_per_row_start():
    pts = np.random.default_rng(2).normal(size=(2, 64, 3)).astype(np.float32)
    got = farthest_point_sample_plain(torch.from_numpy(pts), 8,
                                      torch.tensor([5, 17]))
    for row, start in enumerate((5, 17)):
        want = np.asarray(jax_fps(jnp.asarray(pts[row:row + 1]), 8,
                                  start_idx=start))
        np.testing.assert_array_equal(got[row:row + 1].numpy(), want)


def test_ball_query_plain_matches_pallas_exact_path():
    """N=512 takes the Pallas exact path: indices equal."""
    rng = np.random.default_rng(3)
    pts = _sphere(rng, (2, 512, 3))
    q = pts[:, :64]
    want = np.asarray(ball_query_pallas(0.4, 16, jnp.asarray(pts), jnp.asarray(q),
                                        tile_q=64, interpret=True))
    got = ball_query_plain(0.4, 16, torch.from_numpy(pts), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("radius", [0.05, 0.2, 0.6])
def test_ball_query_plain_matches_xla(radius):
    """Against the XLA expansion-distance path on a seed where no pair sits
    within float error of the radius (checked here), so both sides agree."""
    rng = np.random.default_rng(7)
    pts = _sphere(rng, (2, 256, 3))
    q = pts[:, :32]
    d = np.sum((q[:, :, None].astype(np.float64) - pts[:, None]) ** 2, -1)
    assert np.min(np.abs(d - radius * radius)) > 1e-5
    want = np.asarray(jax_ball_query(radius, 16, jnp.asarray(pts), jnp.asarray(q)))
    got = ball_query_plain(radius, 16, torch.from_numpy(pts), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [0, 8])
def test_sample_and_group_plain_matches_xla(width):
    """Centres and grouped [xyz - centre | feats] equal the XLA
    sample_and_group bit for bit (both gather by copying), on a seed with
    no pair within float error of the radius."""
    rng = np.random.default_rng(11)
    pts = _sphere(rng, (2, 256, 3))
    feats = rng.normal(size=(2, 256, width)).astype(np.float32) if width else None
    fps_idx = rng.choice(256, size=(2, 32)).astype(np.int32)
    q = np.take_along_axis(pts, fps_idx[..., None].astype(np.int64), axis=1)
    d = np.sum((q[:, :, None].astype(np.float64) - pts[:, None]) ** 2, -1)
    assert np.min(np.abs(d - 0.3 * 0.3)) > 1e-5
    want = jax_sample_and_group(32, 0.3, 16, jnp.asarray(pts),
                                None if feats is None else jnp.asarray(feats),
                                jnp.asarray(fps_idx))
    got = sample_and_group(0.3, 16, torch.from_numpy(pts),
                           None if feats is None else torch.from_numpy(feats),
                           torch.from_numpy(fps_idx))
    assert got[1].shape == (2, 32, 16, 3 + width)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ball_query_grouped_plain_matches_pallas():
    """SA1 layout at N=2048 with oversample=nsample, where JAX's blocked
    path equals exact selection: indices equal, coords within 1e-5 (JAX
    gathers through bf16 hi/lo one-hot matmuls; the port copies)."""
    rng = np.random.default_rng(4)
    pts = _sphere(rng, (2, 2048, 3))
    q = pts[:, :128]
    idx_j, g_j = ball_query_grouped_pallas(0.4, 32, jnp.asarray(pts), jnp.asarray(q),
                                           tile_q=32, interpret=True, oversample=32)
    idx, g = cuda_ballquery.ball_query_grouped(0.4, 32, torch.from_numpy(pts),
                                               torch.from_numpy(q))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=1e-5, rtol=0)
    # the port's gather is exact
    want = np.stack([pts[b][idx.numpy()[b]] for b in range(2)]) - q[:, :, None]
    np.testing.assert_array_equal(g.numpy(), want)


def test_sa_grouped_exact_plain_matches_pallas():
    """SA2 layout [xyz - centre | feats]: indices equal, values within 1e-4
    (the JAX test's own bound for its one-hot gather)."""
    rng = np.random.default_rng(5)
    pts = _sphere(rng, (2, 512, 3))
    feats = rng.normal(size=(2, 512, 16)).astype(np.float32)
    q = pts[:, :64]
    idx_j, g_j = sa_grouped_exact_pallas(0.4, 32, jnp.asarray(pts), jnp.asarray(feats),
                                         jnp.asarray(q), tile_q=32, interpret=True)
    idx, g = cuda_ballquery.sa_grouped_exact(0.4, 32, torch.from_numpy(pts),
                                             torch.from_numpy(feats),
                                             torch.from_numpy(q))
    assert g.shape == (2, 64, 32, 19)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=1e-4, rtol=0)


def test_ball_query_short_rows_pad_with_first():
    """A query with fewer in-radius points than nsample repeats its first
    (smallest) in-radius index; a query with none gives N-1."""
    pts = np.zeros((1, 8, 3), np.float32)
    pts[0, :, 0] = np.arange(8, dtype=np.float32)
    q = np.array([[[3.0, 0.0, 0.0], [100.0, 0.0, 0.0]]], np.float32)
    idx = ball_query_plain(1.0, 4, torch.from_numpy(pts), torch.from_numpy(q))
    np.testing.assert_array_equal(idx.numpy()[0], [[2, 3, 4, 2], [7, 7, 7, 7]])


def _three_nn_oracle(dst, src, feats):
    out = np.zeros(dst.shape[:2] + (feats.shape[-1],), np.float64)
    for b in range(dst.shape[0]):
        for i, q in enumerate(dst[b]):
            d = np.sum((src[b] - q) ** 2, axis=1)
            order = np.argsort(d, kind="stable")[:3]
            w = 1.0 / (d[order] + 1e-8)
            out[b, i] = (w[:, None] * feats[b][order]).sum(0) / w.sum()
    return out


def test_three_nn_plain_matches_numpy_oracle():
    """Exact distances and sequential-argmin tie order; self points (src a
    subset of dst) recover their source feature."""
    rng = np.random.default_rng(6)
    src = rng.normal(size=(2, 16, 3)).astype(np.float32)
    dst = np.concatenate([src, rng.normal(size=(2, 48, 3)).astype(np.float32)], 1)
    feats = rng.normal(size=(2, 16, 8)).astype(np.float32)
    got = three_nn_interpolate_plain(*map(torch.from_numpy, (dst, src, feats)))
    np.testing.assert_allclose(got.numpy(), _three_nn_oracle(dst, src, feats),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[:, :16], feats, atol=1e-5, rtol=0)


def test_three_nn_plain_matches_pallas():
    """Within 2e-3: the Pallas kernel quantises its distances (index packed
    into the low mantissa bits), the port does not."""
    rng = np.random.default_rng(8)
    src = rng.normal(size=(2, 16, 3)).astype(np.float32)
    dst = np.concatenate([src, rng.normal(size=(2, 48, 3)).astype(np.float32)], 1)
    feats = rng.normal(size=(2, 16, 8)).astype(np.float32)
    want = np.asarray(three_nn_interpolate_pallas(
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(feats), 1e-8, 8, True))
    got = cuda_knn.three_nn_interpolate(*map(torch.from_numpy, (dst, src, feats)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)


def test_three_nn_plain_matches_xla():
    """Against the XLA path (approx=False) on points that do not coincide,
    so its expansion-form distances carry no cancellation: rtol 1e-4."""
    rng = np.random.default_rng(9)
    src = rng.normal(size=(2, 32, 3)).astype(np.float32)
    dst = rng.normal(size=(2, 64, 3)).astype(np.float32)
    feats = rng.uniform(1.0, 2.0, size=(2, 32, 16)).astype(np.float32)
    want = np.asarray(jax_three_nn(jnp.asarray(dst), jnp.asarray(src),
                                   jnp.asarray(feats), approx=False))
    got = three_nn_interpolate_plain(*map(torch.from_numpy, (dst, src, feats)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0)


def test_three_nn_exact_ties():
    """Two coincident sources at distance 0 are both taken with full 1/eps
    weight; the third is the true next-nearest."""
    src = np.zeros((1, 8, 3), np.float32)
    src[0, :, 0] = [0.0, 0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
    feats = np.arange(8, dtype=np.float32).reshape(1, 8, 1)
    dst = np.zeros((1, 8, 3), np.float32)
    got = three_nn_interpolate_plain(*map(torch.from_numpy, (dst, src, feats)))
    w = np.array([1e8, 1e8, 4.0])
    want = (w * np.array([0.0, 1.0, 2.0])).sum() / w.sum()
    np.testing.assert_allclose(got.numpy()[0, :, 0], want, atol=1e-5, rtol=0)


def test_wrappers_route_cpu_tensors_to_plain(monkeypatch):
    """CPU tensors take the plain versions: the kernel build is never
    touched and no launch is counted."""
    def no_build(*args, **kwargs):
        raise AssertionError("the kernel library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "function", no_build)
    counters = (cuda_fps.farthest_point_sample_kernel,
                cuda_ballquery.ball_query_grouped_kernel,
                cuda_ballquery.sa_grouped_exact_kernel,
                cuda_knn.three_nn_interpolate_kernel)
    before = [fn.launches for fn in counters]
    rng = np.random.default_rng(10)
    pts = torch.from_numpy(_sphere(rng, (2, 128, 3)))
    feats = torch.from_numpy(rng.normal(size=(2, 128, 4)).astype(np.float32))
    idx = cuda_fps.farthest_point_sample(pts, 16)
    np.testing.assert_array_equal(idx.numpy(),
                                  farthest_point_sample_plain(pts, 16).numpy())
    q = pts[:, :16].contiguous()
    cuda_ballquery.ball_query_grouped(0.4, 8, pts, q)
    cuda_ballquery.sa_grouped_exact(0.4, 8, pts, feats, q)
    cuda_knn.three_nn_interpolate(pts, q, feats[:, :16].contiguous())
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("launch", [
    lambda t: cuda_fps.farthest_point_sample_kernel(t, 4),
    lambda t: cuda_ballquery.ball_query_grouped_kernel(0.4, 4, t, t[:, :4]),
    lambda t: cuda_ballquery.sa_grouped_exact_kernel(0.4, 4, t, t, t[:, :4]),
    lambda t: cuda_knn.three_nn_interpolate_kernel(t, t[:, :4], t[:, :4]),
])
def test_kernel_launchers_reject_cpu_tensors(launch, monkeypatch):
    """Asked for the kernel with a CPU tensor, a launcher raises before it
    builds anything: there is no silent plain route."""
    def no_build(*args, **kwargs):
        raise AssertionError("the kernel library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.zeros(1, 16, 3))


def test_port_imports_no_jax():
    """Importing every point2cyl_torch module pulls in no JAX, flax or
    point2cyl_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import point2cyl_torch\n"
        "for m in pkgutil.walk_packages(point2cyl_torch.__path__, 'point2cyl_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'point2cyl_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('point2cyl_torch')]))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20
