"""The port's reconstruction post-processing (point2cyl_torch.recon.postprocess)
against the JAX package's, which runs scikit-learn's DBSCAN and KDTree.

The port's DBSCAN and nearest-neighbour query are scipy's cKDTree; the
post-processors choose a dominant cluster by ``np.bincount(labels +
1).argmax()``, where the lowest label wins a tie, so the labels must be
sklearn's exactly: the numbering of clusters, the cluster a border point
joins, noise. Inputs come from numpy seeds checked to hold no pair of
points within 1e-6 of a DBSCAN radius.
"""

from __future__ import annotations

import numpy as np
import pytest
from sklearn.cluster import DBSCAN
from sklearn.neighbors import KDTree

from point2cyl_torch.recon import postprocess as TP
from point2cyl_tpu.recon import postprocess as JP


def no_pair_at(points: np.ndarray, eps: float) -> None:
    pts = np.asarray(points, np.float64).reshape(len(points), -1)
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    assert np.abs(d - eps).min() > 1e-6, "a pair sits at the radius"


def sklearn_labels(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    return DBSCAN(eps=eps, min_samples=min_samples).fit(
        np.asarray(points).reshape(len(points), -1)).labels_


def blobs(seed: int, n: int = 300) -> np.ndarray:
    """Three blobs of unequal spread in 3D and a sprinkle of far points."""
    rng = np.random.default_rng(seed)
    parts = [rng.normal(size=(n // 3, 3)) * s + c for s, c in
             ((0.08, [1, 0, 0]), (0.12, [-1, 0, 0]), (0.3, [0, 1.5, 0]))]
    parts.append(rng.uniform(-3, 3, (n // 20, 3)))
    pts = np.concatenate(parts).astype(np.float32)
    return pts[rng.permutation(len(pts))]


# the cases: (points, eps, min_samples)
CASES = {
    # two equal clusters, the second first in index order: cluster 0 is it
    "tie": (np.concatenate([np.linspace(1.0, 1.04, 10), np.linspace(0.0, 0.04, 10)]),
            0.05, 10),
    # a border point (index 0) within eps of a core point of each cluster;
    # the cluster on the right comes first in index order, so it takes it
    "border": (np.array([0.215, 0.34, 0.37, 0.40, 0.43, 0.0, 0.03, 0.06, 0.09, 5.0]),
               0.13, 4),
    "noise": (blobs(3), 0.2, 20),
    "dense": (blobs(4), 0.35, 8),
    "1d": (np.random.default_rng(5).normal(size=400).astype(np.float32), 0.05, 30),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dbscan_labels_are_sklearns(case):
    pts, eps, min_samples = CASES[case]
    no_pair_at(pts, eps)
    want = sklearn_labels(pts, eps, min_samples)
    got = TP.dbscan_labels(np.asarray(pts).reshape(len(pts), -1), eps, min_samples)
    np.testing.assert_array_equal(got, want)
    if case == "tie":
        assert list(np.bincount(want + 1)) == [0, 10, 10]
        assert (want[:10] == 0).all()
    if case == "border":
        assert want[0] == 0 and (want[5:9] == 1).all() and want[-1] == -1
    if case == "noise":
        assert (want == -1).any() and want.max() >= 1


def test_dbscan_rejects_min_samples_below_one():
    with pytest.raises(ValueError, match="min_samples"):
        TP.dbscan_labels(np.zeros((3, 1)), 0.1, 0)


@pytest.mark.parametrize("k", [2, 8, 40])
def test_knn_indices_are_kdtrees(k):
    pts = blobs(6, 240)
    want = KDTree(pts).query(pts, k=k)[1]
    got = TP.knn_indices(pts, k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], np.arange(len(pts)))


def test_extents_clustering_1d_matches_jax_on_a_tie():
    """The two clusters are equal; the lowest label, the one first in index
    order, is dominant on both sides."""
    d = CASES["tie"][0].astype(np.float32)
    got = TP.extents_clustering_1d(d, eps=0.05)
    assert got == JP.extents_clustering_1d(d, eps=0.05)
    assert got == (float(d[:10].min()), float(d[:10].max()))


def test_scale_ransac_matches_jax():
    rng = np.random.default_rng(8)
    sk = rng.normal(size=(2, 3, 256, 2)).astype(np.float32)
    sk[0, 1, :12] *= 6.0  # outliers
    found = np.array([[True, True, False], [True, False, True]])
    got = TP.scale_ransac(sk, found, seed=3)
    want = JP.scale_ransac(sk, found, seed=3)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_extents_clustering_matches_jax():
    """Barrel points of four instances: instance 0's lie on its axis
    within 0.04 (one DBSCAN cluster) but for a far group (noise),
    instances 1 and 2 are spread (all noise: the raw min and max), and
    instance 3 has one point (not found)."""
    rng = np.random.default_rng(9)
    n, k = 600, 4
    pts = rng.uniform(-0.5, 0.5, (1, n, 3)).astype(np.float32)
    seg = rng.integers(0, 3, (1, n)).astype(np.int32)
    bb = (rng.uniform(size=(1, n)) < 0.2).astype(np.int32)
    seg[0, :1], bb[0, :1] = 3, 0
    axes = rng.normal(size=(1, k, 3)).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    centers = rng.uniform(-0.1, 0.1, (1, k, 3)).astype(np.float32)
    on = np.flatnonzero((seg[0] == 0) & (bb[0] == 0))
    t = rng.uniform(-0.02, 0.02, len(on))
    t[:len(on) // 20] = 0.5
    pts[0, on] = centers[0, 0] + t[:, None] * axes[0, 0]
    args = (pts, seg, bb, axes, centers)
    got_e, got_f = TP.extents_clustering(*args, seed=2)
    want_e, want_f = JP.extents_clustering(*args, seed=2)
    np.testing.assert_array_equal(got_e, want_e)
    np.testing.assert_array_equal(got_f, want_f)
    assert list(got_f[0]) == [True, True, True, False]
    assert got_e[0, 0, 1] < 0.03  # the far group dropped


@pytest.mark.parametrize("seed", [2, 3])
def test_consensus_relabel_matches_jax(seed):
    """Three blobs with 10% label noise, unconfident points (unknowns) and
    far points that DBSCAN calls noise; labels equal."""
    rng = np.random.default_rng(seed)
    pts = blobs(seed, 360)
    n = len(pts)
    true = np.argmin(((pts[:, None, :2] - np.array([[1, 0], [-1, 0], [0, 1.5]])[None])
                      ** 2).sum(-1), axis=1)
    noisy = true.copy()
    flip = rng.choice(n, n // 10, replace=False)
    noisy[flip] = rng.integers(0, 3, len(flip))
    probs = rng.dirichlet(np.ones(3), n) * 0.3 + np.eye(3)[noisy] * 0.7
    probs[rng.choice(n, n // 8, replace=False)] = 1.0 / 3
    no_pair_at(pts, 0.2)
    got = TP.consensus_relabel(pts, noisy, probs, 3)
    want = JP.consensus_relabel(pts, noisy, probs, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != noisy).any()
