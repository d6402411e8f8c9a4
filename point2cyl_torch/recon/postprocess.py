"""Reconstruction post-processing.

Host-side equivalents of the reference's visualizer post-processors:
RANSAC sketch-scale re-estimation (``data_utils.py:2027-2150``), DBSCAN
extent clustering (``data_utils.py:2152-2247``), and KDTree neighborhood
label-consensus relabeling with DBSCAN outlier removal
(``visualizer.py:494-607``). The RANSAC loop is vectorized (all candidate
scales scored at once) instead of the reference's 1000-iteration python
loop; small-N post-processing stays on host by design (SURVEY.md N6).

The port's copy of the JAX package's ``recon/postprocess.py`` without
scikit-learn: ``dbscan_labels`` and ``knn_indices`` stand in for
``sklearn.cluster.DBSCAN`` and ``sklearn.neighbors.KDTree`` on scipy's
``cKDTree`` and give their labels and neighbour sets.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def dbscan_labels(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """``sklearn.cluster.DBSCAN(eps, min_samples).fit(points).labels_``.

    A point is core when at least ``min_samples`` points, itself
    included, lie within distance <= ``eps``. Clusters are numbered in the
    order of their lowest-index core point; each grows through the
    neighbourhoods of its core points, so a border point reachable from
    two clusters joins the one numbered first; the rest is noise (-1).
    """
    if min_samples < 1:
        raise ValueError(f"min_samples must be >= 1, got {min_samples}")
    points = np.asarray(points, np.float64).reshape(len(points), -1)
    neighbours = cKDTree(points).query_ball_point(points, eps)
    is_core = np.array([len(nb) >= min_samples for nb in neighbours], bool)
    labels = np.full(len(points), -1, np.int64)
    cluster = 0
    for seed in range(len(points)):
        if labels[seed] != -1 or not is_core[seed]:
            continue
        labels[seed] = cluster
        stack = [seed]
        while stack:
            for v in neighbours[stack.pop()]:
                if labels[v] == -1:
                    labels[v] = cluster
                    if is_core[v]:
                        stack.append(v)
        cluster += 1
    return labels


def knn_indices(points: np.ndarray, k: int) -> np.ndarray:
    """(N, k) indices of each point's ``k`` nearest points, nearest first,
    the point itself among them (``sklearn.neighbors.KDTree(points)
    .query(points, k)[1]``)."""
    if k > len(points):
        raise ValueError(f"k={k} neighbours of {len(points)} points")
    _, idx = cKDTree(points).query(points, k=k)
    return idx.reshape(len(points), k)


def scale_ransac_1d(
    projected: np.ndarray,
    rng: np.random.Generator,
    num_iterations: int = 1000,
    small_percent: float = 0.01,
    agreement_thresh: float = 0.8,
) -> float:
    """RANSAC max-norm scale for one projected 2D sketch
    (``data_utils.py:2115-2147``): draw small subsets, score each candidate
    scale by the fraction of points it covers, return the first candidate
    covering > 80% (in iteration order), else the last. Vectorized over all
    iterations.
    """
    n = projected.shape[0]
    m = max(int(small_percent * n), 1)
    norms = np.linalg.norm(projected, axis=-1)
    subsets = rng.integers(0, n, size=(num_iterations, m))
    cand = norms[subsets].max(axis=1)  # (I,)
    agreed = (norms[None, :] < cand[:, None]).mean(axis=1)
    hits = np.flatnonzero(agreed > agreement_thresh)
    return float(cand[hits[0]] if hits.size else cand[-1])


def scale_ransac(
    projected_sketches: np.ndarray,
    found_mask: np.ndarray,
    seed: int = 0,
) -> np.ndarray:
    """Batched wrapper: projected_sketches (B, K, S, 2), found (B, K).
    Returns (B, K) scales, 1.0 where not found."""
    rng = np.random.default_rng(seed)
    b, k = found_mask.shape
    scales = np.ones((b, k), np.float32)
    for bi in range(b):
        for ki in range(k):
            if found_mask[bi, ki]:
                scales[bi, ki] = scale_ransac_1d(
                    projected_sketches[bi, ki], rng
                )
    return scales


def extents_clustering_1d(
    dists: np.ndarray, eps: float = 0.05, min_fraction: float = 0.5
) -> tuple[float, float]:
    """DBSCAN the 1-D axis-projections and take min/max of the dominant
    cluster (``data_utils.py:2218-2242``), rejecting outlier points that
    inflate raw min/max extents."""
    labels = dbscan_labels(dists.reshape(-1, 1), eps, int(min_fraction * len(dists)))
    dominant = np.bincount(labels + 1).argmax() - 1
    sel = dists[labels == dominant]
    if sel.size == 0:
        sel = dists
    return float(sel.min()), float(sel.max())


def extents_clustering(
    points: np.ndarray,
    seg_label: np.ndarray,
    bb_labels: np.ndarray,
    axes: np.ndarray,
    centers: np.ndarray,
    num_samples: int = 1024,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched robust extents: sample barrel points per instance, project on
    the axis, cluster. points (B, N, 3); axes/centers (B, K, 3).
    Returns extents (B, K, 2), found (B, K)."""
    rng = np.random.default_rng(seed)
    b, k = axes.shape[:2]
    extents = np.zeros((b, k, 2), np.float32)
    found = np.zeros((b, k), bool)
    for bi in range(b):
        for ki in range(k):
            sel = np.flatnonzero(
                (seg_label[bi] == ki) & (bb_labels[bi] == 0)
            )
            if sel.size <= 1:
                continue
            idx = sel[rng.integers(0, sel.size, num_samples)]
            centered = points[bi, idx] - centers[bi, ki]
            dists = centered @ axes[bi, ki]
            extents[bi, ki] = extents_clustering_1d(dists)
            found[bi, ki] = True
    return extents, found


def consensus_relabel(
    points: np.ndarray,
    labels: np.ndarray,
    soft_probs: np.ndarray,
    n_instances: int,
    neighborhood_percent: float = 0.02,
    unconfident_thresh: float = 0.6,
    consensus_percent: float = 0.8,
    relabel_percent: float = 0.7,
    num_iterations: int = 10,
    dbscan_eps: float = 0.2,
    dbscan_min_samples: int = 20,
) -> np.ndarray:
    """Segmentation cleanup (``visualizer.py:494-607``):

    1. mask points whose max soft probability is below ``unconfident_thresh``
       as unknown;
    2. per instance, DBSCAN its points and unlabel noise + non-dominant
       spatial clusters (disconnected-component removal);
    3. iteratively relabel each point by the consensus of its
       ``neighborhood_percent`` nearest neighbors (unknowns take the
       neighborhood majority; confident disagreements need a
       ``relabel_percent`` majority to flip).

    Args: points (N, 3); labels (N,) int; soft_probs (N, K).
    Returns relabeled (N,) int.
    """
    n = points.shape[0]
    labels = labels.copy()
    unknown = n_instances  # sentinel label

    conf = soft_probs.max(axis=-1)
    labels[conf < unconfident_thresh] = unknown

    for i in range(n_instances):
        seg_idx = np.flatnonzero(labels == i)
        if seg_idx.size == 0:
            continue
        cl = dbscan_labels(points[seg_idx], dbscan_eps, dbscan_min_samples)
        labels[seg_idx[cl == -1]] = unknown
        n_clusters = len(set(cl)) - (1 if -1 in cl else 0)
        if n_clusters > 1:
            dominant = np.bincount(cl + 1).argmax() - 1
            labels[seg_idx[cl != dominant]] = unknown

    n_neighbors = max(int(n * neighborhood_percent), 2)
    nbrs = knn_indices(points, n_neighbors)
    consensus_threshold = n_neighbors * consensus_percent
    relabel_threshold = n_neighbors * relabel_percent

    for _ in range(num_iterations):
        neighbor_labels = labels[nbrs]  # (N, k)
        hist = np.apply_along_axis(
            lambda x: np.bincount(x, minlength=n_instances + 1),
            axis=-1,
            arr=neighbor_labels,
        )
        new_labels = labels.copy()
        for i in range(n):
            if labels[i] == unknown:
                best = int(np.argmax(hist[i]))
                if best == unknown:
                    best = int(np.argsort(hist[i])[-2])
                new_labels[i] = best
            elif hist[i][labels[i]] <= consensus_threshold:
                order = np.argsort(hist[i])[::-1]
                for cand in order:
                    if cand == unknown:
                        continue
                    if hist[i][cand] > relabel_threshold:
                        new_labels[i] = int(cand)
                        break
        labels = new_labels
    # any leftover unknowns take their neighborhood majority known label
    leftover = np.flatnonzero(labels == unknown)
    for i in leftover:
        counts = np.bincount(
            labels[nbrs[i]][labels[nbrs[i]] != unknown],
            minlength=n_instances,
        )
        labels[i] = int(np.argmax(counts)) if counts.sum() else 0
    return labels
