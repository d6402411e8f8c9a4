"""Pure-numpy mesh utilities.

Replaces the trimesh dependency of the reference's offline preprocessing
(``utils.py:11,204,270,514-515,881``): vertex welding, face areas/adjacency,
connected components, area-weighted surface sampling, and
closest-point-on-surface queries. The port's copy of the JAX package's
``data/meshutil.py``.
"""

from __future__ import annotations

import numpy as np


def merge_vertices(
    vertices: np.ndarray, faces: np.ndarray, decimals: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """Weld duplicate vertices (trimesh.Trimesh does this on construction,
    which the reference relies on for adjacency, ``utils.py:452-454``)."""
    quant = np.round(vertices * 10**decimals).astype(np.int64)
    _, first, inverse = np.unique(
        quant, axis=0, return_index=True, return_inverse=True
    )
    return vertices[first], inverse[faces]


def face_areas(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    tri = vertices[faces]
    return 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1
    )


def face_adjacency(faces: np.ndarray) -> np.ndarray:
    """(E, 2) pairs of face indices sharing an edge
    (trimesh.graph.face_adjacency equivalent)."""
    f = np.asarray(faces)
    edges = np.concatenate(
        [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0
    )
    edges = np.sort(edges, axis=1)
    face_idx = np.tile(np.arange(len(f)), 3)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    edges = edges[order]
    face_idx = face_idx[order]
    same = (edges[1:] == edges[:-1]).all(axis=1)
    return np.stack([face_idx[:-1][same], face_idx[1:][same]], axis=1)


def connected_component_labels(edges: np.ndarray, node_count: int) -> np.ndarray:
    """Union-find component labels, 0-based contiguous
    (trimesh.graph.connected_component_labels equivalent)."""
    parent = np.arange(node_count)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in np.asarray(edges).reshape(-1, 2):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    roots = np.array([find(i) for i in range(node_count)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def sample_surface(
    vertices: np.ndarray,
    faces: np.ndarray,
    num_points: int,
    rng: np.random.Generator,
    even: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Area-weighted uniform surface sampling
    (trimesh.sample.sample_surface[_even] equivalent).

    ``even=True`` approximates blue-noise spacing by oversampling 4x and
    greedily thinning with a farthest-point pass.

    Returns (points (num_points, 3), face_indices (num_points,)).
    """
    areas = face_areas(vertices, faces)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero surface area")
    n_draw = num_points * 4 if even else num_points
    probs = areas / total
    fidx = rng.choice(len(faces), size=n_draw, p=probs)
    u = rng.uniform(size=(n_draw, 1))
    v = rng.uniform(size=(n_draw, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    tri = vertices[faces[fidx]]
    pts = tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (tri[:, 2] - tri[:, 0])
    if not even:
        return pts, fidx
    # farthest-point thinning to num_points
    chosen = np.zeros(num_points, dtype=np.int64)
    dist = np.full(n_draw, np.inf)
    cur = 0
    for i in range(num_points):
        chosen[i] = cur
        d = np.sum((pts - pts[cur]) ** 2, axis=-1)
        dist = np.minimum(dist, d)
        cur = int(np.argmax(dist))
    return pts[chosen], fidx[chosen]


def closest_point_on_triangles(
    points: np.ndarray, tri: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Closest point on each triangle for each query point.

    Args: points (P, 3); tri (T, 3, 3).
    Returns (closest (P, T, 3), sq_dist (P, T)). Vectorized
    Ericson-style closest-point-on-triangle.
    """
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab = b - a
    ac = c - a
    p = points[:, None, :]  # (P, 1, 3)
    ap = p - a
    d1 = np.einsum("td,ptd->pt", ab, ap)
    d2 = np.einsum("td,ptd->pt", ac, ap)
    bp = p - b
    d3 = np.einsum("td,ptd->pt", ab, bp)
    d4 = np.einsum("td,ptd->pt", ac, bp)
    cp = p - c
    d5 = np.einsum("td,ptd->pt", ab, cp)
    d6 = np.einsum("td,ptd->pt", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    denom = np.where(np.abs(denom) < 1e-30, 1e-30, denom)
    v = vb / denom
    w = vc / denom
    # interior candidate
    closest = a + v[..., None] * ab + w[..., None] * ac
    # edge/vertex regions
    t_ab = np.clip(d1 / np.where(d1 - d3 == 0, 1e-30, d1 - d3), 0, 1)
    t_ac = np.clip(d2 / np.where(d2 - d6 == 0, 1e-30, d2 - d6), 0, 1)
    t_bc = np.clip(
        (d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, 1e-30,
                             (d4 - d3) + (d5 - d6)), 0, 1,
    )
    cand_a = np.broadcast_to(a, closest.shape)
    cand_ab = a + t_ab[..., None] * ab
    cand_ac = a + t_ac[..., None] * ac
    cand_bc = b + t_bc[..., None] * (c - b)

    closest = np.where((vc <= 0)[..., None], cand_ab, closest)
    closest = np.where((vb <= 0)[..., None], cand_ac, closest)
    closest = np.where((va <= 0)[..., None], cand_bc, closest)
    closest = np.where(
        ((d1 <= 0) & (d2 <= 0))[..., None], cand_a, closest
    )
    closest = np.where(
        ((d3 >= 0) & (d4 <= d3))[..., None], np.broadcast_to(b, closest.shape),
        closest,
    )
    closest = np.where(
        ((d6 >= 0) & (d5 <= d6))[..., None], np.broadcast_to(c, closest.shape),
        closest,
    )
    sq = np.sum((closest - p) ** 2, axis=-1)
    return closest, sq


def on_surface(
    points: np.ndarray, vertices: np.ndarray, faces: np.ndarray,
    block: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """(distances, face_ids) of the closest surface point per query
    (trimesh ProximityQuery.on_surface equivalent, used for split-face
    recovery at ``utils.py:270``)."""
    tri = vertices[faces]
    best_d = np.full(len(points), np.inf)
    best_f = np.zeros(len(points), dtype=np.int64)
    for start in range(0, len(faces), block):
        _, sq = closest_point_on_triangles(points, tri[start : start + block])
        fmin = np.argmin(sq, axis=1)
        dmin = sq[np.arange(len(points)), fmin]
        upd = dmin < best_d
        best_d[upd] = dmin[upd]
        best_f[upd] = fmin[upd] + start
    return np.sqrt(best_d), best_f
