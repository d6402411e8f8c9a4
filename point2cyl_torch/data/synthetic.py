"""Synthetic extrusion-solid generator (the port's copy of the JAX
``data/synthetic.py``: the same numpy draws, so a seed gives the same
arrays in both packages).

The reference trains on Fusion Gallery / DeepCAD h5 packs produced by an
offline Autodesk-JSON preprocessing pipeline (``utils.py:16-951``); neither
the data nor the preprocessing program ships with it. This generator
produces fully-labeled extrusion solids with the exact same packed schema —
per-point normals, instance and base/barrel labels, per-instance axes /
centers / extents / distances, and normalized 2D sketches — so training,
eval, reconstruction, benchmarks, and tests run end-to-end without the
proprietary data. Real h5 packs drop in unchanged via ``data.h5_io``.

Solids are unions of K' extruded sketches (circles and regular polygons),
sampled uniformly by surface area over barrel and caps, then normalized to
the unit sphere (matching the preprocessing's center/normalize step,
``utils.py:922-950``).
"""

from __future__ import annotations

import numpy as np

from point2cyl_torch.data.h5_io import PackedDataset


def _random_unit(rng: np.random.Generator, n: int = 1) -> np.ndarray:
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _frame(axis: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    ref = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(axis, ref)) > 0.9:
        ref = np.array([0.0, 1.0, 0.0])
    u = np.cross(axis, ref)
    u /= np.linalg.norm(u)
    return u, np.cross(axis, u)


def _sketch_boundary(
    rng: np.random.Generator, kind: str, radius: float, n: int
) -> tuple[np.ndarray, np.ndarray]:
    """2D boundary points + outward unit normals for a sketch profile."""
    if kind == "circle":
        th = rng.uniform(0, 2 * np.pi, n)
        pts = radius * np.stack([np.cos(th), np.sin(th)], -1)
        nrm = np.stack([np.cos(th), np.sin(th)], -1)
        return pts, nrm
    # regular polygon with `sides` edges
    sides = int(kind)
    edge = rng.integers(0, sides, n)
    t = rng.uniform(0, 1, n)
    ang0 = 2 * np.pi * edge / sides
    ang1 = 2 * np.pi * (edge + 1) / sides
    v0 = radius * np.stack([np.cos(ang0), np.sin(ang0)], -1)
    v1 = radius * np.stack([np.cos(ang1), np.sin(ang1)], -1)
    pts = v0 + t[:, None] * (v1 - v0)
    mid = (ang0 + ang1) / 2
    nrm = np.stack([np.cos(mid), np.sin(mid)], -1)
    return pts, nrm


def _sketch_interior(
    rng: np.random.Generator, kind: str, radius: float, n: int
) -> np.ndarray:
    """Uniform samples inside the sketch profile (rejection from disc)."""
    if kind == "circle":
        r = radius * np.sqrt(rng.uniform(0, 1, n))
        th = rng.uniform(0, 2 * np.pi, n)
        return r[:, None] * np.stack([np.cos(th), np.sin(th)], -1)
    sides = int(kind)
    # fan triangulation sampling for the regular polygon
    edge = rng.integers(0, sides, n)
    a = rng.uniform(0, 1, n)
    b = rng.uniform(0, 1, n)
    flip = a + b > 1
    a[flip], b[flip] = 1 - a[flip], 1 - b[flip]
    ang0 = 2 * np.pi * edge / sides
    ang1 = 2 * np.pi * (edge + 1) / sides
    v0 = radius * np.stack([np.cos(ang0), np.sin(ang0)], -1)
    v1 = radius * np.stack([np.cos(ang1), np.sin(ang1)], -1)
    return a[:, None] * v0 + b[:, None] * v1


def generate_sample(
    rng: np.random.Generator,
    resolution: int,
    max_instances: int,
    num_sketch_points: int,
) -> dict:
    n_inst = int(rng.integers(2, max_instances + 1))
    kinds = [
        str(rng.choice(["circle", "3", "4", "5", "6"])) for _ in range(n_inst)
    ]
    axes = _random_unit(rng, n_inst)
    centers = rng.uniform(-0.6, 0.6, size=(n_inst, 3))
    radii = rng.uniform(0.15, 0.5, n_inst)
    heights = rng.uniform(0.3, 1.0, n_inst)

    # Allocate points per instance proportional to rough surface area.
    barrel_area = 2 * np.pi * radii * heights
    cap_area = 2 * np.pi * radii**2
    area = barrel_area + cap_area
    counts = np.maximum((resolution * area / area.sum()).astype(int), 8)
    counts[-1] += resolution - counts.sum()
    while counts[-1] < 8:  # rebalance if rounding starved the last one
        counts[0] -= 8 - counts[-1]
        counts[-1] = 8

    pts_all, nrm_all, seg_all, bb_all = [], [], [], []
    sketches = np.zeros((max_instances, num_sketch_points, 4), np.float32)
    sk_norms = np.ones((max_instances,), np.float32)
    for i in range(n_inst):
        u, v = _frame(axes[i])
        n_i = counts[i]
        n_barrel = max(int(n_i * barrel_area[i] / area[i]), 4)
        n_cap = n_i - n_barrel
        b2d, bn2d = _sketch_boundary(rng, kinds[i], radii[i], n_barrel)
        h = rng.uniform(-heights[i] / 2, heights[i] / 2, n_barrel)
        barrel = (
            centers[i]
            + b2d[:, :1] * u
            + b2d[:, 1:] * v
            + h[:, None] * axes[i]
        )
        barrel_n = bn2d[:, :1] * u + bn2d[:, 1:] * v
        c2d = _sketch_interior(rng, kinds[i], radii[i], n_cap)
        side = np.where(rng.uniform(size=n_cap) < 0.5, -1.0, 1.0)
        caps = (
            centers[i]
            + c2d[:, :1] * u
            + c2d[:, 1:] * v
            + (side * heights[i] / 2)[:, None] * axes[i]
        )
        caps_n = side[:, None] * axes[i]
        pts_all.append(np.concatenate([barrel, caps]))
        nrm_all.append(np.concatenate([barrel_n, caps_n]))
        seg_all.append(np.full(n_i, i))
        bb_all.append(
            np.concatenate([np.zeros(n_barrel), np.ones(n_cap)])
        )
        # Normalized sketch: boundary points + normals, centered, max-norm 1
        sb, sn = _sketch_boundary(rng, kinds[i], radii[i], num_sketch_points)
        scale = np.linalg.norm(sb, axis=-1).max()
        sketches[i, :, :2] = sb / scale
        sketches[i, :, 2:] = sn
        sk_norms[i] = scale

    pts = np.concatenate(pts_all).astype(np.float32)
    nrm = np.concatenate(nrm_all).astype(np.float32)
    seg = np.concatenate(seg_all).astype(np.int32)
    bb = np.concatenate(bb_all).astype(np.int32)

    # Shuffle points so labels aren't block-ordered.
    perm = rng.permutation(pts.shape[0])
    pts, nrm, seg, bb = pts[perm], nrm[perm], seg[perm], bb[perm]

    # Normalize to unit sphere (utils.py:922-950 semantics).
    centroid = pts.mean(axis=0)
    pts -= centroid
    scale = np.linalg.norm(pts, axis=-1).max()
    pts /= scale

    axes_pad = np.zeros((max_instances, 3), np.float32)
    axes_pad[:n_inst] = axes
    centers_pad = np.zeros((max_instances, 3), np.float32)
    centers_pad[:n_inst] = (centers - centroid) / scale
    extents_pad = np.zeros((max_instances, 2), np.float32)
    extents_pad[:n_inst, 0] = -heights / 2 / scale
    extents_pad[:n_inst, 1] = heights / 2 / scale
    dist_pad = np.zeros((max_instances,), np.float32)
    dist_pad[:n_inst] = heights / scale
    ops = np.zeros(pts.shape[0], np.int32)  # all "add" operations

    return dict(
        point_cloud=pts,
        normals=nrm,
        extrusion_labels=seg,
        base_barrel_labels=bb,
        n_instances=n_inst,
        extrusion_axes=axes_pad,
        extrusion_distances=dist_pad,
        extrusion_operation=ops,
        extrusion_centers=centers_pad,
        extrusion_extents=extents_pad,
        sketches=sketches,
        sketches_norms=sk_norms,
    )


def generate_dataset(
    num_samples: int,
    resolution: int = 8192,
    max_instances: int = 8,
    num_sketch_points: int = 2048,
    seed: int = 0,
) -> PackedDataset:
    """Generate a packed dataset of ``num_samples`` labeled solids."""
    rng = np.random.default_rng(seed)
    samples = [
        generate_sample(rng, resolution, max_instances, num_sketch_points)
        for _ in range(num_samples)
    ]
    stack = {
        k: np.stack([s[k] for s in samples]) for k in samples[0]
    }
    stack["n_instances"] = stack["n_instances"].astype(np.int32)
    ds = PackedDataset(**stack)
    ds.validate()
    return ds
