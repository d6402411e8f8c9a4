"""Synthetic CAD solids: unions of 2 to K extrusions of circles and
regular polygons, sampled uniformly by surface area over barrels and caps,
normalised to the unit sphere, with per-point normals, instance and
base/barrel labels, per-instance axes and centres, and each instance's
normalised 2D sketch (boundary points and normals).

A frozen copy of the point2cyl port's synthetic generator, so that a
change to the program cannot change the benchmark's inputs. All draws come
from one numpy generator: the same seed gives the same solids.
"""

from __future__ import annotations

import numpy as np


def _random_unit(rng, n=1):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _frame(axis):
    ref = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(axis, ref)) > 0.9:
        ref = np.array([0.0, 1.0, 0.0])
    u = np.cross(axis, ref)
    u /= np.linalg.norm(u)
    return u, np.cross(axis, u)


def _boundary(rng, kind, radius, n):
    if kind == "circle":
        th = rng.uniform(0, 2 * np.pi, n)
        ring = np.stack([np.cos(th), np.sin(th)], -1)
        return radius * ring, ring
    sides = int(kind)
    edge = rng.integers(0, sides, n)
    t = rng.uniform(0, 1, n)
    ang0 = 2 * np.pi * edge / sides
    ang1 = 2 * np.pi * (edge + 1) / sides
    v0 = radius * np.stack([np.cos(ang0), np.sin(ang0)], -1)
    v1 = radius * np.stack([np.cos(ang1), np.sin(ang1)], -1)
    mid = (ang0 + ang1) / 2
    return v0 + t[:, None] * (v1 - v0), np.stack([np.cos(mid), np.sin(mid)], -1)


def _interior(rng, kind, radius, n):
    if kind == "circle":
        r = radius * np.sqrt(rng.uniform(0, 1, n))
        th = rng.uniform(0, 2 * np.pi, n)
        return r[:, None] * np.stack([np.cos(th), np.sin(th)], -1)
    sides = int(kind)
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


def solid(rng, resolution: int, max_instances: int, sketch_points: int) -> dict:
    """One labelled solid of ``resolution`` points."""
    n_inst = int(rng.integers(2, max_instances + 1))
    kinds = [str(rng.choice(["circle", "3", "4", "5", "6"])) for _ in range(n_inst)]
    axes = _random_unit(rng, n_inst)
    centers = rng.uniform(-0.6, 0.6, size=(n_inst, 3))
    radii = rng.uniform(0.15, 0.5, n_inst)
    heights = rng.uniform(0.3, 1.0, n_inst)
    barrel_area = 2 * np.pi * radii * heights
    area = barrel_area + 2 * np.pi * radii**2
    counts = np.maximum((resolution * area / area.sum()).astype(int), 8)
    counts[-1] += resolution - counts.sum()
    while counts[-1] < 8:
        counts[0] -= 8 - counts[-1]
        counts[-1] = 8
    pts_all, nrm_all, seg_all, bb_all = [], [], [], []
    sketches = np.zeros((max_instances, sketch_points, 4), np.float32)
    for i in range(n_inst):
        u, v = _frame(axes[i])
        n_barrel = max(int(counts[i] * barrel_area[i] / area[i]), 4)
        n_cap = counts[i] - n_barrel
        b2d, bn2d = _boundary(rng, kinds[i], radii[i], n_barrel)
        h = rng.uniform(-heights[i] / 2, heights[i] / 2, n_barrel)
        barrel = centers[i] + b2d[:, :1] * u + b2d[:, 1:] * v + h[:, None] * axes[i]
        c2d = _interior(rng, kinds[i], radii[i], n_cap)
        side = np.where(rng.uniform(size=n_cap) < 0.5, -1.0, 1.0)
        caps = (centers[i] + c2d[:, :1] * u + c2d[:, 1:] * v
                + (side * heights[i] / 2)[:, None] * axes[i])
        pts_all.append(np.concatenate([barrel, caps]))
        nrm_all.append(np.concatenate([bn2d[:, :1] * u + bn2d[:, 1:] * v,
                                       side[:, None] * axes[i]]))
        seg_all.append(np.full(counts[i], i))
        bb_all.append(np.concatenate([np.zeros(n_barrel), np.ones(n_cap)]))
        sb, sn = _boundary(rng, kinds[i], radii[i], sketch_points)
        sketches[i, :, :2] = sb / np.linalg.norm(sb, axis=-1).max()
        sketches[i, :, 2:] = sn
    pts = np.concatenate(pts_all).astype(np.float32)
    nrm = np.concatenate(nrm_all).astype(np.float32)
    seg = np.concatenate(seg_all).astype(np.int32)
    bb = np.concatenate(bb_all).astype(np.int32)
    perm = rng.permutation(pts.shape[0])
    pts, nrm, seg, bb = pts[perm], nrm[perm], seg[perm], bb[perm]
    centroid = pts.mean(axis=0)
    pts -= centroid
    scale = np.linalg.norm(pts, axis=-1).max()
    pts /= scale
    axes_pad = np.zeros((max_instances, 3), np.float32)
    axes_pad[:n_inst] = axes
    centers_pad = np.zeros((max_instances, 3), np.float32)
    centers_pad[:n_inst] = (centers - centroid) / scale
    return {"point_cloud": pts, "normals": nrm, "extrusion_labels": seg,
            "base_barrel_labels": bb, "extrusion_axes": axes_pad,
            "extrusion_centers": centers_pad, "sketches": sketches}


def pool(seed_seq, count: int, resolution: int, max_instances: int,
         sketch_points: int, keys=None) -> dict[str, np.ndarray]:
    """``count`` solids stacked on a leading axis (the keys ``keys``, or
    all)."""
    rng = np.random.default_rng(seed_seq)
    solids = [solid(rng, resolution, max_instances, sketch_points) for _ in range(count)]
    keys = keys or list(solids[0])
    return {k: np.stack([s[k] for s in solids]) for k in keys}
