"""Neighbourhood ops for set abstraction and feature propagation, plain
PyTorch.

These are the plain versions of the ball-query and 3-NN kernels and of
their backward kernels (``ops/cuda_ballquery.py``, ``ops/cuda_knn.py``):
the CPU path, and what ``chip_smoke.py`` holds the kernels against on the
card. Squared
distances are exact differences summed as ``((dx*dx + dy*dy) + dz*dz)``,
the form of the JAX Pallas kernels (``pallas_ballquery.py:_exact_d``), so
in-radius membership equals theirs bit for bit. (The JAX XLA path,
``point2cyl_tpu/ops/grouping.py``, uses the expansion
``|s|^2 + |d|^2 - 2 s.d``; a pair within about 1e-7 of the radius can fall
on the other side there.)

Selection is always exact: the first ``nsample`` in-radius indices in
ascending order, short rows padded with the first; the 3 nearest sources
with ties going to the lowest index.
"""

from __future__ import annotations

import numpy as np
import torch


def radius_squared(radius: float) -> float:
    """``radius**2`` rounded to float32, the threshold every version of
    the ball query compares float32 distances against."""
    return float(np.float32(radius * radius))


def square_distance_exact(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(B, S, 3) x (B, N, 3) -> (B, S, N) exact squared distances."""
    dx = q[..., 0:1] - p[..., 0][:, None, :]
    dy = q[..., 1:2] - p[..., 1][:, None, :]
    dz = q[..., 2:3] - p[..., 2][:, None, :]
    return dx * dx + dy * dy + dz * dz


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows by per-batch indices: (B, N, C), (B, ...) -> (B, ..., C)."""
    b, _, c = points.shape
    flat = idx.reshape(b, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


def ball_query_plain(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """First ``nsample`` in-radius indices per query (ascending), short
    rows padded with the first; a row with none gives N-1, as the JAX
    exact kernel does.

    Args: xyz (B, N, 3); new_xyz (B, S, 3). Returns (B, S, nsample) int32.
    """
    n = xyz.shape[1]
    inside = square_distance_exact(new_xyz, xyz) <= radius_squared(radius)
    cols = torch.arange(n, device=xyz.device)
    key = torch.where(inside, cols, n)
    top = torch.topk(key, nsample, dim=-1, largest=False, sorted=True).values
    idx = torch.where(top == n, top[..., :1], top)
    return idx.clamp(max=n - 1).to(torch.int32)


def three_nn_weights_plain(
    xyz_dst: torch.Tensor, xyz_src: torch.Tensor, eps: float = 1e-8
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3 nearest sources of each destination point and their weights.

    Weights ``1/(d + eps)`` normalised over the 3 nearest sources, on
    exact squared distances; ties go to the lowest source index.

    Args: xyz_dst (B, N, 3); xyz_src (B, S, 3) with S >= 3. Returns idx
    (B, N, 3) int64 and w (B, N, 3).
    """
    d = square_distance_exact(xyz_dst, xyz_src)  # (B, N, S)
    dists, idx = torch.sort(d, dim=-1, stable=True)
    dists, idx = dists[..., :3], idx[..., :3]
    recip = 1.0 / (dists + eps)
    norm = recip[..., 0] + recip[..., 1] + recip[..., 2]
    return idx, recip / norm[..., None]


def three_nn_interpolate_plain(
    xyz_dst: torch.Tensor,
    xyz_src: torch.Tensor,
    feats_src: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Inverse-squared-distance weighted 3-NN interpolation
    (:func:`three_nn_weights_plain`), summed ``w0*f0 + w1*f1 + w2*f2``.

    Args: xyz_dst (B, N, 3); xyz_src (B, S, 3) with S >= 3; feats_src
    (B, S, C). Returns (B, N, C).
    """
    return three_nn_combine_plain(feats_src, *three_nn_weights_plain(xyz_dst, xyz_src, eps))


def three_nn_combine_plain(
    feats_src: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """``w0*f[i0] + w1*f[i1] + w2*f[i2]`` (B, N, C) from the 3 sources
    ``idx`` (B, N, 3) and weights (B, N, 3) of each destination point."""
    g = index_points(feats_src, idx)  # (B, N, 3, C)
    w = weight[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]


def three_nn_backward_plain(
    idx: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, s: int
) -> torch.Tensor:
    """Feature cotangent of the 3-NN interpolation, ``W^T g``: each
    destination row of ``g`` (B, N, C) scatter-adds into its 3 sources
    ``idx`` (B, N, 3) with weights ``weight`` (B, N, 3). Returns (B, S, C).
    """
    b, n, c = g.shape
    contrib = (weight[..., None] * g[:, :, None, :]).reshape(b, n * 3, c)
    rows = idx.reshape(b, n * 3, 1).long().expand(-1, -1, c)
    out = torch.zeros((b, s, c), dtype=g.dtype, device=g.device)
    return out.scatter_add_(1, rows, contrib)


def group_scatter_plain(idx: torch.Tensor, dg: torch.Tensor, n: int) -> torch.Tensor:
    """Backward of the neighbour gather: the grouped cotangent ``dg``
    (B, S, nsample, W) scatter-added onto an (B, n, W) table at the rows
    ``idx`` (B, S, nsample) it was gathered from."""
    b, w = dg.shape[0], dg.shape[-1]
    rows = idx.reshape(b, -1, 1).long().expand(-1, -1, w)
    out = torch.zeros((b, n, w), dtype=dg.dtype, device=dg.device)
    return out.scatter_add_(1, rows, dg.reshape(b, -1, w))


def group_points(
    xyz: torch.Tensor,
    feats: torch.Tensor | None,
    new_xyz: torch.Tensor,
    idx: torch.Tensor,
) -> torch.Tensor:
    """``[xyz[idx] - centre | feats[idx]]`` (B, S, nsample, 3 + D) for
    neighbour indices ``idx`` (B, S, nsample) around ``new_xyz`` (B, S, 3)."""
    grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped, index_points(feats, idx)], dim=-1)
    return grouped


def sample_and_group(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    feats: torch.Tensor | None,
    fps_idx: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Centres from FPS indices, their ball-query neighbourhoods, and the
    grouped ``[xyz[idx] - centre | feats[idx]]`` (B, S, nsample, 3 + D)."""
    new_xyz = index_points(xyz, fps_idx)
    idx = ball_query_plain(radius, nsample, xyz, new_xyz)
    return new_xyz, group_points(xyz, feats, new_xyz, idx)


def sample_and_group_all(
    xyz: torch.Tensor, feats: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole cloud as one group. Like the reference, the coordinates
    are not centred here."""
    b, _, c = xyz.shape
    new_xyz = torch.zeros((b, 1, c), dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None]
    if feats is not None:
        grouped = torch.cat([grouped, feats[:, None]], dim=-1)
    return new_xyz, grouped
