"""Decomposition geometry: per-segment sampling, extrusion extents and
the sketch-plane projection (exact rotation mode), the training noise and
the weighted centre estimate (the serving and training parts of the JAX
``ops/geometry.py``)."""

from __future__ import annotations

import torch

ZERO_TOL = 1e-6


def add_noise(
    generator: torch.Generator,
    xyz: torch.Tensor,
    normals: torch.Tensor,
    sigma: float = 0.01,
) -> torch.Tensor:
    """Gaussian displacement of each point along its normal
    (``data_utils.py:84-96``), drawn from ``generator``."""
    b, n, _ = xyz.shape
    noise = sigma * torch.randn((b, n, 1), generator=generator, dtype=xyz.dtype,
                                device=xyz.device)
    return xyz + noise * normals


def estimate_extrusion_centers(w: torch.Tensor, pcs: torch.Tensor) -> torch.Tensor:
    """Segmentation-weighted point means (B, K, 3) from soft weights
    (B, N, K) and points (B, N, 3) (``data_utils.py:253-266``). Like the
    reference it divides by N, not by the weight mass."""
    return torch.einsum("bnk,bnc->bkc", w, pcs) / pcs.shape[1]


def rotation_to_z(axis: torch.Tensor, tol: float = ZERO_TOL) -> torch.Tensor:
    """Rotations (..., 3, 3) taking each unit ``axis`` (..., 3) to +z.

    Exact Rodrigues alignment R = I + [u]x + [u]x^2 / (1 + c) with
    u = axis x z and c = axis . z, written out elementwise; an
    antiparallel axis (1 + c <= tol) keeps the identity.
    """
    c = axis[..., 2]
    ux = axis[..., 1]
    uy = -axis[..., 0]
    d = torch.where(torch.abs(1.0 + c) > tol, 1.0 + c, torch.ones_like(c))
    r = torch.stack(
        [
            1.0 - uy * uy / d, ux * uy / d, uy,
            ux * uy / d, 1.0 - ux * ux / d, -ux,
            -uy, ux, c,
        ],
        dim=-1,
    ).reshape(*c.shape, 3, 3)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand_as(r)
    aligned = (1.0 + c) <= tol
    return torch.where(aligned[..., None, None], eye, r)


def _sample_segment_rows_disjoint(
    tab: torch.Tensor,
    seg_label: torch.Tensor,
    bb_labels: torch.Tensor,
    k: int,
    num_samples: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic per-segment row sampling for disjoint barrel masks.

    One stable sort by ``barrel ? label : K`` lays each segment's members
    out contiguously in ascending point order; sample j of segment k is
    sorted row ``starts[k] + j % count[k]`` (the JAX ``key=None`` draw).
    An empty segment repeats point 0. Returns (rows (B, K, S, C),
    found (B, K) = count > 1).
    """
    b, n, width = tab.shape
    sort_key = torch.where(bb_labels == 0, seg_label, k)
    perm = torch.argsort(sort_key, dim=-1, stable=True)  # (B, N)
    segs = torch.arange(k, device=tab.device)
    counts = (sort_key[:, None, :] == segs[None, :, None]).sum(-1)  # (B, K)
    starts = torch.cumsum(counts, dim=-1) - counts
    draws = torch.arange(num_samples, device=tab.device)
    r = draws[None, None, :] % torch.clamp(counts, min=1)[..., None]
    # an empty segment past the last member points at row n; clamp it in
    # range, its rows are replaced by point 0 below
    pos = (starts[..., None] + r).reshape(b, k * num_samples).clamp(max=n - 1)
    sorted_tab = torch.gather(tab, 1, perm[..., None].expand(-1, -1, width))
    rows = torch.gather(sorted_tab, 1, pos[..., None].expand(-1, -1, width))
    rows = rows.reshape(b, k, num_samples, width)
    rows = torch.where((counts == 0)[..., None, None], tab[:, 0][:, None, None, :], rows)
    return rows, counts > 1


def _extents_from(
    pts: torch.Tensor, found: torch.Tensor, axes: torch.Tensor, centers: torch.Tensor
) -> torch.Tensor:
    """[min, max] (B, K, 2) of the sampled points' signed distances along
    each axis from its centre; an unfound segment's samples count as 0."""
    pts = pts * found[..., None, None].to(pts.dtype)
    centered = pts - centers[:, :, None, :]
    dist = torch.einsum("bksj,bkj->bks", centered, axes)
    return torch.stack([dist.amin(dim=-1), dist.amax(dim=-1)], dim=-1)


def _projection_from(
    pts: torch.Tensor,
    nrm: torch.Tensor,
    found: torch.Tensor,
    axes: torch.Tensor,
    centers: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotate each segment's samples so its axis is +z, drop z, centre on
    the projected centre; scale is the largest 2D norm (1 where not
    found). Returns p2d, n2d (B, K, S, 2), scales (B, K), found."""
    rot = rotation_to_z(axes)  # (B, K, 3, 3)
    p_rot = torch.einsum("bkij,bksj->bksi", rot, pts)[..., :2]
    n_rot = torch.einsum("bkij,bksj->bksi", rot, nrm)[..., :2]
    c_rot = torch.einsum("bkij,bkj->bki", rot, centers)[..., :2]
    p2d = p_rot - c_rot[:, :, None, :]
    scale = torch.sqrt((p2d * p2d).sum(-1) + 1e-20).amax(dim=-1)
    foundf = found[..., None, None].to(pts.dtype)
    scales = torch.where(found, scale, torch.ones_like(scale))
    return p2d * foundf, n_rot * foundf, scales, found


def extents_and_sketch_projection(
    points: torch.Tensor,
    normals: torch.Tensor,
    seg_label: torch.Tensor,
    bb_labels: torch.Tensor,
    axes: torch.Tensor,
    centers: torch.Tensor,
    num_samples: int = 1024,
) -> tuple[torch.Tensor, ...]:
    """Extents and sketch projection from one shared per-segment sample of
    ``[points | normals]`` rows (deterministic sampling, exact rotation).

    Returns extents (B, K, 2), p2d (B, K, S, 2), n2d (B, K, S, 2),
    scales (B, K), found (B, K).
    """
    k = axes.shape[1]
    tab = torch.cat([points, normals], dim=-1)  # (B, N, 6)
    rows, found = _sample_segment_rows_disjoint(tab, seg_label, bb_labels, k,
                                                num_samples)
    pts, nrm = rows[..., :3], rows[..., 3:]
    extents = _extents_from(pts, found, axes, centers)
    p2d, n2d, scales, found_p = _projection_from(pts, nrm, found, axes, centers)
    return extents, p2d, n2d, scales, found_p
