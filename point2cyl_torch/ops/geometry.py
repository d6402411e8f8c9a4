"""Decomposition geometry: per-segment sampling, extrusion extents and
the sketch-plane projection, the training noise and the weighted centre
estimate (the port of the JAX ``ops/geometry.py``).

Two paths share the maths (``_extents_from``, ``_projection_from``): the
general one (``segment_masks`` -> ``sample_segment_points`` -> a row
gather), which the evaluator runs with either rotation mode and a keyed
or deterministic draw, and the serving one
(``extents_and_sketch_projection``), which samples disjoint barrel
segments through one sort with the deterministic draw and the exact
rotation, and gives the same rows.
"""

from __future__ import annotations

import torch

from point2cyl_torch.core.config import ZERO_TOL
from point2cyl_torch.parallel.distributed import batch_draw


def add_noise(
    generator: torch.Generator,
    xyz: torch.Tensor,
    normals: torch.Tensor,
    sigma: float = 0.01,
) -> torch.Tensor:
    """Gaussian displacement of each point along its normal
    (``data_utils.py:84-96``), drawn from ``generator``."""
    b, n, _ = xyz.shape
    noise = sigma * batch_draw(generator, torch.randn, size=(b, n, 1), dtype=xyz.dtype,
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


def rotation_to_z_reference(axis: torch.Tensor, tol: float = ZERO_TOL) -> torch.Tensor:
    """The reference's sketch-plane rotation, defects included.

    ``sketch_implicit_projection`` builds R with
    ``tgm.angle_axis_to_rotation_matrix(cross(ax, z) * acos(ax . z))``
    (``data_utils.py:1092-1104``) and applies it as a row-vector product
    ``p @ R`` (``data_utils.py:1113``). The angle-axis vector is not
    normalised, so the applied angle is theta * sin(theta), and the
    transpose means the dropped direction is not the axis for tilted
    axes. Checkpoints of the reference's encoder and implicit network were
    trained on these projections. tgm's unit axis is v / (|v| + 1e-6), its
    Taylor branch (R = I + [v]x) takes |v|^2 <= 1e-6, and the identity
    stays where theta <= tol.

    Args: axis (..., 3) unit vectors. Returns (..., 3, 3) matrices to
    apply as q = M p (the transpose folded in).
    """
    z = torch.eye(3, dtype=axis.dtype, device=axis.device)[2]
    theta = torch.arccos(torch.clamp(axis[..., 2], -1.0, 1.0))
    v = torch.linalg.cross(axis, z.expand_as(axis)) * theta[..., None]  # |v| = theta sin(theta)
    theta2 = (v * v).sum(-1)
    theta_eff = torch.sqrt(torch.clamp(theta2, min=1e-30))
    w = v / (theta_eff[..., None] + 1e-6)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    c = torch.cos(theta_eff)
    s = torch.sin(theta_eff)
    one_c = 1.0 - c
    r_normal = torch.stack(
        [
            c + wx * wx * one_c, wx * wy * one_c - wz * s, wy * s + wx * wz * one_c,
            wz * s + wx * wy * one_c, c + wy * wy * one_c, -wx * s + wy * wz * one_c,
            -wy * s + wx * wz * one_c, wx * s + wy * wz * one_c, c + wz * wz * one_c,
        ],
        dim=-1,
    ).reshape(*theta.shape, 3, 3)
    ones = torch.ones_like(wx)
    r_taylor = torch.stack(
        [
            ones, -v[..., 2], v[..., 1],
            v[..., 2], ones, -v[..., 0],
            -v[..., 1], v[..., 0], ones,
        ],
        dim=-1,
    ).reshape(*theta.shape, 3, 3)
    r = torch.where((theta2 > 1e-6)[..., None, None], r_normal, r_taylor)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand_as(r)
    r = torch.where((theta > tol)[..., None, None], r, eye)
    return r.transpose(-1, -2)  # the p @ R row-vector product


def segment_masks(
    seg_label: torch.Tensor, bb_labels: torch.Tensor | None, k: int
) -> torch.Tensor:
    """(B, K, N) bool membership of each point in each segment.

    With ``bb_labels`` only the barrel points (bb == 0) of instance k are
    members (the gt_W_b of ``data_utils.py:1018-1024``). Without, every
    point is a member of every instance: the projection3 variant builds
    its gt_W_b as ``where(bb == 0, 1.0, 1.0)`` (``data_utils.py:1300``).
    """
    if bb_labels is None:
        return torch.ones((seg_label.shape[0], k, seg_label.shape[1]), dtype=torch.bool,
                          device=seg_label.device)
    segs = torch.arange(k, device=seg_label.device)
    member = seg_label[:, None, :] == segs[None, :, None]
    return member & (bb_labels[:, None, :] == 0)


def sample_segment_points(
    generator: torch.Generator | None, masks: torch.Tensor, num_samples: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_samples`` member indices of each (b, k), drawn with
    replacement (``data_utils.py:1061-1065``).

    A stable sort brings each segment's members to the front in ascending
    point order (the order of the reference's ``nonzero()``); draw j picks
    member ``j % count`` with ``generator=None`` (the deterministic draw of
    the JAX ``key=None`` mode), else a uniform member in
    [0, max(count, 1)) drawn from ``generator`` (a 31-bit ``randint``
    reduced modulo the count). An empty segment draws point 0.

    Returns idx (B, K, S) int64 and found (B, K), True where the segment
    has at least 2 members (``data_utils.py:1055-1058``).
    """
    b, k, _ = masks.shape
    order = torch.argsort((~masks).to(torch.uint8), dim=-1, stable=True)
    count = masks.sum(dim=-1)  # (B, K)
    high = torch.clamp(count, min=1)[..., None]
    if generator is None:
        draws = torch.arange(num_samples, device=masks.device)[None, None, :]
    else:
        draws = batch_draw(generator, torch.randint, 0, 2**31 - 1,
                           size=(b, k, num_samples), device=masks.device)
    return torch.gather(order, -1, draws % high), count > 1


def _gather_segment_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows (B, K, S, C) of ``tab`` (B, N, C) at ``idx`` (B, K, S)."""
    b, k, s = idx.shape
    rows = torch.gather(tab, 1, idx.reshape(b, k * s, 1).expand(-1, -1, tab.shape[-1]))
    return rows.reshape(b, k, s, tab.shape[-1])


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
    rotation_mode: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotate each segment's samples (``rotation_to_z`` for ``"exact"``,
    ``rotation_to_z_reference`` for ``"reference"``), drop z, centre on
    the projected centre; scale is the largest 2D norm (1 where not
    found). Returns p2d, n2d (B, K, S, 2), scales (B, K), found."""
    if rotation_mode == "exact":
        rot = rotation_to_z(axes)  # (B, K, 3, 3)
    elif rotation_mode == "reference":
        rot = rotation_to_z_reference(axes)
    else:
        raise ValueError(f"unknown rotation_mode: {rotation_mode!r}")
    p_rot = torch.einsum("bkij,bksj->bksi", rot, pts)[..., :2]
    n_rot = torch.einsum("bkij,bksj->bksi", rot, nrm)[..., :2]
    c_rot = torch.einsum("bkij,bkj->bki", rot, centers)[..., :2]
    p2d = p_rot - c_rot[:, :, None, :]
    scale = torch.sqrt((p2d * p2d).sum(-1) + 1e-20).amax(dim=-1)
    foundf = found[..., None, None].to(pts.dtype)
    scales = torch.where(found, scale, torch.ones_like(scale))
    return p2d * foundf, n_rot * foundf, scales, found


def sketch_projection(
    generator: torch.Generator | None,
    points: torch.Tensor,
    normals: torch.Tensor,
    seg_label: torch.Tensor,
    bb_labels: torch.Tensor | None,
    axes: torch.Tensor,
    centers: torch.Tensor,
    num_samples: int = 1024,
    rotation_mode: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-instance samples projected to centred 2D sketch planes
    (``sketch_implicit_projection{,2,3}``, ``data_utils.py:1014-1417``).

    Samples ``num_samples`` members of each segment (``segment_masks``:
    the barrel points of each instance, or with ``bb_labels=None`` the
    whole cloud), rotates each axis to +z in ``rotation_mode``, drops z
    and centres on the projected centre. Unfound segments are zeroed.

    Returns p2d, n2d (B, K, S, 2), scales (B, K) (1 where not found,
    ``data_utils.py:1144``) and found (B, K).
    """
    k = axes.shape[1]
    idx, found = sample_segment_points(generator, segment_masks(seg_label, bb_labels, k),
                                       num_samples)
    return _projection_from(_gather_segment_rows(points, idx),
                            _gather_segment_rows(normals, idx), found, axes, centers,
                            rotation_mode)


def extrusion_extents(
    generator: torch.Generator | None,
    points: torch.Tensor,
    seg_label: torch.Tensor,
    bb_labels: torch.Tensor,
    axes: torch.Tensor,
    centers: torch.Tensor,
    num_samples: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[min, max] (B, K, 2) of the sampled barrel points' signed distances
    along each axis from its centre (``get_extrusion_extents``,
    ``data_utils.py:1650-1730``), and found (B, K). As in the reference an
    unfound segment's samples count as 0, so its extents collapse to
    -centre . axis."""
    k = axes.shape[1]
    idx, found = sample_segment_points(generator, segment_masks(seg_label, bb_labels, k),
                                       num_samples)
    return _extents_from(_gather_segment_rows(points, idx), found, axes, centers), found


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
    ``[points | normals]`` rows (deterministic sampling, exact rotation):
    the rows, and so the results, of :func:`extrusion_extents` and
    :func:`sketch_projection` with ``generator=None``.

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
