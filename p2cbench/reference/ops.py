"""Plain neighbour operations, matching and closed-form geometry: the
arithmetic the reference's forward, losses and decomposition are built
from.

Frozen copies of the plain versions that the point2cyl port holds its
kernels against (farthest point sampling, the first-``nsample`` ball
query, the 3-NN interpolation), and of its matching over all K!
permutations and its closed-form 3x3 eigensolver. Every operation runs in
the order the plain versions run it, so that the reference agrees with a
sound program to float32 rounding: squared distances as
``((dx*dx + dy*dy) + dz*dz)``, FPS ties and the 3-NN ties to the lowest
index. Nothing here imports the program.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

ZERO_TOL = 1e-6


# ---- neighbourhoods ---------------------------------------------------------

def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: int | torch.Tensor = 0) -> torch.Tensor:
    """(B, npoint) int32 FPS indices from the (B,) ``start`` points."""
    b, n, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=xyz.device)
    if isinstance(start, torch.Tensor):
        farthest = start.to(device=xyz.device, dtype=torch.int64)
    else:
        farthest = torch.full((b,), int(start), dtype=torch.int64, device=xyz.device)
    distance = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    centroids = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        centroids[:, i] = farthest
        cx = x[rows, farthest][:, None]
        cy = y[rows, farthest][:, None]
        cz = z[rows, farthest][:, None]
        dx, dy, dz = x - cx, y - cy, z - cz
        distance = torch.minimum(distance, dx * dx + dy * dy + dz * dz)
        farthest = torch.argmax(distance, dim=-1)
    return centroids.to(torch.int32)


def square_distance(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(B, S, 3) x (B, N, 3) -> (B, S, N) exact squared distances."""
    dx = q[..., 0:1] - p[..., 0][:, None, :]
    dy = q[..., 1:2] - p[..., 1][:, None, :]
    dz = q[..., 2:3] - p[..., 2][:, None, :]
    return dx * dx + dy * dy + dz * dz


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (B, N, C) at per-batch indices (B, ...) -> (B, ..., C)."""
    b, _, c = points.shape
    flat = idx.reshape(b, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """The first ``nsample`` in-radius indices of each query, ascending,
    short rows padded with the first (B, S, nsample) int32; the radius is
    compared squared and rounded to float32."""
    n = xyz.shape[1]
    r2 = float(np.float32(radius * radius))
    inside = square_distance(new_xyz, xyz) <= r2
    cols = torch.arange(n, device=xyz.device)
    key = torch.where(inside, cols, n)
    top = torch.topk(key, nsample, dim=-1, largest=False, sorted=True).values
    idx = torch.where(top == n, top[..., :1], top)
    return idx.clamp(max=n - 1).to(torch.int32)


def group_points(xyz, feats, new_xyz, idx) -> torch.Tensor:
    """``[xyz[idx] - centre | feats[idx]]`` (B, S, nsample, 3 + D)."""
    grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped, index_points(feats, idx)], dim=-1)
    return grouped


def three_nn_interpolate(xyz_dst, xyz_src, feats_src, eps: float = 1e-8):
    """Inverse-squared-distance weighted mean of the 3 nearest sources'
    features, ``w0*f0 + w1*f1 + w2*f2`` (B, N, C)."""
    d = square_distance(xyz_dst, xyz_src)
    dists, idx = torch.sort(d, dim=-1, stable=True)
    dists, idx = dists[..., :3], idx[..., :3]
    recip = 1.0 / (dists + eps)
    norm = recip[..., 0] + recip[..., 1] + recip[..., 2]
    weight = recip / norm[..., None]
    g = index_points(feats_src, idx)
    w = weight[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]


# ---- matching ---------------------------------------------------------------

_PERMS: dict = {}


def _permutations(k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    key = (k, str(device))
    if key not in _PERMS:
        perms = torch.tensor(list(itertools.permutations(range(k))), dtype=torch.int64,
                             device=device)
        onehot = torch.nn.functional.one_hot(perms, k).to(torch.float32)
        _PERMS[key] = (perms, onehot.reshape(perms.shape[0], k * k).t().contiguous())
    return _PERMS[key]


def one_hot_labels(labels: torch.Tensor, k: int, dtype) -> torch.Tensor:
    cols = torch.arange(k, device=labels.device)
    return (labels[..., None] == cols).to(dtype)


def mask_gt_from_labels(i_gt: torch.Tensor, k: int) -> torch.Tensor:
    n_inst = i_gt.amax(dim=1) + 1
    cols = torch.arange(k, device=i_gt.device)
    return cols[None, :] < n_inst[:, None]


def hungarian_matching(w_pred: torch.Tensor, i_gt: torch.Tensor):
    """The GT-instance -> predicted-segment assignment of the largest
    summed relaxed IoU, over all K! permutations (ties to the first), and
    the valid rows (B, K). K <= 8."""
    k = w_pred.shape[-1]
    with torch.no_grad():
        w_gt = one_hot_labels(i_gt, k, w_pred.dtype)
        dot = torch.einsum("bnk,bnj->bkj", w_gt, w_pred)
        denom = w_gt.sum(dim=1)[:, :, None] + w_pred.sum(dim=1)[:, None, :] - dot
        cost = dot / torch.clamp(denom, min=1e-10)
        perms, onehot = _permutations(k, w_pred.device)
        scores = cost.reshape(cost.shape[0], k * k) @ onehot.to(cost.dtype)
        matching = perms[torch.argmax(scores, dim=-1)]
        mask = mask_gt_from_labels(i_gt, k)
        return torch.where(mask, matching, torch.zeros_like(matching)), mask


def reorder_w(w: torch.Tensor, matching: torch.Tensor) -> torch.Tensor:
    cols = matching[:, None, :].expand(-1, w.shape[1], -1)
    return torch.gather(w, 2, cols)


def reduce_mean_masked_instance(loss: torch.Tensor, mask_gt: torch.Tensor) -> torch.Tensor:
    loss = torch.where(mask_gt, loss, torch.zeros_like(loss))
    denom = mask_gt.to(loss.dtype).sum(dim=1)
    mean = loss.sum(dim=1) / torch.clamp(denom, min=1.0)
    return torch.where(denom > 0, mean, torch.zeros_like(mean))


# ---- the extrusion axis -----------------------------------------------------

def _det3(m: torch.Tensor) -> torch.Tensor:
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def eigenvalues_sym3x3(a: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues (..., 3) of symmetric (..., 3, 3), in closed
    form (trigonometric)."""
    a = 0.5 * (a + a.transpose(-1, -2))
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    q = diag.sum(-1) / 3.0
    off2 = a[..., 0, 1] ** 2 + a[..., 0, 2] ** 2 + a[..., 1, 2] ** 2
    p2 = ((diag - q[..., None]) ** 2).sum(-1) + 2.0 * off2
    p = torch.sqrt(torch.clamp(p2, min=1e-14) / 6.0)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    b = (a - q[..., None, None] * eye) / p[..., None, None]
    r = torch.clamp(_det3(b) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    phi = torch.arccos(r) / 3.0
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0943951023931953)
    lam_mid = 3.0 * q - lam_max - lam_min
    return torch.stack([lam_min, lam_mid, lam_max], dim=-1)


def smallest_eigenvector_sym3x3(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue (sign arbitrary): the
    largest column of (A - l2 I)(A - l3 I), or unit z where it vanishes."""
    a = 0.5 * (a + a.transpose(-1, -2))
    lam = eigenvalues_sym3x3(a)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = torch.matmul(a - lam[..., 1, None, None] * eye, a - lam[..., 2, None, None] * eye)
    norms2 = (m * m).sum(-2)
    best = torch.argmax(norms2, dim=-1)
    v = torch.gather(m, -1, best[..., None, None].expand(*m.shape[:-1], 1))[..., 0]
    n2 = (v * v).sum(-1, keepdim=True)
    v_unit = v * torch.rsqrt(torch.clamp(n2, min=eps))
    fallback = torch.eye(3, dtype=a.dtype, device=a.device)[2]
    return torch.where(n2 > eps, v_unit, fallback.expand_as(v_unit))


def axis_matrices(normals: torch.Tensor, w_barrel: torch.Tensor,
                  w_base: torch.Tensor) -> torch.Tensor:
    """sum_n (w_barrel^2 - w_base^2) x_n x_n^T (B, K, 3, 3): the matrix
    whose smallest eigenvector is each instance's extrusion axis."""
    wdiff = w_barrel * w_barrel - w_base * w_base
    outer = normals[..., :, None] * normals[..., None, :]
    return torch.einsum("bnk,bnij->bkij", wdiff, outer)


def extrusion_axes(normals, w_barrel, w_base) -> torch.Tensor:
    return smallest_eigenvector_sym3x3(axis_matrices(normals, w_barrel, w_base))


# ---- the sketch plane -------------------------------------------------------

def rotation_to_z(axis: torch.Tensor, tol: float = ZERO_TOL) -> torch.Tensor:
    """Rodrigues rotations (..., 3, 3) taking each unit axis to +z; an
    antiparallel axis keeps the identity."""
    c = axis[..., 2]
    ux = axis[..., 1]
    uy = -axis[..., 0]
    d = torch.where(torch.abs(1.0 + c) > tol, 1.0 + c, torch.ones_like(c))
    r = torch.stack([1.0 - uy * uy / d, ux * uy / d, uy,
                     ux * uy / d, 1.0 - ux * ux / d, -ux,
                     -uy, ux, c], dim=-1).reshape(*c.shape, 3, 3)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand_as(r)
    return torch.where(((1.0 + c) <= tol)[..., None, None], eye, r)


def project_to_sketch(pts, nrm, found, axes, centers):
    """Samples (B, K, S, 3) rotated so that each axis is +z, z dropped,
    centred on the projected centre: p2d, n2d (B, K, S, 2) (zero where not
    found) and scales (B, K), the largest 2D norm (1 where not found)."""
    rot = rotation_to_z(axes)
    p_rot = torch.einsum("bkij,bksj->bksi", rot, pts)[..., :2]
    n_rot = torch.einsum("bkij,bksj->bksi", rot, nrm)[..., :2]
    c_rot = torch.einsum("bkij,bkj->bki", rot, centers)[..., :2]
    p2d = p_rot - c_rot[:, :, None, :]
    scale = torch.sqrt((p2d * p2d).sum(-1) + 1e-20).amax(dim=-1)
    foundf = found[..., None, None].to(pts.dtype)
    return p2d * foundf, n_rot * foundf, torch.where(found, scale, torch.ones_like(scale))


def barrel_rows(tab: torch.Tensor, seg_label: torch.Tensor, bb_labels: torch.Tensor,
                k: int, num_samples: int, generator=None):
    """``num_samples`` rows (B, K, S, C) of ``tab`` (B, N, C) from the
    barrel points (bb == 0) of each segment, taken in ascending point order
    with repeats (sample j is member ``j % count``), or, given a
    ``generator``, members drawn as a 31-bit ``randint`` modulo the count;
    an empty segment repeats point 0. And found (B, K), at least 2
    members."""
    b, n, width = tab.shape
    segs = torch.arange(k, device=tab.device)
    member = (seg_label[:, None, :] == segs[None, :, None]) & (bb_labels[:, None, :] == 0)
    count = member.sum(dim=-1)
    order = torch.argsort((~member).to(torch.uint8), dim=-1, stable=True)
    if generator is None:
        draws = torch.arange(num_samples, device=tab.device)[None, None, :]
    else:
        draws = torch.randint(0, 2**31 - 1, (b, k, num_samples), generator=generator,
                              device=tab.device)
    idx = torch.gather(order, -1, draws % torch.clamp(count, min=1)[..., None])
    rows = torch.gather(tab, 1, idx.reshape(b, k * num_samples, 1).expand(-1, -1, width))
    return rows.reshape(b, k, num_samples, width), count > 1
