"""Closed-form symmetric 3x3 eigensolver and the extrusion-axis estimate.

Each extrusion axis is the eigenvector of the smallest eigenvalue of
X^T diag(w_barrel^2 - w_base^2) X over the predicted normals X, one 3x3
matrix per instance, solved analytically (trigonometric eigenvalues, then
Cayley-Hamilton for the eigenvector), as in the JAX ``ops/linalg.py``.
"""

from __future__ import annotations

import torch

_TWO_PI_OVER_3 = 2.0943951023931953  # 2*pi/3


def _det3(m: torch.Tensor) -> torch.Tensor:
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def eigenvalues_sym3x3(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending (..., 3).

    Inputs are clamped before the risky operations (sqrt at 0, the
    division by p, arccos at +-1), as in the JAX version.
    """
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
    lam_min = q + 2.0 * p * torch.cos(phi + _TWO_PI_OVER_3)
    lam_mid = 3.0 * q - lam_max - lam_min
    return torch.stack([lam_min, lam_mid, lam_max], dim=-1)


def smallest_eigenvector_sym3x3(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue, (..., 3, 3) -> (..., 3).

    Every column of (A - l2 I)(A - l3 I) is a multiple of it; the column of
    largest norm is taken. Where that column vanishes (the smallest
    eigenvalue is repeated) a fixed unit z is returned. The sign is
    arbitrary.
    """
    a = 0.5 * (a + a.transpose(-1, -2))
    lam = eigenvalues_sym3x3(a)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = torch.matmul(a - lam[..., 1, None, None] * eye,
                     a - lam[..., 2, None, None] * eye)
    norms2 = (m * m).sum(-2)  # column squared norms
    best = torch.argmax(norms2, dim=-1)
    v = torch.gather(m, -1, best[..., None, None].expand(*m.shape[:-1], 1))[..., 0]
    n2 = (v * v).sum(-1, keepdim=True)
    v_unit = v * torch.rsqrt(torch.clamp(n2, min=eps))
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device)
    return torch.where(n2 > eps, v_unit, fallback.expand_as(v_unit))


def estimate_extrusion_axis(
    normals: torch.Tensor,
    w_barrel: torch.Tensor,
    w_base: torch.Tensor,
    bb_labels: torch.Tensor | None = None,
    inst_labels: torch.Tensor | None = None,
    normalize: bool = False,
) -> torch.Tensor:
    """Per-instance extrusion axes (B, K, 3) from unit normals (B, N, 3)
    and barrel/base weights (B, N, K): the smallest-eigenvalue eigenvector
    of sum_n (w_barrel^2 - w_base^2) x_n x_n^T.

    ``normalize`` (the reference's NORM_EIG path, ``data_utils.py:133-160``)
    scales the barrel and base weights of instance k by 1/(sqrt(count)+1)
    of its ground-truth barrel / base points, from ``bb_labels`` (0 barrel,
    1 base) and ``inst_labels`` (B, N).
    """
    k = w_barrel.shape[-1]
    wb2 = w_barrel * w_barrel
    wc2 = w_base * w_base
    if normalize:
        if bb_labels is None or inst_labels is None:
            raise ValueError("normalize=True requires gt bb/instance labels")
        inst = (inst_labels[..., None] == torch.arange(k, device=normals.device)
                ).to(normals.dtype)
        n_barrel = (inst * (bb_labels == 0).to(normals.dtype)[..., None]).sum(dim=1)
        n_base = (inst * (bb_labels == 1).to(normals.dtype)[..., None]).sum(dim=1)
        wb2 = wb2 / ((torch.sqrt(n_barrel) + 1.0)[:, None, :] ** 2)
        wc2 = wc2 / ((torch.sqrt(n_base) + 1.0)[:, None, :] ** 2)
    wdiff = wb2 - wc2  # (B, N, K)
    outer = normals[..., :, None] * normals[..., None, :]  # (B, N, 3, 3)
    m = torch.einsum("bnk,bnij->bkij", wdiff, outer)
    return smallest_eigenvector_sym3x3(m)
