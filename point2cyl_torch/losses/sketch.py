"""Sketch reconstruction losses (the port of the JAX ``losses/sketch.py``;
reference ``losses.py:165-245``). No trainer calls them; they are ported
so that the port does all the JAX package does.
"""

from __future__ import annotations

import torch

from point2cyl_torch.core.config import ZERO_TOL
from point2cyl_torch.ops.chamfer import chamfer_distances
from point2cyl_torch.ops.matching import one_hot_labels


def sketch_loss(projected: torch.Tensor, gt_projected: torch.Tensor) -> torch.Tensor:
    """MSE between projected and GT-projected sketch points over the GT
    sketch's non-zero points (``losses.py:165-175``).

    Args: projected, gt_projected (B, K, S, D). Returns (B, K).
    """
    nonzero = ((gt_projected * gt_projected).sum(-1) != 0.0).sum(-1)
    sq = ((gt_projected - projected) ** 2).sum(dim=(-1, -2))
    return sq / (nonzero + ZERO_TOL)


def sketch_loss_masked(projected: torch.Tensor, gt_projected: torch.Tensor,
                       gt_bb_labels: torch.Tensor,
                       gt_instances: torch.Tensor) -> torch.Tensor:
    """Per-point sketch MSE over the GT barrel points of each instance
    (``losses.py:177-209``); the projections are per point (S == N).

    Args: projected, gt_projected (B, K, N, D); gt_bb_labels (B, N),
    0 = barrel; gt_instances (B, N). Returns (B, K).
    """
    k = projected.shape[1]
    w_b = (one_hot_labels(gt_instances, k, projected.dtype)
           * (gt_bb_labels == 0).to(projected.dtype)[..., None])  # (B, N, K)
    dists = ((gt_projected - projected) ** 2).sum(-1).transpose(1, 2)  # (B, N, K)
    count = (w_b != 0.0).sum(dim=1)
    return (dists * w_b).sum(dim=1) / (count + ZERO_TOL)


def weighted_chamfer_loss(p_projected: torch.Tensor, gt_projected: torch.Tensor,
                          p_soft_projected: torch.Tensor, w_barrel: torch.Tensor,
                          multiplier: float = 10.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Barrel-confidence-weighted bidirectional chamfer
    (``losses.py:212-230``).

    Args: p_projected, gt_projected, p_soft_projected (B, K, S, D);
    w_barrel (B, S, K). Returns the forward (B, K) weighted pred -> GT
    chamfer times ``multiplier`` and the backward (B, K) GT -> soft-pred
    chamfer times ``multiplier / 2``.
    """
    b, k, s, d = p_projected.shape
    fwd = chamfer_distances(p_projected.reshape(b * k, s, d),
                            gt_projected.reshape(b * k, s, d)).reshape(b, k, s)
    bwd = chamfer_distances(gt_projected.reshape(b * k, s, d),
                            p_soft_projected.reshape(b * k, s, d)).reshape(b, k, s)
    w = w_barrel.transpose(1, 2)  # (B, K, S)
    return (fwd * w).mean(-1) * multiplier, bwd.mean(-1) * (multiplier / 2.0)


def chamfer_eval(a_projected: torch.Tensor, b_projected: torch.Tensor) -> torch.Tensor:
    """Unweighted forward chamfer mean (``losses.py:232-245``).

    Args: (B, K, S, D) each. Returns (B, K).
    """
    b, k, s, d = a_projected.shape
    fwd = chamfer_distances(a_projected.reshape(b * k, s, d),
                            b_projected.reshape(b * k, s, d))
    return fwd.reshape(b, k, s).mean(-1)
