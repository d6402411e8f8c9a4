"""Relaxed-IoU segmentation loss and the eval-time IoUs (the port of the
JAX ``losses/segmentation.py``; reference ``losses.py:90-117``)."""

from __future__ import annotations

import torch

from point2cyl_torch.ops.matching import one_hot_labels


def reorder_w(w: torch.Tensor, matching: torch.Tensor) -> torch.Tensor:
    """Predicted columns in GT-instance order: column k of the result is
    column ``matching[b, k]`` of ``w`` (B, N, K) (``losses.py:95``)."""
    cols = matching[:, None, :].expand(-1, w.shape[1], -1)
    return torch.gather(w, 2, cols)


def compute_miou_loss(
    w: torch.Tensor, i_gt: torch.Tensor, matching: torch.Tensor,
    div_eps: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-instance relaxed 1 - IoU after matching; background points
    (label -1) count in neither intersection nor union.

    Returns loss (B, K) and the reordered predictions (B, N, K).
    """
    k = w.shape[-1]
    w_reordered = reorder_w(w, matching)
    w_gt = one_hot_labels(i_gt, k, w.dtype)
    dot = (w_gt * w_reordered).sum(dim=1)  # (B, K)
    denom = w_gt.sum(dim=1) + w_reordered.sum(dim=1) - dot + div_eps
    return 1.0 - dot / denom, w_reordered


def segmentation_iou(
    w: torch.Tensor, i_gt: torch.Tensor, matching: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Per-sample mean IoU (B,) over the valid instances ``mask`` (B, K)
    (``losses.py:106-109``)."""
    loss, _ = compute_miou_loss(w, i_gt, matching)
    maskf = mask.to(w.dtype)
    return (maskf * (1.0 - loss)).sum(dim=1) / torch.clamp(maskf.sum(dim=1), min=1.0)


def weighted_segmentation_iou(
    w: torch.Tensor, i_gt: torch.Tensor, matching: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Point-count-weighted IoU (B,) with ``weights`` (B, K) the instances'
    point counts (``losses.py:111-117``; no reference entry point calls
    it)."""
    loss, _ = compute_miou_loss(w, i_gt, matching)
    return ((1.0 - loss) * weights / float(w.shape[1])).sum(dim=1)
