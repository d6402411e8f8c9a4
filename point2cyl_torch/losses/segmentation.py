"""Relaxed-IoU segmentation loss (the port of the JAX
``losses/segmentation.py``; reference ``losses.py:90-103``)."""

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
