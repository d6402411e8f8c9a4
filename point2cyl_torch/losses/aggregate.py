"""Aggregate proxy losses for the segmentation, normal and base/barrel
heads (the port of the JAX ``losses/aggregate.py``; reference
``losses.py:317-351`` and ``train_Point2Cyl_without_sketch.py:283-307``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from point2cyl_torch.losses.normal import normal_loss
from point2cyl_torch.losses.segmentation import compute_miou_loss, reorder_w
from point2cyl_torch.ops.matching import (hungarian_matching, mask_gt_from_labels,
                                          reduce_mean_masked_instance)


class ProxyLosses(NamedTuple):
    total: torch.Tensor  # scalar
    normal: torch.Tensor  # scalar
    miou: torch.Tensor  # scalar
    matching: torch.Tensor  # (B, K)
    mask: torch.Tensor  # (B, K) bool


def compute_all_losses(
    w: torch.Tensor,
    i_gt: torch.Tensor,
    normals: torch.Tensor,
    normals_gt: torch.Tensor,
    normal_loss_multiplier: float,
    miou_loss_multiplier: float,
) -> ProxyLosses:
    """Normal + Hungarian-matched relaxed-mIoU loss. The matching always
    runs (the other heads need it) and carries no gradient, as the
    reference's scipy matching does not."""
    batch, k = w.shape[0], w.shape[-1]
    mask_gt = mask_gt_from_labels(i_gt, k)
    matching, mask = hungarian_matching(w, i_gt)
    zeros = torch.zeros((batch,), dtype=w.dtype, device=w.device)
    nloss = (normal_loss(normals, normals_gt) if normal_loss_multiplier > 0
             else zeros)
    if miou_loss_multiplier > 0:
        miou_loss, _ = compute_miou_loss(w, i_gt, matching)
        avg_miou = reduce_mean_masked_instance(miou_loss, mask_gt)
    else:
        avg_miou = zeros
    total_miou = avg_miou.mean()
    total_normal = nloss.mean()
    total = miou_loss_multiplier * total_miou + normal_loss_multiplier * total_normal
    return ProxyLosses(total, total_normal, total_miou, matching, mask)


def base_barrel_ce_loss(
    w: torch.Tensor,
    w_barrel_raw: torch.Tensor,
    w_base_raw: torch.Tensor,
    gt_bb_labels: torch.Tensor,
    matching: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Confidence-weighted base/barrel cross entropy (scalar).

    W in GT order, invalid instances zeroed, renormalised by a softmax,
    weights a 2-way CE between the raw barrel/base logits; the
    reference's sort before the weighted sum is a no-op and is dropped, as
    in JAX (``aggregate.py:262-268``).
    """
    w_reordered = reorder_w(w, matching)
    w_reordered = torch.where(mask[:, None, :], w_reordered,
                              torch.zeros_like(w_reordered))
    w_reordered = torch.softmax(w_reordered, dim=-1)
    logp = torch.log_softmax(torch.stack([w_barrel_raw, w_base_raw], dim=-1), dim=-1)
    gt = gt_bb_labels[:, :, None]  # broadcast over K
    ce = -torch.where(gt == 0, logp[..., 0], logp[..., 1])  # (B, N, K)
    return (ce * w_reordered).sum(dim=-1).mean()
