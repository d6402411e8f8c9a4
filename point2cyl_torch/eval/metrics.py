"""Evaluation metrics (the port of the JAX ``eval/metrics.py``; reference
``eval.py:231-446``): hard, null-masked, Hungarian-matched segmentation
mIoU, base/barrel accuracy, the extrusion-axis error under the
oracle-substitution flags (``eval.py:63-69,348-405``) and hard
per-segment centroids. The serving decomposition reuses
``base_barrel_probs`` and ``hard_segment_centers``. ``fitting_losses``
scores the implicit decoder on the projected sketches
(``eval.py:553-590``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from point2cyl_torch.core.config import EvalConfig
from point2cyl_torch.losses.normal import normal_difference
from point2cyl_torch.losses.segmentation import reorder_w, segmentation_iou
from point2cyl_torch.models.implicit import add_latent
from point2cyl_torch.ops.geometry import sketch_projection
from point2cyl_torch.ops.linalg import estimate_extrusion_axis
from point2cyl_torch.ops.matching import (hard_w_encoding, hungarian_matching,
                                          mask_gt_from_labels, one_hot_labels,
                                          reduce_mean_masked_instance)


class SegMetrics(NamedTuple):
    miou: torch.Tensor  # (B,)
    matching: torch.Tensor  # (B, K)
    mask: torch.Tensor  # (B, K) bool
    w_hard: torch.Tensor  # (B, N, K)


def segmentation_metrics(w: torch.Tensor, i_gt: torch.Tensor) -> SegMetrics:
    """Hard, null-masked, Hungarian-matched mIoU (``eval.py:314-326``)."""
    w_hard = hard_w_encoding(w, to_null_mask=True)
    matching, mask = hungarian_matching(w_hard, i_gt)
    return SegMetrics(segmentation_iou(w_hard, i_gt, matching, mask), matching, mask,
                      w_hard)


def base_barrel_probs(w_2k: torch.Tensor) -> torch.Tensor:
    """(B, N, 2) summed even (barrel) / odd (base) softmax mass."""
    return torch.stack([w_2k[:, :, ::2].sum(-1), w_2k[:, :, 1::2].sum(-1)], dim=-1)


def base_barrel_accuracy(
    w_2k: torch.Tensor, gt_bb: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Accuracy (B,) of the argmax base/barrel labels, and those labels
    (B, N) (``eval.py:340-345``)."""
    pred = torch.argmax(base_barrel_probs(w_2k), dim=-1)
    return (pred == gt_bb).to(torch.float32).mean(dim=-1), pred


def axis_estimation_weights(
    cfg: EvalConfig,
    seg: SegMetrics,
    w: torch.Tensor,
    w_barrel: torch.Tensor,
    w_base: torch.Tensor,
    w_2k: torch.Tensor,
    i_gt: torch.Tensor,
    gt_bb: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Barrel and base weights (B, N, K) for the axis estimate under the
    oracle flags (``eval.py:354-394``), and ea_w, the hard segmentation
    that the centres and projection labels use downstream."""
    k = w.shape[-1]
    if cfg.use_gt_segmentation:
        ea_w = one_hot_labels(i_gt, k, w.dtype)
        bb = gt_bb if cfg.use_gt_bb else torch.argmax(base_barrel_probs(w_2k), dim=-1)
        is_barrel = (bb == 0).to(w.dtype)[..., None]
        return ea_w * is_barrel, ea_w * (1.0 - is_barrel), ea_w
    w_reordered_hard = reorder_w(seg.w_hard, seg.matching)
    if cfg.use_gt_bb:
        is_barrel = (gt_bb == 0).to(w.dtype)[..., None]
        return (w_reordered_hard * is_barrel, w_reordered_hard * (1.0 - is_barrel),
                w_reordered_hard)
    # full prediction: the soft barrel/base columns reordered
    # (eval.py:386-394; the reference's ea_w here reads an undefined
    # W_reordered — the hard reordered encoding is the evident intent)
    return (reorder_w(w_barrel, seg.matching), reorder_w(w_base, seg.matching),
            w_reordered_hard)


def axis_metrics(
    cfg: EvalConfig,
    normals: torch.Tensor,
    gt_normals: torch.Tensor,
    wb: torch.Tensor,
    wc: torch.Tensor,
    i_gt: torch.Tensor,
    gt_bb: torch.Tensor,
    gt_axes: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Extrusion-axis angle error in degrees, the mean over each sample's
    valid instances (``eval.py:397-405``). Returns error (B,) and axes
    (B, K, 3)."""
    x = gt_normals if cfg.use_gt_normals else normals
    axes = estimate_extrusion_axis(x, wb, wc, gt_bb, i_gt, normalize=cfg.norm_eig)
    diff = normal_difference(axes, gt_axes, in_radians=False, collapse=False)
    return reduce_mean_masked_instance(diff, mask_gt_from_labels(i_gt, gt_axes.shape[1])), axes


def hard_segment_centers(
    points: torch.Tensor, ea_w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment mean of the points whose hard membership ``ea_w`` is 1
    (``eval.py:409-436``).

    Returns centers (B, K, 3), zero where not found, and found (B, K),
    which needs at least 2 member points.
    """
    member = (ea_w == 1.0).to(points.dtype)  # (B, N, K)
    count = member.sum(dim=1)  # (B, K)
    total = torch.einsum("bnk,bnc->bkc", member, points)
    centers = total / torch.clamp(count, min=1.0)[..., None]
    found = count > 1
    return centers * found[..., None], found


def centroid_metric(
    centers: torch.Tensor, gt_centers: torch.Tensor, i_gt: torch.Tensor
) -> torch.Tensor:
    """Mean squared centre difference (B,) over each sample's valid
    instances (``eval.py:439-446``; masked by GT validity, not by
    found)."""
    diff = ((centers - gt_centers) ** 2).sum(dim=-1)
    return reduce_mean_masked_instance(diff, mask_gt_from_labels(i_gt, gt_centers.shape[1]))


@torch.no_grad()
def fitting_losses(
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],
    generator: torch.Generator | None,
    points: torch.Tensor,
    gt_normals: torch.Tensor,
    i_gt: torch.Tensor,
    gt_bb: torch.Tensor,
    axes: torch.Tensor,
    centers: torch.Tensor,
    scales: torch.Tensor,
    latents: torch.Tensor,
    valid_mask: torch.Tensor,
    num_sk_points: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Implicit-fitting metrics (``eval.py:553-590``), as the JAX
    ``fitting_losses`` computes them.

    Per cylinder: ``num_sk_points`` GT-labelled barrel points of each
    instance (GT normals) projected onto its PREDICTED sketch plane
    (``axes``, ``centers``), divided by ``scales``, and |SDF| under its
    latent, zeroed where the slot is invalid or not found; the mean over
    samples, summed over K and divided by ``max(i_gt) + 1``.

    Global: every point of each instance (``bb_labels=None``, N samples)
    the same way; |SDF| is 1e4 where the slot is invalid or not found,
    the min over K is taken per sample, and the mean over the barrel
    points of ``gt_bb`` (indexed by the cloud's point order, as the
    reference indexes it).

    ``generator`` draws the per-cylinder samples, then the global ones;
    ``None`` takes the deterministic draw. No autograd graph is kept.

    Args: sdf_fn (M, S, L+2) -> (M, S, 1); scales (B, K); latents
    (B, K, L); valid_mask (B, K) bool. Returns (per_cyl (B,), global (B,)).
    """
    b, n, _ = points.shape
    k = axes.shape[1]
    flat_lat = latents.reshape(b * k, -1)

    def run_sdf(p2d: torch.Tensor) -> torch.Tensor:
        s = p2d.shape[2]
        return sdf_fn(add_latent(p2d.reshape(b * k, s, 2), flat_lat)).reshape(b, k, s)

    p2d, _, _, found2 = sketch_projection(generator, points, gt_normals, i_gt, gt_bb,
                                          axes, centers, num_samples=num_sk_points)
    sk_out = run_sdf(p2d / scales[..., None, None])
    mask2 = (valid_mask & found2).to(points.dtype)
    n_inst = i_gt.amax(dim=1) + 1
    per_cyl = (sk_out * mask2[..., None]).abs().mean(dim=-1).sum(dim=-1) / n_inst

    p2d3, _, _, found3 = sketch_projection(generator, points, gt_normals, i_gt, None,
                                           axes, centers, num_samples=n)
    sk_out3 = run_sdf(p2d3 / scales[..., None, None]).abs()  # (B, K, N)
    mask3 = (valid_mask & found3)[..., None]
    min_over_k = torch.where(mask3, sk_out3, torch.full_like(sk_out3, 1e4)).amin(dim=1)
    barrel = (gt_bb == 0).to(points.dtype)
    glob = (min_over_k * barrel).sum(dim=-1) / torch.clamp(barrel.sum(dim=-1), min=1.0)
    return per_cyl, glob
