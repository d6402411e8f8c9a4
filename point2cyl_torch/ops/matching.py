"""Segment-to-instance matching and the hard segment encodings (the port
of the JAX ``ops/matching.py``).

The optimal GT-instance -> predicted-segment assignment over the (K, K)
relaxed-IoU cost is found, for K <= 8, by scoring all K! permutations with
one (B, K^2) x (K^2, K!) product and taking the argmax (ties to the first
permutation, as in JAX), all on the device. Rows past a sample's instance
count cost zero for every column, so the optimum restricted to the valid
rows is the rectangular Hungarian optimum. K > 8 needs the
Jonker-Volgenant solver (JAX ``ops/lap.py``), not ported yet.
"""

from __future__ import annotations

import functools
import itertools

import torch

MAX_ENUM_K = 8


@functools.lru_cache(maxsize=None)
def _permutations(k: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """All k! permutations (k!, k) and their one-hot matrices flattened to
    (k*k, k!), built once per (k, device): 10 MB at k=8."""
    perms = torch.tensor(list(itertools.permutations(range(k))), dtype=torch.int64,
                         device=device)
    onehot = torch.nn.functional.one_hot(perms, k).to(torch.float32)  # (k!, row, col)
    return perms, onehot.reshape(perms.shape[0], k * k).t().contiguous()


def relaxed_iou_cost(
    w_pred: torch.Tensor, i_gt: torch.Tensor, div_eps: float = 1e-10
) -> torch.Tensor:
    """Relaxed-IoU affinity (B, K, K) between GT instances (rows) and
    predicted segments (columns): ``<Wgt_k, Wpred_j> / (|Wgt_k| + |Wpred_j|
    - <.,.>)`` (``losses.py:38-41``). Background points (label -1) and rows
    past the instance count are zero."""
    k = w_pred.shape[-1]
    w_gt = one_hot_labels(i_gt, k, w_pred.dtype)
    dot = torch.einsum("bnk,bnj->bkj", w_gt, w_pred)
    denom = w_gt.sum(dim=1)[:, :, None] + w_pred.sum(dim=1)[:, None, :] - dot
    return dot / torch.clamp(denom, min=div_eps)


def one_hot_labels(labels: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, N) int labels in [-1, k) -> (B, N, k) one-hot; -1 gives a zero row."""
    cols = torch.arange(k, device=labels.device)
    return (labels[..., None] == cols).to(dtype)


def mask_gt_from_labels(i_gt: torch.Tensor, n_max_instances: int) -> torch.Tensor:
    """(B, K) bool validity mask: k < max(i_gt) + 1 (``losses.py:78-81``)."""
    n_inst = i_gt.amax(dim=1) + 1
    cols = torch.arange(n_max_instances, device=i_gt.device)
    return cols[None, :] < n_inst[:, None]


def hungarian_matching(
    w_pred: torch.Tensor, i_gt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimal GT-instance -> predicted-segment assignment, on the device.

    Args: w_pred (B, N, K) soft segmentation; i_gt (B, N) int labels in
    [-1, K), the instance count of a sample being max(i_gt) + 1.

    Returns matching (B, K) int64, the predicted column matched to GT
    instance k (zero for rows k >= n_gt), and mask (B, K) bool, True for
    the valid rows. Carries no gradient.
    """
    k = w_pred.shape[-1]
    if k > MAX_ENUM_K:
        raise NotImplementedError(
            f"matching K={k} > {MAX_ENUM_K} needs the Jonker-Volgenant solver "
            "(point2cyl_tpu/ops/lap.py), which waits in ROADMAP queue 1"
        )
    with torch.no_grad():
        cost = relaxed_iou_cost(w_pred, i_gt)  # (B, K, K)
        perms, onehot = _permutations(k, str(w_pred.device))
        scores = cost.reshape(cost.shape[0], k * k) @ onehot.to(cost.dtype)  # (B, K!)
        matching = perms[torch.argmax(scores, dim=-1)]  # (B, K)
        mask = mask_gt_from_labels(i_gt, k)
        return torch.where(mask, matching, torch.zeros_like(matching)), mask


def reduce_mean_masked_instance(
    loss: torch.Tensor, mask_gt: torch.Tensor
) -> torch.Tensor:
    """Mean over the valid instances of each sample (``losses.py:83-88``):
    loss (B, K), mask (B, K) bool -> (B,)."""
    loss = torch.where(mask_gt, loss, torch.zeros_like(loss))
    denom = mask_gt.to(loss.dtype).sum(dim=1)
    mean = loss.sum(dim=1) / torch.clamp(denom, min=1.0)
    return torch.where(denom > 0, mean, torch.zeros_like(mean))


def hard_w_encoding(
    w: torch.Tensor, to_null_mask: bool = False, null_threshold: float = 0.005
) -> torch.Tensor:
    """One-hot of the argmax of a soft segmentation (B, N, K).

    With ``to_null_mask``, columns whose soft mass is below
    ``null_threshold * N`` are zeroed entirely (null segments).
    """
    n, k = w.shape[1], w.shape[2]
    hard = torch.nn.functional.one_hot(torch.argmax(w, dim=-1), k).to(w.dtype)
    if to_null_mask:
        null = (w.sum(dim=1) < n * null_threshold).to(w.dtype)  # (B, K)
        hard = hard * (1.0 - null[:, None, :])
    return hard
