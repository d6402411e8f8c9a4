"""Evaluation quantities the serving decomposition reuses (the serving
part of the JAX ``eval/metrics.py``)."""

from __future__ import annotations

import torch


def base_barrel_probs(w_2k: torch.Tensor) -> torch.Tensor:
    """(B, N, 2) summed even (barrel) / odd (base) softmax mass."""
    return torch.stack([w_2k[:, :, ::2].sum(-1), w_2k[:, :, 1::2].sum(-1)], dim=-1)


def hard_segment_centers(
    points: torch.Tensor, ea_w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment mean of the points whose hard membership ``ea_w`` is 1.

    Returns centers (B, K, 3), zero where not found, and found (B, K),
    which needs at least 2 member points.
    """
    member = (ea_w == 1.0).to(points.dtype)  # (B, N, K)
    count = member.sum(dim=1)  # (B, K)
    total = torch.einsum("bnk,bnc->bkc", member, points)
    centers = total / torch.clamp(count, min=1.0)[..., None]
    found = count > 1
    return centers * found[..., None], found
