"""Unoriented normal loss (the port of the JAX ``losses/normal.py``;
reference ``losses.py:120-143``)."""

from __future__ import annotations

import torch


def acos_safe(x: torch.Tensor) -> torch.Tensor:
    """Clamped arccos (``losses.py:123-124``)."""
    return torch.arccos(torch.clamp(x, -1.0 + 1e-6, 1.0 - 1e-6))


def normal_loss(
    normal: torch.Tensor,
    normal_gt: torch.Tensor,
    angle_diff: bool = False,
    collapse: bool = True,
) -> torch.Tensor:
    """``1 - |<n, n_gt>|`` (or its angle) per point of (B, N, 3) inputs,
    also used for (B, K, 3) axes; (B,) when collapsed, else (B, N)."""
    dot_abs = torch.abs((normal * normal_gt).sum(dim=-1))
    per_point = acos_safe(dot_abs) if angle_diff else 1.0 - dot_abs
    return per_point.mean(dim=-1) if collapse else per_point
