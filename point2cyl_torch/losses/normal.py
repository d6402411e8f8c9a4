"""Unoriented normal loss and angular error (the port of the JAX
``losses/normal.py``; reference ``losses.py:120-159``)."""

from __future__ import annotations

import math

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


def normal_difference(
    x: torch.Tensor,
    x_gt: torch.Tensor,
    in_radians: bool = True,
    collapse: bool = True,
) -> torch.Tensor:
    """Unoriented angle between ``x`` and ``x_gt`` (..., 3), in radians or
    degrees; averaged over the last axis left when collapsed
    (``losses.py:146-159``)."""
    ang = acos_safe(torch.abs((x * x_gt).sum(dim=-1)))
    if not in_radians:
        ang = ang * (180.0 / math.pi)
    return ang.mean(dim=-1) if collapse else ang
