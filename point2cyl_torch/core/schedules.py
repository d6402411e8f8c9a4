"""Staircase learning-rate and BN-momentum schedules (the port of
``point2cyl_tpu/core/schedules.py:14-36, 66-77``; reference
``train_Point2Cyl_without_sketch.py:142-164``). Both are functions of
the step: of a Python int on the host, or of a device int64 tensor,
computed on the device in float32 as JAX computes them inside its
compiled step (a captured step reads the step count from the card)."""

from __future__ import annotations

import math

import torch


def staircase_lr(
    step: int | torch.Tensor,
    batch_size: int,
    init_lr: float,
    decay_step: int = 200_000,
    decay_rate: float = 0.7,
) -> float | torch.Tensor:
    """lr = init * rate^floor(step * batch / decay_step)."""
    if isinstance(step, torch.Tensor):
        return init_lr * torch.pow(decay_rate, torch.floor(step * batch_size / decay_step))
    return init_lr * decay_rate ** math.floor(step * batch_size / decay_step)


def staircase_bn_momentum(
    step: int | torch.Tensor,
    batch_size: int,
    bn_decay_step: int = 200_000,
    init: float = 0.5,
    rate: float = 0.5,
    clip: float = 0.99,
) -> float | torch.Tensor:
    """momentum = max(init * rate^floor(step * batch / decay_step), 1-clip)."""
    if isinstance(step, torch.Tensor):
        p = torch.floor(step * batch_size / bn_decay_step)
        return torch.clamp(init * torch.pow(rate, p), min=1.0 - clip)
    return max(init * rate ** math.floor(step * batch_size / bn_decay_step),
               1.0 - clip)
