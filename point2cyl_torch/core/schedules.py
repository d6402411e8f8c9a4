"""Staircase learning-rate and BN-momentum schedules (the port of
``point2cyl_tpu/core/schedules.py:14-36, 66-77``; reference
``train_Point2Cyl_without_sketch.py:142-164``). Both are plain functions
of the step, evaluated on the host once per step."""

from __future__ import annotations

import math


def staircase_lr(
    step: int,
    batch_size: int,
    init_lr: float,
    decay_step: int = 200_000,
    decay_rate: float = 0.7,
) -> float:
    """lr = init * rate^floor(step * batch / decay_step)."""
    return init_lr * decay_rate ** math.floor(step * batch_size / decay_step)


def staircase_bn_momentum(
    step: int,
    batch_size: int,
    bn_decay_step: int = 200_000,
    init: float = 0.5,
    rate: float = 0.5,
    clip: float = 0.99,
) -> float:
    """momentum = max(init * rate^floor(step * batch / decay_step), 1-clip)."""
    return max(init * rate ** math.floor(step * batch_size / bn_decay_step),
               1.0 - clip)
