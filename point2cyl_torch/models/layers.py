"""Shared building blocks, channels-last (B, ..., C) like the JAX package.

The reference's kernel-size-1 convolutions are per-point dense layers; the
weights keep the reference's conv shapes, (out, in, 1, 1) or (out, in, 1),
so state_dicts carry the reference key names and shapes.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class Dense(nn.Module):
    """Per-point dense layer with a reference conv-shaped weight."""

    def __init__(self, in_features: int, out_features: int, conv_rank: int = 3):
        super().__init__()
        shape = (out_features, in_features) + (1,) * (conv_rank - 2)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the PyTorch conv default the
        reference trains under."""
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        return torch.matmul(x, w.t()) + self.bias


class BatchNorm(nn.Module):
    """Batch normalisation with torch semantics and eps 1e-5 over the last
    axis: ``(x - mean) * rsqrt(var + eps) * weight + bias``.

    Eval mode normalises with the stored statistics. Train mode (the JAX
    ``TorchBatchNorm``, ``layers.py:127-188``) normalises with the biased
    batch variance, summed in two passes with the per-row partial sums
    first, and updates the running statistics in place as ``running =
    (1 - m) * running + m * batch`` with the unbiased variance; the
    momentum ``m`` comes with each call (the staircase schedule).

    The state_dict holds ``weight``, ``bias``, ``running_mean`` and
    ``running_var``; a reference checkpoint's ``num_batches_tracked`` is
    accepted on load and dropped (nothing reads it).
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, train: bool = False,
                momentum: float = 0.1) -> torch.Tensor:
        if not train:
            y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
            return y * self.weight + self.bias
        n = x.numel() // x.shape[-1]
        inner = tuple(range(1, x.dim() - 1))
        mean = x.sum(dim=inner).sum(dim=0) / n
        centered = x - mean
        var = (centered * centered).sum(dim=inner).sum(dim=0) / n
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            self.running_mean.copy_((1.0 - momentum) * self.running_mean + momentum * mean)
            self.running_var.copy_((1.0 - momentum) * self.running_var + momentum * unbiased)
        y = centered * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; the mask is
    drawn from ``generator`` (``F.dropout`` takes none)."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class PointMLP(nn.Module):
    """Stack of per-point Dense + BN + ReLU layers, held as the reference
    names them (``mlp_convs.j``, ``mlp_bns.j``)."""

    def __init__(self, in_features: int, widths: Sequence[int], conv_rank: int = 3):
        super().__init__()
        dims = [in_features, *widths]
        self.mlp_convs = nn.ModuleList(
            Dense(dims[i], dims[i + 1], conv_rank) for i in range(len(widths))
        )
        self.mlp_bns = nn.ModuleList(BatchNorm(w) for w in widths)

    def mlp(self, x: torch.Tensor, train: bool = False,
            momentum: float = 0.1) -> torch.Tensor:
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            x = torch.relu(bn(conv(x), train, momentum))
        return x

    def forward(self, x: torch.Tensor, train: bool = False,
                momentum: float = 0.1) -> torch.Tensor:
        return self.mlp(x, train, momentum)
