"""Shared building blocks, channels-last (B, ..., C) like the JAX package.

The reference's kernel-size-1 convolutions are per-point dense layers; the
weights keep the reference's conv shapes, (out, in, 1, 1) or (out, in, 1),
so state_dicts carry the reference key names and shapes.

A dense layer with a low-precision compute dtype (``"bfloat16"`` or
``"float16"``, JAX's ``TorchDense(dtype=...)``) multiplies in that type
with a float32 result (``ops/lowp_dense.py``); its parameters, and BN,
ReLU and everything after, stay float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from point2cyl_torch.ops.lowp_dense import dense_lowp, lowp_dtype
from point2cyl_torch.parallel.collectives import psum
from point2cyl_torch.parallel.distributed import batch_draw


class Dense(nn.Module):
    """Per-point dense layer with a reference conv-shaped weight.

    ``compute_dtype`` and ``impl`` are plain attributes, not state: a
    low-precision layer loads and saves the float32 layer's state_dict.
    """

    def __init__(self, in_features: int, out_features: int, conv_rank: int = 3,
                 compute_dtype: str = "float32", impl: str = "auto"):
        super().__init__()
        shape = (out_features, in_features) + (1,) * (conv_rank - 2)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.compute_dtype = lowp_dtype(compute_dtype)  # None: float32
        self.impl = impl

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the PyTorch conv default the
        reference trains under."""
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        if self.compute_dtype is None:
            return torch.matmul(x, w.t()) + self.bias
        return dense_lowp(x, w, self.bias, self.compute_dtype, self.impl)


class BatchNorm(nn.Module):
    """Batch normalisation with torch semantics and eps 1e-5 over the last
    axis: ``(x - mean) * rsqrt(var + eps) * weight + bias``.

    Eval mode normalises with the stored statistics. Train mode (the JAX
    ``TorchBatchNorm``, ``layers.py:127-188``) normalises with the biased
    batch variance, summed in two passes with the per-row partial sums
    first, and updates the running statistics in place as ``running =
    (1 - m) * running + m * batch`` with the unbiased variance; the
    momentum ``m`` comes with each call (the staircase schedule), as a
    float or as a 0-dim tensor on the device (Trainer A's step, which
    computes it from its step count on the card).

    With a ``group`` (a ``parallel.mesh.Mesh``, set by
    ``parallel.mesh.use_global_batch_norm``) the train-mode statistics
    are the global batch's, as under JAX's sharding: each pass's
    per-feature sum is summed over the ranks (differentiably) and divided
    by the global count.

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
        self.group = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, train: bool = False,
                momentum: float | torch.Tensor = 0.1) -> torch.Tensor:
        if not train:
            y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
            return y * self.weight + self.bias
        n = x.numel() // x.shape[-1]
        inner = tuple(range(1, x.dim() - 1))
        total = x.sum(dim=inner).sum(dim=0)
        if self.group is not None:
            total = psum(total, self.group)
            n *= self.group.world
        mean = total / n
        centered = x - mean
        squares = (centered * centered).sum(dim=inner).sum(dim=0)
        if self.group is not None:
            squares = psum(squares, self.group)
        var = squares / n
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            self.running_mean.copy_((1.0 - momentum) * self.running_mean + momentum * mean)
            self.running_var.copy_((1.0 - momentum) * self.running_var + momentum * unbiased)
        y = centered * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; the mask is
    drawn from ``generator`` (``F.dropout`` takes none; a
    ``parallel.distributed.RowDraws`` draws the global batch's mask)."""
    if rate <= 0.0:
        return x
    keep = batch_draw(generator, torch.rand, size=x.shape, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class PointMLP(nn.Module):
    """Stack of per-point Dense + BN + ReLU layers, held as the reference
    names them (``mlp_convs.j``, ``mlp_bns.j``); the dense layers compute
    in ``compute_dtype``."""

    def __init__(self, in_features: int, widths: Sequence[int], conv_rank: int = 3,
                 compute_dtype: str = "float32", dense_impl: str = "auto"):
        super().__init__()
        dims = [in_features, *widths]
        self.mlp_convs = nn.ModuleList(
            Dense(dims[i], dims[i + 1], conv_rank, compute_dtype, dense_impl)
            for i in range(len(widths))
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
