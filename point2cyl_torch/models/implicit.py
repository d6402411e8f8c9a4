"""The implicit sketch networks: the IGR SDF decoder and the 2D PointNet
encoder (the port of the JAX ``models/implicit.py``; reference
``IGR/network.py:20-92,132-174``).

``ImplicitNet`` is an 8x512 MLP with a skip connection, softplus(beta=100)
and geometric initialisation to the SDF of a circle. ``PointNetEncoder``
maps a sketch (or a weighted cloud) to an L2-normalised latent. The
state_dicts carry the reference's key names and shapes: ``lin{i}.weight``
(out, in) for the decoder, ``mlp1.{0,1,3,4}``, ``mlp2.{0,1,3,4,6,7}``
(Conv1d weights (out, in, 1) and BatchNorm1d with ``num_batches_tracked``)
and ``fc`` for the encoder.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from point2cyl_torch.models.layers import BatchNorm, Dense
from point2cyl_torch.parallel.distributed import batch_draw


class ImplicitNet(nn.Module):
    """SDF decoder f([latent | xy]) -> signed distance.

    Geometric initialisation (``IGR/network.py:47-56``): hidden layers
    ~ N(0, sqrt(2)/sqrt(out_dim)) with zero bias; the last layer
    ~ N(sqrt(pi)/sqrt(fan_in), 1e-5) with bias -radius, so the network
    starts as the SDF of a circle of ``radius_init``. A layer in
    ``skip_in`` takes ``cat([x, input]) / sqrt(2)``; the layer before it
    is ``hidden - d_in`` wide. Without geometric init the weights are
    LeCun-normal (flax's ``lecun_normal``) and the biases zero.
    """

    def __init__(self, d_in: int = 258, hidden: Sequence[int] = (512,) * 8,
                 skip_in: Sequence[int] = (4,), geometric_init: bool = True,
                 radius_init: float = 1.0, beta: float = 100.0):
        super().__init__()
        self.d_in = d_in
        self.skip_in = tuple(skip_in)
        self.geometric_init = geometric_init
        self.radius_init = radius_init
        self.beta = beta
        dims = [d_in, *hidden, 1]
        self.num_layers = len(dims)
        for layer in range(self.num_layers - 1):
            out_dim = dims[layer + 1] - (d_in if layer + 1 in self.skip_in else 0)
            setattr(self, f"lin{layer}", nn.Linear(dims[layer], out_dim))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every layer afresh from ``generator``."""
        last = self.num_layers - 2
        with torch.no_grad():
            for layer in range(self.num_layers - 1):
                lin = getattr(self, f"lin{layer}")
                out_dim, fan_in = lin.weight.shape
                if not self.geometric_init:
                    # flax lecun_normal: a normal truncated at 2 sigma, scaled
                    # so the variance is 1 / fan_in
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    lin.bias.zero_()
                elif layer == last:
                    lin.weight.normal_(math.sqrt(math.pi) / math.sqrt(fan_in), 1e-5,
                                       generator=generator)
                    lin.bias.fill_(-self.radius_init)
                else:
                    lin.weight.normal_(0.0, math.sqrt(2.0) / math.sqrt(out_dim),
                                       generator=generator)
                    lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        for layer in range(self.num_layers - 1):
            if layer in self.skip_in:
                x = torch.cat([x, inp], dim=-1) / math.sqrt(2.0)
            x = getattr(self, f"lin{layer}")(x)
            if layer < self.num_layers - 2:
                # log1p(exp(beta x)) / beta; identity above beta x = 20
                x = F.softplus(x, beta=self.beta) if self.beta > 0 else torch.relu(x)
        return x


class EncoderBatchNorm(BatchNorm):
    """The port's BatchNorm with the ``num_batches_tracked`` buffer of the
    reference's ``nn.BatchNorm1d`` in its state_dict; train mode counts
    batches in it, and nothing reads it."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps)
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        nn.Module._load_from_state_dict(self, state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, train: bool = False,
                momentum: float = 0.1) -> torch.Tensor:
        if train:
            self.num_batches_tracked.add_(1)
        return super().forward(x, train, momentum)


# the reference encoder's Sequential indices of its convs and BNs, in the
# order of the JAX TorchDense_j / TorchBatchNorm_j (torch_compat.py:230-233)
ENCODER_CONVS = (("mlp1", 0), ("mlp1", 3), ("mlp2", 0), ("mlp2", 3), ("mlp2", 6))
ENCODER_BNS = (("mlp1", 1), ("mlp1", 4), ("mlp2", 1), ("mlp2", 4), ("mlp2", 7))


class PointNetEncoder(nn.Module):
    """Sketch encoder -> L2-normalised latent (``IGR/network.py:132-174``).

    Input (M, S, C), channels last; C is cut to ``input_channels`` (x2
    with ``with_normals``) as the reference does (``IGR/network.py:165``).
    Five per-point dense layers (64, 64, 64, 128, 1024), each with BN and
    ReLU, a max-pool over points, ``fc`` and division by
    ``max(norm, 1e-12)``.
    """

    WIDTHS = (64, 64, 64, 128, 1024)

    def __init__(self, embedding_size: int = 256, input_channels: int = 2,
                 with_normals: bool = True):
        super().__init__()
        self.embedding_size = embedding_size
        self.input_channels = input_channels
        self.with_normals = with_normals
        self.c_in = input_channels * (2 if with_normals else 1)
        w = self.WIDTHS
        self.mlp1 = nn.Sequential(
            Dense(self.c_in, w[0]), EncoderBatchNorm(w[0]), nn.ReLU(),
            Dense(w[0], w[1]), EncoderBatchNorm(w[1]), nn.ReLU())
        self.mlp2 = nn.Sequential(
            Dense(w[1], w[2]), EncoderBatchNorm(w[2]), nn.ReLU(),
            Dense(w[2], w[3]), EncoderBatchNorm(w[3]), nn.ReLU(),
            Dense(w[3], w[4]), EncoderBatchNorm(w[4]), nn.ReLU())
        self.fc = nn.Linear(w[4], embedding_size)
        self.reset_parameters()

    def _layers(self) -> list[tuple[Dense, EncoderBatchNorm]]:
        return [(getattr(self, conv)[i], getattr(self, bn)[j])
                for (conv, i), (bn, j) in zip(ENCODER_CONVS, ENCODER_BNS)]

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Dense layers and ``fc`` drawn from ``generator`` as PyTorch's
        default (U(+-1/sqrt(fan_in))); BN left as it is."""
        for conv, _ in self._layers():
            conv.reset_parameters(generator)
        bound = 1.0 / math.sqrt(self.fc.in_features)
        with torch.no_grad():
            self.fc.weight.uniform_(-bound, bound, generator=generator)
            self.fc.bias.uniform_(-bound, bound, generator=generator)

    def mlp(self, x: torch.Tensor, train: bool = False,
            momentum: float = 0.1) -> torch.Tensor:
        """The five per-point dense-BN-ReLU layers over ``x`` (M, S, c_in)."""
        for conv, bn in self._layers():
            x = torch.relu(bn(conv(x), train, momentum))
        return x

    def forward(self, x: torch.Tensor, train: bool = False,
                momentum: float = 0.1) -> torch.Tensor:
        x = self.fc(self.mlp(x[..., :self.c_in], train, momentum).amax(dim=1))
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                               min=1e-12)


def add_latent(points: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """(M, S, 2) points and (M, L) latents -> (M, S, L + 2), the latent
    first, as the reference concatenates (``IGR/network.py:200-206``)."""
    lat = latents[:, None, :].expand(-1, points.shape[1], -1)
    return torch.cat([lat, points], dim=-1)


def sample_off_surface(
    generator: torch.Generator | None,
    points: torch.Tensor,
    global_sigma: float = 1.8,
    local_sigma: float = 0.01,
) -> torch.Tensor:
    """Off-surface samples for the eikonal term (``IGR/sampler.py:18-37``):
    each point moved by N(0, local_sigma), then S // 8 points uniform in
    [-global_sigma, global_sigma], both drawn from ``generator``.

    Args: points (B, S, D). Returns (B, S + S // 8, D).
    """
    b, s, d = points.shape
    local = points + local_sigma * batch_draw(generator, torch.randn, size=points.shape,
                                              dtype=points.dtype, device=points.device)
    glob = batch_draw(generator, torch.rand, size=(b, s // 8, d), dtype=points.dtype,
                      device=points.device)
    return torch.cat([local, (2.0 * glob - 1.0) * global_sigma], dim=1)
