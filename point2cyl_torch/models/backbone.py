"""PointNet++-style segmentation backbone, eval and train forward.

The port of ``point2cyl_tpu/models/backbone.py``: set-abstraction stages
(FPS -> ball query -> shared MLP -> max over the neighbours), a group-all
stage, feature propagation (3-NN inverse-distance upsampling + shared
MLP), a shared FC stage with dropout and one dense head per output size.
Module names follow the reference model (``sa1``, ``fp3``, ``fc1``,
``bn1``, ``fc2.i``), so state_dicts load under the reference's keys.

Dispatch (``BackboneConfig.*_impl``): ``"auto"`` calls the kernel wrapper
(CUDA tensor -> the hand-written kernel, with its backward kernel where
one exists; CPU tensor -> its plain version), ``"kernel"`` the same but a
CPU tensor raises, ``"plain"`` the plain PyTorch version on any device,
differentiated by autograd. A set-abstraction stage picks its ball query
as the JAX backbone does (``backbone.py:91-120``): the fused SA1 kernel
for a cloud without features above N=1024, the fused SA2 kernel for one
with features up to N=1024, and otherwise the idx-only kernel with the
gather in PyTorch.

Train mode: batch statistics with the momentum passed in, dropout, and
random FPS starts, both drawn from the caller's ``torch.Generator``
(FPS starts may also be given).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn

from point2cyl_torch.core.config import BackboneConfig
from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.models.layers import BatchNorm, Dense, PointMLP, dropout
from point2cyl_torch.ops import cuda_ballquery, cuda_fps, cuda_knn
from point2cyl_torch.ops.grouping import (ball_query_plain, group_points,
                                          index_points, sample_and_group_all)

EXACT_N_MAX = 1024  # JAX's _EXACT_N_MAX: the fused SA kernels' dispatch bound


def _on_card(fn, *args):
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type != "cuda":
            raise ValueError(f"impl='kernel' needs CUDA tensors, got {a.device}")
    return fn(*args)


def _pick(impl: str, auto, plain):
    if impl == "plain":
        return plain
    if impl == "kernel":
        return functools.partial(_on_card, auto)
    return auto


class SetAbstraction(PointMLP):
    """FPS + ball-query grouping + shared MLP + neighbourhood max."""

    def __init__(self, in_features: int, npoint: int, radius: float, nsample: int,
                 mlp: Sequence[int], fps_impl: str = "auto",
                 ballquery_impl: str = "auto"):
        super().__init__(in_features + 3, mlp, conv_rank=4)
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.fps_impl = fps_impl
        self.ballquery_impl = ballquery_impl

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor | None,
                train: bool = False, momentum: float = 0.1,
                start: int | torch.Tensor = 0):
        fps = _pick(self.fps_impl, cuda_fps.farthest_point_sample,
                    cuda_fps.farthest_point_sample_plain)
        new_xyz = index_points(xyz, fps(xyz, self.npoint, start))
        n = xyz.shape[1]
        impl = self.ballquery_impl
        if feats is None and n > EXACT_N_MAX:
            group = _pick(impl, cuda_ballquery.ball_query_grouped,
                          cuda_ballquery.ball_query_grouped_plain)
            _, grouped = group(self.radius, self.nsample, xyz, new_xyz)
        elif feats is not None and n <= EXACT_N_MAX:
            group = _pick(impl, cuda_ballquery.sa_grouped_exact,
                          cuda_ballquery.sa_grouped_exact_plain)
            _, grouped = group(self.radius, self.nsample, xyz, feats, new_xyz)
        else:
            query = _pick(impl, cuda_ballquery.ball_query, ball_query_plain)
            idx = query(self.radius, self.nsample, xyz, new_xyz)
            grouped = group_points(xyz, feats, new_xyz, idx)
        return new_xyz, self.mlp(grouped, train, momentum).amax(dim=2)


class GlobalAbstraction(PointMLP):
    """Group-all stage: the whole cloud is one neighbourhood."""

    def __init__(self, in_features: int, mlp: Sequence[int]):
        super().__init__(in_features + 3, mlp, conv_rank=4)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor | None,
                train: bool = False, momentum: float = 0.1):
        new_xyz, grouped = sample_and_group_all(xyz, feats)
        return new_xyz, self.mlp(grouped, train, momentum).amax(dim=2)


class FeaturePropagation(PointMLP):
    """3-NN inverse-distance upsampling + shared MLP; a single source
    point broadcasts instead."""

    def __init__(self, in_features: int, mlp: Sequence[int], knn_impl: str = "auto"):
        super().__init__(in_features, mlp, conv_rank=3)
        self.knn_impl = knn_impl

    def forward(self, xyz_dst, xyz_src, feats_dst, feats_src, train: bool = False,
                momentum: float = 0.1):
        b, n, _ = xyz_dst.shape
        if xyz_src.shape[1] == 1:
            interpolated = feats_src.expand(b, n, feats_src.shape[2])
        else:
            interp = _pick(self.knn_impl, cuda_knn.three_nn_interpolate,
                           cuda_knn.three_nn_interpolate_plain)
            interpolated = interp(xyz_dst, xyz_src, feats_src, 1e-8)
        if feats_dst is not None:
            interpolated = torch.cat([feats_dst, interpolated], dim=-1)
        return self.mlp(interpolated, train, momentum)


class Backbone(nn.Module):
    """Per-point prediction backbone: ``pts`` (B, N, 3) -> one (B, N, out)
    tensor per entry of ``cfg.output_sizes``."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        num_sa = len(c.sa_npoints)
        if len(c.fp_mlps) != num_sa + 1:
            raise ValueError("need one feature-propagation stage per set "
                             "abstraction plus the group-all stage")
        feat_widths = [0]  # channels of each pyramid level's features
        for i in range(num_sa):
            sa = SetAbstraction(
                feat_widths[-1], c.sa_npoints[i], c.sa_radii[i], c.sa_nsamples[i],
                c.sa_mlps[i], fps_impl=c.fps_impl, ballquery_impl=c.ballquery_impl,
            )
            self.add_module(f"sa{i + 1}", sa)
            feat_widths.append(c.sa_mlps[i][-1])
        self.add_module(f"sa{num_sa + 1}",
                        GlobalAbstraction(feat_widths[-1], c.sa_global_mlp))
        width_up = c.sa_global_mlp[-1]
        for i, mlp in enumerate(c.fp_mlps):
            fp = FeaturePropagation(feat_widths[-(i + 1)] + width_up, mlp,
                                    knn_impl=c.knn_impl)
            self.add_module(f"fp{num_sa + 1 - i}", fp)
            width_up = mlp[-1]
        self.fc1 = Dense(width_up, c.fc_width)
        self.bn1 = BatchNorm(c.fc_width)
        self.fc2 = nn.ModuleList(Dense(c.fc_width, out) for out in c.output_sizes)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every dense layer afresh (PyTorch's conv default) from
        ``generator``; BN goes to weight 1, bias 0, mean 0, var 1."""
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)

    def forward(
        self,
        pts: torch.Tensor,
        train: bool = False,
        *,
        bn_momentum: float = 0.1,
        generator: torch.Generator | None = None,
        fps_starts: Sequence[torch.Tensor] | None = None,
    ) -> list[torch.Tensor]:
        """Heads for ``pts`` (B, N, 3).

        Eval mode (``train=False``) starts FPS at point 0 and uses the
        stored BN statistics. Train mode needs ``generator`` (on the
        cloud's device) for the dropout mask and, unless ``fps_starts``
        gives one (B,) start tensor per set-abstraction stage, the FPS
        starts; BN uses batch statistics and updates its running ones
        with ``bn_momentum``.
        """
        num_sa = len(self.cfg.sa_npoints)
        if train and generator is None and (
                fps_starts is None or self.cfg.dropout_rate > 0):
            raise ValueError("train mode draws dropout and FPS starts from a "
                             "generator; pass generator=")
        xyz, f = pts, None
        skips = [(xyz, f)]
        for i in range(num_sa):
            start: int | torch.Tensor = 0
            if train:
                if fps_starts is not None:
                    start = fps_starts[i]
                else:
                    start = torch.randint(0, xyz.shape[1], (xyz.shape[0],),
                                          generator=generator, device=xyz.device)
            xyz, f = getattr(self, f"sa{i + 1}")(xyz, f, train, bn_momentum, start)
            skips.append((xyz, f))
        xyz_up, feats_up = getattr(self, f"sa{num_sa + 1}")(xyz, f, train, bn_momentum)
        for i in range(num_sa + 1):
            dst_xyz, dst_f = skips[-(i + 1)]
            feats_up = getattr(self, f"fp{num_sa + 1 - i}")(
                dst_xyz, xyz_up, dst_f, feats_up, train, bn_momentum
            )
            xyz_up = dst_xyz
        h = torch.relu(self.bn1(self.fc1(feats_up), train, bn_momentum))
        if train:
            h = dropout(h, self.cfg.dropout_rate, generator)
        return [head(h) for head in self.fc2]


def build_backbone(
    cfg: BackboneConfig,
    *,
    state_dict: dict[str, torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> Backbone:
    """A backbone in eval mode on ``device`` (default: the card).

    Weights come from ``state_dict`` (loaded strictly) or, without one,
    are drawn from ``generator``.
    """
    dev = resolve_device(device)
    model = Backbone(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        model.reset_parameters(generator)
    return model.to(dev).eval()
