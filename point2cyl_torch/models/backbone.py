"""PointNet++-style segmentation backbone, eval forward.

The port of ``point2cyl_tpu/models/backbone.py``: set-abstraction stages
(FPS -> ball query -> shared MLP -> max over the neighbours), a group-all
stage, feature propagation (3-NN inverse-distance upsampling + shared
MLP), a shared FC stage and one dense head per output size. Module names
follow the reference model (``sa1``, ``fp3``, ``fc1``, ``bn1``, ``fc2.i``),
so state_dicts load under the reference's keys.

Dispatch (``BackboneConfig.*_impl``): ``"auto"`` calls the kernel wrapper
(CUDA tensor -> the hand-written kernel, CPU tensor -> its plain version),
``"kernel"`` the kernel itself, ``"plain"`` the plain PyTorch version on
any device. Train mode (batch statistics, dropout, random FPS starts)
comes with the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from point2cyl_torch.core.config import BackboneConfig
from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.models.layers import BatchNorm, Dense, PointMLP
from point2cyl_torch.ops import cuda_ballquery, cuda_fps, cuda_knn
from point2cyl_torch.ops.grouping import index_points, sample_and_group_all


def _pick(impl: str, auto, kernel, plain):
    return {"auto": auto, "kernel": kernel, "plain": plain}[impl]


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

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor | None):
        fps = _pick(self.fps_impl, cuda_fps.farthest_point_sample,
                    cuda_fps.farthest_point_sample_kernel,
                    cuda_fps.farthest_point_sample_plain)
        new_xyz = index_points(xyz, fps(xyz, self.npoint))
        if feats is None:
            group = _pick(self.ballquery_impl, cuda_ballquery.ball_query_grouped,
                          cuda_ballquery.ball_query_grouped_kernel,
                          cuda_ballquery.ball_query_grouped_plain)
            _, grouped = group(self.radius, self.nsample, xyz, new_xyz)
        else:
            group = _pick(self.ballquery_impl, cuda_ballquery.sa_grouped_exact,
                          cuda_ballquery.sa_grouped_exact_kernel,
                          cuda_ballquery.sa_grouped_exact_plain)
            _, grouped = group(self.radius, self.nsample, xyz, feats, new_xyz)
        return new_xyz, self.mlp(grouped).amax(dim=2)


class GlobalAbstraction(PointMLP):
    """Group-all stage: the whole cloud is one neighbourhood."""

    def __init__(self, in_features: int, mlp: Sequence[int]):
        super().__init__(in_features + 3, mlp, conv_rank=4)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor | None):
        new_xyz, grouped = sample_and_group_all(xyz, feats)
        return new_xyz, self.mlp(grouped).amax(dim=2)


class FeaturePropagation(PointMLP):
    """3-NN inverse-distance upsampling + shared MLP; a single source
    point broadcasts instead."""

    def __init__(self, in_features: int, mlp: Sequence[int], knn_impl: str = "auto"):
        super().__init__(in_features, mlp, conv_rank=3)
        self.knn_impl = knn_impl

    def forward(self, xyz_dst, xyz_src, feats_dst, feats_src):
        b, n, _ = xyz_dst.shape
        if xyz_src.shape[1] == 1:
            interpolated = feats_src.expand(b, n, feats_src.shape[2])
        else:
            interp = _pick(self.knn_impl, cuda_knn.three_nn_interpolate,
                           cuda_knn.three_nn_interpolate_kernel,
                           cuda_knn.three_nn_interpolate_plain)
            interpolated = interp(xyz_dst, xyz_src, feats_src, 1e-8)
        if feats_dst is not None:
            interpolated = torch.cat([feats_dst, interpolated], dim=-1)
        return self.mlp(interpolated)


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

    def forward(self, pts: torch.Tensor, train: bool = False) -> list[torch.Tensor]:
        if train:
            raise NotImplementedError(
                "train mode (batch statistics, dropout, random FPS starts) is "
                "not ported yet"
            )
        num_sa = len(self.cfg.sa_npoints)
        xyz, f = pts, None
        skips = [(xyz, f)]
        for i in range(num_sa):
            xyz, f = getattr(self, f"sa{i + 1}")(xyz, f)
            skips.append((xyz, f))
        xyz_up, feats_up = getattr(self, f"sa{num_sa + 1}")(xyz, f)
        for i in range(num_sa + 1):
            dst_xyz, dst_f = skips[-(i + 1)]
            feats_up = getattr(self, f"fp{num_sa + 1 - i}")(
                dst_xyz, xyz_up, dst_f, feats_up
            )
            xyz_up = dst_xyz
        h = torch.relu(self.bn1(self.fc1(feats_up)))
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
