"""The networks of Point2Cyl in plain PyTorch, as functions of a dict of
named weights: the PointNet++ backbone (``models/pointnet_extrusion.py``
of the published code), the sketch encoder and the IGR decoder
(``IGR/network.py``). The names and shapes are the published state_dict's
(:mod:`p2cbench.reference.layout`).

Every dense layer is ``x @ W^T + b`` channels last, batch normalisation
is torch's with eps 1e-5 (train mode: the biased batch variance, summed
per row first). Nothing here updates running statistics in a training
step: no comparison reads them. A ``stats`` dict instead makes each BN
normalise by its batch's statistics and record them (:func:`calibrate`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from p2cbench.reference import ops

EPS = 1e-5


def dense(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    w = p[name + ".weight"]
    return torch.matmul(x, w.reshape(w.shape[0], w.shape[1]).t()) + p[name + ".bias"]


def batch_norm(p: dict, name: str, x: torch.Tensor, train: bool,
               stats: dict | None = None) -> torch.Tensor:
    if not train and stats is None:
        y = (x - p[name + ".running_mean"]) * torch.rsqrt(p[name + ".running_var"] + EPS)
        return y * p[name + ".weight"] + p[name + ".bias"]
    n = x.numel() // x.shape[-1]
    inner = tuple(range(1, x.dim() - 1))
    mean = x.sum(dim=inner).sum(dim=0) / n
    centered = x - mean
    var = (centered * centered).sum(dim=inner).sum(dim=0) / n
    if stats is not None:
        stats[name] = (mean, var)
    return centered * torch.rsqrt(var + EPS) * p[name + ".weight"] + p[name + ".bias"]


def point_mlp(p: dict, stage: str, x: torch.Tensor, layers: int, train: bool, stats=None):
    for j in range(layers):
        x = torch.relu(batch_norm(p, f"{stage}.mlp_bns.{j}",
                                  dense(p, f"{stage}.mlp_convs.{j}", x), train, stats))
    return x


def backbone(p: dict, cfg: dict, pts: torch.Tensor, train: bool = False,
             generator: torch.Generator | None = None, stats=None) -> list[torch.Tensor]:
    """Heads (B, N, out) for each of ``cfg["output_sizes"]``. Train mode
    draws, from ``generator`` and in this order, SA1's and SA2's FPS
    starts and the dropout mask; eval mode starts FPS at point 0, and so
    does a run with ``stats``, whose BN layers use and record their batch
    statistics."""
    num_sa = len(cfg["sa_npoints"])
    xyz, f = pts, None
    skips = [(xyz, f)]
    for i in range(num_sa):
        stage = f"sa{i + 1}"
        start = 0
        if train:
            start = torch.randint(0, xyz.shape[1], (xyz.shape[0],), generator=generator,
                                  device=xyz.device)
        new_xyz = ops.index_points(xyz, ops.farthest_point_sample(
            xyz, cfg["sa_npoints"][i], start))
        idx = ops.ball_query(cfg["sa_radii"][i], cfg["sa_nsamples"][i], xyz, new_xyz)
        grouped = ops.group_points(xyz, f, new_xyz, idx)
        f = point_mlp(p, stage, grouped, len(cfg["sa_mlps"][i]), train, stats).amax(dim=2)
        xyz = new_xyz
        skips.append((xyz, f))
    # group all: the cloud of centres as one neighbourhood, not centred
    grouped = torch.cat([xyz[:, None], f[:, None]], dim=-1)
    feats_up = point_mlp(p, f"sa{num_sa + 1}", grouped, len(cfg["sa_global_mlp"]),
                         train, stats).amax(dim=2)
    xyz_up = torch.zeros((pts.shape[0], 1, 3), dtype=pts.dtype, device=pts.device)
    for i in range(num_sa + 1):
        dst_xyz, dst_f = skips[-(i + 1)]
        b, n, _ = dst_xyz.shape
        if xyz_up.shape[1] == 1:
            inter = feats_up.expand(b, n, feats_up.shape[2])
        else:
            inter = ops.three_nn_interpolate(dst_xyz, xyz_up, feats_up, 1e-8)
        if dst_f is not None:
            inter = torch.cat([dst_f, inter], dim=-1)
        feats_up = point_mlp(p, f"fp{num_sa + 1 - i}", inter, len(cfg["fp_mlps"][i]), train,
                             stats)
        xyz_up = dst_xyz
    h = torch.relu(batch_norm(p, "bn1", dense(p, "fc1", feats_up), train, stats))
    if train and cfg["dropout_rate"] > 0:
        rate = cfg["dropout_rate"]
        keep = torch.rand(tuple(h.shape), generator=generator, device=h.device) < 1.0 - rate
        h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
    return [dense(p, f"fc2.{i}", h) for i in range(len(cfg["output_sizes"]))]


ENCODER_LAYERS = (("mlp1.0", "mlp1.1"), ("mlp1.3", "mlp1.4"), ("mlp2.0", "mlp2.1"),
                  ("mlp2.3", "mlp2.4"), ("mlp2.6", "mlp2.7"))


def encoder(p: dict, x: torch.Tensor, train: bool = False, stats=None) -> torch.Tensor:
    """Sketches (M, S, 4) -> unit latents (M, L): five dense + BN + ReLU
    layers, a max over the points, ``fc``, and division by the norm."""
    x = x[..., :p["mlp1.0.weight"].shape[1]]
    for conv, bn in ENCODER_LAYERS:
        x = torch.relu(batch_norm(p, bn, dense(p, conv, x), train, stats))
    x = F.linear(x.amax(dim=1), p["fc.weight"], p["fc.bias"])
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def decoder(p: dict, x: torch.Tensor, layers: int, skip_in=(4,), beta: float = 100.0):
    """The SDF f([latent | xy]): ``layers`` linear layers with softplus
    (beta 100) between them, ``cat([h, input]) / sqrt(2)`` into each layer
    of ``skip_in``."""
    inp = x
    for layer in range(layers):
        if layer in skip_in:
            x = torch.cat([x, inp], dim=-1) / math.sqrt(2.0)
        x = F.linear(x, p[f"lin{layer}.weight"], p[f"lin{layer}.bias"])
        if layer < layers - 1:
            x = F.softplus(x, beta=beta)
    return x


@torch.no_grad()
def calibrate(p: dict, net, x: torch.Tensor, *args) -> None:
    """Set every BN layer's running statistics of the weights ``p`` in
    place to its batch's statistics on ``x`` through ``net`` (``backbone``
    with its config as ``args``, or ``encoder``), as a trained network's
    population statistics would be, so that eval mode normalises the
    activations of random weights as it does a trained network's."""
    stats: dict = {}
    if net is backbone:
        backbone(p, args[0], x, stats=stats)
    else:
        encoder(p, x, stats=stats)
    for name, (mean, var) in stats.items():
        p[name + ".running_mean"] = mean
        p[name + ".running_var"] = var
