"""Bytes and operations the neighbour operations need, and their roofline
bound: the larger of the bytes at the peak HBM rate and the float32
operations at the peak rate. Inputs are counted read once and outputs
written once, whatever a kernel reads again; a ball query counts the
distance tests its first-``nsample`` selection needs on these inputs.

Each function takes the configuration, the clouds of one step or request
(B, N, 3) and the reference's ball-query indices of SA1 and SA2 on them,
and returns (bytes, operations) summed over that step's calls.
"""

from __future__ import annotations

import torch

from p2cbench.work.flops import PEAKS


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS["flop_per_s"]["float32"])


def _scanned(idx: torch.Tensor, n: int) -> tuple[int, int]:
    """(tests, rows): up to each query's nsample-th in-radius point, or all
    N where its row is short; the rows each batch row's farthest query
    needs."""
    full = idx[..., -1] != idx[..., 0]
    reach = torch.where(full, idx[..., -1].long() + 1, n)
    return int(reach.sum()), int(reach.reshape(idx.shape[0], -1).amax(dim=1).sum())


def fps(cfg: dict, b: int, stages: list, train: bool) -> tuple[float, float]:
    """Each SA stage's FPS: the cloud read once, the indices written; 10
    operations a point and iteration."""
    nbytes = ops = 0.0
    for st in stages:
        nbytes += b * st["n"] * 12 + b * st["npoint"] * 4
        ops += 10.0 * b * st["npoint"] * st["n"]
    return nbytes, ops


def ball_query(cfg: dict, b: int, stages: list, train: bool) -> tuple[float, float]:
    """Each SA stage's grouped query: the rows the selection needs and the
    centres read once, the indices and the grouped rows written once; 9
    operations a distance test and 3 a slot for the centring."""
    nbytes = ops = 0.0
    for st in stages:
        idx = st["idx"]
        tests, rows = _scanned(idx, st["n"])
        width = 3 + st["c"]
        nbytes += (rows * width * 4 + b * st["npoint"] * 12 + idx.numel() * 4
                   + idx.numel() * width * 4)
        ops += 9.0 * tests + 3.0 * idx.numel()
    return nbytes, ops


def _fp_stages(cfg: dict, stages: list):
    """(dst points, src points, feature width) of each 3-NN interpolation."""
    widths = [0] + [m[-1] for m in cfg["sa_mlps"]]
    pts = [cfg["num_points"]] + [st["npoint"] for st in stages]
    up = cfg["sa_global_mlp"][-1]
    out = []
    for i, mlp in enumerate(cfg["fp_mlps"]):
        dst, src = pts[-(i + 1)], (pts[-i] if i else 1)
        if src > 1:
            out.append((dst, src, up))
        up = mlp[-1]
    return out


def knn3(cfg: dict, b: int, stages: list, train: bool) -> tuple[float, float]:
    """The 3-NN interpolations (FP2, FP1): both point sets, the source
    features read once and the output written; 9 operations a pair, 5 an
    output element."""
    nbytes = ops = 0.0
    for dst, src, c in _fp_stages(cfg, stages):
        nbytes += (b * dst * 3 + b * src * 3 + b * src * c + b * dst * c) * 4
        ops += 9.0 * b * dst * src + 5.0 * b * dst * c
    return nbytes, ops


def neighbour_backward(cfg: dict, b: int, stages: list, train: bool) -> tuple[float, float]:
    """A training step's backwards of the 3-NN interpolations (indices,
    weights and cotangent read once, the source table written; 6
    operations a cotangent element) and of SA2's gather (indices and
    grouped cotangent read, the (B, N, 3 + C) table written; one add an
    element). SA1's gather has no backward: the cloud takes no gradient."""
    if not train:
        return 0.0, 0.0
    nbytes = ops = 0.0
    for dst, src, c in _fp_stages(cfg, stages):
        nbytes += (b * dst * 3 * 2 + b * dst * c + b * src * c) * 4
        ops += 6.0 * b * dst * c
    for st in stages:
        if st["c"]:
            idx = st["idx"]
            width = 3 + st["c"]
            nbytes += (idx.numel() + idx.numel() * width + b * st["n"] * width) * 4
            ops += float(idx.numel() * width)
    return nbytes, ops
