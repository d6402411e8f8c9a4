"""Arithmetic shared by the per-layer metric readers (``metrics/*.py``):
the model FLOPs of the window's work, and the neighbour operations'
roofline share in the traced slice."""

from __future__ import annotations

import torch

from p2cbench.reference import ops
from p2cbench.work import flops, neighbour


def mfu_percent(run, kind: str):
    """The window's model FLOPs a second as a share (%) of the card's peak
    in the configuration's compute dtype, over the steps or requests
    counted for the rate (the traced slice left out); None in a cell of
    another kind."""
    if run.traffic["kind"] != kind or not run.units:
        return None
    if kind == "train":
        work = flops.train_step_flop(run.cfg, run.traffic["batch"])
    else:
        work = flops.serve_flop(run.cfg, run.traffic["request_clouds"])
    return 100.0 * work * run.units / run.elapsed / flops.peak_flop_per_s(run.cfg["compute_dtype"])


def _stages(cfg: dict, pts: torch.Tensor) -> list[dict]:
    """Each set-abstraction stage's sizes and the reference's ball-query
    indices on ``pts`` (FPS from point 0)."""
    stages, xyz, width = [], pts, 0
    for npoint, radius, nsample, mlp in zip(cfg["sa_npoints"], cfg["sa_radii"],
                                            cfg["sa_nsamples"], cfg["sa_mlps"]):
        new = ops.index_points(xyz, ops.farthest_point_sample(xyz, npoint, 0))
        stages.append({"n": xyz.shape[1], "npoint": npoint, "c": width,
                       "idx": ops.ball_query(radius, nsample, xyz, new)})
        xyz, width = new, mlp[-1]
    return stages


def neighbour_roofline_percent(run, kind: str):
    """The neighbour operations' summed roofline bounds over their summed
    device time in the traced slice, a share (%); None where the slice ran
    none of their kernels, or in a cell of another kind."""
    if run.traffic["kind"] != kind or run.slice is None:
        return None
    maps = run.bench.kernel_maps()
    measured_s = sum(run.slice.device_time(m["patterns"]) for m in maps.values()) / 1e6
    if measured_s <= 0:
        return None
    if kind == "train":
        pts, train = run.batches[0]["point_cloud"], True
    else:
        pts, train = torch.from_numpy(run.pool[run.sample[0][1]]).to(run.device), False
    with torch.no_grad():
        stages = _stages(run.cfg, pts)
    bound_s = 0.0
    for m in maps.values():
        nbytes, n_ops = getattr(neighbour, m["work"])(run.cfg, pts.shape[0], stages, train)
        bound_s += neighbour.bound_s(nbytes, n_ops)
    return 100.0 * bound_s * run.slice_steps / measured_s
