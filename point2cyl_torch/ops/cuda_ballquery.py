"""Ball query, with and without fused neighbour gather: the CUDA kernels
(``csrc/ballquery.cu``), their plain versions, and the autograd Functions
that carry gradients through them.

- :func:`ball_query` (idx only): returns ``idx`` (B, S, nsample) int32.
  The backbone gathers with it in plain PyTorch wherever neither fused
  kernel applies (SA1 at N <= 1024).
- :func:`ball_query_grouped` (SA1, no features): returns ``idx`` and
  ``grouped = xyz[idx] - centre`` (B, S, nsample, 3).
- :func:`sa_grouped_exact` (SA2, with features): returns ``idx`` and
  ``grouped = [xyz[idx] - centre | feats[idx]]`` (B, S, nsample, 3 + C).

The two fused ones are :class:`BallQueryGrouped` and
:class:`SAGroupedExact`: the backward scatter-adds the grouped cotangent
onto the point table (``d_xyz[b, idx] += dg``, a kernel too) and sends
``-sum_slots dg[..., :3]`` to the centres; the indices carry no gradient.
Under ``inference_mode`` nothing is saved and no backward launches.

All select exactly at every N (the first ``nsample`` in-radius indices in
ascending order, padded with the first). A CPU tensor takes the plain
version, forward and backward; a CUDA tensor the kernel; a CUDA input the
kernel does not take raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from point2cyl_torch.ops import _build
from point2cyl_torch.ops.grouping import (ball_query_plain, group_points,
                                          group_scatter_plain, radius_squared)

_SMEM_LIMIT = 232448  # bytes of shared memory a block may opt into on sm_90

_ARGS_IDX = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])
_ARGS_GROUPED = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_void_p])
_ARGS_FEATURES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                  + [ctypes.c_float, ctypes.c_void_p])
_ARGS_SCATTER3 = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ARGS_SCATTER = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def ball_query_grouped_plain(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the SA1 kernel: (idx, xyz[idx] - centre)."""
    idx = ball_query_plain(radius, nsample, xyz, new_xyz)
    return idx, group_points(xyz, None, new_xyz, idx)


def sa_grouped_exact_plain(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    feats: torch.Tensor,
    new_xyz: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the SA2 kernel: (idx, [xyz[idx] - centre | feats[idx]])."""
    idx = ball_query_plain(radius, nsample, xyz, new_xyz)
    return idx, group_points(xyz, feats, new_xyz, idx)


def _check_inputs(name: str, nsample: int, tensors: dict[str, torch.Tensor]) -> None:
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name}: {key} must be on the same CUDA device, got {t.device}")
        if t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(f"{name}: {key} must be float32 (B, M, C), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.shape[0] != first.shape[0]:
            raise ValueError(f"{name}: batch sizes differ")
    b, n, _ = tensors["xyz"].shape
    if tensors["xyz"].shape[2] != 3 or tensors["new_xyz"].shape[2] != 3:
        raise ValueError(f"{name}: xyz and new_xyz must have 3 coordinates")
    if not (1 <= nsample <= n) or not 1 <= b <= 65535:
        raise ValueError(f"{name}: needs 1 <= nsample <= N and 1 <= B <= 65535, "
                         f"got nsample={nsample} N={n} B={b}")
    warps = 32 if n > 1024 else 8  # as csrc/ballquery.cu picks them
    if (3 * n + warps * nsample) * 4 > _SMEM_LIMIT:
        raise ValueError(f"{name}: N={n}, nsample={nsample} exceed shared memory")


def ball_query_kernel(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """Launch the idx-only kernel; ``.launches`` counts the launches."""
    _check_inputs("ball_query", nsample, {"xyz": xyz, "new_xyz": new_xyz})
    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    idx = torch.empty((b, s, nsample), dtype=torch.int32, device=xyz.device)
    fn = _build.function("p2c_ball_query", _ARGS_IDX)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    status = fn(xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(), b, n, s,
                nsample, radius_squared(radius), stream)
    ball_query_kernel.launches += 1
    _build.check("p2c_ball_query", status)
    return idx


ball_query_kernel.launches = 0  # kernel launches, for chip_smoke.py


def ball_query_grouped_kernel(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the SA1 kernel; ``.launches`` counts the launches."""
    _check_inputs("ball_query_grouped", nsample, {"xyz": xyz, "new_xyz": new_xyz})
    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    idx = torch.empty((b, s, nsample), dtype=torch.int32, device=xyz.device)
    grouped = torch.empty((b, s, nsample, 3), dtype=torch.float32, device=xyz.device)
    fn = _build.function("p2c_ball_query_grouped", _ARGS_GROUPED)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    status = fn(xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(),
                grouped.data_ptr(), b, n, s, nsample, radius_squared(radius), stream)
    ball_query_grouped_kernel.launches += 1
    _build.check("p2c_ball_query_grouped", status)
    return idx, grouped


ball_query_grouped_kernel.launches = 0  # kernel launches, for chip_smoke.py


def sa_grouped_exact_kernel(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    feats: torch.Tensor,
    new_xyz: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the SA2 kernel; ``.launches`` counts the launches."""
    _check_inputs("sa_grouped_exact", nsample,
                  {"xyz": xyz, "feats": feats, "new_xyz": new_xyz})
    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    c = feats.shape[2]
    if feats.shape[1] != n:
        raise ValueError("sa_grouped_exact: feats and xyz differ in N")
    idx = torch.empty((b, s, nsample), dtype=torch.int32, device=xyz.device)
    grouped = torch.empty((b, s, nsample, 3 + c), dtype=torch.float32,
                          device=xyz.device)
    fn = _build.function("p2c_sa_grouped_features", _ARGS_FEATURES)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    status = fn(xyz.data_ptr(), feats.data_ptr(), new_xyz.data_ptr(),
                idx.data_ptr(), grouped.data_ptr(), b, n, s, nsample, c,
                radius_squared(radius), stream)
    sa_grouped_exact_kernel.launches += 1
    _build.check("p2c_sa_grouped_features", status)
    return idx, grouped


sa_grouped_exact_kernel.launches = 0  # kernel launches, for chip_smoke.py


def _check_scatter(name: str, idx: torch.Tensor, dg: torch.Tensor, n: int) -> None:
    for key, t in (("idx", idx), ("dg", dg)):
        if t.device.type != "cuda" or t.device != idx.device:
            raise ValueError(f"{name}: {key} must be on the same CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if idx.dtype != torch.int32 or idx.dim() != 3:
        raise ValueError(f"{name}: idx must be int32 (B, S, nsample), got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if dg.dtype != torch.float32 or dg.shape[:3] != idx.shape or dg.dim() != 4:
        raise ValueError(f"{name}: dg must be float32 (B, S, nsample, W) over idx "
                         f"{tuple(idx.shape)}, got {dg.dtype} {tuple(dg.shape)}")
    if n < 1 or idx.numel() == 0:
        raise ValueError(f"{name}: needs N >= 1 and a non-empty idx")


def ball_query_grouped_backward_kernel(
    idx: torch.Tensor, dg: torch.Tensor, n: int
) -> torch.Tensor:
    """Launch the SA1 gather's backward: ``dg`` (B, S, nsample, 3)
    scatter-added onto a zeroed (B, n, 3) table at ``idx``;
    ``.launches`` counts the launches."""
    _check_scatter("ball_query_grouped_backward", idx, dg, n)
    if dg.shape[3] != 3:
        raise ValueError("ball_query_grouped_backward: dg must be 3 wide")
    b = idx.shape[0]
    rows = idx.shape[1] * idx.shape[2]
    out = torch.zeros((b, n, 3), dtype=torch.float32, device=dg.device)
    fn = _build.function("p2c_ball_query_grouped_backward", _ARGS_SCATTER3)
    stream = torch.cuda.current_stream(dg.device).cuda_stream
    status = fn(idx.data_ptr(), dg.data_ptr(), out.data_ptr(), b, rows, n, stream)
    ball_query_grouped_backward_kernel.launches += 1
    _build.check("p2c_ball_query_grouped_backward", status)
    return out


ball_query_grouped_backward_kernel.launches = 0  # kernel launches, for chip_smoke.py


def sa_grouped_backward_kernel(
    idx: torch.Tensor, dg: torch.Tensor, n: int
) -> torch.Tensor:
    """Launch the SA2 gather's backward: ``dg`` (B, S, nsample, 3 + C)
    scatter-added onto a zeroed (B, n, 3 + C) table at ``idx``;
    ``.launches`` counts the launches."""
    _check_scatter("sa_grouped_backward", idx, dg, n)
    b, w = idx.shape[0], dg.shape[3]
    rows = idx.shape[1] * idx.shape[2]
    out = torch.zeros((b, n, w), dtype=torch.float32, device=dg.device)
    fn = _build.function("p2c_sa_grouped_backward", _ARGS_SCATTER)
    stream = torch.cuda.current_stream(dg.device).cuda_stream
    status = fn(idx.data_ptr(), dg.data_ptr(), out.data_ptr(), b, rows, n, w, stream)
    sa_grouped_backward_kernel.launches += 1
    _build.check("p2c_sa_grouped_backward", status)
    return out


sa_grouped_backward_kernel.launches = 0  # kernel launches, for chip_smoke.py


class BallQueryGrouped(torch.autograd.Function):
    """SA1's fused ball query + gather with its scatter backward (the JAX
    ``ball_query_grouped`` custom VJP, ``pallas_ballquery.py:719-794``)."""

    @staticmethod
    def forward(ctx, radius, nsample, xyz, new_xyz):
        if xyz.device.type == "cpu":
            idx, grouped = ball_query_grouped_plain(radius, nsample, xyz, new_xyz)
        else:
            idx, grouped = ball_query_grouped_kernel(radius, nsample, xyz, new_xyz)
        ctx.mark_non_differentiable(idx)
        if ctx.needs_input_grad[2]:
            ctx.save_for_backward(idx)
            ctx.n = xyz.shape[1]
        return idx, grouped

    @staticmethod
    def backward(ctx, _, dg):
        d_xyz = d_new_xyz = None
        if ctx.needs_input_grad[2]:
            (idx,) = ctx.saved_tensors
            dg_c = dg.contiguous()
            if dg_c.device.type == "cpu":
                d_xyz = group_scatter_plain(idx, dg_c, ctx.n)
            else:
                d_xyz = ball_query_grouped_backward_kernel(idx, dg_c, ctx.n)
        if ctx.needs_input_grad[3]:
            d_new_xyz = -dg.sum(dim=2)  # centering adjoint
        return None, None, d_xyz, d_new_xyz


class SAGroupedExact(torch.autograd.Function):
    """SA2's fused ball query + gather of ``[xyz | feats]`` with its scatter
    backward (the JAX ``sa_grouped_exact`` custom VJP,
    ``pallas_ballquery.py:834-902``)."""

    @staticmethod
    def forward(ctx, radius, nsample, xyz, feats, new_xyz):
        if xyz.device.type == "cpu":
            idx, grouped = sa_grouped_exact_plain(radius, nsample, xyz, feats, new_xyz)
        else:
            idx, grouped = sa_grouped_exact_kernel(radius, nsample, xyz, feats,
                                                   new_xyz)
        ctx.mark_non_differentiable(idx)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            ctx.save_for_backward(idx)
            ctx.n = xyz.shape[1]
        return idx, grouped

    @staticmethod
    def backward(ctx, _, dg):
        d_xyz = d_feats = d_new_xyz = None
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            (idx,) = ctx.saved_tensors
            dg_c = dg.contiguous()
            if dg_c.device.type == "cpu":
                table = group_scatter_plain(idx, dg_c, ctx.n)
            else:
                table = sa_grouped_backward_kernel(idx, dg_c, ctx.n)
            d_xyz, d_feats = table[..., :3], table[..., 3:]
        if ctx.needs_input_grad[4]:
            d_new_xyz = -dg[..., :3].sum(dim=2)  # centering adjoint
        return None, None, d_xyz, d_feats, d_new_xyz


def ball_query(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """Ball query indices (B, S, nsample) int32: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, new_xyz)
    return ball_query_kernel(radius, nsample, xyz, new_xyz)


def ball_query_grouped(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ball query + centred coordinate gather (SA1), differentiable in
    ``xyz`` and ``new_xyz``: the kernels for CUDA tensors, the plain
    versions for CPU tensors."""
    return BallQueryGrouped.apply(radius, nsample, xyz, new_xyz)


def sa_grouped_exact(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    feats: torch.Tensor,
    new_xyz: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ball query + gather of ``[xyz - centre | feats]`` (SA2),
    differentiable in ``xyz``, ``feats`` and ``new_xyz``: the kernels for
    CUDA tensors, the plain versions for CPU tensors."""
    return SAGroupedExact.apply(radius, nsample, xyz, feats, new_xyz)
