"""Ball query with fused neighbour gather: the CUDA kernels
(``csrc/ballquery.cu``) and their plain versions.

Two kernels, one per set-abstraction stage of the backbone:

- :func:`ball_query_grouped` (SA1, no features): returns ``idx`` (B, S,
  nsample) int32 and ``grouped = xyz[idx] - centre`` (B, S, nsample, 3).
- :func:`sa_grouped_exact` (SA2, with features): returns ``idx`` and
  ``grouped = [xyz[idx] - centre | feats[idx]]`` (B, S, nsample, 3 + C).

Both select exactly at every N (the first ``nsample`` in-radius indices in
ascending order, padded with the first). A CPU tensor takes the plain
version, a CUDA tensor the kernel; a CUDA input the kernel does not take
raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from point2cyl_torch.ops import _build
from point2cyl_torch.ops.grouping import ball_query_plain, group_points, radius_squared

_SMEM_LIMIT = 232448  # bytes of shared memory a block may opt into on sm_90

_ARGS_GROUPED = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_void_p])
_ARGS_FEATURES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                  + [ctypes.c_float, ctypes.c_void_p])


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


def ball_query_grouped(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ball query + centred coordinate gather (SA1): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if xyz.device.type == "cpu":
        return ball_query_grouped_plain(radius, nsample, xyz, new_xyz)
    return ball_query_grouped_kernel(radius, nsample, xyz, new_xyz)


def sa_grouped_exact(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    feats: torch.Tensor,
    new_xyz: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ball query + gather of ``[xyz - centre | feats]`` (SA2): the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if xyz.device.type == "cpu":
        return sa_grouped_exact_plain(radius, nsample, xyz, feats, new_xyz)
    return sa_grouped_exact_kernel(radius, nsample, xyz, feats, new_xyz)
