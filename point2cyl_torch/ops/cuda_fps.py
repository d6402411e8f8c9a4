"""Farthest point sampling: the CUDA kernel (``csrc/fps.cu``) and its
plain version.

:func:`farthest_point_sample` takes the plain version
(:func:`farthest_point_sample_plain`, ``ops/sampling.py``) for a CPU
tensor and launches the kernel for a CUDA tensor; it raises on anything
the kernel does not take. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from point2cyl_torch.ops import _build
from point2cyl_torch.ops.sampling import farthest_point_sample_plain, start_indices

__all__ = ["farthest_point_sample", "farthest_point_sample_kernel",
           "farthest_point_sample_plain"]

MAX_POINTS = 16384  # 16 points a thread in a 1024-thread block

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def farthest_point_sample_kernel(
    xyz: torch.Tensor, npoint: int, start_idx: int | torch.Tensor = 0
) -> torch.Tensor:
    """Launch the FPS kernel; ``.launches`` counts the launches.

    xyz (B, N, 3) float32 contiguous on CUDA. Returns (B, npoint) int32.
    """
    if xyz.device.type != "cuda":
        raise ValueError(f"FPS kernel needs a CUDA tensor, got {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(
            f"FPS kernel needs float32 (B, N, 3), got {xyz.dtype} {tuple(xyz.shape)}"
        )
    if not xyz.is_contiguous():
        raise ValueError("FPS kernel needs a contiguous xyz")
    b, n, _ = xyz.shape
    if not (1 <= n <= MAX_POINTS) or not (1 <= npoint <= n) or b < 1:
        raise ValueError(
            f"FPS kernel takes 1 <= npoint <= N <= {MAX_POINTS} and B >= 1, "
            f"got B={b} N={n} npoint={npoint}"
        )
    if isinstance(start_idx, torch.Tensor):
        bad = bool(((start_idx < 0) | (start_idx >= n)).any())
    else:
        bad = not 0 <= start_idx < n
    if bad:
        raise ValueError(f"FPS start indices must lie in [0, {n})")
    start = start_indices(b, start_idx, xyz.device).to(torch.int32)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    fn = _build.function("p2c_fps", _ARGTYPES)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    status = fn(xyz.data_ptr(), start.data_ptr(), out.data_ptr(), b, n, npoint,
                stream)
    farthest_point_sample_kernel.launches += 1
    _build.check("p2c_fps", status)
    return out


farthest_point_sample_kernel.launches = 0  # kernel launches, for chip_smoke.py


def farthest_point_sample(
    xyz: torch.Tensor, npoint: int, start_idx: int | torch.Tensor = 0
) -> torch.Tensor:
    """Iterative FPS: the kernel for a CUDA tensor, the plain version for a
    CPU tensor. Returns (B, npoint) int32 indices."""
    if xyz.device.type == "cpu":
        return farthest_point_sample_plain(xyz, npoint, start_idx)
    return farthest_point_sample_kernel(xyz, npoint, start_idx)
