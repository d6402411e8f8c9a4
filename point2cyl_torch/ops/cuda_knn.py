"""3-NN inverse-distance interpolation: the CUDA kernel
(``csrc/knn3.cu``) and its plain version.

:func:`three_nn_interpolate` takes the plain version
(:func:`three_nn_interpolate_plain`, ``ops/grouping.py``) for CPU tensors
and launches the kernel for CUDA tensors; a CUDA input the kernel does not
take raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from point2cyl_torch.ops import _build
from point2cyl_torch.ops.grouping import three_nn_interpolate_plain

__all__ = ["three_nn_interpolate", "three_nn_interpolate_kernel",
           "three_nn_interpolate_plain"]

MAX_SOURCES = 19370  # source coordinates staged in 227 KB of shared memory

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])


def three_nn_interpolate_kernel(
    xyz_dst: torch.Tensor,
    xyz_src: torch.Tensor,
    feats_src: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Launch the 3-NN kernel; ``.launches`` counts the launches.

    xyz_dst (B, N, 3), xyz_src (B, S, 3), feats_src (B, S, C): float32,
    contiguous, on one CUDA device. Returns (B, N, C).
    """
    named = {"xyz_dst": xyz_dst, "xyz_src": xyz_src, "feats_src": feats_src}
    for key, t in named.items():
        if t.device.type != "cuda" or t.device != xyz_dst.device:
            raise ValueError(f"3-NN kernel: {key} must be on the same CUDA device, "
                             f"got {t.device}")
        if t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"3-NN kernel: {key} must be contiguous float32 "
                             f"(B, M, C), got {t.dtype} {tuple(t.shape)}")
    b, n, _ = xyz_dst.shape
    s = xyz_src.shape[1]
    c = feats_src.shape[2]
    if (xyz_dst.shape[2] != 3 or xyz_src.shape[2] != 3
            or xyz_src.shape[0] != b or feats_src.shape[:2] != (b, s)):
        raise ValueError("3-NN kernel: shapes must be (B, N, 3), (B, S, 3), (B, S, C)")
    if not 3 <= s <= MAX_SOURCES or not 1 <= b <= 65535:
        raise ValueError(f"3-NN kernel takes 3 <= S <= {MAX_SOURCES} and "
                         f"1 <= B <= 65535, got S={s} B={b}")
    out = torch.empty((b, n, c), dtype=torch.float32, device=xyz_dst.device)
    fn = _build.function("p2c_three_nn_interpolate", _ARGTYPES)
    stream = torch.cuda.current_stream(xyz_dst.device).cuda_stream
    status = fn(xyz_dst.data_ptr(), xyz_src.data_ptr(), feats_src.data_ptr(),
                out.data_ptr(), b, n, s, c, eps, stream)
    three_nn_interpolate_kernel.launches += 1
    _build.check("p2c_three_nn_interpolate", status)
    return out


three_nn_interpolate_kernel.launches = 0  # kernel launches, for chip_smoke.py


def three_nn_interpolate(
    xyz_dst: torch.Tensor,
    xyz_src: torch.Tensor,
    feats_src: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """3-NN interpolation: the kernel for CUDA tensors, the plain version
    for CPU tensors. Returns (B, N, C)."""
    if xyz_dst.device.type == "cpu":
        return three_nn_interpolate_plain(xyz_dst, xyz_src, feats_src, eps)
    return three_nn_interpolate_kernel(xyz_dst, xyz_src, feats_src, eps)
