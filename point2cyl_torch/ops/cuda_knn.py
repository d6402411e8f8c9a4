"""3-NN inverse-distance interpolation: the CUDA kernels
(``csrc/knn3.cu``), their plain versions, and the autograd Function that
carries the feature gradient through them.

:func:`three_nn_interpolate` is :class:`ThreeNNInterpolate`. Its forward
takes the plain version (``ops/grouping.py``) for CPU tensors and launches
the kernel for CUDA tensors; when ``feats_src`` needs a gradient the
forward also keeps each point's 3 source indices and weights, and the
backward scatters ``d_feats_src = W^T g`` from them (a kernel on the
card). The position cotangents are zero by design, as in JAX
(``pallas_knn.py:182-188, 248-252``): coordinates never depend on
parameters. A CUDA input the kernel does not take raises; there is no
fallback between kernel and plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from point2cyl_torch.ops import _build, cuda_scatter
from point2cyl_torch.ops.grouping import (three_nn_backward_plain,
                                          three_nn_combine_plain,
                                          three_nn_interpolate_plain,
                                          three_nn_weights_plain)

__all__ = ["ThreeNNInterpolate", "three_nn_backward_kernel",
           "three_nn_backward_plain", "three_nn_interpolate",
           "three_nn_interpolate_kernel", "three_nn_interpolate_plain",
           "three_nn_lanes"]

MAX_SOURCES = 19370  # source coordinates staged in 227 KB of shared memory

H100_SMS = 132

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check_cuda(name: str, named: dict[str, torch.Tensor], dtype=torch.float32) -> None:
    first = next(iter(named.values()))
    for key, t in named.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name}: {key} must be on the same CUDA device, "
                             f"got {t.device}")
        if t.dtype != dtype or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {dtype} "
                             f"(B, M, C), got {t.dtype} {tuple(t.shape)}")


def three_nn_lanes(b: int, n: int, num_sms: int = H100_SMS) -> int:
    """Threads that search for one destination point (1, 2 or 4): the
    fewest that give every SM at least 12 warps of searching threads, so
    that a small batch still fills the card (each of L lanes scans every
    L-th 4-source chunk and the L lists are merged). On the H100 that is
    1 at FP1 and B=16, 2 at FP1 and B=4, and 4 at FP2 (PERF.md)."""
    for lanes in (1, 2):
        if b * n * lanes >= num_sms * 12 * 32:
            return lanes
    return 4


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def three_nn_interpolate_kernel(
    xyz_dst: torch.Tensor,
    xyz_src: torch.Tensor,
    feats_src: torch.Tensor,
    eps: float = 1e-8,
    weights_out: tuple[torch.Tensor, torch.Tensor] | None = None,
    lanes: int | None = None,
) -> torch.Tensor:
    """Launch the 3-NN kernel; ``.launches`` counts the launches.

    xyz_dst (B, N, 3), xyz_src (B, S, 3), feats_src (B, S, C): float32,
    contiguous, on one CUDA device. Returns (B, N, C). ``weights_out``,
    an (idx int32, w float32) pair of (B, N, 3) tensors, is filled with
    each point's 3 sources and weights for the backward. ``lanes``
    overrides :func:`three_nn_lanes`.
    """
    _check_cuda("3-NN kernel", {"xyz_dst": xyz_dst, "xyz_src": xyz_src,
                                "feats_src": feats_src})
    b, n, _ = xyz_dst.shape
    s = xyz_src.shape[1]
    c = feats_src.shape[2]
    if (xyz_dst.shape[2] != 3 or xyz_src.shape[2] != 3
            or xyz_src.shape[0] != b or feats_src.shape[:2] != (b, s)):
        raise ValueError("3-NN kernel: shapes must be (B, N, 3), (B, S, 3), (B, S, C)")
    if not 3 <= s <= MAX_SOURCES or not 1 <= b <= 65535:
        raise ValueError(f"3-NN kernel takes 3 <= S <= {MAX_SOURCES} and "
                         f"1 <= B <= 65535, got S={s} B={b}")
    idx_ptr = w_ptr = None
    if weights_out is not None:
        idx, w = weights_out
        if (idx.dtype != torch.int32 or w.dtype != torch.float32
                or idx.shape != (b, n, 3) or w.shape != (b, n, 3)
                or not idx.is_contiguous() or not w.is_contiguous()
                or idx.device != xyz_dst.device or w.device != xyz_dst.device):
            raise ValueError("3-NN kernel: weights_out must be contiguous int32 "
                             f"and float32 ({b}, {n}, 3) on {xyz_dst.device}")
        idx_ptr, w_ptr = idx.data_ptr(), w.data_ptr()
    if lanes is None:
        lanes = three_nn_lanes(b, n, _num_sms(xyz_dst.device.index))
    out = torch.empty((b, n, c), dtype=torch.float32, device=xyz_dst.device)
    fn = _build.function("p2c_three_nn_interpolate", _ARGTYPES)
    stream = torch.cuda.current_stream(xyz_dst.device).cuda_stream
    status = fn(xyz_dst.data_ptr(), xyz_src.data_ptr(), feats_src.data_ptr(),
                out.data_ptr(), idx_ptr, w_ptr, b, n, s, c, eps, lanes, stream)
    three_nn_interpolate_kernel.launches += 1
    _build.check("p2c_three_nn_interpolate", status)
    return out


three_nn_interpolate_kernel.launches = 0  # kernel launches, for chip_smoke.py


def three_nn_backward_kernel(
    idx: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, s: int
) -> torch.Tensor:
    """Launch the 3-NN backward: ``W^T g`` (B, S, C) from the forward's
    ``idx`` (B, N, 3) int32 and ``weight`` (B, N, 3) and the output
    cotangent ``g`` (B, N, C), each source's terms summed in ascending
    (point, k) order (``csrc/target_sum.cu``); ``.launches`` counts the
    launches. ``g`` may be any view whose channels are adjacent (FP2's is
    a slice of a concatenation's gradient): the kernel reads its rows
    through their stride."""
    if g.dim() != 3 or g.dtype != torch.float32:
        raise ValueError(f"3-NN backward: g must be float32 (B, N, C), got {g.dtype} "
                         f"{tuple(g.shape)}")
    cuda_scatter.check_rows("3-NN backward: g", g.data_ptr(), tuple(g.shape), g.stride(), 1)
    if g.device.type != "cuda":
        raise ValueError(f"3-NN backward: g must be on a CUDA device, got {g.device}")
    _check_cuda("3-NN backward", {"weight": weight})
    _check_cuda("3-NN backward", {"idx": idx}, dtype=torch.int32)
    b, n, c = g.shape
    if idx.shape != (b, n, 3) or weight.shape != (b, n, 3) or s < 1:
        raise ValueError(f"3-NN backward: idx and weight must be ({b}, {n}, 3) "
                         f"and S >= 1, got {tuple(idx.shape)} "
                         f"{tuple(weight.shape)} S={s}")
    if not idx.device == weight.device == g.device:
        raise ValueError("3-NN backward: idx, weight and g must be on one CUDA device")
    plan = cuda_scatter.plan_or_raise("3-NN backward", b, s, 3 * n,
                                      num_sms=_num_sms(g.device.index))
    out = torch.empty((b, s, c), dtype=torch.float32, device=g.device)
    cuda_scatter.launch_three_nn(idx, weight, g, out, plan)
    three_nn_backward_kernel.launches += 1
    return out


three_nn_backward_kernel.launches = 0  # kernel launches, for chip_smoke.py


class ThreeNNInterpolate(torch.autograd.Function):
    """3-NN interpolation with the feature cotangent ``W^T g`` (the JAX
    ``three_nn_interpolate_pallas`` custom VJP, ``pallas_knn.py:167-255``)."""

    @staticmethod
    def forward(ctx, xyz_dst, xyz_src, feats_src, eps):
        save = ctx.needs_input_grad[2]
        if xyz_dst.device.type == "cpu":
            idx, weight = three_nn_weights_plain(xyz_dst, xyz_src, eps)
            if save:
                ctx.save_for_backward(idx, weight)
            out = three_nn_combine_plain(feats_src, idx, weight)
        else:
            weights = None
            if save:
                shape = (*xyz_dst.shape[:2], 3)
                weights = (torch.empty(shape, dtype=torch.int32, device=xyz_dst.device),
                           torch.empty(shape, dtype=torch.float32, device=xyz_dst.device))
            out = three_nn_interpolate_kernel(xyz_dst, xyz_src, feats_src, eps,
                                              weights)
            if save:
                ctx.save_for_backward(*weights)
        ctx.s = xyz_src.shape[1]
        return out

    @staticmethod
    def backward(ctx, g):
        idx, weight = ctx.saved_tensors
        if g.device.type == "cpu":
            d_feats = three_nn_backward_plain(idx, weight, g, ctx.s)
        else:
            # FP2's g, a slice of the concatenation's gradient, is read in place
            if not cuda_scatter.rows_readable(g, 1):
                g = g.contiguous()
            d_feats = three_nn_backward_kernel(idx, weight, g, ctx.s)
        return None, None, d_feats, None


def three_nn_interpolate(
    xyz_dst: torch.Tensor,
    xyz_src: torch.Tensor,
    feats_src: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """3-NN interpolation, differentiable in ``feats_src``: the kernels
    for CUDA tensors, the plain versions for CPU tensors. Returns (B, N, C)."""
    return ThreeNNInterpolate.apply(xyz_dst, xyz_src, feats_src, eps)
