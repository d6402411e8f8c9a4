"""Ordered per-target sums (``csrc/target_sum.cu``): the launch plan and
the checks that the 3-NN backward (``ops/cuda_knn.py``) and the SA2
gather's backward (``ops/cuda_ballquery.py``) share.

Both sum, for every target row of a cloud, the rows of the entries that
point at it: the 3 source entries of each destination point at 3-NN
(weighted), the slots of each ball at SA2. A CTA owns a few targets of
one cloud, lists their entries in ascending order in shared memory (a
bitmap of the entries for each target), and warps sum each target's list
in that order, so the result
is the float32 sum from 0 in entry order (``np.add.at`` on the host), the
same on every run, with no atomics and no fill of the output.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from point2cyl_torch.ops import _build

SMEM_LIMIT = 232448  # bytes of shared memory a block may opt into on sm_90
H100_SMS = 132
MAX_TARGETS = 32  # targets a CTA owns, at most (csrc/target_sum_layout.cuh kSumMaxTargets)
MAX_WARPS = 16  # warps a CTA, at most (kSumMaxWarps)
MAX_WINDOW = 65536  # entries a window: list entries are uint16 (kSumMaxWindow)

# g, idx, w, out; b, n, s, c; g_batch, g_row; per_cta, warps, window; stream
_ARGS_THREE_NN = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# idx, dg, out; b, rows, n, w; dg_batch, dg_row; per_cta, warps, window; stream
_ARGS_GROUP = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
               + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round16(x: int) -> int:
    return _cdiv(x, 16) * 16


# sum_window, the bitmap's words and sum_smem are those of
# csrc/target_sum_layout.cuh; tests/test_torch_ops.py compiles that header
# and holds the two equal.


def sum_window(entries: int, windows: int) -> int:
    """Entries of each of a cloud's ``windows`` windows (the last may be
    shorter): a multiple of 4."""
    return _cdiv(_cdiv(entries, windows), 4) * 4


def sum_bitmap_words(window: int) -> int:
    """Words of a target's bitmap of the window: a pad word after each
    lane's run of 2^sh words."""
    nw = _cdiv(window, 32)
    sh = 0
    while (32 << sh) < nw:
        sh += 1
    return nw + (nw >> sh) + 1


def sum_summary_words(window: int) -> int:
    """Words of a target's summary: a bit for each bitmap word that is not
    zero."""
    return _cdiv(_cdiv(window, 32), 32)


def sum_smem(window: int, targets: int) -> int:
    """Shared memory of a CTA: each target's bitmap of the window and its
    summary (uint32), the lists (uint16, room for the whole window in one
    target), each target's count and list start, and the count of items
    taken (int32)."""
    return (_round16(4 * targets * (sum_bitmap_words(window) + sum_summary_words(window)))
            + _round16(2 * window) + _round16(4 * (2 * targets + 2)))


class ScatterPlan(NamedTuple):
    """How an ordered per-target sum is launched over a cloud."""

    targets: int  # targets a CTA owns, at most (ctas apart)
    warps: int    # warps a CTA
    window: int   # entries a CTA lists at a time
    windows: int  # windows a cloud's entries take
    ctas: int     # CTAs a cloud: a power of two
    smem: int     # bytes of dynamic shared memory a CTA


def scatter_plan(
    b: int, targets: int, entries: int, *, num_sms: int = H100_SMS,
    per_cta: int | None = None, warps: int | None = None,
) -> ScatterPlan | None:
    """The launch of a sum over B clouds of ``targets`` target rows and
    ``entries`` entries each; None where there is none (B outside 1..65535,
    no target or entry, or an override out of range).

    Targets a CTA: the largest power of two up to MAX_TARGETS that still
    gives at least 3/4 of num_sms CTAs (at B=4: 16 at FP1 and SA2, 4 at
    FP2; 128 CTAs each). A CTA takes targets that many CTAs apart (CTAs a
    cloud: the next power of two). Warps a CTA: MAX_WARPS (the most work
    in flight; PERF.md). Windows: as few as fit shared memory with room for every
    entry of a window in one target's list (the worst skew), at most
    MAX_WINDOW entries each: one window up to about 37,000 entries at 32
    targets a CTA, 55,000 at 16.
    ``per_cta`` and ``warps`` override the choice (``kernel_sweep.py``).
    """
    if not (1 <= b <= 65535 and targets >= 1 and 1 <= entries < 2**31):
        return None
    if per_cta is None:
        per_cta = MAX_TARGETS
        while per_cta > 1 and b * _cdiv(targets, per_cta) < num_sms * 3 // 4:
            per_cta //= 2
    warps = MAX_WARPS if warps is None else warps
    if not (1 <= per_cta <= MAX_TARGETS and 1 <= warps <= MAX_WARPS):
        return None
    windows = _cdiv(entries, MAX_WINDOW)
    while (sum_window(entries, windows) > MAX_WINDOW
           or sum_smem(sum_window(entries, windows), per_cta) > SMEM_LIMIT):
        windows += 1
    window = sum_window(entries, windows)
    # csrc/target_sum.cu:cta_shift
    ctas = 1 << (_cdiv(targets, per_cta) - 1).bit_length()
    return ScatterPlan(per_cta, warps, window, windows, ctas, sum_smem(window, per_cta))


def plan_or_raise(name: str, b: int, targets: int, entries: int, *,
                  num_sms: int = H100_SMS) -> ScatterPlan:
    """:func:`scatter_plan`; raises ValueError where the shapes have none."""
    plan = scatter_plan(b, targets, entries, num_sms=num_sms)
    if plan is None:
        raise ValueError(f"{name}: no launch plan for B={b}, {targets} targets, "
                         f"{entries} entries a cloud")
    return plan


def check_rows(name: str, ptr: int, shape: tuple[int, ...], strides: tuple[int, ...],
               merge: int) -> None:
    """Check that the kernel can read a (B, *rows, C) float32 tensor at
    ``ptr`` whose ``merge`` row dimensions it takes as one: row r of batch
    b at ``ptr + b * strides[0] + r * strides[merge]``, its C channels
    adjacent. Raises ValueError where the strides do not allow that, or
    where ``ptr`` is not 4-byte aligned."""
    if len(shape) != merge + 2 or len(strides) != len(shape):
        raise ValueError(f"{name}: expected {merge + 2} dimensions, got {tuple(shape)}")
    if shape[-1] > 1 and strides[-1] != 1:
        raise ValueError(f"{name}: the channels must be adjacent (stride 1), got "
                         f"strides {tuple(strides)}")
    for d in range(1, merge):
        # an outer row dimension steps over the inner one exactly
        if shape[d] > 1 and strides[d] != shape[d + 1] * strides[d + 1]:
            raise ValueError(f"{name}: dimensions 1..{merge} must merge into one "
                             f"row stride, got strides {tuple(strides)}")
    if ptr % 4:
        raise ValueError(f"{name}: data at {ptr:#x} is not 4-byte aligned")


def rows_readable(t: torch.Tensor, merge: int) -> bool:
    """Whether the kernels can read ``t``'s rows as they lie (the
    Functions copy a cotangent to contiguous memory only where not)."""
    try:
        check_rows("", t.data_ptr(), tuple(t.shape), t.stride(), merge)
    except ValueError:
        return False
    return True


def launch_three_nn(idx: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                    out: torch.Tensor, plan: ScatterPlan) -> None:
    """Launch ``p2c_three_nn_backward`` at ``plan`` on tensors that
    ``ops/cuda_knn.py:three_nn_backward_kernel`` checked: g (B, N, C) with
    adjacent channels, idx and weight (B, N, 3), out (B, S, C). Raises
    RuntimeError on a CUDA error."""
    b, n, c = g.shape
    fn = _build.function("p2c_three_nn_backward", _ARGS_THREE_NN)
    status = fn(g.data_ptr(), idx.data_ptr(), weight.data_ptr(), out.data_ptr(), b, n,
                out.shape[1], c, g.stride(0), g.stride(1), plan.targets, plan.warps,
                plan.window, torch.cuda.current_stream(g.device).cuda_stream)
    _build.check("p2c_three_nn_backward", status)


def launch_group(idx: torch.Tensor, dg: torch.Tensor, out: torch.Tensor,
                 plan: ScatterPlan) -> None:
    """Launch ``p2c_sa_grouped_backward`` at ``plan`` on tensors that
    ``ops/cuda_ballquery.py:sa_grouped_backward_kernel`` checked: dg (B, S,
    nsample, W) with adjacent channels and evenly spaced rows, idx (B, S,
    nsample), out (B, N, W). Raises RuntimeError on a CUDA error."""
    b, s, k, w = dg.shape
    fn = _build.function("p2c_sa_grouped_backward", _ARGS_GROUP)
    status = fn(idx.data_ptr(), dg.data_ptr(), out.data_ptr(), b, s * k, out.shape[1], w,
                dg.stride(0), dg.stride(2), plan.targets, plan.warps, plan.window,
                torch.cuda.current_stream(dg.device).cuda_stream)
    _build.check("p2c_sa_grouped_backward", status)
