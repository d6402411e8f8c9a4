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
onto the point table (``d_xyz[b, idx] += dg``, a kernel too: at SA2 the
ordered per-target sums of ``ops/cuda_scatter.py``) and sends
``-sum_slots dg[..., :3]`` to the centres; the indices carry no gradient.
Under ``inference_mode`` nothing is saved and no backward launches.

All select exactly at every N (the first ``nsample`` in-radius indices in
ascending order, padded with the first). A CPU tensor takes the plain
version, forward and backward; a CUDA tensor the kernel; a CUDA input the
kernel does not take raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from point2cyl_torch.ops import _build, cuda_scatter
from point2cyl_torch.ops.grouping import (ball_query_plain, group_points,
                                          group_scatter_plain, radius_squared)

SMEM_LIMIT = 232448  # bytes of shared memory a block may opt into on sm_90
H100_SMS = 132
MAX_CELLS = 4096  # cells of a row's grid, at most (csrc/ballquery.cu kMaxCells)
GRID_HEADER = 1024  # bytes ahead of the grid kernel's planes (kGridHeader)
GRID_CAP = 1024  # candidates a query tests through the grid before it scans
GRID_MIN_WARPS = 4  # fewer warps than this build a grid too slowly
SA2_WARPS = 16  # warps of an SA2 CTA

_ARGS_IDX = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_ARGS_GROUPED = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_ARGS_FEATURES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_ARGS_SCATTER3 = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round16(x: int) -> int:
    return _cdiv(x, 16) * 16


# The shared-memory totals below are those of csrc/ballquery_layout.cuh;
# tests/test_torch_ops.py compiles that header and holds the two equal.


def _bitmap_words(n: int) -> int:
    """Words of a warp's N-bit bitmap in the grid kernel
    (``bitmap_words``): a pad word after each lane's run of 2^sh words."""
    nw = _cdiv(n, 32)
    sh = 0
    while (32 << sh) < nw:
        sh += 1
    return nw + (nw >> sh) + 1


def _grid_smem(n: int, nsample: int, warps: int) -> int:
    """Shared memory of the grid kernel (``grid_smem``):
    header, the x|y|z planes, a region for the points' codes or each
    warp's bitmap and slots (whichever is larger), the cell offsets and
    the cell-sorted uint16 list."""
    n4 = _cdiv(n, 4) * 4
    region = _round16(max(4 * n4, 4 * warps * (_bitmap_words(n) + nsample)))
    return GRID_HEADER + 14 * n4 + region + 4 * (MAX_CELLS + 4)


def _scan_smem(n: int, nsample: int, warps: int) -> int:
    """Shared memory of the scan kernel (``scan_smem``):
    planes and a warp's slots."""
    return 12 * _cdiv(n, 4) * 4 + 4 * warps * nsample


def _sa_smem(n: int, nsample: int, c: int, warps: int, store: str) -> int:
    """Shared memory of the SA2 kernel (``sa_smem``):
    planes, a warp's slots and query centre, and for the bulk store two
    blocks of ``nsample * (3 + c)`` floats."""
    smem = 12 * _cdiv(n, 4) * 4 + _round16(4 * warps * nsample) + 16 * warps
    if store == "bulk":
        smem += 8 * nsample * (3 + c)
    return smem


# how the SA2 kernel writes a query's grouped block (enum Store of
# csrc/ballquery_layout.cuh): 4-byte stores, or one bulk copy a block
_STORES = ("scalar", "bulk")


class BallQueryPlan(NamedTuple):
    """How a ball-query kernel is launched over a batch row."""

    select: str  # "grid": a cell grid of the row in shared memory; "scan": index order
    store: str   # SA2: one of _STORES; SA1: "coords"; idx only: "none"
    ctas: int    # CTAs a batch row
    warps: int   # warps a CTA
    cap: int     # grid: most candidates a query tests before it scans instead
    smem: int    # bytes of dynamic shared memory a CTA


def _scan_plan(s: int, n: int, nsample: int, store: str) -> BallQueryPlan | None:
    # a warp a query, 32 warps a CTA above N=1024 (8 below), fewer where
    # the slots would not fit beside the planes
    warps = 32 if n > 1024 else 8
    while warps > 1 and _scan_smem(n, nsample, warps) > SMEM_LIMIT:
        warps //= 2
    smem = _scan_smem(n, nsample, warps)
    if smem > SMEM_LIMIT:
        return None
    return BallQueryPlan("scan", store, _cdiv(s, warps), warps, 0, smem)


def ball_query_plan(
    b: int, n: int, s: int, nsample: int, c: int | None = None, *,
    gather: bool = True, num_sms: int = H100_SMS, ctas: int | None = None,
    warps: int | None = None, cap: int = GRID_CAP, store: str | None = None,
) -> BallQueryPlan | None:
    """The launch of a ball query over B rows of N points, S queries and
    ``nsample`` slots; None where no route fits shared memory.

    - ``gather=False``: the idx-only kernel, an index-order scan, a warp a
      query.
    - ``c is None`` (SA1's gather, coordinates only): the cell grid where
      the row's grid fits, with about num_sms / B CTAs a row so that the
      card fills in one wave (8 at B=16, 33 at B=4), but no more than at
      B=4 (33 at B=1 too), and as many warps a CTA as it has queries, at
      most 32; fewer warps where the grid would not fit, down to
      GRID_MIN_WARPS; the index-order scan (a warp a query) above that.
    - ``c`` features (SA2): the index-order scan, each CTA taking its
      queries in rounds of one a warp (each warp selects one, then all
      write the round's rows): each query's block composed in shared
      memory and sent with one bulk copy ("bulk", wherever its two
      buffers fit), else (or on request) written with 4-byte stores
      ("scalar"). Where the alignment the bulk copy needs is missing, the
      kernel takes the 4-byte stores. SA2_WARPS warps a CTA (fewer where
      the shared memory would not fit) and 2 x num_sms / B CTAs a row (16
      at B=16, 66 at B=4), at most S.

    ``ctas``, ``warps``, ``cap`` and ``store`` override the choice
    (``kernel_sweep.py``); an override that does not fit gives None.
    """
    if not gather:
        return _scan_plan(s, n, nsample, "none")
    if c is None:
        if store not in (None, "coords"):
            return None
        # at most num_sms / 4 CTAs a row: each CTA builds the whole row's
        # grid, and below B=4 more CTAs repeat that build for fewer queries
        # (PERF.md: 33 CTAs beat 132 at B=1)
        ctas = ctas or max(1, min(num_sms // max(b, 4), s))
        fixed = warps is not None
        warps = warps or min(32, _cdiv(s, ctas))
        while (not fixed and warps > GRID_MIN_WARPS
               and _grid_smem(n, nsample, warps) > SMEM_LIMIT):
            warps = max(GRID_MIN_WARPS, warps // 2)
        smem = _grid_smem(n, nsample, warps)
        if n <= 65535 and smem <= SMEM_LIMIT:
            return BallQueryPlan("grid", "coords", ctas, warps, cap, smem)
        return None if fixed else _scan_plan(s, n, nsample, "coords")
    if store is None:
        store = "bulk" if _sa_smem(n, nsample, c, 1, "bulk") <= SMEM_LIMIT else "scalar"
    fixed = warps is not None
    warps = warps or SA2_WARPS
    while not fixed and warps > 1 and _sa_smem(n, nsample, c, warps, store) > SMEM_LIMIT:
        warps //= 2
    smem = _sa_smem(n, nsample, c, warps, store)
    if smem > SMEM_LIMIT or store not in _STORES:
        return None
    return BallQueryPlan("scan", store, ctas or max(1, min(s, 2 * num_sms // b)), warps, 0,
                         smem)


def plan_or_raise(name: str, b: int, n: int, s: int, nsample: int,
                  plan: BallQueryPlan | None = None, **plan_args) -> BallQueryPlan:
    """``plan``, or :func:`ball_query_plan` with ``plan_args``; raises
    ValueError where the shapes have none."""
    if not (1 <= nsample <= n) or not 1 <= b <= 65535:
        raise ValueError(f"{name}: needs 1 <= nsample <= N and 1 <= B <= 65535, "
                         f"got nsample={nsample} N={n} B={b}")
    if plan is None:
        plan = ball_query_plan(b, n, s, nsample, **plan_args)
    if plan is None:
        raise ValueError(f"{name}: N={n}, nsample={nsample} exceed shared memory")
    return plan


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _check_inputs(name: str, nsample: int, tensors: dict[str, torch.Tensor],
                  plan: BallQueryPlan | None = None, **plan_args) -> BallQueryPlan:
    """Check the tensors a launch takes and return its plan
    (:func:`plan_or_raise`)."""
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
    return plan_or_raise(name, b, n, tensors["new_xyz"].shape[1], nsample, plan,
                         num_sms=_num_sms(first.device.index), **plan_args)


def ball_query_kernel(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """Launch the idx-only kernel; ``.launches`` counts the launches."""
    plan = _check_inputs("ball_query", nsample, {"xyz": xyz, "new_xyz": new_xyz},
                         gather=False)
    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    idx = torch.empty((b, s, nsample), dtype=torch.int32, device=xyz.device)
    fn = _build.function("p2c_ball_query", _ARGS_IDX)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    status = fn(xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(), b, n, s,
                nsample, radius_squared(radius), plan.ctas, plan.warps, stream)
    ball_query_kernel.launches += 1
    _build.check("p2c_ball_query", status)
    return idx


ball_query_kernel.launches = 0  # kernel launches, for chip_smoke.py


def ball_query_grouped_kernel(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
    plan: BallQueryPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the SA1 kernel; ``.launches`` counts the launches. ``plan``
    overrides :func:`ball_query_plan`."""
    plan = _check_inputs("ball_query_grouped", nsample, {"xyz": xyz, "new_xyz": new_xyz},
                         plan)
    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    idx = torch.empty((b, s, nsample), dtype=torch.int32, device=xyz.device)
    grouped = torch.empty((b, s, nsample, 3), dtype=torch.float32, device=xyz.device)
    fn = _build.function("p2c_ball_query_grouped", _ARGS_GROUPED)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    status = fn(xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(),
                grouped.data_ptr(), b, n, s, nsample,
                radius_squared(radius), int(plan.select == "grid"), plan.ctas,
                plan.warps, plan.cap, stream)
    ball_query_grouped_kernel.launches += 1
    _build.check(f"p2c_ball_query_grouped ({plan.select})", status)
    return idx, grouped


ball_query_grouped_kernel.launches = 0  # kernel launches, for chip_smoke.py


def sa_grouped_exact_kernel(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    feats: torch.Tensor,
    new_xyz: torch.Tensor,
    plan: BallQueryPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the SA2 kernel; ``.launches`` counts the launches. ``plan``
    overrides :func:`ball_query_plan`."""
    c = feats.shape[2] if feats.dim() == 3 else 0
    plan = _check_inputs("sa_grouped_exact", nsample,
                         {"xyz": xyz, "feats": feats, "new_xyz": new_xyz}, plan, c=c)
    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    if feats.shape[1] != n or c < 1:
        raise ValueError("sa_grouped_exact: feats must be (B, N, C >= 1) beside xyz")
    idx = torch.empty((b, s, nsample), dtype=torch.int32, device=xyz.device)
    grouped = torch.empty((b, s, nsample, 3 + c), dtype=torch.float32,
                          device=xyz.device)
    fn = _build.function("p2c_sa_grouped_features", _ARGS_FEATURES)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    status = fn(xyz.data_ptr(), feats.data_ptr(), new_xyz.data_ptr(),
                idx.data_ptr(), grouped.data_ptr(), b, n, s, nsample, c,
                radius_squared(radius), _STORES.index(plan.store), plan.ctas,
                plan.warps, stream)
    sa_grouped_exact_kernel.launches += 1
    _build.check(f"p2c_sa_grouped_features ({plan.store})", status)
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
    summed onto a (B, n, 3 + C) table at ``idx``, each row's terms in
    ascending (query, slot) order (``csrc/target_sum.cu``);
    ``.launches`` counts the launches. ``dg``'s channels must be adjacent
    and its (S, nsample) rows evenly spaced."""
    name = "sa_grouped_backward"
    if dg.dim() != 4 or dg.dtype != torch.float32:
        raise ValueError(f"{name}: dg must be float32 (B, S, nsample, W), got "
                         f"{dg.dtype} {tuple(dg.shape)}")
    cuda_scatter.check_rows(f"{name}: dg", dg.data_ptr(), tuple(dg.shape), dg.stride(), 2)
    for key, t in (("idx", idx), ("dg", dg)):
        if t.device.type != "cuda" or t.device != dg.device:
            raise ValueError(f"{name}: {key} must be on the same CUDA device, got {t.device}")
    if (idx.dtype != torch.int32 or idx.dim() != 3 or not idx.is_contiguous()
            or dg.shape[:3] != idx.shape or n < 1):
        raise ValueError(f"{name}: idx must be contiguous int32 (B, S, nsample) over dg "
                         f"{tuple(dg.shape)} and N >= 1, got {idx.dtype} "
                         f"{tuple(idx.shape)} N={n}")
    b, w = idx.shape[0], dg.shape[3]
    entries = idx.shape[1] * idx.shape[2]
    plan = cuda_scatter.plan_or_raise(name, b, n, entries, num_sms=_num_sms(dg.device.index))
    out = torch.empty((b, n, w), dtype=torch.float32, device=dg.device)
    cuda_scatter.launch_group(idx, dg, out, plan)
    sa_grouped_backward_kernel.launches += 1
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
            if dg.device.type == "cpu":
                table = group_scatter_plain(idx, dg, ctx.n)
            else:
                if not cuda_scatter.rows_readable(dg, 2):
                    dg = dg.contiguous()
                table = sa_grouped_backward_kernel(idx, dg, ctx.n)
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
