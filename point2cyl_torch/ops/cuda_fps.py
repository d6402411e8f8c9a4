"""Farthest point sampling: the CUDA kernels (``csrc/fps.cu`` up to
``MAX_POINTS`` points, ``csrc/fps_cluster.cu`` up to ``CLUSTER_CAPACITY``,
``csrc/fps_grid.cu`` above, and ``csrc/fps_ring.cu`` for one step over a
point-sharded cloud) and their plain versions.

:func:`farthest_point_sample` takes the plain version
(:func:`farthest_point_sample_plain`, ``ops/sampling.py``) for a CPU
tensor and launches a kernel for a CUDA tensor, by N; it raises on
anything the kernel does not take. There is no fallback between the
routes.

``fps.cu`` runs each cloud on a thread-block cluster of CTAs, each with a
copy of the whole cloud in shared memory; :func:`fps_launch_plan` picks
the cluster size and the threads per CTA from (B, N). Above, 8 points a
thread stay in registers and no CTA keeps a copy of the cloud.
``fps_cluster.cu`` (the cluster route) holds a cloud in one cluster of up
to 16 CTAs, which meet in distributed shared memory and nowhere else:
every record that crosses a CTA carries the candidate's coordinates.
``fps_grid.cu`` (the grid route) spreads a cloud over CTAs, all resident
at once, which meet once a step in a buffer zeroed a call.
:func:`fps_grid_plan` picks the route, the CTAs and the threads. The ring
step (``fps_ring.cu``, :func:`fps_ring_plan`) runs one cluster a cloud
whose CTAs meet in distributed shared memory. A start index is checked
without a host sync: on the host when it is a Python int or a CPU tensor
(``ValueError``), in the kernel when it is a CUDA tensor (a device-side
assert, reported as a ``RuntimeError`` at the next synchronising call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from point2cyl_torch.ops import _build
from point2cyl_torch.ops.sampling import (LOW32, farthest_point_sample_plain,
                                          fps_ring_step_plain, start_indices)

__all__ = ["farthest_point_sample", "farthest_point_sample_cluster_kernel",
           "farthest_point_sample_grid_kernel", "farthest_point_sample_kernel",
           "farthest_point_sample_plain", "fps_grid_plan", "FpsGridPlan", "fps_launch_plan",
           "fps_ring_plan", "FpsRingPlan", "fps_ring_step", "fps_ring_step_kernel",
           "fps_ring_step_plain"]

MAX_POINTS = 16384
MAX_POINTS_PER_THREAD = 8  # the kernel's register budget (fps.cu)
MAX_THREADS = 512
# fps.cu's clusters: 16 CTAs can be scheduled, but were slower in fps.cu at
# N <= 16,384 (its whole-cloud copies; fps_cluster.cu takes 16 above)
MAX_CLUSTER = 8
H100_SMS = 132

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_RING_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                  + [ctypes.c_void_p])
RING_MAX_CLUSTER = 16
RING_THREADS = 256
RING_MAX_THREADS = 512
RING_POINTS_PER_THREAD = 4
# the FPS kernels' limits and layouts above MAX_POINTS (csrc/fps_grid_layout.cuh)
GRID_MAX_THREADS = 1024
GRID_PPT = 8
GRID_REGS = 64
SM_REGS = 65536
GRID_MEET_WORDS = 32
CLUSTER_MAX_CTAS = 16
CLUSTER_CAPACITY = CLUSTER_MAX_CTAS * GRID_MAX_THREADS * GRID_PPT  # 131,072 points
# the cluster route's fewest threads a CTA (PERF.md, kernel_sweep.py --fps-large)
CLUSTER_MIN_THREADS = 256
_GRID_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fps_launch_plan(b: int, n: int, num_sms: int = H100_SMS) -> tuple[int, int]:
    """(cluster, threads): CTAs per cloud and threads per CTA.

    The largest power-of-two cluster up to 8 (2 for N <= 1024) whose
    B x cluster CTAs fit on the card's SMs at once, so that no cloud
    waits for another, and at least the CTAs that hold N at 8 points a
    thread; then the fewest threads, a power of two from 128 to 512, that
    hold the cloud's share at 8 points a thread. Fewer, fuller threads
    make a shorter step: an FPS step is a chain of latencies, not of
    throughput (PERF.md).
    """
    if b < 1 or not 1 <= n <= MAX_POINTS:
        raise ValueError(f"FPS plan needs B >= 1 and 1 <= N <= {MAX_POINTS}, "
                         f"got B={b} N={n}")
    max_cluster = 2 if n <= 1024 else MAX_CLUSTER
    cluster = 1
    while cluster < max_cluster and b * cluster * 2 <= num_sms:
        cluster *= 2
    cluster = max(cluster, _cdiv(n, MAX_THREADS * MAX_POINTS_PER_THREAD))
    share = _cdiv(_cdiv(n, cluster), MAX_POINTS_PER_THREAD)
    threads = 128
    while threads < share:
        threads *= 2
    return cluster, threads


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def farthest_point_sample_kernel(
    xyz: torch.Tensor, npoint: int, start_idx: int | torch.Tensor = 0,
    plan: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Launch the FPS kernel; ``.launches`` counts the launches.

    xyz (B, N, 3) float32 contiguous on CUDA. Returns (B, npoint) int32.
    ``plan`` (cluster, threads) overrides :func:`fps_launch_plan`.
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
    start = start_indices(b, n, start_idx, xyz.device, torch.int32)
    if plan is None:
        plan = fps_launch_plan(b, n, _num_sms(xyz.device.index))
    cluster, threads = plan
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    fn = _build.function("p2c_fps", _ARGTYPES)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    with torch.cuda.device(xyz.device):  # the runtime launches on the current device
        status = fn(xyz.data_ptr(), start.data_ptr(), out.data_ptr(), b, n, npoint,
                    cluster, threads, stream)
    farthest_point_sample_kernel.launches += 1
    _build.check(f"p2c_fps (cluster {cluster}, {threads} threads)", status)
    return out


farthest_point_sample_kernel.launches = 0  # kernel launches, for chip_smoke.py


def grid_blocks_per_sm(threads: int) -> int:
    """CTAs of ``threads`` threads one SM holds at once, by registers
    (``grid_blocks_per_sm``)."""
    return SM_REGS // (GRID_REGS * threads)


def grid_streamed(n: int, ctas: int, threads: int) -> int:
    """Points of a cloud beyond the plan's registers (``grid_streamed``)."""
    return max(0, n - ctas * threads * GRID_PPT)


class FpsGridPlan(NamedTuple):
    """How a kernel above ``MAX_POINTS`` points is launched over a batch."""

    route: str     # "cluster" (fps_cluster.cu, one cluster a cloud) or "grid" (fps_grid.cu)
    ctas: int      # CTAs a cloud: the cluster's size on the cluster route
    threads: int   # threads a CTA, each holding GRID_PPT points in registers
    streamed: int  # points a cloud beyond the registers, read every step (grid)


def fps_grid_plan(b: int, n: int, num_sms: int = H100_SMS,
                  route: str | None = None) -> FpsGridPlan:
    """The launch over B clouds of N points above ``MAX_POINTS``: the
    cluster route up to ``CLUSTER_CAPACITY`` points, the grid route above
    (``route`` forces one).

    Cluster route: the fewest threads a CTA, a power of two from
    ``CLUSTER_MIN_THREADS``, with which 16 CTAs hold the cloud at
    ``GRID_PPT`` points a thread, then the fewest CTAs, a power of two
    from 2, that hold it. Clusters need not be resident together, so any
    B runs, in waves. Grid route: every CTA must be resident at once (the
    steps meet in global memory): ``GRID_MAX_THREADS`` threads a CTA,
    halved while B clouds of one CTA would not fit (``num_sms`` x
    :func:`grid_blocks_per_sm`); CTAs a cloud: those that hold the cloud
    at ``GRID_PPT`` points a thread (the slots past its end hold copies
    that never win), at most the card's share of one cloud. Where those
    registers do not hold the cloud (large B at large N), the points
    beyond stream from global memory every step, their running distances
    in a (B, streamed) scratch array. Raises ValueError for an empty batch
    or cloud, a cloud beyond the cluster route, or B clouds that cannot be
    resident at once.
    """
    if b < 1 or n < 1:
        raise ValueError(f"FPS plan needs B >= 1 and N >= 1, got B={b} N={n}")
    if route is None:
        route = "cluster" if n <= CLUSTER_CAPACITY else "grid"
    if route == "cluster":
        if n > CLUSTER_CAPACITY:
            raise ValueError(f"cluster FPS: N={n} exceeds one cluster's {CLUSTER_CAPACITY} "
                             "points")
        threads = CLUSTER_MIN_THREADS
        while CLUSTER_MAX_CTAS * threads * GRID_PPT < n:
            threads *= 2
        ctas = 2
        while ctas * threads * GRID_PPT < n:
            ctas *= 2
        return FpsGridPlan("cluster", ctas, threads, 0)
    if route != "grid":
        raise ValueError(f"FPS route must be 'cluster' or 'grid', got {route!r}")
    threads = GRID_MAX_THREADS
    while threads > 32 and b > num_sms * grid_blocks_per_sm(threads):
        threads //= 2
    resident = num_sms * grid_blocks_per_sm(threads)
    if b > resident:
        raise ValueError(f"grid FPS: B={b} clouds exceed the {resident} CTAs the card "
                         "holds at once")
    ctas = max(1, min(resident // b, _cdiv(n, threads * GRID_PPT)))
    return FpsGridPlan("grid", ctas, threads, grid_streamed(n, ctas, threads))


def _large_fps(wrapper, route: str, xyz: torch.Tensor, npoint: int,
               start_idx: int | torch.Tensor, plan: FpsGridPlan | None) -> torch.Tensor:
    if xyz.device.type != "cuda":
        raise ValueError(f"FPS kernel needs a CUDA tensor, got {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(
            f"FPS kernel needs float32 (B, N, 3), got {xyz.dtype} {tuple(xyz.shape)}"
        )
    if not xyz.is_contiguous():
        raise ValueError("FPS kernel needs a contiguous xyz")
    b, n, _ = xyz.shape
    if not (1 <= npoint <= n) or 3 * n >= 2**31:
        raise ValueError(f"{route} FPS kernel takes 1 <= npoint <= N and 3 N < 2^31, "
                         f"got N={n} npoint={npoint}")
    if plan is None:
        plan = fps_grid_plan(b, n, _num_sms(xyz.device.index), route)
    if plan.route != route:
        raise ValueError(f"{route} FPS kernel got a {plan.route} plan: {plan}")
    start = start_indices(b, n, start_idx, xyz.device, torch.int32)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    if route == "cluster":
        fn = _build.function("p2c_fps_cluster", _ARGTYPES)  # p2c_fps's arguments
        with torch.cuda.device(xyz.device):  # the runtime launches on the current device
            status = fn(xyz.data_ptr(), start.data_ptr(), out.data_ptr(), b, n, npoint,
                        plan.ctas, plan.threads, stream)
    else:
        scratch = (torch.empty((b, plan.streamed), dtype=torch.float32, device=xyz.device)
                   if plan.streamed else None)
        meet = torch.zeros((b, GRID_MEET_WORDS), dtype=torch.int64, device=xyz.device)
        fn = _build.function("p2c_fps_grid", _GRID_ARGTYPES)
        with torch.cuda.device(xyz.device):
            status = fn(xyz.data_ptr(), start.data_ptr(), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(), meet.data_ptr(), b,
                        n, npoint, plan.ctas, plan.threads, stream)
    wrapper.launches += 1
    _build.check(f"p2c_fps_{route} ({plan.ctas} CTAs x {plan.threads} threads a cloud, "
                 f"{plan.streamed} points streamed)", status)
    return out


def farthest_point_sample_cluster_kernel(
    xyz: torch.Tensor, npoint: int, start_idx: int | torch.Tensor = 0,
    plan: FpsGridPlan | None = None,
) -> torch.Tensor:
    """Launch the cluster route (``csrc/fps_cluster.cu``): one
    thread-block cluster a cloud, N up to ``CLUSTER_CAPACITY``;
    ``.launches`` counts the launches.

    xyz (B, N, 3) float32 contiguous on CUDA. Returns (B, npoint) int32.
    ``plan`` (a cluster route) overrides :func:`fps_grid_plan`. The
    cluster's CTAs meet in distributed shared memory: nothing is
    allocated beside the output.
    """
    return _large_fps(farthest_point_sample_cluster_kernel, "cluster", xyz, npoint,
                      start_idx, plan)


farthest_point_sample_cluster_kernel.launches = 0  # kernel launches, for chip_smoke.py


def farthest_point_sample_grid_kernel(
    xyz: torch.Tensor, npoint: int, start_idx: int | torch.Tensor = 0,
    plan: FpsGridPlan | None = None,
) -> torch.Tensor:
    """Launch the grid route (``csrc/fps_grid.cu``), any N; ``.launches``
    counts the launches.

    xyz (B, N, 3) float32 contiguous on CUDA. Returns (B, npoint) int32.
    ``plan`` (a grid route) overrides ``fps_grid_plan(..., route="grid")``.
    Each call gets its own zeroed (B, GRID_MEET_WORDS) int64 buffer where a
    cloud's CTAs meet, so calls on several streams, or graphs replayed at
    once, never share one.
    """
    return _large_fps(farthest_point_sample_grid_kernel, "grid", xyz, npoint, start_idx,
                      plan)


farthest_point_sample_grid_kernel.launches = 0  # kernel launches, for chip_smoke.py


def farthest_point_sample(
    xyz: torch.Tensor, npoint: int, start_idx: int | torch.Tensor = 0
) -> torch.Tensor:
    """Iterative FPS: for a CUDA tensor ``fps.cu`` up to ``MAX_POINTS``
    points, ``fps_cluster.cu`` up to ``CLUSTER_CAPACITY`` and
    ``fps_grid.cu`` above, the plain version for a CPU tensor. Returns (B,
    npoint) int32 indices."""
    if xyz.device.type == "cpu":
        return farthest_point_sample_plain(xyz, npoint, start_idx)
    if xyz.dim() == 3 and xyz.shape[1] > CLUSTER_CAPACITY:
        return farthest_point_sample_grid_kernel(xyz, npoint, start_idx)
    if xyz.dim() == 3 and xyz.shape[1] > MAX_POINTS:
        return farthest_point_sample_cluster_kernel(xyz, npoint, start_idx)
    return farthest_point_sample_kernel(xyz, npoint, start_idx)


class FpsRingPlan(NamedTuple):
    """How one ring FPS step is launched over a batch: one cluster a cloud."""

    cluster: int  # CTAs a cluster
    threads: int  # threads a CTA


def fps_ring_plan(b: int, nl: int) -> FpsRingPlan:
    """The launch of one ring step: the fewest CTAs a cluster, a power of
    two up to ``RING_MAX_CLUSTER``, that give ``RING_THREADS`` threads
    about ``RING_POINTS_PER_THREAD`` points of the shard each, then the
    fewest threads, a power of two up to ``RING_MAX_THREADS``, that do.
    Clusters need not be resident together, so a large batch runs in
    waves."""
    if b < 1 or nl < 1:
        raise ValueError(f"ring FPS plan needs B >= 1 and Nl >= 1, got B={b} Nl={nl}")
    cluster = 1
    while cluster < RING_MAX_CLUSTER and cluster * RING_THREADS * RING_POINTS_PER_THREAD < nl:
        cluster *= 2
    threads = RING_THREADS
    while threads < RING_MAX_THREADS and cluster * threads * RING_POINTS_PER_THREAD < nl:
        threads *= 2
    return FpsRingPlan(cluster, threads)


def _need(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"ring FPS step: {name} must be contiguous {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def fps_ring_step_kernel(xyz: torch.Tensor, every: torch.Tensor, distance: torch.Tensor,
                         centroids: torch.Tensor, step: int, off: int,
                         plan: FpsRingPlan | None = None) -> torch.Tensor:
    """Launch one ring FPS step (``csrc/fps_ring.cu``) on the current
    stream; ``.launches`` counts the launches. The arguments are
    :func:`fps_ring_step_plain`'s, all on one CUDA device; ``plan``
    overrides :func:`fps_ring_plan`. Returns this rank's (B, 4) int64
    offer."""
    if xyz.device.type != "cuda":
        raise ValueError(f"ring FPS kernel needs a CUDA tensor, got {xyz.device}")
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"ring FPS kernel needs xyz (B, Nl, 3), got {tuple(xyz.shape)}")
    b, nl, _ = xyz.shape
    npoint = centroids.shape[-1]
    dev = xyz.device
    _need(xyz, "xyz", torch.float32, (b, nl, 3), dev)
    if every.dim() != 3:
        raise ValueError(f"ring FPS step: every must be (P, B, 4), got {tuple(every.shape)}")
    _need(every, "every", torch.int64, (every.shape[0], b, 4), dev)
    _need(distance, "distance", torch.float32, (b, nl), dev)
    _need(centroids, "centroids", torch.int64, (b, npoint), dev)
    if not (0 <= step < npoint) or off < 0 or off + nl > LOW32 or 3 * nl >= 2**31:
        raise ValueError(f"ring FPS step takes 0 <= step < npoint, 0 <= off, "
                         f"off + Nl <= 2^32 - 1 and 3 Nl < 2^31, got step={step} "
                         f"npoint={npoint} off={off} Nl={nl}")
    plan = fps_ring_plan(b, nl) if plan is None else FpsRingPlan(*plan)
    offer = torch.empty((b, 4), dtype=torch.int64, device=dev)
    fn = _build.function("p2c_fps_ring_step", _RING_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = fn(xyz.data_ptr(), every.data_ptr(), every.shape[0], distance.data_ptr(),
                    centroids.data_ptr(), offer.data_ptr(), b, nl, npoint, step, off,
                    plan.cluster, plan.threads, stream)
    fps_ring_step_kernel.launches += 1
    _build.check(f"p2c_fps_ring_step (a cluster of {plan.cluster} CTAs x {plan.threads} "
                 "threads a cloud)", status)
    return offer


fps_ring_step_kernel.launches = 0  # kernel launches, for chip_smoke.py


def fps_ring_step(xyz: torch.Tensor, every: torch.Tensor, distance: torch.Tensor,
                  centroids: torch.Tensor, step: int, off: int) -> torch.Tensor:
    """One ring FPS step: the kernel for a CUDA tensor, the plain version
    for a CPU tensor. Returns this rank's (B, 4) int64 offer."""
    if xyz.device.type == "cpu":
        return fps_ring_step_plain(xyz, every, distance, centroids, step, off)
    return fps_ring_step_kernel(xyz, every, distance, centroids, step, off)
