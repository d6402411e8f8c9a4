"""Port neighbour ops (point2cyl_torch.ops) against the JAX package.

Inputs come from numpy with fixed seeds and go through the port's plain
PyTorch versions (what its kernel wrappers run for CPU tensors) and their
JAX counterparts: the XLA functions and the Pallas kernels in interpret
mode. The CUDA kernels themselves run only on the card (chip_smoke.py
holds each one against these plain versions there).
"""

from __future__ import annotations

import itertools
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.ops import _build, cuda_ballquery, cuda_fps, cuda_knn, cuda_scatter
from point2cyl_torch.ops.grouping import (ball_query_plain, sample_and_group,
                                          three_nn_interpolate_plain)
from point2cyl_torch.ops.sampling import farthest_point_sample_plain
from point2cyl_tpu.ops.grouping import ball_query as jax_ball_query
from point2cyl_tpu.ops.grouping import sample_and_group as jax_sample_and_group
from point2cyl_tpu.ops.grouping import three_nn_interpolate as jax_three_nn
from point2cyl_tpu.ops.pallas_ballquery import (ball_query_grouped_pallas,
                                                ball_query_pallas,
                                                sa_grouped_exact_pallas)
from point2cyl_tpu.ops.pallas_knn import three_nn_interpolate_pallas
from point2cyl_tpu.ops.sampling import farthest_point_sample as jax_fps


def _sphere(rng, shape):
    pts = rng.normal(size=shape).astype(np.float32)
    return pts / np.linalg.norm(pts, axis=-1, keepdims=True)


@pytest.mark.parametrize("b,n,npoint", [(3, 96, 32), (2, 1024, 128)])
def test_fps_plain_matches_jax_indices(b, n, npoint):
    """Indices equal (bitwise), start_idx=0 as in serving."""
    pts = np.random.default_rng(1).normal(size=(b, n, 3)).astype(np.float32)
    got = farthest_point_sample_plain(torch.from_numpy(pts), npoint, 0)
    want = np.asarray(jax_fps(jnp.asarray(pts), npoint, start_idx=0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_plain_per_row_start():
    pts = np.random.default_rng(2).normal(size=(2, 64, 3)).astype(np.float32)
    got = farthest_point_sample_plain(torch.from_numpy(pts), 8,
                                      torch.tensor([5, 17]))
    for row, start in enumerate((5, 17)):
        want = np.asarray(jax_fps(jnp.asarray(pts[row:row + 1]), 8,
                                  start_idx=start))
        np.testing.assert_array_equal(got[row:row + 1].numpy(), want)


def _tie_cloud(kind: str, b: int, n: int) -> np.ndarray:
    """Clouds whose distances tie exactly: 64 distinct points each repeated
    (in a random order, so equal points lie far apart in index), or points
    of an integer lattice scaled by 0.25 (exact in float32)."""
    rng = np.random.default_rng(12)
    if kind == "repeated":
        distinct = rng.normal(size=(64, 3)).astype(np.float32)
        return np.stack([distinct[rng.permutation(n) % 64] for _ in range(b)])
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
    grid = grid.reshape(-1, 3)[:n].astype(np.float32) * 0.25
    return np.stack([grid[rng.permutation(n)] for _ in range(b)])


@pytest.mark.parametrize("kind", ["repeated", "lattice"])
def test_fps_plain_matches_jax_on_ties(kind):
    """Exact ties of distances at N=1000 (not a multiple of 32) with a
    start per row: the indices equal JAX's, so ties go to the lowest
    index on both sides. 100 samples of the repeated cloud run past its
    64 distinct points, where every distance is 0."""
    pts = _tie_cloud(kind, 3, 1000)
    starts = [5, 517, 999]
    got = farthest_point_sample_plain(torch.from_numpy(pts), 100,
                                      torch.tensor(starts))
    for row, start in enumerate(starts):
        want = np.asarray(jax_fps(jnp.asarray(pts[row:row + 1]), 100,
                                  start_idx=start))
        np.testing.assert_array_equal(got[row:row + 1].numpy(), want)


@pytest.mark.parametrize("start", [1000, -1, torch.tensor([0, 1000, 3])])
@pytest.mark.parametrize("fps", [farthest_point_sample_plain,
                                 cuda_fps.farthest_point_sample])
def test_fps_start_out_of_range_raises(fps, start):
    """A start outside [0, N) that the host can see (an int or a CPU
    tensor) raises ValueError; on the card the kernel asserts instead."""
    pts = torch.from_numpy(_tie_cloud("repeated", 3, 1000))
    with pytest.raises(ValueError, match="must lie in"):
        fps(pts, 8, start)


@pytest.mark.parametrize("b", [1, 4, 8, 16, 64])
def test_fps_launch_plan_covers_every_n(b):
    """Every N the kernel takes gets a plan it accepts: a cluster of 1-8
    CTAs of 128-512 threads that holds N at <= 8 points a thread; a
    cluster of at most 2 at N <= 1024; and B x cluster CTAs within the
    H100's 132 SMs unless N itself needs more CTAs."""
    for n in range(1, cuda_fps.MAX_POINTS + 1):
        cluster, threads = cuda_fps.fps_launch_plan(b, n)
        assert 1 <= cluster <= cuda_fps.MAX_CLUSTER
        assert threads in (128, 256, 512)
        assert cluster * threads * cuda_fps.MAX_POINTS_PER_THREAD >= n
        assert n > 1024 or cluster <= 2
        needed = -(-n // (cuda_fps.MAX_THREADS * cuda_fps.MAX_POINTS_PER_THREAD))
        assert b * cluster <= 132 or cluster == needed


def test_fps_launch_plan_main_shapes():
    """The plans measured best on the H100 (PERF.md): 8 CTAs of 128
    threads at SA1 for serving and training, 2 of 128 at SA2."""
    assert cuda_fps.fps_launch_plan(16, 8192) == (8, 128)
    assert cuda_fps.fps_launch_plan(4, 8192) == (8, 128)
    assert cuda_fps.fps_launch_plan(16, 512) == (2, 128)
    assert cuda_fps.fps_launch_plan(8, 512) == (2, 128)


def _taken_before(n: int, nsample: int) -> bool:
    """What the ball-query wrappers took before the launch plans: planes of
    N points and a warp's slots within 227 KB, 32 warps above N=1024."""
    warps = 32 if n > 1024 else 8
    return 1 <= nsample <= n and (3 * n + warps * nsample) * 4 <= cuda_ballquery.SMEM_LIMIT


_PLAN_KINDS = {  # keyword arguments of ball_query_plan for each kernel
    "sa1": {}, "idx": {"gather": False}, "sa2": {"c": 128}, "sa2 C=67": {"c": 67},
}


@pytest.mark.parametrize("nsample", [1, 32, 64, 128])
def test_ball_query_plan_covers_every_n(nsample):
    """Every (N, nsample) the wrappers took before gets a plan within the
    card's shared memory, for each kernel at B=16 and B=4; SA1 takes the
    grid exactly where the grid fits with GRID_MIN_WARPS warps, else the
    streamed query (which beat the staged scan at N=16,384), and the
    idx-only query above N=1024 the staged scan below STREAM_MIN_N
    points, the streamed query from there."""
    limit = cuda_ballquery.SMEM_LIMIT
    for n in range(nsample, 18001):
        before = _taken_before(n, nsample)
        grid_fits = cuda_ballquery._grid_smem(n, nsample,
                                              cuda_ballquery.GRID_MIN_WARPS) <= limit
        for b in (16, 4):
            for kind, extra in _PLAN_KINDS.items():
                plan = cuda_ballquery.ball_query_plan(b, n, 512, nsample, **extra)
                if plan is None:
                    assert not before, (kind, b, n, nsample)
                    continue
                assert plan.smem <= limit and 1 <= plan.warps <= 32 and plan.ctas >= 1
                if kind == "sa1":
                    assert plan.select == ("grid" if grid_fits else "stream"), (b, n, nsample)
                    want = (cuda_ballquery._grid_smem(n, nsample, plan.warps) if grid_fits
                            else cuda_ballquery._stream_smem(nsample, plan.warps, plan.group,
                                                             True))
                    assert plan.smem == want
                elif kind == "idx" and n > cuda_ballquery.BALLOT_MAX_N:
                    streams = n >= cuda_ballquery.STREAM_MIN_N
                    assert plan.select == ("stream" if streams else "scan"), (b, n, nsample)


@pytest.mark.parametrize("kind", list(_PLAN_KINDS))
def test_plan_or_raise_raises_exactly_where_no_plan(kind):
    """The wrappers' shape check reads the plan: it raises where
    ball_query_plan gives none (and for nsample outside 1..N), and
    nowhere else."""
    extra = _PLAN_KINDS[kind]
    for n in list(range(1, 40)) + list(range(11000, 21000, 7)) + [65535, 65536, 80000]:
        for nsample in (1, 63, 64, 128, 1024):
            plan = (cuda_ballquery.ball_query_plan(16, n, 128, nsample, **extra)
                    if 1 <= nsample <= n else None)
            if plan is None:
                with pytest.raises(ValueError):
                    cuda_ballquery.plan_or_raise(kind, 16, n, 128, nsample, **extra)
            else:
                assert cuda_ballquery.plan_or_raise(kind, 16, n, 128, nsample,
                                                    **extra) == plan


def test_ball_query_plan_main_shapes():
    """The plans measured best on the H100 (PERF.md): the grid at SA1 with
    about 132 / B CTAs a row (8 of 32 warps at B=16, 33 of 16 at B=4 and,
    where more CTAs would repeat the build, at B=1); at
    SA2 the bulk copy, 16 warps a CTA and 2 x 132 / B CTAs a row. A grid
    that does not fit (N=16384) takes the streamed query, and so does the
    idx-only query from N=1536."""
    plan = cuda_ballquery.ball_query_plan
    assert plan(16, 8192, 512, 64)[:4] == ("grid", "coords", 8, 32)
    assert plan(4, 8192, 512, 64)[:4] == ("grid", "coords", 33, 16)
    assert plan(1, 8192, 512, 64)[:4] == ("grid", "coords", 33, 16)
    assert plan(16, 16384, 512, 64).select == "stream"
    assert plan(16, 16384, 512, 64, gather=False).select == "stream"
    assert plan(16, 512, 128, 64, 128)[:4] == ("scan", "bulk", 16, 16)
    assert plan(4, 512, 128, 64, 128)[:4] == ("scan", "bulk", 66, 16)
    # idx only: the ballots, 32 warps a CTA and S / 32 CTAs a row (128 CTAs
    # at the N=512 protocol's B=8); above N=1024 the index-order scan, from
    # N=1536 the streamed query
    assert plan(8, 512, 512, 64, gather=False)[:4] == ("ballot", "none", 16, 32)
    assert plan(8, 1024, 512, 64, gather=False).select == "ballot"
    assert plan(8, 1025, 512, 64, gather=False).select == "scan"
    assert plan(16, 1535, 512, 64, gather=False).select == "scan"
    assert plan(16, 1536, 512, 64, gather=False).select == "stream"
    assert plan(8, 512, 512, 64, gather=False, select="scan")[:3] == ("scan", "none", 64)


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """nvcc compiles the .cu sources alone, but the library's name hashes
    the headers they include too: an edited header never loads a stale
    build."""
    (tmp_path / "a.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("constexpr int k = 1;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._sources() == [tmp_path / "a.cu"]
    before = _build._library_path(_build._hashed())
    (tmp_path / "a.cuh").write_text("constexpr int k = 2;\n")
    assert _build._library_path(_build._hashed()) != before
    monkeypatch.undo()
    assert _build.CSRC / "ballquery_layout.cuh" in _build._hashed()
    assert _build.CSRC / "target_sum_layout.cuh" in _build._hashed()


@pytest.mark.skipif(shutil.which("c++") is None, reason="needs a host C++ compiler")
def test_ball_query_smem_matches_layout_header(tmp_path):
    """The plans' shared-memory totals are the kernels' own: the layout
    header (csrc/ballquery_layout.cuh) compiled on the host gives the same
    bytes for the grid, scan, ballot and SA2 kernels and the same bitmap
    over N, nsample, warps, C and store, and the same constants and store
    codes."""
    cb = cuda_ballquery
    exprs = {"kMaxCells": cb.MAX_CELLS, "kGridHeader": cb.GRID_HEADER,
             "kBallotMaxN": cb.BALLOT_MAX_N,
             **{f"k{name.capitalize()}": code for code, name in enumerate(cb._STORES)}}
    for n in (1, 3, 31, 32, 33, 512, 1023, 1025, 4999, 8192, 11904, 16384, 18000, 65535):
        exprs[f"bitmap_words({n})"] = cb._bitmap_words(n)
        for ns in (1, 63, 64, 128):
            for warps in (1, 4, 16, 32):
                exprs[f"grid_smem({n}, {ns}, {warps})"] = cb._grid_smem(n, ns, warps)
                exprs[f"scan_smem({n}, {ns}, {warps})"] = cb._scan_smem(n, ns, warps)
                exprs[f"ballot_smem({ns}, {warps})"] = cb._ballot_smem(ns, warps)
                for c in (67, 128):
                    for code, store in enumerate(cb._STORES):
                        exprs[f"sa_smem({n}, {ns}, {c}, {warps}, {code})"] = cb._sa_smem(
                            n, ns, c, warps, store)
    src = tmp_path / "layout.cpp"
    src.write_text('#include <cstdio>\n#include "ballquery_layout.cuh"\nint main() {\n'
                   + "".join(f'  std::printf("%lld\\n", (long long)({e}));\n' for e in exprs)
                   + "}\n")
    subprocess.run(["c++", "-std=c++17", "-I", str(_build.CSRC), str(src), "-o",
                    str(tmp_path / "layout")], check=True, capture_output=True)
    out = subprocess.run([str(tmp_path / "layout")], check=True, capture_output=True,
                         text=True).stdout.split()
    got = dict(zip(exprs, map(int, out)))
    assert len(out) == len(exprs) and got == exprs


# (targets, entries a cloud) of the ordered per-target sums on the main
# path (N=8192) and the N=512 protocol: FP1 (S sources of N points), FP2
# (128 sources of 512 points), SA2 (512 table rows, 128 balls of 64);
# and SA1's gather backward in the saliency backward (8192 points, 512
# balls of 64)
_SCATTER_SHAPES = {"fp1": (512, 3 * 8192), "fp2": (128, 3 * 512), "sa2": (512, 128 * 64),
                   "fp1 N=512": (512, 3 * 512), "fp2 N=512": (128, 3 * 512),
                   "sa2 N=512": (512, 128 * 64), "sa1": (8192, 512 * 64)}


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 64])
def test_scatter_plan_covers_every_shape(b):
    """Every (B, targets, entries) of the main path and the N=512
    protocol, and every entry count up to 200,000 for 3 to 20,000
    targets, gets a plan within 227 KB that leaves room for every entry of
    a window in one target's list (the worst skew), with windows of at
    most 65,536 entries (uint16 list entries) that cover the cloud and
    CTAs that cover the targets; the counts listing exactly where a
    gather's backward sums rows of at most 4 floats (SA1's 3), bitmaps
    would need more than one wave at 32 targets a CTA and a target has at
    most 8 entries on average; bitmaps for the 3-NN backward and for wider
    rows (SA2's 131) at every shape."""
    cs = cuda_scatter
    limit = cs.SMEM_LIMIT
    shapes = list(_SCATTER_SHAPES.values())
    shapes += [(t, e) for t in (3, 128, 512, 8192, 20000) for e in range(1, 200001, 997)]
    for (targets, entries), width in itertools.product(shapes, (None, 3, 4, 5, 131)):
        plan = cs.scatter_plan(b, targets, entries, group_width=width)
        assert plan is not None, (b, targets, entries, width)
        counts = (width in (3, 4) and b * -(-targets // cs.MAX_TARGETS) > cs.H100_SMS
                  and entries <= 8 * targets)
        assert plan.listing == ("counts" if counts else "bitmaps"), (b, targets, entries, width)
        smem = cs.list_smem if counts else cs.sum_smem
        assert plan.smem == smem(plan.window, plan.targets)
        assert plan.smem <= limit
        assert plan.window % 4 == 0 and plan.window <= cs.MAX_WINDOW
        assert plan.window * plan.windows >= entries > plan.window * (plan.windows - 1)
        assert plan.ctas * plan.targets >= targets and plan.ctas & (plan.ctas - 1) == 0
        assert plan.ctas < 2 * -(-targets // plan.targets)
        assert 1 <= plan.targets <= (cs.MAX_LIST_TARGETS if counts else cs.MAX_TARGETS)
        assert plan.warps == cs.MAX_WARPS
        if counts:  # one wave: at most num_sms / B CTAs a cloud, unless the cap needs more
            assert b * plan.ctas <= cs.H100_SMS or plan.targets == cs.MAX_LIST_TARGETS
        if plan.windows > 1:  # one fewer window would not fit
            wider = cs.sum_window(entries, plan.windows - 1)
            assert wider > cs.MAX_WINDOW or smem(wider, plan.targets) > limit


def test_scatter_plan_main_shapes():
    """About 132 CTAs or more at B=4: 16 targets a CTA at FP1 and SA2, 4 at
    FP2, 16 warps, 32 CTAs a cloud and one window each, bitmaps; two
    windows at N=16384. FP1, FP2 and SA2 keep bitmaps at every batch, the
    N=512 protocol's too. SA1's gather backward (8192 targets, 512 balls
    of 64, 3 wide) takes the counts listing: 32 CTAs of 256 targets a
    cloud at B=4, one wave, and one window."""
    plan = cuda_scatter.scatter_plan
    assert plan(4, *_SCATTER_SHAPES["fp1"])[:4] == (16, 16, 24576, 1)
    assert plan(4, *_SCATTER_SHAPES["fp2"])[:4] == (4, 16, 1536, 1)
    assert plan(4, *_SCATTER_SHAPES["sa2"])[:4] == (16, 16, 8192, 1)
    assert plan(8, *_SCATTER_SHAPES["fp1 N=512"])[:2] == (32, 16)
    assert plan(4, 1024, 3 * 16384).windows == 2
    for shape in ("fp1", "fp2", "sa2"):
        assert 4 * plan(4, *_SCATTER_SHAPES[shape]).ctas >= 128
        assert plan(4, *_SCATTER_SHAPES[shape]).listing == "bitmaps"
    for shape, b in itertools.product(("fp1", "fp2", "fp1 N=512", "fp2 N=512"), (1, 8, 16, 64)):
        assert plan(b, *_SCATTER_SHAPES[shape]).listing == "bitmaps"
    for shape, b in itertools.product(("sa2", "sa2 N=512"), (1, 8, 16, 64)):
        assert plan(b, *_SCATTER_SHAPES[shape], group_width=131).listing == "bitmaps"
    sa1 = plan(4, *_SCATTER_SHAPES["sa1"], group_width=3)
    assert sa1.listing == "counts" and sa1[:5] == (256, 16, 32768, 1, 32)
    assert plan(4, *_SCATTER_SHAPES["sa1"], group_width=3,
                listing="bitmaps")[:5] == (32, 16, 32768, 1, 256)


@pytest.mark.parametrize("kind", ["three_nn", "sa2", "sa1"])
def test_scatter_plan_raises_exactly_where_no_plan(kind):
    """The wrappers' shape check reads the plan: it raises where
    scatter_plan gives none (no batch row, more than 65,535, no target or
    entry) and nowhere else. scatter_plan also gives none for an override
    (``kernel_sweep.py``'s plans) out of range: targets a CTA beyond each
    listing's limit, warps, a listing it does not know, or the counts
    listing for the 3-NN backward or rows wider than 4."""
    for b in (0, 1, 4, 65535, 65536):
        for targets in (0, 1, 512, 8192):
            for entries in (0, 1, 24576, 32768, 2**31):
                plan = cuda_scatter.scatter_plan(b, targets, entries, num_sms=100)
                if plan is None:
                    with pytest.raises(ValueError, match="no launch plan"):
                        cuda_scatter.plan_or_raise(kind, b, targets, entries, num_sms=100)
                else:
                    assert cuda_scatter.plan_or_raise(kind, b, targets, entries,
                                                      num_sms=100) == plan
    for listing, most in (("bitmaps", 32), ("counts", 8192)):
        for per_cta in (0, 1, most, most + 1):
            for warps in (0, 1, 16, 17):
                plan = cuda_scatter.scatter_plan(4, 8192, 32768, group_width=3,
                                                 per_cta=per_cta, warps=warps, listing=listing)
                in_range = 1 <= per_cta <= most and 1 <= warps <= 16
                assert (plan is not None) == in_range, (listing, per_cta, warps)
                assert plan is None or plan.listing == listing
    assert cuda_scatter.scatter_plan(4, 8192, 32768, group_width=3, listing="sorted") is None
    for width in (None, 5, 131):
        assert cuda_scatter.scatter_plan(4, 8192, 32768, group_width=width,
                                         listing="counts") is None


@pytest.mark.skipif(shutil.which("c++") is None, reason="needs a host C++ compiler")
def test_scatter_smem_matches_layout_header(tmp_path):
    """The plan's shared-memory totals and windows are the kernel's own:
    the layout header (csrc/target_sum_layout.cuh) compiled on the host
    gives the same bytes and windows for both listings, the same limits
    and the same listing codes."""
    cs = cuda_scatter
    exprs = {"kSumMaxTargets": cs.MAX_TARGETS, "kListMaxTargets": cs.MAX_LIST_TARGETS,
             "kSumMaxWarps": cs.MAX_WARPS,
             "kSumMaxWindow": cs.MAX_WINDOW, "kListMaxWidth": cs.MAX_LIST_WIDTH,
             **{f"k{name.capitalize()}": code for code, name in enumerate(cs.LISTINGS)}}
    for entries in (1, 3, 4, 5, 1536, 2331, 8192, 24576, 32768, 49152, 65537, 200001):
        for windows in (1, 2, 3, 7):
            exprs[f"sum_window({entries}, {windows})"] = cs.sum_window(entries, windows)
    for window in (4, 32, 33, 1536, 2332, 8192, 24576, 32768, 37888, 55296, 65536):
        exprs[f"sum_bitmap_words({window})"] = cs.sum_bitmap_words(window)
        exprs[f"sum_summary_words({window})"] = cs.sum_summary_words(window)
        for targets in (1, 3, 4, 16, 32):
            exprs[f"sum_smem({window}, {targets})"] = cs.sum_smem(window, targets)
        for targets in (1, 3, 64, 256, 1024, 8192):
            exprs[f"list_smem({window}, {targets})"] = cs.list_smem(window, targets)
    src = tmp_path / "layout.cpp"
    src.write_text('#include <cstdio>\n#include "target_sum_layout.cuh"\nint main() {\n'
                   + "".join(f'  std::printf("%lld\\n", (long long)({e}));\n' for e in exprs)
                   + "}\n")
    subprocess.run(["c++", "-std=c++17", "-I", str(_build.CSRC), str(src), "-o",
                    str(tmp_path / "layout")], check=True, capture_output=True)
    out = subprocess.run([str(tmp_path / "layout")], check=True, capture_output=True,
                         text=True).stdout.split()
    got = dict(zip(exprs, map(int, out)))
    assert len(out) == len(exprs) and got == exprs


LANE_SORT_MAX = 16  # csrc/target_sum.cu kLaneSortMax


def _warp_sort_model(s: list) -> list:
    """``csrc/target_sum.cu:warp_sort`` step by step: up to 32 entries the
    shuffle network in registers (lane l holds entry l, the lanes past the
    end a key above every entry); more, the bitonic network over the next
    power of two in shared memory, every compare-exchange putting the
    smaller entry at the lower place, pairs reaching past the list's end
    skipped (the lanes of a step take disjoint pairs, so their order is
    immaterial)."""
    if len(s) <= 32:
        x = [int(v) for v in s] + [0x10000 + lane for lane in range(len(s), 32)]
        k = 2
        while k <= 32:
            j = k >> 1
            while j > 0:
                y = [x[lane ^ j] for lane in range(32)]
                x = [min(x[lane], y[lane]) if ((lane & j) == 0) == ((lane & k) == 0)
                     else max(x[lane], y[lane]) for lane in range(32)]
                j >>= 1
            k <<= 1
        return x[:len(s)]
    s = list(s)
    n = 2
    while n < len(s):
        n <<= 1
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            for p in range(n >> 1):
                i = (p // j) * 2 * j + p % j
                other = (i | (k - 1)) - (i & (k - 1)) if j == k >> 1 else i + j
                if other < len(s) and s[other] < s[i]:
                    s[i], s[other] = s[other], s[i]
            j >>= 1
        k <<= 1
    return s


def _register_sort_model(s: list, size: int) -> list:
    """``csrc/target_sum.cu:sort_regs<size>`` on a list of at most ``size``
    entries (places past its end hold 0x10000): the bitonic network, each
    compare-exchange ascending or descending by bit k of the lower place."""
    x = [int(v) for v in s] + [0x10000] * (size - len(s))
    k = 2
    while k <= size:
        j = k >> 1
        while j > 0:
            for i in range(size):
                if i ^ j > i:
                    lo, hi = min(x[i], x[i ^ j]), max(x[i], x[i ^ j])
                    x[i], x[i ^ j] = (lo, hi) if i & k == 0 else (hi, lo)
            j >>= 1
        k <<= 1
    return x[:len(s)]


def _list_sort_model(s: list, size: int = 0) -> list:
    """The counts listing's sort of one list at a row of at most 4 floats:
    up to LANE_SORT_MAX entries the thread's network in registers of the
    warp's size (``size``, by default the least of 4, 8 and 16 that holds
    the list), else the warp's network."""
    if len(s) > LANE_SORT_MAX:
        return _warp_sort_model(s)
    if len(s) < 2:
        return list(s)
    return _register_sort_model(s, size or next(m for m in (4, 8, 16) if m >= len(s)))


@pytest.mark.parametrize("lengths", [range(0, 40), range(40, 300, 7), (511, 512, 513, 1000)])
def test_list_sort_sorts_every_length(lengths):
    """The counts listing's list sort puts any order of distinct entry ids
    in ascending order, at every list length around the powers of two
    (where the warp's network skips the pairs past the end), and a short
    list at each size of register network that holds it (a warp takes the
    size of its longest list)."""
    rng = np.random.default_rng(61)
    for n in lengths:
        for _ in range(3):
            ids = rng.choice(65536, size=n, replace=False)
            assert _list_sort_model(list(ids)) == sorted(ids)
            for size in (4, 8, 16):
                if 2 <= n <= size:
                    assert _list_sort_model(list(ids), size) == sorted(ids)


def _target_sum_model(idx: np.ndarray, rows: np.ndarray, targets: int,
                      plan: cuda_scatter.ScatterPlan) -> np.ndarray:
    """``csrc/target_sum.cu`` step by step in numpy: CTA k of ``plan.ctas``
    owns targets k, k + ctas, ...; for each window, each of its targets'
    list, read out of the target's bitmap of the entries in word and bit
    order (bitmaps), or placed in an arbitrary order (the atomics') and
    sorted (counts); each list summed in order in float32 (a later window
    from the row so far). Checks on the way that the CTAs cover every
    target once and that every list ascends."""
    rng = np.random.default_rng(62)
    b_count, entries = idx.shape
    out = np.full((b_count, targets, rows.shape[-1]), np.nan, np.float32)
    for b in range(b_count):
        for k in range(plan.ctas):
            owned = np.arange(k, targets, plan.ctas)[:plan.targets]
            acc = np.zeros((len(owned), rows.shape[-1]), np.float32)
            for e0 in range(0, entries, plan.window):
                window = idx[b, e0:e0 + plan.window]
                for lt, t in enumerate(owned):
                    if plan.listing == "counts":
                        listed = _list_sort_model(list(rng.permutation(
                            np.nonzero(window == t)[0])))
                    else:
                        bitmap = np.zeros(-(-len(window) // 32), np.uint64)
                        for e in np.nonzero(window == t)[0]:
                            bitmap[e >> 5] |= np.uint64(1) << np.uint64(e & 31)
                        listed = [32 * wd + bit for wd, word in enumerate(bitmap)
                                  for bit in range(32) if int(word) >> bit & 1]
                    assert (np.diff(listed) > 0).all()
                    for e in listed:
                        acc[lt] = acc[lt] + rows[b, e0 + e]
            assert np.isnan(out[b, owned]).all()
            out[b, owned] = acc
    return out


@pytest.mark.parametrize("case", ["fp1-like", "3 targets", "windows", "padded balls",
                                  "sa1-like", "isolated points padded", "one target in every ball"])
def test_target_sum_order_equals_host_sum(case):
    """The kernel's order of work, modelled in numpy, sums each target's
    terms in ascending entry order: equal bit for bit to np.add.at (what
    chip_smoke.py holds the kernel to on the card), at the default plan,
    with every entry on 3 targets, over several windows and warps, and
    with balls of one point padded to nsample; and with the counts
    listing, the wrapper's choice at SA1-like shapes (many targets, about
    4 entries each, rows 3 wide): balls of 64 among 2048 points, isolated
    points each padded 64 times onto itself, and one target in every
    ball."""
    rng = np.random.default_rng(60)
    b, targets, entries, c = 2, 96, 1500, 5
    idx = rng.integers(0, targets, size=(b, entries))
    plan = cuda_scatter.scatter_plan(b, targets, entries, per_cta=16, warps=4)
    if case == "3 targets":
        targets = 3
        idx = rng.integers(0, 3, size=(b, entries))
        plan = cuda_scatter.scatter_plan(b, targets, entries)
    elif case == "windows":
        plan = plan._replace(window=cuda_scatter.sum_window(entries, 3), windows=3)
    elif case == "padded balls":
        idx = np.repeat(rng.integers(0, targets, size=(b, entries // 64 + 1)), 64,
                        axis=1)[:, :entries]
    elif case in ("sa1-like", "isolated points padded", "one target in every ball"):
        # 128 balls of 64 among 2048 points at r=0.4 (about 82 points a ball,
        # as at SA1): about 4 entries a target
        b, targets, balls, ns, c = 3, 2048, 128, 64, 3
        entries = balls * ns
        pts = _sphere(rng, (b, targets, 3))
        centres = pts[:, rng.permutation(targets)[:balls]]
        if case == "isolated points padded":  # each ball's centre is its only point
            pts[:, :balls] = 5.0 + np.arange(balls, dtype=np.float32)[:, None]
            centres = pts[:, :balls]
        idx = ball_query_plain(0.4, ns, torch.from_numpy(pts),
                               torch.from_numpy(np.ascontiguousarray(centres))).numpy()
        if case == "one target in every ball":
            idx[:, :, 0] = 7
        idx = idx.reshape(b, entries)
        plan = cuda_scatter.scatter_plan(b, targets, entries, group_width=c)
        assert plan.listing == "counts"
        sizes = np.stack([np.bincount(row, minlength=targets) for row in idx])
        if case == "sa1-like":  # nearly every list sorted by one thread
            assert (sizes <= LANE_SORT_MAX).mean() > 0.99
        else:  # lists of a padded ball, or of every ball, that a warp sorts
            assert sizes.max() >= ns
    rows = rng.normal(size=(b, entries, c)).astype(np.float32) * np.float32(1e3) ** \
        rng.integers(-1, 2, size=(b, entries, 1))
    want = np.zeros((b, targets, c), np.float32)
    for row in range(b):
        np.add.at(want[row], idx[row], rows[row])
    got = _target_sum_model(idx, rows, targets, plan)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _ballot_model(radius: float, nsample: int, xyz: np.ndarray,
                  centres: np.ndarray) -> np.ndarray:
    """``csrc/ballquery.cu:ball_query_ballot_kernel`` step by step in
    numpy: for each query, lane l's in-radius bits of points 128 m + 4 l
    .. 128 m + 4 l + 3 of each block m (float32 ((dx^2 + dy^2) + dz^2), no
    fused multiply-add), one exclusive prefix over the lanes of their
    counts, a byte for each block packed into 64 bits, each lane's hits
    placed from the blocks before and its prefix while below nsample, and
    the row padded with the least of the lanes' first hits (N - 1 where
    there is none)."""
    r2 = np.float32(radius * radius)
    b_count, n, _ = xyz.shape
    blocks = -(-n // 128)
    out = np.empty(centres.shape[:2] + (nsample,), np.int32)
    for b in range(b_count):
        for q, c in enumerate(centres[b]):
            with np.errstate(invalid="ignore"):  # inf - inf: NaN, never in radius
                d = (c - xyz[b]).astype(np.float32)
            sq = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            inside = np.zeros(128 * blocks, bool)
            inside[:n] = sq <= r2
            hits = inside.reshape(blocks, 32, 4)  # [block, lane, point of the lane]
            packed = [sum(int(hits[m, lane].sum()) << (8 * m) for m in range(blocks))
                      for lane in range(32)]
            before = np.cumsum(packed) - packed
            totals = sum(packed)
            sel = np.full(nsample, -1, np.int32)
            base = 0
            for m in range(blocks):
                for lane in range(32):
                    at = base + (int(before[lane]) >> (8 * m) & 0xFF)
                    for k in np.nonzero(hits[m, lane])[0]:
                        if at < nsample:
                            sel[at] = 128 * m + 4 * lane + k
                        at += 1
                base += totals >> (8 * m) & 0xFF
            firsts = [128 * m + 4 * lane + k for lane in range(32)
                      for m, k in zip(*np.nonzero(hits[:, lane]))]
            first = min(firsts) if firsts else n - 1
            out[b, q] = np.where(np.arange(nsample) < min(base, nsample), sel, first)
    return out


@pytest.mark.parametrize("n", [33, 512, 1000, 1024])
def test_ballot_placement_equals_plain(n):
    """The idx-only kernel's placement (each lane's bits of 4 adjacent
    points a block, one packed prefix, the pad), modelled in numpy, gives
    ball_query_plain's indices: full rows, short rows, empty rows and a
    point with a NaN or an infinite coordinate, at N not a multiple of 4
    (33: one block, its lanes past N), 4 blocks, a ragged last block and
    all 8; the plan takes the ballots at each of these N."""
    rng = np.random.default_rng(63)
    pts = _sphere(rng, (2, n, 3))
    pts[0, 3, 1], pts[1, n // 2, 0] = np.nan, np.inf
    centres = np.concatenate([pts[:, rng.permutation(n)[:40]],
                              np.full((2, 1, 3), 9.0, np.float32)], 1)
    for radius, nsample in ((0.2, min(64, n)), (0.6, 16), (1.5, min(63, n))):
        got = _ballot_model(radius, nsample, pts, centres)
        want = ball_query_plain(radius, nsample, torch.from_numpy(pts),
                                torch.from_numpy(centres)).numpy()
        np.testing.assert_array_equal(got, want)
    assert cuda_ballquery.ball_query_plan(2, n, 41, 64, gather=False).select == "ballot"


@pytest.mark.parametrize("case", ["fp2 slice", "channels strided", "sa2 rows strided",
                                  "misaligned"])
def test_check_rows(case):
    """The kernels read a row at ``ptr + b * batch + r * row`` with its
    channels adjacent: FP2's cotangent, the interpolated slice of a
    concatenation's gradient, passes with its row stride 384 and an
    offset that keeps 16-byte rows; channels apart, SA2 rows that do not
    merge into one stride, or a pointer off 4 bytes raise."""
    cat = torch.zeros(2, 512, 384)
    if case == "fp2 slice":
        g = cat[..., 128:]
        assert g.stride() == (512 * 384, 384, 1)
        cuda_scatter.check_rows("g", g.data_ptr(), tuple(g.shape), g.stride(), 1)
        assert (g.data_ptr() - cat.data_ptr()) % 16 == 0 and cuda_scatter.rows_readable(g, 1)
        return
    if case == "channels strided":
        t, merge, match = cat[..., ::2], 1, "adjacent"
    elif case == "sa2 rows strided":
        t, merge, match = torch.zeros(2, 8, 16, 131).transpose(1, 2), 2, "merge"
    else:
        t, merge, match = cat, 1, "aligned"
    ptr = t.data_ptr() + (2 if case == "misaligned" else 0)
    with pytest.raises(ValueError, match=match):
        cuda_scatter.check_rows("t", ptr, tuple(t.shape), t.stride(), merge)
    assert case == "misaligned" or not cuda_scatter.rows_readable(t, merge)


@pytest.mark.parametrize("launch", [
    lambda: cuda_knn.three_nn_backward_kernel(
        torch.zeros(1, 16, 3, dtype=torch.int32), torch.zeros(1, 16, 3),
        torch.zeros(1, 16, 8)[..., ::2], 4),
    lambda: cuda_ballquery.sa_grouped_backward_kernel(
        torch.zeros(1, 4, 4, dtype=torch.int32), torch.zeros(1, 4, 4, 7).transpose(1, 2), 16),
    lambda: cuda_ballquery.sa_grouped_backward_kernel(
        torch.zeros(1, 4, 4, dtype=torch.int32), torch.zeros(1, 4, 4, 14)[..., ::2], 16),
    lambda: cuda_ballquery.ball_query_grouped_backward_kernel(
        torch.zeros(1, 4, 4, dtype=torch.int32), torch.zeros(1, 4, 4, 3).transpose(1, 2), 16),
])
def test_scatter_launchers_reject_bad_strides(launch, monkeypatch):
    """Given a cotangent whose rows the kernel cannot read as they lie, a
    launcher raises before it builds anything."""
    def no_build(*args, **kwargs):
        raise AssertionError("the kernel library was requested")

    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(ValueError, match="adjacent|merge"):
        launch()


def _axis_cells(p, lo, inv, dim):
    """``csrc/ballquery.cu:axis_cell`` in float32."""
    t = np.floor((p - lo).astype(np.float32) * inv)
    return np.clip(t, 0, dim - 1).astype(np.int64)


def _grid_edge(ext, r2):
    """``csrc/ballquery.cu:grid_shape`` in float32: the cell edge's inverse
    and the grid's cells a side."""
    e = np.float32(np.sqrt(np.float32(r2))) * np.float32(1.015625)
    e = max(e, np.float32(ext.max() * np.float32(1.0 / cuda_ballquery.MAX_CELLS)))
    while True:
        inv = np.float32(1.0) / e
        dims = np.minimum(np.floor(ext * inv), cuda_ballquery.MAX_CELLS - 1) + 1
        if np.prod(dims.astype(np.int64)) <= cuda_ballquery.MAX_CELLS:
            return inv, dims.astype(np.int64)
        e = np.float32(e * np.float32(1.25))


@pytest.mark.parametrize("scale,radius", [(1.0, 0.2), (1.0, 0.4), (1e-3, 2e-4),
                                          (1e4, 0.2), (3.0, 1.5)])
def test_grid_cells_cover_every_in_radius_pair(scale, radius):
    """The coverage argument of the grid kernel, in the kernel's float32
    arithmetic: a pair that passes the exact float32 test lies at most one
    cell apart on every axis, whatever the box (the 4096-cell cap included)
    and with pairs at and just beyond the radius."""
    rng = np.random.default_rng(14)
    r2 = np.float32(radius * radius)
    pts = (rng.uniform(-1, 1, size=(20000, 3)) * scale).astype(np.float32)
    pts[0] = [1e4, 0.0, 0.0]  # widens the box, so the cap enlarges the cells
    lo, hi = pts.min(0), pts.max(0)
    inv, dims = _grid_edge((hi - lo).astype(np.float32), r2)
    # centres near points, offsets of about the radius on each axis
    q = pts[rng.integers(0, len(pts), 20000)]
    off = rng.normal(size=q.shape) * radius / np.sqrt(3)
    off[:3000] = 0.0
    off[np.arange(3000), np.arange(3000) % 3] = radius
    p = (q + off).astype(np.float32)
    d = (p - q).astype(np.float32)
    sq = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).astype(np.float32) + d[:, 2] * d[:, 2]
    inside = sq.astype(np.float32) <= r2
    assert inside.sum() > 10000
    inside &= np.all((p >= lo) & (p <= hi), axis=1)  # grid points lie in the box
    for a in range(3):
        cp = _axis_cells(p[inside, a], lo[a], inv, dims[a])
        cq = _axis_cells(q[inside, a], lo[a], inv, dims[a])
        assert np.abs(cp - cq).max() <= 1


def test_ball_query_plain_matches_pallas_exact_path():
    """N=512 takes the Pallas exact path: indices equal."""
    rng = np.random.default_rng(3)
    pts = _sphere(rng, (2, 512, 3))
    q = pts[:, :64]
    want = np.asarray(ball_query_pallas(0.4, 16, jnp.asarray(pts), jnp.asarray(q),
                                        tile_q=64, interpret=True))
    got = ball_query_plain(0.4, 16, torch.from_numpy(pts), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("radius", [0.05, 0.2, 0.6])
def test_ball_query_plain_matches_xla(radius):
    """Against the XLA expansion-distance path on a seed where no pair sits
    within float error of the radius (checked here), so both sides agree."""
    rng = np.random.default_rng(7)
    pts = _sphere(rng, (2, 256, 3))
    q = pts[:, :32]
    d = np.sum((q[:, :, None].astype(np.float64) - pts[:, None]) ** 2, -1)
    assert np.min(np.abs(d - radius * radius)) > 1e-5
    want = np.asarray(jax_ball_query(radius, 16, jnp.asarray(pts), jnp.asarray(q)))
    got = ball_query_plain(radius, 16, torch.from_numpy(pts), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [0, 8])
def test_sample_and_group_plain_matches_xla(width):
    """Centres and grouped [xyz - centre | feats] equal the XLA
    sample_and_group bit for bit (both gather by copying), on a seed with
    no pair within float error of the radius."""
    rng = np.random.default_rng(11)
    pts = _sphere(rng, (2, 256, 3))
    feats = rng.normal(size=(2, 256, width)).astype(np.float32) if width else None
    fps_idx = rng.choice(256, size=(2, 32)).astype(np.int32)
    q = np.take_along_axis(pts, fps_idx[..., None].astype(np.int64), axis=1)
    d = np.sum((q[:, :, None].astype(np.float64) - pts[:, None]) ** 2, -1)
    assert np.min(np.abs(d - 0.3 * 0.3)) > 1e-5
    want = jax_sample_and_group(32, 0.3, 16, jnp.asarray(pts),
                                None if feats is None else jnp.asarray(feats),
                                jnp.asarray(fps_idx))
    got = sample_and_group(0.3, 16, torch.from_numpy(pts),
                           None if feats is None else torch.from_numpy(feats),
                           torch.from_numpy(fps_idx))
    assert got[1].shape == (2, 32, 16, 3 + width)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ball_query_grouped_plain_matches_pallas():
    """SA1 layout at N=2048 with oversample=nsample, where JAX's blocked
    path equals exact selection: indices equal, coords within 1e-5 (JAX
    gathers through bf16 hi/lo one-hot matmuls; the port copies)."""
    rng = np.random.default_rng(4)
    pts = _sphere(rng, (2, 2048, 3))
    q = pts[:, :128]
    idx_j, g_j = ball_query_grouped_pallas(0.4, 32, jnp.asarray(pts), jnp.asarray(q),
                                           tile_q=32, interpret=True, oversample=32)
    idx, g = cuda_ballquery.ball_query_grouped(0.4, 32, torch.from_numpy(pts),
                                               torch.from_numpy(q))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=1e-5, rtol=0)
    # the port's gather is exact
    want = np.stack([pts[b][idx.numpy()[b]] for b in range(2)]) - q[:, :, None]
    np.testing.assert_array_equal(g.numpy(), want)


def test_sa_grouped_exact_plain_matches_pallas():
    """SA2 layout [xyz - centre | feats]: indices equal, values within 1e-4
    (the JAX test's own bound for its one-hot gather)."""
    rng = np.random.default_rng(5)
    pts = _sphere(rng, (2, 512, 3))
    feats = rng.normal(size=(2, 512, 16)).astype(np.float32)
    q = pts[:, :64]
    idx_j, g_j = sa_grouped_exact_pallas(0.4, 32, jnp.asarray(pts), jnp.asarray(feats),
                                         jnp.asarray(q), tile_q=32, interpret=True)
    idx, g = cuda_ballquery.sa_grouped_exact(0.4, 32, torch.from_numpy(pts),
                                             torch.from_numpy(feats),
                                             torch.from_numpy(q))
    assert g.shape == (2, 64, 32, 19)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=1e-4, rtol=0)


def test_ball_query_short_rows_pad_with_first():
    """A query with fewer in-radius points than nsample repeats its first
    (smallest) in-radius index; a query with none gives N-1."""
    pts = np.zeros((1, 8, 3), np.float32)
    pts[0, :, 0] = np.arange(8, dtype=np.float32)
    q = np.array([[[3.0, 0.0, 0.0], [100.0, 0.0, 0.0]]], np.float32)
    idx = ball_query_plain(1.0, 4, torch.from_numpy(pts), torch.from_numpy(q))
    np.testing.assert_array_equal(idx.numpy()[0], [[2, 3, 4, 2], [7, 7, 7, 7]])


def _three_nn_oracle(dst, src, feats):
    out = np.zeros(dst.shape[:2] + (feats.shape[-1],), np.float64)
    for b in range(dst.shape[0]):
        for i, q in enumerate(dst[b]):
            d = np.sum((src[b] - q) ** 2, axis=1)
            order = np.argsort(d, kind="stable")[:3]
            w = 1.0 / (d[order] + 1e-8)
            out[b, i] = (w[:, None] * feats[b][order]).sum(0) / w.sum()
    return out


def test_three_nn_plain_matches_numpy_oracle():
    """Exact distances and sequential-argmin tie order; self points (src a
    subset of dst) recover their source feature."""
    rng = np.random.default_rng(6)
    src = rng.normal(size=(2, 16, 3)).astype(np.float32)
    dst = np.concatenate([src, rng.normal(size=(2, 48, 3)).astype(np.float32)], 1)
    feats = rng.normal(size=(2, 16, 8)).astype(np.float32)
    got = three_nn_interpolate_plain(*map(torch.from_numpy, (dst, src, feats)))
    np.testing.assert_allclose(got.numpy(), _three_nn_oracle(dst, src, feats),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[:, :16], feats, atol=1e-5, rtol=0)


def test_three_nn_plain_matches_pallas():
    """Within 2e-3: the Pallas kernel quantises its distances (index packed
    into the low mantissa bits), the port does not."""
    rng = np.random.default_rng(8)
    src = rng.normal(size=(2, 16, 3)).astype(np.float32)
    dst = np.concatenate([src, rng.normal(size=(2, 48, 3)).astype(np.float32)], 1)
    feats = rng.normal(size=(2, 16, 8)).astype(np.float32)
    want = np.asarray(three_nn_interpolate_pallas(
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(feats), 1e-8, 8, True))
    got = cuda_knn.three_nn_interpolate(*map(torch.from_numpy, (dst, src, feats)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)


def test_three_nn_plain_matches_pallas_odd_channels():
    """C=67, the width the kernel serves with its 4-byte path: within
    2e-3 of the Pallas kernel in interpret mode, as above."""
    rng = np.random.default_rng(13)
    src = rng.normal(size=(2, 16, 3)).astype(np.float32)
    dst = np.concatenate([src, rng.normal(size=(2, 48, 3)).astype(np.float32)], 1)
    feats = rng.normal(size=(2, 16, 67)).astype(np.float32)
    want = np.asarray(three_nn_interpolate_pallas(
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(feats), 1e-8, 8, True))
    got = cuda_knn.three_nn_interpolate(*map(torch.from_numpy, (dst, src, feats)))
    assert got.shape == (2, 64, 67)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("b,n,lanes", [(16, 8192, 1), (4, 8192, 2), (16, 512, 4),
                                       (4, 512, 4), (1, 1, 4), (64, 8192, 1)])
def test_three_nn_lanes(b, n, lanes):
    """One thread a point where B x N fills the card, up to 4 where it
    does not (the split measured best on the H100, PERF.md)."""
    assert cuda_knn.three_nn_lanes(b, n) == lanes


def test_three_nn_plain_matches_xla():
    """Against the XLA path (approx=False) on points that do not coincide,
    so its expansion-form distances carry no cancellation: rtol 1e-4."""
    rng = np.random.default_rng(9)
    src = rng.normal(size=(2, 32, 3)).astype(np.float32)
    dst = rng.normal(size=(2, 64, 3)).astype(np.float32)
    feats = rng.uniform(1.0, 2.0, size=(2, 32, 16)).astype(np.float32)
    want = np.asarray(jax_three_nn(jnp.asarray(dst), jnp.asarray(src),
                                   jnp.asarray(feats), approx=False))
    got = three_nn_interpolate_plain(*map(torch.from_numpy, (dst, src, feats)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0)


def test_three_nn_exact_ties():
    """Two coincident sources at distance 0 are both taken with full 1/eps
    weight; the third is the true next-nearest."""
    src = np.zeros((1, 8, 3), np.float32)
    src[0, :, 0] = [0.0, 0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
    feats = np.arange(8, dtype=np.float32).reshape(1, 8, 1)
    dst = np.zeros((1, 8, 3), np.float32)
    got = three_nn_interpolate_plain(*map(torch.from_numpy, (dst, src, feats)))
    w = np.array([1e8, 1e8, 4.0])
    want = (w * np.array([0.0, 1.0, 2.0])).sum() / w.sum()
    np.testing.assert_allclose(got.numpy()[0, :, 0], want, atol=1e-5, rtol=0)


def test_wrappers_route_cpu_tensors_to_plain(monkeypatch):
    """CPU tensors take the plain versions: the kernel build is never
    touched and no launch is counted."""
    def no_build(*args, **kwargs):
        raise AssertionError("the kernel library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "function", no_build)
    counters = (cuda_fps.farthest_point_sample_kernel,
                cuda_ballquery.ball_query_grouped_kernel,
                cuda_ballquery.sa_grouped_exact_kernel,
                cuda_knn.three_nn_interpolate_kernel)
    before = [fn.launches for fn in counters]
    rng = np.random.default_rng(10)
    pts = torch.from_numpy(_sphere(rng, (2, 128, 3)))
    feats = torch.from_numpy(rng.normal(size=(2, 128, 4)).astype(np.float32))
    idx = cuda_fps.farthest_point_sample(pts, 16)
    np.testing.assert_array_equal(idx.numpy(),
                                  farthest_point_sample_plain(pts, 16).numpy())
    q = pts[:, :16].contiguous()
    cuda_ballquery.ball_query_grouped(0.4, 8, pts, q)
    cuda_ballquery.sa_grouped_exact(0.4, 8, pts, feats, q)
    cuda_knn.three_nn_interpolate(pts, q, feats[:, :16].contiguous())
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("launch", [
    lambda t: cuda_fps.farthest_point_sample_kernel(t, 4),
    lambda t: cuda_ballquery.ball_query_grouped_kernel(0.4, 4, t, t[:, :4]),
    lambda t: cuda_ballquery.sa_grouped_exact_kernel(0.4, 4, t, t, t[:, :4]),
    lambda t: cuda_knn.three_nn_interpolate_kernel(t, t[:, :4], t[:, :4]),
])
def test_kernel_launchers_reject_cpu_tensors(launch, monkeypatch):
    """Asked for the kernel with a CPU tensor, a launcher raises before it
    builds anything: there is no silent plain route."""
    def no_build(*args, **kwargs):
        raise AssertionError("the kernel library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.zeros(1, 16, 3))


def test_port_imports_no_jax():
    """Importing every point2cyl_torch module (preprocessing, the HDF5
    writer, the assignment solver, profiling, the five modules of
    ``parallel/``, the low-precision dense layer and the captured steps'
    helper among them) pulls in no JAX, flax or point2cyl_tpu, and
    neither scikit-learn nor h5py (the card's machine has neither) nor
    matplotlib (imported only where a plot is drawn)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import point2cyl_torch\n"
        "for m in pkgutil.walk_packages(point2cyl_torch.__path__, 'point2cyl_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'point2cyl_tpu', 'sklearn', 'matplotlib', "
        "'h5py')]\n"
        "new = ['point2cyl_torch.' + m for m in ('data.preprocess', 'data.h5_writer', "
        "'ops.lap', 'core.profiling', 'parallel.mesh', 'parallel.distributed', "
        "'parallel.collectives', 'parallel.point_sharding', 'parallel.sharded_backbone', "
        "'ops.lowp_dense', 'core.graphs')]\n"
        "assert all(m in sys.modules for m in new), new\n"
        "print(len([m for m in sys.modules if m.startswith('point2cyl_torch')]))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 67
