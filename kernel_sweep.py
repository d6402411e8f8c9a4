"""Time the port's kernels' launch plans on one NVIDIA GPU.

    python3 kernel_sweep.py

The ordered per-target sums: the 3-NN backward and the SA2 gather
backward (items 8 and 6) at the train step's shapes (B=4: FP1, FP2 with
its cotangent a slice of a concatenation's gradient, SA2) and the SA1
gather backward (item 4) at the saliency backward's (B=4, 512 balls of 64
among 8192 points, 3 wide): the wrapper, and at SA1 also the bitmap
listing at its own plan and ``index_add_``; then every plan of targets a
CTA in {2, 4, 8, 16, 32} (bitmaps) or {64, 128, 256, 512, 1024} (counts,
SA1 only) x warps a CTA in {4, 8, 16}, and the chosen counts plan in 2
and 4 windows, each output bit-equal to the host's ordered sum, with the
list build alone beside it. ``--scatter`` stops after them; ``--split``
times instead each kernel ended after its marks or staging and after its
lists beside the whole kernel, and at SA1 the counts listing's phases in
SM cycles from each CTA's clocks; then the ball queries' split below
(``--split --scatter``: the scatters' alone).

Grouped ball queries, at SA1 (N=8192 -> 512, r=0.2, nsample 64) and SA2
(512 -> 128, r=0.4, nsample 64, C=128) at B=16, 4 and 1 (the serving
buckets and the training batch), every output held equal to the plain
version's: SA1 over ``ball_query_plan``'s choices (CTAs a row at 1 and 2
an SM, or at B=1 8 to 132, warps a CTA in {4, 8, 16, 32}, list cap in
{256, 1024, 4096}) and the grid's build alone (one query a row, N in {64,
1024, 8192}); SA2 over its stores (the bulk copy, 4-byte stores), warps a
CTA in {8, 16, 32} and CTAs a row at 1-4 an SM (at B=1 8 to 128). The
idx-only ball query at SA1 of the N=512 protocol (B=8, 512 -> 512, r=0.2,
nsample 64): its ballots at 8, 16 and 32 warps a CTA and the index-order
scan, each equal to the plain version. The plan the wrapper picks is
marked with a star. ``--ball-query`` stops after them; ``--split`` times
instead each grouped kernel beside its selection alone and a fill of its
outputs, and the idx-only kernel ended after its ballots and after its
placing beside the whole kernel and a fill of its output.

FPS: every plan (cluster CTAs per cloud in {1, 2, 4, 8, 16}) x (threads
per CTA in {128, 256, 512}) at the shapes the main path gives the
kernel: SA1 (N=8192 -> 512) and SA2 (N=512 -> 128) at B=16 (serving) and
B=4 (training, per-row random starts), and SA1 of the N=512 protocol
(B=8, 512 -> 512). Each plan's indices are checked equal to the plain
version's; a plan the kernel refuses (more than 8 points a thread, or a
cluster the card cannot hold) is listed with its error. The plan that
``fps_launch_plan`` picks is marked. 3-NN: the forward at FP2
(128 -> 512, C=256) and FP1 (512 -> 8192, C=128) at B=4 and B=16 with 1,
2 and 4 threads searching for a point, each held against the plain
version; the count ``three_nn_lanes`` picks is marked.

``--stream-split`` times only the streamed SA1 ball query (above 11,944
points, ``p2c_ball_query_stream``) at N=32,768 (B=4), 131,072 (B=4 and
1) and 2^20 (B=1): the wrapper's plan whole, its indices alone and over
the row's first 2,048 points (one block of the earlier design), beside a
fill of its outputs and where each query's 64th hit lies; then one
launch with each CTA's clock stamps (``p2c_ball_query_stream_probe``):
set-up, and per block the wait, the tests to the barrier, the placing and
the next copy's issue, in µs. ``--stream`` times SA1 and its indices
alone there and at N=16,384 (B=1 and 4): the wrappers' plans and every
streamed plan (warps a query, warps a CTA); then the idx-only query past
its ballots (N=1,025 to 11,944 at B=1, 4 and 16): the wrapper's plan,
the staged scan and the streamed plan; each equal to the plain version,
with the bound.

``--fps-large`` times only the FPS above 16,384 points (the cluster
route, ``csrc/fps_cluster.cu``, and the grid route, ``csrc/fps_grid.cu``)
and the ring FPS step (``csrc/fps_ring.cu``), and ``csrc/fps.cu`` at SA1
and SA2 (B=16) beside them: at N=32,768 (B=4), 131,072 (B=1 and 4) and
2^20 (B=1), card starts, the wrapper's plan, every cluster-route plan of
16, 8 and 4 CTAs (threads to hold the cloud at 8 points a thread) and the
grid route's plans of 1,024 and 512 threads a CTA with the CTAs that hold
the cloud (where the card holds them at once), indices checked equal to
the plain version's and the time a step (ms / (npoint - 1)) beside each;
then one ring step at P=1 from step 1's state at B=4, Nl=8,192, B=1 and 4
at Nl=131,072 and B=1 at Nl=524,288, the wrapper's plan and every plan of
(cluster in {4, 8, 16}) x (threads in {128, 256, 512, 1024}), offers and
distances bit-equal to the plain step's. With ``--default-only`` only the
wrappers' own plans.

Times are the median of 25 CUDA-event timings (``chip_smoke.time_ms``).
Each line is one JSON object; the card's name and power limit come first.

    python3 kernel_sweep.py --default-only

times only what the wrappers choose themselves at the same shapes,
through arguments every version of the port takes, so that the script,
copied into an unpacked older commit and run there, times that commit's
kernels at the same shapes.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import sys

import numpy as np
import torch

from chip_smoke import card_line, clouds, time_ms

CLUSTERS = (1, 2, 4, 8, 16)
THREADS = (128, 256, 512)
LANES = (1, 2, 4)


def grouping_inputs(b: int, dev: torch.device, rng: np.random.Generator) -> dict:
    """The grouped ball queries' inputs at the main path's shapes: SA1
    (N=8192 -> 512 FPS centres, r=0.2, nsample 64) and SA2 (those 512 ->
    128 centres, r=0.4, nsample 64, C=128 features from a numpy seed)."""
    from point2cyl_torch.ops import cuda_fps

    pts = torch.from_numpy(clouds(30 + b, b, 8192)).to(dev)
    rows = torch.arange(b, device=dev)[:, None]
    with torch.inference_mode():
        l1 = pts[rows, cuda_fps.farthest_point_sample_kernel(pts, 512).long()].contiguous()
        l2 = l1[rows, cuda_fps.farthest_point_sample_kernel(l1, 128).long()].contiguous()
    feats = torch.from_numpy(rng.normal(size=(b, 512, 128)).astype(np.float32)).to(dev)
    return {"sa1": (0.2, 64, pts, l1), "sa2": (0.4, 64, l1, feats, l2)}


def grid_select(radius: float, ns: int, xyz: torch.Tensor,
                new_xyz: torch.Tensor) -> torch.Tensor:
    """SA1's grid kernel without its gather (a null ``grouped``), at the
    wrapper's plan: the selection alone. Called through the library's
    entry point, as the wrapper always gathers."""
    from point2cyl_torch.ops import _build, cuda_ballquery
    from point2cyl_torch.ops.grouping import radius_squared

    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    plan = cuda_ballquery.ball_query_plan(b, n, s, ns)
    idx = torch.empty((b, s, ns), dtype=torch.int32, device=xyz.device)
    fn = _build.function("p2c_ball_query_grouped", cuda_ballquery._ARGS_GROUPED)
    status = fn(xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(), None, b, n, s, ns,
                radius_squared(radius), plan.ctas, plan.warps, plan.cap, torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check("p2c_ball_query_grouped (selection alone)", status)
    return idx


def split_ball_query(dev: torch.device, rng: np.random.Generator) -> None:
    """Selection alone beside the whole SA1 and SA2 kernels, and a fill of
    their outputs (the write at the card's store rate), at B=16 and B=4.
    Selection alone: the idx-only kernel (the index-order scan, SA2's
    selection) and, at SA1, the grid kernel without its gather (where the
    port has it). Every output is checked equal to the plain version's."""
    from point2cyl_torch.ops import cuda_ballquery
    from point2cyl_torch.ops.grouping import ball_query_plain

    with torch.inference_mode():
        for b in (16, 4):
            inputs = grouping_inputs(b, dev, rng)
            for stage, kernel, plain in (
                    ("sa1", cuda_ballquery.ball_query_grouped_kernel,
                     cuda_ballquery.ball_query_grouped_plain),
                    ("sa2", cuda_ballquery.sa_grouped_exact_kernel,
                     cuda_ballquery.sa_grouped_exact_plain)):
                args = inputs[stage]
                radius, ns, xyz, new_xyz = args[0], args[1], args[2], args[-1]
                idx, grouped = kernel(*args)
                want = plain(*args)
                # the index-order scan of the idx-only kernel: SA2's selection
                scan = cuda_ballquery.ball_query_plan(b, xyz.shape[1], new_xyz.shape[1], ns,
                                                      gather=False, select="scan")
                scan_idx = cuda_ballquery.ball_query_kernel(radius, ns, xyz, new_xyz, scan)
                if not (torch.equal(idx, want[0]) and torch.equal(grouped, want[1])
                        and torch.equal(scan_idx, want[0])):
                    sys.exit(f"kernel_sweep: {stage} B={b} differs from plain")
                row = {"split": f"{stage} B={b}",
                       "scan_select_ms": time_ms(lambda: cuda_ballquery.ball_query_kernel(
                           radius, ns, xyz, new_xyz, scan))}
                if stage == "sa1" and hasattr(cuda_ballquery, "ball_query_plan"):
                    if not torch.equal(grid_select(*args), want[0]):
                        sys.exit(f"kernel_sweep: {stage} B={b} grid selection differs")
                    row["grid_select_ms"] = time_ms(lambda: grid_select(*args))
                row.update(whole_ms=time_ms(lambda: kernel(*args)),
                           fill_outputs_ms=time_ms(lambda: (idx.fill_(0), grouped.fill_(0.0))),
                           grouped_mb=grouped.numel() * 4 / 1e6)
                print(json.dumps(row), flush=True)
        # the idx-only kernel at the N=512 protocol: ended after its ballots,
        # after its placing, whole, and a fill of its output
        radius, ns, xyz, new_xyz = n512_inputs(dev)
        idx = cuda_ballquery.ball_query_kernel(radius, ns, xyz, new_xyz)
        if not torch.equal(idx, ball_query_plain(radius, ns, xyz, new_xyz)):
            sys.exit("kernel_sweep: idx-only N=512 differs from plain")
        row = {"split": "idx-only N=512 B=8",
               "plan": cuda_ballquery.ball_query_plan(8, 512, 512, ns, gather=False)._asdict()}
        for stop, phase in ((1, "ballots_ms"), (2, "placed_ms")):
            row[phase] = time_ms(lambda: ballot_probe(stop, radius, ns, xyz, new_xyz))
        row.update(whole_ms=time_ms(lambda: cuda_ballquery.ball_query_kernel(
            radius, ns, xyz, new_xyz)), fill_output_ms=time_ms(lambda: idx.fill_(0)))
        print(json.dumps(row), flush=True)


# phase 17b's shapes of the streamed SA1 query: (B, N)
STREAM_SHAPES = ((4, 32768), (4, 131072), (1, 131072), (1, 2**20))
# the idx-only query's shapes past its ballots: (B, N)
IDX_BAND = tuple((b, n) for n in (1025, 1280, 1536, 1792, 2048, 4096, 8192, 11944)
                 for b in (1, 4, 16))
# points of the row the split's "one block" runs keep (a tile of the
# streamed query's earlier design)
ONE_BLOCK = 2048


def stream_inputs(b: int, n: int, dev: torch.device, rng: np.random.Generator) -> tuple:
    """SA1 at N points (r=0.2, nsample 64): phase 17a's clouds and 512 FPS
    centres from a random start, as ``chip_smoke.large_kernel_checks``
    makes them."""
    from point2cyl_torch.ops import cuda_fps
    from point2cyl_torch.ops.grouping import index_points

    xyz = torch.from_numpy(clouds(1700 + n % 1000 + b, b, n)).to(dev)
    start = torch.from_numpy(rng.integers(0, n, size=b)).to(dev)
    with torch.inference_mode():
        centres = index_points(xyz, cuda_fps.farthest_point_sample(xyz, 512, start))
    return 0.2, 64, xyz, centres.contiguous()


def hit_positions(idx: torch.Tensor, n: int, per_cta: int) -> dict:
    """Where each query's nsample-th in-radius point lies in its row (N
    where the row is short), from the plain version's indices: the median
    over the queries, and over the CTAs of ``per_cta`` queries the median
    and the largest of each CTA's farthest."""
    full = idx[..., -1] != idx[..., 0]
    pos = torch.where(full, idx[..., -1].long() + 1, n).cpu()
    b, s = pos.shape
    pad = -(-s // per_cta) * per_cta - s
    cta = torch.cat([pos, pos.new_zeros(b, pad)], dim=1).reshape(b, -1, per_cta).amax(-1)
    return {"query_median": int(pos.median()), "cta_max_median": int(cta.median()),
            "cta_max": int(cta.max()), "short_rows": int((~full).sum())}


def split_stream(dev: torch.device, rng: np.random.Generator) -> None:
    """``--stream-split``: the streamed SA1 query at phase 17b's shapes,
    each output checked equal to the plain version's: the whole kernel at
    the wrapper's plan, its indices alone (no gather), and the same plan
    over the row's first ``ONE_BLOCK`` points (one block a query: a tile
    of the earlier design), beside a fill of the outputs (the launch
    floor) and the distribution of each query's nsample-th hit; then one
    launch's phases from its clock stamps (:func:`stream_phases`)."""
    from point2cyl_torch.ops import cuda_ballquery
    from point2cyl_torch.ops.grouping import ball_query_plain

    kernel = cuda_ballquery.ball_query_stream_kernel
    with torch.inference_mode():
        for b, n in STREAM_SHAPES:
            radius, ns, xyz, centres = stream_inputs(b, n, dev, rng)
            s = centres.shape[1]
            plan = cuda_ballquery.ball_query_plan(b, n, s, ns, select="stream")
            want = cuda_ballquery.ball_query_grouped_plain(radius, ns, xyz, centres)
            idx, grouped = kernel(radius, ns, xyz, centres)
            alone = kernel(radius, ns, xyz, centres, gather=False)
            tile = xyz[:, :ONE_BLOCK].contiguous()
            want_tile = ball_query_plain(radius, ns, tile, centres)
            if not (torch.equal(idx, want[0]) and torch.equal(grouped, want[1])
                    and torch.equal(alone, want[0])
                    and torch.equal(kernel(radius, ns, tile, centres, plan)[0], want_tile)):
                sys.exit(f"kernel_sweep: streamed query B={b} N={n} differs from plain")
            print(json.dumps({
                "stream_split": f"N={n} B={b}", "plan": plan._asdict(),
                "whole_ms": time_ms(lambda: kernel(radius, ns, xyz, centres)),
                "idx_only_ms": time_ms(lambda: kernel(radius, ns, xyz, centres, gather=False)),
                "one_block_ms": time_ms(lambda: kernel(radius, ns, tile, centres, plan)),
                "fill_outputs_ms": time_ms(lambda: (idx.fill_(0), grouped.fill_(0.0))),
                "nsample_th_hit": hit_positions(want[0], n, plan.warps // plan.group)}),
                flush=True)
            # the phases of one launch at the wrapper's plan
            print(json.dumps({"stream_phases": f"N={n} B={b}", "plan": plan._asdict(),
                              **stream_phases((radius, ns, xyz, centres), plan)}), flush=True)
            del xyz, tile


# xyz, new_xyz, idx, grouped; b, n, s, ns; r2; ctas, warps, group; stamps;
# stream
_ARGS_STREAM_PROBE = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)


def stream_phases(inputs: tuple, plan) -> dict:
    """One launch of the streamed query at ``plan`` with each CTA's clock
    stamps (``p2c_ball_query_stream_probe``): the medians over the CTAs, in
    µs, of the set-up, each block's wait, tests to the barrier, placing and
    next copy's issue (the first 12 blocks), the drain and the end; the CTAs'
    spread of start times, their median span and the launch's span (first
    start to last end, global timer), and the blocks tested (median and
    most); cycles become µs at each CTA's clock over its global-timer
    span."""
    from point2cyl_torch.ops import _build, cuda_ballquery
    from point2cyl_torch.ops.grouping import radius_squared

    radius, ns, xyz, centres = inputs
    b, n, _ = xyz.shape
    s = centres.shape[1]
    idx = torch.empty((b, s, ns), dtype=torch.int32, device=xyz.device)
    grouped = torch.empty((b, s, ns, 3), device=xyz.device)
    stamps = torch.zeros((b * plan.ctas, 64), dtype=torch.int64, device=xyz.device)
    fn = _build.function("p2c_ball_query_stream_probe", _ARGS_STREAM_PROBE)
    status = fn(xyz.data_ptr(), centres.data_ptr(), idx.data_ptr(), grouped.data_ptr(), b, n,
                s, ns, radius_squared(radius), plan.ctas, plan.warps, plan.group,
                stamps.data_ptr(),
                torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check("p2c_ball_query_stream_probe", status)
    want = cuda_ballquery.ball_query_grouped_plain(radius, ns, xyz, centres)
    if not (torch.equal(idx, want[0]) and torch.equal(grouped, want[1])):
        sys.exit(f"kernel_sweep: the probed streamed query {plan} differs from plain")
    st = stamps.cpu().double()
    per_us = (st[:, 51] - st[:, 0]) / ((st[:, 53] - st[:, 52]) / 1e3)  # cycles a µs

    def med(a, c):
        return round(float(((st[:, c] - st[:, a]) / per_us).median()), 3)

    blocks = int(st[:, 54].median())
    row = {"setup_us": med(0, 1), "blocks": blocks + 1, "most_blocks": int(st[:, 54].max()) + 1,
           "start_spread_us": round(float(st[:, 52].max() - st[:, 52].min()) / 1e3, 3),
           "span_us": round(float((st[:, 53] - st[:, 52]).median()) / 1e3, 3),
           "launch_span_us": round(float(st[:, 53].max() - st[:, 52].min()) / 1e3, 3),
           "mhz": round(float(per_us.median()), 1)}
    prev = 1
    for k in range(min(blocks + 1, 12)):
        row[f"block{k}"] = [med(prev, 2 + 4 * k), med(2 + 4 * k, 3 + 4 * k),
                            med(3 + 4 * k, 4 + 4 * k)]
        if k < blocks:  # the median CTA's last block copies nothing after it
            row[f"block{k}"].append(med(4 + 4 * k, 5 + 4 * k))
        prev = 5 + 4 * k
    if blocks < 12:
        row["drain_us"] = med(4 + 4 * blocks, 50)
    row["end_us"] = med(50, 51)
    return row


def stream_plans(b: int, n: int, s: int, ns: int, default) -> list:
    """Every plan of the streamed query worth timing at (B, N): warps a
    query in {1, 2, 4, 8, 16} x warps a CTA in {4, 8, 16, 32}, where they
    fit; the wrapper's own first."""
    from point2cyl_torch.ops import cuda_ballquery

    plans = [default]
    for group, warps in itertools.product((1, 2, 4, 8, 16), (4, 8, 16, 32)):
        plan = cuda_ballquery.ball_query_plan(b, n, s, ns, select="stream", group=group,
                                              warps=warps)
        if plan is not None and plan not in plans:
            plans.append(plan)
    return plans


def sweep_stream(dev: torch.device, rng: np.random.Generator, default_only: bool) -> None:
    """``--stream``: SA1 (and its indices alone) at phase 17b's shapes and
    at N=16,384 (B=1 and 4), each output checked equal to the plain
    version's, with the bound of ``chip_smoke.group_work``: the wrappers'
    own plans and, unless ``default_only``, every plan of
    :func:`stream_plans`; then the idx-only query at ``IDX_BAND`` (bound
    of ``chip_smoke.query_work``). The plan the wrapper picks is
    marked."""
    from chip_smoke import bound, group_work, query_work
    from point2cyl_torch.ops import cuda_ballquery
    from point2cyl_torch.ops.grouping import ball_query_plain

    with torch.inference_mode():
        for b, n in (*STREAM_SHAPES, (1, 16384), (4, 16384)):
            radius, ns, xyz, centres = stream_inputs(b, n, dev, rng)
            s = centres.shape[1]
            want = cuda_ballquery.ball_query_grouped_plain(radius, ns, xyz, centres)
            bound_ms, bound_by = bound(*group_work(xyz, centres, want[0], 3))
            label = f"N={n} B={b}"
            for gather in (True, False):
                chosen = cuda_ballquery.ball_query_plan(b, n, s, ns, gather=gather)
                if gather:
                    def call(plan=None):
                        extra = {} if plan is None else {"plan": plan}
                        return cuda_ballquery.ball_query_grouped_kernel(
                            radius, ns, xyz, centres, **extra)
                else:
                    def call(plan=None):
                        extra = {} if plan is None else {"plan": plan}
                        return (cuda_ballquery.ball_query_kernel(radius, ns, xyz, centres,
                                                                  **extra), None)
                plans = [None]
                if gather and not default_only:
                    plans += stream_plans(b, n, s, ns, cuda_ballquery.ball_query_plan(
                        b, n, s, ns, select="stream"))
                for plan in plans:
                    got = call(plan)
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], want[0])
                            and (got[1] is None or torch.equal(got[1], want[1]))):
                        sys.exit(f"kernel_sweep: {label} plan {plan} differs from plain")
                    print(json.dumps({
                        "stream": label, "gather": gather,
                        "plan": "default" if plan is None else plan._asdict(),
                        "chosen": plan is None or plan == chosen,
                        "default_plan": chosen._asdict(), "ms": time_ms(lambda: call(plan)),
                        "bound_ms": bound_ms, "bound_by": bound_by}), flush=True)
            del xyz
        # the idx-only query past its ballots (N > 1024): the wrapper's plan
        # and, unless default_only, the staged scan and the streamed plan
        for b, n in IDX_BAND:
            radius, ns, xyz, centres = stream_inputs(b, n, dev, rng)
            s = centres.shape[1]
            want = ball_query_plain(radius, ns, xyz, centres)
            bound_ms, bound_by = bound(*query_work(xyz, centres, want))
            chosen = cuda_ballquery.ball_query_plan(b, n, s, ns, gather=False)
            plans = [None]
            for select in () if default_only else ("scan", "stream"):
                other = cuda_ballquery.ball_query_plan(b, n, s, ns, gather=False,
                                                       select=select)
                if other is not None and other != chosen:
                    plans.append(other)
            for plan in plans:
                extra = {} if plan is None else {"plan": plan}
                got = cuda_ballquery.ball_query_kernel(radius, ns, xyz, centres, **extra)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    sys.exit(f"kernel_sweep: idx-only N={n} B={b} plan {plan} differs")
                print(json.dumps({
                    "idx_band": f"N={n} B={b}",
                    "plan": "default" if plan is None else plan._asdict(),
                    "default_plan": chosen._asdict(), "ms": time_ms(
                        lambda: cuda_ballquery.ball_query_kernel(radius, ns, xyz, centres,
                                                                 **extra)),
                    "bound_ms": bound_ms, "bound_by": bound_by}), flush=True)


def n512_inputs(dev: torch.device) -> tuple:
    """SA1 of the N=512 protocol: 8 clouds of 512 points, their 512 FPS
    centres, r=0.2, nsample 64 (the idx-only ball query's inputs)."""
    from point2cyl_torch.ops import cuda_fps
    from point2cyl_torch.ops.grouping import index_points

    xyz = torch.from_numpy(clouds(2, 8, 512)).to(dev)
    with torch.inference_mode():
        centres = index_points(xyz, cuda_fps.farthest_point_sample_plain(xyz, 512))
    return 0.2, 64, xyz, centres.contiguous()


# p2c_ball_query_probe (csrc/ballquery.cu): stop; xyz, new_xyz, idx; b, n,
# s, ns; r2; ctas, warps; stream
BALLOT_PROBE_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                     + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def ballot_probe(stop: int, radius: float, ns: int, xyz: torch.Tensor,
                 new_xyz: torch.Tensor) -> None:
    """The idx-only ballot kernel at the wrapper's plan, ended after its
    ballots (stop 1) or its placing (stop 2), through the measurement-only
    entry point."""
    from point2cyl_torch.ops import _build, cuda_ballquery
    from point2cyl_torch.ops.grouping import radius_squared

    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    plan = cuda_ballquery.ball_query_plan(b, n, s, ns, gather=False)
    idx = torch.empty((b, s, ns), dtype=torch.int32, device=xyz.device)
    fn = _build.function("p2c_ball_query_probe", BALLOT_PROBE_ARGS)
    status = fn(stop, xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(), b, n, s, ns,
                radius_squared(radius), plan.ctas, plan.warps,
                torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check("p2c_ball_query_probe", status)


def scatter_inputs(dev: torch.device, rng: np.random.Generator, b: int = 4) -> list:
    """Items 8 and 6 at the train step's shapes: FP1 (each of 8192 points'
    3 sources among 512, g (B, 8192, 128)), FP2 (512 points among 128, g
    (B, 512, 256), the slice of a (B, 512, 384) gradient that the step
    passes) and SA2 (128 balls of 64 among 512 points, dg (B, 128, 64,
    131)); item 4 at the saliency backward's, SA1 (512 balls of 64 among
    8192 points, dg (B, 512, 64, 3)); sources and balls from the plain
    versions on FPS centres, cotangents from a numpy seed. Each entry:
    label, kind, arguments of the wrapper."""
    from point2cyl_torch.ops import cuda_ballquery
    from point2cyl_torch.ops.grouping import three_nn_weights_plain

    inputs = grouping_inputs(b, dev, rng)
    pts, l1 = inputs["sa1"][2:]
    l2 = inputs["sa2"][4]

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def sources(dst, src):
        idx, w = three_nn_weights_plain(dst, src)
        return idx.to(torch.int32).contiguous(), w.contiguous()

    with torch.inference_mode():
        idx_sa1 = cuda_ballquery.ball_query_grouped_plain(*inputs["sa1"])[0]
        idx_sa2 = cuda_ballquery.sa_grouped_exact_plain(*inputs["sa2"])[0]
        return [
            ("fp1", "three_nn", (*sources(pts, l1), normal(b, 8192, 128), 512)),
            ("fp2", "three_nn", (*sources(l1, l2), normal(b, 512, 384)[..., 128:], 128)),
            ("sa2", "group", (idx_sa2, normal(b, 128, 64, 131), 512)),
            ("sa1", "group", (idx_sa1, normal(b, 512, 64, 3), 8192)),
        ]


def split_scatter(dev: torch.device, rng: np.random.Generator) -> None:
    """Items 8, 6 and 4 at their shapes (B=4): the kernel ended after each
    phase (the marks or staging, the lists) beside the whole kernel, and
    for the counts listing its phases from the CTAs' clocks, with the
    longest and the mean list, and the whole kernel on targets drawn
    uniformly (the skew's cost); the whole kernel is checked bit-equal to
    the host's ordered sum."""
    from chip_smoke import same_bits

    with torch.inference_mode():
        for label, kind, args in scatter_inputs(dev, rng):
            if not same_bits(ordered_sum(kind, args), scatter_want(args)):
                sys.exit(f"kernel_sweep: the ordered sum at {label} differs from the host's")
            row = {"split": f"{label} B={args[0].shape[0]}",
                   "listing": scatter_plan_of(args).listing}
            for stop, phase in ((1, "marked_ms"), (2, "listed_ms")):
                row[phase] = time_ms(lambda: ordered_sum(kind, args, stop=stop))
            row["whole_ms"] = time_ms(lambda: ordered_sum(kind, args))
            if row["listing"] == "counts":
                row.update(phase_clocks(kind, args))
            sizes = torch.stack([torch.bincount(r.reshape(-1).long(), minlength=args[-1])
                                 for r in args[0]])
            row.update(longest_list=int(sizes.max()), mean_list=float(sizes.float().mean()))
            # the same work with targets drawn uniformly: what the skew costs
            flat = torch.from_numpy(rng.integers(0, args[-1], size=tuple(args[0].shape),
                                                 dtype=np.int32)).to(dev)
            row["uniform_targets_ms"] = time_ms(lambda: ordered_sum(kind, (flat, *args[1:])))
            print(json.dumps(row), flush=True)


def phase_clocks(kind: str, args: tuple) -> dict:
    """The counts listing's phases from each CTA's clocks (median over 25
    runs of the median and the largest over the CTAs, in SM cycles): from
    its start to the end of the counts' zeroing, the staging, the scan and
    placing, and the sorts with the sums (a thread or a warp a target sums
    the list it sorted); the kernel's span and the spread of the CTAs'
    starts on the global timer (ns)."""
    runs = [ordered_sum(kind, args, stop=3).cpu().numpy() for _ in range(25)]
    names = ("zeroing", "staging", "scan_and_placing", "sorts_and_sums")
    out = {}
    for i, name in enumerate(names):
        spans = np.stack([r[:, i + 1] - r[:, i] for r in runs])
        out[f"{name}_cycles"] = float(np.median(np.median(spans, 1)))
        out[f"{name}_cycles_max"] = float(np.median(spans.max(1)))
    out["span_ns"] = float(np.median([r[:, 6].max() - r[:, 5].min() for r in runs]))
    out["start_spread_ns"] = float(np.median([r[:, 5].max() - r[:, 5].min() for r in runs]))
    return out


# p2c_target_sum_probe (csrc/target_sum.cu): three_nn, stop; idx, w, g;
# g_batch, g_row; out; b, targets, entries, c, per_cta, warps, window,
# listing; stream
PROBE_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
              + [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def scatter_plan_of(args: tuple, **override):
    """The wrapper's plan for an ordered sum's wrapper arguments (B,
    targets and entries a cloud from idx and the target count; for a
    gather's backward its rows' width, where the port's plan takes it), or
    with ``override``."""
    from point2cyl_torch.ops import cuda_scatter

    if len(args) == 3 and hasattr(cuda_scatter, "LISTINGS"):
        override = {"group_width": args[1].shape[-1], **override}
    return cuda_scatter.scatter_plan(args[0].shape[0], args[-1], args[0][0].numel(),
                                     **override)


def ordered_sum(kind: str, args: tuple, plan=None, stop: int = 0) -> torch.Tensor:
    """The ordered per-target sum of the wrapper's arguments ``args`` at the
    wrapper's plan (or ``plan``); ``stop`` 1 or 2 launches instead the
    measurement entry point, which ends the kernel after the marks or
    staging or after the lists and writes no output, to time the phases;
    ``stop`` 3 (counts listing) runs it whole and returns each CTA's 8
    clocks (``p2c_target_sum_probe``)."""
    from point2cyl_torch.ops import _build, cuda_scatter

    if kind == "three_nn":
        idx, w, g, targets = args
        b, n, c = g.shape
        entries, row = 3 * n, g.stride(1)
    else:
        idx, g, targets = args
        w, (b, *_, c) = None, g.shape
        entries, row = idx.shape[1] * idx.shape[2], g.stride(2)
    plan = plan or scatter_plan_of(args)
    # stop 3: room past the output for each CTA's 8 clocks (8-byte aligned)
    room = 16 * b * plan.ctas if stop == 3 else 0
    out = torch.empty(((b * targets * c + 1) // 2 * 2 + room,), device=g.device)
    if stop:
        fn = _build.function("p2c_target_sum_probe", PROBE_ARGS)
        status = fn(int(kind == "three_nn"), stop, idx.data_ptr(),
                    w.data_ptr() if w is not None else None, g.data_ptr(), g.stride(0), row,
                    out.data_ptr(), b, targets, entries, c, plan.targets, plan.warps,
                    plan.window, cuda_scatter.LISTINGS.index(plan.listing),
                    torch.cuda.current_stream(g.device).cuda_stream)
        _build.check("p2c_target_sum_probe", status)
        return out[-room:].view(torch.int64).view(b * plan.ctas, 8) if stop == 3 else out
    out = out[:b * targets * c].view(b, targets, c)
    if kind == "three_nn":
        cuda_scatter.launch_three_nn(idx, w, g, out, plan)
    else:
        cuda_scatter.launch_group(idx, g, out, plan)
    return out


def scatter_want(args: tuple) -> torch.Tensor:
    """The host's ordered sum of the same terms, on the card."""
    from chip_smoke import host_ordered_sum

    return torch.from_numpy(host_ordered_sum(args)).to(args[0].device)


def sweep_scatter(dev: torch.device, rng: np.random.Generator, default_only: bool) -> None:
    """Items 8, 6 and 4 at their shapes (B=4): the wrappers' own plans and,
    at SA1, the bitmap listing's own plan through the same launch and
    ``index_add_``; or (full sweep) every plan of targets a CTA x warps a
    CTA of each listing the shape takes, each checked against the host's
    ordered sum (bit for bit where the port has the ordered sums, else
    within 1e-4 of the plain version). FP2 also with g contiguous; an
    older port, whose kernel takes only a contiguous g, is timed with the
    copy the step made for it."""
    from chip_smoke import index_add_call, same_bits
    from point2cyl_torch.ops import cuda_ballquery, cuda_knn, cuda_scatter

    ordered = hasattr(cuda_knn, "cuda_scatter")
    # a port with the counts listing sums SA1's gather backward in order too
    counts = hasattr(cuda_scatter, "LISTINGS")
    with torch.inference_mode():
        for label, kind, args in scatter_inputs(dev, rng):
            wrapper = (cuda_knn.three_nn_backward_kernel if kind == "three_nn"
                       else cuda_ballquery.ball_query_grouped_backward_kernel if label == "sa1"
                       else cuda_ballquery.sa_grouped_backward_kernel)
            exact = counts if label == "sa1" else ordered
            want = scatter_want(args)
            variants = [("", args)]
            if not args[2 if kind == "three_nn" else 1].is_contiguous():
                contiguous = list(args)
                contiguous[2] = args[2].contiguous()
                variants.append((" g contiguous", tuple(contiguous)))

            def call(a):
                if ordered or a[2 if kind == "three_nn" else 1].is_contiguous():
                    return wrapper(*a)
                g = a[2].contiguous()  # the copy the step made for the atomic design
                return wrapper(a[0], a[1], g, a[3])

            def report(name, plan, fn):
                got = fn()
                torch.cuda.synchronize()
                row = {"scatter": name, "plan": plan, "host_equal": same_bits(got, want),
                       "max_abs_err": float((got - want).abs().max()), "ms": time_ms(fn)}
                print(json.dumps(row), flush=True)
                return row

            for suffix, a in variants:
                row = report(f"{label} B=4{suffix}", "default", lambda: call(a))
                if exact and not row["host_equal"] or row["max_abs_err"] > 1e-4:
                    sys.exit(f"kernel_sweep: scatter {label} differs from the host sum")
            if label == "sa1":
                # the bitmap listing at its own plan, and one PyTorch call
                bitmaps = scatter_plan_of(args, **({"listing": "bitmaps"} if counts else {}))
                row = report("sa1 B=4 bitmaps", bitmaps._asdict(),
                             lambda: ordered_sum(kind, args, bitmaps))
                if not row["host_equal"]:
                    sys.exit("kernel_sweep: scatter sa1 bitmaps differs from the host sum")
                library = index_add_call(*args)
                row = report("sa1 B=4 index_add_", None,
                             lambda: library().reshape(want.shape))
                if row["max_abs_err"] > 1e-4:
                    sys.exit("kernel_sweep: index_add_ at sa1 differs from the host sum")
            if default_only:
                continue
            chosen = scatter_plan_of(args)
            listings = ("bitmaps", "counts") if label == "sa1" else ("bitmaps",)
            for listing in listings:
                sizes = (64, 128, 256, 512, 1024) if listing == "counts" else (2, 4, 8, 16, 32)
                plans = [scatter_plan_of(args, per_cta=per_cta, warps=warps, listing=listing)
                         for per_cta, warps in itertools.product(sizes, (4, 8, 16))]
                if listing == "counts":  # the chosen plan in 2 and 4 windows
                    entries = args[0][0].numel()
                    plans += [chosen._replace(window=cuda_scatter.sum_window(entries, k),
                                              windows=k, smem=cuda_scatter.list_smem(
                                                  cuda_scatter.sum_window(entries, k),
                                                  chosen.targets)) for k in (2, 4)]
                for plan in plans:
                    got = ordered_sum(kind, args, plan)
                    torch.cuda.synchronize()
                    row = {"scatter": f"{label} B=4" + (" *" if plan == chosen else ""),
                           "plan": plan._asdict(), "host_equal": same_bits(got, want),
                           "ms": time_ms(lambda: ordered_sum(kind, args, plan)),
                           "listed_ms": time_ms(lambda: ordered_sum(kind, args, plan, stop=2))}
                    print(json.dumps(row), flush=True)
                    if not row["host_equal"]:
                        sys.exit(f"kernel_sweep: scatter {label} {plan} differs")


def sweep_ball_query(dev: torch.device, rng: np.random.Generator, default_only: bool) -> None:
    """The idx-only ball query at the N=512 protocol, then the SA1 and SA2
    grouped ball queries at B=16, 4 and 1: the wrappers' own plans, or
    (full sweep) every plan below, each checked equal to the plain
    version. SA1 also with one query a row, which leaves each CTA's grid
    build and little else."""
    from point2cyl_torch.ops import cuda_ballquery
    from point2cyl_torch.ops.grouping import ball_query_plain

    def run(label, kernel, want, args, plan=None):
        extra = {} if plan is None else {"plan": plan}
        got = kernel(*args, **extra)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got[0], want[0]) and (want[1] is None
                                                        or torch.equal(got[1], want[1])))
        row = {"ball_query": label, "plan": "default" if plan is None else plan._asdict(),
               "equal": equal, "ms": time_ms(lambda: kernel(*args, **extra))}
        print(json.dumps(row), flush=True)
        if not equal:
            sys.exit(f"kernel_sweep: {label} differs from plain")

    sa1_kernel = cuda_ballquery.ball_query_grouped_kernel
    sa2_kernel = cuda_ballquery.sa_grouped_exact_kernel
    with torch.inference_mode():
        # the idx-only kernel at the N=512 protocol (its indices alone)
        radius, ns, xyz, new_xyz = n512_inputs(dev)
        want = ball_query_plain(radius, ns, xyz, new_xyz)

        def idx_only(*args, plan=None):
            extra = {} if plan is None else {"plan": plan}
            return (cuda_ballquery.ball_query_kernel(*args, **extra), None)

        args = (radius, ns, xyz, new_xyz)
        run("idx-only N=512 B=8", idx_only, (want, None), args)
        if not default_only:
            chosen = cuda_ballquery.ball_query_plan(8, 512, 512, ns, gather=False)
            for p in [cuda_ballquery.ball_query_plan(8, 512, 512, ns, gather=False, warps=w)
                      for w in (8, 16, 32)] + [cuda_ballquery.ball_query_plan(
                          8, 512, 512, ns, gather=False, select="scan")]:
                run("idx-only N=512 B=8" + (" *" if p == chosen else ""), idx_only,
                    (want, None), args, p)
        for b in (16, 4, 1):
            inputs = grouping_inputs(b, dev, rng)
            sa1, sa2 = inputs["sa1"], inputs["sa2"]
            want1 = cuda_ballquery.ball_query_grouped_plain(*sa1)
            want2 = cuda_ballquery.sa_grouped_exact_plain(*sa2)
            if default_only:
                run(f"sa1 B={b}", sa1_kernel, want1, sa1)
                run(f"sa2 B={b}", sa2_kernel, want2, sa2)
                continue
            plan = cuda_ballquery.ball_query_plan
            s1, s2 = sa1[3].shape[1], sa2[4].shape[1]
            chosen = plan(b, 8192, s1, 64)
            for n in (64, 1024, 8192):
                # the build alone: every CTA builds its row's grid of n points
                one = (*sa1[:2], sa1[2][:, :n].contiguous(), sa1[3][:, :1].contiguous())
                run(f"sa1 B={b} N={n}, one query a row (the build)", sa1_kernel,
                    cuda_ballquery.ball_query_grouped_plain(*one), one,
                    plan(b, n, 1, 64, ctas=chosen.ctas, warps=chosen.warps))
            # CTAs a row: 1 or 2 an SM over the batch; at B=1 also fewer,
            # each CTA building the whole row's grid
            ctas1 = (8, 16, 33, 66, 132) if b == 1 else (132 // b, 264 // b)
            for ctas in ctas1:
                for warps in (4, 8, 16, 32) if b == 1 else (8, 16, 32):
                    for cap in (256, 1024, 4096) if b > 1 else (1024,):
                        p = plan(b, 8192, s1, 64, ctas=ctas, warps=warps, cap=cap)
                        if p is not None and (b > 1 or ctas * warps <= 2 * s1):
                            run(f"sa1 B={b}" + (" *" if p == chosen else ""),
                                sa1_kernel, want1, sa1, p)
            chosen = plan(b, 512, s2, 64, 128)
            ctas2 = ((8, 16, 32, 64, 128) if b == 1
                     else [min(s2, per_sm * 132 // b) for per_sm in (1, 2, 3, 4)])
            for store in ("bulk", "scalar"):
                for warps in (8, 16, 32):
                    for ctas in ctas2:
                        p = plan(b, 512, s2, 64, 128, warps=warps, store=store, ctas=ctas)
                        run(f"sa2 B={b} {store}" + (" *" if p == chosen else ""),
                            sa2_kernel, want2, sa2, p)


def sweep_fps_large(dev: torch.device, rng: np.random.Generator, default_only: bool) -> None:
    """``--fps-large``: the FPS above 16,384 points and the ring step (see
    the module's docstring). A plan the kernel refuses is listed with its
    error."""
    from point2cyl_torch.ops import cuda_fps
    from point2cyl_torch.ops.sampling import fps_ring_offers, fps_ring_step_plain

    npoint = 512
    ppt = cuda_fps.GRID_PPT

    def timed(row, fn, equal, steps=0):
        try:
            got = fn()
            torch.cuda.synchronize()
        except RuntimeError as err:
            row["refused"] = str(err).splitlines()[0]
            print(json.dumps(row), flush=True)
            return
        row["equal"] = equal(got)
        if not row["equal"]:
            print(json.dumps(row), flush=True)
            sys.exit(f"kernel_sweep: {row} differs from plain")
        row["ms"] = time_ms(fn)
        if steps:
            row["us_per_step"] = row["ms"] * 1e3 / steps
        print(json.dumps(row), flush=True)

    with torch.inference_mode():
        # fps.cu at the serving shapes (B=16: SA1 8192 -> 512, SA2 512 -> 128)
        sa1 = torch.from_numpy(clouds(26, 16, 8192)).to(dev)
        sa2 = sa1[:, :512].contiguous()
        for label, xyz, m in (("sa1 B=16", sa1, 512), ("sa2 B=16", sa2, 128)):
            want = cuda_fps.farthest_point_sample_plain(xyz, m, 0)
            timed({"fps": label, "plan": "default"},
                  lambda: cuda_fps.farthest_point_sample_kernel(xyz, m, 0),
                  lambda got: bool(torch.equal(got, want)))
        for b, n in ((4, 32768), (1, 131072), (4, 131072), (1, 2**20)):
            xyz = torch.from_numpy(clouds(1700 + n % 1000 + b, b, n)).to(dev)
            start = torch.from_numpy(rng.integers(0, n, size=b)).to(dev)
            want = cuda_fps.farthest_point_sample_plain(xyz, npoint, start)
            chosen = cuda_fps.fps_grid_plan(b, n)
            plans = [None]
            if not default_only:
                for ctas in (16, 8, 4):
                    threads = 256
                    while ctas * threads * ppt < n and threads < 1024:
                        threads *= 2
                    if ctas * threads * ppt >= n:
                        plans.append(cuda_fps.FpsGridPlan("cluster", ctas, threads, 0))
                for threads in (1024, 512):
                    ctas = -(-n // (threads * ppt))
                    if b * ctas <= cuda_fps.H100_SMS * cuda_fps.grid_blocks_per_sm(threads):
                        plans.append(cuda_fps.FpsGridPlan("grid", ctas, threads, 0))
            for plan in plans:
                route = (plan or chosen).route
                kernel = getattr(cuda_fps, f"farthest_point_sample_{route}_kernel")
                row = {"fps_large": f"N={n} B={b}",
                       "plan": (plan or chosen)._asdict() | {"default": plan is None},
                       "chosen": plan is None or plan == chosen}

                def call(k=kernel, pl=plan):
                    return k(xyz, npoint, start, pl)

                timed(row, call, lambda got: bool(torch.equal(got, want)), npoint - 1)
            del xyz

        # one ring step at P=1 from step 1's state
        for b, nl in ((4, 8192), (1, 131072), (1, 524288), (4, 131072)):
            xyz = torch.from_numpy(clouds(1600 + b, b, nl)).to(dev)
            every = fps_ring_offers(torch.zeros(b, dtype=torch.int64, device=dev), xyz[:, 0])[None]
            distance = torch.full((b, nl), 1e10, device=dev)
            centroids = torch.empty((b, npoint), dtype=torch.int64, device=dev)
            every = fps_ring_step_plain(xyz, every, distance, centroids, 0, 0)[None]
            want_dist = distance.clone()
            want = fps_ring_step_plain(xyz, every, want_dist, centroids.clone(), 1, 0)
            plans = [None]
            if not default_only:
                plans += [cuda_fps.FpsRingPlan(c, t) for c, t in itertools.product(
                    (4, 8, 16), (128, 256, 512, 1024))]
            for plan in plans:
                state = [distance.clone(), centroids.clone()]

                def step(st=state, pl=plan):
                    return cuda_fps.fps_ring_step_kernel(xyz, every, st[0], st[1], 1, 0, pl)

                timed({"ring_step": f"B={b} Nl={nl}", "plan": plan or "default",
                       "chosen": plan is None or plan == cuda_fps.fps_ring_plan(b, nl)},
                      step, lambda got, st=state: bool(torch.equal(got, want)
                                                       and torch.equal(st[0], want_dist)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--default-only", action="store_true",
                        help="time only the wrappers' own plans")
    parser.add_argument("--split", action="store_true",
                        help="time only the ordered sums' phases and the grouped "
                        "ball queries' selection beside the whole kernels, and stop")
    parser.add_argument("--ball-query", action="store_true",
                        help="time only the grouped ball queries")
    parser.add_argument("--fps-large", action="store_true",
                        help="time only the FPS above 16,384 points and the ring FPS step")
    parser.add_argument("--scatter", action="store_true",
                        help="time only the 3-NN backward and the SA2 gather "
                        "backward (items 8 and 6)")
    parser.add_argument("--stream-split", action="store_true",
                        help="time only the streamed SA1 query whole, without its "
                        "gather and over one block, with its hits' positions")
    parser.add_argument("--stream", action="store_true",
                        help="time only SA1 and its indices alone above the grid's "
                        "sizes: the wrappers' plans and every streamed plan; and "
                        "the idx-only query's routes from 1,025 points")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_sweep: no CUDA device (torch.cuda.is_available() is False)")
    from point2cyl_torch.ops import cuda_fps, cuda_knn

    card = card_line()
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0)}), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    if args.fps_large:
        sweep_fps_large(dev, np.random.default_rng(17), args.default_only)
        return
    if args.stream_split:
        split_stream(dev, np.random.default_rng(1700))
        return
    if args.stream:
        sweep_stream(dev, np.random.default_rng(1700), args.default_only)
        return
    if args.split:
        split_scatter(dev, np.random.default_rng(5))
        if not args.scatter:
            split_ball_query(dev, np.random.default_rng(5))
        return
    sweep_scatter(dev, np.random.default_rng(5), args.default_only)
    if args.scatter:
        return
    sweep_ball_query(dev, np.random.default_rng(5), args.default_only)
    if args.ball_query:
        return

    def starts(b, n):
        return torch.from_numpy(rng.integers(0, n, size=b).astype(np.int64)).to(dev)

    shapes = []
    for b in (16, 4):
        sa1 = torch.from_numpy(clouds(10 + b, b, 8192)).to(dev)
        start = 0 if b == 16 else starts(b, 8192)
        shapes.append((f"sa1 B={b}", sa1, 512, start))
        with torch.inference_mode():
            sa2 = sa1[torch.arange(b, device=dev)[:, None],
                      cuda_fps.farthest_point_sample_plain(sa1, 512, start).long()]
        shapes.append((f"sa2 B={b}", sa2.contiguous(), 128, 0 if b == 16 else starts(b, 512)))
    shapes.append(("sa1 N=512 B=8", torch.from_numpy(clouds(7, 8, 512)).to(dev), 512,
                   starts(8, 512)))

    with torch.inference_mode():
        for label, xyz, npoint, start in shapes:
            want = cuda_fps.farthest_point_sample_plain(xyz, npoint, start)
            if args.default_only:
                got = cuda_fps.farthest_point_sample_kernel(xyz, npoint, start)
                if not torch.equal(got, want):
                    sys.exit(f"kernel_sweep: FPS {label} differs from plain")
                print(json.dumps({"fps": label, "plan": "default", "equal": True,
                                  "ms": time_ms(lambda: cuda_fps.farthest_point_sample_kernel(
                                      xyz, npoint, start))}), flush=True)
                continue
            chosen = cuda_fps.fps_launch_plan(xyz.shape[0], xyz.shape[1])
            for cluster in CLUSTERS:
                for threads in THREADS:
                    plan = (cluster, threads)
                    row = {"fps": label, "cluster": cluster, "threads": threads,
                           "chosen": plan == chosen}
                    try:
                        got = cuda_fps.farthest_point_sample_kernel(xyz, npoint, start, plan)
                        torch.cuda.synchronize()
                    except RuntimeError as err:
                        row["refused"] = str(err).splitlines()[0]
                        print(json.dumps(row), flush=True)
                        continue
                    row["equal"] = bool(torch.equal(got, want))
                    row["ms"] = time_ms(lambda: cuda_fps.farthest_point_sample_kernel(
                        xyz, npoint, start, plan))
                    print(json.dumps(row), flush=True)
                    if not row["equal"]:
                        sys.exit(f"kernel_sweep: FPS {label} plan {plan} differs from plain")

        for b in (16, 4):
            pts = torch.from_numpy(clouds(20 + b, b, 8192)).to(dev)
            l1 = pts[:, :512].contiguous()
            l2 = pts[:, :128].contiguous()
            for label, dst, src, c in (("fp2", l1, l2, 256), ("fp1", pts, l1, 128)):
                feats = torch.from_numpy(rng.normal(size=(b, src.shape[1], c))
                                         .astype(np.float32)).to(dev)
                want = cuda_knn.three_nn_interpolate_plain(dst, src, feats)
                if args.default_only:
                    got = cuda_knn.three_nn_interpolate_kernel(dst, src, feats)
                    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
                    print(json.dumps({"three_nn": f"{label} B={b}", "lanes": "default",
                                      "ms": time_ms(lambda: cuda_knn.three_nn_interpolate_kernel(
                                          dst, src, feats))}), flush=True)
                    continue
                chosen = cuda_knn.three_nn_lanes(b, dst.shape[1])
                for lanes in LANES:
                    got = cuda_knn.three_nn_interpolate_kernel(dst, src, feats,
                                                               lanes=lanes)
                    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
                    print(json.dumps({"three_nn": f"{label} B={b}", "lanes": lanes,
                                      "chosen": lanes == chosen, "ms": time_ms(
                        lambda: cuda_knn.three_nn_interpolate_kernel(
                            dst, src, feats, lanes=lanes)),
                        "max_abs_err": float((got - want).abs().max())}), flush=True)


if __name__ == "__main__":
    main()
