"""Time the ball queries', FPS's and the 3-NN forward's launch plans on one NVIDIA GPU.

    python3 kernel_sweep.py

Grouped ball queries, at SA1 (N=8192 -> 512, r=0.2, nsample 64) and SA2
(512 -> 128, r=0.4, nsample 64, C=128) at B=16, 4 and 1 (the serving
buckets and the training batch), every output held equal to the plain
version's: SA1 over ``ball_query_plan``'s choices (CTAs a row at 1 and 2
an SM, or at B=1 8 to 132, warps a CTA in {4, 8, 16, 32}, list cap in
{256, 1024, 4096}) and the grid's build alone (one query a row, N in {64,
1024, 8192}); SA2 over its stores (the bulk copy, 4-byte stores), warps a
CTA in {8, 16, 32} and CTAs a row at 1-4 an SM (at B=1 8 to 128). The
plan the wrapper picks is marked with a star. ``--ball-query`` stops after them; ``--split`` times instead
each kernel beside its selection alone and a fill of its outputs.

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
                radius_squared(radius), int(plan.select == "grid"), plan.ctas,
                plan.warps, plan.cap, torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check("p2c_ball_query_grouped (selection alone)", status)
    return idx


def split_ball_query(dev: torch.device, rng: np.random.Generator) -> None:
    """Selection alone beside the whole SA1 and SA2 kernels, and a fill of
    their outputs (the write at the card's store rate), at B=16 and B=4.
    Selection alone: the idx-only kernel (the index-order scan, SA2's
    selection) and, at SA1, the grid kernel without its gather (where the
    port has it). Every output is checked equal to the plain version's."""
    from point2cyl_torch.ops import cuda_ballquery

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
                scan_idx = cuda_ballquery.ball_query_kernel(radius, ns, xyz, new_xyz)
                if not (torch.equal(idx, want[0]) and torch.equal(grouped, want[1])
                        and torch.equal(scan_idx, want[0])):
                    sys.exit(f"kernel_sweep: {stage} B={b} differs from plain")
                row = {"split": f"{stage} B={b}",
                       "scan_select_ms": time_ms(lambda: cuda_ballquery.ball_query_kernel(
                           radius, ns, xyz, new_xyz))}
                if stage == "sa1" and hasattr(cuda_ballquery, "ball_query_plan"):
                    if not torch.equal(grid_select(*args), want[0]):
                        sys.exit(f"kernel_sweep: {stage} B={b} grid selection differs")
                    row["grid_select_ms"] = time_ms(lambda: grid_select(*args))
                row.update(whole_ms=time_ms(lambda: kernel(*args)),
                           fill_outputs_ms=time_ms(lambda: (idx.fill_(0), grouped.fill_(0.0))),
                           grouped_mb=grouped.numel() * 4 / 1e6)
                print(json.dumps(row), flush=True)


def sweep_ball_query(dev: torch.device, rng: np.random.Generator, default_only: bool) -> None:
    """The SA1 and SA2 grouped ball queries at B=16, 4 and 1: the wrappers'
    own plans, or (full sweep) every plan below, each checked equal to the
    plain version. SA1 also with one query a row, which leaves each CTA's
    grid build and little else."""
    from point2cyl_torch.ops import cuda_ballquery

    def run(label, kernel, want, args, plan=None):
        extra = {} if plan is None else {"plan": plan}
        got = kernel(*args, **extra)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        row = {"ball_query": label, "plan": "default" if plan is None else plan._asdict(),
               "equal": equal, "ms": time_ms(lambda: kernel(*args, **extra))}
        print(json.dumps(row), flush=True)
        if not equal:
            sys.exit(f"kernel_sweep: {label} differs from plain")

    sa1_kernel = cuda_ballquery.ball_query_grouped_kernel
    sa2_kernel = cuda_ballquery.sa_grouped_exact_kernel
    with torch.inference_mode():
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--default-only", action="store_true",
                        help="time only the wrappers' own plans")
    parser.add_argument("--split", action="store_true",
                        help="time only the grouped ball queries' selection "
                        "beside the whole kernels, and stop")
    parser.add_argument("--ball-query", action="store_true",
                        help="time only the grouped ball queries")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_sweep: no CUDA device (torch.cuda.is_available() is False)")
    from point2cyl_torch.ops import cuda_fps, cuda_knn

    card = card_line()
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0)}), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    if args.split:
        split_ball_query(dev, np.random.default_rng(5))
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
