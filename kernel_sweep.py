"""Time the FPS kernel's launch plans and the 3-NN forward on one NVIDIA GPU.

    python3 kernel_sweep.py

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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--default-only", action="store_true",
                        help="time only the wrappers' own plans")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_sweep: no CUDA device (torch.cuda.is_available() is False)")
    from point2cyl_torch.ops import cuda_fps, cuda_knn

    card = card_line()
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0)}), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)

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
