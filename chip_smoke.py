"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py            # what a check of the port runs
    python3 chip_smoke.py --profile  # also print a device-time breakdown

Phases, in order; any failure raises, exits non-zero and prints no result:

1. Set-up: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, and the build of the kernels from ``point2cyl_torch/csrc``.
2. Kernels: at the full-width serving shapes (B=16, N=8192) each kernel
   (FPS at SA1 and SA2, the SA1 and SA2 grouped ball queries, 3-NN at FP2
   and FP1) is held against its plain PyTorch version on the same card
   inputs, and both are timed with CUDA events (median of 25 runs).
3. Slice: a full-width backbone (N=8192, K=8, heads [3, 16]) with weights
   drawn from a seeded torch.Generator is written as an artifact with
   buckets (1, 4, 16) and served through ``InferenceSession`` on the card
   for requests of 1, 5 and 16 clouds. The kernels' launch counts over
   those requests are checked; the raw heads are held against the same
   request with every ``*_impl="plain"`` on the card and against the
   port on the CPU.
4. Rate: decompositions per second at bucket 16.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B = 16  # bucket measured in the kernel and rate phases
K = 8
SK = 2048  # sketch samples per instance, the JAX export's default
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TIMED_RUNS = 25


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of one call, by CUDA events. A ~0.5 ms spin on
    the stream ahead of each start event keeps the host's enqueue work off
    the clock."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) for the work: bytes at peak HBM rate or float32
    operations at peak rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scanned_points(idx: torch.Tensor, n: int) -> int:
    """Distance tests a first-nsample ball query needs on this data: up to
    its nsample-th in-radius point, or all N where fewer exist (a short row
    repeats its first index in the last slot)."""
    full = idx[..., -1] != idx[..., 0]
    return int(torch.where(full, idx[..., -1].long() + 1, n).sum())


def clouds(seed: int, n: int, num_points: int) -> np.ndarray:
    pts = np.random.default_rng(seed).normal(size=(n, num_points, 3))
    return (pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(np.float32)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="print a torch.profiler device-time breakdown of "
                        "one bucket-16 request")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

    from point2cyl_torch.core.config import BackboneConfig
    from point2cyl_torch.models.backbone import build_backbone
    from point2cyl_torch.ops import _build, cuda_ballquery, cuda_fps, cuda_knn
    from point2cyl_torch.serve.export import _backbone_forward, export_artifact
    from point2cyl_torch.serve.session import InferenceSession

    # ---- 1. set-up -------------------------------------------------------
    card = card_line()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"setup: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
          f"kernel build {build_s:.2f} s", flush=True)
    dev = torch.device("cuda")

    cfg = BackboneConfig(num_points=8192, output_sizes=(3, 2 * K),
                         approx_neighbors=False)
    plain_cfg = dataclasses.replace(cfg, fps_impl="plain", ballquery_impl="plain",
                                    knn_impl="plain")
    gen = torch.Generator().manual_seed(0)
    state_dict = build_backbone(cfg, generator=gen, device="cpu").state_dict()
    plain_model = build_backbone(plain_cfg, state_dict=state_dict, device=dev)

    # ---- 2. kernels at the main path's shapes ------------------------------
    pts = torch.from_numpy(clouds(1, B, cfg.num_points)).to(dev)
    with torch.inference_mode():
        m = plain_model
        l1_xyz, l1_f = m.sa1(pts, None)
        l2_xyz, l2_f = m.sa2(l1_xyz, l1_f)
        g_xyz, g_f = m.sa3(l2_xyz, l2_f)
        f3 = m.fp3(l2_xyz, g_xyz, l2_f, g_f)
        f2 = m.fp2(l1_xyz, l2_xyz, l1_f, f3)
    r1, r2 = cfg.sa_radii
    ns1, ns2 = cfg.sa_nsamples

    def fps_work(xyz, npoint):
        b, n, _ = xyz.shape
        # per point and iteration: 3 sub, 3 mul, 2 add, 1 min, 1 compare
        return xyz.numel() * 4 + b * npoint * 4, 10.0 * b * npoint * n

    def group_work(xyz, new_xyz, idx, width, feats=None):
        b, s, ns = idx.shape
        nbytes = (xyz.numel() + new_xyz.numel()) * 4 + idx.numel() * 4 \
            + b * s * ns * width * 4 + (feats.numel() * 4 if feats is not None else 0)
        # per distance test: 3 sub, 3 mul, 2 add, 1 compare; 3 subs a slot
        return nbytes, 9.0 * scanned_points(idx, xyz.shape[1]) + 3.0 * idx.numel()

    def knn_work(dst, src, feats):
        b, n, _ = dst.shape
        s, c = feats.shape[1], feats.shape[2]
        nbytes = (dst.numel() + src.numel() + feats.numel() + b * n * c) * 4
        # per pair: 8 for the distance, 1 compare; per output: 3 mul, 2 add
        return nbytes, 9.0 * b * n * s + 5.0 * b * n * c

    cases = [
        ("fps@sa1", "point2cyl_torch/csrc/fps.cu",
         "point2cyl_tpu/ops/pallas_fps.py:22 _fps_kernel",
         cuda_fps.farthest_point_sample_kernel, cuda_fps.farthest_point_sample_plain,
         (pts, cfg.sa_npoints[0]), fps_work(pts, cfg.sa_npoints[0])),
        ("fps@sa2", "point2cyl_torch/csrc/fps.cu",
         "point2cyl_tpu/ops/pallas_fps.py:22 _fps_kernel",
         cuda_fps.farthest_point_sample_kernel, cuda_fps.farthest_point_sample_plain,
         (l1_xyz, cfg.sa_npoints[1]), fps_work(l1_xyz, cfg.sa_npoints[1])),
        ("ball_query_grouped@sa1", "point2cyl_torch/csrc/ballquery.cu",
         "point2cyl_tpu/ops/pallas_ballquery.py:276 _ballquery_grouped_kernel",
         cuda_ballquery.ball_query_grouped_kernel,
         cuda_ballquery.ball_query_grouped_plain, (r1, ns1, pts, l1_xyz), None),
        ("sa_grouped_exact@sa2", "point2cyl_torch/csrc/ballquery.cu",
         "point2cyl_tpu/ops/pallas_ballquery.py:394 _sa_grouped_exact_kernel",
         cuda_ballquery.sa_grouped_exact_kernel,
         cuda_ballquery.sa_grouped_exact_plain, (r2, ns2, l1_xyz, l1_f, l2_xyz), None),
        ("three_nn@fp2", "point2cyl_torch/csrc/knn3.cu",
         "point2cyl_tpu/ops/pallas_knn.py:97 _knn3_kernel",
         cuda_knn.three_nn_interpolate_kernel, cuda_knn.three_nn_interpolate_plain,
         (l1_xyz, l2_xyz, f3), knn_work(l1_xyz, l2_xyz, f3)),
        ("three_nn@fp1", "point2cyl_torch/csrc/knn3.cu",
         "point2cyl_tpu/ops/pallas_knn.py:97 _knn3_kernel",
         cuda_knn.three_nn_interpolate_kernel, cuda_knn.three_nn_interpolate_plain,
         (pts, l1_xyz, f2), knn_work(pts, l1_xyz, f2)),
    ]
    rows = []
    with torch.inference_mode():
        for name, source, replaces, kernel, plain, inputs, work in cases:
            got = kernel(*inputs)
            torch.cuda.synchronize()
            want = plain(*inputs)
            torch.cuda.synchronize()
            if name.startswith("fps"):
                check(torch.equal(got, want), f"{name}: indices differ from plain")
                err = 0.0
            elif name.startswith("three_nn"):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                           msg=lambda m: f"{name}: {m}")
                err = float((got - want).abs().max())
            else:
                check(torch.equal(got[0], want[0]), f"{name}: indices differ from plain")
                check(torch.equal(got[1], want[1]), f"{name}: grouped values differ")
                err = float((got[1] - want[1]).abs().max())
                feats = inputs[3] if len(inputs) == 5 else None
                width = got[1].shape[-1]
                work = group_work(inputs[2], inputs[-1], got[0], width, feats)
            k_ms = time_ms(lambda: kernel(*inputs))
            p_ms = time_ms(lambda: plain(*inputs))
            b_ms, b_by = bound(*work)
            row = {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces, "max_abs_err": err, "ms": k_ms,
                   "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None}
            rows.append(row)
            print(json.dumps({"kernel": name, "kernel_ms": k_ms, "plain_ms": p_ms,
                              "bound_ms": b_ms, "bound_by": b_by,
                              "library_ms": None, "max_abs_err": err,
                              "card": card}), flush=True)
    del l1_xyz, l1_f, l2_xyz, l2_f, g_xyz, g_f, f3, f2

    # ---- 3. the slice through the session ----------------------------------
    counters = {
        "fps": cuda_fps.farthest_point_sample_kernel,
        "ball_query_grouped": cuda_ballquery.ball_query_grouped_kernel,
        "sa_grouped_exact": cuda_ballquery.sa_grouped_exact_kernel,
        "three_nn": cuda_knn.three_nn_interpolate_kernel,
    }
    per_forward = {"fps": 2, "ball_query_grouped": 1, "sa_grouped_exact": 1,
                   "three_nn": 2}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fullwidth.p2ct")
        export_artifact(path, state_dict, k=K, backbone_config=cfg,
                        buckets=(1, 4, 16), num_sk_points=SK)
        sess = InferenceSession(path)
        check(sess.device.type == "cuda", "the session did not default to the card")
        requests = {n: clouds(100 + n, n, cfg.num_points) for n in (1, 5, 16)}
        # one forward each: 1 -> bucket 1, 5 -> bucket 16 (11 zero rows),
        # 16 -> bucket 16
        chunks = {1: 1, 5: 1, 16: 1}
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        results = {n: sess.decompose(p) for n, p in requests.items()}
        torch.cuda.synchronize()
        slice_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        forwards = sum(chunks.values())
        for name, count in launches.items():
            check(count == per_forward[name] * forwards,
                  f"{name} launched {count} times over {forwards} forwards, "
                  f"expected {per_forward[name] * forwards}")
        for n, out in results.items():
            check(out["axes"].shape == (n, K, 3) and out["labels"].shape
                  == (n, cfg.num_points), f"decompose({n}) shapes")
            for key in ("axes", "centers", "extents", "scales"):
                check(bool(np.isfinite(out[key]).all()), f"decompose({n}) {key} finite")
            norms = np.linalg.norm(out["axes"], axis=-1)
            check(bool(np.abs(norms - 1.0).max() < 1e-4), f"decompose({n}) unit axes")
            check(bool(out["found"].any()), f"decompose({n}) found no instance")
        print(json.dumps({"slice": "decompose", "requests": [1, 5, 16],
                          "forwards": forwards, "launches": launches,
                          "found_per_cloud": float(np.mean(
                              [o["found"].sum(-1).mean() for o in results.values()])),
                          "host_s": slice_s}), flush=True)

        # the same request with every *_impl="plain", on the card
        pts16 = torch.from_numpy(requests[16]).to(dev)
        with torch.inference_mode():
            got = _backbone_forward(sess.model, pts16, k=K, num_sk_points=SK)
            want = _backbone_forward(plain_model, pts16, k=K, num_sk_points=SK)
        for key in ("x_raw", "w_raw"):
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-4,
                                       msg=lambda m: f"plain vs kernel {key}: {m}")
        agree = float((got["labels"] == want["labels"]).float().mean())
        check(agree >= 0.999, f"labels agree on {agree:.5f} of points vs plain")
        raw_err = max(float((got[k] - want[k]).abs().max()) for k in ("x_raw", "w_raw"))

        # and against the port on the CPU, one cloud
        cpu_model = build_backbone(cfg, state_dict=state_dict, device="cpu")
        with torch.inference_mode():
            cpu = _backbone_forward(cpu_model, torch.from_numpy(requests[1]), k=K,
                                    num_sk_points=SK)
            card1 = _backbone_forward(sess.model, torch.from_numpy(requests[1]).to(dev),
                                      k=K, num_sk_points=SK)
        for key in ("x_raw", "w_raw"):
            torch.testing.assert_close(card1[key].cpu(), cpu[key], rtol=0, atol=1e-4,
                                       msg=lambda m: f"card vs CPU {key}: {m}")
        agree_cpu = float((card1["labels"].cpu() == cpu["labels"]).float().mean())
        check(agree_cpu >= 0.999, f"labels agree on {agree_cpu:.5f} of points vs CPU")
        print(json.dumps({"check": "reference", "plain_max_abs_err": raw_err,
                          "plain_label_agreement": agree,
                          "cpu_max_abs_err": max(
                              float((card1[k].cpu() - cpu[k]).abs().max())
                              for k in ("x_raw", "w_raw")),
                          "cpu_label_agreement": agree_cpu}), flush=True)

        # ---- 4. rate ---------------------------------------------------------
        rate = sess.benchmark(batch=B, iters=20)
        print(json.dumps({"rate": "decompose", **rate, "card": card}), flush=True)

        if args.profile:
            # device span of the backbone alone and with the decomposition,
            # then a trace of whole requests: device time by kernel name
            # (the card's own events, so nothing is counted twice)
            x = torch.from_numpy(requests[16]).to(dev)
            with torch.inference_mode():
                fwd_ms = time_ms(lambda: sess.model(x))
                full_ms = time_ms(lambda: _backbone_forward(sess.model, x, k=K,
                                                            num_sk_points=SK))
            print(json.dumps({"breakdown": "bucket 16", "backbone_ms": fwd_ms,
                              "decomposition_ms": full_ms - fwd_ms,
                              "request_ms": rate["ms_per_request"], "card": card}),
                  flush=True)
            # the busy share holds the traced device time against the
            # untraced request time: tracing slows the host, not the card
            requests_traced = 3
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(requests_traced):
                    sess.decompose(requests[16])
                torch.cuda.synchronize()
            on_card = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            device_ms = sum(e.self_device_time_total for e in on_card) / 1e3
            print(json.dumps({"profile": f"{requests_traced} x decompose(16)",
                              "device_ms_per_request": device_ms / requests_traced,
                              "device_busy_share": device_ms / requests_traced
                              / rate["ms_per_request"], "card": card}), flush=True)
            top = sorted(on_card, key=lambda e: e.self_device_time_total,
                         reverse=True)[:20]
            for e in top:
                print(json.dumps({
                    "device_op": e.key[:100],
                    "ms_per_request": e.self_device_time_total / 1e3 / requests_traced,
                    "calls_per_request": e.count / requests_traced}), flush=True)

    for row in rows:
        row["launches"] = launches[row["name"].split("@")[0]]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
