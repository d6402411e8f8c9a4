"""Drive the PyTorch/CUDA port's serving, training and evaluation on one NVIDIA GPU.

    python3 chip_smoke.py            # what a check of the port runs
    python3 chip_smoke.py --profile  # also print device-time breakdowns

Phases, in order; any failure raises, exits non-zero and prints no result:

1. Set-up: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, and the build of the kernels from ``point2cyl_torch/csrc``.
2. Kernels: each kernel is held against its plain PyTorch version on the
   same card inputs, and both are timed with CUDA events (median of 25
   runs), beside the bound and, where one PyTorch call computes the same
   function, that call's time (the SA1 grouped ball query's op term
   counts one distance test a point of each ball; the index-order scan's
   count, the bound of earlier versions, is printed beside it as
   ``scan_bound_ms``). The forward kernels at the full-width
   serving shapes (B=16, N=8192): FPS at SA1 and SA2, the SA1 and SA2
   grouped ball queries, 3-NN at FP2 and FP1. The training kernels at the
   training shapes: the idx-only ball query at SA1 of the N=512 protocol
   (B=8), the SA1 and SA2 gather backwards and the 3-NN backward at FP2
   and FP1 (B=4, N=8192), with cotangents from a numpy seed (FP2's the
   slice of a concatenation's gradient that the step passes). The
   gathers' backwards and the 3-NN backward, the ordered per-target
   sums, are also held bit-equal to the host's ordered sum (np.add.at)
   and to a second run, and the 3-NN backward's library time is
   index_add_ of the w * g rows (the product inside the timed call).
   Then the autograd Functions' card branches: SA1's gather
   differentiated with respect to the cloud through ``BallQueryGrouped``
   against autograd of the plain version, and its d_xyz bit-equal to the
   host's ordered sum and to a second backward, and the sources and
   weights the 3-NN forward saves for its backward against the plain
   version's. The FPS, grouped ball
   query and 3-NN rows are also measured at the training shapes (B=4,
   random FPS starts). Then the corner cases of the cluster FPS (N=512
   at B=8, N=5000, N=16384, a cloud of 64 distinct points each repeated,
   so that ties fall across CTAs), of the 3-NN forward (C=67, S=3,
   duplicated sources, feats that are not 16-byte aligned; with 1, 2 and
   4 threads searching for a point, with and without the saved sources
   and weights) and of the grouped ball queries (the main shapes at B=1,
   4 and 16, N=5000, 4999 and 16384, a dense cluster, repeated points, a
   lattice at spacing r with points on cell edges, an outlier at 1e4,
   NaN and inf coordinates and centres, nsample 63, and at SA2 C=67 and
   misaligned feats; SA1 with its plan, every query on the grid and
   every query scanning, SA2 with each store; indices and values
   bit-equal), each against the plain version; of the idx-only ball query
   (N=33, 1000, 1024 and 1025, the last the index-order scan, N=510 with
   4-byte loads, nsample 63, S not a multiple of a CTA's warps, NaN and
   inf coordinates, a cloud all within the radius), indices equal to the
   plain version; and of the ordered sums (3-NN at S=3, with duplicated
   sources, C=67, a misaligned g, the N=512 protocol's FP1 and FP2,
   N=16384 in two windows, N=12000 in one window of 36,000 entries, and
   B=1; SA2 at the N=512 protocol, C=67, width 128 aligned and not, a
   one-point ball padded 64 times, a dense cluster, N=16384 and B=1; SA1
   with eight one-point balls padded 64 times, a dense cluster, B=1 and
   N=16384, each in the counts listing), each bit-equal to the host's
   ordered sum and to a second run; an FPS call with a start tensor on
   the card under ``torch.cuda.set_sync_debug_mode("error")``; an out-of-range start,
   which must raise (an int on the host, a card tensor by the kernel's
   device-side assert, in a child process); and FPS's time a step, the
   slope of its SA1 time over npoint in {64, 128, 256, 512}.
3. Serving: a full-width backbone (N=8192, K=8, heads [3, 16]) with
   weights drawn from a seeded torch.Generator is written as an artifact
   with buckets (1, 4, 16) and served through ``InferenceSession`` on the
   card for requests of 1, 5 and 16 clouds. The kernels' launch counts
   over those requests are checked; the raw heads are held against the
   same request with every ``*_impl="plain"`` on the card and against the
   port on the CPU.
4. Rate: decompositions per second at bucket 16.
5. Training at full width: Trainer A built by the CLI's own
   ``build_trainer`` on ``--synthetic 16`` (seed 0), N=8192, K=8, B=4.
   Launches per step are checked, every parameter gets a non-zero
   gradient, the losses are finite, and one step is held against the
   same step (weights, batch, FPS starts, dropout mask) with every
   ``*_impl="plain"`` on the card: loss, every gradient, BN statistics.
   Then the median ms per step, and the loss's gradient with respect to
   the input clouds (a saliency map), the one caller of SA1's gather
   backward, with its launches checked. Then two epochs of ``--synthetic 8``
   through the CLI's ``train()`` into a temporary logdir, and a resume
   that must continue its step and epoch.
6. Training at N=512, B=8 (the A/B protocol): a few steps; SA1 goes
   through the idx-only ball query once per step.
7. Evaluation: ``python -m point2cyl_torch.eval.evaluator``'s
   ``cli_main`` restores phase 5's CLI checkpoint and evaluates
   ``--synthetic 8`` at full width (N=8192, K=8, B=4, ``--no_implicit``):
   the ``Restored backbone`` line, a finite metric block, and per eval
   batch 2 FPS, 1 SA1 grouped query, 1 SA2 grouped query and 2 3-NN
   launches and no other. The same batches through ``evaluate`` with
   every ``*_impl="plain"`` must give the same metric means within the
   CPU parity test's tolerances; then the clouds per second of
   ``evaluate`` and the ms of one eval step. Then the N=512 protocol:
   phase 6's weights evaluated on ``ab_data/test.h5`` at B=8, SA1 through
   the idx-only ball query once a batch.
8. The implicit stack at full width: ``ImplicitNet(d_in=258)`` with
   geometric init and the sketch encoders (4-channel, and the 7-channel
   whole-cloud one) with seeded weights and BN statistics, written as an
   IGR-layout and a joint-layout checkpoint. Serving: the export CLI
   (``python -m point2cyl_torch.serve.export``) on phase 5's checkpoint
   with and without ``--im_logdir`` (buckets 1, 4, 16), requests of 1, 5
   and 16 clouds through both sessions: latents (n, 8, 256), unit norm
   and float16 against ``exact_latents`` within 1e-3, labels and geometry
   equal to the artifact without the encoder, the launches per request
   unchanged, the kernel path against every ``*_impl="plain"`` (heads
   1e-4, labels on 0.999 of points, latents 1e-3 where a cloud's labels
   agree), and decompositions per second at bucket 16 with latents
   beside the rate without them. Evaluation: ``cli_main`` with the
   implicit stack in the default mode and with ``--use_whole_pc
   --use_extrusion_axis_feat`` (the restore line, a finite block with
   non-zero fitting lines, 2 FPS, 1 SA1, 1 SA2 and 2 3-NN launches a
   batch), the same batches against every ``*_impl="plain"`` within the
   CPU tests' tolerances, clouds per second of ``evaluate``, the ms of an
   eval step in both modes, its peak memory, and the decoder alone on
   the fitting metrics' 327,680 points against its float32 bound.
9. The joint trainer at full width: ``python -m
   point2cyl_torch.train.train_joint``'s ``cli_main`` with
   ``--pretrain_im`` on ``--synthetic 8`` (K=8, B=4, 2,048 sketch points,
   2 epochs; no backbone kernel launched, finite losses, the IGR layout),
   then the joint CLI from phase 5's backbone and that stack
   (``--is_pc_init --is_im_init --is_pc_train --is_im_train
   --with_im_loss --init_global_step -1``, 2 epochs: both load lines, the
   carried step, finite losses, the launches of 4 steps, the three
   written files) and its ``--resume`` to epoch 3. One joint step from the
   resumed weights against the same step with every ``*_impl="plain"``:
   the loss and its parts within 1e-5, every backbone and encoder
   gradient within phase 5's rule and non-zero, none on the decoder, the
   BN statistics; the launches of a step with and without
   ``--is_pc_train``. The ms per joint step and per pretrain step (and
   the pretrain step at B=16 in chunks of 32 instances and whole), their
   peak memory, and the IGR block alone (forward and double backward)
   against its float32 bound. Then the evaluator's ``cli_main`` and the export
   CLI read the joint logdir (restore lines, a finite block with
   non-zero fitting lines, served latents).

The line before the last is the kernel table as JSON (each row also
with its launches in the evaluations, ``eval_launches``, in the requests
with latents, ``serve_latents_launches``, and in the joint trainer,
``joint_launches``); the last line is ``{"ok": true, "device": {...}}``.

``--profile`` adds device-time breakdowns of a bucket-16 request, of
full-width train steps, of full-width eval steps without and with the
implicit stack and of joint steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B = 16  # bucket measured in the kernel and rate phases
TB = 4  # training batch at full width
K = 8
SK = 2048  # sketch samples per instance, the JAX export's default
# metric means of the kernel path against the all-plain path, as
# tests/test_torch_eval.py holds the port against JAX
EVAL_ATOL = {"miou": 1e-5, "bb_accuracy": 1e-5, "normal_error_deg": 2e-3,
             "axis_error_deg": 2e-3, "centroid_difference": 1e-5}
# the fitting metrics' means, as tests/test_torch_eval.py holds them
EVAL_FIT_ATOL = {"fit_cyl_loss": 1e-4, "fit_global_loss": 1e-4}
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


def ball_population(xyz: torch.Tensor, new_xyz: torch.Tensor, r2: float) -> int:
    """Points within the radius of each centre, summed over the centres:
    the distance tests any exact ball query must make on this data (one a
    point of each ball), counted on the card a batch row at a time."""
    total = 0
    for b in range(xyz.shape[0]):
        d = new_xyz[b][:, None, :] - xyz[b][None, :, :]
        total += int(((d * d).sum(-1) <= r2).sum())
    return total


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN equal to a NaN."""
    return a.shape == b.shape and bool(
        ((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


def host_sum(idx: torch.Tensor, rows: np.ndarray, targets: int) -> np.ndarray:
    """Each target's rows summed on the host in float32, from 0, in
    ascending entry order (np.add.at): idx (B, E) targets, rows (B, E, C)."""
    idx = idx.reshape(idx.shape[0], -1).cpu().numpy()
    out = np.zeros((idx.shape[0], targets, rows.shape[-1]), np.float32)
    for b in range(idx.shape[0]):
        np.add.at(out[b], idx[b], rows[b])
    return out


def three_nn_rows(w: torch.Tensor, g: torch.Tensor) -> np.ndarray:
    """The 3-NN backward's terms w * g in float32, (B, 3 N, C), entry
    3 i + k for point i's k-th source."""
    b, n, c = g.shape
    prod = w.cpu().numpy()[..., None] * g.cpu().numpy()[:, :, None, :]
    return prod.reshape(b, 3 * n, c)


def host_ordered_sum(inputs) -> np.ndarray:
    """The host's ordered sum for an ordered per-target sum's inputs: the
    3-NN backward's (idx, w, g, S) or the SA2 gather backward's (idx, dg,
    N)."""
    if len(inputs) == 4:
        idx, w, g, s = inputs
        return host_sum(idx, three_nn_rows(w, g), s)
    idx, dg, n = inputs
    return host_sum(idx, dg.reshape(dg.shape[0], -1, dg.shape[-1]).cpu().numpy(), n)


def ordered_sum_case(kernel, inputs) -> tuple[torch.Tensor, np.ndarray]:
    """One run of an ordered per-target sum and the host's ordered sum of
    the same terms."""
    return kernel(*inputs), host_ordered_sum(inputs)


def knn_index_add_call(idx, w, g, s):
    """One PyTorch call for the 3-NN backward's sum: index_add_ of the w * g
    rows (the product inside the timed call) into a zeroed (B*S, C) table
    at batch-offset source indices (made once, untimed)."""
    b, _, c = g.shape
    rows = (idx.long() + s * torch.arange(b, device=g.device)[:, None, None]).reshape(-1)
    return lambda: torch.zeros((b * s, c), device=g.device).index_add_(
        0, rows, (w[..., None] * g[:, :, None, :]).reshape(-1, c))


def index_add_call(idx, dg, n):
    """One PyTorch call for a gather's backward: index_add_ into a zeroed
    (B*n, W) table at batch-offset row indices (made once, untimed)."""
    b, w = idx.shape[0], dg.shape[-1]
    rows = (idx.long() + n * torch.arange(b, device=dg.device)[:, None, None]).reshape(-1)
    flat = dg.reshape(-1, w)
    return lambda: torch.zeros((b * n, w), device=dg.device).index_add_(0, rows, flat)


def clouds(seed: int, n: int, num_points: int) -> np.ndarray:
    pts = np.random.default_rng(seed).normal(size=(n, num_points, 3))
    return (pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(np.float32)


def logged_losses(logdir: str) -> list[float]:
    """Every epoch mean a trainer wrote to ``<logdir>/log.txt``
    (``Loss/<name>: value``), in order."""
    with open(os.path.join(logdir, "log.txt")) as f:
        return [float(v) for v in re.findall(r"Loss/\w+: (\S+)", f.read())]


def profile_steps(label: str, step, card: str, step_ms: float) -> None:
    """Device time by kernel name over three traced calls of ``step``, the
    busy share against the untraced time of one, and the host's time by
    operator."""
    traced = 3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(traced):
            step()
        torch.cuda.synchronize()
    # kernels and copies only: a user annotation (Adam's step) spans
    # kernels that are counted on their own
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in on_card) / 1e3 / traced
    print(json.dumps({"profile": f"{traced} x {label}", "device_ms_per_step": device_ms,
                      "device_busy_share": device_ms / step_ms, "card": card}), flush=True)
    for e in sorted(on_card, key=lambda e: e.self_device_time_total, reverse=True)[:25]:
        print(json.dumps({"device_op": e.key[:100],
                          "ms_per_step": e.self_device_time_total / 1e3 / traced,
                          "calls_per_step": e.count / traced}), flush=True)
    # the host's side: where its time per step goes, by operator
    on_host = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(on_host, key=lambda e: e.self_cpu_time_total, reverse=True)[:20]:
        print(json.dumps({"host_op": e.key[:100],
                          "host_ms_per_step": e.self_cpu_time_total / 1e3 / traced,
                          "calls_per_step": e.count / traced}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="print torch.profiler device-time breakdowns of a "
                        "bucket-16 request and of full-width train and eval steps")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

    from point2cyl_torch.core.checkpoint import CheckpointManager, restore_implicit_stack
    from point2cyl_torch.core.config import BackboneConfig, EvalConfig, TrainConfig
    from point2cyl_torch.data.pipeline import InputPipeline
    from point2cyl_torch.data.synthetic import generate_dataset
    from point2cyl_torch.eval import evaluator
    from point2cyl_torch.models.backbone import Backbone, build_backbone
    from point2cyl_torch.models.implicit import EncoderBatchNorm, ImplicitNet, PointNetEncoder
    from point2cyl_torch.models.layers import Dense
    from point2cyl_torch.ops import _build, cuda_ballquery, cuda_fps, cuda_knn, cuda_scatter
    from point2cyl_torch.ops.grouping import (ball_query_plain, group_scatter_plain,
                                              index_points, radius_squared,
                                              three_nn_weights_plain)
    from point2cyl_torch.serve import export as export_cli
    from point2cyl_torch.serve.export import _backbone_forward, export_artifact
    from point2cyl_torch.serve.session import InferenceSession
    from point2cyl_torch.losses.igr import igr_losses
    from point2cyl_torch.train import steps, train_joint
    from point2cyl_torch.train.train_pc import (build_pipeline, build_trainer,
                                                config_from_args, epoch_generator, train)

    # ---- 1. set-up -------------------------------------------------------
    script_t0 = time.perf_counter()
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

    # the training shapes of the same kernels: B=4, per-row random starts
    # (the training plan of the FPS kernel differs from serving's)
    pts4, l1_4, l1f_4, l2_4, f3_4, f2_4 = (
        t[:TB].contiguous() for t in (pts, l1_xyz, l1_f, l2_xyz, f3, f2))
    srng = np.random.default_rng(4)
    start_sa1, start_sa2 = (torch.from_numpy(srng.integers(0, n, size=TB)).to(dev)
                            for n in (cfg.num_points, cfg.sa_npoints[0]))
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
        ("fps@sa1_train", "point2cyl_torch/csrc/fps.cu",
         "point2cyl_tpu/ops/pallas_fps.py:22 _fps_kernel",
         cuda_fps.farthest_point_sample_kernel, cuda_fps.farthest_point_sample_plain,
         (pts4, cfg.sa_npoints[0], start_sa1), fps_work(pts4, cfg.sa_npoints[0])),
        ("fps@sa2_train", "point2cyl_torch/csrc/fps.cu",
         "point2cyl_tpu/ops/pallas_fps.py:22 _fps_kernel",
         cuda_fps.farthest_point_sample_kernel, cuda_fps.farthest_point_sample_plain,
         (l1_4, cfg.sa_npoints[1], start_sa2), fps_work(l1_4, cfg.sa_npoints[1])),
        ("ball_query_grouped@sa1_train", "point2cyl_torch/csrc/ballquery.cu",
         "point2cyl_tpu/ops/pallas_ballquery.py:276 _ballquery_grouped_kernel",
         cuda_ballquery.ball_query_grouped_kernel,
         cuda_ballquery.ball_query_grouped_plain, (r1, ns1, pts4, l1_4), None),
        ("sa_grouped_exact@sa2_train", "point2cyl_torch/csrc/ballquery.cu",
         "point2cyl_tpu/ops/pallas_ballquery.py:394 _sa_grouped_exact_kernel",
         cuda_ballquery.sa_grouped_exact_kernel,
         cuda_ballquery.sa_grouped_exact_plain, (r2, ns2, l1_4, l1f_4, l2_4), None),
        ("three_nn@fp2_train", "point2cyl_torch/csrc/knn3.cu",
         "point2cyl_tpu/ops/pallas_knn.py:97 _knn3_kernel",
         cuda_knn.three_nn_interpolate_kernel, cuda_knn.three_nn_interpolate_plain,
         (l1_4, l2_4, f3_4), knn_work(l1_4, l2_4, f3_4)),
        ("three_nn@fp1_train", "point2cyl_torch/csrc/knn3.cu",
         "point2cyl_tpu/ops/pallas_knn.py:97 _knn3_kernel",
         cuda_knn.three_nn_interpolate_kernel, cuda_knn.three_nn_interpolate_plain,
         (pts4, l1_4, f2_4), knn_work(pts4, l1_4, f2_4)),
    ]
    rows = []
    with torch.inference_mode():
        for name, source, replaces, kernel, plain, inputs, work in cases:
            extra = {}
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
                if feats is None:
                    # SA1's grid tests the points of each ball (and their
                    # cells' neighbours), not the index-order scan that
                    # group_work counts: its op term is one test a point of
                    # each ball. The scan's figure, the bound of PRs 1-3,
                    # is printed beside it.
                    extra["scan_bound_ms"] = bound(*work)[0]
                    work = (work[0], 9.0 * ball_population(
                        inputs[2], inputs[-1], radius_squared(inputs[0]))
                        + 3.0 * got[0].numel())
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
                              "library_ms": None, "max_abs_err": err, **extra,
                              "card": card}), flush=True)

    # the training kernels, at the training shapes: B=4 at full width, and
    # SA1 of the N=512 protocol at B=8; cotangents from a numpy seed
    trng = np.random.default_rng(5)

    def cotangent(*shape):
        return torch.from_numpy(trng.normal(size=shape).astype(np.float32)).to(dev)

    p512 = torch.from_numpy(clouds(2, 8, 512)).to(dev)
    with torch.inference_mode():
        c512 = index_points(p512, cuda_fps.farthest_point_sample_plain(
            p512, cfg.sa_npoints[0]))
        idx_sa1 = cuda_ballquery.ball_query_grouped_plain(r1, ns1, pts4, l1_4)[0]
        idx_sa2 = cuda_ballquery.sa_grouped_exact_plain(r2, ns2, l1_4, l1f_4, l2_4)[0]
        nn_fp2 = [t.to(dt).contiguous() for t, dt in zip(
            three_nn_weights_plain(l1_4, l2_4), (torch.int32, torch.float32))]
        nn_fp1 = [t.to(dt).contiguous() for t, dt in zip(
            three_nn_weights_plain(pts4, l1_4), (torch.int32, torch.float32))]
    dg_sa1 = cotangent(TB, cfg.sa_npoints[0], ns1, 3)
    dg_sa2 = cotangent(TB, cfg.sa_npoints[1], ns2, 3 + l1f_4.shape[2])
    # FP2's cotangent as the step passes it: the interpolated slice of the
    # gradient of cat([feats_dst, interpolated]) (row stride 384)
    g_fp2 = cotangent(TB, l1_4.shape[1], l1f_4.shape[2] + f3_4.shape[2])[
        ..., l1f_4.shape[2]:]
    g_fp1 = cotangent(TB, cfg.num_points, f2_4.shape[2])

    def query_work(xyz, new_xyz, idx):
        nbytes = (xyz.numel() + new_xyz.numel() + idx.numel()) * 4
        return nbytes, 9.0 * scanned_points(idx, xyz.shape[1])

    def scatter_work(idx, dg, n):
        # idx and dg read once, the (B, n, W) table written once; one add
        # per cotangent element
        b, w = idx.shape[0], dg.shape[-1]
        return (idx.numel() + dg.numel() + b * n * w) * 4, float(dg.numel())

    def knn_bwd_work(idx, w, g, s):
        b, _, c = g.shape
        # per cotangent element: 3 multiplies and 3 adds
        return (idx.numel() + w.numel() + g.numel() + b * s * c) * 4, 6.0 * g.numel()

    n1 = cfg.num_points
    train_cases = [
        ("ball_query@sa1_n512", "point2cyl_torch/csrc/ballquery.cu",
         "point2cyl_tpu/ops/pallas_ballquery.py:213 _ballquery_kernel",
         cuda_ballquery.ball_query_kernel, ball_query_plain,
         (r1, ns1, p512, c512), None, None),
        ("ball_query_grouped_backward@sa1", "point2cyl_torch/csrc/target_sum.cu",
         "point2cyl_tpu/ops/pallas_ballquery.py:675 _bqg_scatter_kernel",
         cuda_ballquery.ball_query_grouped_backward_kernel, group_scatter_plain,
         (idx_sa1, dg_sa1, n1), scatter_work(idx_sa1, dg_sa1, n1),
         index_add_call(idx_sa1, dg_sa1, n1)),
        ("sa_grouped_backward@sa2", "point2cyl_torch/csrc/target_sum.cu",
         "point2cyl_tpu/ops/pallas_ballquery.py:797 _sa_exact_scatter_kernel",
         cuda_ballquery.sa_grouped_backward_kernel, group_scatter_plain,
         (idx_sa2, dg_sa2, l1_4.shape[1]), scatter_work(idx_sa2, dg_sa2, l1_4.shape[1]),
         index_add_call(idx_sa2, dg_sa2, l1_4.shape[1])),
        ("three_nn_backward@fp2", "point2cyl_torch/csrc/target_sum.cu",
         "point2cyl_tpu/ops/pallas_knn.py:110 _knn3_bwd_kernel",
         cuda_knn.three_nn_backward_kernel, cuda_knn.three_nn_backward_plain,
         (*nn_fp2, g_fp2, l2_4.shape[1]), knn_bwd_work(*nn_fp2, g_fp2, l2_4.shape[1]),
         knn_index_add_call(*nn_fp2, g_fp2, l2_4.shape[1])),
        ("three_nn_backward@fp1", "point2cyl_torch/csrc/target_sum.cu",
         "point2cyl_tpu/ops/pallas_knn.py:110 _knn3_bwd_kernel",
         cuda_knn.three_nn_backward_kernel, cuda_knn.three_nn_backward_plain,
         (*nn_fp1, g_fp1, l1_4.shape[1]), knn_bwd_work(*nn_fp1, g_fp1, l1_4.shape[1]),
         knn_index_add_call(*nn_fp1, g_fp1, l1_4.shape[1])),
    ]
    with torch.inference_mode():
        for name, source, replaces, kernel, plain, inputs, work, library in train_cases:
            got = kernel(*inputs)
            torch.cuda.synchronize()
            want = plain(*inputs)
            torch.cuda.synchronize()
            if name.startswith("ball_query@"):
                check(torch.equal(got, want), f"{name}: indices differ from plain")
                err = 0.0
                work = query_work(inputs[2], inputs[3], got)
            else:
                # the plain scatter_add_ adds in another order: 1e-4
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                           msg=lambda m: f"{name}: {m}")
                err = float((got - want).abs().max())
            if kernel in (cuda_ballquery.ball_query_grouped_backward_kernel,
                          cuda_ballquery.sa_grouped_backward_kernel,
                          cuda_knn.three_nn_backward_kernel):
                # the ordered sums: bit-equal to the host's ordered sum and
                # to a second run
                again, host = ordered_sum_case(kernel, inputs)
                check(same_bits(got, torch.from_numpy(host).to(dev)),
                      f"{name}: differs from the host's ordered sum")
                check(same_bits(got, again), f"{name}: two runs differ")
            k_ms = time_ms(lambda: kernel(*inputs))
            p_ms = time_ms(lambda: plain(*inputs))
            l_ms = time_ms(library) if library is not None else None
            if library is not None:
                torch.testing.assert_close(library().reshape(got.shape), want,
                                           rtol=1e-4, atol=1e-4,
                                           msg=lambda m: f"{name} library: {m}")
            b_ms, b_by = bound(*work)
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "max_abs_err": err, "ms": k_ms,
                         "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": l_ms})
            print(json.dumps({"kernel": name, "kernel_ms": k_ms, "plain_ms": p_ms,
                              "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
                              "max_abs_err": err, "card": card}), flush=True)

    # the Functions' card branches: SA1's gather differentiated with respect
    # to the cloud and the centres goes through BallQueryGrouped.backward
    # (item 4), held against autograd of the plain version (tolerance as
    # for the scatters above), and its d_xyz, an ordered sum, bit-equal to
    # the host's and to a second backward
    xk, ck = pts4.clone().requires_grad_(), l1_4.clone().requires_grad_()
    xp, cp = pts4.clone().requires_grad_(), l1_4.clone().requires_grad_()
    before = cuda_ballquery.ball_query_grouped_backward_kernel.launches
    cuda_ballquery.ball_query_grouped(r1, ns1, xk, ck)[1].backward(dg_sa1)
    torch.cuda.synchronize()
    check(cuda_ballquery.ball_query_grouped_backward_kernel.launches == before + 1,
          "BallQueryGrouped.backward did not launch the SA1 gather backward once")
    cuda_ballquery.ball_query_grouped_plain(r1, ns1, xp, cp)[1].backward(dg_sa1)
    for what, got, want in (("d_xyz", xk.grad, xp.grad), ("d_new_xyz", ck.grad, cp.grad)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"BallQueryGrouped {what}: {m}")
    xk2 = pts4.clone().requires_grad_()
    cuda_ballquery.ball_query_grouped(r1, ns1, xk2, l1_4)[1].backward(dg_sa1)
    check(same_bits(xk.grad, torch.from_numpy(host_ordered_sum(
        (idx_sa1, dg_sa1, n1))).to(dev)), "BallQueryGrouped d_xyz differs from the "
          "host's ordered sum")
    check(same_bits(xk.grad, xk2.grad), "BallQueryGrouped d_xyz: two backwards differ")
    # the sources and weights the 3-NN forward saves for its backward
    # (kSave), held against the plain version's; tolerance as for the
    # forward
    saved_err = 0.0
    with torch.inference_mode():
        for name, inputs, (idx_want, w_want) in (
                ("fp2", (l1_4, l2_4, f3_4), nn_fp2), ("fp1", (pts4, l1_4, f2_4), nn_fp1)):
            saved = (torch.empty_like(idx_want), torch.empty_like(w_want))
            cuda_knn.three_nn_interpolate_kernel(*inputs, 1e-8, saved)
            torch.cuda.synchronize()
            check(torch.equal(saved[0], idx_want), f"three_nn@{name}: saved sources "
                  "differ from plain")
            torch.testing.assert_close(saved[1], w_want, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"three_nn@{name} saved weights: {m}")
            saved_err = max(saved_err, float((saved[1] - w_want).abs().max()))
    print(json.dumps({"check": "Functions on the card", "ball_query_grouped_d_xyz_err":
                      float((xk.grad - xp.grad).abs().max()),
                      "three_nn_saved_weights_err": saved_err}), flush=True)
    del l2_f, g_xyz, g_f, f3, f2, train_cases, xk, ck, xp, cp, xk2

    # ---- 2b. the corner cases of the cluster FPS and the thread-per-point
    # 3-NN, each held against the plain version on the card -------------------
    corner_rng = np.random.default_rng(6)

    def fps_case(b, n, seed):
        return torch.from_numpy(clouds(seed, b, n)).to(dev)

    distinct = corner_rng.normal(size=(64, 3)).astype(np.float32)
    repeated = np.stack([distinct[corner_rng.permutation(cfg.num_points) % 64]
                         for _ in range(TB)])
    fps_cases = [
        ("N=512 B=8 (A/B protocol, SA1)", fps_case(8, 512, 30), 512,
         torch.from_numpy(corner_rng.integers(0, 512, size=8)).to(dev)),
        ("N=512 B=8 (A/B protocol, SA2)", fps_case(8, 512, 31), 128, 0),
        ("N=5000 B=3", fps_case(3, 5000, 32), 512,
         torch.from_numpy(corner_rng.integers(0, 5000, size=3)).to(dev)),
        ("N=16384 B=2", fps_case(2, 16384, 33), 512, 0),
        ("64 distinct points repeated, N=8192 B=4", torch.from_numpy(repeated).to(dev),
         512, 0),
        ("64 distinct points repeated, N=8192 B=16",
         torch.from_numpy(np.concatenate([repeated] * 4)).to(dev), 512, 7),
    ]
    fps_checked = []
    with torch.inference_mode():
        for label, xyz, npoint, start in fps_cases:
            got = cuda_fps.farthest_point_sample_kernel(xyz, npoint, start)
            torch.cuda.synchronize()
            want = cuda_fps.farthest_point_sample_plain(xyz, npoint, start)
            check(torch.equal(got, want), f"fps {label}: indices differ from plain")
            fps_checked.append({"case": label, "plan": cuda_fps.fps_launch_plan(
                xyz.shape[0], xyz.shape[1])})

    def knn_inputs(b, n, s, c, seed):
        r = np.random.default_rng(seed)
        return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            r.normal(size=(b, n, 3)), r.normal(size=(b, s, 3)), r.normal(size=(b, s, c)))]

    dup_dst, dup_src, dup_feats = knn_inputs(4, 2048, 128, 64, 40)
    dup_src = dup_src[:, torch.arange(128, device=dev) % 32].contiguous()
    dup_dst[:, :256] = dup_src[:, torch.arange(256, device=dev) % 128]
    mis_dst, mis_src, mis_feats = knn_inputs(4, 2048, 128, 64, 41)
    misaligned = torch.empty(mis_feats.numel() + 1, device=dev)[1:].view(mis_feats.shape)
    misaligned.copy_(mis_feats)
    knn_cases = [
        ("C=67 (scalar path)", knn_inputs(4, 1000, 130, 67, 42)),
        ("S=3", knn_inputs(4, 777, 3, 32, 43)),
        ("duplicated sources (index ties)", [dup_dst, dup_src, dup_feats]),
        ("feats not 16-byte aligned", [mis_dst, mis_src, misaligned]),
    ]
    knn_err = 0.0
    with torch.inference_mode():
        for label, (dst, src, feats) in knn_cases:
            want_idx, want_w = three_nn_weights_plain(dst, src)
            saved = (torch.empty(want_idx.shape, dtype=torch.int32, device=dev),
                     torch.empty(want_w.shape, device=dev))
            want = cuda_knn.three_nn_interpolate_plain(dst, src, feats)
            # every search split, whichever three_nn_lanes picks here
            for lanes in (1, 2, 4):
                for weights in (None, saved):
                    got = cuda_knn.three_nn_interpolate_kernel(dst, src, feats, 1e-8,
                                                               weights, lanes)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(
                        got, want, rtol=1e-5, atol=1e-6,
                        msg=lambda m: f"three_nn {label} ({lanes} lanes): {m}")
                    knn_err = max(knn_err, float((got - want).abs().max()))
                check(torch.equal(saved[0], want_idx.to(torch.int32)),
                      f"three_nn {label} ({lanes} lanes): saved sources differ from plain")
                torch.testing.assert_close(
                    saved[1], want_w, rtol=1e-5, atol=1e-6,
                    msg=lambda m: f"three_nn {label} ({lanes} lanes) saved weights: {m}")
                saved[0].fill_(-1)
                saved[1].fill_(-1.0)

    # the grouped ball queries (items 3 and 5): indices and values bit-equal
    # to the plain version (a NaN equal to a NaN) on every case. SA1 with
    # its own plan, with every query on the grid (cap 2^30) and with every
    # query scanning in index order (cap 0); SA2 with each store (the
    # kernel takes the 4-byte stores where the bulk copy's alignment is
    # missing)
    brng = np.random.default_rng(7)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def some_centres(xyz, s):
        rows = torch.stack([torch.from_numpy(brng.permutation(xyz.shape[1])[:s])
                            for _ in range(xyz.shape[0])]).to(dev)
        return index_points(xyz, rows).contiguous()

    def feats_for(xyz, c=128):
        return on_card(brng.normal(size=(xyz.shape[0], xyz.shape[1], c)))

    dense = clouds(50, 2, cfg.num_points)
    dense[:, :4096] = np.array([1.0, 0.0, 0.0], np.float32) + 0.05 * clouds(51, 2, 4096)
    lattice = 0.25 * np.stack(np.meshgrid(*[np.arange(9)] * 3, indexing="ij"),
                              -1).reshape(-1, 3)
    edge = np.float32(np.float32(0.25) * np.float32(1.015625))  # the grid's cell edge
    on_edges = edge * np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"),
                               -1).reshape(-1, 3)
    exact = np.concatenate([lattice, on_edges]).astype(np.float32)
    exact = np.stack([exact, exact[brng.permutation(len(exact))]])
    outlier = clouds(52, 2, cfg.num_points)
    outlier[:, 0] = [1e4, 0.0, 0.0]
    bad = clouds(53, 2, cfg.num_points)
    bad[0, 5, 1], bad[1, 9, 2], bad[0, 11, 0] = np.nan, np.inf, -np.inf
    bad_xyz = on_card(bad)
    bad_centres = some_centres(bad_xyz, 512)
    bad_centres[0, 0], bad_centres[1, 0] = bad_xyz[0, 5], bad_xyz[1, 9]
    geometry = [  # label, xyz, centres, radius
        ("N=5000 B=3", on_card(clouds(54, 3, 5000)), None, r1),
        ("N=4999 B=3 (not a multiple of 4)", on_card(clouds(55, 3, 4999)), None, r1),
        ("N=16384 B=2 (SA1's scan route)", on_card(clouds(56, 2, 16384)), None, r1),
        ("dense cluster: 4096 points within r of one another", on_card(dense), None, r1),
        ("64 distinct points repeated", on_card(repeated), None, r1),
        ("lattice at spacing r and points on cell edges, r=0.25", on_card(exact),
         None, 0.25),
        ("an outlier at 1e4 (the cell cap)", on_card(outlier), None, r1),
        ("NaN and inf coordinates, centres among them", bad_xyz, bad_centres, r1),
    ]
    sa1_cases = [(f"main shape B={b}", r1, ns1, pts[:b].contiguous(), l1_xyz[:b].contiguous())
                 for b in (1, TB, B)]
    sa2_cases = [(f"main shape B={b}", r2, ns2, l1_xyz[:b].contiguous(),
                  l1_f[:b].contiguous(), l2_xyz[:b].contiguous()) for b in (1, TB, B)]
    for label, xyz, centres, radius in geometry:
        centres = some_centres(xyz, 512) if centres is None else centres
        sa1_cases.append((label, radius, ns1, xyz, centres))
        sa2_cases.append((label, radius, ns2, xyz, feats_for(xyz), centres))
    sa1_cases.append(("nsample 63 (4-byte stores)", r1, 63, pts4, l1_4))
    c67 = feats_for(l1_4, 67)
    mis_sa2 = torch.empty(l1f_4.numel() + 1, device=dev)[1:].view(l1f_4.shape)
    mis_sa2.copy_(l1f_4)
    sa2_cases += [("C=67", r2, ns2, l1_4, c67, l2_4),
                  ("feats not 16-byte aligned", r2, ns2, l1_4, mis_sa2, l2_4),
                  ("nsample 63", r2, 63, l1_4, l1f_4, l2_4)]
    bq_checked = 0
    bq_routes = {}
    with torch.inference_mode():
        for kernel, plain, bq_cases in (
                (cuda_ballquery.ball_query_grouped_kernel,
                 cuda_ballquery.ball_query_grouped_plain, sa1_cases),
                (cuda_ballquery.sa_grouped_exact_kernel,
                 cuda_ballquery.sa_grouped_exact_plain, sa2_cases)):
            for label, *inputs in bq_cases:
                want = plain(*inputs)
                b, n = inputs[2].shape[:2]
                s, ns = inputs[-1].shape[1], inputs[1]
                if kernel is cuda_ballquery.ball_query_grouped_kernel:
                    plans = [cuda_ballquery.ball_query_plan(b, n, s, ns, cap=cap)
                             for cap in (cuda_ballquery.GRID_CAP, 1 << 30, 0)]
                else:
                    c = inputs[3].shape[2]
                    # the wrapper's own plan first; the bulk copy's buffers
                    # do not fit beside N=16384 points
                    plans = [cuda_ballquery.ball_query_plan(b, n, s, ns, c)]
                    plans += [p for p in (cuda_ballquery.ball_query_plan(
                        b, n, s, ns, c, store=store) for store in ("bulk", "scalar"))
                        if p is not None and p != plans[0]]
                for plan in plans:
                    got = kernel(*inputs, plan=plan)
                    torch.cuda.synchronize()
                    check(torch.equal(got[0], want[0]),
                          f"{kernel.__name__} {label} {plan}: indices differ from plain")
                    check(same_bits(got[1], want[1]),
                          f"{kernel.__name__} {label} {plan}: values differ from plain")
                    bq_checked += 1
                bq_routes[f"{kernel.__name__} {label}"] = plans[0].select
    check(bq_routes["ball_query_grouped_kernel N=16384 B=2 (SA1's scan route)"] == "scan"
          and bq_routes["ball_query_grouped_kernel main shape B=16"] == "grid",
          f"SA1 routes {bq_routes}")

    # the idx-only ball query (item 2): indices equal to the plain version,
    # its ballots up to N=1024, the index-order scan above
    def idx_case(seed, b, n, s, radius, ns=ns1):
        xyz = on_card(clouds(seed, b, n))
        return radius, ns, xyz, some_centres(xyz, s)

    nan_xyz = clouds(61, 4, 512)
    nan_xyz[0, 5, 1], nan_xyz[1, 9, 2], nan_xyz[2, 11, 0] = np.nan, np.inf, -np.inf
    nan_xyz = on_card(nan_xyz)
    nan_centres = some_centres(nan_xyz, 512)
    nan_centres[0, 0], nan_centres[1, 0] = nan_xyz[0, 5], nan_xyz[1, 9]
    tight = on_card(0.01 * clouds(62, 2, 1000))  # every point within r of every other
    idx_cases = [
        ("N=33 B=3 (one block, lanes past N), S=33, nsample 16",
         idx_case(63, 3, 33, 33, 0.6, 16)),
        ("N=1000 B=4 (a ragged last block), S=500", idx_case(64, 4, 1000, 500, r1)),
        ("N=1024 B=4 (8 blocks), S=512", idx_case(65, 4, 1024, 512, r1)),
        ("N=1025 B=4 (the index-order scan)", idx_case(66, 4, 1025, 512, r1)),
        ("nsample 63 (4-byte stores), N=512 B=8", (r1, 63, p512, c512)),
        ("S=300, not a multiple of a CTA's warps", (r1, ns1, p512, c512[:, :300].contiguous())),
        ("NaN and inf coordinates, centres among them", (r1, ns1, nan_xyz, nan_centres)),
        ("a cloud all within the radius, N=1000", (r1, ns1, tight, some_centres(tight, 256))),
        ("N=510 (4-byte loads), B=8", (r1, ns1, p512[:, :510].contiguous(), c512)),
    ]
    idx_routes = {}
    with torch.inference_mode():
        for label, inputs in idx_cases:
            got = cuda_ballquery.ball_query_kernel(*inputs)
            torch.cuda.synchronize()
            check(torch.equal(got, ball_query_plain(*inputs)),
                  f"ball_query_kernel {label}: indices differ from plain")
            b, n = inputs[2].shape[:2]
            idx_routes[label] = cuda_ballquery.ball_query_plan(
                b, n, inputs[3].shape[1], inputs[1], gather=False).select
    check(idx_routes["N=1025 B=4 (the index-order scan)"] == "scan"
          and idx_routes["N=1024 B=4 (8 blocks), S=512"] == "ballot",
          f"idx-only routes {idx_routes}")
    del l1_xyz, l1_f, l2_xyz, geometry, sa1_cases, sa2_cases, bad_xyz, bad_centres
    del idx_cases, nan_xyz, nan_centres, tight

    # the ordered per-target sums (items 8 and 6): each case bit-equal to
    # the host's ordered sum (np.add.at) at the wrapper's plan
    srng = np.random.default_rng(8)

    def snormal(*shape):
        return torch.from_numpy(srng.normal(size=shape).astype(np.float32)).to(dev)

    def misaligned(t):
        view = torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape)
        return view.copy_(t)

    def nn_case(dst, src, c, g=None):
        idx, w = (t.to(dt).contiguous() for t, dt in zip(
            three_nn_weights_plain(dst, src), (torch.int32, torch.float32)))
        g = snormal(*dst.shape[:2], c) if g is None else g
        return cuda_knn.three_nn_backward_kernel, (idx, w, g, src.shape[1])

    def ball_case(radius, xyz, centres, c, dg=None):
        idx = ball_query_plain(radius, ns2, xyz, centres).contiguous()
        dg = snormal(*idx.shape, 3 + c) if dg is None else dg
        return cuda_ballquery.sa_grouped_backward_kernel, (idx, dg, xyz.shape[1])

    def sa1_case(xyz, centres):
        idx = ball_query_plain(r1, ns1, xyz, centres).contiguous()
        return cuda_ballquery.ball_query_grouped_backward_kernel, (
            idx, snormal(*idx.shape, 3), xyz.shape[1])

    with torch.inference_mode():
        s3_dst, s3_src, _ = knn_inputs(4, 777, 3, 32, 43)
        c67_dst, c67_src, _ = knn_inputs(4, 1000, 130, 67, 42)
        l2_512 = index_points(c512, cuda_fps.farthest_point_sample_plain(c512, 128))
        lone_xyz, lone_centres = l1_4.clone(), l2_4.clone()
        lone_xyz[:, 0] = lone_centres[:, 0] = 5.0  # a ball of one point, padded 64 times
        dense512 = clouds(57, TB, 512)
        dense512[:, :256] = np.array([1.0, 0.0, 0.0], np.float32) + 0.05 * clouds(58, TB, 256)
        dense512 = on_card(dense512)
        big = on_card(clouds(59, 2, 16384))
        # eight isolated points, each its own ball's centre: balls of one
        # point, padded 64 times onto it
        lone1_xyz, lone1_centres = pts4.clone(), l1_4.clone()
        far = 5.0 + torch.arange(8, device=dev, dtype=torch.float32)[:, None]
        lone1_xyz[:, :8] = lone1_centres[:, :8] = far
        dense1 = on_card(dense)
        scatter_cases = [
            ("3-NN S=3", nn_case(s3_dst, s3_src, 32)),
            ("3-NN duplicated sources", nn_case(dup_dst, dup_src, 64)),
            ("3-NN C=67 (4-byte loads)", nn_case(c67_dst, c67_src, 67)),
            ("3-NN g not 16-byte aligned",
             nn_case(mis_dst, mis_src, 64, misaligned(snormal(4, 2048, 64)))),
            ("3-NN FP1 N=512 B=8 (512 -> 512)", nn_case(p512, c512, 128)),
            ("3-NN FP2 N=512 B=8 (cat slice)",
             nn_case(c512, l2_512, 256, snormal(8, 512, 384)[..., 128:])),
            ("3-NN N=16384 B=2 (two windows)", nn_case(big, big[:, :1024].contiguous(), 128)),
            ("3-NN N=12000 B=2 (one window of 36,000 entries, lane runs of 64 words)",
             nn_case(big[:, :12000].contiguous(), big[:, :1024].contiguous(), 128)),
            ("3-NN FP1 B=1", nn_case(pts4[:1], l1_4[:1], 128)),
            ("3-NN FP2 B=1 (cat slice)",
             nn_case(l1_4[:1], l2_4[:1], 256, snormal(1, 512, 384)[..., 128:])),
            ("SA2 N=512 B=8", ball_case(r2, c512, l2_512, 128)),
            ("SA2 C=67", ball_case(r2, l1_4, l2_4, 67)),
            ("SA2 width 128 (16-byte loads)", ball_case(r2, l1_4, l2_4, 125)),
            ("SA2 width 128, dg not 16-byte aligned",
             ball_case(r2, l1_4, l2_4, 125, misaligned(snormal(TB, 128, ns2, 128)))),
            ("SA2 a one-point ball padded 64 times", ball_case(r2, lone_xyz, lone_centres, 128)),
            ("SA2 dense cluster: 256 points within r of one another",
             ball_case(r2, dense512, some_centres(dense512, 128), 128)),
            ("SA2 N=16384 B=2", ball_case(r1, big, some_centres(big, 512), 128)),
            ("SA2 B=1", ball_case(r2, l1_4[:1], l2_4[:1], 128)),
            ("SA1 eight one-point balls padded 64 times", sa1_case(lone1_xyz, lone1_centres)),
            ("SA1 dense cluster: 4096 points within r of one another",
             sa1_case(dense1, some_centres(dense1, 512))),
            ("SA1 B=1", sa1_case(pts4[:1], l1_4[:1])),
            ("SA1 N=16384 B=2", sa1_case(big, some_centres(big, 512))),
        ]
        for label, (kernel, inputs) in scatter_cases:
            got, host = ordered_sum_case(kernel, inputs)
            torch.cuda.synchronize()
            check(same_bits(got, torch.from_numpy(host).to(dev)),
                  f"{kernel.__name__} {label}: differs from the host's ordered sum")
            check(same_bits(got, kernel(*inputs)), f"{kernel.__name__} {label}: two runs differ")
        for label, (kernel, inputs) in scatter_cases:
            if label.startswith("SA1"):
                plan = cuda_scatter.scatter_plan(inputs[0].shape[0], inputs[-1],
                                                 inputs[0][0].numel(), group_width=3)
                check(plan.listing == "counts", f"{label}: not the counts listing")
        for label in ("SA2 a one-point ball padded 64 times",
                      "SA1 eight one-point balls padded 64 times"):
            lone = dict(scatter_cases)[label][1][0]
            check(bool((lone[:, 0] == lone[:, 0, :1]).all()), f"{label}: not padded")

    # no host sync in an FPS call with a start tensor on the card (the
    # train step's), and an out-of-range start is an error, never an index:
    # on the host for an int, in the kernel for a card tensor (a
    # device-side assert poisons the context, so in a child process)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cuda_fps.farthest_point_sample_kernel(pts4, cfg.sa_npoints[0], start_sa1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    try:
        cuda_fps.farthest_point_sample_kernel(pts4, 16, cfg.num_points)
        raise RuntimeError("check failed: an int FPS start of N was taken")
    except ValueError:
        pass
    child = subprocess.run(
        [sys.executable, "-c", (
            "import torch\n"
            "from point2cyl_torch.ops import cuda_fps\n"
            "x = torch.rand(2, 1000, 3, device='cuda')\n"
            "start = torch.tensor([3, 1000], device='cuda')\n"
            "try:\n"
            "    cuda_fps.farthest_point_sample_kernel(x, 8, start)\n"
            "    torch.cuda.synchronize()\n"
            "except RuntimeError as err:\n"
            "    print('raised:', str(err).splitlines()[0])\n"
            "else:\n"
            "    print('no error')\n")],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [os.path.dirname(os.path.abspath(__file__)),
                          os.environ.get("PYTHONPATH")])))
    )
    check("raised:" in child.stdout and "assert" in child.stdout,
          f"an out-of-range FPS start on the card was not reported: "
          f"{child.stdout!r} {child.stderr[-400:]!r}")

    # FPS time a step: the slope of the SA1 kernel's time over npoint
    npoints = (64, 128, 256, 512)
    with torch.inference_mode():
        slope_ms = [time_ms(lambda: cuda_fps.farthest_point_sample_kernel(pts, m))
                    for m in npoints]
    slope, intercept = np.polyfit(npoints, slope_ms, 1)
    print(json.dumps({"check": "corner cases", "fps": fps_checked,
                      "three_nn": [label for label, _ in knn_cases],
                      "three_nn_max_abs_err": knn_err,
                      "ball_query_cases_checked": bq_checked,
                      "ball_query_routes": bq_routes,
                      "idx_only_routes": idx_routes,
                      "scatter_cases": [label for label, _ in scatter_cases],
                      "fps_sync_free": True,
                      "fps_bad_start_on_card": child.stdout.strip()}), flush=True)
    print(json.dumps({"fps_step": "SA1 B=16", "plan": cuda_fps.fps_launch_plan(
        B, cfg.num_points), "npoint": list(npoints), "ms": slope_ms,
        "us_per_step": slope * 1e3, "intercept_ms": intercept, "card": card}), flush=True)

    # ---- 3. the slice through the session ----------------------------------
    counters = {
        "fps": cuda_fps.farthest_point_sample_kernel,
        "ball_query": cuda_ballquery.ball_query_kernel,
        "ball_query_grouped": cuda_ballquery.ball_query_grouped_kernel,
        "ball_query_grouped_backward": cuda_ballquery.ball_query_grouped_backward_kernel,
        "sa_grouped_exact": cuda_ballquery.sa_grouped_exact_kernel,
        "sa_grouped_backward": cuda_ballquery.sa_grouped_backward_kernel,
        "three_nn": cuda_knn.three_nn_interpolate_kernel,
        "three_nn_backward": cuda_knn.three_nn_backward_kernel,
    }
    # serving launches no idx-only query (its SA1 has N > 1024, its SA2
    # features) and no backward
    per_forward = {"fps": 2, "ball_query": 0, "ball_query_grouped": 1,
                   "ball_query_grouped_backward": 0, "sa_grouped_exact": 1,
                   "sa_grouped_backward": 0, "three_nn": 2, "three_nn_backward": 0}
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
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.is_user_annotation]
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

    # ---- 5. training at full width ----------------------------------------
    tcfg = TrainConfig(batch_size=TB, pred_seg=True, pred_normal=True, pred_bb=True,
                       pred_extrusion=True, pred_center=True, seed=0)
    trainer = build_trainer(tcfg, cfg.num_points, K, dev)
    pipeline = build_pipeline(tcfg, cfg.num_points, K, dev, synthetic=16)
    per_step = {"fps": 2, "ball_query": 0, "ball_query_grouped": 1,
                "ball_query_grouped_backward": 0, "sa_grouped_exact": 1,
                "sa_grouped_backward": 1, "three_nn": 2, "three_nn_backward": 2}
    gen = epoch_generator(tcfg.seed, 1, dev)
    for fn in counters.values():
        fn.launches = 0
    auxes = [trainer.train_step(batch, gen) for batch in pipeline.epochs(TB, gen)]
    torch.cuda.synchronize()
    train_launches = {name: fn.launches for name, fn in counters.items()}
    for name, count in train_launches.items():
        check(count == per_step[name] * len(auxes),
              f"{name} launched {count} times over {len(auxes)} train steps, "
              f"expected {per_step[name] * len(auxes)}")
    totals = [float(a["total"]) for a in auxes]
    check(len(auxes) >= 4 and all(np.isfinite(totals)), f"train losses {totals}")
    check(not any(float(a["skipped"]) for a in auxes), "a train step was skipped")
    zero_grad = [name for name, p in trainer.model.named_parameters()
                 if p.grad is None or not bool((p.grad != 0).any())]
    check(not zero_grad, f"parameters without a gradient: {zero_grad}")
    print(json.dumps({"train": "full width", "steps": len(auxes), "loss": totals,
                      "launches": train_launches,
                      "parameters_with_gradient": sum(
                          1 for _ in trainer.model.parameters())}), flush=True)

    # one step held against the same step with every *_impl="plain"
    plain_train_cfg = dataclasses.replace(trainer.model.cfg, fps_impl="plain",
                                          ballquery_impl="plain", knn_impl="plain")
    plain_trainer = steps.Trainer(Backbone(plain_train_cfg).to(dev), tcfg)
    plain_trainer.load_state_dict(trainer.state_dict())
    batch = pipeline.batch(torch.arange(TB, device=dev), epoch_generator(0, 99, dev))
    got = trainer.train_step(batch, torch.Generator(dev).manual_seed(7))
    want = plain_trainer.train_step(batch, torch.Generator(dev).manual_seed(7))
    loss_err = abs(float(got["total"]) - float(want["total"]))
    check(loss_err <= 1e-5 * abs(float(want["total"])), f"loss kernel {float(got['total'])} "
          f"vs plain {float(want['total'])}")
    # Tolerance for each parameter: 1e-3 of its largest gradient plus 1e-4
    # of the largest gradient of any parameter. Float atomics (the kernels,
    # and autograd's own scatters on the plain side) add in no fixed order,
    # and a bias in front of batch-statistics BN has an analytic gradient
    # of 0: what it holds is that summation noise, about 1e-5 of the
    # largest gradient, which the plain path alone shows from run to run.
    pairs = list(zip(trainer.model.named_parameters(),
                     plain_trainer.model.named_parameters()))
    top = max(float(pp.grad.abs().max()) for _, (_, pp) in pairs)
    grad_err = 0.0
    for (name, pk), (_, pp) in pairs:
        scale = float(pp.grad.abs().max())
        err = float((pk.grad - pp.grad).abs().max())
        check(err <= 1e-3 * scale + 1e-4 * top,
              f"gradient of {name}: {err} vs its scale {scale}, largest {top}")
        grad_err = max(grad_err, err / (1e-3 * scale + 1e-4 * top))
    bn_err = 0.0
    for (name, bk), (_, bp) in zip(trainer.model.named_buffers(),
                                   plain_trainer.model.named_buffers()):
        torch.testing.assert_close(bk, bp, rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"BN statistic {name}: {m}")
        bn_err = max(bn_err, float((bk - bp).abs().max()))
    print(json.dumps({"check": "train step vs plain", "loss_abs_err": loss_err,
                      "grad_err_over_tolerance": grad_err, "largest_grad": top,
                      "bn_max_abs_err": bn_err}), flush=True)
    del plain_trainer

    step_ms = []
    for epoch in (2, 3):
        gen = epoch_generator(tcfg.seed, epoch, dev)
        for batch in pipeline.epochs(TB, gen):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step(batch, gen)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
    print(json.dumps({"rate": "train step", "batch": TB, "num_points": cfg.num_points,
                      "ms_per_step": statistics.median(step_ms), "steps": len(step_ms),
                      "card": card}), flush=True)
    if args.profile:
        gen = epoch_generator(tcfg.seed, 4, dev)
        batches = pipeline.epochs(TB, gen)
        profile_steps("train step", lambda: trainer.train_step(next(batches), gen), card,
                      statistics.median(step_ms))

    # the loss's gradient with respect to the input clouds (a saliency map
    # of the trained model, stored BN statistics): SA1's gather backward
    # runs here, and in no train step
    batch = pipeline.batch(torch.arange(TB, device=dev), epoch_generator(0, 98, dev))
    cloud = batch["point_cloud"].clone().requires_grad_()
    for fn in counters.values():
        fn.launches = 0
    x_raw, w_raw = trainer.model(cloud)
    heads = steps.assemble_heads(x_raw, w_raw, tcfg.pred_seg, tcfg.pred_bb, k=K)
    steps.proxy_losses(heads, dict(batch, point_cloud=cloud), tcfg)[0].backward()
    torch.cuda.synchronize()
    saliency_launches = {name: fn.launches for name, fn in counters.items()}
    per_saliency = dict(per_step, ball_query_grouped_backward=1)
    for name, count in saliency_launches.items():
        check(count == per_saliency[name],
              f"saliency: {name} launched {count} times, expected {per_saliency[name]}")
    check(bool(torch.isfinite(cloud.grad).all()) and bool((cloud.grad != 0).any()),
          "the gradient with respect to the clouds is not finite, or zero")
    print(json.dumps({"saliency": "d loss / d cloud", "launches": saliency_launches,
                      "grad_abs_max": float(cloud.grad.abs().max())}), flush=True)
    trainer.optimizer.zero_grad(set_to_none=True)
    del trainer, pipeline, cloud, heads, x_raw, w_raw

    # two epochs through the CLI's train(), then a resume that continues;
    # phase 7 evaluates its checkpoint
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    logdir = os.path.join(work.name, "cli_run")
    cli_cfg = dataclasses.replace(tcfg, num_epochs=2, logdir=logdir)
    done = train(cli_cfg, cfg.num_points, K, synthetic=8, device=dev)
    check(done.step == 4, f"2 epochs of 8 clouds at B=4 took {done.step} steps")
    resumed = train(dataclasses.replace(cli_cfg, num_epochs=3, resume=True),
                    cfg.num_points, K, synthetic=8, device=dev)
    check(resumed.step == 6, f"the resumed run ended at step {resumed.step}, not 6")
    with open(os.path.join(logdir, "log.txt")) as f:
        log = f.read()
    check("epoch 2, step 4" in log and "> Epoch 0003 done" in log
          and "> Epoch 0001 done" in log.split("Resumed from")[0],
          "the resumed run did not continue at epoch 3, step 4")
    print(json.dumps({"check": "cli resume", "steps": [done.step, resumed.step]}),
          flush=True)
    del done, resumed

    # ---- 6. training at N=512, B=8 (the A/B protocol) ----------------------
    small = build_trainer(dataclasses.replace(tcfg, batch_size=8), 512, K, dev)
    pipe512 = build_pipeline(tcfg, 512, K, dev, synthetic=16)
    per_step_512 = dict(per_step, ball_query=1, ball_query_grouped=0)
    for fn in counters.values():
        fn.launches = 0
    aux512 = []
    for epoch in (1, 2):
        gen = epoch_generator(tcfg.seed, epoch, dev)
        aux512 += [small.train_step(batch, gen) for batch in pipe512.epochs(8, gen)]
    torch.cuda.synchronize()
    launches_512 = {name: fn.launches for name, fn in counters.items()}
    for name, count in launches_512.items():
        check(count == per_step_512[name] * len(aux512),
              f"N=512: {name} launched {count} times over {len(aux512)} steps")
    totals512 = [float(a["total"]) for a in aux512]
    check(all(np.isfinite(totals512)), f"N=512 losses {totals512}")
    print(json.dumps({"train": "N=512 B=8", "steps": len(aux512), "loss": totals512,
                      "launches": launches_512}), flush=True)

    # ---- 7. evaluation ------------------------------------------------------
    per_eval_batch = dict(per_forward)
    eval_argv = ["--synthetic", "8", "--num_point", str(cfg.num_points), "--K", str(K),
                 "--batch_size", str(TB), "--no_implicit", "--logdir", logdir]
    for fn in counters.values():
        fn.launches = 0
    means = evaluator.cli_main(eval_argv)
    torch.cuda.synchronize()
    eval_launches = {name: fn.launches for name, fn in counters.items()}
    with open(os.path.join(logdir, "log_evaluate.txt")) as f:
        eval_log = f.read().splitlines()
    check(eval_log[0] == f"Restored backbone from {logdir}/model",
          f"the evaluator did not restore the CLI checkpoint: {eval_log[0]!r}")
    block = eval_log[eval_log.index("=" * 20) + 1:]
    check(len(block) == 8 and block[0] == "Num evaluated= 8"
          and all(np.isfinite(float(line.rsplit("=", 1)[1])) for line in block),
          f"metric block {block}")
    for name, count in eval_launches.items():
        check(count == per_eval_batch[name] * 2,
              f"eval: {name} launched {count} times over 2 batches, "
              f"expected {per_eval_batch[name] * 2}")
    print(json.dumps({"eval": "full width, cli_main", "clouds": 8, "batch": TB,
                      "launches": eval_launches, **means}), flush=True)

    # the same batches through evaluate() with every *_impl="plain"
    state = CheckpointManager(logdir).load("model", dev)["model"]
    eval_cfg = EvalConfig(num_sketch_samples=SK)
    # the trainer's backbone is cfg: full width, heads [3, 2K], exact
    eval_model = build_backbone(cfg, state_dict=state, device=dev)
    eval_plain = build_backbone(plain_cfg, state_dict=state, device=dev)
    eval_pipe = InputPipeline(generate_dataset(8, resolution=cfg.num_points,
                                               max_instances=K, num_sketch_points=SK,
                                               seed=1), cfg.num_points, K, dev)
    eval_batches = list(eval_pipe.epochs(TB, torch.Generator(dev).manual_seed(0),
                                         shuffle=False))
    quiet = lambda msg: None  # noqa: E731
    got = evaluator.evaluate(eval_model, eval_batches, eval_cfg, TB, log=quiet)
    want = evaluator.evaluate(eval_plain, eval_batches, eval_cfg, TB, log=quiet)
    eval_err = {name: abs(got[name] - want[name]) for name in EVAL_ATOL}
    for name, atol in EVAL_ATOL.items():
        check(eval_err[name] <= atol, f"eval {name}: kernels {got[name]} vs plain "
              f"{want[name]}, tolerance {atol}")
    print(json.dumps({"check": "eval vs plain", "abs_err": eval_err,
                      "atol": EVAL_ATOL}), flush=True)

    # clouds per second of evaluate() and the ms of one eval step
    eval_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluator.evaluate(eval_model, eval_batches, eval_cfg, TB, log=quiet)
        eval_s.append(time.perf_counter() - t0)
    step = evaluator.make_eval_step(eval_model, eval_cfg, SK)
    gen = torch.Generator(dev).manual_seed(0)
    step_eval_ms = time_ms(lambda: step(eval_batches[0], gen))
    print(json.dumps({"rate": "evaluate", "batch": TB, "num_points": cfg.num_points,
                      "clouds_per_s": 8 / statistics.median(eval_s),
                      "evaluate_s": eval_s, "ms_per_eval_step": step_eval_ms,
                      "card": card}), flush=True)
    if args.profile:
        profile_steps("eval step", lambda: step(eval_batches[0], gen), card, step_eval_ms)

    # the N=512 protocol: phase 6's weights on the committed held-out pack
    logdir512 = os.path.join(work.name, "n512")
    CheckpointManager(logdir512).save("model", {"model": small.model.state_dict()})
    per_eval_512 = dict(per_eval_batch, ball_query=1, ball_query_grouped=0)
    for fn in counters.values():
        fn.launches = 0
    means512 = evaluator.cli_main(["--data_dir", "ab_data", "--data_split", "test",
                                   "--num_point", "512", "--K", str(K), "--batch_size",
                                   "8", "--no_implicit", "--seed", "0",
                                   "--logdir", logdir512])
    torch.cuda.synchronize()
    eval_launches_512 = {name: fn.launches for name, fn in counters.items()}
    batches512 = 32 // 8
    for name, count in eval_launches_512.items():
        check(count == per_eval_512[name] * batches512,
              f"eval N=512: {name} launched {count} times over {batches512} batches")
    check(all(np.isfinite(v) for v in means512.values()), f"eval N=512 means {means512}")
    print(json.dumps({"eval": "N=512 B=8, ab_data/test.h5", "launches": eval_launches_512,
                      **means512}), flush=True)

    # ---- 8. the implicit stack at full width -------------------------------
    # an IGR checkpoint of ImplicitNet and the 4-channel sketch encoder, and
    # a joint-layout one with the 7-channel whole-cloud encoder, from a seed
    gen8 = torch.Generator().manual_seed(8)
    implicit8 = ImplicitNet(d_in=258)
    implicit8.reset_parameters(gen8)
    im_dirs = {}
    for key, encoder8, names in (
            ("sketch", PointNetEncoder(256, 2, with_normals=True),
             ("model", "model_state_dict", "encoder_state_dict")),
            ("whole pc, axis", PointNetEncoder(256, 7, with_normals=False),
             ("im_model", "implicit_net", "pn_encoder"))):
        encoder8.reset_parameters(gen8)
        with torch.no_grad():
            for m in encoder8.modules():
                if isinstance(m, EncoderBatchNorm):
                    m.weight.uniform_(0.5, 1.5, generator=gen8)
                    m.bias.normal_(0.0, 0.1, generator=gen8)
                    m.running_mean.normal_(0.0, 0.1, generator=gen8)
                    m.running_var.uniform_(0.5, 1.5, generator=gen8)
        im_dirs[key] = (os.path.join(work.name, key.replace(" ", "_").replace(",", "")),
                        names[0])
        os.makedirs(im_dirs[key][0])
        torch.save({names[1]: implicit8.state_dict(), names[2]: encoder8.state_dict()},
                   os.path.join(im_dirs[key][0], f"{names[0]}.pth"))

    # serving: the export CLI on phase 5's checkpoint, with and without the
    # encoder, and the same requests through both sessions
    arts = {name: os.path.join(work.name, f"{name}.p2ct") for name in ("lat", "geo")}
    export_argv = ["--logdir", logdir, "--num_point", str(cfg.num_points), "--K", str(K),
                   "--num_sk_point", str(SK), "--buckets", "1", "4", "16"]
    meta_lat = export_cli.cli_main(export_argv + ["--out", arts["lat"], "--im_logdir",
                                                  im_dirs["sketch"][0]])
    meta_geo = export_cli.cli_main(export_argv + ["--out", arts["geo"]])
    check(meta_lat["with_latents"] and meta_lat["latent_size"] == 256
          and not meta_geo["with_latents"], "export CLI metas")
    sess_lat, sess_geo = InferenceSession(arts["lat"]), InferenceSession(arts["geo"])
    check(sess_lat.encoder is not None and sess_geo.encoder is None, "session encoders")
    for fn in counters.values():
        fn.launches = 0
    lat_results = {n: sess_lat.decompose(p) for n, p in requests.items()}
    torch.cuda.synchronize()
    lat_launches = {name: fn.launches for name, fn in counters.items()}
    for name, count in lat_launches.items():
        check(count == per_forward[name] * forwards,
              f"latents: {name} launched {count} times over {forwards} forwards, "
              f"expected {per_forward[name] * forwards}")
    lat_err = norm_err = 0.0
    for n, p in requests.items():
        got, geo = lat_results[n], sess_geo.decompose(p)
        exact = sess_lat.decompose(p, exact_latents=True)
        check(got["latents"].shape == (n, K, 256) and bool(np.isfinite(got["latents"]).all()),
              f"decompose({n}) latents {got['latents'].shape}")
        norm_err = max(norm_err, float(np.abs(np.linalg.norm(got["latents"], axis=-1)
                                              - 1.0).max()))
        lat_err = max(lat_err, float(np.abs(got["latents"] - exact["latents"]).max()))
        for key, val in geo.items():
            check(np.array_equal(got[key], val) and np.array_equal(exact[key], val),
                  f"decompose({n}) {key} differs from the artifact without the encoder")
    check(norm_err <= 1e-3, f"latents not unit norm: {norm_err}")
    check(lat_err <= 1e-3, f"float16 latents vs exact_latents: {lat_err}")

    # the kernel path against every *_impl="plain", on the card: heads
    # within 1e-4, labels on >= 0.999 of points, and the latents of each
    # cloud whose labels all agree within 1e-3 (float32 through the
    # encoder from projections within ~1e-5)
    state = CheckpointManager(logdir).load("model", dev)["model"]
    plain8 = build_backbone(plain_cfg, state_dict=state, device=dev)
    with torch.inference_mode():
        got = _backbone_forward(sess_lat.model, pts16, k=K, num_sk_points=SK,
                                encoder=sess_lat.encoder)
        want = _backbone_forward(plain8, pts16, k=K, num_sk_points=SK,
                                 encoder=sess_lat.encoder)
    for key in ("x_raw", "w_raw"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-4,
                                   msg=lambda m: f"latents: plain vs kernel {key}: {m}")
    agree8 = float((got["labels"] == want["labels"]).float().mean())
    check(agree8 >= 0.999, f"latents: labels agree on {agree8:.5f} of points vs plain")
    same = (got["labels"] == want["labels"]).all(dim=-1)
    check(int(same.sum()) >= B // 2, f"only {int(same.sum())} clouds' labels agree")
    plain_lat_err = float((got["latents"] - want["latents"])[same].abs().max())
    check(plain_lat_err <= 1e-3, f"latents kernel vs plain: {plain_lat_err}")
    rate_lat = sess_lat.benchmark(batch=B, iters=20)
    rate_geo = sess_geo.benchmark(batch=B, iters=20)
    # the encoder alone on a bucket's 128 sketches of 2,048 points
    enc_in = torch.randn(B * K, SK, 4, device=dev)
    enc_macs = sum(m.weight.shape[0] * m.weight.shape[1]
                   for m in sess_lat.encoder.modules() if isinstance(m, Dense))
    with torch.inference_mode():
        enc_ms = time_ms(lambda: sess_lat.encoder(enc_in), runs=10)
    enc_flop = 2.0 * (enc_macs * B * K * SK + 1024 * 256 * B * K)
    del enc_in
    print(json.dumps({"slice": "decompose with latents", "requests": [1, 5, 16],
                      "launches": lat_launches, "fp16_vs_exact_max_abs_err": lat_err,
                      "unit_norm_max_err": norm_err, "plain_label_agreement": agree8,
                      "plain_latent_max_abs_err": plain_lat_err,
                      "plain_clouds_compared": int(same.sum())}), flush=True)
    print(json.dumps({"rate": "decompose with latents", **rate_lat,
                      "without_latents": rate_geo["decompositions_per_sec"],
                      "ms_per_request_without_latents": rate_geo["ms_per_request"],
                      "phase4_without_latents": rate["decompositions_per_sec"],
                      "encoder_ms": enc_ms, "encoder_flop": enc_flop,
                      "encoder_flop_bound_ms": enc_flop / FP32_OPS_PER_S * 1e3,
                      "card": card}), flush=True)
    if args.profile:
        profile_steps("decompose(16) with latents", lambda: sess_lat.decompose(requests[16]),
                      card, rate_lat["ms_per_request"])
    del sess_lat, sess_geo, plain8, got, want

    # evaluation: cli_main with the implicit stack, in the default mode and
    # on the whole cloud with its axis feature
    im_argv = ["--synthetic", "8", "--num_point", str(cfg.num_points), "--K", str(K),
               "--batch_size", str(TB), "--num_sk_point", str(SK), "--logdir", logdir]
    im_flags = {"sketch": [], "whole pc, axis": ["--use_whole_pc",
                                                 "--use_extrusion_axis_feat"]}
    im_launches = {}
    for mode, flags in im_flags.items():
        im_dir, name = im_dirs[mode]
        for fn in counters.values():
            fn.launches = 0
        means8 = evaluator.cli_main(im_argv + flags + ["--im_logdir", im_dir])
        torch.cuda.synchronize()
        im_launches[mode] = {name_: fn.launches for name_, fn in counters.items()}
        with open(os.path.join(logdir, "log_evaluate.txt")) as f:
            eval_log = f.read().splitlines()
        check(eval_log[1] == f"Restored implicit stack from {im_dir}/{name}",
              f"{mode}: the evaluator did not restore the implicit stack: {eval_log[1]!r}")
        block = eval_log[eval_log.index("=" * 20) + 1:]
        values = [float(line.rsplit("=", 1)[1]) for line in block]
        check(len(block) == 8 and block[0] == "Num evaluated= 8"
              and all(np.isfinite(values)) and values[-2] > 0 and values[-1] > 0,
              f"{mode}: metric block {block}")
        for name_, count in im_launches[mode].items():
            check(count == per_eval_batch[name_] * 2,
                  f"eval {mode}: {name_} launched {count} times over 2 batches, "
                  f"expected {per_eval_batch[name_] * 2}")
        print(json.dumps({"eval": f"full width, implicit stack, {mode}", "clouds": 8,
                          "batch": TB, "launches": im_launches[mode], **means8}),
              flush=True)

    # the same batches with every *_impl="plain", in both modes, within
    # the CPU parity tests' tolerances
    stacks = {}
    for mode, flags in im_flags.items():
        cfg8 = EvalConfig(num_sketch_samples=SK, use_whole_pc=bool(flags),
                          use_extrusion_axis_feat=bool(flags))
        implicit8, encoder8 = ImplicitNet(d_in=258), evaluator.encoder_for(cfg8)
        check(restore_implicit_stack(im_dirs[mode][0], implicit8, encoder8)
              == im_dirs[mode][1], f"{mode}: restore")
        stacks[mode] = (cfg8, implicit8.to(dev).eval(), encoder8.to(dev).eval())
        fit_got = evaluator.evaluate(eval_model, eval_batches, cfg8, TB, log=quiet,
                                     implicit=stacks[mode][1], encoder=stacks[mode][2])
        fit_want = evaluator.evaluate(eval_plain, eval_batches, cfg8, TB, log=quiet,
                                      implicit=stacks[mode][1], encoder=stacks[mode][2])
        fit_err = {name: abs(fit_got[name] - fit_want[name]) for name in EVAL_FIT_ATOL}
        for name, atol in EVAL_FIT_ATOL.items():
            check(fit_err[name] <= atol, f"eval {mode} {name}: kernels {fit_got[name]} "
                  f"vs plain {fit_want[name]}, tolerance {atol}")
        print(json.dumps({"check": f"eval with implicit stack vs plain, {mode}",
                          "abs_err": fit_err, "atol": EVAL_FIT_ATOL}), flush=True)
    del eval_plain

    # clouds per second of evaluate() and the ms of one eval step with the
    # implicit stack; the decoder alone on the fitting metrics' points
    cfg8, implicit8, encoder8 = stacks["sketch"]
    eval8_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluator.evaluate(eval_model, eval_batches, cfg8, TB, log=quiet,
                           implicit=implicit8, encoder=encoder8)
        eval8_s.append(time.perf_counter() - t0)
    gen = torch.Generator(dev).manual_seed(0)
    step8_ms = {}
    for mode, (cfg_m, implicit_m, encoder_m) in stacks.items():
        step_m = evaluator.make_eval_step(eval_model, cfg_m, SK, implicit_m, encoder_m)
        step8_ms[mode] = time_ms(lambda: step_m(eval_batches[0], gen), runs=10)
    torch.cuda.reset_peak_memory_stats()
    step8 = evaluator.make_eval_step(eval_model, cfg8, SK, implicit8, encoder8)
    step8(eval_batches[0], gen)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    sdf_points = TB * K * (SK + cfg.num_points)
    macs = sum(m.in_features * m.out_features for m in implicit8.modules()
               if isinstance(m, torch.nn.Linear))
    with torch.no_grad():
        x_cyl = torch.randn(TB * K, SK, 258, device=dev)
        x_glob = torch.randn(TB * K, cfg.num_points, 258, device=dev)
        sdf_ms = time_ms(lambda: (implicit8(x_cyl), implicit8(x_glob)), runs=10)
    del x_cyl, x_glob
    sdf_flop = 2.0 * macs * sdf_points
    print(json.dumps({"rate": "evaluate with implicit stack", "batch": TB,
                      "num_points": cfg.num_points, "num_sk_point": SK,
                      "clouds_per_s": 8 / statistics.median(eval8_s), "evaluate_s": eval8_s,
                      "ms_per_eval_step": step8_ms, "peak_gib_eval_step": peak_gib,
                      "card": card}), flush=True)
    print(json.dumps({"gemm": "ImplicitNet on the fitting metrics' points, B=4",
                      "points": sdf_points, "macs_per_point": macs, "flop": sdf_flop,
                      "ms": sdf_ms, "bound_ms": sdf_flop / FP32_OPS_PER_S * 1e3,
                      "tflop_per_s": sdf_flop / sdf_ms / 1e9, "card": card}), flush=True)
    if args.profile:
        profile_steps("eval step with implicit stack", lambda: step8(eval_batches[0], gen),
                      card, step8_ms["sketch"])
    del eval_model, eval_batches, eval_pipe, stacks, step8

    # ---- 9. the joint trainer at full width --------------------------------
    # IGR pretraining through the CLI: 2 epochs of --synthetic 8 at B=4,
    # which launches no backbone kernel
    igr_dir = os.path.join(work.name, "igr_pretrain")
    joint_dir = os.path.join(work.name, "joint")
    sk_argv = ["--synthetic", "8", "--K", str(K), "--batch_size", str(TB),
               "--num_sk_point", str(SK), "--num_point", str(cfg.num_points)]
    for fn in counters.values():
        fn.launches = 0
    pre = train_joint.cli_main(sk_argv + ["--pretrain_im", "--num_epochs", "2",
                                          "--logdir", igr_dir])
    torch.cuda.synchronize()
    pretrain_launches = {name: fn.launches for name, fn in counters.items()}
    check(not any(pretrain_launches.values()), f"pretraining launched {pretrain_launches}")
    check(pre.step == 4, f"2 epochs of 8 sketch sets at B=4 took {pre.step} steps")
    igr_state = torch.load(os.path.join(igr_dir, "model.pth"), map_location="cpu",
                           weights_only=True)
    check(set(igr_state) == {"model_state_dict", "encoder_state_dict"},
          f"the IGR checkpoint's keys {sorted(igr_state)}")
    pre_losses = logged_losses(igr_dir)
    check(len(pre_losses) == 2 * 4 and all(np.isfinite(pre_losses)),
          f"pretrain losses {pre_losses}")

    # the joint CLI at full width from phase 5's backbone (carrying its
    # step, 6) and the pretrained stack, 2 epochs, then a resume
    joint_argv = sk_argv + [
        "--logdir", joint_dir, "--is_pc_init", "--pc_logdir", logdir, "--is_im_init",
        "--im_logdir", igr_dir, "--is_pc_train", "--is_im_train", "--with_im_loss",
        "--init_global_step", "-1", "--pred_seg", "--pred_normal", "--pred_bb",
        "--pred_extrusion", "--pred_center"]
    for fn in counters.values():
        fn.launches = 0
    joint = train_joint.cli_main(joint_argv + ["--num_epochs", "2"])
    torch.cuda.synchronize()
    joint_cli_launches = {name: fn.launches for name, fn in counters.items()}
    for name, count in joint_cli_launches.items():
        check(count == per_step[name] * 4, f"joint CLI: {name} launched {count} times "
              f"over 4 steps, expected {per_step[name] * 4}")
    with open(os.path.join(joint_dir, "log.txt")) as f:
        log = f.read()
    check("carrying trainer-A global step 6" in log and "3D model loaded." in log
          and "Pre-trained fixed implicit model loaded." in log,
          "the joint CLI did not load both stages or carry the step")
    check(joint.step == 10, f"the joint run ended at step {joint.step}, not 6 + 4")
    joint_losses = logged_losses(joint_dir)
    check(len(joint_losses) == 2 * 11 and all(np.isfinite(joint_losses)),
          f"joint losses {joint_losses}")
    layouts = {"model": {"model", "implicit_net", "pn_encoder"}, "pc_model": {"model"},
               "im_model": {"implicit_net", "pn_encoder"}}
    for name, keys in layouts.items():
        state = torch.load(os.path.join(joint_dir, f"{name}.pth"), map_location="cpu",
                           weights_only=True)
        check(keys <= set(state), f"{name}.pth keys {sorted(state)}")
    resumed = train_joint.cli_main(joint_argv + ["--num_epochs", "3", "--resume"])
    with open(os.path.join(joint_dir, "log.txt")) as f:
        log = f.read()
    check(resumed.step == 12 and "epoch 2, step 10" in log and "> Epoch 0003 done" in log,
          f"the resumed joint run did not continue at epoch 3, step 10 ({resumed.step})")
    print(json.dumps({"train": "joint CLI, full width", "steps": [joint.step, resumed.step],
                      "pretrain_steps": pre.step, "launches": joint_cli_launches,
                      "pretrain_launches": pretrain_launches, "loss": joint_losses[-11:],
                      "pretrain_loss": pre_losses[-4:]}), flush=True)

    # one joint step against the same step with every *_impl="plain", from
    # the resumed run's weights, batch and generator; then the launches of
    # a step with and without --is_pc_train
    jcfg = config_from_args(train_joint.build_argparser().parse_args(joint_argv))
    pipe9 = InputPipeline(generate_dataset(8, resolution=cfg.num_points, max_instances=K,
                                           num_sketch_points=SK, seed=0),
                          cfg.num_points, K, dev, num_sketch_points=SK)
    state9 = resumed.state_dict()
    del joint, resumed

    def joint_trainer(plain: bool, is_pc_train: bool = True) -> train_joint.JointTrainer:
        """The resumed run's nets in a joint trainer with a fresh Adam."""
        nets = train_joint.build_nets(jcfg, cfg.num_points, K, False, False, dev)
        if plain:
            nets = (Backbone(dataclasses.replace(nets[0].cfg, fps_impl="plain",
                                                 ballquery_impl="plain",
                                                 knn_impl="plain")).to(dev), *nets[1:])
        for net, key in zip(nets, ("model", "implicit_net", "pn_encoder", "loaded_encoder")):
            net.load_state_dict(state9[key], strict=True)
        return train_joint.JointTrainer(*nets, jcfg, num_sk_points=SK,
                                        is_pc_train=is_pc_train, is_im_train=True,
                                        with_im_loss=True, step=state9["step"])

    batch9 = pipe9.batch(torch.arange(TB, device=dev), epoch_generator(0, 97, dev))
    kernel9, plain9 = joint_trainer(False), joint_trainer(True)
    for fn in counters.values():
        fn.launches = 0
    got = kernel9.train_step(batch9, torch.Generator(dev).manual_seed(7))
    torch.cuda.synchronize()
    step_launches = {name: fn.launches for name, fn in counters.items()}
    want = plain9.train_step(batch9, torch.Generator(dev).manual_seed(7))
    part_err = {key: abs(float(got[key]) - float(want[key])) for key in want}
    for key in ("total", "normal", "miou", "bb", "extrusion", "center", "manifold",
                "eikonal", "sald", "latent", "im_total"):
        check(part_err[key] <= 1e-5 * max(abs(float(want[key])), 1.0),
              f"joint {key}: kernel {float(got[key])} vs plain {float(want[key])}")
    pairs = [(name, pk, pp) for net in ("backbone", "encoder")
             for (name, pk), (_, pp) in zip(getattr(kernel9, net).named_parameters(),
                                             getattr(plain9, net).named_parameters())]
    top = max(float(pp.grad.abs().max()) for _, _, pp in pairs)
    grad_err = 0.0
    for name, pk, pp in pairs:
        check(pk.grad is not None and bool((pk.grad != 0).any()),
              f"joint: {name} has no gradient")
        scale = float(pp.grad.abs().max())
        err = float((pk.grad - pp.grad).abs().max())
        check(err <= 1e-3 * scale + 1e-4 * top,
              f"joint gradient of {name}: {err} vs its scale {scale}, largest {top}")
        grad_err = max(grad_err, err / (1e-3 * scale + 1e-4 * top))
    check(all(p.grad is None for net in (kernel9.implicit, kernel9.loaded_encoder)
              for p in net.parameters()), "a frozen net got a gradient")
    bn_err = 0.0
    for net in ("backbone", "encoder"):
        for (name, bk), (_, bp) in zip(getattr(kernel9, net).named_buffers(),
                                       getattr(plain9, net).named_buffers()):
            torch.testing.assert_close(bk, bp, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"joint BN {net}.{name}: {m}")
            bn_err = max(bn_err, float((bk.double() - bp.double()).abs().max()))
    for key, count in step_launches.items():
        check(count == per_step[key], f"joint step: {key} launched {count} times, "
              f"expected {per_step[key]}")
    del plain9
    frozen9 = joint_trainer(False, is_pc_train=False)
    for fn in counters.values():
        fn.launches = 0
    frozen9.train_step(batch9, torch.Generator(dev).manual_seed(7))
    torch.cuda.synchronize()
    frozen_launches = {name: fn.launches for name, fn in counters.items()}
    for key, count in frozen_launches.items():
        check(count == per_forward[key], f"frozen joint step: {key} launched {count} "
              f"times, expected {per_forward[key]}")
    check(all(p.grad is None for p in frozen9.backbone.parameters()),
          "the frozen backbone got a gradient")
    del frozen9
    print(json.dumps({"check": "joint step vs plain", "abs_err": part_err,
                      "grad_err_over_tolerance": grad_err, "largest_grad": top,
                      "bn_max_abs_err": bn_err, "launches_pc_train": step_launches,
                      "launches_pc_frozen": frozen_launches}), flush=True)

    # ms per joint step and per pretrain step (CUDA events, after a
    # warm-up), their peak memory, and the pretrain step at the reference's
    # B=16 in chunks of 32 instances
    def step_times(step, pipe, batch_size: int, epochs=(2, 3)):
        times = []
        for epoch in epochs:
            gen9 = epoch_generator(0, epoch, dev)
            for batch in pipe.epochs(batch_size, gen9):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step(batch, gen9)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        torch.cuda.reset_peak_memory_stats()
        step(pipe.batch(torch.arange(batch_size, device=dev), gen9), gen9)
        torch.cuda.synchronize()
        return times, torch.cuda.max_memory_allocated() / 2**30

    joint_ms, joint_gib = step_times(kernel9.train_step, pipe9, TB)
    pre_ms, pre_gib = step_times(pre.train_step, pipe9, TB)
    pipe16 = InputPipeline(generate_dataset(16, resolution=cfg.num_points,
                                            max_instances=K, num_sketch_points=SK, seed=0),
                           cfg.num_points, K, dev, num_sketch_points=SK)
    pre.igr_chunk = train_joint.resolve_igr_chunk(0, 16 * K)
    pre16_ms, pre16_gib = step_times(pre.train_step, pipe16, 16)
    pre.igr_chunk = None
    pre16u_ms, pre16u_gib = step_times(pre.train_step, pipe16, 16)
    print(json.dumps({"rate": "joint step", "batch": TB, "num_points": cfg.num_points,
                      "num_sk_point": SK, "ms_per_step": statistics.median(joint_ms),
                      "steps": len(joint_ms), "peak_gib": joint_gib,
                      "pretrain_ms_per_step": statistics.median(pre_ms),
                      "pretrain_peak_gib": pre_gib,
                      "pretrain_b16_chunk32_ms_per_step": statistics.median(pre16_ms),
                      "pretrain_b16_chunk32_peak_gib": pre16_gib,
                      "pretrain_b16_unchunked_ms_per_step": statistics.median(pre16u_ms),
                      "pretrain_b16_unchunked_peak_gib": pre16u_gib, "card": card}),
          flush=True)
    del pipe16

    # the IGR block alone at the joint step's shapes (32 instances of 2,048
    # sketch points and 2,304 off-surface points, latents that need a
    # gradient, the decoder frozen): its forward and its double backward
    sk9 = batch9["sketches"]
    mask9 = torch.ones(TB, K, dtype=torch.bool, device=dev)
    lat9 = torch.nn.functional.normalize(torch.randn(TB, K, 256, device=dev), dim=-1)
    lat9.requires_grad_()

    def igr_block():
        igr_losses(kernel9.implicit, torch.Generator(dev).manual_seed(1), sk9[..., :2],
                   sk9[..., 2:], lat9, mask9).total.backward()

    igr_ms = time_ms(igr_block, runs=10)
    igr_points = TB * K * (SK + SK + SK // 8)
    igr_macs = sum(m.in_features * m.out_features for m in kernel9.implicit.modules()
                   if isinstance(m, torch.nn.Linear))
    # forward, the input gradient and the double backward's two passes, each
    # one GEMM a layer; the frozen decoder takes no weight gradient
    igr_flop = 4 * 2.0 * igr_macs * igr_points
    print(json.dumps({"gemm": "IGR block (forward + double backward), joint step, B=4",
                      "points": igr_points, "macs_per_point": igr_macs, "flop": igr_flop,
                      "ms": igr_ms, "bound_ms": igr_flop / FP32_OPS_PER_S * 1e3,
                      "tflop_per_s": igr_flop / igr_ms / 1e9, "card": card}), flush=True)
    if args.profile:
        gen9 = epoch_generator(0, 4, dev)
        batches9 = iter([batch for _ in range(2) for batch in pipe9.epochs(TB, gen9)])
        profile_steps("joint step", lambda: kernel9.train_step(next(batches9), gen9), card,
                      statistics.median(joint_ms))
    del kernel9, pre, pipe9, batch9, sk9, lat9

    # the joint logdir read back: the evaluator with the implicit stack and
    # the export CLI with the trained encoder
    means9 = evaluator.cli_main(["--synthetic", "8", "--num_point", str(cfg.num_points),
                                 "--K", str(K), "--batch_size", str(TB), "--num_sk_point",
                                 str(SK), "--logdir", joint_dir, "--im_logdir", joint_dir])
    with open(os.path.join(joint_dir, "log_evaluate.txt")) as f:
        eval_log = f.read().splitlines()
    check(eval_log[:2] == [f"Restored backbone from {joint_dir}/model",
                           f"Restored implicit stack from {joint_dir}/model"],
          f"the evaluator did not restore the joint logdir: {eval_log[:2]}")
    block = eval_log[eval_log.index("=" * 20) + 1:]
    values = [float(line.rsplit("=", 1)[1]) for line in block]
    check(len(block) == 8 and all(np.isfinite(values)) and values[-2] > 0
          and values[-1] > 0, f"joint logdir: metric block {block}")
    art9 = os.path.join(work.name, "joint.p2ct")
    meta9 = export_cli.cli_main(["--logdir", joint_dir, "--num_point", str(cfg.num_points),
                                 "--K", str(K), "--num_sk_point", str(SK), "--buckets", "1",
                                 "4", "--out", art9, "--im_logdir", joint_dir])
    lat_out = InferenceSession(art9).decompose(requests[5])["latents"]
    check(meta9["with_latents"] and lat_out.shape == (5, K, 256)
          and bool(np.isfinite(lat_out).all()), f"joint artifact latents {lat_out.shape}")
    print(json.dumps({"eval": "the joint logdir, implicit stack", "clouds": 8, **means9,
                      "export_latents": list(lat_out.shape)}), flush=True)
    work.cleanup()
    print(json.dumps({"script_s": time.perf_counter() - script_t0}), flush=True)

    for row in rows:
        kernel = row["name"].split("@")[0]
        row["eval_launches"] = {"n8192": eval_launches[kernel],
                                "n512": eval_launches_512[kernel],
                                "n8192_implicit": im_launches["sketch"][kernel],
                                "n8192_implicit_whole_pc": im_launches["whole pc, axis"][kernel]}
        row["serve_latents_launches"] = lat_launches[kernel]
        row["joint_launches"] = {"step_pc_train": step_launches[kernel],
                                 "step_pc_frozen": frozen_launches[kernel],
                                 "cli_4_steps": joint_cli_launches[kernel],
                                 "pretrain_cli_4_steps": pretrain_launches[kernel]}
        if kernel == "ball_query":
            row["launches"] = launches_512[kernel]
        elif kernel == "ball_query_grouped_backward":
            row["launches"] = saliency_launches[kernel]
        elif row["name"].endswith("_train"):
            row["launches"] = train_launches[kernel]
        elif kernel in ("fps", "ball_query_grouped", "sa_grouped_exact", "three_nn"):
            row["launches"] = launches[kernel]
        else:
            row["launches"] = train_launches[kernel]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
