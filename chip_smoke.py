"""Drive the PyTorch/CUDA port's serving, training, evaluation, reconstruction, preprocessing, parallel package, bf16 compute, captured steps and large clouds on one NVIDIA GPU.

    python3 chip_smoke.py                  # what a check of the port runs
    python3 chip_smoke.py --profile        # also print device-time breakdowns
    python3 chip_smoke.py --only-parallel  # the set-up and phase 12 alone
    python3 chip_smoke.py --only-parallel multi-card  # only 12c (two cards)
    python3 chip_smoke.py --only-bf16      # the set-up and phase 13 alone
    python3 chip_smoke.py --only-graphs    # the set-up and phases 14 and 15 alone
    python3 chip_smoke.py --only-large     # the set-up and phase 17 alone
    python3 chip_smoke.py --recon-igr-post-process  # reconstruction with the IGR post-process

Phases, in order (phases 14, 15, 12 and 17 run first, right after the
set-up); any failure raises, exits non-zero and prints no result:

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
   so that ties fall across CTAs, NaN and inf coordinates), of the 3-NN
   forward (C=67, S=3,
   duplicated sources, feats that are not 16-byte aligned; with 1, 2 and
   4 threads searching for a point, with and without the saved sources
   and weights) and of the grouped ball queries (the main shapes at B=1,
   4 and 16, N=5000, 4999 and 16384, a dense cluster, repeated points, a
   lattice at spacing r with points on cell edges, an outlier at 1e4,
   NaN and inf coordinates and centres, nsample 63, and at SA2 C=67 and
   misaligned feats; SA1 with its plan, every query on the grid and
   every query scanning, at 16384 its streamed route, SA2 with each
   store; indices and values bit-equal), each against the plain version;
   of the idx-only ball query (N=33, 1000, 1024, 1025 and 1535, the
   index-order scan, and 1536, the streamed query, N=510 with
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
4. (No rate: the benchmark, ``p2cbench``, measures the session.)
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
   agree), and the encoder's ms on a bucket's sketches. Evaluation: ``cli_main`` with the
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
   carried step, finite losses, the launches of 4 steps (the eager
   first step and the capture; the two replays launch no wrapper), the
   three written files) and its ``--resume`` to epoch 3. One eager joint
   step from the resumed weights against the same step with every
   ``*_impl="plain"``:
   the loss and its parts within 1e-5, every backbone and encoder
   gradient within phase 5's rule and non-zero, none on the decoder, the
   BN statistics; the launches of a step with and without
   ``--is_pc_train``. The ms per eager joint step and per eager pretrain
   step (and the pretrain step at B=16 in chunks of 32 instances and
   whole; phase 15 times the captured ones), their
   peak memory, and the IGR block alone (forward and double backward)
   against its float32 bound. Then the evaluator's ``cli_main`` and the export
   CLI read the joint logdir (restore lines, a finite block with
   non-zero fitting lines, served latents).
10. Reconstruction at full width: ``python -m
   point2cyl_torch.recon.reconstruct``'s ``cli_main`` on phase 9's joint
   logdir (its backbone and implicit stack; ``--synthetic --model_id 0
   --K 8 --num_points 2048 --num_sk_point 2048 --resolution 256``): both
   load lines, 2 FPS, 1 SA1, 1 SA2 and 2 3-NN launches a reconstruction
   and no other, a non-empty mesh inside the grid's box with its
   statistics (``mesh`` line, ``data/meshutil.py``), one intermediate
   PLY per composited instance, the render scripts and the wall seconds
   of each stage. ``extract_extrusion_params`` against every
   ``*_impl="plain"`` (labels on 0.999 of points, axes, centres and
   extents within 1e-4); ``composite_volume`` at R=64 and
   ``eval_sdf_grid_2d`` on the card against the CPU (1e-5 of the largest
   magnitude); the CLI with the three post-process flags and design
   option 2 (a cut) and with ``--use_gt_3d`` at R=128 (non-empty
   meshes); ``igr_finetune`` of one instance for 200 steps (the loss
   falls, ms a step) and one step's gradients against the CPU's (phase
   5's rule); the evaluator's ``--visu --no_implicit`` on phase 5's
   checkpoint (render scripts, 8 labelled clouds); one instance
   composited at R=512 (seconds, TFLOP/s against the float32 bound, peak
   memory) and marching tetrahedra of its volume on the host.
11. Preprocessing, packs and K > 8: 15 Fusion 360 Gallery-style models
   written by ``write_fusion_models`` (joins of 1-4 extrusions on
   axis-aligned and oblique axes, a two-profile extrusion, a cut that
   splits faces, 9 and 10 instances, a tapered extrusion) through
   ``python -m point2cyl_torch.data.preprocess``'s ``cli_main`` (16,384
   points, 2,048 sketch points) at ``--K 8`` and ``--K 10`` into a train
   and a test pack each, without h5py: the kept/total lines, exactly the
   expected models rejected, every key, shape and dtype read back by
   ``load_h5``, labels in [0, n_instances), host seconds a model. Trainer
   A's CLI from the K=8 pack (N=8192, B=4, 2 epochs: finite losses, the
   checkpoint, phase 5's launches a step), the pretrainer
   (``--pretrain_im``, 1 epoch) on its sketches and the evaluator
   (``--no_implicit``) on its test split. The CUDA-event median of steps
   from the pack, and ``trace()`` around two steps (the trace names the
   hand kernels and the step's phase markers). At K=10 (heads [3, 20]): one
   step on a batch with the 9- and 10-instance models held against the
   all-plain step (phase 5's rule), ``hungarian_matching`` on the card
   equal to the CPU's and at scipy's optimum, with no host sync under
   ``torch.cuda.set_sync_debug_mode("error")``, and the ms of the
   matching and of a K=10 step beside a K=8 step.
12. The parallel package (``point2cyl_torch/parallel``). a. One rank,
   NCCL, world 1: Trainer A's CLI with ``--data_parallel 1`` (2 epochs of
   ``--synthetic 8`` at B=4, then a resume), one full-width step through
   the data-parallel path (BN and gradient all-reduces, global draws)
   bit-equal to the one-process step under deterministic algorithms
   (loss, every gradient, BN statistics; the one-process step repeated
   bit-equal first), and the point-sharded forward at P=1 (N=8192, B=4,
   heads [3, 16]; SA1 through the single-device FPS and fused ball query,
   no ring step) bit-equal to ``Backbone.forward``; the ring-step kernel
   (``csrc/fps_ring.cu``, one cluster a cloud) against its plain version
   at SA1 (B=4, N=8192: 8 CTAs) and at 131,072 points (B=1: 16 CTAs),
   512 steps from one start, the offers and
   running distances after every step and the centroids bit-equal (at SA1
   first 64 steps of the clouds with a NaN and an inf coordinate); then
   ``ShardedForward`` (the captured forward): five calls (eager, capture,
   replays) each bit-equal to ``Backbone.forward``, the kernels' wrappers
   counted in the eager call and the capture only, and one graph launch a
   replay (a trace); and the ring FPS a P > 1 forward runs
   (``point_sharding._fps_ring``: a ring-step launch and an NCCL
   all-gather a step) captured at world 1, five calls each bit-equal to
   the FPS kernel, 512 ring steps in the eager call and the capture, none
   in a replay, one graph launch a replay (a trace). b. Two ranks on this card over gloo, every
   collective staged through host memory (``torch.multiprocessing``
   spawns them; NCCL refuses two ranks on one card): Trainer A's and the
   joint trainer's step at B=4 (2 rows a rank, 2,048 sketch points)
   against the one-process card step at the JAX tests' tolerances, the BN
   statistics within 1e-5, the gradients of all parameters together
   nearer the one-process step's than the nearer of two wrong steps (the
   sum not divided by the world, one rank's rows alone) by
   ``GRAD_NEARER`` (phase 5's per-parameter rule reported beside it); the
   sharded forward at P=2 with its ring FPS, ball-query and 3-NN indices
   bit-equal to the FPS, SA1 and 3-NN kernels' and its heads within rtol
   2e-4, atol 1e-5, and ``ShardedForward`` eager over the host-staged
   mesh, saying so, bit-equal to it. c. Where there are two cards, b over
   NCCL with a card a rank (``ShardedForward`` captured), and an
   ``InferenceSession`` over two cards bit-equal to one; otherwise the
   phase says it skipped c. d. The world-1 data-parallel step beside the
   one-process step (CUDA-event medians); in turns (the host's clock),
   the captured P=1 sharded forward beside the eager one and the forward,
   the captured world-1 ring FPS at SA1 beside the eager one and the FPS
   kernel,
   with the replay's device time, busy share and host launches from a
   trace; one world-1 all-gather and all-reduce; one cloud of 131,072
   points at P=1 captured beside eager and the all-plain single-device
   forward (ms, peak GiB, heads within 1e-3); one
   cloud of 2^20 points at P=1 captured (the seconds of each call, peak
   GiB, heads within 1e-3 of the all-plain forward, its seconds). e. Each
   kernel's launches a data-parallel step per rank, a sharded forward and
   its capture; ``phase12_s``.
13. bf16 compute (``compute_dtype="bfloat16"``: the backbone's dense
   layers as bf16 products with float32 results, ``ops/lowp_dense.py``).
   a. The bf16 dense layer at each of the backbone's 19 shapes (B=4,
   N=8192), forward and both gradients, against its plain version on the
   card (the forward within float32 summation order, the gradients within
   one bf16 ulp plus the cotangent's rounding), 3 GEMMs a layer; CUDA-event
   medians of the forward and of forward plus backward beside the float32
   layer's, and the bound at the bf16 tensor-core rate. b. Trainer A in
   bf16 from ``build_trainer`` on ``--synthetic 16`` (B=4): the hand
   kernels' launches a step are the float32 step's, 56 GEMMs a step,
   every parameter with a gradient, finite losses; one step against the
   all-plain bf16 step with the float32 step on the same weights as the
   yardstick (``BF16_NEARER``); the ms a step beside float32's in turns
   and the device launches a step of each (a trace); the CLI with
   ``--compute_dtype bfloat16`` for 2 epochs, then a resume. c. A bf16
   artifact (buckets 1, 4, 16) served for requests of 1, 5 and 16 clouds:
   the launches, the raw heads against the all-plain bf16 path on the
   card and the bf16 port on the CPU (1e-3; labels on 0.999 of points).
   d. One NCCL rank: the world-1
   data-parallel bf16 step bit-equal to the one-process bf16 step under
   deterministic algorithms, and the P=1 sharded bf16 forward bit-equal
   to ``Backbone.forward``. e. One joint step with a bf16 backbone against
   the all-plain bf16 step, float32 as the yardstick.
14. Captured steps (``core/graphs.py``: Trainer A's step, each serving
   bucket and the evaluator's step as CUDA graphs, first call eager,
   then replays). The earlier phases count the wrappers' launches in the
   eager first call and the capture of each shape (a replay launches the
   captured kernels without the wrappers) and time their evaluations
   eagerly. a. Trainer A at K=8 and K=10, float32 and bf16 (B=4,
   N=8192): eleven calls (eager, capture, nine more replays) each held
   against the eager step from the same state and a generator of the
   same seed (loss 1e-5 relative, gradients by phase 5's rule, BN 1e-5,
   the generators advanced alike), then three calls of each under
   deterministic algorithms, bit-equal without resyncing (the replayed
   draws are the eager ones). b. A batch with NaN normals: the replay
   keeps every state tensor bit for bit, the next replay matches the
   eager step. c. Requests of 1, 4, 16 and 37 clouds (three chunks of
   bucket 16), with and without latents, three times each, and raw heads
   at 37, bit-equal to an eager session. d. ``evaluate`` on 14a's K=8
   weights without and with the implicit stack against its eager run
   (phase 7's and 8's tolerances). e. Trainer A's CLI, 2 epochs and a
   resume, replaying. f. In turns, captured and eager: ms a train step
   (each 14a configuration), the device's busy share and the host's
   kernel and graph launches a step (a trace), decompositions a second at
   buckets 1, 4 and 16 with and without latents, ms an eval step and
   clouds a second of ``evaluate`` over 16 batches, and capture ms (the
   train step's part after b, the buckets' after c). g. ``SetAbstractionMsg`` (npoint 512, radii 0.1/0.2/0.4, nsamples
   16/32/64, N=1024, B=4): FPS and three idx-only ball queries, eval and
   train mode against the plain versions, and its ms beside theirs.
15. Captured steps II: the joint and pretrain steps, the world-1 NCCL
   data-parallel steps and reconstruction's fine-tune step as CUDA
   graphs. a. The joint step (``train_Point2Cyl.py``'s defaults: B=4,
   N=8192, K=8, 2,048 sketch points, a carried step of 6), float32 and
   bf16, with and without ``--is_pc_train``: eleven calls each against
   the eager step from the same state (copied in place) and a generator
   of the same seed (loss 1e-5 relative, gradients by phase 9's rule, BN
   1e-5, the generators advanced alike), the hand kernels launched in the
   capture, then three calls of each under deterministic algorithms, bit
   for bit without resyncing. b. A joint batch with NaN normals: the
   replay keeps every state tensor of both Adam groups bit for bit, the
   next replay matches the eager step. c. The pretrain step at B=4 and
   at B=16 in chunks of 32, held the same way (B=4 also bit for bit
   under deterministic algorithms). d. One NCCL rank, world 1: the
   data-parallel Trainer A and joint steps captured (in ``thread_local``
   capture mode) against their eager steps and against the one-process
   captured step, then bit for bit under deterministic algorithms. e.
   The 200-step fine-tune of one instance at S=2048 captured against
   eager with generators of the same seed (the weights within 1e-4 of
   each tensor's largest entry). f. In turns, captured against eager: ms
   a step of each owner, and for the float32 joint step with
   ``--is_pc_train``, the pretrain step at B=4, the data-parallel steps
   and the fine-tune step the device's busy share and the host's kernel
   and graph launches a step (a trace), and the capture call's ms.

17. Clouds beyond 16,384 points (the FPS's cluster route,
   ``csrc/fps_cluster.cu``, up to 131,072 points and its grid route,
   ``csrc/fps_grid.cu``, above, the streamed query of
   ``csrc/ballquery.cu``, SA1's route above 11,944 points). a. The FPS
   and the streamed SA1 ball query against their plain versions, index
   for index and value for value: B=1 and 4 at N=11,945 (the first N the
   plan streams; 11,944 keeps the grid, the idx-only query streams) and
   16,384 (the band the staged scan held) through the planned routes,
   16,385, B=4 and 16 at 32,768, B=1 and 4 at 131,072,
   B=1 at 2^20, FPS at B=2 and N=131,072 and 131,073 (both routes at their
   border), B=64 at 20,000 (clusters in several waves), B=2 at 2^20 and
   B=64 and 200 at 131,073 (the grid route's points beyond its registers
   streamed), NaN and inf points at 20,000 and 131,073, start tensors on
   the card, each FPS twice in a row; clouds of 4,096 points repeated 8
   times and to 2^20 (ties across the CTAs of either route); N=32,767
   with a dense cluster, NaN and inf points, a far, a sparse-region and a
   NaN query, nsample 63 and the idx-only route (the sparse and far
   queries walk the whole row: its ms printed), a far query at 2^20 (the
   whole row, its ms); a row that is not 16-byte aligned; the cluster
   route and the query inside one captured graph and the grid route
   inside another, replayed on new clouds. b. Each new kernel timed (25
   CUDA-event runs) beside its plain version and bound at N=32,768 (B=4),
   131,072 (B=4 and 1) and 2^20 (B=1), the streamed query also at 16,384
   (B=1 and 4) and with its plan, the FPS with its plan and µs a step;
   the SA1 gather backward and the 3-NN
   backward at 32,768 (bit-equal to the host's ordered sum and a second
   run, beside ``index_add_``), the 3-NN forward at FP1 at 131,072 and
   2^20. c. Serving at N=131,072 (buckets 1 and 4): requests of 1 and 4
   clouds, eager, capture and replay each bit-equal to an eager session,
   the heads within 1e-3 of the all-plain forward, launches a request, ms
   of a 4-cloud request captured and eager. d. Trainer A at N=32,768 (B=4,
   K=8) through the CLI (2 epochs, random FPS
   starts), three captured steps bit-equal to eager ones under
   deterministic algorithms, ms a step, and a saliency backward through
   the streamed query's gather backward. e. One NCCL rank: the P=1
   ``ShardedForward`` at 2^20 points (eager, capture, replay) bit-equal to
   ``Backbone.forward`` at 2^20, with the seconds and peak GiB.

The line before the last is the kernel table as JSON (each row also
with its launches in the evaluations, ``eval_launches``, in the requests
with latents, ``serve_latents_launches``, in the joint trainer,
``joint_launches``, in one reconstruction, ``recon_launches``, over
the 4 steps trained from the K=8 pack, ``pack_launches``, and in phase
12, ``parallel_launches``, in phase 13, ``bf16_launches``, in phase 17's
paths, ``large_launches``, and inside
phases 14 and 15's replays, ``graph_launches``: the launches counted
in a graph's capture times its replays, for the K=8 train step, bucket
16, the eval step, the joint step and the world-1 data-parallel Trainer
A step). The ring-step kernel's rows (``fps_ring_step@sa1_p1`` and
``@n131072_p1``) come from phase 12a; their ``launches`` are a rank's in
12b's P=2 sharded forward (at P=1 there is no ring). Phase 17's rows
(``fps_cluster@...``, ``fps_grid@...``, ``ball_query_stream@...`` and the
backwards and 3-NN at the new N) carry the launches of phase 17's paths:
a 131,072-point request, a 2^20-point forward, a 32,768-point train step,
a saliency backward. The ``fps_step`` line also gives each FPS route's
µs a step. The last line is ``{"ok": true, "device": {...}}``.

``--recon-igr-post-process`` runs, after the set-up and alone, the
reconstruction CLI with ``--igr_post_process`` at R=256 on a joint
logdir trained as phases 5 and 9 train theirs, at the CLI's own
fine-tune budget (10,000 steps an instance at most), and prints the
seconds of each stage and the steps of each instance; a failure exits
non-zero. It is not part of the default run.

``--profile`` adds device-time breakdowns of a bucket-16 request, of
full-width train steps, of full-width eval steps without and with the
implicit stack, of joint steps and of one instance composited at
R=256.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
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
# a served replica's raw heads and latents against the unfolded modules it
# was folded from (eval BN in the weights: float32 rounding in another order)
FOLD_ATOL = 1e-4


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


def scanned_rows(idx: torch.Tensor, n: int) -> int:
    """Cloud rows a first-nsample ball query must read on this data: in each
    batch row the prefix up to the farthest index any query needs (its
    nsample-th in-radius point, or all N where a query's row is short)."""
    full = idx[..., -1] != idx[..., 0]
    reach = torch.where(full, idx[..., -1].long() + 1, n)
    return int(reach.reshape(idx.shape[0], -1).amax(dim=1).sum())


def fps_work(xyz, npoint):
    """(bytes, operations) of an FPS call: the cloud read once, the indices
    written; per point and iteration 3 sub, 3 mul, 2 add, 1 min, 1 compare."""
    b, n, _ = xyz.shape
    return xyz.numel() * 4 + b * npoint * 4, 10.0 * b * npoint * n


def group_work(xyz, new_xyz, idx, width, feats=None):
    """(bytes, operations) of a grouped ball query: the cloud's rows the
    selection needs (:func:`scanned_rows`) and the centres read once, idx
    and grouped written once; per distance test of the index-order scan (3
    sub, 3 mul, 2 add, 1 compare), and 3 subs a slot."""
    b, s, ns = idx.shape
    row_bytes = 12 + (feats.shape[-1] * 4 if feats is not None else 0)
    nbytes = scanned_rows(idx, xyz.shape[1]) * row_bytes + new_xyz.numel() * 4 \
        + idx.numel() * 4 + b * s * ns * width * 4
    return nbytes, 9.0 * scanned_points(idx, xyz.shape[1]) + 3.0 * idx.numel()


def knn_work(dst, src, feats):
    """(bytes, operations) of the 3-NN forward: per pair 8 for the distance
    and 1 compare; per output 3 mul, 2 add."""
    b, n, _ = dst.shape
    s, c = feats.shape[1], feats.shape[2]
    nbytes = (dst.numel() + src.numel() + feats.numel() + b * n * c) * 4
    return nbytes, 9.0 * b * n * s + 5.0 * b * n * c


def query_work(xyz, new_xyz, idx):
    """(bytes, operations) of the idx-only ball query: the cloud's rows the
    selection needs, the centres read once, idx written once."""
    nbytes = scanned_rows(idx, xyz.shape[1]) * 12 + (new_xyz.numel() + idx.numel()) * 4
    return nbytes, 9.0 * scanned_points(idx, xyz.shape[1])


def scatter_work(idx, dg, n):
    """(bytes, operations) of a gather's backward: idx and dg read once,
    the (B, n, W) table written once; one add per cotangent element."""
    b, w = idx.shape[0], dg.shape[-1]
    return (idx.numel() + dg.numel() + b * n * w) * 4, float(dg.numel())


def knn_bwd_work(idx, w, g, s):
    """(bytes, operations) of the 3-NN backward: 3 multiplies and 3 adds
    per cotangent element."""
    b, _, c = g.shape
    return (idx.numel() + w.numel() + g.numel() + b * s * c) * 4, 6.0 * g.numel()


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


def mesh_stats(verts: np.ndarray, faces: np.ndarray) -> dict:
    """A mesh's invariants as ``tools/mesh_stats.py`` computes them, from
    the port's ``data/meshutil.py``."""
    from point2cyl_torch.data import meshutil

    mv, mf = meshutil.merge_vertices(verts, faces)
    comps = meshutil.connected_component_labels(meshutil.face_adjacency(mf), mf.shape[0])
    tri = mv[mf]
    volume = float(np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum()
                   / 6.0)
    return {"verts": int(verts.shape[0]), "faces": int(faces.shape[0]),
            "components": int(comps.max() + 1) if mf.size else 0,
            "area": float(meshutil.face_areas(mv, mf).sum()), "signed_volume": volume}


# ---- Fusion 360 Gallery-style models for the preprocessing phase ------------

_BOX_QUADS = {  # local corner indices of each face, outward winding
    "bottom": (1, 4, 3, 2), "top": (5, 6, 7, 8), "s1": (1, 2, 6, 5),
    "s2": (2, 3, 7, 6), "s3": (3, 4, 8, 7), "s4": (4, 1, 5, 8),
}


def _unit(v) -> list[float]:
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v)).tolist()


def _box(obj: dict, center, half, axis, names: dict) -> None:
    """Append a box to an OBJ being built: half sizes ``half`` along a frame
    whose third axis is ``axis`` (the extrusion's), one group per face."""
    a = np.asarray(axis, np.float64)
    helper = np.array([1.0, 0.0, 0.0]) if abs(a[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = helper - (helper @ a) * a  # the identity frame for axis z
    u /= np.linalg.norm(u)
    frame = np.stack([u, np.cross(a, u), a], axis=1)
    (x0, y0, z0), (x1, y1, z1) = -np.asarray(half), np.asarray(half)
    local = [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
             (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)]
    base = len(obj["v"])
    obj["v"] += [np.asarray(center, np.float64) + frame @ np.asarray(p) for p in local]
    for face, (a_, b_, c_, d_) in _BOX_QUADS.items():
        a_, b_, c_, d_ = a_ + base, b_ + base, c_ + base, d_ + base
        obj["g"].append((names[face], [(a_, b_, c_), (a_, c_, d_)]))


def _box_names(prefix: str) -> dict:
    return {face: f"{prefix}_{face}" for face in _BOX_QUADS}


def _write_obj(path: str, obj: dict) -> None:
    lines = [f"v {float(p[0])!r} {float(p[1])!r} {float(p[2])!r}" for p in obj["v"]]
    for group, tris in obj["g"]:
        lines.append(f"g {group}")
        lines += [f"f {a} {b} {c}" for a, b, c in tris]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _entity(groups: list[str], body: list[str], distance: float,
            operation: str = "JoinFeatureOperation", taper: float = 0.0) -> dict:
    return {"extent_one": {"distance": {"value": distance},
                           "taper_angle": {"value": taper}},
            "operation": operation, "extrude_faces": groups,
            "bodies": {"b1": {"faces": list(body)}}}


def _write_model(root: str, mid: str, steps: list[tuple[dict, dict, tuple]]) -> None:
    """One model: each step an OBJ of the body after it, its entity and
    its sketch plane's normal; the JSON sequence, entities and sketches in
    the Fusion 360 Gallery layout that ``data/preprocess.py`` parses."""
    doc = {"sequence": [], "timeline": [], "entities": {}}
    for i, (obj, entity, axis) in enumerate(steps):
        obj_name = f"{mid}_{i}.obj"
        _write_obj(os.path.join(root, obj_name), obj)
        doc["entities"][f"e{i}"] = dict(entity, profiles=[{"sketch": f"sk{i}"}])
        doc["entities"][f"sk{i}"] = {"reference_plane": {"plane": {"normal": dict(
            zip("xyz", axis))}}}
        doc["sequence"].append({"obj": obj_name, "type": "ExtrudeFeature",
                                "entity": f"e{i}"})
    with open(os.path.join(root, mid + ".json"), "w") as f:
        json.dump(doc, f)


def _joined_boxes(root: str, mid: str, axes: list, taper: float = 0.0,
                  loops: int = 1) -> None:
    """One extrusion a box (``loops`` disjoint boxes for a multi-loop
    profile) along each axis, on a grid far enough apart to be disjoint;
    each step's OBJ is the union so far."""
    obj = {"v": [], "g": []}
    body, steps = [], []
    rng = np.random.default_rng(len(mid) * 1000 + sum(map(ord, mid)))
    for i, axis in enumerate(axes):
        groups = []
        half = rng.uniform(0.3, 0.9, 3)
        for loop in range(loops):
            cell = i * loops + loop
            names = _box_names(f"e{i}l{loop}")
            _box(obj, (4.0 * (cell % 4), 4.0 * (cell // 4), 0.5 * i), half, axis, names)
            groups += list(names.values())
        body += groups
        steps.append(({"v": list(obj["v"]), "g": list(obj["g"])},
                      _entity(groups, body, 2.0 * half[2],
                              "NewBodyFeatureOperation" if i == 0
                              else "JoinFeatureOperation", taper), axis))
    _write_model(root, mid, steps)


def _slot_cut(root: str, mid: str) -> None:
    """A box along z, then a cut through its middle: the cut splits the
    box's top, bottom and two side faces, whose far halves belong to no
    extrusion (split faces, found on the first step's surface), and leaves
    two lumps, so both the box's and the cut's barrels are two loops."""
    first = {"v": [], "g": []}
    names = _box_names("g0")
    _box(first, (1.0, 0.5, 0.5), (1.0, 0.5, 0.5), (0, 0, 1), names)
    lumps = {"v": [], "g": []}
    _box(lumps, (0.45, 0.5, 0.5), (0.45, 0.5, 0.5), (0, 0, 1),
         dict(names, s2="cut_w1"))
    _box(lumps, (1.55, 0.5, 0.5), (0.45, 0.5, 0.5), (0, 0, 1),
         {"bottom": "sp_bottom", "top": "sp_top", "s1": "sp_s1", "s2": "g0_s2",
          "s3": "sp_s3", "s4": "cut_w2"})
    body = [g for g, _ in lumps["g"]]
    _write_model(root, mid, [
        (first, _entity(list(names.values()), list(names.values()), 1.0,
                        "NewBodyFeatureOperation"), (0, 0, 1)),
        (lumps, _entity(["cut_w1", "cut_w2"], body, 1.0, "CutFeatureOperation"),
         (0, 0, 1)),
    ])


def write_fusion_models(root: str) -> dict[str, int | None]:
    """Write Fusion 360 Gallery-style models (OBJ per step plus JSON) under
    ``root``; returns each id's instance count after preprocessing, None
    for a model every ``--K`` rejects. Axis-aligned and oblique joins of
    1-4 extrusions, a two-profile extrusion, a cut that splits faces, 9
    and 10 instances, and a tapered extrusion."""
    diag = [_unit(v) for v in ((1, 1, 0), (1, 0, 1), (1, 1, 1), (0, 1, 1),
                               (1, -2, 0.5), (2, 1, -1))]
    x, y, z = (1, 0, 0), (0, 1, 0), (0, 0, 1)
    joins = {
        "m00": [z], "m01": [z, x], "m02": [x, y, diag[0]], "m03": [z, y, diag[1], diag[2]],
        "m06": [diag[3], y], "m07": [diag[4], z, x],
        "m08": [z, x, y, diag[0], diag[1], diag[2], diag[3], diag[4], diag[5]],
        "m09": [z, x, y, diag[0], diag[1], diag[2], diag[3], diag[4], diag[5], z],
        "m11": [y, z, x], "m12": [diag[5]], "m13": [z, z], "m14": [x, diag[1], y, diag[3]],
    }
    for mid, axes in joins.items():
        _joined_boxes(root, mid, axes)
    _joined_boxes(root, "m04", [z], loops=2)
    _slot_cut(root, "m05")
    _joined_boxes(root, "m10", [z, x], taper=0.1)
    expected = {mid: len(axes) for mid, axes in joins.items()}
    expected.update(m04=2, m05=4, m10=None)
    return dict(sorted(expected.items()))


def step_against_plain(trainer, tcfg, dev: torch.device, batch: dict) -> dict:
    """One train step of ``trainer`` held against the same step (weights,
    batch, generator) with every ``*_impl="plain"``: the loss, every
    gradient and the BN statistics; returns the errors."""
    from point2cyl_torch.models.backbone import Backbone
    from point2cyl_torch.train import steps

    plain_train_cfg = dataclasses.replace(trainer.model.cfg, fps_impl="plain",
                                          ballquery_impl="plain", knn_impl="plain")
    plain_trainer = steps.Trainer(Backbone(plain_train_cfg).to(dev), tcfg)
    plain_trainer.load_state_dict(trainer.state_dict())
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
    return {"loss_abs_err": loss_err, "grad_err_over_tolerance": grad_err,
            "largest_grad": top, "bn_max_abs_err": bn_err}


def preprocessing_phase(card: str, dev: torch.device, counters: dict, per_step: dict,
                        work: str, pack_points: int = 16384, num_point: int = 8192,
                        sketch_points: int = SK) -> dict:
    """Phase 11: preprocessing at full width into packs written without
    h5py, Trainer A, the pretrainer and the evaluator from them, a K=10
    step and matching, and the profiling utilities. Returns the kernels'
    launches over the pack-trained CLI's steps."""
    import contextlib
    import importlib.util
    import io

    from scipy.optimize import linear_sum_assignment

    from point2cyl_torch.core.config import TrainConfig
    from point2cyl_torch.core.profiling import MARK_PREFIX, trace
    from point2cyl_torch.data import preprocess
    from point2cyl_torch.data.h5_io import load_h5
    from point2cyl_torch.eval import evaluator
    from point2cyl_torch.ops.matching import hungarian_matching, relaxed_iou_cost
    from point2cyl_torch.train import steps, train_joint, train_pc

    t_phase = time.perf_counter()
    had_h5py = importlib.util.find_spec("h5py") is not None
    raw = os.path.join(work, "fusion")
    os.makedirs(raw)
    expected = write_fusion_models(raw)
    train_ids, test_ids = list(expected)[:11], list(expected)[11:]

    # 1. the CLI at its defaults (16,384 points, 2,048 sketch points) at
    # --K 8 and 10, a train and a test pack each
    packs, pre_s = {}, {}
    for k in (8, 10):
        packs[k] = os.path.join(work, f"pack_k{k}")
        os.makedirs(packs[k])
        t0 = time.perf_counter()
        for split, ids in (("train", train_ids), ("test", test_ids)):
            out = os.path.join(packs[k], f"{split}.h5")
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                kept = preprocess.cli_main(["--raw_dir", raw, "--out", out,
                                            "--num_points", str(pack_points),
                                            "--num_sk_point", str(sketch_points),
                                            "--K", str(k), "--model_ids", *ids])
            print(text.getvalue(), end="", flush=True)
            want = [m for m in ids if expected[m] is not None and expected[m] <= k]
            check(kept == want, f"K={k} {split}: kept {kept}, expected {want}")
            check(text.getvalue().splitlines()[-1]
                  == f"Preprocessed {len(want)}/{len(ids)} models -> {out}",
                  f"K={k} {split}: {text.getvalue()!r}")
            ds = load_h5(out)
            m = len(want)
            r = pack_points
            shapes = {"point_cloud": ((m, r, 3), np.float32),
                      "normals": ((m, r, 3), np.float32),
                      "extrusion_labels": ((m, r), np.int32),
                      "base_barrel_labels": ((m, r), np.int32),
                      "n_instances": ((m,), np.int32),
                      "extrusion_axes": ((m, k, 3), np.float32),
                      "extrusion_distances": ((m, k), np.float32),
                      "extrusion_operation": ((m, r), np.int32),
                      "extrusion_centers": ((m, k, 3), np.float32),
                      "extrusion_extents": ((m, k, 2), np.float32),
                      "sketches": ((m, k, sketch_points, 4), np.float32),
                      "sketches_norms": ((m, k), np.float32)}
            for key, (shape, dtype) in shapes.items():
                val = getattr(ds, key)
                check(val is not None and val.shape == shape and val.dtype == dtype,
                      f"K={k} {split} {key}: {None if val is None else (val.shape, val.dtype)}")
                check(np.isfinite(val).all(), f"K={k} {split} {key} is not finite")
            check(ds.n_instances.tolist() == [expected[i] for i in want],
                  f"K={k} {split}: instances {ds.n_instances.tolist()}")
            labels = ds.extrusion_labels
            check(bool((labels >= 0).all() and (labels < ds.n_instances[:, None]).all()),
                  f"K={k} {split}: a label outside [0, n_instances)")
        pre_s[k] = (time.perf_counter() - t0) / len(expected)
    check("h5py" not in sys.modules, "h5py was imported")
    print(json.dumps({"preprocess": f"{pack_points} points, {sketch_points} sketch points",
                      "models": len(expected), "host_s_per_model": pre_s,
                      "h5py": "present, not used" if had_h5py else "absent",
                      "card": card}), flush=True)

    # 2. Trainer A through its CLI from the K=8 pack: 2 epochs of 8 models
    # at B=4, launches per step as in phase 5
    pc_dir = os.path.join(work, "pack_trainer")
    flags = ["--pred_seg", "--pred_normal", "--pred_bb", "--pred_extrusion",
             "--pred_center"]
    for fn in counters.values():
        fn.launches = 0
    trained = train_pc.cli_main(["--data_dir", packs[8], "--num_point", str(num_point),
                                 "--K", "8",
                                 "--batch_size", str(TB), "--num_epochs", "2",
                                 "--logdir", pc_dir, *flags])
    torch.cuda.synchronize()
    pack_launches = {name: fn.launches for name, fn in counters.items()}
    check(trained.step == 4, f"2 epochs of 8 models at B=4 took {trained.step} steps")
    for name, count in pack_launches.items():
        check(count == per_step[name] * wrapper_calls(trained.graphs),
              f"pack: {name} launched {count} times over {trained.step} steps, "
              f"{wrapper_calls(trained.graphs)} of them eager or captured")
    pc_losses = logged_losses(pc_dir)
    check(pc_losses and all(np.isfinite(pc_losses)), f"pack losses {pc_losses}")
    check(os.path.exists(os.path.join(pc_dir, "model.pth")), "no checkpoint written")
    print(json.dumps({"train": "Trainer A CLI, K=8 pack", "steps": int(trained.step),
                      "launches": pack_launches, "loss": pc_losses}), flush=True)

    # the pretrainer on the same pack's sketches (no backbone kernel) and the
    # evaluator on its test split with the trained checkpoint
    igr_dir = os.path.join(work, "pack_igr")
    for fn in counters.values():
        fn.launches = 0
    pre = train_joint.cli_main(["--pretrain_im", "--data_dir", packs[8], "--K", "8",
                                "--batch_size", str(TB), "--num_sk_point", str(sketch_points),
                                "--num_point", str(num_point), "--num_epochs", "1",
                                "--logdir", igr_dir])
    torch.cuda.synchronize()
    check(not any(fn.launches for fn in counters.values()), "pretraining launched a kernel")
    pre_losses = logged_losses(igr_dir)
    check(pre.step == 2 and pre_losses and all(np.isfinite(pre_losses)),
          f"pretrain: {pre.step} steps, losses {pre_losses}")
    means = evaluator.cli_main(["--data_dir", packs[8], "--data_split", "test",
                                "--num_point", str(num_point), "--K", "8", "--batch_size",
                                str(TB), "--no_implicit", "--logdir", pc_dir])
    with open(os.path.join(pc_dir, "log_evaluate.txt")) as f:
        first = f.readline().strip()
    check(first == f"Restored backbone from {pc_dir}/model", f"eval restore: {first!r}")
    check(all(np.isfinite(v) for v in means.values()), f"pack eval means {means}")
    print(json.dumps({"pretrain": "K=8 pack", "steps": int(pre.step), "loss": pre_losses}),
          flush=True)
    print(json.dumps({"eval": "K=8 pack, test split", **means}), flush=True)

    # 3. steps from the K=8 pack: their CUDA-event median, and a trace of
    # two steps
    tcfg = TrainConfig(batch_size=TB, pred_seg=True, pred_normal=True, pred_bb=True,
                       pred_extrusion=True, pred_center=True, seed=0)
    trainer8 = train_pc.build_trainer(tcfg, num_point, 8, dev)
    pipe8 = train_pc.build_pipeline(tcfg, num_point, 8, dev,
                                    h5_path=os.path.join(packs[8], "train.h5"))
    k8_ms = []
    for epoch in range(1, 6):
        gen = train_pc.epoch_generator(0, epoch, dev)
        for batch in pipe8.epochs(TB, gen):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            trainer8.train_step(batch, gen)
            end.record()
            end.synchronize()
            k8_ms.append(start.elapsed_time(end))
    k8_ms = k8_ms[2:]
    trace_dir = os.path.join(work, "trace")
    gen = train_pc.epoch_generator(0, 9, dev)
    batches = pipe8.epochs(TB, gen)
    with trace(trace_dir):
        for _ in range(2):
            trainer8.train_step(next(batches), gen)
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"trace files {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        text = f.read()
    names = ("fps_kernel", "ball_query_grid_kernel", "sa_group_kernel", "knn3_kernel",
             "target_sum_kernel") + tuple(MARK_PREFIX + phase for phase in (
                 "train_forward", "train_loss", "train_backward", "train_update", "end"))
    check(all(name in text for name in names),
          f"the trace lacks {[n for n in names if n not in text]}")
    print(json.dumps({"profiling": "K=8 pack steps",
                      "cuda_event_steps_per_s": 1e3 / statistics.median(k8_ms),
                      "trace_mb": len(text) / 1e6, "trace_kernels": list(names),
                      "card": card}), flush=True)
    del trainer8, pipe8

    # 4. K=10 from the K=10 pack (heads [3, 20]): a batch of the 9- and
    # 10-instance models and two others, one step against all-plain
    trainer10 = train_pc.build_trainer(tcfg, num_point, 10, dev)
    pipe10 = train_pc.build_pipeline(tcfg, num_point, 10, dev,
                                     h5_path=os.path.join(packs[10], "train.h5"))
    rows = torch.tensor([8, 9, 0, 5], device=dev)
    batch = pipe10.batch(rows, train_pc.epoch_generator(0, 97, dev))
    check(int(batch["extrusion_labels"].max()) + 1 == 10, "the K=10 batch has no 10 instances")
    print(json.dumps({"check": "K=10 train step vs plain",
                      **step_against_plain(trainer10, tcfg, dev, batch)}), flush=True)

    # hungarian_matching at K=10 on the card: the CPU's columns, scipy's
    # optimum over each sample's instances, no host sync
    trainer10.model.eval()
    with torch.no_grad():
        heads = steps.assemble_heads(*trainer10.model(batch["point_cloud"]), True, True, k=10)
    w, labels = heads.w.contiguous(), batch["extrusion_labels"]
    got, mask = hungarian_matching(w, labels)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hungarian_matching(w, labels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, _ = hungarian_matching(w.cpu(), labels.cpu())
    check(torch.equal(got.cpu(), want), f"K=10 matching card {got.tolist()} vs CPU "
          f"{want.tolist()}")
    cost = relaxed_iou_cost(w, labels).double().cpu().numpy()
    gaps = []
    for c, cols, valid in zip(cost, got.cpu().numpy(), mask.cpu().numpy()):
        n = int(valid.sum())
        r, cc = linear_sum_assignment(c[:n], maximize=True)
        gaps.append(float(c[r, cc].sum() - c[np.arange(n), cols[:n]].sum()))
    check(max(gaps) <= 1e-5, f"K=10 matching short of scipy's optimum by {gaps}")
    match_ms = time_ms(lambda: hungarian_matching(w, labels))
    trainer10.model.train()
    k10_ms = []
    for epoch in range(1, 6):
        gen = train_pc.epoch_generator(0, epoch, dev)
        for batch in pipe10.epochs(TB, gen):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            trainer10.train_step(batch, gen)
            end.record()
            end.synchronize()
            k10_ms.append(start.elapsed_time(end))
    print(json.dumps({"rate": "K=10 matching and step", "matching_ms": match_ms,
                      "matching_gap_to_scipy": max(gaps),
                      "k10_ms_per_step": statistics.median(k10_ms[2:]),
                      "k8_ms_per_step": statistics.median(k8_ms), "batch": TB,
                      "num_points": num_point, "card": card}), flush=True)
    print(json.dumps({"phase11_s": time.perf_counter() - t_phase}), flush=True)
    return pack_launches


def reconstruction_phase(args, card: str, dev: torch.device, counters: dict,
                         per_forward: dict, work: str, pc_logdir: str,
                         joint_dir: str) -> dict:
    """Phase 10: reconstruction at full width on phase 9's joint logdir.
    Returns the kernels' launches in the main reconstruction."""
    import contextlib
    import copy
    import io

    from point2cyl_torch.core.config import BackboneConfig
    from point2cyl_torch.data.synthetic import generate_dataset
    from point2cyl_torch.eval import evaluator
    from point2cyl_torch.losses.igr import igr_losses
    from point2cyl_torch.models.backbone import Backbone
    from point2cyl_torch.models.implicit import ImplicitNet, PointNetEncoder
    from point2cyl_torch.recon import isosurface, plots
    from point2cyl_torch.recon import reconstruct as recon
    from point2cyl_torch.recon.ply import read_ply

    t_phase = time.perf_counter()
    n10, sk10, res10 = 2048, SK, 256
    joint_im = torch.load(os.path.join(joint_dir, "im_model.pth"), map_location="cpu",
                          weights_only=True)

    def run(name: str, flags: list[str], resolution: int):
        out_dir = os.path.join(work, f"recon_{name}")
        argv = ["--logdir", joint_dir, "--synthetic", "--K", str(K), "--num_points",
                str(n10), "--num_sk_point", str(sk10), "--resolution", str(resolution),
                "--output_dir", os.path.join(out_dir, "out"),
                "--dump_dir", os.path.join(out_dir, "dump"), *flags]
        text = io.StringIO()
        for fn in counters.values():
            fn.launches = 0
        with contextlib.redirect_stdout(text):
            res = recon.cli_main(argv)
        torch.cuda.synchronize()
        launched = {key: fn.launches for key, fn in counters.items()}
        print(text.getvalue(), end="", flush=True)
        lines = text.getvalue().splitlines()
        check(lines[:2] == ["Model loaded.",
                            f"Pre-trained fixed implicit model loaded ({joint_dir})."],
              f"{name}: load lines {lines[:2]}")
        check(res["faces"] > 0, f"{name}: empty mesh")
        return res, launched, out_dir

    # 1. the CLI on phase 9's joint logdir (its backbone and implicit stack)
    res, launched, out_dir = run("main", ["--model_id", "0"], res10)
    for name, count in launched.items():
        check(count == per_forward[name], f"reconstruction: {name} launched {count} "
              f"times, expected {per_forward[name]}")
    verts, faces = read_ply(res["out_ply"])
    box = 2.0 * (res10 - 1) / res10
    check(len(faces) == res["faces"] and bool(np.isfinite(verts).all())
          and verts.min() >= 0.0 and verts.max() <= box,
          f"reconstruction mesh: {len(faces)} faces in [{verts.min()}, {verts.max()}]")
    inter = os.listdir(os.path.join(out_dir, "out", "intermediate_volumes"))
    check(res["intermediates"] >= 1 and len(inter) == res["intermediates"],
          f"{len(inter)} intermediate PLYs for {res['intermediates']} instances")
    dump = os.listdir(os.path.join(out_dir, "dump"))
    check({"render.sh", "image_files.sh", "0_pred.pts", "0_gt.pts"} <= set(dump),
          f"render scripts: {dump}")
    print(json.dumps({"mesh": "reconstruction, model 0, R=256", **mesh_stats(verts, faces),
                      "instances": res["intermediates"]}), flush=True)
    print(json.dumps({"recon": "CLI, full width", "resolution": res10, "launches": launched,
                      "wall_s": res["timings"], "card": card}), flush=True)

    # 2. the kernel path against the all-plain path: the same weights and
    # points, the deterministic draw
    ds = generate_dataset(1, resolution=8192, max_instances=K, num_sketch_points=sk10, seed=0)
    sel = np.random.default_rng(0).permutation(8192)[:n10]
    pts = torch.from_numpy(np.ascontiguousarray(ds.point_cloud[0][sel][None])).to(dev)
    gt = torch.from_numpy(ds.extrusion_labels[0][sel][None].astype(np.int64)).to(dev)
    bcfg = BackboneConfig(num_points=n10, output_sizes=(3, 2 * K), approx_neighbors=False)
    pc_state = torch.load(os.path.join(joint_dir, "pc_model.pth"), map_location="cpu",
                          weights_only=True)["model"]
    models = {}
    for route, c in (("kernel", bcfg), ("plain", dataclasses.replace(
            bcfg, fps_impl="plain", ballquery_impl="plain", knn_impl="plain"))):
        models[route] = Backbone(c)
        models[route].load_state_dict(pc_state, strict=True)
        models[route].to(dev).eval()
    got = recon.extract_extrusion_params(models["kernel"], pts, gt, K)
    want = recon.extract_extrusion_params(models["plain"], pts, gt, K)
    agree = float((got["label"] == want["label"]).float().mean())
    check(agree >= 0.999, f"extraction labels agree on {agree} of points")
    same = [k for k in range(K) if bool(((got["label"] == k) == (want["label"] == k)).all())]
    err = {key: float((got[key][0, same] - want[key][0, same]).abs().max())
           for key in ("axes", "centers", "extents")}
    for key, e in err.items():
        check(e <= 1e-4, f"extraction {key}: kernel vs plain {e}")
    print(json.dumps({"check": "recon extraction vs plain", "label_agreement": agree,
                      "instances_compared": len(same), "max_abs_err": err,
                      "atol": 1e-4}), flush=True)

    # 3. the card against the CPU: the volume at R=64 from the same
    # parameters and latents (up to three instances deep enough to
    # composite), and one latent's 2D grid
    encoder = PointNetEncoder(256, 2, with_normals=True)
    encoder.load_state_dict(joint_im["pn_encoder"], strict=True)
    encoder.to(dev).eval()
    latents, scales, p2d_n, n2d, _ = recon.extract_sketch_latents(
        encoder, None, pts, got["normals"], got["label"], got["pred_bb"], got["axes"],
        got["centers"], sk10)
    decoder = ImplicitNet(d_in=258)
    decoder.load_state_dict(joint_im["implicit_net"], strict=True)
    decoder.eval()
    decoder_dev = copy.deepcopy(decoder).to(dev)
    ops, perm = recon.DESIGN_OPTIONS[1]
    sc, ext = scales[0].cpu().numpy(), got["extents"][0].cpu().numpy()
    deep = [k for k in range(int(ds.n_instances[0])) if abs(ext[k, 0] - ext[k, 1]) >= 0.01][:3]
    check(len(deep) > 0, f"no instance to composite: extents {ext.tolist()}")
    sel_k = torch.tensor(deep, device=dev)
    args64 = (latents[0, sel_k], got["axes"][0, sel_k], got["centers"][0, sel_k])
    vol_card, inter_card = recon.composite_volume(
        [decoder_dev] * len(deep), *args64, sc[deep], ext[deep], ops, perm, len(deep),
        resolution=64)
    vol_cpu, inter_cpu = recon.composite_volume(
        [decoder] * len(deep), *(t.cpu() for t in args64), sc[deep], ext[deep], ops, perm,
        len(deep), resolution=64)
    top = float(np.abs(vol_cpu).max())
    vol_err = float(np.abs(vol_card - vol_cpu).max())
    check(len(inter_card) == len(inter_cpu) and vol_err <= 1e-5 * top,
          f"volume card vs CPU: {vol_err} of {top}, {len(inter_card)} instances")
    grid_card = plots.eval_sdf_grid_2d(decoder_dev, latents[0, 0], 128)
    grid_cpu = plots.eval_sdf_grid_2d(decoder, latents[0, 0].cpu(), 128)
    grid_err = float(np.abs(grid_card - grid_cpu).max())
    check(grid_err <= 1e-5, f"2D grid card vs CPU: {grid_err}")
    print(json.dumps({"check": "volume card vs CPU, R=64", "max_abs_err": vol_err,
                      "largest": top, "instances": len(inter_card),
                      "grid_max_abs_err": grid_err}), flush=True)

    # 4. post-processing with a cut (model 3 has 3 instances), and GT params
    for name, flags in (("postprocess", ["--seg_post_process", "--scale_post_process",
                                         "--extent_post_process", "--design_option", "2",
                                         "--model_id", "3"]),
                        ("gt_3d", ["--use_gt_3d", "--model_id", "0"])):
        res_o, _, _ = run(name, flags, 128)
        print(json.dumps({"recon": name, "faces": res_o["faces"],
                          "instances": res_o["intermediates"],
                          "wall_s": sum(res_o["timings"].values())}), flush=True)

    # 5. IGR fine-tune of one instance: 200 steps on the card, the loss on
    # fixed off-surface points before and after, ms per step; one step's
    # gradients against the CPU port's from the same weights and points
    j = int(torch.argmax(scales[0] * (scales[0] != 1.0)))
    # clones: autograd cannot save the inference tensors they come from
    lat, sk_p, sk_n = (t.clone() for t in (latents[0, j], p2d_n[0, j], n2d[0, j]))
    off = torch.randn(1, sk10 + sk10 // 8, 2, generator=torch.Generator().manual_seed(5))
    mask = torch.ones(1, 1, dtype=torch.bool)

    def igr(decoder, device):
        return igr_losses(decoder, None, sk_p.to(device)[None, None],
                          sk_n.to(device)[None, None], lat.to(device)[None, None],
                          mask.to(device), off_pts=off.to(device)).total

    loss_start = float(igr(decoder_dev, dev).detach())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tuned, steps = recon.igr_finetune(decoder_dev, lat, sk_p, sk_n,
                                      torch.Generator(dev).manual_seed(1), max_steps=200)
    torch.cuda.synchronize()
    ft_ms = (time.perf_counter() - t0) / steps * 1e3
    loss_end = float(igr(tuned, dev).detach())
    check(np.isfinite(loss_end) and loss_end < loss_start,
          f"fine-tune loss {loss_start} -> {loss_end}")
    grads = {}
    for device, net in ((dev, decoder_dev), ("cpu", decoder)):
        net.zero_grad(set_to_none=True)
        igr(net, device).backward()
        grads[str(device)] = {n: p.grad.cpu() for n, p in net.named_parameters()}
    top_g = max(float(g.abs().max()) for g in grads["cpu"].values())
    grad_ratio = 0.0
    for name, want_g in grads["cpu"].items():
        e = float((grads[str(dev)][name] - want_g).abs().max())
        tol = 1e-3 * float(want_g.abs().max()) + 1e-4 * top_g
        check(e <= tol, f"fine-tune gradient of {name}: {e}, tolerance {tol}")
        grad_ratio = max(grad_ratio, e / tol)
    print(json.dumps({"recon": "IGR fine-tune, one instance", "steps": steps,
                      "loss": [loss_start, loss_end], "ms_per_step": ft_ms,
                      "grad_err_over_tolerance": grad_ratio, "card": card}), flush=True)

    # 6. the evaluator's --visu on phase 5's checkpoint
    visu_dir = os.path.join(work, "visu")
    evaluator.cli_main(["--synthetic", "8", "--num_point", "8192", "--K", str(K),
                        "--batch_size", str(TB), "--logdir", pc_logdir, "--no_implicit",
                        "--visu", "--dump_dir", visu_dir])
    visu = os.listdir(visu_dir)
    clouds_written = [f for f in visu if f.endswith("_pred.pts")]
    check({"render.sh", "image_files.sh"} <= set(visu) and len(clouds_written) == 8,
          f"--visu wrote {sorted(visu)}")
    print(json.dumps({"eval": "--visu --no_implicit", "labelled_clouds": len(clouds_written)}),
          flush=True)

    # 7. one instance composited at R=512 (the CLI's default) against its
    # float32 bound, its peak memory, and marching tetrahedra of its volume
    macs = sum(m.in_features * m.out_features for m in decoder_dev.modules()
               if isinstance(m, torch.nn.Linear))
    one = dict(decoders=[decoder_dev], latents=latents[0, j:j + 1], axes=got["axes"][0, j:j + 1],
               centers=got["centers"][0, j:j + 1], scales=sc[j:j + 1],
               extents=np.array([[-0.3, 0.3]], np.float32), ops=ops, perm=perm,
               n_instances=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vol512, _ = recon.composite_volume(**one, resolution=512)
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    flop = 2.0 * macs * 512**3
    t0 = time.perf_counter()
    v512, f512 = isosurface.marching_tetrahedra(vol512, 0.0, spacing=(2 / 512,) * 3)
    mt_s = time.perf_counter() - t0
    check(len(f512) > 0 and bool(np.isfinite(vol512).all()), "the R=512 volume has no surface")
    print(json.dumps({"recon": "one instance, R=512", "points": 512**3, "macs_per_point": macs,
                      "flop": flop, "composite_s": comp_s, "tflop_per_s": flop / comp_s / 1e12,
                      "bound_s": flop / FP32_OPS_PER_S, "peak_gib": peak,
                      "marching_tetrahedra_s": mt_s, "faces": len(f512), "card": card}),
          flush=True)
    del vol512, v512, f512
    if args.profile:
        composite256 = lambda: recon.composite_volume(**one, resolution=256)  # noqa: E731
        t0 = time.perf_counter()
        composite256()
        profile_steps("composite one instance, R=256", composite256, card,
                      (time.perf_counter() - t0) * 1e3)
    print(json.dumps({"phase10_s": time.perf_counter() - t_phase}), flush=True)
    return launched


# ---- opt-in: reconstruction with the IGR post-process ------------------------


def igr_post_process_run(card: str, dev: torch.device, root: str) -> dict:
    """``--recon-igr-post-process``: a joint logdir trained as phases 5 and
    9 train theirs (Trainer A's CLI, 2 epochs of ``--synthetic 8`` at B=4
    and a resume to 3; 2 epochs of ``--pretrain_im``; 2 joint epochs from
    both), then the reconstruction CLI on it at R=256 with
    ``--igr_post_process`` at the CLI's own fine-tune budget (10,000 steps
    an instance at most, ended early by its plateau check). Prints the
    wall seconds by stage and the steps each instance took."""
    import contextlib
    import io

    from point2cyl_torch.recon import reconstruct as recon
    from point2cyl_torch.train import train_joint, train_pc

    t_run = time.perf_counter()
    pc_dir, igr_dir, joint_dir = (os.path.join(root, d) for d in ("pc", "igr", "joint"))
    heads = ["--pred_seg", "--pred_normal", "--pred_bb", "--pred_extrusion", "--pred_center"]
    argv = ["--synthetic", "8", "--num_point", "8192", "--K", str(K), "--batch_size",
            str(TB), "--logdir", pc_dir, *heads]
    train_pc.cli_main(argv + ["--num_epochs", "2"])
    check(int(train_pc.cli_main(argv + ["--num_epochs", "3", "--resume"]).step) == 6,
          "Trainer A's CLI did not reach step 6")
    sk_argv = ["--synthetic", "8", "--K", str(K), "--batch_size", str(TB), "--num_sk_point",
               str(SK), "--num_point", "8192", "--num_epochs", "2"]
    train_joint.cli_main(sk_argv + ["--pretrain_im", "--logdir", igr_dir])
    joint = train_joint.cli_main(sk_argv + [
        "--logdir", joint_dir, "--is_pc_init", "--pc_logdir", pc_dir, "--is_im_init",
        "--im_logdir", igr_dir, "--is_pc_train", "--is_im_train", "--with_im_loss",
        "--init_global_step", "-1", *heads])
    check(int(joint.step) == 10, f"the joint run ended at step {int(joint.step)}")
    train_s = time.perf_counter() - t_run
    text = io.StringIO()
    out_dir = os.path.join(root, "recon_igr")
    with contextlib.redirect_stdout(text):
        res = recon.cli_main(["--logdir", joint_dir, "--synthetic", "--K", str(K),
                              "--num_points", "2048", "--num_sk_point", str(SK),
                              "--resolution", "256", "--model_id", "0", "--igr_post_process",
                              "--output_dir", os.path.join(out_dir, "out"),
                              "--dump_dir", os.path.join(out_dir, "dump")])
    print(text.getvalue(), end="", flush=True)
    lines = text.getvalue().splitlines()
    tuned = [line for line in lines if line.startswith("IGR fine-tuned instance")]
    steps = res["finetune_steps"]
    check(lines[:2] == ["Model loaded.",
                        f"Pre-trained fixed implicit model loaded ({joint_dir})."],
          f"reconstruction with the post-process: load lines {lines[:2]}")
    # every instance of the model is tuned; the volumes composited are
    # those of the instances the design option keeps
    check(len(steps) == len(tuned) >= res["intermediates"] >= 1
          and all(1 <= n <= 10_000 for n in steps) and "igr_finetune" in res["timings"],
          f"the post-process tuned {steps} ({len(tuned)} lines) for "
          f"{res['intermediates']} composited instances")
    check(res["faces"] > 0, "the post-processed reconstruction's mesh is empty")
    report = {"recon": "CLI with --igr_post_process, R=256", "resolution": 256,
              "finetune_steps": steps, "wall_s": res["timings"], "faces": res["faces"],
              "composited_instances": res["intermediates"], "training_s": train_s,
              "card": card}
    print(json.dumps(report), flush=True)
    return report


# ---- phase 12: the parallel package ----------------------------------------


def kernel_counters() -> dict:
    """Each hand kernel's launch counter, by name."""
    from point2cyl_torch.ops import cuda_ballquery, cuda_fps, cuda_knn

    return {
        "fps": cuda_fps.farthest_point_sample_kernel,
        "ball_query": cuda_ballquery.ball_query_kernel,
        "ball_query_grouped": cuda_ballquery.ball_query_grouped_kernel,
        "ball_query_grouped_backward": cuda_ballquery.ball_query_grouped_backward_kernel,
        "sa_grouped_exact": cuda_ballquery.sa_grouped_exact_kernel,
        "sa_grouped_backward": cuda_ballquery.sa_grouped_backward_kernel,
        "three_nn": cuda_knn.three_nn_interpolate_kernel,
        "three_nn_backward": cuda_knn.three_nn_backward_kernel,
        "fps_ring_step": cuda_fps.fps_ring_step_kernel,
        "fps_cluster": cuda_fps.farthest_point_sample_cluster_kernel,
        "fps_grid": cuda_fps.farthest_point_sample_grid_kernel,
        "ball_query_stream": cuda_ballquery.ball_query_stream_kernel,
    }


def counted(fn):
    """``fn()`` and the kernel launches it made (counts set to 0 before,
    read after a synchronise)."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: c.launches for name, c in counters.items()}


# the sharded forward's launches at P > 1: SA1 runs on the ring (a ring-step
# kernel a step, the rest plain PyTorch), SA2 and the feature propagations
# through the model's kernels
PER_SHARDED_FORWARD = {"fps": 1, "ball_query": 0, "ball_query_grouped": 0,
                       "ball_query_grouped_backward": 0, "sa_grouped_exact": 1,
                       "sa_grouped_backward": 0, "three_nn": 2, "three_nn_backward": 0,
                       "fps_ring_step": 512, "fps_cluster": 0, "fps_grid": 0,
                       "ball_query_stream": 0}
# at P=1 (N=8192) SA1 takes the single-device FPS and fused ball query: no
# ring step, no all-gather for its FPS
PER_SHARDED_FORWARD_P1 = {**PER_SHARDED_FORWARD, "fps": 2, "ball_query_grouped": 1,
                          "fps_ring_step": 0}
# JAX test tolerances of the data-parallel steps (tests/test_parallel.py)
DP_TOL = {"extrusion": 6e-3, "total": 6e-3}
JOINT_AXIS_PATH = ("manifold", "eikonal", "sald", "latent", "im_total", "total")


def step_record(modules, aux: dict) -> dict:
    """A step's loss scalars, gradients and buffers, on the host."""
    out = {"aux": {k: float(v) for k, v in aux.items()}}
    for i, mod in enumerate(modules):
        out[f"grads{i}"] = {n: p.grad.cpu() for n, p in mod.named_parameters()
                            if p.grad is not None}
        out[f"buffers{i}"] = {n: b.cpu() for n, b in mod.named_buffers()}
    return out


# The two ranks' gradients against the one-process step's, all parameters
# together (relative L2), must lie nearer it than the nearer of two wrong
# data-parallel steps, computed in the same phase, by GRAD_NEARER: the
# ranks' sum not divided by the world (twice the gradient) and one rank's
# rows alone (a missing all-reduce). A reordered sum of BN statistics and
# gradients moves a near-tied max-pool winner, which reroutes one
# channel's gradient (phase 5's per-parameter rule fails by 10-13x), but
# leaves the whole gradient near; a wrong reduction cannot.
GRAD_NEARER = 0.1


def grad_rel_l2(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every parameter's gradient together."""
    num = sum(float(((got[n].double() - g.double()) ** 2).sum()) for n, g in want.items())
    den = sum(float((g.double() ** 2).sum()) for g in want.values())
    return (num / den) ** 0.5


def all_grads(record: dict) -> dict:
    """Every gradient of a ``step_record``, all its modules together."""
    return {f"{key}.{n}": g for key, grads in record.items() if key.startswith("grads")
            for n, g in grads.items()}


def grads_nearer(label: str, ranks: list, want: dict, one_rank: dict) -> dict:
    """Hold each rank's gradients (``ranks``, ``step_record``s) nearer the
    one-process step's (``want``) than the nearer wrong variant by
    ``GRAD_NEARER``, and show that each wrong variant fails that check."""
    want_g = all_grads(want)
    wrong = {"sum_not_divided": grad_rel_l2({n: 2 * g for n, g in want_g.items()}, want_g),
             "one_rank_rows": grad_rel_l2(all_grads(one_rank), want_g)}
    limit = GRAD_NEARER * min(wrong.values())
    got = max(grad_rel_l2(all_grads(r), want_g) for r in ranks)
    check(got <= limit, f"{label}: the ranks' gradients sit at {got} relative L2 from the "
          f"one-process step's, the limit {limit} (wrong variants {wrong})")
    check(all(w > limit for w in wrong.values()), f"{label}: a wrong variant {wrong} passes")
    return {"rel_l2": got, "limit": limit, "wrong_rel_l2": wrong}


def grad_rule_ratio(got: dict, want: dict) -> tuple[float, str]:
    """The largest gradient error over phase 5's tolerance (1e-3 of the
    parameter's largest gradient plus 1e-4 of the largest of any), and
    the parameter it falls on."""
    top = max(float(g.abs().max()) for g in want.values())
    return max((float((got[n] - g).abs().max()) / (1e-3 * float(g.abs().max()) + 1e-4 * top),
                n) for n, g in want.items())


def full_width_config(num_points: int):
    """The full-width backbone at ``num_points``, heads [3, 2K]."""
    from point2cyl_torch.core.config import BackboneConfig

    return BackboneConfig(num_points=num_points, output_sizes=(3, 2 * K),
                          approx_neighbors=False)


def parallel_inputs(cfg, dev, root: str) -> dict:
    """Phase 12's shared inputs, written to ``root`` for the ranks: the
    full-width weights, Trainer A's and the joint trainer's batches (B=4
    from seed 0) and their configurations, and B=4 clouds."""
    from point2cyl_torch.core.config import TrainConfig
    from point2cyl_torch.data.pipeline import InputPipeline
    from point2cyl_torch.data.synthetic import generate_dataset
    from point2cyl_torch.models.backbone import build_backbone
    from point2cyl_torch.train import train_joint
    from point2cyl_torch.train.train_pc import build_model, config_from_args, epoch_generator

    tcfg = TrainConfig(batch_size=TB, pred_seg=True, pred_normal=True, pred_bb=True,
                       pred_extrusion=True, pred_center=True, seed=0)
    jargv = ["--synthetic", "8", "--K", str(K), "--batch_size", str(TB), "--num_sk_point",
             str(SK), "--num_point", str(cfg.num_points), "--is_pc_train", "--is_im_train",
             "--with_im_loss", "--pred_seg", "--pred_normal", "--pred_bb",
             "--pred_extrusion", "--pred_center"]
    jcfg = config_from_args(train_joint.build_argparser().parse_args(jargv))
    pipe = InputPipeline(generate_dataset(8, resolution=cfg.num_points, max_instances=K,
                                          num_sketch_points=SK, seed=0),
                         cfg.num_points, K, dev, num_sketch_points=SK)
    batch = pipe.batch(torch.arange(TB, device=dev), epoch_generator(0, 97, dev))
    nets = train_joint.build_nets(jcfg, cfg.num_points, K, False, False, "cpu")
    inp = {
        "cfg": cfg, "tcfg": tcfg, "jcfg": jcfg,
        "state": build_model(tcfg, cfg.num_points, K, "cpu").state_dict(),
        "serve_state": build_backbone(cfg, generator=torch.Generator().manual_seed(12),
                                      device="cpu").state_dict(),
        "batch": {k: v.cpu() for k, v in batch.items()},
        "joint_states": [n.state_dict() for n in nets],
        "pts": torch.from_numpy(clouds(12, TB, cfg.num_points)),
    }
    torch.save(inp, os.path.join(root, "inputs.pt"))
    return inp


def joint_trainer_from(inp: dict, dev, mesh=None):
    """The joint trainer of phase 12's nets on ``dev`` (data parallel over
    ``mesh`` where given)."""
    from point2cyl_torch.train import train_joint

    nets = train_joint.build_nets(inp["jcfg"], inp["cfg"].num_points, K, False, False, dev)
    for net, state in zip(nets, inp["joint_states"]):
        net.load_state_dict(state, strict=True)
    return train_joint.JointTrainer(*nets, inp["jcfg"], num_sk_points=SK, is_pc_train=True,
                                    is_im_train=True, with_im_loss=True, mesh=mesh)


def trainer_from(inp: dict, dev, mesh=None):
    """Trainer A on phase 12's weights on ``dev`` (data parallel over
    ``mesh`` where given)."""
    from point2cyl_torch.train import steps
    from point2cyl_torch.train.train_pc import build_model

    model = build_model(inp["tcfg"], inp["cfg"].num_points, K, dev)
    model.load_state_dict(inp["state"], strict=True)
    # the one-process step eager, as the data-parallel step runs
    return steps.Trainer(model, inp["tcfg"], mesh, graph=False)


def parallel_rank(rank: int, world: int, url: str, backend: str, root: str) -> None:
    """One rank of phase 12's two-rank runs (``torch.multiprocessing``
    spawns it): gloo on one card with host-staged collectives, or NCCL with
    a card a rank. Runs Trainer A's and the joint trainer's data-parallel
    step on its rows, and the point-sharded forward with the ring ops on
    its half of the points; writes what it found to ``root``."""
    from point2cyl_torch.models.backbone import build_backbone
    from point2cyl_torch.parallel import point_sharding as ps
    from point2cyl_torch.parallel.distributed import join
    from point2cyl_torch.parallel.mesh import make_mesh, shard_batch
    from point2cyl_torch.parallel.sharded_backbone import (ShardedForward,
                                                           backbone_apply_point_sharded)

    staged = backend == "gloo"
    dev = torch.device("cuda", 0 if staged else rank)
    torch.cuda.set_device(dev)
    join(url, world, rank, backend)
    try:
        mesh = make_mesh(devices=[dev] * world if staged else None, host_staged=staged)
        inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
        out = {}
        trainer = trainer_from(inp, dev, mesh)
        local = shard_batch(mesh, inp["batch"])
        aux, out["dp_launches"] = counted(
            lambda: trainer.train_step(local, torch.Generator(dev).manual_seed(7)))
        out["dp"] = step_record([trainer.model], aux)
        del trainer
        jtrainer = joint_trainer_from(inp, dev, mesh)
        aux, out["joint_launches"] = counted(
            lambda: jtrainer.train_step(local, torch.Generator(dev).manual_seed(7)))
        out["joint"] = step_record([jtrainer.backbone, jtrainer.encoder], aux)
        out["joint_eager_because"] = jtrainer.graphs.eager_because
        del jtrainer
        model = build_backbone(inp["cfg"], state_dict=inp["serve_state"], device=dev)
        n = inp["pts"].shape[1] // world
        pts = inp["pts"][:, rank * n:(rank + 1) * n].to(dev)
        heads, out["sharded_launches"] = counted(
            lambda: backbone_apply_point_sharded(mesh, model, inp["cfg"], pts))
        out["heads"] = [h.cpu() for h in heads]
        # the owner of the captured forward: eager over a host-staged mesh
        # (three calls: eager, capture and replay where the mesh allows it)
        owner = ShardedForward(mesh, model, inp["cfg"])
        out["owner_equal"] = all(torch.equal(a.cpu(), b) for _ in range(3)
                                 for a, b in zip(owner(pts), out["heads"]))
        out["owner_eager_because"] = owner.graphs.eager_because
        np0 = inp["cfg"].sa_npoints[0]
        fps = ps.farthest_point_sample_sharded(mesh, pts, np0)
        centres = ps._owned_gather(pts, fps, mesh)
        q = centres[:, rank * (np0 // world):(rank + 1) * (np0 // world)]
        out["fps"] = fps.cpu()
        out["ball_query"] = ps.ball_query_sharded(mesh, inp["cfg"].sa_radii[0],
                                                  inp["cfg"].sa_nsamples[0], pts, q).cpu()
        out["three_nn"] = ps._ring_three_nn_local(pts, q, mesh)[1].cpu()
        torch.cuda.synchronize()
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(backend: str, root: str) -> list[dict]:
    """Spawn phase 12's two ranks and wait for them; their results."""
    import torch.multiprocessing as mp

    url = "file://" + os.path.join(root, f"rdv_{backend}")
    mp.spawn(parallel_rank, args=(2, url, backend, root), nprocs=2, join=True)
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


def check_two_ranks(label: str, ranks: list[dict], inp: dict, dev) -> dict:
    """Phase 12 b/c: the two ranks against the one-process card paths.
    Trainer A's and the joint step's losses at the JAX tests' tolerances
    (``tests/test_parallel.py``) and Trainer A's BN statistics within
    1e-5; the ring's FPS, ball-query and 3-NN indices equal to the
    single-device ops on the card; the heads of the sharded forward within
    rtol 2e-4, atol 1e-5 of the forward. The gradients are reported
    against phase 5's rule, not held to it: unlike the kernel against the
    plain version (whose forwards are bit-equal), the ranks sum the BN
    statistics in another order, and a 1e-7 change moves the winner of a
    near-tied max-pool, which reroutes that channel's gradient (the worst
    parameter is the group-all stage's first layer; the float32 joint
    tests in tests/test_torch_joint.py meet the same). The CPU tests hold
    the rule at a small size, and phase 12a the world-1 step bit for
    bit. The gradients of all parameters together are held by
    ``GRAD_NEARER`` against two wrong variants."""
    from point2cyl_torch.models.backbone import build_backbone
    from point2cyl_torch.ops import cuda_ballquery, cuda_fps, cuda_knn
    from point2cyl_torch.ops.grouping import index_points

    report = {"phase": "12" + label}
    batch = {k: v.to(dev) for k, v in inp["batch"].items()}
    rows0 = {k: v[:TB // 2] for k, v in batch.items()}  # rank 0's rows
    trainer = trainer_from(inp, dev)
    want = step_record([trainer.model], trainer.train_step(
        batch, torch.Generator(dev).manual_seed(7)))
    del trainer
    trainer = trainer_from(inp, dev)
    one_rank = step_record([trainer.model], trainer.train_step(
        rows0, torch.Generator(dev).manual_seed(7)))
    del trainer
    err = {}
    for r in ranks:
        for key, val in want["aux"].items():
            if key == "skipped":
                check(r["dp"]["aux"][key] == val == 0.0, f"12{label}: a step was skipped")
                continue
            e = abs(r["dp"]["aux"][key] - val)
            check(e <= 2e-4 * abs(val) + DP_TOL.get(key, 1e-4),
                  f"12{label} Trainer A {key}: {r['dp']['aux'][key]} vs one process {val}")
            err[key] = max(err.get(key, 0.0), e)
        for name, buf in want["buffers0"].items():
            torch.testing.assert_close(r["dp"]["buffers0"][name], buf, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"12{label} BN {name}: {m}")
    report.update(trainer_a_abs_err=err,
                  trainer_a_grad_over_rule=grad_rule_ratio(ranks[0]["dp"]["grads0"],
                                                           want["grads0"]),
                  trainer_a_grads=grads_nearer(f"12{label} Trainer A",
                                               [r["dp"] for r in ranks], want, one_rank),
                  dp_launches_per_rank=ranks[0]["dp_launches"])

    jtrainer = joint_trainer_from(inp, dev)
    jwant = step_record([jtrainer.backbone, jtrainer.encoder], jtrainer.train_step(
        batch, torch.Generator(dev).manual_seed(7)))
    del jtrainer
    jtrainer = joint_trainer_from(inp, dev)
    jone_rank = step_record([jtrainer.backbone, jtrainer.encoder], jtrainer.train_step(
        rows0, torch.Generator(dev).manual_seed(7)))
    del jtrainer
    jerr = {}
    for r in ranks:
        for key, val in jwant["aux"].items():
            if key == "skipped":
                check(r["joint"]["aux"][key] == val == 0.0, f"12{label}: a joint step skipped")
                continue
            atol = 8e-3 if key in JOINT_AXIS_PATH else 2e-3
            e = abs(r["joint"]["aux"][key] - val)
            check(e <= 3e-4 * abs(val) + atol,
                  f"12{label} joint {key}: {r['joint']['aux'][key]} vs one process {val}")
            jerr[key] = max(jerr.get(key, 0.0), e)
    report.update(joint_abs_err=jerr, joint_grad_over_rule=grad_rule_ratio(
        ranks[0]["joint"]["grads0"], jwant["grads0"]),
        joint_grads=grads_nearer(f"12{label} joint", [r["joint"] for r in ranks], jwant,
                                 jone_rank),
        joint_launches_per_rank=ranks[0]["joint_launches"])

    cfg = inp["cfg"]
    pts = inp["pts"].to(dev)
    model = build_backbone(cfg, state_dict=inp["serve_state"], device=dev)
    with torch.inference_mode():
        heads = model(pts)
        fps = cuda_fps.farthest_point_sample(pts, cfg.sa_npoints[0])
        centres = index_points(pts, fps)
        idx, _ = cuda_ballquery.ball_query_grouped(cfg.sa_radii[0], cfg.sa_nsamples[0], pts,
                                                   centres)
        nn_idx = torch.empty((TB, cfg.num_points, 3), dtype=torch.int32, device=dev)
        nn_w = torch.empty((TB, cfg.num_points, 3), dtype=torch.float32, device=dev)
        cuda_knn.three_nn_interpolate_kernel(pts, centres, centres, 1e-8, (nn_idx, nn_w))
    for r in ranks:
        check(torch.equal(r["fps"], fps.cpu()), f"12{label}: ring FPS indices differ")
    check(torch.equal(torch.cat([r["ball_query"] for r in ranks], 1), idx.cpu()),
          f"12{label}: ring ball-query indices differ from the SA1 kernel's")
    check(torch.equal(torch.cat([r["three_nn"] for r in ranks], 1), nn_idx.long().cpu()),
          f"12{label}: ring 3-NN indices differ from the 3-NN kernel's")
    head_err = 0.0
    for i, want_h in enumerate(heads):
        got = torch.cat([r["heads"][i] for r in ranks], 1)
        torch.testing.assert_close(got, want_h.cpu(), rtol=2e-4, atol=1e-5,
                                   msg=lambda m: f"12{label} sharded head {i}: {m}")
        head_err = max(head_err, float((got - want_h.cpu()).abs().max()))
    report.update(sharded_heads_max_abs_err=head_err, indices_bit_equal=True,
                  sharded_launches_per_rank=ranks[0]["sharded_launches"])
    for r in ranks:
        check(r["sharded_launches"] == PER_SHARDED_FORWARD,
              f"12{label}: sharded forward launched {r['sharded_launches']}")
        check(r["owner_equal"], f"12{label}: ShardedForward differs from the eager forward")
    report["sharded_forward_owner"] = {"bit_equal_to_eager": True,
                                       "eager_because": ranks[0]["owner_eager_because"]}
    return report


def bit_equal_steps(a: dict, b: dict) -> bool:
    return (a["aux"] == b["aux"]
            and all(torch.equal(a["grads0"][n], g) for n, g in b["grads0"].items())
            and all(torch.equal(a["buffers0"][n], g) for n, g in b["buffers0"].items()))


def two_card_phase(card: str, dev, root: str, inp: dict) -> None:
    """Phase 12c: phase 12b's checks with two NCCL ranks on cuda:0 and
    cuda:1, and an ``InferenceSession`` over both cards bit-equal to one
    card's."""
    from point2cyl_torch.serve.export import export_artifact
    from point2cyl_torch.serve.session import InferenceSession

    check(torch.cuda.device_count() >= 2, "phase 12c needs two cards")
    report = check_two_ranks("c", run_ranks("nccl", root), inp, dev)
    path = os.path.join(root, "two_cards.p2ct")
    export_artifact(path, inp["serve_state"], k=K, backbone_config=inp["cfg"],
                    buckets=(1, 4))
    one = InferenceSession(path, device="cuda:0")
    two = InferenceSession(path, devices=["cuda:0", "cuda:1"])
    req = clouds(14, 9, inp["cfg"].num_points)  # chunks of 4, 4 and 1
    a, b = one.predict(req, assemble=False), two.predict(req, assemble=False)
    check(all(np.array_equal(a[k], b[k]) for k in a) and two._next_dev == 1,
          "12c: the two-card session differs from one card")
    check(two.stats["folded_layers"] == 17 and two._models[0] is not two._models[1]
          and all(m.served_fc.weight.device == torch.device(d)
                  for m, d in zip(two._models, ("cuda:0", "cuda:1"))),
          "12c: the two cards' replicas are not each folded on their card")
    print(json.dumps({**report, "world": 2, "backend": "nccl", "session_bit_equal": True,
                      "card": card}), flush=True)


def ring_step_row(name: str, xyz: torch.Tensor, npoint: int, card: str,
                  nan_check: bool = False) -> dict:
    """Phase 12a: the ring-step kernel against its plain version at P=1 on
    the clouds ``xyz``, ``npoint`` steps from the same start (point 0):
    after every step the offers and the running distances bit-equal, at
    the end the centroids bit-equal (also to
    ``farthest_point_sample_plain``); with ``nan_check`` first the same over
    64 steps of a copy with a NaN and an inf coordinate (a NaN distance
    equal to a NaN); then one step of each timed from step 1's state.
    Returns the kernel table's row."""
    from point2cyl_torch.ops import cuda_fps
    from point2cyl_torch.ops.sampling import (farthest_point_sample_plain, fps_ring_offers,
                                              fps_ring_step_plain)

    b, n, _ = xyz.shape
    dev = xyz.device
    plan = cuda_fps.fps_ring_plan(b, n)
    routes = {"kernel": cuda_fps.fps_ring_step_kernel, "plain": fps_ring_step_plain}

    def run(pts: torch.Tensor, steps: int, label: str) -> dict:
        first = fps_ring_offers(torch.zeros(b, dtype=torch.int64, device=dev), pts[:, 0])[None]
        state = {route: [first, torch.full((b, n), 1e10, device=dev),
                         torch.empty((b, steps), dtype=torch.int64, device=dev)]
                 for route in routes}
        for i in range(steps):
            if i == 1:
                state["step1"] = [t.clone() for t in state["kernel"]]
            offers = {route: fn(pts, *state[route], i, 0) for route, fn in routes.items()}
            check(torch.equal(offers["kernel"], offers["plain"])
                  and same_bits(state["kernel"][1], state["plain"][1]),
                  f"ring step {label}, step {i}: the kernel's offer or distances differ from "
                  "the plain version's")
            for route in routes:
                state[route][0] = offers[route][None]
        check(torch.equal(state["kernel"][2], state["plain"][2]),
              f"ring step {label}: the centroids differ")
        return state

    if nan_check:
        bad = xyz.clone()
        bad[b - 1, n // 3] = float("nan")
        bad[0, n // 5, 0] = float("inf")
        run(bad, 64, f"{name} with NaN and inf")
    state = run(xyz, npoint, name)
    check(torch.equal(state["kernel"][2].int(), farthest_point_sample_plain(xyz, npoint)),
          f"ring step {name}: the centroids differ from the single-device FPS")
    step1 = state["step1"]
    k_ms = time_ms(lambda: cuda_fps.fps_ring_step_kernel(xyz, *step1, 1, 0))
    p_ms = time_ms(lambda: fps_ring_step_plain(xyz, *step1, 1, 0))
    # each point's coordinates and distance read, its distance written;
    # the offers read and written, the centroid written. Per point: 3 sub,
    # 3 mul, 2 add, 1 min, 1 compare
    nbytes = b * n * (12 + 4 + 4) + step1[0].numel() * 8 + b * 4 * 8 + b * 8
    b_ms, b_by = bound(nbytes, 10.0 * b * n)
    row = {"name": f"fps_ring_step@{name}", "route": "cuda",
           "source": "point2cyl_torch/csrc/fps_ring.cu",
           "replaces": "point2cyl_tpu/parallel/point_sharding.py:252 _fps_local's "
                       "fori_loop body (XLA, no pallas_call)",
           "max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None}
    print(json.dumps({"kernel": row["name"], "batch": b, "shard_points": n, "steps": npoint,
                      "plan": plan._asdict(), "bit_equal_every_step": True,
                      "nan_inf_checked": nan_check, "kernel_ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                      "card": card}), flush=True)
    return row


def huge_cloud_run(mesh, state: dict, dev) -> dict:
    """Phase 12d: one cloud of 2^20 points at P=1 through
    ``ShardedForward`` (eager, capture and replay, then three replays): the wall
    seconds of each call, the peak GiB over them, and the heads against the
    single-device forward with every ``*_impl="plain"`` (within 1e-3, as
    at N = 131,072), with its wall seconds and peak."""
    from point2cyl_torch.models.backbone import build_backbone
    from point2cyl_torch.parallel.sharded_backbone import ShardedForward

    cfg = full_width_config(2**20)
    pts = torch.from_numpy(clouds(15, 1, 2**20)).to(dev)
    model = build_backbone(cfg, state_dict=state, device=dev)
    owner = ShardedForward(mesh, model, cfg)
    out = {"calls_s": []}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            heads = owner(pts)
            torch.cuda.synchronize()
            out["calls_s"].append(time.perf_counter() - t0)
    g = owner.graphs
    check(g.eager_calls == 1 and g.captures == 1 and g.replays == 4,
          f"2^20 points: {g.eager_calls} eager, {g.captures} captures, {g.replays} replays")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["replay_s"] = statistics.median(out["calls_s"][2:])
    del owner
    torch.cuda.empty_cache()
    plain = build_backbone(dataclasses.replace(cfg, fps_impl="plain", ballquery_impl="plain",
                                               knn_impl="plain"), state_dict=state, device=dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(pts)
        torch.cuda.synchronize()
    out["plain_forward_s"] = time.perf_counter() - t0
    out["plain_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    err = max(float((a - b).abs().max()) for a, b in zip(heads, want))
    check(all(h.shape == (1, 2**20, w.shape[-1]) and bool(torch.isfinite(h).all())
              for h, w in zip(heads, want)), "2^20 points: heads of the wrong shape or not "
          "finite")
    check(err <= 1e-3, f"2^20 points: sharded vs plain heads differ by {err}")
    out["heads_max_abs_err"] = err
    del plain, model, pts, heads, want
    torch.cuda.empty_cache()
    return out


def parallel_phase(card: str, dev, root: str) -> tuple[dict, list]:
    """Phase 12: the parallel package on the card. Returns the launches of
    a data-parallel Trainer A step (per rank), of a joint step (per rank),
    of a point-sharded forward and of its capture, by kernel, and the
    kernel table's rows of the ring-step kernel."""
    import warnings

    from point2cyl_torch.core.graphs import step_graphs
    from point2cyl_torch.models.backbone import build_backbone
    from point2cyl_torch.ops import cuda_fps
    from point2cyl_torch.parallel import collectives
    from point2cyl_torch.parallel import point_sharding as ps
    from point2cyl_torch.parallel.distributed import join
    from point2cyl_torch.parallel.mesh import make_mesh
    from point2cyl_torch.parallel.sharded_backbone import (ShardedForward,
                                                           backbone_apply_point_sharded)
    from point2cyl_torch.train import train_pc

    t_phase = time.perf_counter()
    cfg = full_width_config(8192)
    inp = parallel_inputs(cfg, dev, root)
    ran = []

    # a. one rank, NCCL, world 1. The CLI first: it forms (and leaves) its
    # own world-1 group, 2 epochs of --synthetic 8 at B=4, then a resume
    logdir = os.path.join(root, "dp1")
    argv = ["--synthetic", "8", "--num_point", str(cfg.num_points), "--K", str(K),
            "--batch_size", str(TB), "--logdir", logdir, "--data_parallel", "1",
            "--pred_seg", "--pred_normal", "--pred_bb", "--pred_extrusion", "--pred_center"]
    done = train_pc.cli_main(argv + ["--num_epochs", "2"])
    resumed = train_pc.cli_main(argv + ["--num_epochs", "3", "--resume"])
    with open(os.path.join(logdir, "log.txt")) as f:
        log = f.read()
    check(done.step == 4 and resumed.step == 6 and "epoch 2, step 4" in log
          and "data-parallel over 1 rank(s)" in log,
          f"--data_parallel 1: steps {done.step}, {resumed.step}")
    del done, resumed
    join("file://" + os.path.join(root, "rdv_world1"), 1, 0, "nccl")
    try:
        mesh = make_mesh()
        batch = {k: v.to(dev) for k, v in inp["batch"].items()}
        records = {}
        # both steps with deterministic algorithms, so that autograd's own
        # scatters add in a fixed order and two runs of one step agree
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for name, m in (("single", None), ("single_again", None), ("dp", mesh)):
                    trainer = trainer_from(inp, dev, m)
                    aux, launches = counted(lambda: trainer.train_step(
                        batch, torch.Generator(dev).manual_seed(7)))
                    records[name] = step_record([trainer.model], aux)
                    records[name + "_launches"] = launches
                    del trainer
            finally:
                torch.use_deterministic_algorithms(False)
        repeatable = bit_equal_steps(records["single_again"], records["single"])
        check(repeatable, "12a: the one-process step does not repeat itself bit for bit "
              "under deterministic algorithms")
        check(bit_equal_steps(records["dp"], records["single"]),
              "12a: the world-1 data-parallel step differs from the one-process step")
        check(records["dp_launches"] == records["single_launches"],
              f"12a: launches {records['dp_launches']} vs {records['single_launches']}")
        model = build_backbone(cfg, state_dict=inp["serve_state"], device=dev)
        pts = inp["pts"].to(dev)
        np0 = cfg.sa_npoints[0]
        with torch.inference_mode():
            want = model(pts)
        got, sharded_launches = counted(
            lambda: backbone_apply_point_sharded(mesh, model, cfg, pts))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "12a: the P=1 sharded forward differs from Backbone.forward")
        check(sharded_launches == PER_SHARDED_FORWARD_P1,
              f"12a: sharded forward launched {sharded_launches}")
        # the ring step against its plain version, every step, at SA1 and
        # at 131,072 points
        big_pts = torch.from_numpy(clouds(13, 1, 131072)).to(dev)
        ring_rows = [ring_step_row("sa1_p1", pts, np0, card, nan_check=True),
                     ring_step_row("n131072_p1", big_pts, np0, card)]
        # the captured forward: eager, capture, replays, each bit-equal to
        # Backbone.forward (and so to the eager sharded forward)
        owner = ShardedForward(mesh, model, cfg)
        calls = []
        for i in range(5):
            heads, launched = counted(lambda: owner(pts))
            check(all(torch.equal(g, w) for g, w in zip(heads, want)),
                  f"12a: call {i} of the captured P=1 forward differs from Backbone.forward")
            calls.append(launched)
        og = owner.graphs
        check(og.eager_calls == 1 and og.captures == 1 and og.replays == 4,
              f"12a: {og.eager_calls} eager calls, {og.captures} captures, "
              f"{og.replays} replays")
        check(calls[0] == calls[1] == PER_SHARDED_FORWARD_P1 and not any(calls[2].values()),
              f"12a: the captured forward's calls launched {calls[:3]}")
        replay = traced_calls(lambda: owner(pts))
        check(replay["host_graph_launches"] == 1,
              f"12a: a replay made {replay['host_graph_launches']} graph launches")
        # the ring FPS that a P > 1 forward runs, here at world 1 over NCCL:
        # eager, capture, replays, each bit-equal to the FPS kernel; np0
        # ring-step launches in the eager call and in the capture, none in a
        # replay, and one graph launch a replay
        ring = step_graphs(dev, True, mesh)

        def ring_fps():
            return ring(lambda x, _: ps._fps_ring(x["pts"], np0, 0, mesh), {"pts": pts})

        # no_grad, not inference_mode: a replay copies into the graph's
        # static input, a tensor made outside inference mode
        with torch.no_grad():
            fps_want = cuda_fps.farthest_point_sample(pts, np0)
            ring_calls = []
            for i in range(5):
                ring_idx, launched = counted(ring_fps)
                check(torch.equal(ring_idx, fps_want),
                      f"12a: call {i} of the captured world-1 ring FPS differs from the "
                      "FPS kernel")
                ring_calls.append(launched["fps_ring_step"])
            check(ring.eager_calls == 1 and ring.captures == 1 and ring.replays == 4,
                  f"12a ring FPS: {ring.eager_calls} eager calls, {ring.captures} captures, "
                  f"{ring.replays} replays")
            check(ring_calls == [np0, np0, 0, 0, 0],
                  f"12a: the captured ring FPS's calls launched {ring_calls} ring steps")
            ring_replay = traced_calls(ring_fps)
        check(ring_replay["host_graph_launches"] == 1,
              f"12a: a ring FPS replay made {ring_replay['host_graph_launches']} graph launches")
        ran.append("a")
        print(json.dumps({"phase": "12a", "world": 1, "backend": "nccl",
                          "dp_step_bit_equal": True, "single_step_repeats": repeatable,
                          "cli_steps": [4, 6], "sharded_forward_bit_equal": True,
                          "ring_step_bit_equal": [r["name"] for r in ring_rows],
                          "captured_forward_bit_equal": {"calls": 5, "eager": og.eager_calls,
                                                         "captures": og.captures,
                                                         "replays": og.replays},
                          "captured_replay_host_launches": {
                              "graphs": replay["host_graph_launches"],
                              "kernels": replay["host_kernel_launches"]},
                          "dp_launches": records["dp_launches"],
                          "sharded_launches": sharded_launches,
                          "captured_forward_capture_launches": calls[1],
                          "captured_ring_fps_bit_equal": {"calls": 5,
                                                          "ring_step_launches": ring_calls},
                          "ring_fps_replay_host_launches": {
                              "graphs": ring_replay["host_graph_launches"],
                              "kernels": ring_replay["host_kernel_launches"]},
                          "ring_fps_replay_device_ms": ring_replay["device_ms"]}), flush=True)

        # d. timings at world 1: the data-parallel step beside the
        # one-process step (the BN and gradient all-reduces); in turns, the
        # captured P=1 sharded forward beside the eager one and the
        # forward, the captured ring FPS beside the eager one and the FPS
        # kernel
        single, dp_trainer = trainer_from(inp, dev), trainer_from(inp, dev, mesh)
        gen = torch.Generator(dev).manual_seed(8)
        step_ms = {"single": [], "dp": []}
        for _ in range(6):
            for name, tr in (("single", single), ("dp", dp_trainer), ("dp", dp_trainer),
                             ("single", single)):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                tr.train_step(batch, gen)
                end.record()
                end.synchronize()
                step_ms[name].append(start.elapsed_time(end))
        del single, dp_trainer
        with torch.no_grad():
            check(all(torch.equal(ring_fps(), fps_want) for _ in range(3)),
                  "12d: the captured ring FPS differs from the kernel")
            turns = in_turns({
                "captured_forward": lambda: owner(pts),
                "eager_forward": lambda: backbone_apply_point_sharded(mesh, model, cfg, pts),
                "forward": lambda: model(pts), "captured_ring_fps": ring_fps,
                "eager_ring_fps": lambda: ps._fps_ring(pts, np0, 0, mesh),
                "fps_kernel": lambda: cuda_fps.farthest_point_sample(pts, np0)}, rounds=5)
            fwd_ms = time_ms(lambda: model(pts))
            fps_ms = time_ms(lambda: cuda_fps.farthest_point_sample(pts, np0))
            # one world-1 NCCL collective of the ring FPS's size (B x 4
            # int64) and of a BN layer's sums (128 floats), in a run of 100
            offer = torch.zeros((1, TB, 4), dtype=torch.int64, device=dev)
            sums = torch.zeros(128, device=dev)
            gather_us = time_ms(lambda: [collectives.all_gather(offer, mesh)
                                         for _ in range(100)]) * 10
            reduce_us = time_ms(lambda: [collectives.psum(sums, mesh)
                                         for _ in range(100)]) * 10
        del owner, ring
        # one cloud of 131,072 points on one rank, captured beside eager and
        # beside the single-device forward with every *_impl="plain"
        big_cfg = full_width_config(131072)
        big = build_backbone(big_cfg, state_dict=inp["serve_state"], device=dev)
        plain = build_backbone(dataclasses.replace(big_cfg, fps_impl="plain",
                                                   ballquery_impl="plain", knn_impl="plain"),
                               state_dict=inp["serve_state"], device=dev)
        big_owner = ShardedForward(mesh, big, big_cfg)
        peaks = {}
        with torch.no_grad():
            for name, fn in (("sharded", lambda: backbone_apply_point_sharded(
                    mesh, big, big_cfg, big_pts)), ("plain", lambda: plain(big_pts))):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                fn()
                torch.cuda.synchronize()
                peaks[name] = (torch.cuda.max_memory_allocated() - before) / 2**30
            eager_big = backbone_apply_point_sharded(mesh, big, big_cfg, big_pts)
            captured_big = [big_owner(big_pts) for _ in range(3)][-1]
            check(all(torch.equal(g, w) for g, w in zip(captured_big, eager_big)),
                  "12d: the captured N=131072 forward differs from the eager one")
            big_err = max(float((g - w).abs().max()) for g, w in zip(eager_big,
                                                                      plain(big_pts)))
            big_ms = in_turns({"captured": lambda: big_owner(big_pts),
                               "eager": lambda: backbone_apply_point_sharded(
                                   mesh, big, big_cfg, big_pts),
                               "plain": lambda: plain(big_pts)}, rounds=3)
        check(big_err <= 1e-3, f"12d: N=131072 sharded vs plain heads differ by {big_err}")
        del big, plain, big_pts, big_owner, eager_big, captured_big
        huge = huge_cloud_run(mesh, inp["serve_state"], dev)
        print(json.dumps({"phase": "12d", "card": card,
                          "dp_world1_step_ms": statistics.median(step_ms["dp"]),
                          "single_step_ms": statistics.median(step_ms["single"]),
                          "sharded_forward_p1_captured_ms": turns["captured_forward"],
                          "sharded_forward_p1_eager_ms": turns["eager_forward"],
                          "forward_ms_in_turns": turns["forward"],
                          "captured_replay": {**replay, "busy_share": replay["device_ms"]
                                              / turns["captured_forward"]},
                          "forward_ms": fwd_ms,
                          "ring_fps_sa1_captured_ms": turns["captured_ring_fps"],
                          "ring_fps_sa1_eager_ms": turns["eager_ring_fps"],
                          "fps_kernel_sa1_ms_in_turns": turns["fps_kernel"],
                          "fps_kernel_sa1_ms": fps_ms,
                          "nccl_world1_all_gather_us": gather_us,
                          "nccl_world1_all_reduce_us": reduce_us,
                          "n131072_sharded_p1_captured_ms": big_ms["captured"],
                          "n131072_sharded_p1_eager_ms": big_ms["eager"],
                          "n131072_plain_forward_ms": big_ms["plain"],
                          "n131072_sharded_peak_gib": peaks["sharded"],
                          "n131072_plain_peak_gib": peaks["plain"],
                          "n131072_heads_max_abs_err": big_err, "batch": TB}), flush=True)
        print(json.dumps({"phase": "12d", "cloud": "2^20 points, B=1, P=1", **huge,
                          "card": card}), flush=True)
    finally:
        torch.distributed.destroy_process_group()

    # b. two ranks on this one card over gloo (NCCL refuses two ranks on one
    # card), every collective staged through host memory
    ranks = run_ranks("gloo", root)
    report = check_two_ranks("b", ranks, inp, dev)
    # a host-staged mesh's step is not captured, and says why
    check(all(r["joint_eager_because"] == r["owner_eager_because"] == "host-staged mesh"
              for r in ranks),
          f"12b: {[(r['joint_eager_because'], r['owner_eager_because']) for r in ranks]}")
    ran.append("b")
    print(json.dumps({**report, "world": 2, "backend": "gloo, host-staged", "card": card}),
          flush=True)

    # c. two cards over NCCL, and a session over two cards
    if torch.cuda.device_count() >= 2:
        two_card_phase(card, dev, root, inp)
        ran.append("c")
        why_c = "two or more cards"
    else:
        why_c = f"skipped: {torch.cuda.device_count()} card"
    print(json.dumps({"phase": "12", "ran": ran, "a": "one rank, NCCL, world 1",
                      "b": "two ranks on one card, gloo, host-staged", "c": why_c,
                      "phase12_s": time.perf_counter() - t_phase}), flush=True)
    return {"dp_step_per_rank": report["dp_launches_per_rank"],
            "joint_step_per_rank": report["joint_launches_per_rank"],
            "sharded_forward": sharded_launches,
            "sharded_forward_capture": calls[1],
            "sharded_forward_p2": report["sharded_launches_per_rank"]}, ring_rows


# ---- phase 13: bf16 compute --------------------------------------------------

BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate, NVIDIA data sheet
# The bf16 step on the card against the all-plain bf16 step, with the
# float32 step on the same weights and batch as the yardstick: the card's
# loss, its gradients (all parameters together, relative L2) and its BN
# statistics (all together, relative L2) must lie nearer the plain bf16
# step's than the float32 step's do, by BF16_NEARER. A float32 rule cannot
# hold them: the card's backward rounds each dense layer's cotangent to
# bf16 to enter the tensor cores (the plain version multiplies it in
# float32, as JAX does on the CPU; the TPU's MXU rounds it too), and a
# float32 summation order moves some roundings to bf16 by an ulp (2^-8
# relative); batch-statistics BN, whose backward leaves a small residual
# of large per-row terms, and near-tied max-pool winners spread that to
# tens of percent of the SA1 weights' gradients (measured on the card,
# PERF.md). A bf16 path that ran in float32 would sit at the float32
# step's distance and fail.
BF16_NEARER = 0.6
# served heads at bf16 scale (eval-mode BN: only the forward's roundings)
BF16_HEADS_ATOL = 1e-3  # an eighth of a bf16 ulp at 1


def dense_shapes(model, pts) -> list[tuple[str, int, int, int]]:
    """(name, rows, in, out) of every dense layer of ``model``'s eval
    forward on ``pts``, in the order the forward runs them."""
    from point2cyl_torch.models.layers import Dense

    shapes, hooks = [], []
    for name, m in model.named_modules():
        if isinstance(m, Dense):
            hooks.append(m.register_forward_hook(
                lambda mod, a, out, name=name: shapes.append(
                    (name, a[0].numel() // a[0].shape[-1], a[0].shape[-1], out.shape[-1]))))
    with torch.inference_mode():
        model(pts)
    for h in hooks:
        h.remove()
    return shapes


def bound_lowp(rows: int, cin: int, cout: int) -> tuple[float, str]:
    """Least time (ms) of a bf16 dense layer's forward on float32 tensors:
    x, the weight and the bias read once and y written once (float32) at
    peak HBM rate, or its 2 * rows * in * out operations at the bf16
    tensor-core rate, whichever is larger."""
    t_bytes = (rows * cin + cin * cout + cout + rows * cout) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * rows * cin * cout / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each magnitude of ``v`` (normal numbers)."""
    _, e = torch.frexp(v.abs())
    return torch.ldexp(torch.ones_like(v), e - 8)


def lowp_step_check(label: str, card: dict, plain: dict, fp32: dict) -> dict:
    """A bf16 step (``step_record``) held against the all-plain bf16 step
    with the float32 step as the yardstick (``BF16_NEARER``); every
    gradient non-zero. The distances and the parameter the card's
    gradients part most on, printed before they are checked."""
    def rel_l2(a: dict, b: dict, key: str) -> float:
        names = list(b[key])
        flat = lambda r: torch.cat([r[key][n].flatten().double() for n in names])  # noqa: E731
        return float((flat(a) - flat(b)).norm() / flat(b).norm())

    dist = {"loss": (abs(card["aux"]["total"] - plain["aux"]["total"]),
                     abs(fp32["aux"]["total"] - plain["aux"]["total"])),
            "grads": (rel_l2(card, plain, "grads0"), rel_l2(fp32, plain, "grads0")),
            "bn": (rel_l2(card, plain, "buffers0"), rel_l2(fp32, plain, "buffers0"))}
    per = {n: float((card["grads0"][n] - g).norm() / g.norm())
           for n, g in plain["grads0"].items() if g.norm() > 0}
    worst = max(per, key=per.get)
    report = {"card_vs_plain": {k: v[0] for k, v in dist.items()},
              "fp32_vs_plain": {k: v[1] for k, v in dist.items()},
              "ratio": {k: v[0] / v[1] for k, v in dist.items()},
              "worst_parameter": worst, "worst_parameter_rel_l2": per[worst],
              "bound": BF16_NEARER}
    print(json.dumps({"check": f"{label} vs all-plain bf16", **report}), flush=True)
    for key, (near, far) in dist.items():
        check(near <= BF16_NEARER * far, f"{label}: {key} {near} from the plain bf16 step, "
              f"the float32 step {far}")
    check(all(bool((g != 0).any()) for g in card["grads0"].values()), f"{label}: a zero "
          "gradient")
    return report


def launches_per_step(step, steps: int = 2) -> float:
    """Device kernels launched per call of ``step``, from a trace."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / steps


def bf16_phase(args, card: str, dev, root: str) -> dict:
    """Phase 13: the backbone's dense layers in bf16 with float32 results.
    Returns the hand kernels' launches in its runs, by run and kernel."""
    import warnings

    from point2cyl_torch.core.config import TrainConfig
    from point2cyl_torch.models.backbone import Backbone, build_backbone
    from point2cyl_torch.ops import lowp_dense
    from point2cyl_torch.parallel.distributed import join
    from point2cyl_torch.parallel.mesh import make_mesh
    from point2cyl_torch.parallel.sharded_backbone import backbone_apply_point_sharded
    from point2cyl_torch.serve.export import _backbone_forward, export_artifact
    from point2cyl_torch.serve.session import InferenceSession
    from point2cyl_torch.train import steps, train_joint, train_pc
    from point2cyl_torch.train.train_pc import build_pipeline, build_trainer, epoch_generator

    t_phase = time.perf_counter()
    gemm = lowp_dense.lowp_gemm
    cfg = full_width_config(8192)
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    plain16 = dataclasses.replace(cfg16, fps_impl="plain", ballquery_impl="plain",
                                  knn_impl="plain", dense_impl="plain")
    state = build_backbone(cfg, generator=torch.Generator().manual_seed(13),
                           device="cpu").state_dict()
    out = {}

    # a. the bf16 dense product at each layer's shape (B=4), forward and
    # both gradients, against its plain version on the card; CUDA-event
    # medians beside the float32 layer (torch.matmul, TF32 off)
    model16 = build_backbone(cfg16, state_dict=state, device=dev)
    shapes = dense_shapes(model16, torch.from_numpy(clouds(14, TB, cfg.num_points)).to(dev))
    check(len(shapes) == 19, f"{len(shapes)} dense layers, expected 19")
    gen = torch.Generator(dev).manual_seed(13)
    rows_out = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "fp32_ms": 0.0, "fwd_bwd_ms": 0.0,
              "fp32_fwd_bwd_ms": 0.0, "bound_ms": 0.0}
    for name, rows, cin, cout in shapes:
        x = torch.randn(rows, cin, device=dev, generator=gen)
        w = torch.randn(cout, cin, device=dev, generator=gen) / cin ** 0.5
        b = torch.randn(cout, device=dev, generator=gen) * 0.1
        g = torch.randn(rows, cout, device=dev, generator=gen)
        res = {}
        for impl in ("kernel", "plain"):
            xi, wi, bi = (t.clone().requires_grad_() for t in (x, w, b))
            gemm.launches = 0
            y = lowp_dense.dense_lowp(xi, wi, bi, torch.bfloat16, impl)
            y.backward(g)
            torch.cuda.synchronize()
            res[impl] = (y.detach(), xi.grad, wi.grad, bi.grad, gemm.launches)
        check(res["kernel"][4] == 3 and res["plain"][4] == 0,
              f"{name}: GEMM launches {res['kernel'][4]} (card), {res['plain'][4]} (plain)")
        xa, wa, ga = x.bfloat16().float().abs(), w.bfloat16().float().abs(), g.abs()
        # forward: float32 summation order; the gradients: one bf16 ulp
        # plus the cotangent's rounding to bf16 (2^-9 of each term)
        bounds = (2.0**-20 * (xa @ wa.t() + b.abs()),
                  ulp_bf16(res["plain"][1]) + 2.0**-8 * (ga @ wa),
                  ulp_bf16(res["plain"][2]) + 2.0**-8 * (ga.t() @ xa),
                  2.0**-20 * ga.sum(0))
        over = max(float(((k - p).abs() / bd).max()) for k, p, bd in
                   zip(res["kernel"][:4], res["plain"][:4], bounds))
        errs = [float((k - p).abs().max()) for k, p in zip(res["kernel"][:4], res["plain"][:4])]
        check(over <= 1.0, f"{name} ({rows}x{cin}x{cout}): card vs plain {over} times "
              f"the bound, max abs errors {errs}")
        with torch.no_grad():
            ms = time_ms(lambda: lowp_dense.dense_lowp(x, w, b, torch.bfloat16, "kernel"))
            plain_ms = time_ms(lambda: lowp_dense.dense_lowp(x, w, b, torch.bfloat16,
                                                             "plain"))
            fp32_ms = time_ms(lambda: torch.matmul(x, w.t()) + b)
        xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
        fwd_bwd_ms = time_ms(lambda: lowp_dense.dense_lowp(xg, wg, bg, torch.bfloat16,
                                                           "kernel").backward(g))
        fp32_fwd_bwd_ms = time_ms(lambda: (torch.matmul(xg, wg.t()) + bg).backward(g))
        bound_ms, bound_by = bound_lowp(rows, cin, cout)
        row = {"layer": name, "rows": rows, "in": cin, "out": cout,
               "max_abs_err": {"y": errs[0], "dx": errs[1], "dw": errs[2], "db": errs[3]},
               "err_over_bound": over, "ms": ms, "plain_ms": plain_ms, "fp32_ms": fp32_ms,
               "fwd_bwd_ms": fwd_bwd_ms, "fp32_fwd_bwd_ms": fp32_fwd_bwd_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        for key in totals:
            totals[key] += row[key]
        rows_out.append(row)
        print(json.dumps({"phase": "13a", **row, "card": card}), flush=True)
        del x, w, b, g, xg, wg, bg, res
    print(json.dumps({"phase": "13a", "layers": len(rows_out), "sum_over_layers": totals,
                      "card": card}), flush=True)

    # b. Trainer A in bf16 from build_trainer on --synthetic 16 (B=4): the
    # hand kernels' launches a step are the float32 step's, the GEMMs 3 a
    # dense layer less one (SA1's first layer takes no input gradient)
    counters = kernel_counters()
    per_step = {"fps": 2, "ball_query": 0, "ball_query_grouped": 1,
                "ball_query_grouped_backward": 0, "sa_grouped_exact": 1,
                "sa_grouped_backward": 1, "three_nn": 2, "three_nn_backward": 2,
                "fps_ring_step": 0, "fps_cluster": 0, "fps_grid": 0,
                "ball_query_stream": 0}
    tcfg = TrainConfig(batch_size=TB, pred_seg=True, pred_normal=True, pred_bb=True,
                       pred_extrusion=True, pred_center=True, seed=0)
    tcfg16 = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    trainer16 = build_trainer(tcfg16, cfg.num_points, K, dev)
    pipeline = build_pipeline(tcfg, cfg.num_points, K, dev, synthetic=16)
    gen = epoch_generator(0, 1, dev)
    for fn in counters.values():
        fn.launches = 0
    gemm.launches = 0
    auxes = [trainer16.train_step(batch, gen) for batch in pipeline.epochs(TB, gen)]
    torch.cuda.synchronize()
    traced_steps = wrapper_calls(trainer16.graphs)  # eager or captured
    train_launches = {name: fn.launches // traced_steps for name, fn in counters.items()}
    gemms_per_step = gemm.launches / traced_steps
    check(train_launches == per_step and all(
        fn.launches == per_step[name] * traced_steps for name, fn in counters.items()),
        f"bf16 train step launches {train_launches}, expected {per_step}")
    check(gemms_per_step == 3 * 19 - 1, f"bf16 GEMMs a step {gemms_per_step}, expected 56")
    totals_loss = [float(a["total"]) for a in auxes]
    check(len(auxes) >= 4 and all(np.isfinite(totals_loss)), f"bf16 losses {totals_loss}")
    check(not any(float(a["skipped"]) for a in auxes), "a bf16 train step was skipped")
    zero = [n for n, p in trainer16.model.named_parameters()
            if p.grad is None or not bool((p.grad != 0).any())]
    check(not zero, f"bf16: parameters without a gradient: {zero}")
    check(all(p.dtype == torch.float32 for p in trainer16.model.parameters()),
          "bf16 training changed a parameter's dtype")

    batch = pipeline.batch(torch.arange(TB, device=dev), epoch_generator(0, 99, dev))
    plain_trainer = steps.Trainer(Backbone(dataclasses.replace(
        trainer16.model.cfg, fps_impl="plain", ballquery_impl="plain", knn_impl="plain",
        dense_impl="plain")).to(dev), tcfg16)
    f32_trainer = steps.Trainer(Backbone(dataclasses.replace(
        trainer16.model.cfg, compute_dtype="float32")).to(dev), tcfg)
    for tr in (plain_trainer, f32_trainer):
        tr.load_state_dict(trainer16.state_dict())
    records = {}
    for name, tr in (("card", trainer16), ("plain", plain_trainer), ("fp32", f32_trainer)):
        records[name] = step_record([tr.model], tr.train_step(
            batch, torch.Generator(dev).manual_seed(7)))
    lowp_step_check("13b train step", records["card"], records["plain"], records["fp32"])
    del plain_trainer
    print(json.dumps({"phase": "13b", "losses": totals_loss,
                      "launches_per_step": train_launches,
                      "gemms_per_step": gemms_per_step}), flush=True)

    # ms a step, bf16 beside float32, in turns; device launches a step of each
    step_ms = {"fp32": [], "bf16": []}
    for epoch in (2, 3):
        gen = epoch_generator(0, epoch, dev)
        for batch in pipeline.epochs(TB, gen):
            for name, tr in (("fp32", f32_trainer), ("bf16", trainer16), ("bf16", trainer16),
                             ("fp32", f32_trainer)):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                tr.train_step(batch, gen)
                end.record()
                end.synchronize()
                step_ms[name].append(start.elapsed_time(end))
    gen = epoch_generator(0, 5, dev)
    device_launches = {name: launches_per_step(lambda: tr.train_step(batch, gen))
                       for name, tr in (("fp32", f32_trainer), ("bf16", trainer16))}
    print(json.dumps({"phase": "13b", "rate": "train step", "batch": TB,
                      "bf16_ms_per_step": statistics.median(step_ms["bf16"]),
                      "fp32_ms_per_step": statistics.median(step_ms["fp32"]),
                      "steps": len(step_ms["bf16"]),
                      "device_launches_per_step": device_launches,
                      "added_launches_per_step": device_launches["bf16"]
                      - device_launches["fp32"], "card": card}), flush=True)
    if args.profile:
        for name, tr in (("fp32", f32_trainer), ("bf16", trainer16)):
            gen = epoch_generator(0, 4, dev)
            batches = pipeline.epochs(TB, gen)
            profile_steps(f"{name} train step (13b)", lambda: tr.train_step(next(batches), gen),
                          card, statistics.median(step_ms[name]))
    out["train_step"] = train_launches
    del trainer16, f32_trainer, pipeline

    # the CLI: 2 epochs of --synthetic 8 in bf16, then a resume
    logdir = os.path.join(root, "bf16_cli")
    argv = ["--synthetic", "8", "--num_point", str(cfg.num_points), "--K", str(K),
            "--batch_size", str(TB), "--logdir", logdir, "--compute_dtype", "bfloat16",
            "--pred_seg", "--pred_normal", "--pred_bb", "--pred_extrusion", "--pred_center"]
    done = train_pc.cli_main(argv + ["--num_epochs", "2"])
    resumed = train_pc.cli_main(argv + ["--num_epochs", "3", "--resume"])
    losses = logged_losses(logdir)
    check(done.step == 4 and resumed.step == 6 and all(np.isfinite(losses))
          and resumed.model.fc1.compute_dtype == torch.bfloat16,
          f"bf16 CLI: steps {done.step}, {resumed.step}, losses {losses}")
    print(json.dumps({"phase": "13b", "check": "bf16 cli resume",
                      "steps": [int(done.step), int(resumed.step)]}), flush=True)
    del done, resumed

    # c. serving in bf16: buckets (1, 4, 16), requests of 1, 5 and 16
    # clouds; the raw heads against the all-plain bf16 backbone on the card
    # and the port's bf16 backbone on the CPU
    per_forward = {"fps": 2, "ball_query": 0, "ball_query_grouped": 1,
                   "ball_query_grouped_backward": 0, "sa_grouped_exact": 1,
                   "sa_grouped_backward": 0, "three_nn": 2, "three_nn_backward": 0,
                   "fps_ring_step": 0, "fps_cluster": 0, "fps_grid": 0,
                   "ball_query_stream": 0}
    path = os.path.join(root, "bf16.p2ct")
    export_artifact(path, state, k=K, backbone_config=cfg16, buckets=(1, 4, 16),
                    num_sk_points=SK)
    sess = InferenceSession(path)
    check(sess.served is sess.model and sess.stats["folded_layers"] == 0,
          f"13c: the bf16 session folded {sess.stats['folded_layers']} layers")
    requests = {n: clouds(200 + n, n, cfg.num_points) for n in (1, 5, 16)}
    for fn in counters.values():
        fn.launches = 0
    gemm.launches = 0
    served = {n: sess.decompose(p) for n, p in requests.items()}
    torch.cuda.synchronize()
    serve_launches = {name: fn.launches for name, fn in counters.items()}
    check(serve_launches == {k: 3 * v for k, v in per_forward.items()}
          and gemm.launches == 3 * 19,
          f"bf16 serving launches {serve_launches}, GEMMs {gemm.launches}")
    for n, o in served.items():
        check(o["axes"].shape == (n, K, 3) and bool(np.isfinite(o["centers"]).all())
              and bool(o["found"].any()), f"bf16 decompose({n})")
    pts16 = torch.from_numpy(requests[16]).to(dev)
    plain_model = build_backbone(plain16, state_dict=state, device=dev)
    cpu_model = build_backbone(cfg16, state_dict=state, device="cpu")
    with torch.inference_mode():
        got = _backbone_forward(sess.served, pts16, k=K, num_sk_points=SK)
        want = _backbone_forward(plain_model, pts16, k=K, num_sk_points=SK)
        cpu = _backbone_forward(cpu_model, torch.from_numpy(requests[1]), k=K,
                                num_sk_points=SK)
        card1 = _backbone_forward(sess.served, torch.from_numpy(requests[1]).to(dev), k=K,
                                  num_sk_points=SK)
        f32_model = build_backbone(cfg, state_dict=state, device=dev)
        f32_heads = _backbone_forward(f32_model, pts16, k=K, num_sk_points=SK)
    errs = {key: {"plain": float((got[key] - want[key]).abs().max()),
                  "cpu": float((card1[key].cpu() - cpu[key]).abs().max()),
                  "vs_fp32": float((got[key] - f32_heads[key]).abs().max())}
            for key in ("x_raw", "w_raw")}
    agree = float((got["labels"] == want["labels"]).float().mean())
    agree_cpu = float((card1["labels"].cpu() == cpu["labels"]).float().mean())
    print(json.dumps({"phase": "13c", "heads_max_abs_err": errs, "atol": BF16_HEADS_ATOL,
                      "label_agreement": {"plain": agree, "cpu": agree_cpu}}), flush=True)
    check(max(max(e["plain"], e["cpu"]) for e in errs.values()) <= BF16_HEADS_ATOL,
          f"bf16 heads against the all-plain path and the CPU: {errs}")
    check(agree >= 0.999 and agree_cpu >= 0.999,
          f"bf16 labels agree on {agree} (plain), {agree_cpu} (CPU) of points")
    check(min(e["vs_fp32"] for e in errs.values()) > 0, "bf16 heads equal float32 heads")
    print(json.dumps({"phase": "13c", "launches": serve_launches, "gemms": 3 * 19,
                      "batch": B, "card": card}), flush=True)
    out["serve_requests"] = serve_launches
    del sess, plain_model, f32_model, cpu_model

    # d. parallel in bf16, one NCCL rank: the data-parallel step bit-equal
    # to the one-process step under deterministic algorithms, the P=1
    # sharded forward bit-equal to Backbone.forward
    inp = parallel_inputs(cfg, dev, root)
    jcfg32 = inp["jcfg"]
    inp = dict(inp, cfg=cfg16, tcfg=tcfg16, jcfg=dataclasses.replace(
        jcfg32, compute_dtype="bfloat16"))
    join("file://" + os.path.join(root, "rdv_bf16"), 1, 0, "nccl")
    try:
        mesh = make_mesh()
        batch = {k: v.to(dev) for k, v in inp["batch"].items()}
        recs = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for name, m in (("single", None), ("single_again", None), ("dp", mesh)):
                    tr = trainer_from(inp, dev, m)
                    aux, launches = counted(lambda: tr.train_step(
                        batch, torch.Generator(dev).manual_seed(7)))
                    recs[name], recs[name + "_launches"] = step_record([tr.model], aux), launches
                    del tr
            finally:
                torch.use_deterministic_algorithms(False)
        check(bit_equal_steps(recs["single_again"], recs["single"]),
              "13d: the one-process bf16 step does not repeat itself bit for bit")
        check(bit_equal_steps(recs["dp"], recs["single"]),
              "13d: the world-1 data-parallel bf16 step differs from the one-process step")
        check(recs["dp_launches"] == recs["single_launches"] == per_step,
              f"13d: launches {recs['dp_launches']} vs {recs['single_launches']}")
        model = build_backbone(cfg16, state_dict=inp["serve_state"], device=dev)
        pts = inp["pts"].to(dev)
        with torch.inference_mode():
            want = model(pts)
        got, sharded_launches = counted(
            lambda: backbone_apply_point_sharded(mesh, model, cfg16, pts))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "13d: the P=1 sharded bf16 forward differs from Backbone.forward")
        check(sharded_launches == PER_SHARDED_FORWARD_P1,
              f"13d: sharded bf16 forward launched {sharded_launches}")
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps({"phase": "13d", "world": 1, "backend": "nccl",
                      "dp_step_bit_equal": True, "sharded_forward_bit_equal": True,
                      "dp_launches": recs["dp_launches"],
                      "sharded_launches": sharded_launches}), flush=True)
    out["dp_step"], out["sharded_forward"] = recs["dp_launches"], sharded_launches
    del model, recs

    # e. one joint step with a bf16 backbone against the all-plain bf16 step
    def joint_step(name: str) -> dict:
        """One joint step from phase 12's nets and batch: the backbone in
        bf16 on the kernels ("card") or all plain ("plain"), or float32."""
        jcfg = inp["jcfg"] if name != "fp32" else jcfg32
        nets = train_joint.build_nets(jcfg, cfg.num_points, K, False, False, dev)
        if name == "plain":
            nets = (Backbone(dataclasses.replace(
                nets[0].cfg, fps_impl="plain", ballquery_impl="plain", knn_impl="plain",
                dense_impl="plain")).to(dev), *nets[1:])
        for net, st in zip(nets, inp["joint_states"]):
            net.load_state_dict(st, strict=True)
        tr = train_joint.JointTrainer(*nets, jcfg, num_sk_points=SK, is_pc_train=True,
                                      is_im_train=True, with_im_loss=True)
        aux, launches = counted(lambda: tr.train_step(batch, torch.Generator(dev).manual_seed(7)))
        check(all(np.isfinite(float(v)) for v in aux.values()), f"13e: {name} joint losses")
        return {"record": step_record([tr.backbone], aux), "launches": launches}

    jrec = {name: joint_step(name) for name in ("card", "plain", "fp32")}
    check(jrec["card"]["launches"] == per_step, f"13e: joint launches {jrec['card']['launches']}")
    lowp_step_check("13e joint step", *(jrec[n]["record"] for n in ("card", "plain", "fp32")))
    print(json.dumps({"phase": "13e", "launches": jrec["card"]["launches"]}), flush=True)
    out["joint_step"] = jrec["card"]["launches"]
    print(json.dumps({"phase": "13", "phase13_s": time.perf_counter() - t_phase}), flush=True)
    return out


# ---- phase 14: captured steps -------------------------------------------------

GRAPH_REPLAYS = 10  # replays of each Trainer A configuration held against eager steps


def wrapper_calls(graphs) -> int:
    """Calls of a captured step that ran the kernels' wrappers, so counted
    their launches: each shape's eager first call and its capture. A
    replay launches the captured kernels and no wrapper."""
    return graphs.eager_calls + graphs.captures


def state_tensors(trainer) -> dict:
    """Every tensor of Trainer A's state: the model's parameters and
    buffers, Adam's moments, the step count."""
    out = dict(trainer.model.state_dict())
    for i, st in enumerate(trainer.optimizer.state.values()):
        out[f"exp_avg.{i}"] = st["exp_avg"]
        out[f"exp_avg_sq.{i}"] = st["exp_avg_sq"]
    out["step"] = trainer.step
    return out


def counts_now() -> dict:
    return {name: c.launches for name, c in kernel_counters().items()}


def step_errors(got_aux: dict, want_aux: dict, got_nets, want_nets) -> dict:
    """A step of ``got_nets`` against the same step of ``want_nets`` from
    the same state and draws: the loss (relative), the gradients of every
    net that has them by phase 5's rule (over its tolerance) and the
    buffers, BN statistics among them (absolute)."""
    loss = abs(float(got_aux["total"]) - float(want_aux["total"])) / max(
        abs(float(want_aux["total"])), 1e-30)
    got = {f"{i}.{n}": p.grad for i, net in enumerate(got_nets)
           for n, p in net.named_parameters() if p.grad is not None}
    want = {f"{i}.{n}": p.grad for i, net in enumerate(want_nets)
            for n, p in net.named_parameters() if p.grad is not None}
    check(set(got) == set(want), "the two steps' gradients are of other parameters")
    grads = grad_rule_ratio(got, want) if want else (0.0, "")
    bn = max(float((a.double() - b.double()).abs().max())
             for ga, wa in zip(got_nets, want_nets)
             for a, b in zip(ga.buffers(), wa.buffers()))
    return {"loss_rel": loss, "grad_over_rule": grads[0], "grad_worst": grads[1],
            "bn_abs": bn, "skipped": [float(got_aux["skipped"]), float(want_aux["skipped"])]}


def hold_step(label: str, err: dict) -> None:
    check(err["loss_rel"] <= 1e-5, f"{label}: loss differs by {err['loss_rel']} (relative)")
    check(err["grad_over_rule"] <= 1.0,
          f"{label}: gradient of {err['grad_worst']} at {err['grad_over_rule']} x the rule")
    check(err["bn_abs"] <= 1e-5, f"{label}: BN statistics differ by {err['bn_abs']}")
    check(err["skipped"][0] == err["skipped"][1], f"{label}: skipped {err['skipped']}")


def host_launches(prof) -> dict:
    """The host's launch calls in a trace: kernel launches
    (``cudaLaunchKernel*``, ``cuLaunch*``) and graph launches."""
    counts = {"kernels": 0, "graphs": 0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if "GraphLaunch" in e.key:
            counts["graphs"] += e.count
        elif "LaunchKernel" in e.key or e.key.startswith("cuLaunch"):
            counts["kernels"] += e.count
    return counts


def traced_calls(fn, calls: int = 3) -> dict:
    """Per call of ``fn`` over ``calls`` traced calls: the device's time
    (kernels and copies, ms), its operations, and the host's kernel and
    graph launches."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    launches = host_launches(prof)
    return {"device_ms": sum(e.self_device_time_total for e in on_card) / 1e3 / calls,
            "device_ops": sum(e.count for e in on_card) / calls,
            "host_kernel_launches": launches["kernels"] / calls,
            "host_graph_launches": launches["graphs"] / calls}


def in_turns(fns: dict, rounds: int) -> dict:
    """Median ms of a call of each of ``fns`` (the host's clock around a
    call that ends in a synchronise), called in turns a, b, b, a."""
    names = list(fns)
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(v) for name, v in times.items()}


def graphs_phase(args, card: str, dev, root: str) -> dict:
    """Phase 14: Trainer A's step, the serving buckets and the evaluator's
    step as captured CUDA graphs against their eager steps, and
    ``SetAbstractionMsg`` on the card. Returns each hand kernel's
    launches inside replays, by captured step."""
    import warnings

    from point2cyl_torch.core.config import EvalConfig, TrainConfig
    from point2cyl_torch.data.pipeline import InputPipeline
    from point2cyl_torch.data.synthetic import generate_dataset
    from point2cyl_torch.eval import evaluator
    from point2cyl_torch.models.backbone import SetAbstractionMsg, build_backbone
    from point2cyl_torch.models.implicit import ImplicitNet, PointNetEncoder
    from point2cyl_torch.serve.export import export_artifact
    from point2cyl_torch.serve.session import InferenceSession
    from point2cyl_torch.train import steps, train_pc
    from point2cyl_torch.train.train_pc import build_model, build_pipeline

    t_phase = time.perf_counter()
    memory_at_start = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
                       "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    cfg = full_width_config(8192)
    tcfg = TrainConfig(batch_size=TB, pred_seg=True, pred_normal=True, pred_bb=True,
                       pred_extrusion=True, pred_center=True, seed=0)
    served = ("fps", "ball_query_grouped", "sa_grouped_exact", "three_nn")
    trained = served + ("sa_grouped_backward", "three_nn_backward")
    graph_launches = {}

    # a. Trainer A: the captured step (first call eager, then replays)
    # against the eager step from the same state and seed, each step; then
    # both under deterministic algorithms, bit for bit without resyncing
    for c in kernel_counters().values():
        c.launches = 0
    pairs, batches, captured = {}, {}, {}
    for k, dtype in ((8, "float32"), (10, "float32"), (8, "bfloat16"), (10, "bfloat16")):
        kcfg = dataclasses.replace(tcfg, compute_dtype=dtype)
        graph_tr = steps.Trainer(build_model(kcfg, cfg.num_points, k, dev), kcfg)
        eager_tr = steps.Trainer(build_model(kcfg, cfg.num_points, k, dev), kcfg,
                                 graph=False)
        if k not in batches:
            pipe = build_pipeline(kcfg, cfg.num_points, k, dev, synthetic=16)
            gen = torch.Generator(dev).manual_seed(k)
            batches[k] = [pipe.batch(torch.arange(i * TB, (i + 1) * TB, device=dev) % 16,
                                     gen) for i in range(GRAPH_REPLAYS + 1)]
        worst = {"loss_rel": 0.0, "grad_over_rule": 0.0, "bn_abs": 0.0}
        for i, batch in enumerate(batches[k]):
            eager_tr.load_state_dict(graph_tr.state_dict())
            g_graph = torch.Generator(dev).manual_seed(1000 + i)
            g_eager = torch.Generator(dev).manual_seed(1000 + i)
            before = counts_now()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = graph_tr.train_step(batch, g_graph)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3
            if i == 1:  # the capture: the wrappers run once, inside it
                after = counts_now()
                captured[(k, dtype)] = {name: after[name] - before[name] for name in after}
                capture_ms = call_ms
            want = eager_tr.train_step(batch, g_eager)
            check(torch.equal(g_graph.get_state(), g_eager.get_state()),
                  f"14a K={k} {dtype} step {i}: the generators advanced differently")
            err = step_errors(got, want, [graph_tr.model], [eager_tr.model])
            hold_step(f"14a K={k} {dtype} step {i}", err)
            for key in worst:
                worst[key] = max(worst[key], err[key])
        g = graph_tr.graphs
        check(g.eager_calls == 1 and g.captures == 1 and g.replays == GRAPH_REPLAYS,
              f"14a K={k} {dtype}: {g.eager_calls} eager, {g.captures} captures, "
              f"{g.replays} replays")
        check(all(captured[(k, dtype)][name] >= 1 for name in trained),
              f"14a K={k} {dtype}: the capture launched {captured[(k, dtype)]}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                det_g = steps.Trainer(build_model(kcfg, cfg.num_points, k, dev), kcfg)
                det_e = steps.Trainer(build_model(kcfg, cfg.num_points, k, dev), kcfg,
                                      graph=False)
                bit_equal = []
                for i in range(3):
                    a = det_g.train_step(batches[k][i], torch.Generator(dev).manual_seed(7 + i))
                    b = det_e.train_step(batches[k][i], torch.Generator(dev).manual_seed(7 + i))
                    sa, sb = state_tensors(det_g), state_tensors(det_e)
                    bit_equal.append(all(torch.equal(a[n], b[n]) for n in a)
                                     and all(torch.equal(sa[n], sb[n]) for n in sa))
                check(det_g.graphs.replays == 2 and all(bit_equal),
                      f"14a K={k} {dtype}: deterministic replays vs eager steps bit-equal "
                      f"{bit_equal} (eager, capture, replay)")
                del det_g, det_e
            finally:
                torch.use_deterministic_algorithms(False)
        pairs[(k, dtype)] = (graph_tr, eager_tr)
        print(json.dumps({"phase": "14a", "K": k, "compute_dtype": dtype,
                          "replays": g.replays, "worst": worst,
                          "capture_call_ms": capture_ms,
                          "deterministic_bit_equal": bit_equal,
                          "wrapper_launches_in_capture": captured[(k, dtype)]}),
              flush=True)
    main_path = counts_now()
    check(all(main_path[name] > 0 for name in trained),
          f"14a: the captured steps' run launched {main_path}")

    # b. a non-finite batch (NaN normals, which the forward never reads):
    # the replay keeps every state tensor bit for bit, and the next replay
    # matches the eager step
    graph_tr, eager_tr = pairs[(8, "float32")]
    before = {n: v.clone() for n, v in state_tensors(graph_tr).items()}
    bad = dict(batches[8][0], normals=torch.full_like(batches[8][0]["normals"], float("nan")))
    aux = graph_tr.train_step(bad, torch.Generator(dev).manual_seed(3000))
    kept = all(torch.equal(v, before[n]) for n, v in state_tensors(graph_tr).items())
    check(float(aux["skipped"]) == 1.0 and kept and graph_tr.graphs.captures == 1,
          f"14b: skipped {float(aux['skipped'])}, state kept {kept}")
    eager_tr.load_state_dict(graph_tr.state_dict())
    err = step_errors(graph_tr.train_step(batches[8][1], torch.Generator(dev).manual_seed(3001)),
                      eager_tr.train_step(batches[8][1], torch.Generator(dev).manual_seed(3001)),
                      [graph_tr.model], [eager_tr.model])
    hold_step("14b next replay", err)
    print(json.dumps({"phase": "14b", "skipped": 1.0, "state_bit_equal": kept,
                      "next_replay": err}), flush=True)

    # f (the train step's part). In turns, captured against eager: ms a
    # step of each configuration, the device's busy share and the host's
    # kernel and graph launches a step (a trace)
    for (k, dtype), (g_tr, e_tr) in pairs.items():
        batch, gen = batches[k][2], torch.Generator(dev).manual_seed(4000)
        ms = in_turns({"graph": lambda: g_tr.train_step(batch, gen),
                       "eager": lambda: e_tr.train_step(batch, gen)}, 5)
        row = {"graph_ms": ms["graph"], "eager_ms": ms["eager"]}
        if dtype == "float32":
            for name, tr in (("graph", g_tr), ("eager", e_tr)):
                tr_calls = traced_calls(lambda: tr.train_step(batch, gen))
                row[name] = {**tr_calls, "busy_share": tr_calls["device_ms"] / ms[name]}
        print(json.dumps({"phase": "14f", "rate": "train step", "K": k,
                          "compute_dtype": dtype, "batch": TB, "num_points": cfg.num_points,
                          **row, "card": card}), flush=True)
    graph_launches["train_step"] = {name: count * graph_tr.graphs.replays
                                    for name, count in captured[(8, "float32")].items()}
    state = graph_tr.model.state_dict()
    del pairs, graph_tr, eager_tr, g_tr, e_tr, tr

    # c. serving: buckets 1, 4 and 16 and a 37-cloud request (three chunks
    # of bucket 16) with and without latents, each request three times
    # (eager, capture, replay) against the eager session, bit for bit
    enc = PointNetEncoder(256, 2, with_normals=True)
    enc.reset_parameters(torch.Generator().manual_seed(14))
    arts = {"geometry": os.path.join(root, "g14_geo.p2ct"),
            "latents": os.path.join(root, "g14_lat.p2ct")}
    export_artifact(arts["geometry"], state, k=K, backbone_config=cfg, buckets=(1, 4, 16),
                    num_sk_points=SK)
    export_artifact(arts["latents"], state, k=K, backbone_config=cfg, buckets=(1, 4, 16),
                    num_sk_points=SK, encoder_state_dict=enc.state_dict())
    requests = {n: clouds(140 + n, n, cfg.num_points) for n in (1, 4, 16, 37)}
    sessions, fold_err = {}, {}
    folded_layers = {"geometry": 17, "latents": 22}
    for c in kernel_counters().values():
        c.launches = 0
    for kind, path in arts.items():
        sess, eager = InferenceSession(path), InferenceSession(path, graph=False)
        sessions[kind] = (sess, eager)
        for n, pts in requests.items():
            want = eager.decompose(pts)
            for call in ("eager", "capture", "replay"):
                got = sess.decompose(pts)
                same = all(np.array_equal(got[key], want[key]) for key in want)
                check(same, f"14c {kind}: decompose({n}) {call} differs from the eager "
                      "session")
        raw = sess.predict(requests[37], assemble=False)
        raw = sess.predict(requests[37], assemble=False)
        want = eager.predict(requests[37], assemble=False)
        check(all(np.array_equal(raw[key], want[key]) for key in want),
              f"14c {kind}: predict(37) raw heads differ from the eager session")
        g = sess._graphs[0]
        check(g.captures == 4 and g.replays > 0, f"14c {kind}: {g.captures} captures")
        # the captured folded replica against the unfolded modules it was
        # folded from: raw heads of a bucket-16 request, and latents of
        # seeded sketches
        check(sess.stats["folded_layers"] == folded_layers[kind]
              and sess.stats["unfolded_layers"] == 0,
              f"14c {kind}: the session folded {sess.stats['folded_layers']} layers")
        raw = sess.predict(requests[16], assemble=False)
        with torch.inference_mode():
            heads = sess.model(torch.from_numpy(requests[16]).to(dev))
            fold_err[kind] = {key: float(np.abs(raw[key] - h.cpu().numpy()).max())
                              for key, h in zip(("x_raw", "w_raw"), heads)}
            if sess.encoder is not None:
                sk = torch.randn(128, SK, 4, device=dev,
                                 generator=torch.Generator(dev).manual_seed(15))
                fold_err[kind]["latents"] = float(
                    (sess.served_encoder(sk) - sess.encoder(sk)).abs().max())
        check(max(fold_err[kind].values()) <= FOLD_ATOL,
              f"14c {kind}: the folded replica against the unfolded modules: "
              f"{fold_err[kind]}")
    serve_counts = counts_now()
    check(all(serve_counts[name] > 0 for name in served),
          f"14c: the captured requests launched {serve_counts}")
    print(json.dumps({"phase": "14c", "requests": list(requests), "bit_equal": True,
                      "with_latents": [False, True], "launches": serve_counts,
                      "folded_layers": folded_layers,
                      "fold_max_abs_err": fold_err, "fold_atol": FOLD_ATOL}), flush=True)

    # f (the buckets' part). In turns, captured against eager:
    # decompositions a second at buckets 1, 4 and 16 with and without
    # latents, the device's busy share and the host's launches at bucket
    # 16 (a trace) and the capture's ms
    sess16 = InferenceSession(arts["geometry"])  # bucket 16 only: its replays are bucket 16's
    sess16.decompose(requests[16])
    before = counts_now()
    t0 = time.perf_counter()
    sess16.decompose(requests[16])  # the capture
    serve_capture_ms = (time.perf_counter() - t0) * 1e3
    after = counts_now()
    serve_captured = {name: after[name] - before[name] for name in after}
    for kind, (sess, eager) in sessions.items():
        for b in (1, 4, 16):
            pts = clouds(150 + b, b, cfg.num_points)
            graph_sess = sess16 if (kind, b) == ("geometry", 16) else sess
            ms = in_turns({"graph": lambda: graph_sess.decompose(pts),
                           "eager": lambda: eager.decompose(pts)}, 5)
            row = {"graph_decompositions_per_s": b * 1e3 / ms["graph"],
                   **({"capture_call_ms": serve_capture_ms} if graph_sess is sess16 else {}),
                   "eager_decompositions_per_s": b * 1e3 / ms["eager"],
                   "graph_ms": ms["graph"], "eager_ms": ms["eager"]}
            if b == 16:
                for name, s in (("graph", graph_sess), ("eager", eager)):
                    s_calls = traced_calls(lambda: s.decompose(pts))
                    row[name] = {**s_calls, "busy_share": s_calls["device_ms"] / ms[name]}
            print(json.dumps({"phase": "14f", "rate": "decompose", "artifact": kind,
                              "bucket": b, **row, "card": card}), flush=True)
    graph_launches["serve_bucket16"] = {name: count * sess16._graphs[0].replays
                                        for name, count in serve_captured.items()}
    del sessions, sess, eager, sess16, graph_sess, s

    # d. evaluate() on 14a's K=8 weights, captured against eager, without
    # and with the implicit stack
    eval_model = build_backbone(cfg, state_dict=state, device=dev)
    pipe = InputPipeline(generate_dataset(16, resolution=cfg.num_points, max_instances=K,
                                          num_sketch_points=SK, seed=2), cfg.num_points, K,
                         dev)
    eval_batches = list(pipe.epochs(TB, torch.Generator(dev).manual_seed(0),
                                    shuffle=False))
    implicit = ImplicitNet(d_in=258)
    implicit.reset_parameters(torch.Generator().manual_seed(15))
    encoder = PointNetEncoder(256, 2, with_normals=True)
    encoder.reset_parameters(torch.Generator().manual_seed(16))
    implicit, encoder = implicit.to(dev), encoder.to(dev)
    quiet = lambda msg: None  # noqa: E731
    eval_cfg = EvalConfig(num_sketch_samples=SK)
    eval_errs = {}
    for mode, stack in (("no_implicit", {}), ("implicit",
                                              {"implicit": implicit, "encoder": encoder})):
        got = evaluator.evaluate(eval_model, eval_batches, eval_cfg, TB, log=quiet, **stack)
        want = evaluator.evaluate(eval_model, eval_batches, eval_cfg, TB, log=quiet,
                                  graph=False, **stack)
        eval_errs[mode] = {name: abs(got[name] - want[name]) for name in want}
        tol = {**EVAL_ATOL, **(EVAL_FIT_ATOL if stack else {})}
        for name, atol in tol.items():
            check(eval_errs[mode][name] <= atol, f"14d {mode}: {name} captured "
                  f"{got[name]} vs eager {want[name]}, tolerance {atol}")
    print(json.dumps({"phase": "14d", "batches": len(eval_batches), "abs_err": eval_errs}),
          flush=True)

    # e. Trainer A's CLI on the captured path: 2 epochs, then a resume
    logdir = os.path.join(root, "g14_cli")
    argv = ["--synthetic", "8", "--num_point", str(cfg.num_points), "--K", str(K),
            "--batch_size", str(TB), "--logdir", logdir, "--pred_seg", "--pred_normal",
            "--pred_bb", "--pred_extrusion", "--pred_center"]
    done = train_pc.cli_main(argv + ["--num_epochs", "2"])
    resumed = train_pc.cli_main(argv + ["--num_epochs", "3", "--resume"])
    losses = logged_losses(logdir)
    with open(os.path.join(logdir, "log.txt")) as f:
        log = f.read()
    check(int(done.step) == 4 and int(resumed.step) == 6 and "epoch 2, step 4" in log
          and done.graphs.replays == 3 and resumed.graphs.captures == 1
          and losses and all(np.isfinite(losses)),
          f"14e: steps {int(done.step)}, {int(resumed.step)}, replays "
          f"{done.graphs.replays}, losses {losses}")
    print(json.dumps({"phase": "14e", "steps": [int(done.step), int(resumed.step)],
                      "replays": [done.graphs.replays, resumed.graphs.replays],
                      "losses": losses}), flush=True)
    del done, resumed

    # f (the eval step's part; the train step's and the buckets' follow b
    # and c). In turns, captured against eager: ms an eval step, the
    # device's busy share and the host's launches a step (a trace),
    # clouds a second of evaluate() over 16 batches
    eval_rows = {}
    for mode, stack in (("no_implicit", {}), ("implicit",
                                              {"implicit": implicit, "encoder": encoder})):
        step_g = evaluator.make_eval_step(eval_model, eval_cfg, SK, **stack)
        step_e = evaluator.make_eval_step(eval_model, eval_cfg, SK, graph=False, **stack)
        gen = torch.Generator(dev).manual_seed(0)
        step_g(eval_batches[0], gen)
        before = counts_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_g(eval_batches[0], gen)  # the capture
        torch.cuda.synchronize()
        eval_capture_ms = (time.perf_counter() - t0) * 1e3
        after = counts_now()
        ms = in_turns({"graph": lambda: step_g(eval_batches[0], gen),
                       "eager": lambda: step_e(eval_batches[0], gen)}, 5)
        sweep = in_turns({
            "graph": lambda: evaluator.evaluate(eval_model, eval_batches * 4, eval_cfg, TB,
                                                log=quiet, **stack),
            "eager": lambda: evaluator.evaluate(eval_model, eval_batches * 4, eval_cfg, TB,
                                                log=quiet, graph=False, **stack)}, 1)
        row = {"graph_step_ms": ms["graph"], "eager_step_ms": ms["eager"],
               "graph_clouds_per_s": 16 * TB * 1e3 / sweep["graph"],
               "eager_clouds_per_s": 16 * TB * 1e3 / sweep["eager"],
               "capture_call_ms": eval_capture_ms}
        for name, step in (("graph", step_g), ("eager", step_e)):
            s_calls = traced_calls(lambda: step(eval_batches[0], gen))
            row[name] = {**s_calls, "busy_share": s_calls["device_ms"] / ms[name]}
        if mode == "no_implicit":
            graph_launches["eval_step"] = {name: (after[name] - before[name])
                                           * step_g.graphs.replays for name in after}
        eval_rows[mode] = row
        print(json.dumps({"phase": "14f", "rate": "eval", "mode": mode, "batch": TB,
                          "num_points": cfg.num_points, "sweep_clouds": 16 * TB, **row,
                          "card": card}), flush=True)

    # g. SetAbstractionMsg at the reference classifier's first stage
    # (npoint 512, radii 0.1/0.2/0.4, nsamples 16/32/64) on a 1024-point
    # cloud, B=4: the FPS and idx-only ball-query kernels against the
    # plain versions, eval and train mode
    msg_args = (0, 512, (0.1, 0.2, 0.4), (16, 32, 64), ((32, 32, 64), (64, 64, 128),
                                                         (64, 96, 128)))
    msg = SetAbstractionMsg(*msg_args)
    msg.reset_parameters(torch.Generator().manual_seed(17))
    plain_msg = SetAbstractionMsg(*msg_args, fps_impl="plain", ballquery_impl="plain")
    plain_msg.load_state_dict(msg.state_dict())
    msg, plain_msg = msg.to(dev), plain_msg.to(dev)
    xyz = torch.from_numpy(clouds(18, TB, 1024)).to(dev)
    start = torch.tensor([3, 100, 500, 1023], device=dev)
    with torch.inference_mode():
        (got_xyz, got), launched = counted(lambda: msg(xyz, None))
        want_xyz, want = plain_msg(xyz, None)
        (tr_xyz, tr_f) = msg(xyz, None, train=True, momentum=0.5, start=start)
        (ptr_xyz, ptr_f) = plain_msg(xyz, None, train=True, momentum=0.5, start=start)
        msg_ms = time_ms(lambda: msg(xyz, None))
        plain_ms = time_ms(lambda: plain_msg(xyz, None))
    msg_err = max(float((got - want).abs().max()), float((tr_f - ptr_f).abs().max()))
    check(torch.equal(got_xyz, want_xyz) and torch.equal(tr_xyz, ptr_xyz)
          and msg_err <= 1e-5 and got.shape == (TB, 512, 64 + 128 + 128),
          f"14g: MSG centres equal {torch.equal(got_xyz, want_xyz)}, features {msg_err}")
    check(launched["fps"] == 1 and launched["ball_query"] == 3
          and sum(launched.values()) == 4, f"14g: MSG launched {launched}")
    print(json.dumps({"phase": "14g", "msg": "B=4 N=1024 npoint 512", "max_abs_err": msg_err,
                      "launches": launched, "ms": msg_ms, "plain_ms": plain_ms,
                      "card": card}), flush=True)
    print(json.dumps({"phase": "14", "phase14_s": time.perf_counter() - t_phase,
                      "memory_at_start": memory_at_start}), flush=True)
    return graph_launches



# ---- phase 15: captured steps II ----------------------------------------------

JOINT_REPLAYS = 10  # replays of each joint configuration held against eager steps


def joint_state(tr) -> dict:
    """Every tensor of a joint trainer's state: the four nets' parameters
    and buffers, each Adam group's moments and count, the step."""
    out = {f"{name}.{k}": v for name in ("backbone", "implicit", "encoder", "loaded_encoder")
           for k, v in getattr(tr, name).state_dict().items()}
    for g in tr._groups:
        out[f"{g.name}.moments"], out[f"{g.name}.count"] = g.moments, g.count
    out["step"] = tr.step
    return out


def pretrain_state(tr) -> dict:
    """Every tensor of a pretrainer's state: both nets, Adam's moments,
    the step."""
    out = {f"{name}.{k}": v for name in ("implicit", "encoder")
           for k, v in getattr(tr, name).state_dict().items()}
    out["moments"], out["step"] = tr._moments, tr.step
    return out


def copy_state(dst: dict, src: dict) -> None:
    """``src``'s values into ``dst``'s tensors, in place."""
    with torch.no_grad():
        for name, val in src.items():
            dst[name].copy_(val)


def same_state(a: dict, b: dict) -> bool:
    return all(torch.equal(a[n], b[n]) for n in a)


def fold_worst(worst: dict, err: dict) -> None:
    for key in ("loss_rel", "grad_over_rule", "bn_abs"):
        worst[key] = max(worst.get(key, 0.0), err[key])


def held_pairs(label: str, graph_tr, eager_tr, state_of, nets_of, batches, seed: int,
               worst: dict) -> tuple[dict, float]:
    """Each batch through the captured owner and through the eager one
    from the same state (copied in place before each step) and a generator
    of the same seed, held by ``hold_step``'s rules; the kernels' launches
    in the capture (the second call) and the capture call's ms."""
    captured, capture_ms = {}, 0.0
    for i, batch in enumerate(batches):
        copy_state(state_of(eager_tr), state_of(graph_tr))
        g_graph = torch.Generator(graph_tr.graphs.device).manual_seed(seed + i)
        g_eager = torch.Generator(graph_tr.graphs.device).manual_seed(seed + i)
        before = counts_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = graph_tr.train_step(batch, g_graph)
        torch.cuda.synchronize()
        if i == 1:
            after = counts_now()
            captured = {name: after[name] - before[name] for name in after}
            capture_ms = (time.perf_counter() - t0) * 1e3
        want = eager_tr.train_step(batch, g_eager)
        check(torch.equal(g_graph.get_state(), g_eager.get_state()),
              f"{label} step {i}: the generators advanced differently")
        err = step_errors(got, want, nets_of(graph_tr), nets_of(eager_tr))
        hold_step(f"{label} step {i}", err)
        fold_worst(worst, err)
    g = graph_tr.graphs
    check(g.eager_calls == 1 and g.captures == 1 and g.replays == len(batches) - 1,
          f"{label}: {g.eager_calls} eager, {g.captures} captures, {g.replays} replays")
    return captured, capture_ms


def bit_equal_runs(makers, batches, steps_: int, state_of) -> list[bool]:
    """Owners from ``makers`` (the first captured), ``steps_`` steps each
    under deterministic algorithms on the same batches and seeds, without
    resyncing: each step's outputs and the whole states of the others bit
    for bit equal to the first's."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            owners = [make() for make in makers]
            same = []
            for i in range(steps_):
                dev = owners[0].graphs.device
                outs = [tr.train_step(batches[i], torch.Generator(dev).manual_seed(70 + i))
                        for tr in owners]
                states = [state_of(tr) for tr in owners]
                same.append(all(all(torch.equal(outs[0][n], out[n]) for n in out)
                                and same_state(states[0], st)
                                for out, st in zip(outs[1:], states[1:])))
            check(owners[0].graphs.replays == steps_ - 1,
                  f"deterministic runs: {owners[0].graphs.replays} replays")
            return same
        finally:
            torch.use_deterministic_algorithms(False)


def timed_owner(label: str, graph_fn, eager_fn, capture_ms: float,
                card: str, rounds: int = 3, per: int = 1, trace=None) -> dict:
    """In turns, captured against eager: ms a step (``per`` steps a call),
    beside the capture call's ms; with ``trace``
    (the captured and the eager call to trace, and the steps in each) the
    device's busy share and the host's kernel and graph launches a step,
    from a trace of two calls. Printed as a 15f line."""
    ms = in_turns({"graph": graph_fn, "eager": eager_fn}, rounds)
    row = {"graph_ms": ms["graph"] / per, "eager_ms": ms["eager"] / per,
           "capture_call_ms": capture_ms}
    if trace is not None:
        *fns, steps_ = trace
        for name, fn in zip(("graph", "eager"), fns):
            calls = traced_calls(fn, calls=2)
            row[name] = {key: val / steps_ for key, val in calls.items()}
            row[name]["busy_share"] = row[name]["device_ms"] / row[f"{name}_ms"]
    print(json.dumps({"phase": "15f", "step": label, **row, "card": card}), flush=True)
    return row


def graphs2_phase(args, card: str, dev, root: str) -> dict:
    """Phase 15: the joint and pretrain steps, the world-1 NCCL
    data-parallel Trainer A and joint steps and reconstruction's
    fine-tune step as captured CUDA graphs against their eager steps.
    Returns each hand kernel's launches inside replays of the joint step
    and of the data-parallel Trainer A step."""
    from point2cyl_torch.core.config import TrainConfig
    from point2cyl_torch.data.pipeline import InputPipeline
    from point2cyl_torch.data.synthetic import generate_dataset
    from point2cyl_torch.models.implicit import ImplicitNet
    from point2cyl_torch.parallel.distributed import join
    from point2cyl_torch.parallel.mesh import make_mesh
    from point2cyl_torch.recon import reconstruct as recon
    from point2cyl_torch.train import steps, train_joint
    from point2cyl_torch.train.train_pc import build_model, config_from_args, epoch_generator

    t_phase = time.perf_counter()
    cfg = full_width_config(8192)
    n = cfg.num_points
    trained = ("fps", "ball_query_grouped", "sa_grouped_exact", "three_nn",
               "sa_grouped_backward", "three_nn_backward")
    served = trained[:4]
    jargv = ["--synthetic", "8", "--K", str(K), "--batch_size", str(TB), "--num_sk_point",
             str(SK), "--num_point", str(n), "--is_pc_train", "--is_im_train",
             "--with_im_loss", "--pred_seg", "--pred_normal", "--pred_bb",
             "--pred_extrusion", "--pred_center"]
    jcfg = config_from_args(train_joint.build_argparser().parse_args(jargv))
    pipe = InputPipeline(generate_dataset(8, resolution=n, max_instances=K,
                                          num_sketch_points=SK, seed=0),
                         n, K, dev, num_sketch_points=SK)
    gen = epoch_generator(0, 15, dev)
    batches = [pipe.batch(torch.arange(i * TB, (i + 1) * TB, device=dev) % 8, gen)
               for i in range(JOINT_REPLAYS + 1)]
    graph_launches = {}

    def joint(c, is_pc_train: bool, graph: bool, mesh=None):
        nets = train_joint.build_nets(c, n, K, False, False, dev)
        return train_joint.JointTrainer(*nets, c, num_sk_points=SK, is_pc_train=is_pc_train,
                                        is_im_train=True, with_im_loss=True, step=6,
                                        mesh=mesh, graph=graph)

    def joint_nets(tr):
        return [tr.backbone, tr.encoder]

    # a. the joint step, float32 and bf16, with and without --is_pc_train:
    # eleven calls (eager, capture, nine replays) each against the eager
    # step from the same state and seed, then three of each under
    # deterministic algorithms, bit for bit without resyncing; f. then
    # in turns, captured against eager (busy share and launches from a
    # trace for float32 with --is_pc_train). b. With float32 and
    # --is_pc_train, a non-finite batch (NaN normals): the replay keeps
    # every state tensor of both groups bit for bit, and the next replay
    # matches the eager step
    for c in kernel_counters().values():
        c.launches = 0
    for is_pc_train in (True, False):
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(jcfg, compute_dtype=dtype)
            label = f"15a joint pc_train={is_pc_train} {dtype}"
            graph_tr, eager_tr = joint(c, is_pc_train, True), joint(c, is_pc_train, False)
            worst = {}
            captured, capture_ms = held_pairs(label, graph_tr, eager_tr, joint_state,
                                              joint_nets, batches, 1500, worst)
            want = trained if is_pc_train else served
            check(all(captured[name] >= 1 for name in want),
                  f"{label}: the capture launched {captured}")
            det = bit_equal_runs((lambda: joint(c, is_pc_train, True),
                                  lambda: joint(c, is_pc_train, False)), batches, 3,
                                 joint_state)
            check(all(det), f"{label}: deterministic captured vs eager bit-equal {det}")
            print(json.dumps({"phase": "15a", "at_s": time.perf_counter() - t_phase,
                              "is_pc_train": is_pc_train, "compute_dtype": dtype,
                              "replays": graph_tr.graphs.replays, "worst": worst,
                              "capture_call_ms": capture_ms,
                              "deterministic_bit_equal": det,
                              "wrapper_launches_in_capture": captured}), flush=True)
            if (is_pc_train, dtype) == (True, "float32"):
                graph_launches["joint_step"] = {
                    name: count * graph_tr.graphs.replays for name, count in captured.items()}
                before = {k: v.clone() for k, v in joint_state(graph_tr).items()}
                bad = dict(batches[0], normals=torch.full_like(batches[0]["normals"],
                                                               float("nan")))
                aux = graph_tr.train_step(bad, torch.Generator(dev).manual_seed(3000))
                kept = same_state(joint_state(graph_tr), before)
                check(float(aux["skipped"]) == 1.0 and kept and graph_tr.graphs.captures == 1,
                      f"15b: skipped {float(aux['skipped'])}, state kept {kept}")
                copy_state(joint_state(eager_tr), joint_state(graph_tr))
                err = step_errors(
                    graph_tr.train_step(batches[1], torch.Generator(dev).manual_seed(3001)),
                    eager_tr.train_step(batches[1], torch.Generator(dev).manual_seed(3001)),
                    joint_nets(graph_tr), joint_nets(eager_tr))
                hold_step("15b next replay", err)
                print(json.dumps({"phase": "15b", "at_s": time.perf_counter() - t_phase,
                                  "skipped": 1.0, "state_bit_equal": kept, "next_replay": err,
                                  "step": int(graph_tr.step),
                                  "counts": [int(g.count) for g in graph_tr._groups]}),
                      flush=True)
            batch, g = batches[2], torch.Generator(dev).manual_seed(4000)
            graph_fn = lambda: graph_tr.train_step(batch, g)  # noqa: E731
            eager_fn = lambda: eager_tr.train_step(batch, g)  # noqa: E731
            first = (is_pc_train, dtype) == (True, "float32")
            timed_owner(f"joint pc_train={is_pc_train} {dtype}", graph_fn, eager_fn,
                        capture_ms, card,
                        rounds=3 if first else 1,
                        trace=(graph_fn, eager_fn, 1) if first else None)
            del graph_tr, eager_tr
    main_path = counts_now()
    check(all(main_path[name] > 0 for name in trained),
          f"15a: the captured joint steps' run launched {main_path}")

    # c. the pretrain step at B=4 (unchunked, 32 instances) and at B=16 in
    # chunks of 32: captured against eager from the same state and seed,
    # at B=4 also bit for bit under deterministic algorithms; f. then in
    # turns (a trace at B=4)
    def pretrainer(chunk, graph: bool):
        _, implicit, encoder, _ = train_joint.build_nets(jcfg, n, K, False, False, dev)
        return train_joint.ImPretrainer(implicit, encoder, chunk, graph=graph)

    def pre_nets(tr):
        return [tr.implicit, tr.encoder]

    batches16 = [pipe.batch(torch.arange(16, device=dev) % 8, gen) for _ in range(3)]
    for b, chunk, bs in ((TB, None, batches[:5]), (16, 32, batches16)):
        label = f"15c pretrain B={b} chunk {chunk}"
        graph_tr, eager_tr = pretrainer(chunk, True), pretrainer(chunk, False)
        worst = {}
        _, capture_ms = held_pairs(label, graph_tr, eager_tr, pretrain_state, pre_nets, bs,
                                   1600, worst)
        det = (bit_equal_runs((lambda: pretrainer(chunk, True),
                               lambda: pretrainer(chunk, False)), bs, 3, pretrain_state)
               if b == TB else None)
        check(det is None or all(det), f"{label}: deterministic bit-equal {det}")
        print(json.dumps({"phase": "15c", "at_s": time.perf_counter() - t_phase,
                          "batch": b, "igr_chunk": chunk, "replays": graph_tr.graphs.replays,
                          "worst": worst,
                          "capture_call_ms": capture_ms, "deterministic_bit_equal": det}),
              flush=True)
        batch, g = bs[2], torch.Generator(dev).manual_seed(4200)
        graph_fn = lambda: graph_tr.train_step(batch, g)  # noqa: E731
        eager_fn = lambda: eager_tr.train_step(batch, g)  # noqa: E731
        timed_owner(f"pretrain B={b}", graph_fn, eager_fn, capture_ms, card, rounds=3 if b == TB else 1,
                    trace=(graph_fn, eager_fn, 1) if b == TB else None)
        del graph_tr, eager_tr

    # d. one rank over NCCL, world 1: the data-parallel Trainer A and joint
    # steps captured against their eager steps (four calls) and against
    # the one-process captured step (two), from the same state and seed; then
    # bit for bit under deterministic algorithms (captured, eager,
    # one-process captured)
    tcfg = TrainConfig(batch_size=TB, pred_seg=True, pred_normal=True, pred_bb=True,
                       pred_extrusion=True, pred_center=True, seed=0)
    join("file://" + os.path.join(root, "rdv_graphs"), 1, 0, "nccl")
    try:
        mesh = make_mesh()

        def trainer_a(graph: bool, m=mesh):
            return steps.Trainer(build_model(tcfg, n, K, dev), tcfg, m, graph=graph)

        for c in kernel_counters().values():
            c.launches = 0
        owners = {
            "trainer_a": (lambda graph, m=mesh: trainer_a(graph, m), state_tensors,
                          lambda tr: [tr.model]),
            "joint": (lambda graph, m=mesh: joint(jcfg, True, graph, m), joint_state,
                      joint_nets)}
        for name, (make, state_of, nets_of) in owners.items():
            label = f"15d {name} world 1"
            dp_g, dp_e, one_g = make(True), make(False), make(True, None)
            check(dp_g.graphs.enabled and dp_g.graphs.capture_error_mode == "thread_local",
                  f"{label}: the NCCL step is not captured")
            worst, worst_one = {}, {}
            captured, capture_ms = held_pairs(label, dp_g, dp_e, state_of, nets_of,
                                              batches[:4], 1700, worst)
            if name == "trainer_a":
                graph_launches["dp_train_step"] = {k: v * dp_g.graphs.replays
                                                   for k, v in captured.items()}
            # the data-parallel replay against the one-process replay
            for i, batch in enumerate(batches[:2]):
                copy_state(state_of(one_g), state_of(dp_g))
                err = step_errors(
                    dp_g.train_step(batch, torch.Generator(dev).manual_seed(1800 + i)),
                    one_g.train_step(batch, torch.Generator(dev).manual_seed(1800 + i)),
                    nets_of(dp_g), nets_of(one_g))
                hold_step(f"{label} vs one process, step {i}", err)
                fold_worst(worst_one, err)
            replays = dp_g.graphs.replays
            batch, g = batches[2], torch.Generator(dev).manual_seed(4100)
            graph_fn = lambda: dp_g.train_step(batch, g)  # noqa: E731
            eager_fn = lambda: dp_e.train_step(batch, g)  # noqa: E731
            timed_owner(f"{name} data parallel, world 1", graph_fn, eager_fn,
                        capture_ms, card,
                        trace=(graph_fn, eager_fn, 1))
            del dp_g, dp_e, one_g
            # captured, eager, and the one-process captured step
            det = bit_equal_runs((lambda: make(True), lambda: make(False),
                                  lambda: make(True, None)), batches, 3, state_of)
            check(all(det), f"{label}: deterministic bit-equal {det}")
            print(json.dumps({"phase": "15d", "at_s": time.perf_counter() - t_phase,
                              "owner": name, "world": 1, "backend": "nccl", "replays": replays,
                              "worst": worst,
                              "worst_vs_one_process": worst_one,
                              "deterministic_bit_equal_with_eager_and_one_process": det,
                              "capture_call_ms": capture_ms,
                              "wrapper_launches_in_capture": captured}), flush=True)
        dp_path = counts_now()
        check(all(dp_path[k] > 0 for k in trained), f"15d: the run launched {dp_path}")
    finally:
        torch.distributed.destroy_process_group()

    # e. reconstruction's fine-tune: one instance at S=2048, 200 steps
    # captured (two chunks of 100 replays) against 200 eager steps with
    # generators of the same seed
    decoder = ImplicitNet(d_in=258)
    decoder.reset_parameters(torch.Generator().manual_seed(19))
    decoder = decoder.to(dev)
    rng = np.random.default_rng(19)
    lat = torch.from_numpy(rng.normal(size=256).astype(np.float32)).to(dev)
    lat = lat / lat.norm()
    th = torch.from_numpy(rng.uniform(0, 2 * np.pi, SK).astype(np.float32)).to(dev)
    ring = torch.stack([torch.cos(th), torch.sin(th)], -1)
    sk_p, sk_n = ring * torch.tensor([0.7, 0.4], device=dev), ring
    tuned, ft_steps, ft_gens = {}, {}, {}
    for name, graph in (("graph", True), ("eager", False)):
        g = torch.Generator(dev).manual_seed(21)
        tuned[name], ft_steps[name] = recon.igr_finetune(decoder, lat, sk_p, sk_n, g,
                                                         max_steps=200, graph=graph)
        ft_gens[name] = g.get_state()
    ft_err, ft_bits = 0.0, True
    for (pn, a), b in zip(tuned["graph"].named_parameters(), tuned["eager"].parameters()):
        e = float((a - b).abs().max())
        check(e <= 1e-4 * float(b.abs().max()), f"15e fine-tune: {pn} differs by {e}")
        ft_err, ft_bits = max(ft_err, e), ft_bits and torch.equal(a, b)
    check(ft_steps["graph"] == ft_steps["eager"] == 200
          and torch.equal(ft_gens["graph"], ft_gens["eager"]),
          f"15e fine-tune: steps {ft_steps}, generators alike "
          f"{torch.equal(ft_gens['graph'], ft_gens['eager'])}")
    print(json.dumps({"phase": "15e", "at_s": time.perf_counter() - t_phase,
                      "steps": 200, "num_sk_point": SK, "max_abs_err": ft_err,
                      "bit_equal": ft_bits}), flush=True)

    # f. the fine-tune step in turns, captured against eager, a call of
    # 10 steps (a tuner's first call runs eagerly, its second captures),
    # traced in calls of 5
    tuners = {name: recon.FineTuner(decoder, graph=graph)
              for name, graph in (("graph", True), ("eager", False))}
    g = torch.Generator(dev).manual_seed(22)

    def tune(name: str, steps_: int = 10) -> int:
        return tuners[name].tune(decoder, lat, sk_p, sk_n, g, max_steps=steps_,
                                 check_every=steps_)

    tune("graph", 1)  # the eager first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tune("graph", 1)  # the capture
    torch.cuda.synchronize()
    ft_capture_ms = (time.perf_counter() - t0) * 1e3
    timed_owner("fine-tune, one instance, S=2048", lambda: tune("graph"),
                lambda: tune("eager"), ft_capture_ms,
                card, rounds=2, per=10,
                trace=(lambda: tune("graph", 5), lambda: tune("eager", 5), 5))
    del tuners
    print(json.dumps({"phase": "15", "phase15_s": time.perf_counter() - t_phase}),
          flush=True)
    return graph_launches


# ---- phase 17: clouds beyond 16,384 points -------------------------------------

# the heads of a large cloud against the all-plain forward (phase 12d's)
LARGE_HEADS_ATOL = 1e-3
# one forward of a cloud above the old limits: SA1 through the FPS above
# 16,384 points (the cluster route up to 131,072 points, the grid route
# above) and the streamed ball query, SA2 and the feature propagations as
# at N=8192
PER_LARGE_FORWARD = {**PER_SHARDED_FORWARD_P1, "fps": 1, "ball_query_grouped": 0,
                     "fps_cluster": 1, "ball_query_stream": 1}
PER_HUGE_FORWARD = {**PER_LARGE_FORWARD, "fps_cluster": 0, "fps_grid": 1}
# Trainer A's step at N=32,768: the forward's, and the SA2 gather and 3-NN
# backwards (the clouds take no gradient)
PER_LARGE_STEP = {**PER_LARGE_FORWARD, "sa_grouped_backward": 1, "three_nn_backward": 2}
LARGE_SOURCE = {"fps_cluster": "point2cyl_torch/csrc/fps_cluster.cu",
                "fps_grid": "point2cyl_torch/csrc/fps_grid.cu",
                "ball_query_stream": "point2cyl_torch/csrc/ballquery.cu",
                "ball_query_grouped_backward": "point2cyl_torch/csrc/target_sum.cu",
                "three_nn": "point2cyl_torch/csrc/knn3.cu",
                "three_nn_backward": "point2cyl_torch/csrc/target_sum.cu"}
LARGE_REPLACES = {
    "fps_cluster": "point2cyl_tpu/ops/pallas_fps.py:22 _fps_kernel",
    "fps_grid": "point2cyl_tpu/ops/pallas_fps.py:22 _fps_kernel",
    "ball_query_stream": "point2cyl_tpu/ops/pallas_ballquery.py:276 _ballquery_grouped_kernel",
    "ball_query_grouped_backward": "point2cyl_tpu/ops/pallas_ballquery.py:675 "
                                   "_bqg_scatter_kernel",
    "three_nn": "point2cyl_tpu/ops/pallas_knn.py:97 _knn3_kernel",
    "three_nn_backward": "point2cyl_tpu/ops/pallas_knn.py:110 _knn3_bwd_kernel"}


def fps_step_routes(rows: list) -> dict:
    """Microseconds a step of each FPS route above 16,384 points, from
    phase 17b's rows (npoint 512: 511 steps)."""
    return {row["name"]: row["ms"] * 1e3 / 511 for row in rows
            if row["name"].startswith(("fps_cluster@", "fps_grid@"))}


def large_kernel_checks(dev, rng) -> dict:
    """Phase 17a: the FPS above 16,384 points (its cluster and grid
    routes) and the streamed ball query against their plain versions on
    the card, index for index and value for value: the main shapes above
    the old limits, N at the cluster route's capacity and one above, FPS
    clusters in several waves (B=64), the grid route with points streamed
    beyond its registers, clouds of repeated points (ties across CTAs, also
    the grid route's at 2^20), start tensors on the card, two calls in a
    row, N not a multiple of 4 or of a block, NaN and inf coordinates, a
    far and a sparse-region query, a dense cluster, nsample 63, a row that
    is not 16-byte aligned, the idx-only route; the planned routes from
    the first N past SA1's grid (11,945) and at 16,384; a far query at 2^20
    (the whole row); then the cluster route and the streamed query inside
    one captured graph, and the grid route in another, replayed on new
    clouds. Returns the inputs the timings use and the ms of the queries
    that walk the whole row."""
    from point2cyl_torch.ops import cuda_ballquery, cuda_fps
    from point2cyl_torch.ops.grouping import ball_query_plain, index_points

    cfg = full_width_config(8192)
    r1, ns1, np1 = cfg.sa_radii[0], cfg.sa_nsamples[0], cfg.sa_npoints[0]
    bq_k = cuda_ballquery.ball_query_stream_kernel
    routes = {"cluster": cuda_fps.farthest_point_sample_cluster_kernel,
              "grid": cuda_fps.farthest_point_sample_grid_kernel}
    cases, kept = [], {}

    def fps_case(label, xyz, start, npoint=np1):
        want = cuda_fps.farthest_point_sample_plain(xyz, npoint, start)
        plan = cuda_fps.fps_grid_plan(*xyz.shape[:2])
        fps_k = routes[plan.route]
        before = fps_k.launches
        got = [cuda_fps.farthest_point_sample(xyz, npoint, start) for _ in range(2)]
        check(all(torch.equal(g, want) for g in got) and fps_k.launches == before + 2,
              f"17a fps {label}: the {plan.route} route differs from the plain version")
        cases.append(f"fps {label} ({plan.route}: {plan.ctas} CTAs of {plan.threads} threads, "
                     f"{plan.streamed} streamed)")
        return want

    def bq_case(label, xyz, centres, nsample=ns1, gather=True):
        plan = cuda_ballquery.ball_query_plan(xyz.shape[0], xyz.shape[1], centres.shape[1],
                                              nsample, gather=gather, select="stream")
        if gather:
            want = cuda_ballquery.ball_query_grouped_plain(r1, nsample, xyz, centres)
            got = bq_k(r1, nsample, xyz, centres, plan)
            ok = torch.equal(got[0], want[0]) and same_bits(got[1], want[1])
        else:
            want = ball_query_plain(r1, nsample, xyz, centres)
            got = bq_k(r1, nsample, xyz, centres, plan, gather=False)
            ok = torch.equal(got, want)
        check(ok, f"17a ball query {label}: the streamed kernel differs from the plain version")
        cases.append(f"ball query {label}")
        return got

    with torch.inference_mode():
        for b, n in ((1, 16385), (4, 16385), (4, 32768), (16, 32768), (1, 131072), (4, 131072),
                     (1, 2**20)):
            xyz = torch.from_numpy(clouds(1700 + n % 1000 + b, b, n)).to(dev)
            start = torch.from_numpy(rng.integers(0, n, size=b)).to(dev)
            idx = fps_case(f"B={b} N={n}, card start", xyz, start)
            centres = index_points(xyz, idx)
            bq_case(f"B={b} N={n}", xyz, centres)
            if n <= 131072:
                # the routes the planner picks
                got = cuda_ballquery.ball_query_grouped(r1, ns1, xyz, centres)
                want = cuda_ballquery.ball_query_grouped_plain(r1, ns1, xyz, centres)
                check(torch.equal(got[0], want[0]) and same_bits(got[1], want[1]),
                      f"17a ball query B={b} N={n}: the planned route differs")
            kept[(b, n)] = (xyz, start, centres)
        # the first N past SA1's grid and the band the staged scan held
        # until the streamed query beat it: both queries' planned routes
        # (N=11,944 keeps SA1's grid; the idx-only query streams there)
        for b, n in ((1, 11944), (1, 11945), (4, 11945), (1, 16384), (4, 16384)):
            xyz = torch.from_numpy(clouds(1810 + n % 1000 + b, b, n)).to(dev)
            centres = index_points(xyz, cuda_fps.farthest_point_sample(xyz, np1))
            want = cuda_ballquery.ball_query_grouped_plain(r1, ns1, xyz, centres)
            selects = []
            for gather in (True, False):
                plan = cuda_ballquery.ball_query_plan(b, n, np1, ns1, gather=gather)
                selects.append(plan.select)
                check(plan.select == ("grid" if gather and n == 11944 else "stream"),
                      f"17a: the plan at B={b} N={n}: {plan}")
                if gather:
                    got = cuda_ballquery.ball_query_grouped(r1, ns1, xyz, centres)
                    ok = torch.equal(got[0], want[0]) and same_bits(got[1], want[1])
                else:
                    ok = torch.equal(cuda_ballquery.ball_query(r1, ns1, xyz, centres), want[0])
                check(ok, f"17a ball query B={b} N={n} gather={gather}: the planned "
                      f"{plan.select} route differs from the plain version")
            cases.append(f"ball query B={b} N={n}, planned ({selects[0]}; idx only {selects[1]})")
            kept[(b, n)] = (xyz, None, centres)
        # both routes at their border: the cluster route's capacity and
        # one point more (the grid route)
        cap = cuda_fps.CLUSTER_CAPACITY
        for n in (cap, cap + 1):
            fps_case(f"B=2 N={n} (the cluster route's capacity{' + 1' if n > cap else ''})",
                     torch.from_numpy(clouds(1805 + n % 2, 2, n)).to(dev),
                     torch.from_numpy(rng.integers(0, n, size=2)).to(dev))
        # clusters in several waves: 64 clouds of 16 CTAs
        fps_case("B=64 N=20000 (clusters in waves)",
                 torch.from_numpy(clouds(1806, 64, 20000)).to(dev),
                 torch.from_numpy(rng.integers(0, 20000, size=64)).to(dev))
        # points beyond the grid route's registers, streamed from global
        # memory every step: 66 CTAs a cloud at B=2, N=2^20, 2 at B=64, one
        # CTA of 512 threads at B=200
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for b, n in ((2, 2**20), (64, cap + 1), (200, cap + 1)):
            plan = cuda_fps.fps_grid_plan(b, n, sms)
            check(plan.route == "grid" and plan.streamed > 0,
                  f"17a: the plan at B={b} N={n} streams nothing: {plan}")
            xyz = torch.from_numpy(clouds(1800 + b, b, n)).to(dev)
            fps_case(f"B={b} N={n}", xyz, torch.from_numpy(rng.integers(0, n, size=b)).to(dev),
                     npoint=128)
            del xyz
        # NaN and inf coordinates: a NaN point wins the next step, then every
        # distance is NaN and the lowest index wins, as in the plain version
        for n in (20000, cap + 1):
            bad = clouds(1807, 2, n)
            bad[0, n // 3] = np.nan
            bad[1, n // 5] = [np.inf, 0.0, 0.0]
            fps_case(f"N={n}, NaN and inf coordinates", torch.from_numpy(bad).to(dev), 0,
                     npoint=64)
        # repeated points: 4,096 distinct points 8 times, so the farthest
        # distance ties across the CTAs of a cloud at every step; repeated
        # to 2^20, across the CTAs of the grid route too
        base = clouds(1801, 2, 4096)
        dup = torch.from_numpy(np.tile(base, (1, 8, 1))).to(dev)
        idx = fps_case("repeated points", dup, 0)
        check(int(idx.max()) < 4096, "17a fps repeated points: a later copy won a tie")
        bq_case("repeated points", dup, index_points(dup, idx))
        huge_dup = torch.from_numpy(np.tile(base[:1], (1, 256, 1))).to(dev)
        idx = fps_case("repeated points, N=2^20", huge_dup, 5)
        check(int(idx.max()) < 4096, "17a fps repeated points at 2^20: a later copy won a tie")
        del huge_dup
        # N not a multiple of 4 or of the tile, a far and a sparse-region
        # query, NaN and inf coordinates, a dense cluster
        odd = clouds(1802, 2, 32767)
        odd[0, :1000] = odd[0, 5000]  # a dense cluster: 1,000 copies of one point
        odd[1, 7] = np.nan
        odd[1, 9] = [np.inf, 0.0, 0.0]
        odd = torch.from_numpy(odd).to(dev)
        q = index_points(odd, torch.from_numpy(rng.integers(0, 32767, size=(2, 200))).to(dev))
        q[:, 0] = 1e4  # far: an empty row
        q[:, 1] = odd[:, 5000] * 1.19  # off the sphere: fewer than nsample in its ball
        q[1, 2] = float("nan")
        bq_case("N=32767, NaN/inf, far and sparse queries, a cluster", odd, q.contiguous())
        walks = {"n32767_sparse_far_ms": time_ms(lambda: bq_k(r1, ns1, odd, q.contiguous()))}
        bq_case("N=32767, nsample 63", odd, q.contiguous(), nsample=63)
        bq_case("N=32767, idx only", odd, q.contiguous(), gather=False)
        # a row that is not 16-byte aligned: blocks copied from the 16-byte
        # boundary below, tested with 4-byte loads
        flat = torch.empty(2 * 32768 * 3 + 1, device=dev)
        shifted = flat[1:].view(2, 32768, 3)
        shifted.copy_(kept[(4, 32768)][0][:2])
        bq_case("misaligned row", shifted, kept[(4, 32768)][2][:2].contiguous())
        bq_case("B=4 N=32768, idx only", kept[(4, 32768)][0], kept[(4, 32768)][2],
                gather=False)
        # a far query at 2^20: its CTA walks the whole row
        huge, far = kept[(1, 2**20)][0], kept[(1, 2**20)][2].clone()
        far[0, 0] = 1e4
        bq_case("N=2^20, a far query (the whole row)", huge, far)
        walks["n1048576_far_ms"] = time_ms(lambda: bq_k(r1, ns1, huge, far))
        del far
        # both kernels through ball_query_grouped's and FPS's dispatch inside
        # one captured graph, replayed on new clouds and starts
        xyz, start, _ = kept[(4, 32768)]
        sx, ss = xyz.clone(), start.clone()
        cuda_ballquery.ball_query_grouped(r1, ns1, sx, index_points(sx, cuda_fps.
                                          farthest_point_sample(sx, np1, ss)))
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_idx = cuda_fps.farthest_point_sample(sx, np1, ss)
            g_out = cuda_ballquery.ball_query_grouped(r1, ns1, sx, index_points(sx, g_idx))
        for seed in (1803, 1804):
            sx.copy_(torch.from_numpy(clouds(seed, 4, 32768)).to(dev))
            ss.copy_(torch.from_numpy(rng.integers(0, 32768, size=4)).to(dev))
            graph.replay()
            want_idx = cuda_fps.farthest_point_sample_plain(sx, np1, ss)
            want = cuda_ballquery.ball_query_grouped_plain(r1, ns1, sx, index_points(sx, want_idx))
            check(torch.equal(g_idx, want_idx) and torch.equal(g_out[0], want[0])
                  and same_bits(g_out[1], want[1]),
                  f"17a: the captured cluster FPS and streamed query differ on clouds {seed}")
        cases.append("captured graph (cluster route, streamed query), 2 replays")
        del graph, g_idx, g_out
        # the grid route inside a graph: its meeting buffer zeroed by the
        # graph's own fill at every replay
        xyz, start, _ = kept[(1, 2**20)]
        sx, ss = xyz.clone(), start.clone()
        cuda_fps.farthest_point_sample(sx, np1, ss)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_idx = cuda_fps.farthest_point_sample(sx, np1, ss)
        for seed in (1808, 1809):
            sx.copy_(torch.from_numpy(clouds(seed, 1, 2**20)).to(dev))
            ss.copy_(torch.from_numpy(rng.integers(0, 2**20, size=1)).to(dev))
            graph.replay()
            check(torch.equal(g_idx, cuda_fps.farthest_point_sample_plain(sx, np1, ss)),
                  f"17a: the captured grid FPS differs on clouds {seed}")
        cases.append("captured graph (grid route), 2 replays")
        del graph, g_idx, sx
    torch.cuda.synchronize()
    return {"cases": cases, "kept": kept, "walks": walks}


def large_rows(dev, kept: dict, card: str) -> list:
    """Phase 17b: each new kernel timed beside its plain version (median of
    25 CUDA-event timings) with its bound, at the new N, and the SA1
    gather backward, the 3-NN forward at FP1 and the 3-NN backward there.
    The ordered sums are held bit-equal to the host's and to a second run.
    Returns the kernel table's rows (without launches)."""
    from point2cyl_torch.ops import cuda_ballquery, cuda_fps, cuda_knn
    from point2cyl_torch.ops.grouping import group_scatter_plain, three_nn_weights_plain

    cfg = full_width_config(8192)
    r1, ns1, np1 = cfg.sa_radii[0], cfg.sa_nsamples[0], cfg.sa_npoints[0]
    rng = np.random.default_rng(17)

    def cotangent(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    cases = []
    for b, n in ((4, 32768), (4, 131072), (1, 131072), (1, 2**20)):
        xyz, start, centres = kept[(b, n)]
        tag = f"n{n}_b{b}"
        route = cuda_fps.fps_grid_plan(b, n).route
        cases.append((f"fps_{route}@{tag}", getattr(
            cuda_fps, f"farthest_point_sample_{route}_kernel"),
                      cuda_fps.farthest_point_sample_plain, (xyz, np1, start),
                      fps_work(xyz, np1), None))
        with torch.inference_mode():
            idx = cuda_ballquery.ball_query_stream_kernel(r1, ns1, xyz, centres)[0]
        cases.append((f"ball_query_stream@{tag}", cuda_ballquery.ball_query_stream_kernel,
                      cuda_ballquery.ball_query_grouped_plain, (r1, ns1, xyz, centres),
                      group_work(xyz, centres, idx, 3), None))
    # the band the staged scan held (SA1 only: the FPS there is fps.cu's)
    for b in (1, 4):
        xyz, _, centres = kept[(b, 16384)]
        with torch.inference_mode():
            idx = cuda_ballquery.ball_query_stream_kernel(r1, ns1, xyz, centres)[0]
        cases.append((f"ball_query_stream@n16384_b{b}", cuda_ballquery.ball_query_stream_kernel,
                      cuda_ballquery.ball_query_grouped_plain, (r1, ns1, xyz, centres),
                      group_work(xyz, centres, idx, 3), None))
    xyz4, _, c4 = kept[(4, 32768)]
    with torch.inference_mode():
        idx4 = cuda_ballquery.ball_query_stream_kernel(r1, ns1, xyz4, c4)[0]
        nn4 = [t.to(dt).contiguous() for t, dt in zip(three_nn_weights_plain(xyz4, c4),
                                                        (torch.int32, torch.float32))]
    dg = cotangent(4, np1, ns1, 3)
    g = cotangent(4, 32768, 128)
    cases.append(("ball_query_grouped_backward@sa1_n32768",
                  cuda_ballquery.ball_query_grouped_backward_kernel, group_scatter_plain,
                  (idx4, dg, 32768), scatter_work(idx4, dg, 32768),
                  index_add_call(idx4, dg, 32768)))
    cases.append(("three_nn_backward@fp1_n32768", cuda_knn.three_nn_backward_kernel,
                  cuda_knn.three_nn_backward_plain, (*nn4, g, np1),
                  knn_bwd_work(*nn4, g, np1), knn_index_add_call(*nn4, g, np1)))
    for b, n in ((4, 131072), (1, 2**20)):
        xyz, _, centres = kept[(b, n)]
        feats = cotangent(b, np1, 128)
        cases.append((f"three_nn@fp1_n{n}_b{b}", cuda_knn.three_nn_interpolate_kernel,
                      cuda_knn.three_nn_interpolate_plain, (xyz, centres, feats),
                      knn_work(xyz, centres, feats), None))
    rows = []
    with torch.inference_mode():
        for name, kernel, plain, inputs, work, library in cases:
            kind = name.split("@")[0]
            got = kernel(*inputs)
            want = plain(*inputs)
            torch.cuda.synchronize()
            if kind in ("fps_cluster", "fps_grid"):
                check(torch.equal(got, want), f"17b {name}: indices differ from plain")
                err = 0.0
            elif kind == "ball_query_stream":
                check(torch.equal(got[0], want[0]) and same_bits(got[1], want[1]),
                      f"17b {name}: differs from plain")
                err = float((got[1] - want[1]).abs().max())
            elif kind == "three_nn":
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                           msg=lambda m: f"17b {name}: {m}")
                err = float((got - want).abs().max())
            else:
                # the plain scatter adds in another order: 1e-4; the ordered
                # sums bit-equal to the host's ordered sum and a second run
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                           msg=lambda m: f"17b {name}: {m}")
                err = float((got - want).abs().max())
                again, host = ordered_sum_case(kernel, inputs)
                check(same_bits(got, torch.from_numpy(host).to(dev)) and same_bits(got, again),
                      f"17b {name}: differs from the host's ordered sum or a second run")
            k_ms = time_ms(lambda: kernel(*inputs))
            p_ms = time_ms(lambda: plain(*inputs))
            l_ms = time_ms(library) if library is not None else None
            b_ms, b_by = bound(*work)
            row = {"name": name, "route": "cuda", "source": LARGE_SOURCE[kind],
                   "replaces": LARGE_REPLACES[kind], "max_abs_err": err, "ms": k_ms,
                   "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms}
            rows.append(row)
            extra = {}
            if kind in ("fps_cluster", "fps_grid"):
                extra = {"plan": cuda_fps.fps_grid_plan(*inputs[0].shape[:2])._asdict(),
                         "us_per_step": k_ms * 1e3 / (np1 - 1)}
            elif kind == "ball_query_stream":
                extra = {"plan": cuda_ballquery.ball_query_plan(
                    *inputs[2].shape[:2], inputs[3].shape[1], ns1, select="stream")._asdict()}
            print(json.dumps({"phase": "17b", "kernel": name, "kernel_ms": k_ms,
                              "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "library_ms": l_ms, "max_abs_err": err, **extra, "card": card}),
                  flush=True)
    return rows


def large_phase(card: str, dev, root: str) -> tuple[list, dict]:
    """Phase 17: clouds beyond 16,384 points on one card. a. The grid FPS
    and the streamed ball query against their plain versions
    (:func:`large_kernel_checks`). b. Their times and the backwards' and
    3-NN's at the new N (:func:`large_rows`). c. Serving at N=131,072
    (buckets 1 and 4): requests of 1 and 4 clouds three times each
    (eager, capture, replay) bit-equal to an eager session, the heads
    within LARGE_HEADS_ATOL of the all-plain forward, the launches of each
    request. d. Trainer A at N=32,768 (B=4, K=8) through the CLI, 2
    epochs (eager, capture, replays), then three captured steps bit-equal
    to eager ones under deterministic algorithms, and a saliency backward
    (SA1's gather backward at the new N). e. One NCCL rank: the P=1
    ``ShardedForward`` at 2^20 points (eager, capture, replay) bit-equal
    to ``Backbone.forward``, with its pool and peak GiB. Returns the
    kernel table's rows (with the launches of the main paths) and the
    launches of each path."""
    import warnings

    from point2cyl_torch.core.config import TrainConfig
    from point2cyl_torch.models.backbone import build_backbone
    from point2cyl_torch.parallel.distributed import join
    from point2cyl_torch.parallel.mesh import make_mesh
    from point2cyl_torch.parallel.sharded_backbone import ShardedForward
    from point2cyl_torch.serve.export import _backbone_forward, export_artifact
    from point2cyl_torch.serve.session import InferenceSession
    from point2cyl_torch.train import steps, train_pc

    t_phase = time.perf_counter()
    rng = np.random.default_rng(1700)
    checked = large_kernel_checks(dev, rng)
    t_checks = time.perf_counter() - t_phase
    rows = large_rows(dev, checked["kept"], card)
    del checked["kept"]
    torch.cuda.empty_cache()
    t_rows = time.perf_counter() - t_phase - t_checks
    state = build_backbone(full_width_config(8192), generator=torch.Generator().manual_seed(0),
                           device="cpu").state_dict()
    paths = {}

    # c. serving at N=131,072
    n = 131072
    cfg = full_width_config(n)
    art = os.path.join(root, "large.p2ct")
    export_artifact(art, state, k=K, backbone_config=cfg, buckets=(1, 4), num_sk_points=SK)
    sess, eager = InferenceSession(art), InferenceSession(art, graph=False)
    check(sess.stats["folded_layers"] == 17 and sess.stats["unfolded_layers"] == 0,
          f"17c: the session folded {sess.stats['folded_layers']} layers")
    requests = {b: clouds(1710 + b, b, n) for b in (1, 4)}
    for b, req in requests.items():
        want = eager.predict(req, assemble=False)
        for call in range(3):
            got, launched = counted(lambda: sess.predict(req, assemble=False))
            check(all(np.array_equal(got[k], want[k]) for k in want),
                  f"17c: request of {b} call {call} differs from the eager session")
            if call == 0:
                check(launched == PER_LARGE_FORWARD, f"17c: a request launched {launched}")
                paths["serve_n131072_request"] = launched
    # a capture call replays its graph too: 2 replays a bucket
    check(sess._graphs[0].captures == 2 and sess._graphs[0].replays == 4,
          f"17c: {sess._graphs[0].captures} captures, {sess._graphs[0].replays} replays")
    plain = build_backbone(dataclasses.replace(cfg, fps_impl="plain", ballquery_impl="plain",
                                               knn_impl="plain"), state_dict=state, device=dev)
    pts4 = torch.from_numpy(requests[4]).to(dev)
    with torch.inference_mode():
        got = _backbone_forward(sess.served, pts4, k=K, num_sk_points=SK)
        want = _backbone_forward(plain, pts4, k=K, num_sk_points=SK)
    serve_err = max(float((got[k] - want[k]).abs().max()) for k in ("x_raw", "w_raw"))
    check(serve_err <= LARGE_HEADS_ATOL and all(bool(torch.isfinite(got[k]).all())
                                                for k in ("x_raw", "w_raw")),
          f"17c: served (folded) vs all-plain heads differ by {serve_err}")
    serve_ms = in_turns({"captured": lambda: sess.predict(requests[4], assemble=False),
                         "eager": lambda: eager.predict(requests[4], assemble=False)}, 3)
    print(json.dumps({"phase": "17c", "num_points": n, "buckets": [1, 4],
                      "replays_bit_equal_eager": True, "plain_max_abs_err": serve_err,
                      "request4_ms": serve_ms,
                      "launches_per_request": paths["serve_n131072_request"], "card": card}),
          flush=True)
    del sess, eager, plain, got, want, pts4
    torch.cuda.empty_cache()

    # d. Trainer A at N=32,768, B=4, K=8: the CLI (random FPS starts from
    # its generator), then captured steps against eager ones bit for bit
    n = 32768
    logdir = os.path.join(root, "large_run")
    argv = ["--synthetic", "8", "--synthetic_resolution", str(n), "--num_point", str(n),
            "--K", str(K), "--batch_size", str(TB), "--logdir", logdir, "--num_epochs", "2",
            "--pred_seg", "--pred_normal", "--pred_bb", "--pred_extrusion", "--pred_center"]
    trained, launched = counted(lambda: train_pc.cli_main(argv))
    with open(os.path.join(logdir, "log.txt")) as f:
        log = f.read()
    calls = wrapper_calls(trained.graphs)
    check(trained.step == 4 and "Epoch 0002 done" in log and trained.graphs.replays == 3,
          f"17d: the CLI ran {trained.step} steps, {trained.graphs.replays} replays")
    check(launched == {k: v * calls for k, v in PER_LARGE_STEP.items()},
          f"17d: the CLI's steps launched {launched} over {calls} wrapper calls")
    paths["train_n32768_step"] = {k: v // calls for k, v in launched.items()}
    del trained
    tcfg = TrainConfig(batch_size=TB, pred_seg=True, pred_normal=True, pred_bb=True,
                       pred_extrusion=True, pred_center=True, seed=0)
    pipe = train_pc.build_pipeline(tcfg, n, K, dev, synthetic=8, synthetic_resolution=n)
    gen = torch.Generator(dev).manual_seed(17)
    batches = [pipe.batch(torch.arange(i * TB, (i + 1) * TB, device=dev) % 8, gen)
               for i in range(3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det_g = steps.Trainer(train_pc.build_model(tcfg, n, K, dev), tcfg)
            det_e = steps.Trainer(train_pc.build_model(tcfg, n, K, dev), tcfg, graph=False)
            bit_equal, losses = [], []
            for i, batch in enumerate(batches):
                a = det_g.train_step(batch, torch.Generator(dev).manual_seed(70 + i))
                e = det_e.train_step(batch, torch.Generator(dev).manual_seed(70 + i))
                sa, se = state_tensors(det_g), state_tensors(det_e)
                bit_equal.append(all(torch.equal(a[k], e[k]) for k in a)
                                 and all(torch.equal(sa[k], se[k]) for k in sa))
                losses.append(float(a["total"]))
        finally:
            torch.use_deterministic_algorithms(False)
    check(det_g.graphs.replays == 2 and all(bit_equal) and all(np.isfinite(losses)),
          f"17d: captured vs eager steps bit-equal {bit_equal}, losses {losses}")
    step_ms = in_turns({"captured": lambda: det_g.train_step(batches[0], gen),
                        "eager": lambda: det_e.train_step(batches[0], gen)}, 3)
    # the loss's gradient with respect to the clouds: SA1's gather backward
    model = det_e.model.eval()
    cloud = batches[0]["point_cloud"].detach().clone().requires_grad_(True)

    def saliency():
        heads = model(cloud)
        (heads[0].square().mean() + heads[1].square().mean()).backward()

    _, launched = counted(saliency)
    check(launched["ball_query_grouped_backward"] == 1 and launched["ball_query_stream"] == 1
          and bool(torch.isfinite(cloud.grad).all()) and bool(cloud.grad.abs().max() > 0),
          f"17d: the saliency backward launched {launched}")
    paths["saliency_n32768"] = launched
    print(json.dumps({"phase": "17d", "num_points": n, "batch": TB, "K": K, "cli_steps": 4,
                      "captured_bit_equal_eager": bit_equal, "losses": losses,
                      "step_ms": step_ms,
                      "launches_per_step": paths["train_n32768_step"], "card": card}),
          flush=True)
    del det_g, det_e, model, cloud, batches, pipe
    torch.cuda.empty_cache()

    # e. one NCCL rank: the P=1 sharded forward at 2^20 points against
    # Backbone.forward, which now runs on one card too
    n = 2**20
    cfg = full_width_config(n)
    join("file://" + os.path.join(root, "rdv_large"), 1, 0, "nccl")
    try:
        mesh = make_mesh()
        model = build_backbone(cfg, state_dict=state, device=dev)
        pts = torch.from_numpy(clouds(1720, 1, n)).to(dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            want, launched = counted(lambda: model(pts))
            forward_s = time.perf_counter() - t0
            forward_peak = torch.cuda.max_memory_allocated() / 2**30
            check(launched == PER_HUGE_FORWARD, f"17e: Backbone.forward launched {launched}")
            owner = ShardedForward(mesh, model, cfg)
            torch.cuda.reset_peak_memory_stats()
            calls_s, sharded = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                heads, launched = counted(lambda: owner(pts))
                calls_s.append(time.perf_counter() - t0)
                sharded.append(launched)
                check(all(torch.equal(h, w) for h, w in zip(heads, want)),
                      f"17e: call {len(calls_s)} of the P=1 sharded forward at 2^20 differs "
                      "from Backbone.forward")
        og = owner.graphs
        check(og.eager_calls == 1 and og.captures == 1 and og.replays == 2
              and sharded[0] == sharded[1] == PER_HUGE_FORWARD and not any(sharded[2].values()),
              f"17e: {og.eager_calls} eager, {og.captures} captures, {og.replays} replays, "
              f"launches {sharded}")
        paths["sharded_p1_n1048576"] = sharded[0]
        print(json.dumps({"phase": "17e", "num_points": n, "world": 1,
                          "bit_equal_backbone_forward": True, "calls_s": calls_s,
                          "forward_s": forward_s, "forward_peak_gib": forward_peak,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "pr16_peak_gib": [12.44, 14.03],
                          "launches": paths["sharded_p1_n1048576"], "card": card}), flush=True)
        del owner, model, pts, want, heads
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    main_path = {"fps_cluster": "serve_n131072_request", "fps_grid": "sharded_p1_n1048576",
                 "ball_query_stream": "serve_n131072_request",
                 "three_nn": "serve_n131072_request", "three_nn_backward": "train_n32768_step",
                 "ball_query_grouped_backward": "saliency_n32768"}
    for row in rows:
        kernel = row["name"].split("@")[0]
        row["launches"] = paths[main_path[kernel]][kernel]
        row["large_launches"] = {key: val[kernel] for key, val in paths.items()}
    check(all(row["launches"] > 0 for row in rows), "17: a kernel of the paths did not launch")
    print(json.dumps({"phase": "17", "checked": checked["cases"], "whole_row": checked["walks"],
                      "checks_s": t_checks,
                      "timings_s": t_rows, "phase17_s": time.perf_counter() - t_phase}),
          flush=True)
    return rows, paths


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="print torch.profiler device-time breakdowns of a "
                        "bucket-16 request and of full-width train and eval steps")
    parser.add_argument("--only-parallel", nargs="?", const="all",
                        choices=["all", "multi-card"],
                        help="run the set-up and phase 12 (the parallel package) alone, "
                        "without the kernel table; 'multi-card' runs only 12c, which "
                        "needs two cards")
    parser.add_argument("--only-bf16", action="store_true",
                        help="run the set-up and phase 13 (bf16 compute) alone, without "
                        "the kernel table")
    parser.add_argument("--only-graphs", action="store_true",
                        help="run the set-up and phases 14 and 15 (captured steps) alone, "
                        "without the kernel table")
    parser.add_argument("--only-large", action="store_true",
                        help="run the set-up and phase 17 (clouds beyond 16,384 points) "
                        "alone, with its own kernel rows")
    parser.add_argument("--recon-igr-post-process", action="store_true",
                        help="run the set-up and, alone, the reconstruction CLI with "
                        "--igr_post_process (10,000 fine-tune steps an instance at most) at "
                        "R=256 on a joint logdir trained as phases 5 and 9 train theirs; "
                        "not part of the default run")
    args = parser.parse_args()
    faulthandler.enable()  # a crash in native code prints the Python stack

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
    if args.only_large:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            rows, _ = large_phase(card, dev, tmp)
        print(json.dumps({"fps_step": "routes above 16,384 points",
                          "us_per_step": fps_step_routes(rows), "card": card}), flush=True)
        print(card)
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if args.only_parallel or args.only_bf16 or args.only_graphs or args.recon_igr_post_process:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            if args.only_graphs:
                graphs_phase(args, card, dev, tmp)
                graphs2_phase(args, card, dev, tmp)
            elif args.only_bf16:
                bf16_phase(args, card, dev, tmp)
            elif args.only_parallel == "multi-card":
                two_card_phase(card, dev, tmp, parallel_inputs(full_width_config(8192), dev,
                                                                tmp))
            elif args.only_parallel:
                parallel_phase(card, dev, tmp)
            else:
                igr_post_process_run(card, dev, tmp)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    # phases 14, 15 and 12 first: their traces of graph replays take the
    # profiler before any other phase has used it (after phases 11-13's
    # traces, the first traced replay crashed in the profiler)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        graph_launches = graphs_phase(args, card, dev, tmp)
        graph_launches.update(graphs2_phase(args, card, dev, tmp))
        parallel_launches, ring_rows = parallel_phase(card, dev, tmp)
        large_rows_, large_paths = large_phase(card, dev, tmp)

    cfg = full_width_config(8192)
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
        ("NaN and inf coordinates, N=8192 B=4", fps_case(4, 8192, 34), 512, 0),
    ]
    # a NaN point wins the step after it is reached, then every distance is
    # NaN and the lowest index wins; next to an inf point every distance is
    # inf and the point itself NaN, as torch.minimum and torch.argmax take them
    fps_cases[-1][1][0, 4000] = float("nan")
    fps_cases[-1][1][2, 77, 1] = float("inf")
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
        ("N=16384 B=2 (SA1's streamed route)", on_card(clouds(56, 2, 16384)), None, r1),
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
                    if plans[0].select == "stream":  # no cap where the grid does not fit
                        plans = plans[:1]
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
    check(bq_routes["ball_query_grouped_kernel N=16384 B=2 (SA1's streamed route)"] == "stream"
          and bq_routes["ball_query_grouped_kernel main shape B=16"] == "grid",
          f"SA1 routes {bq_routes}")

    # the idx-only ball query (item 2): indices equal to the plain version,
    # its ballots up to N=1024, the index-order scan above, the streamed
    # query from N=1536
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
        ("N=1535 B=16 (the index-order scan's last N)", idx_case(67, 16, 1535, 512, r1)),
        ("N=1536 B=16 (the streamed query's first N)", idx_case(68, 16, 1536, 512, r1)),
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
          and idx_routes["N=1535 B=16 (the index-order scan's last N)"] == "scan"
          and idx_routes["N=1536 B=16 (the streamed query's first N)"] == "stream"
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
        "us_per_step": slope * 1e3, "intercept_ms": intercept,
        "routes_us_per_step": fps_step_routes(large_rows_), "card": card}), flush=True)

    # ---- 3. the slice through the session ----------------------------------
    counters = kernel_counters()
    # serving launches no idx-only query (its SA1 has N > 1024, its SA2
    # features) and no backward
    per_forward = {"fps": 2, "ball_query": 0, "ball_query_grouped": 1,
                   "ball_query_grouped_backward": 0, "sa_grouped_exact": 1,
                   "sa_grouped_backward": 0, "three_nn": 2, "three_nn_backward": 0,
                   "fps_ring_step": 0, "fps_cluster": 0, "fps_grid": 0,
                   "ball_query_stream": 0}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fullwidth.p2ct")
        export_artifact(path, state_dict, k=K, backbone_config=cfg,
                        buckets=(1, 4, 16), num_sk_points=SK)
        sess = InferenceSession(path)
        check(sess.device.type == "cuda", "the session did not default to the card")
        check(sess.stats["folded_layers"] == 17 and sess.stats["unfolded_layers"] == 0,
              f"the session folded {sess.stats['folded_layers']} layers")
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
            got = _backbone_forward(sess.served, pts16, k=K, num_sk_points=SK)
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
            card1 = _backbone_forward(sess.served, torch.from_numpy(requests[1]).to(dev),
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

        if args.profile:
            request_ms = time_ms(lambda: sess.decompose(requests[16]))
            # device span of the backbone alone and with the decomposition,
            # then a trace of whole requests: device time by kernel name
            # (the card's own events, so nothing is counted twice)
            x = torch.from_numpy(requests[16]).to(dev)
            with torch.inference_mode():
                fwd_ms = time_ms(lambda: sess.served(x))
                full_ms = time_ms(lambda: _backbone_forward(sess.served, x, k=K,
                                                            num_sk_points=SK))
            print(json.dumps({"breakdown": "bucket 16", "backbone_ms": fwd_ms,
                              "decomposition_ms": full_ms - fwd_ms,
                              "request_ms": request_ms, "card": card}),
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
                              / request_ms, "card": card}), flush=True)
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
                "sa_grouped_backward": 1, "three_nn": 2, "three_nn_backward": 2,
                "fps_ring_step": 0, "fps_cluster": 0, "fps_grid": 0,
                "ball_query_stream": 0}
    gen = epoch_generator(tcfg.seed, 1, dev)
    for fn in counters.values():
        fn.launches = 0
    auxes = [trainer.train_step(batch, gen) for batch in pipeline.epochs(TB, gen)]
    torch.cuda.synchronize()
    # the wrappers count their launches in the eager first step and the
    # capture; the replays launch the captured kernels
    traced_steps = wrapper_calls(trainer.graphs)
    train_launches = {name: fn.launches for name, fn in counters.items()}
    for name, count in train_launches.items():
        check(count == per_step[name] * traced_steps,
              f"{name} launched {count} times over {len(auxes)} train steps, "
              f"{traced_steps} of them eager or captured, expected "
              f"{per_step[name] * traced_steps}")
    totals = [float(a["total"]) for a in auxes]
    check(len(auxes) >= 4 and all(np.isfinite(totals)), f"train losses {totals}")
    check(not any(float(a["skipped"]) for a in auxes), "a train step was skipped")
    zero_grad = [name for name, p in trainer.model.named_parameters()
                 if p.grad is None or not bool((p.grad != 0).any())]
    check(not zero_grad, f"parameters without a gradient: {zero_grad}")
    print(json.dumps({"train": "full width", "steps": len(auxes), "loss": totals,
                      "launches": train_launches, "replays": trainer.graphs.replays,
                      "parameters_with_gradient": sum(
                          1 for _ in trainer.model.parameters())}), flush=True)

    # one step held against the same step with every *_impl="plain"
    batch = pipeline.batch(torch.arange(TB, device=dev), epoch_generator(0, 99, dev))
    print(json.dumps({"check": "train step vs plain",
                      **step_against_plain(trainer, tcfg, dev, batch)}), flush=True)

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
    print(json.dumps({"check": "cli resume", "steps": [int(done.step), int(resumed.step)]}),
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
        check(count == per_step_512[name] * wrapper_calls(small.graphs),
              f"N=512: {name} launched {count} times over {len(aux512)} steps, "
              f"{wrapper_calls(small.graphs)} of them eager or captured")
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
        evaluator.evaluate(eval_model, eval_batches, eval_cfg, TB, log=quiet, graph=False)
        eval_s.append(time.perf_counter() - t0)
    # eager, as before captured steps (phase 14 times the captured step)
    step = evaluator.make_eval_step(eval_model, eval_cfg, SK, graph=False)
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
    batches512 = min(32 // 8, 2)  # the eager first batch and the capture
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
    print(json.dumps({"slice": "the sketch encoder", "encoder_ms": enc_ms, "encoder_flop": enc_flop,
                      "encoder_flop_bound_ms": enc_flop / FP32_OPS_PER_S * 1e3,
                      "card": card}), flush=True)
    if args.profile:
        profile_steps("decompose(16) with latents", lambda: sess_lat.decompose(requests[16]),
                      card, time_ms(lambda: sess_lat.decompose(requests[16])))
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
                           implicit=implicit8, encoder=encoder8, graph=False)
        eval8_s.append(time.perf_counter() - t0)
    # eager, as before captured steps (phase 14 times the captured step)
    gen = torch.Generator(dev).manual_seed(0)
    step8_ms = {}
    for mode, (cfg_m, implicit_m, encoder_m) in stacks.items():
        step_m = evaluator.make_eval_step(eval_model, cfg_m, SK, implicit_m, encoder_m,
                                          graph=False)
        step8_ms[mode] = time_ms(lambda: step_m(eval_batches[0], gen), runs=10)
    torch.cuda.reset_peak_memory_stats()
    step8 = evaluator.make_eval_step(eval_model, cfg8, SK, implicit8, encoder8, graph=False)
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
    # the wrappers count the eager first step and the capture; the
    # replays (the capture's own and two more) launch the captured kernels
    # without them
    joint_calls = wrapper_calls(joint.graphs)
    check(joint_calls == 2 and joint.graphs.replays == 3,
          f"joint CLI: {joint_calls} eager calls and captures, {joint.graphs.replays} replays")
    for name, count in joint_cli_launches.items():
        check(count == per_step[name] * joint_calls, f"joint CLI: {name} launched {count} "
              f"times over 4 steps, expected {per_step[name] * joint_calls}")
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
    print(json.dumps({"train": "joint CLI, full width",
                      "steps": [int(joint.step), int(resumed.step)],
                      "pretrain_steps": int(pre.step), "launches": joint_cli_launches,
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
        """The resumed run's nets in a joint trainer with a fresh Adam,
        eager (phase 15 holds the captured step against it)."""
        nets = train_joint.build_nets(jcfg, cfg.num_points, K, False, False, dev)
        if plain:
            nets = (Backbone(dataclasses.replace(nets[0].cfg, fps_impl="plain",
                                                 ballquery_impl="plain",
                                                 knn_impl="plain")).to(dev), *nets[1:])
        for net, key in zip(nets, ("model", "implicit_net", "pn_encoder", "loaded_encoder")):
            net.load_state_dict(state9[key], strict=True)
        return train_joint.JointTrainer(*nets, jcfg, num_sk_points=SK,
                                        is_pc_train=is_pc_train, is_im_train=True,
                                        with_im_loss=True, step=state9["step"], graph=False)

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

    # ms per eager joint step and per eager pretrain step (CUDA events,
    # after a warm-up; phase 15 times the captured ones), their peak
    # memory, and the pretrain step at the reference's B=16 in chunks of
    # 32 instances
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
    pre = train_joint.ImPretrainer(pre.implicit, pre.encoder, graph=False)
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
    del sess, small  # their graph pools
    recon_launches = reconstruction_phase(args, card, dev, counters, per_forward, work.name,
                                          logdir, joint_dir)
    pack_launches = preprocessing_phase(card, dev, counters, per_step, work.name)
    bf16_launches = bf16_phase(args, card, dev, work.name)
    work.cleanup()
    print(json.dumps({"script_s": time.perf_counter() - script_t0}), flush=True)

    rows.extend(ring_rows)
    rows.extend(large_rows_)
    for row in rows:
        kernel = row["name"].split("@")[0]
        row["large_launches"] = {key: val[kernel] for key, val in large_paths.items()}
        row["eval_launches"] = {"n8192": eval_launches[kernel],
                                "n512": eval_launches_512[kernel],
                                "n8192_implicit": im_launches["sketch"][kernel],
                                "n8192_implicit_whole_pc": im_launches["whole pc, axis"][kernel]}
        row["serve_latents_launches"] = lat_launches[kernel]
        row["recon_launches"] = recon_launches[kernel]
        row["pack_launches"] = pack_launches[kernel]
        row["parallel_launches"] = {key: val[kernel] for key, val in parallel_launches.items()}
        row["bf16_launches"] = {key: val[kernel] for key, val in bf16_launches.items()}
        row["graph_launches"] = {key: val[kernel] for key, val in graph_launches.items()}
        row["joint_launches"] = {"step_pc_train": step_launches[kernel],
                                 "step_pc_frozen": frozen_launches[kernel],
                                 "cli_4_steps": joint_cli_launches[kernel],
                                 "pretrain_cli_4_steps": pretrain_launches[kernel]}
        if "launches" in row:  # phase 17's rows: the launches of its paths
            pass
        elif kernel == "fps_ring_step":
            row["launches"] = parallel_launches["sharded_forward_p2"][kernel]
        elif kernel == "ball_query":
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
