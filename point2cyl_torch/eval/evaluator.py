"""Evaluator: the reference ``eval.py`` metric pipeline (the port of the
JAX ``eval/evaluator.py``).

    python -m point2cyl_torch.eval.evaluator --logdir runs/ab_s5 \
        --data_dir ab_data --data_split test --num_point 512 \
        --batch_size 8 --no_implicit --seed 0          # on the card
    python -m point2cyl_torch.eval.evaluator --logdir runs/joint \
        --im_logdir runs/igr ...                  # with the fitting metrics
    python -m point2cyl_torch.eval.evaluator ... --device cpu

The flag names are the reference's (``eval.py:36-75``), including its
store_false quirk: ``--pred_seg``, ``--pred_normal`` and ``--pred_bb``
switch a head OFF. ``--synthetic N`` evaluates N generated solids,
``--device`` picks the device (default the card). The backbone is
restored from ``<logdir>/model.pth`` or ``pc_model.pth``
(``{"model": state_dict}``, the port trainer's and the reference's
format). Unless ``--no_implicit``, the implicit stack (``ImplicitNet``
and the sketch encoder: 4 channels, or with ``--use_whole_pc`` 4 or,
with ``--use_extrusion_axis_feat``, 7) is restored from
``<im_logdir>/model.pth`` or ``im_model.pth`` in either reference layout
(``core/checkpoint.py``) and the two fitting metrics are computed. The
metric block of ``eval.py:705-722`` is printed and written to
``<logdir>/log_evaluate.txt``. ``--visu`` writes a labelled cloud of
each sample and the render scripts into ``--dump_dir`` and, with the
implicit stack, an SDF contour plot of each ground-truth instance
(which needs matplotlib: without it the run raises before its first
batch).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Iterable

import torch

from point2cyl_torch.core.checkpoint import (CheckpointManager, restore_backbone,
                                             restore_implicit_stack)
from point2cyl_torch.core.config import BackboneConfig, EvalConfig
from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.core.graphs import StepGraphs
from point2cyl_torch.data.h5_io import load_h5
from point2cyl_torch.data.pipeline import InputPipeline
from point2cyl_torch.data.synthetic import generate_dataset
from point2cyl_torch.eval import metrics as M
from point2cyl_torch.losses.normal import normal_difference
from point2cyl_torch.losses.segmentation import reorder_w
from point2cyl_torch.models.backbone import Backbone
from point2cyl_torch.models.implicit import ImplicitNet, PointNetEncoder
from point2cyl_torch.ops.geometry import add_noise, extrusion_extents, sketch_projection
from point2cyl_torch.ops.matching import one_hot_labels
from point2cyl_torch.recon import plots
from point2cyl_torch.recon.render_scripts import RenderScriptWriter
from point2cyl_torch.serve.export import head_output_sizes
from point2cyl_torch.train.steps import assemble_heads

# metrics kept per cloud, not averaged
PER_SAMPLE_KEYS = ("pred_labels", "pred_bb_labels", "extents", "latents")


def encoder_for(cfg: EvalConfig, latent: int = 256) -> PointNetEncoder:
    """The sketch encoder the evaluator's flags call for: the 4-channel
    sketch ``[p2d / scale | n2d]``, or with ``use_whole_pc`` the cloud and
    its weight channel (4), with ``use_extrusion_axis_feat`` also the axis
    (7)."""
    if cfg.use_whole_pc:
        return PointNetEncoder(latent, 7 if cfg.use_extrusion_axis_feat else 4,
                               with_normals=False)
    return PointNetEncoder(latent, 2, with_normals=True)


def make_eval_step(model: Backbone, cfg: EvalConfig, num_sk_points: int,
                   implicit: ImplicitNet | None = None,
                   encoder: PointNetEncoder | None = None,
                   graph: bool = True) -> Callable:
    """The per-batch evaluation: ``step(batch, generator)`` returns the
    per-cloud metrics (miou, normal_error_deg, bb_accuracy,
    axis_error_deg, centroid_difference), the labels (pred_labels with
    the seg head, pred_bb_labels with the bb head) and the extents. With
    ``implicit`` and ``encoder`` (in eval mode, on the model's device) it
    also returns the latents (B, K, L) and the two fitting metrics,
    fit_cyl_loss and fit_global_loss (``eval.py:463-590``).

    ``generator`` (on the model's device) draws, in this order: the input
    noise (with ``cfg.add_noise``), the extents' segment samples, the
    latents' sketch samples, the per-cylinder fitting samples and the
    global fitting samples. ``None`` takes the deterministic segment draw
    and needs ``cfg.add_noise`` off.

    On the card the step runs as a captured CUDA graph per batch shape
    (``core/graphs.py``), the counterpart of JAX's jitted eval step: the
    first call on a shape runs eagerly, the second captures, later ones
    replay. A replay's outputs are the graph's buffers, valid until the
    step's next call. ``graph=False`` runs every call eagerly.
    """
    if (implicit is None) != (encoder is None):
        raise ValueError("the fitting metrics need both implicit and encoder")
    if not (cfg.pred_normal or cfg.use_gt_normals):
        # the JAX evaluator builds 3x3 axis matrices from the 1-wide
        # dummy normal head by clamped out-of-range indexing
        raise ValueError("the axis error needs 3-channel normals: with the normal "
                         "head off, evaluate with use_gt_normals")
    for module in (model, implicit, encoder):
        if module is not None:
            module.eval()

    graphs = StepGraphs(next(model.parameters()).device, enabled=graph)
    names = ("point_cloud", "normals", "extrusion_labels", "base_barrel_labels",
             "extrusion_axes", "extrusion_centers")

    def eval_step(batch: dict, generator: torch.Generator | None = None) -> dict:
        if cfg.add_noise and generator is None:
            raise ValueError("add_noise draws from a generator; pass one")
        return graphs(body, {name: batch[name] for name in names}, generator)

    @torch.no_grad()
    def body(batch: dict, generator: torch.Generator | None) -> dict:
        pts = batch["point_cloud"]
        if cfg.add_noise:
            # reference eval.py:239-240: inputs moved along the GT normals
            pts = add_noise(generator, pts, batch["normals"], sigma=cfg.noise_sigma)
        i_gt = batch["extrusion_labels"]
        gt_bb = batch["base_barrel_labels"]
        gt_axes = batch["extrusion_axes"]
        gt_centers = batch["extrusion_centers"]
        b, k = gt_axes.shape[:2]

        x_raw, w_raw = model(pts)
        heads = assemble_heads(x_raw, w_raw, cfg.pred_seg, cfg.pred_bb, k=k)
        zeros = torch.zeros((b,), dtype=pts.dtype, device=pts.device)

        out = {}
        if cfg.pred_seg:
            seg = M.segmentation_metrics(heads.w, i_gt)
            # labels for visualisation (eval.py:322-326: invalid columns
            # forced to -1 before the argmax)
            w_vis = reorder_w(seg.w_hard, seg.matching)
            w_vis = torch.where(seg.mask[:, None, :], w_vis, torch.full_like(w_vis, -1.0))
            out["pred_labels"] = torch.argmax(w_vis, dim=-1)
        else:
            seg = M.SegMetrics(torch.ones_like(zeros),
                               torch.zeros((b, k), dtype=torch.int64, device=pts.device),
                               torch.ones((b, k), dtype=torch.bool, device=pts.device),
                               torch.zeros_like(heads.w))
        out["miou"] = seg.miou

        out["normal_error_deg"] = (
            normal_difference(heads.normals, batch["normals"], in_radians=False)
            if cfg.pred_normal else zeros)
        if cfg.pred_bb:
            out["bb_accuracy"], out["pred_bb_labels"] = M.base_barrel_accuracy(
                heads.w_2k, gt_bb)
        else:
            out["bb_accuracy"] = zeros

        wb, wc, ea_w = M.axis_estimation_weights(
            cfg, seg, heads.w, heads.w_barrel, heads.w_base, heads.w_2k, i_gt, gt_bb)
        out["axis_error_deg"], axes = M.axis_metrics(
            cfg, heads.normals, batch["normals"], wb, wc, i_gt, gt_bb, gt_axes)
        centers, _ = M.hard_segment_centers(pts, ea_w)
        out["centroid_difference"] = M.centroid_metric(centers, gt_centers, i_gt)
        out["extents"], _ = extrusion_extents(generator, pts, i_gt, gt_bb, gt_axes,
                                              gt_centers, num_samples=num_sk_points)
        if implicit is None:
            return out

        # latent extraction (eval.py:463-543)
        w_re = reorder_w(heads.w, seg.matching)
        w_re = torch.where(seg.mask[:, None, :], w_re, torch.zeros_like(w_re))
        pred_label = torch.argmax(w_re, dim=-1)
        pred_bb = torch.argmax(M.base_barrel_probs(heads.w_2k), dim=-1)
        if cfg.use_whole_pc:
            # the whole cloud with instance k's weight channel (and its axis)
            # (eval.py:468-486,511-531)
            n = pts.shape[1]
            if cfg.use_gt_im:
                w_chan, ax_feat = one_hot_labels(i_gt, k, pts.dtype), gt_axes
            else:
                w_chan, ax_feat = w_re, axes
            parts = [pts[:, None].expand(b, k, n, 3), w_chan.transpose(1, 2)[..., None]]
            if cfg.use_extrusion_axis_feat:
                parts.append(ax_feat[:, :, None, :].expand(b, k, n, 3))
            enc_in = torch.cat(parts, dim=-1).reshape(b * k, n, -1)
            latents = encoder(enc_in).reshape(b, k, -1)
            _, _, scales, _ = sketch_projection(generator, pts, heads.normals, pred_label,
                                                pred_bb, axes, centers,
                                                num_samples=num_sk_points)
        else:
            proj = ((batch["normals"], i_gt, gt_bb, gt_axes, gt_centers) if cfg.use_gt_im
                    else (heads.normals, pred_label, pred_bb, axes, centers))
            p2d, n2d, scales, _ = sketch_projection(generator, pts, *proj,
                                                    num_samples=num_sk_points)
            enc_in = torch.cat([p2d / scales[..., None, None], n2d], dim=-1)
            latents = encoder(enc_in.reshape(b * k, num_sk_points, 4)).reshape(b, k, -1)
        out["fit_cyl_loss"], out["fit_global_loss"] = M.fitting_losses(
            implicit, generator, pts, batch["normals"], i_gt, gt_bb, axes, centers,
            scales, latents, seg.mask, num_sk_points)
        out["latents"] = latents
        return out

    eval_step.graphs = graphs
    return eval_step


def evaluate(
    model: Backbone,
    batches: InputPipeline | Iterable[dict],
    cfg: EvalConfig,
    batch_size: int,
    seed: int = 0,
    log: Callable[[str], None] = print,
    implicit: ImplicitNet | None = None,
    encoder: PointNetEncoder | None = None,
    visu_dir: str | None = None,
    graph: bool = True,
) -> dict[str, float]:
    """The metric sweep; returns the metric means (``eval.py:697-722``),
    with ``implicit`` and ``encoder`` also the fitting metrics'. With
    ``visu_dir``, also emit labelled point clouds + render.sh
    (``eval.py:659-664``) and, with the implicit stack, per-instance SDF
    contour plots (``eval.py:667-692``).

    ``batches`` is an ``InputPipeline``, read in row order in batches of
    ``batch_size``, or any iterable of batch dicts on the model's device.
    Every draw (subsamples, noise, extents) comes from one generator
    seeded with ``seed``. The per-batch sums stay on the device until the
    sweep ends, so the loop never waits for the card. On the card each
    batch shape's step is captured (:func:`make_eval_step`), and each
    batch's sums and visualisation are taken from the step's outputs
    before the next call; ``graph=False`` runs the steps eagerly.
    """
    dev = next(model.parameters()).device
    writer = None
    if visu_dir:
        if implicit is not None:
            plots.require_matplotlib()
        writer = RenderScriptWriter(visu_dir)
    step = make_eval_step(model, cfg, cfg.num_sketch_samples, implicit, encoder, graph)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if isinstance(batches, InputPipeline):
        batches = batches.epochs(batch_size, gen, shuffle=False)
    names, sums, count = None, [], 0
    t0 = time.time()
    for i, batch in enumerate(batches):
        out = step(batch, gen)
        if names is None:
            names = [name for name in out if name not in PER_SAMPLE_KEYS]
        sums.append(torch.stack([out[name].sum() for name in names]))
        if writer is not None:
            _visualize(writer, i, batch, out, implicit)
        count += int(batch["point_cloud"].shape[0])
        if i % 20 == 0:
            log(f"Time elapsed: {time.time() - t0:.1f} sec for batch {i}.")
    if writer is not None:
        render_sh, image_sh = writer.finalize()
        log(f"Wrote {render_sh} and {image_sh}")
    totals = {name: 0.0 for name in names or ()}
    for row in torch.stack(sums).tolist() if sums else ():
        for name, val in zip(names, row):
            totals[name] += val
    means = {name: s / max(count, 1) for name, s in totals.items()}

    log("=" * 20)
    log(f"Num evaluated= {count}")
    log(f"Mean mIOU= {means.get('miou', 0.0)}")
    log(f"Mean normal angle error (degrees) = {means.get('normal_error_deg', 0.0)}")
    log(f"Mean base/barrel accuracy= {means.get('bb_accuracy', 0.0)}")
    log(f"Mean extrusion angle error (degrees) = {means.get('axis_error_deg', 0.0)}")
    log(f"Mean centroid difference = {means.get('centroid_difference', 0.0)}")
    log(f"Mean per-extrusion cylinder fitting loss= {means.get('fit_cyl_loss', 0.0)}")
    log(f"Mean global fitting loss= {means.get('fit_global_loss', 0.0)}")
    return means


def _visualize(writer: RenderScriptWriter, i: int, batch: dict, out: dict,
               implicit: ImplicitNet | None) -> None:
    """Batch ``i``'s labelled clouds, named ``{i}_{j}_{miou:.3f}``, and with
    latents one SDF contour plot (resolution 128) of each ground-truth
    instance, as the JAX evaluator draws them."""
    pts = batch["point_cloud"].cpu().numpy()
    gt = batch["extrusion_labels"].cpu().numpy()
    miou = out["miou"].cpu().numpy()
    pred = out["pred_labels"].cpu().numpy() if "pred_labels" in out else gt
    for j in range(len(pts)):
        writer.add_pointcloud(f"{i}_{j}_{miou[j]:.3f}", pts[j], pred[j], gt[j])
    if implicit is None or "latents" not in out:
        return
    lat = out["latents"]
    n_inst = gt.max(axis=1) + 1
    for j in range(len(pts)):
        for kk in range(int(n_inst[j])):
            plots.plot_surface_2d(implicit, writer.dump_dir, f"{i}_{j}", str(kk),
                                  lat[j, kk], resolution=128)


def build_argparser() -> argparse.ArgumentParser:
    """Reference-compatible CLI (``eval.py:36-75``). The reference uses
    store_false: passing --pred_seg/--pred_normal/--pred_bb DISABLES that
    head (they default ON)."""
    p = argparse.ArgumentParser(description="Evaluator of the PyTorch/CUDA port")
    p.add_argument("--num_point", type=int, default=8192)
    p.add_argument("--num_sk_point", type=int, default=2048)
    p.add_argument("--K", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--logdir", default="results/Point2Cyl", type=str)
    p.add_argument("--im_logdir", default="results/IGR_dense", type=str)
    p.add_argument("--data_dir", type=str, default="data/")
    p.add_argument("--data_split", default="test", type=str)
    p.add_argument("--dump_dir", default="dump/", type=str)
    p.add_argument("--pred_seg", action="store_false")
    p.add_argument("--pred_normal", action="store_false")
    p.add_argument("--pred_bb", action="store_false")
    p.add_argument("--use_gt_normals", action="store_true")
    p.add_argument("--use_gt_segmentation", action="store_true")
    p.add_argument("--use_gt_bb", action="store_true")
    p.add_argument("--use_gt_im", action="store_true")
    p.add_argument("--use_whole_pc", action="store_true")
    p.add_argument("--use_extrusion_axis_feat", action="store_true")
    p.add_argument("--norm_eig", action="store_true")
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("--noise_sigma", type=float, default=0.01)
    p.add_argument("--visu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", type=int, default=None,
                   help="evaluate N synthetic solids instead of h5 data")
    p.add_argument("--synthetic_resolution", type=int, default=8192)
    p.add_argument("--no_implicit", action="store_true",
                   help="skip the implicit fitting metrics")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p


def cli_main(argv: list[str] | None = None) -> dict[str, float]:
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = EvalConfig(
        pred_seg=args.pred_seg,
        pred_normal=args.pred_normal,
        pred_bb=args.pred_bb,
        use_gt_normals=args.use_gt_normals,
        use_gt_segmentation=args.use_gt_segmentation,
        use_gt_bb=args.use_gt_bb,
        use_gt_im=args.use_gt_im,
        use_whole_pc=args.use_whole_pc,
        use_extrusion_axis_feat=args.use_extrusion_axis_feat,
        num_sketch_samples=args.num_sk_point,
        norm_eig=args.norm_eig,
        add_noise=args.add_noise,
        noise_sigma=args.noise_sigma,
    )
    if args.synthetic:
        ds = generate_dataset(args.synthetic, resolution=args.synthetic_resolution,
                              max_instances=args.K, num_sketch_points=args.num_sk_point,
                              seed=args.seed)
    else:
        ds = load_h5(os.path.join(args.data_dir, args.data_split + ".h5"))
    pipeline = InputPipeline(ds, args.num_point, args.K, dev)

    model = Backbone(BackboneConfig(
        num_points=args.num_point, approx_neighbors=False,
        output_sizes=head_output_sizes(args.K, cfg.pred_seg, cfg.pred_normal,
                                       cfg.pred_bb)))
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    ckpt = CheckpointManager(args.logdir)
    fout = open(os.path.join(ckpt.logdir, "log_evaluate.txt"), "w")

    def log(msg: str) -> None:
        fout.write(msg + "\n")
        fout.flush()
        print(msg, flush=True)

    name = restore_backbone(args.logdir, model)
    if name is None:
        log(f"WARNING: no checkpoint at {args.logdir}/model — fresh init")
    else:
        log(f"Restored backbone from {args.logdir}/{name}")
    implicit = encoder = None
    try:
        if not args.no_implicit:
            gen = torch.Generator().manual_seed(args.seed)
            implicit = ImplicitNet(d_in=258)
            implicit.reset_parameters(gen)
            encoder = encoder_for(cfg)
            encoder.reset_parameters(gen)
            name = restore_implicit_stack(args.im_logdir, implicit, encoder)
            if name is None:
                log(f"WARNING: no implicit checkpoint at {args.im_logdir} — "
                    "fresh init (fitting metrics not meaningful)")
            else:
                log(f"Restored implicit stack from {args.im_logdir}/{name}")
            implicit, encoder = implicit.to(dev), encoder.to(dev)
        return evaluate(model.to(dev), pipeline, cfg, args.batch_size, seed=args.seed,
                        log=log, implicit=implicit, encoder=encoder,
                        visu_dir=args.dump_dir if args.visu else None)
    finally:
        fout.close()


if __name__ == "__main__":
    cli_main()
