"""Trainer B: joint training of the backbone with the implicit sketch
stack, and IGR pretraining (the port of
``point2cyl_tpu/train/train_joint.py``; reference ``train_Point2Cyl.py``).

    python -m point2cyl_torch.train.train_joint --pretrain_im --synthetic 8 \
        --K 8 --batch_size 4 --num_sk_point 2048 --logdir runs/igr
    python -m point2cyl_torch.train.train_joint --synthetic 8 --K 8 \
        --batch_size 4 --is_pc_init --pc_logdir runs/pc --is_im_init \
        --im_logdir runs/igr --is_pc_train --is_im_train --with_im_loss \
        --init_global_step -1 --pred_seg --pred_normal --pred_bb \
        --pred_extrusion --pred_center --logdir runs/joint

Both run on the card unless given ``--device cpu``. ``--data_parallel``
and ``--multihost`` run them data parallel as Trainer A's flags do
(``train_pc.run_data_parallel``): global BN statistics and draws, the
gradients of both Adam groups averaged over the ranks before the guard,
rank 0 writing the checkpoints and the log.

The joint step is Trainer A's proxy path plus the latents of the
predicted sketches (projected onto the GT axes and scaled by the GT
projection's scale), the IGR losses of the GT sketches under those
latents through a frozen SDF decoder, and a latent loss against a frozen
pretrained encoder on the GT sketches. Staged init and freeze
(``--is_pc_init/--is_im_init/--is_pc_train/--is_im_train``) choose what
is loaded and what trains: a frozen net is in no Adam group and runs in
eval mode. ``--pretrain_im`` trains the encoder and the decoder on GT
sketches alone: the provenance of the reference's ``results/IGR_dense``.

Checkpoints: ``--pretrain_im`` writes ``<logdir>/model.pth`` in the IGR
layout ``{"model_state_dict", "encoder_state_dict"}``; the joint trainer
writes ``model.pth`` in the reference's 3-net layout ``{"model",
"implicit_net", "pn_encoder"}`` plus the loaded encoder, Adam, step,
epoch and best loss, and ``pc_model.pth`` ``{"model"}`` and
``im_model.pth`` ``{"implicit_net", "pn_encoder"}`` (the trained
encoder), so the evaluator and the export CLI read its logdir as it is.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import torch

from point2cyl_torch.core.checkpoint import CheckpointManager, restore_implicit_stack
from point2cyl_torch.core.config import TrainConfig
from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.core.logging import TrainLogger
from point2cyl_torch.core.profiling import mark
from point2cyl_torch.core.schedules import staircase_bn_momentum, staircase_lr
from point2cyl_torch.data.h5_io import load_h5
from point2cyl_torch.data.pipeline import InputPipeline
from point2cyl_torch.data.synthetic import generate_dataset
from point2cyl_torch.losses.igr import igr_losses, latent_loss
from point2cyl_torch.losses.segmentation import reorder_w
from point2cyl_torch.models.implicit import ImplicitNet, PointNetEncoder
from point2cyl_torch.ops.geometry import sketch_projection
from point2cyl_torch.ops.matching import mask_gt_from_labels
from point2cyl_torch.train import steps
from point2cyl_torch.parallel.distributed import process_batch_slice
from point2cyl_torch.parallel.mesh import replicate, use_global_batch_norm
from point2cyl_torch.train.train_pc import (add_parallel_args, build_model, config_from_args,
                                            epoch_generator, run_data_parallel)

LATENT_SIZE = 256
IM_LR = 1e-3  # the encoder's: the reference never steps its schedule
              # (only param group 0 is updated, train_Point2Cyl.py:707)


def _adam(groups) -> torch.optim.Adam:
    """Adam as optax's ``adam`` (``steps.make_optimizer``)."""
    return torch.optim.Adam(groups, lr=IM_LR, betas=(0.9, 0.999), eps=1e-8)


def build_nets(cfg: TrainConfig, num_points: int, k: int, use_whole_pc: bool,
               use_axis_feat: bool, device: str | torch.device | None = None):
    """The backbone (``train_pc.build_model``), the SDF decoder, the
    trainable encoder (2x2 channels with normals, or 4 or 7 channels on
    the whole cloud) and the loaded encoder (2x2 channels), on ``device``.
    The decoder and encoders are drawn from ``cfg.seed``'s stream 0,
    which no epoch's generator uses."""
    dev = resolve_device(device)
    backbone = build_model(cfg, num_points, k, dev)
    gen = epoch_generator(cfg.seed, 0, torch.device("cpu"))
    implicit = ImplicitNet(d_in=2 + LATENT_SIZE)
    implicit.reset_parameters(gen)
    if use_whole_pc:
        encoder = PointNetEncoder(LATENT_SIZE, 7 if use_axis_feat else 4,
                                  with_normals=False)
    else:
        encoder = PointNetEncoder(LATENT_SIZE, 2, with_normals=True)
    encoder.reset_parameters(gen)
    loaded_encoder = PointNetEncoder(LATENT_SIZE, 2, with_normals=True)
    loaded_encoder.reset_parameters(gen)
    return backbone, implicit.to(dev), encoder.to(dev), loaded_encoder.to(dev)


def resolve_igr_chunk(flag: int, m: int) -> int | None:
    """``--igr_chunk``: < 0 never chunk, 0 chunks of 32 once the B*K
    instance axis exceeds 32, > 0 that chunk."""
    if flag < 0:
        return None
    if flag == 0:
        return 32 if m > 32 else None
    return flag


class _AdamGroup(NamedTuple):
    """One Adam group of the joint trainer: its parameters, their gradient
    (a slice of the flat buffer), moments (2, n) and its own update count
    (0-dim int64 on the device)."""

    name: str
    params: list[torch.nn.Parameter]
    grad: torch.Tensor
    moments: torch.Tensor
    count: torch.Tensor


class JointTrainer:
    """The joint trainer's state (four nets, Adam, step) and its step
    (JAX ``make_joint_train_step``, ``train_joint.py:127-293``).

    Adam has a group for each net that trains: the backbone's on the
    staircase learning rate of the step, the encoder's at ``IM_LR``.
    ``step`` (a 0-dim int64 on the device) starts where
    ``--init_global_step`` puts it and drives the schedules; each group
    keeps its own count of updates for the bias correction, from 0, as
    JAX's fresh optimiser state does. With a ``mesh`` the step is data
    parallel (``train/steps.py``) and the four nets are replicated from
    rank 0.

    The step is one program, as Trainer A's (``train/steps.py``): the
    trained nets' gradients live in one flat buffer (each ``grad`` a view
    of it), the update is optax's Adam as device-side selects
    (``steps.adam_select``), and ``ok`` (the loss and every gradient
    finite) chooses every group's parameters, moments and count, the
    trained nets' BN statistics and the step alike, so nothing is read
    back. On the card it runs as a captured CUDA graph after its first
    call with each batch shape (``core/graphs.py``), data parallel over
    NCCL too; over a host-staged mesh, or with ``graph=False``, eagerly.
    ``optimizer`` is a ``torch.optim.Adam`` that only holds the state, in
    its checkpoint layout (two groups). On the card the step's phases
    carry markers (``core/profiling.py``): ``train_forward`` (the frozen
    encoder's GT latents, the backbone, the heads), ``train_loss`` (the
    proxy losses and the matching), ``train_sketch`` (both sketch
    projections and the encoder), ``train_igr`` (the IGR and latent
    losses), ``train_backward``, ``train_update`` and ``end``.
    """

    def __init__(self, backbone: torch.nn.Module, implicit: ImplicitNet,
                 encoder: PointNetEncoder, loaded_encoder: PointNetEncoder,
                 cfg: TrainConfig, *, num_sk_points: int, is_pc_train: bool,
                 is_im_train: bool, with_im_loss: bool, is_l2: bool = False,
                 use_gt_im: bool = False, igr_chunk: int | None = None, step: int = 0,
                 mesh=None, graph: bool = True):
        self.backbone, self.implicit = backbone, implicit
        self.encoder, self.loaded_encoder = encoder, loaded_encoder
        self.cfg = cfg
        self.num_sk_points = num_sk_points
        self.is_pc_train, self.is_im_train = is_pc_train, is_im_train
        self.with_im_loss, self.is_l2, self.use_gt_im = with_im_loss, is_l2, use_gt_im
        self.igr_chunk = igr_chunk
        self.mesh = mesh
        if mesh is not None:
            for net in (backbone, implicit, encoder, loaded_encoder):
                use_global_batch_norm(net, mesh)
                replicate(mesh, net)
        for net, trains in ((backbone, is_pc_train), (encoder, is_im_train),
                            (implicit, False), (loaded_encoder, False)):
            net.requires_grad_(trains)
        like = next(backbone.parameters())
        dev = like.device
        # updates applied; skipped steps do not count
        self.step = torch.full((), step, dtype=torch.int64, device=dev)
        self._keys = ("total", "normal", "miou", "bb", "extrusion", "center",
                      *(("manifold", "eikonal", "sald") if with_im_loss else ()),
                      "latent", "im_total")
        named = [(net, name) for net, name, trains in ((backbone, "pc", is_pc_train),
                                                       (encoder, "enc", is_im_train))
                 if trains]
        self._params = [p for net, _ in named for p in net.parameters()]
        self._grads = steps.FlatGrads(self._params, len(self._keys), like=like)
        self._kept = steps.KeptState([b for net, _ in named for b in net.buffers()])
        self._im_lr = torch.full((), IM_LR, device=dev)
        self._groups: list[_AdamGroup] = []
        offset = 0
        for net, name in named:
            params = list(net.parameters())
            n = sum(p.numel() for p in params)
            self._groups.append(_AdamGroup(
                name, params, self._grads.grad[offset:offset + n],
                torch.zeros(2, n, device=dev, dtype=like.dtype),
                torch.zeros((), dtype=torch.int64, device=dev)))
            offset += n
        self.optimizer = (_adam([{"params": g.params, "name": g.name} for g in self._groups])
                          if self._groups else None)
        for g in self._groups:
            for p, m, v in zip(g.params, steps._views(g.moments[0], g.params),
                               steps._views(g.moments[1], g.params)):
                self.optimizer.state[p] = {"step": g.count, "exp_avg": m, "exp_avg_sq": v}
        self.graphs = steps.step_graphs(dev, graph, mesh)
        self._static = (is_pc_train, is_im_train, with_im_loss, use_gt_im, is_l2)

    @property
    def device(self) -> torch.device:
        return next(self.backbone.parameters()).device

    def loss(self, batch: dict, generator: torch.Generator | None, *,
             fps_starts=None, off_pts: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The joint loss of ``batch`` and its parts. The backbone's FPS
        starts and dropout mask, the two segment draws and the off-surface
        samples come from ``generator``; ``fps_starts`` and ``off_pts``
        replace their draws, and ``generator=None`` takes the
        deterministic segment draw (the parity tests feed both sides
        these)."""
        cfg = self.cfg
        momentum = staircase_bn_momentum(self.step, cfg.batch_size, cfg.bn_decay_step,
                                         cfg.bn_init_momentum, cfg.bn_decay_rate,
                                         cfg.bn_momentum_clip)
        pts = batch["point_cloud"]
        generator = steps.step_generator(self.mesh, generator, pts.shape[0])
        i_gt, gt_bb = batch["extrusion_labels"], batch["base_barrel_labels"]
        axes, centers = batch["extrusion_axes"], batch["extrusion_centers"]
        b, k = axes.shape[:2]
        mask_gt = mask_gt_from_labels(i_gt, k)
        sk = batch["sketches"]  # (B, K, S, 4)
        with torch.no_grad():
            gt_latents = self.loaded_encoder(sk.reshape(b * k, sk.shape[2], 4)
                                             ).reshape(b, k, -1)

        if self.is_pc_train:
            x_raw, w_raw = self.backbone(pts, train=True, bn_momentum=momentum,
                                         generator=generator, fps_starts=fps_starts)
        else:
            x_raw, w_raw = self.backbone(pts)
        heads = steps.assemble_heads(x_raw, w_raw, cfg.pred_seg, cfg.pred_bb, k=k)
        mark("train_loss", pts)
        proxy_total, aux, matching, mask = steps.proxy_losses_and_matching(
            heads, batch, cfg)

        # the predicted sketches' latents (train_Point2Cyl.py:516-599)
        mark("train_sketch", pts)
        if self.use_gt_im:
            proj_normals, proj_label, proj_bb = batch["normals"], i_gt, gt_bb
        else:
            w_reordered = reorder_w(heads.w, matching)
            w_reordered = torch.where(mask[:, None, :], w_reordered,
                                      torch.zeros_like(w_reordered))
            proj_label = w_reordered.argmax(dim=-1)
            bb_probs = torch.stack([heads.w_2k[:, :, ::2].sum(-1),
                                    heads.w_2k[:, :, 1::2].sum(-1)], dim=-1)
            proj_bb = bb_probs.argmax(dim=-1)
            proj_normals = heads.normals
        # projected onto the GT axes and centres, and normalised by the GT
        # projection's scale (train_Point2Cyl.py:548-552)
        p2d, n2d, _, _ = sketch_projection(generator, pts, proj_normals, proj_label,
                                           proj_bb, axes, centers,
                                           num_samples=self.num_sk_points)
        _, _, gt_scales, _ = sketch_projection(generator, pts, batch["normals"], i_gt,
                                               gt_bb, axes, centers,
                                               num_samples=self.num_sk_points)
        p2d = p2d / gt_scales[..., None, None]
        enc_in = torch.cat([p2d, n2d], dim=-1).reshape(b * k, self.num_sk_points, 4)
        if self.is_im_train:
            latents = self.encoder(enc_in, train=True, momentum=momentum)
        else:
            latents = self.encoder(enc_in)
        latents = latents.reshape(b, k, -1)

        # IGR and latent losses (train_Point2Cyl.py:608-672)
        mark("train_igr", pts)
        im_total = torch.zeros((), dtype=pts.dtype, device=pts.device)
        if self.with_im_loss:
            igr = igr_losses(self.implicit, generator, sk[..., :2], sk[..., 2:], latents,
                             mask_gt, eikonal_weight=cfg.weights.igr_eikonal,
                             normals_weight=cfg.weights.igr_normal, off_pts=off_pts,
                             chunk_size=self.igr_chunk)
            im_total = igr.total
            aux.update(manifold=igr.manifold, eikonal=igr.eikonal, sald=igr.normals)
        lat_loss = latent_loss(latents, gt_latents, mask_gt, self.is_l2)
        im_total = im_total + cfg.weights.sketch_latent * lat_loss
        total = proxy_total + im_total if self.is_pc_train else im_total
        aux.update(latent=lat_loss, im_total=im_total, total=total)
        return total, aux

    def train_step(self, batch: dict, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """One optimiser step on ``batch``, every draw from ``generator``.
        The non-finite guard keeps the whole state (the trained nets' BN
        statistics and counts, both Adam groups, the step) when the loss
        or a gradient is not finite. Returns the loss scalars on the device
        and ``skipped``, fresh tensors at every call; the gradients stay on
        the parameters until the next step."""
        vals = self.graphs(self._step, batch, generator,
                           static=(*self._static, self.igr_chunk)).clone()
        return dict(zip((*self._keys, "skipped"), vals.unbind()))

    def _step(self, batch: dict, generator) -> torch.Tensor:
        """The step's body, with no host read: the loss scalars and
        ``skipped`` stacked in the order of ``train_step``'s keys."""
        pts = batch["point_cloud"]
        mark("train_forward", pts)
        kept = self._kept.take()
        self._grads.zero()
        total, aux = self.loss(batch, generator)
        mark("train_backward", pts)
        if total.requires_grad:
            total.backward()
        aux = steps.mean_over_ranks(self.mesh, self._grads.buffer, aux)
        mark("train_update", pts)
        with torch.no_grad():
            ok = torch.isfinite(aux["total"]) & torch.isfinite(self._grads.grad).all()
            self._update(ok)
            self._kept.keep_unless(ok, kept)
        aux["skipped"] = 1.0 - ok.to(aux["total"].dtype)
        vals = torch.stack([aux[key] for key in (*self._keys, "skipped")])
        mark("end", pts)
        return vals

    @torch.no_grad()
    def _update(self, ok: torch.Tensor) -> None:
        """Where ``ok``: one Adam update of each group from the gradients
        in the flat buffer, the backbone's at the staircase learning rate
        of ``step``, the encoder's at ``IM_LR``, each bias-corrected by its
        own count; then the counts and the step advance."""
        cfg = self.cfg
        for g in self._groups:
            lr = (staircase_lr(self.step, cfg.batch_size, cfg.learning_rate, cfg.decay_step,
                               cfg.decay_rate) if g.name == "pc" else self._im_lr)
            steps.adam_select(g.params, g.grad, g.moments, g.count, lr, ok)
            g.count.copy_(torch.where(ok, g.count + 1, g.count))
        self.step.copy_(torch.where(ok, self.step + 1, self.step))

    def state_dict(self) -> dict:
        """The reference's 3-net layout plus what an exact resume needs:
        Adam in torch's ``Adam.state_dict`` layout (each parameter's
        ``step`` its group's count, a CPU float32) and ``step`` as an int.
        A host read for the step and for each group's count."""
        opt = None
        if self.optimizer is not None:
            opt = self.optimizer.state_dict()
            for group, g in zip(opt["param_groups"], self._groups):
                count = torch.tensor(float(g.count))
                for i in group["params"]:
                    opt["state"][i] = dict(opt["state"][i], step=count)
        return {"model": self.backbone.state_dict(),
                "implicit_net": self.implicit.state_dict(),
                "pn_encoder": self.encoder.state_dict(),
                "loaded_encoder": self.loaded_encoder.state_dict(),
                "optimizer": opt, "step": int(self.step)}

    def load_state_dict(self, state: dict) -> None:
        """Write ``state`` into the trainer's tensors in place, so that
        captured steps keep reading them. A checkpoint of the eager
        trainer (torch's ``Adam.state_dict`` after ``Adam.step``) loads
        too; a parameter without Adam state gets zero moments, a group
        without any a zero count."""
        for net, key in ((self.backbone, "model"), (self.implicit, "implicit_net"),
                         (self.encoder, "pn_encoder"),
                         (self.loaded_encoder, "loaded_encoder")):
            net.load_state_dict(state[key], strict=True)
        with torch.no_grad():
            if self._groups:
                saved = state["optimizer"]
                sizes = [len(group["params"]) for group in saved["param_groups"]]
                if sizes != [len(g.params) for g in self._groups]:
                    raise ValueError(f"Adam groups of {sizes} parameters in the checkpoint, "
                                     f"{[len(g.params) for g in self._groups]} in this trainer")
                for group, g in zip(saved["param_groups"], self._groups):
                    states = [saved["state"].get(i) for i in group["params"]]
                    counts = [int(st["step"]) for st in states if st is not None]
                    g.count.fill_(counts[0] if counts else 0)
                    for st, m, v in zip(states, steps._views(g.moments[0], g.params),
                                        steps._views(g.moments[1], g.params)):
                        if st is None:
                            m.zero_()
                            v.zero_()
                        else:
                            m.copy_(st["exp_avg"])
                            v.copy_(st["exp_avg_sq"])
            self.step.fill_(int(state["step"]))


class ImPretrainer:
    """IGR pretraining: the encoder (train mode, its default BN momentum)
    and the decoder on GT sketches, Adam at ``IM_LR`` (JAX
    ``make_im_pretrain_step``, ``train_joint.py:296-336``); data parallel
    with a ``mesh``, as the joint step.

    The step is one program, as the joint trainer's: ``step`` (a 0-dim
    int64 on the device) is Adam's count, the gradients live in one flat
    buffer and the update is ``steps.adam_select``, applied always (JAX's
    pretrain step has no guard). On the card it is captured per batch
    shape and chunk size; ``graph=False`` runs it eagerly.
    """

    KEYS = ("total", "manifold", "eikonal", "sald")

    def __init__(self, implicit: ImplicitNet, encoder: PointNetEncoder,
                 igr_chunk: int | None = None, mesh=None, graph: bool = True):
        self.implicit, self.encoder, self.igr_chunk = implicit, encoder, igr_chunk
        self.mesh = mesh
        if mesh is not None:
            for net in (implicit, encoder):
                use_global_batch_norm(net, mesh)
                replicate(mesh, net)
        self._params = [*implicit.parameters(), *encoder.parameters()]
        dev = self._params[0].device
        self._grads = steps.FlatGrads(self._params, len(self.KEYS))
        self._moments = torch.zeros(2, self._grads.grad.numel(), device=dev)
        self._lr = torch.full((), IM_LR, device=dev)
        self._ok = torch.ones((), dtype=torch.bool, device=dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.graphs = steps.step_graphs(dev, graph, mesh)

    def loss(self, batch: dict, generator: torch.Generator | None,
             off_pts: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        sk = batch["sketches"]
        b, k, s, _ = sk.shape
        generator = steps.step_generator(self.mesh, generator, b)
        mask_gt = mask_gt_from_labels(batch["extrusion_labels"], k)
        latents = self.encoder(sk.reshape(b * k, s, 4), train=True).reshape(b, k, -1)
        igr = igr_losses(self.implicit, generator, sk[..., :2], sk[..., 2:], latents,
                         mask_gt, off_pts=off_pts, chunk_size=self.igr_chunk)
        return igr.total, dict(zip(self.KEYS, igr))

    def train_step(self, batch: dict, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """One Adam step on ``batch``'s sketches; returns the loss scalars
        on the device and ``skipped`` (always 0), fresh at every call."""
        vals = self.graphs(self._step, batch, generator, static=(self.igr_chunk,)).clone()
        return dict(zip((*self.KEYS, "skipped"), vals.unbind()))

    def _step(self, batch: dict, generator) -> torch.Tensor:
        self._grads.zero()
        total, aux = self.loss(batch, generator)
        total.backward()
        aux = steps.mean_over_ranks(self.mesh, self._grads.buffer, aux)
        with torch.no_grad():
            steps.adam_select(self._params, self._grads.grad, self._moments, self.step,
                              self._lr, self._ok)
            self.step.add_(1)
        return torch.stack([*(aux[key] for key in self.KEYS), torch.zeros_like(total)])

    def state_dict(self) -> dict:
        """The IGR layout, which ``restore_implicit_stack`` reads."""
        return {"model_state_dict": self.implicit.state_dict(),
                "encoder_state_dict": self.encoder.state_dict()}


def staged_init_restore(backbone: torch.nn.Module, implicit: ImplicitNet,
                        encoder: PointNetEncoder, loaded_encoder: PointNetEncoder, *,
                        is_pc_init: bool, pc_logdir: str, pc_ckpt: str,
                        is_im_init: bool, im_logdir: str, im_ckpt: str,
                        log=print, carry_step: bool = False) -> int:
    """The staged recipe's initialisation (``train_Point2Cyl.py:329-344``):
    Trainer A's backbone from ``<pc_logdir>/<pc_ckpt>.pth`` (with
    ``is_pc_init``), the IGR decoder and encoder from
    ``<im_logdir>/<im_ckpt>.pth`` (either layout) into the decoder and the
    loaded encoder and, with ``is_im_init``, into the trainable encoder as
    well (its own tensors). Returns Trainer A's step with ``carry_step``,
    else 0."""
    step = 0
    if carry_step and not is_pc_init:
        raise ValueError("--init_global_step -1 carries Trainer A's step and needs "
                         "--is_pc_init")
    if is_pc_init:
        state = CheckpointManager(pc_logdir).load(pc_ckpt,
                                                  next(backbone.parameters()).device)
        backbone.load_state_dict(state["model"], strict=True)
        if carry_step:
            # continue the lr and BN staircases from Trainer A's step instead
            # of the reference's reset to 0
            step = int(state["step"])
            log(f"carrying trainer-A global step {step}")
        log("3D model loaded.")
    if restore_implicit_stack(im_logdir, implicit, loaded_encoder, im_ckpt) is None:
        log(f"WARNING: no implicit checkpoint at {im_logdir}/{im_ckpt} — implicit "
            "decoder is freshly initialized")
        return step
    if is_im_init:
        encoder.load_state_dict(loaded_encoder.state_dict(), strict=True)
    log("Pre-trained fixed implicit model loaded.")
    return step


def _rows(cfg: TrainConfig, mesh) -> slice | None:
    """This rank's rows of each global batch (None on one process)."""
    return None if mesh is None else process_batch_slice(cfg.batch_size, mesh.rank,
                                                         mesh.world)


def pretrain(args: argparse.Namespace, cfg: TrainConfig, pipeline: InputPipeline,
             logger: TrainLogger, implicit: ImplicitNet,
             encoder: PointNetEncoder, mesh=None) -> ImPretrainer:
    trainer = ImPretrainer(implicit, encoder,
                           resolve_igr_chunk(args.igr_chunk, cfg.batch_size * args.K), mesh)
    ckpt = CheckpointManager(cfg.logdir, mesh)
    steps_per_epoch = max(pipeline.num_samples // cfg.batch_size, 1)
    for epoch in range(1, cfg.num_epochs + 1):
        t0 = time.time()
        gen = epoch_generator(cfg.seed, epoch, pipeline.device)
        aux_steps = [trainer.train_step(batch, gen)
                     for batch in pipeline.epochs(cfg.batch_size, gen,
                                                  rows_slice=_rows(cfg, mesh))]
        steps.log_epoch_aux(logger, aux_steps, (epoch - 1) * steps_per_epoch)
        means = logger.epoch_means()
        logger.log(f"[pretrain_im] > Epoch {epoch:04d} done in {time.time() - t0:.1f}s | "
                   + " | ".join(f"{key}: {val:.4f}" for key, val in means.items()))
        if epoch % cfg.checkpoint_every_epochs == 0:
            ckpt.save("model", trainer.state_dict())
    ckpt.save("model", trainer.state_dict())
    return trainer


def train(args: argparse.Namespace, cfg: TrainConfig, pipeline: InputPipeline,
          logger: TrainLogger, nets, mesh=None) -> JointTrainer:
    backbone, implicit, encoder, loaded_encoder = nets
    step = staged_init_restore(
        backbone, implicit, encoder, loaded_encoder, is_pc_init=args.is_pc_init,
        pc_logdir=args.pc_logdir, pc_ckpt=args.pc_ckpt, is_im_init=args.is_im_init,
        im_logdir=args.im_logdir, im_ckpt=args.im_ckpt, log=logger.log,
        carry_step=args.init_global_step == -1)
    if args.init_global_step > 0:
        step = args.init_global_step
    trainer = JointTrainer(
        backbone, implicit, encoder, loaded_encoder, cfg,
        num_sk_points=args.num_sk_point, is_pc_train=args.is_pc_train,
        is_im_train=args.is_im_train, with_im_loss=args.with_im_loss, is_l2=args.is_L2,
        use_gt_im=args.use_gt_im,
        igr_chunk=resolve_igr_chunk(args.igr_chunk, cfg.batch_size * args.K), step=step,
        mesh=mesh)

    ckpt = CheckpointManager(cfg.logdir, mesh)
    best_loss = float("inf")
    steps_per_epoch = max(pipeline.num_samples // cfg.batch_size, 1)
    start_epoch = 1
    if cfg.resume and ckpt.exists_global("model"):
        state = ckpt.load("model", trainer.device)
        trainer.load_state_dict(state)
        # the epoch the checkpoint says, never one derived from a step that
        # --init_global_step offset
        done = int(state["epoch"])
        best_loss = float(state["best_loss"])
        start_epoch = done + 1
        logger.log(f"Resumed from {ckpt.path('model')}: epoch {done}, "
                   f"step {int(trainer.step)}, best {best_loss:.4f}")

    for epoch in range(start_epoch, cfg.num_epochs + 1):
        t0 = time.time()
        gen = epoch_generator(cfg.seed, epoch, pipeline.device)
        aux_steps = []
        for i, batch in enumerate(pipeline.epochs(cfg.batch_size, gen,
                                                  rows_slice=_rows(cfg, mesh))):
            aux = trainer.train_step(batch, gen)
            aux_steps.append(aux)
            if i % 10 == 0:
                logger.log(f"Epoch: {epoch}/{cfg.num_epochs} | Batch [{i:04d}/"
                           f"{steps_per_epoch:04d}] | " + " | ".join(
                               f"{key} {float(val):.4f}" for key, val in sorted(aux.items())))
        skipped = steps.log_epoch_aux(logger, aux_steps, (epoch - 1) * steps_per_epoch)
        steps.handle_skipped_epoch(logger, ckpt, trainer, skipped, steps_per_epoch, epoch)
        means = logger.epoch_means()
        logger.log(f"> Epoch {epoch:04d} done in {time.time() - t0:.1f}s | "
                   + " | ".join(f"{key}: {val:.4f}" for key, val in means.items()))
        best_loss = ckpt.save_epoch(epoch, trainer.state_dict(),
                                    means.get("Loss/total", float("inf")), best_loss,
                                    every=cfg.checkpoint_every_epochs,
                                    best_after=cfg.best_after_epoch)
    state = trainer.state_dict()
    ckpt.save("model", {**state, "epoch": max(cfg.num_epochs, start_epoch - 1),
                        "best_loss": best_loss})
    # the backbone and the implicit stack (the trained encoder) on their own
    ckpt.save("pc_model", {"model": state["model"]})
    ckpt.save("im_model", {"implicit_net": state["implicit_net"],
                           "pn_encoder": state["pn_encoder"]})
    return trainer


def build_argparser() -> argparse.ArgumentParser:
    """Reference-compatible CLI (``train_Point2Cyl.py:33-88``)."""
    p = argparse.ArgumentParser(description="Trainer B of the PyTorch/CUDA port")
    p.add_argument("--num_point", type=int, default=8192)
    p.add_argument("--num_sk_point", type=int, default=2048)
    p.add_argument("--K", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--logdir", default="Point2Cyl", type=str)
    p.add_argument("--data_dir", type=str, default="data/")
    p.add_argument("--data_split", default="train", type=str)
    p.add_argument("--num_epochs", type=int, default=300)
    p.add_argument("--decay_step", type=int, default=200_000)
    p.add_argument("--bn_decay_step", type=int, default=200_000)
    p.add_argument("--decay_rate", type=float, default=0.7)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--pred_seg", action="store_true")
    p.add_argument("--pred_normal", action="store_true")
    p.add_argument("--pred_bb", action="store_true")
    p.add_argument("--pred_extrusion", action="store_true")
    p.add_argument("--pred_center", action="store_true")
    p.add_argument("--norm_eig", action="store_true")
    p.add_argument("--weight_seg", type=float, default=1.0)
    p.add_argument("--weight_normal", type=float, default=1.0)
    p.add_argument("--weight_bb", type=float, default=1.0)
    p.add_argument("--weight_extrusion", type=float, default=1.0)
    p.add_argument("--weight_center", type=float, default=1.0)
    # parsed but inert, as in the JAX trainer: the joint step adds no noise
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("--noise_sigma", type=float, default=0.01)
    # parsed but inert in the reference too: the SALD form is hardcoded
    # (train_Point2Cyl.py:114,638-645)
    p.add_argument("--sald", action="store_true")
    p.add_argument("--is_pc_init", action="store_true")
    p.add_argument("--is_im_init", action="store_true")
    p.add_argument("--is_pc_train", action="store_true")
    p.add_argument("--is_im_train", action="store_true")
    p.add_argument("--pc_logdir", default="Point2Cyl_without_sketch")
    p.add_argument("--pc_ckpt", default="model")
    p.add_argument("--im_logdir", default="results/IGR_dense")
    p.add_argument("--im_ckpt", default="model")
    p.add_argument("--init_global_step", type=int, default=0,
                   help="starting step of the lr and BN staircases: 0 resets "
                   "(the reference), -1 carries Trainer A's step (needs "
                   "--is_pc_init), > 0 that step")
    p.add_argument("--is_L2", action="store_true")
    p.add_argument("--with_im_loss", action="store_true")
    p.add_argument("--use_whole_pc", action="store_true")
    p.add_argument("--use_gt_im", action="store_true")
    p.add_argument("--use_extrusion_axis_feat", action="store_true")
    p.add_argument("--pretrain_im", action="store_true",
                   help="IGR pretraining: the encoder and decoder on GT sketches")
    p.add_argument("--igr_chunk", type=int, default=0,
                   help="run the IGR terms over the B*K instances in checkpointed "
                   "chunks of this size (exact; bounds memory). 0: chunks of 32 "
                   "when B*K > 32; negative: never")
    p.add_argument("--resume", action="store_true",
                   help="restore the joint state, Adam, step and epoch from "
                   "<logdir>/model.pth and continue")
    p.add_argument("--synthetic", type=int, default=None,
                   help="train on N synthetic solids instead of h5 data")
    p.add_argument("--synthetic_resolution", type=int, default=8192)
    p.add_argument("--compute_dtype", type=str, default="float32")
    p.add_argument("--ballquery_impl", type=str, default="auto",
                   choices=["auto", "kernel", "plain"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tensorboard", action="store_true",
                   help="also write tensorboard scalars to <logdir>/tb")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    add_parallel_args(p)
    return p


def cli_main(argv: list[str] | None = None) -> JointTrainer | ImPretrainer | None:
    """Pretrain or train as the flags say; returns the trainer, or None
    where the ranks ran in processes of their own (``--data_parallel``
    above 1)."""
    return run_data_parallel(build_argparser().parse_args(argv), _joint_main)


def _joint_main(args: argparse.Namespace, mesh) -> JointTrainer | ImPretrainer:
    cfg = config_from_args(args)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    if args.synthetic:
        ds = generate_dataset(args.synthetic, resolution=args.synthetic_resolution,
                              max_instances=args.K, num_sketch_points=args.num_sk_point,
                              seed=args.seed)
    else:
        ds = load_h5(os.path.join(args.data_dir, args.data_split + ".h5"))
    pipeline = InputPipeline(ds, args.num_point, args.K, dev,
                             num_sketch_points=args.num_sk_point)
    logger = TrainLogger(cfg.logdir, use_tensorboard=cfg.tensorboard,
                         primary=mesh is None or mesh.rank == 0)
    logger.log(f"config: {cfg}")
    logger.log(f"device {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                                  if dev.type == "cuda" else ""))
    nets = build_nets(cfg, args.num_point, args.K, args.use_whole_pc,
                      args.use_extrusion_axis_feat, dev)
    try:
        if args.pretrain_im:
            return pretrain(args, cfg, pipeline, logger, nets[1], nets[2], mesh)
        return train(args, cfg, pipeline, logger, nets, mesh)
    finally:
        logger.close()


if __name__ == "__main__":
    cli_main()
