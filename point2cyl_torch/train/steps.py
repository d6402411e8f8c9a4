"""Head assembly shared by serving, evaluation and training, and Trainer
A's step (the port of the JAX ``train/steps.py``).

One step: optional normal-direction noise, a train-mode forward (batch
statistics, dropout, random FPS starts), the heads, the proxy losses
(Hungarian matching, relaxed mIoU, normal, base/barrel CE, closed-form
axis and centre), backpropagation through the kernels' autograd
Functions, an Adam step on the staircase learning rate, and the
non-finite guard, which keeps the whole previous state (parameters, BN
statistics, Adam's moments and count, step) when the loss or a gradient
is not finite (JAX ``steps.py:242-256``).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Sequence

import torch

from point2cyl_torch.core.config import TrainConfig
from point2cyl_torch.core.schedules import staircase_bn_momentum, staircase_lr
from point2cyl_torch.losses.aggregate import base_barrel_ce_loss, compute_all_losses
from point2cyl_torch.losses.normal import normal_loss
from point2cyl_torch.losses.segmentation import reorder_w
from point2cyl_torch.ops.geometry import add_noise, estimate_extrusion_centers
from point2cyl_torch.ops.linalg import estimate_extrusion_axis
from point2cyl_torch.ops.matching import mask_gt_from_labels, reduce_mean_masked_instance


class HeadOutputs(NamedTuple):
    """Assembled prediction heads."""

    normals: torch.Tensor  # (B, N, 3) unit normals
    w: torch.Tensor  # (B, N, K) soft instance segmentation
    w_barrel: torch.Tensor  # (B, N, K) softmaxed even columns
    w_base: torch.Tensor  # (B, N, K) softmaxed odd columns
    w_barrel_raw: torch.Tensor  # raw logits, even columns
    w_base_raw: torch.Tensor  # raw logits, odd columns
    w_2k: torch.Tensor  # (B, N, 2K)


def assemble_heads(
    x_raw: torch.Tensor,
    w_raw: torch.Tensor,
    pred_seg: bool = True,
    pred_bb: bool = True,
    k: int | None = None,
) -> HeadOutputs:
    """Normalise the normal head and assemble the segmentation weights.

    With both seg and bb heads the 2K-way softmax splits into barrel
    (even) and base (odd) columns; seg only takes a K-way softmax; with
    neither, a zero (B, N, k) dummy stands in.
    """
    norms = torch.linalg.vector_norm(x_raw, dim=-1, keepdim=True)
    normals = x_raw / torch.clamp(norms, min=1e-12)
    if pred_seg and pred_bb:
        w_2k = torch.softmax(w_raw, dim=-1)
        w_barrel = w_2k[:, :, ::2]
        w_base = w_2k[:, :, 1::2]
        return HeadOutputs(
            normals=normals,
            w=w_barrel + w_base,
            w_barrel=w_barrel,
            w_base=w_base,
            w_barrel_raw=w_raw[:, :, ::2],
            w_base_raw=w_raw[:, :, 1::2],
            w_2k=w_2k,
        )
    if pred_seg:
        w = torch.softmax(w_raw, dim=-1)
    else:
        if k is None:
            raise ValueError("k required when pred_seg is False")
        w = torch.zeros((*w_raw.shape[:2], k), dtype=w_raw.dtype, device=w_raw.device)
    zeros = torch.zeros_like(w)
    return HeadOutputs(
        normals=normals,
        w=w,
        w_barrel=zeros,
        w_base=zeros,
        w_barrel_raw=zeros,
        w_base_raw=zeros,
        w_2k=w,
    )


def proxy_losses(
    heads: HeadOutputs, batch: dict, cfg: TrainConfig
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """All proxy losses of the without-sketch trainer
    (``train_Point2Cyl_without_sketch.py:280-353``): the weighted total
    and the per-loss scalars."""
    return proxy_losses_and_matching(heads, batch, cfg)[:2]


def proxy_losses_and_matching(
    heads: HeadOutputs, batch: dict, cfg: TrainConfig
) -> tuple[torch.Tensor, dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """``proxy_losses`` and the Hungarian matching (B, K) and its mask
    (B, K) that they solved, for a caller that needs the matching too
    (the joint step)."""
    w = cfg.weights
    i_gt = batch["extrusion_labels"]
    k = heads.w.shape[-1]
    zero = torch.zeros((), dtype=heads.w.dtype, device=heads.w.device)

    out = compute_all_losses(
        heads.w, i_gt, heads.normals, batch["normals"],
        w.normal if cfg.pred_normal else 0.0,
        w.seg if cfg.pred_seg else 0.0,
    )
    total = out.total
    mask_gt = mask_gt_from_labels(i_gt, k)

    bb_loss = zero
    if cfg.pred_bb:
        bb_loss = base_barrel_ce_loss(heads.w, heads.w_barrel_raw, heads.w_base_raw,
                                      batch["base_barrel_labels"], out.matching,
                                      out.mask)
        total = total + w.base_barrel * bb_loss

    ext_loss = zero
    if cfg.pred_normal and cfg.pred_bb and cfg.pred_extrusion:
        axes = estimate_extrusion_axis(
            heads.normals, reorder_w(heads.w_barrel, out.matching),
            reorder_w(heads.w_base, out.matching), batch["base_barrel_labels"],
            i_gt, normalize=cfg.norm_eig,
        )
        ax_per = normal_loss(axes, batch["extrusion_axes"], collapse=False)
        ext_loss = reduce_mean_masked_instance(ax_per, mask_gt).mean()
    total = total + w.extrusion_axis * ext_loss

    center_loss = zero
    if cfg.pred_center:
        centers = estimate_extrusion_centers(reorder_w(heads.w, out.matching),
                                             batch["point_cloud"])
        diff = ((centers - batch["extrusion_centers"]) ** 2).sum(dim=-1)
        center_loss = reduce_mean_masked_instance(diff, mask_gt).mean()
    total = total + w.center * center_loss

    aux = {"total": total, "normal": out.normal, "miou": out.miou, "bb": bb_loss,
           "extrusion": ext_loss, "center": center_loss}
    return total, aux, out.matching, out.mask


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: TrainConfig) -> torch.optim.Adam:
    """Adam as optax's ``adam``: b1 0.9, b2 0.999, eps 1e-8 outside the
    square root, bias correction. The learning rate is set before each
    update from the staircase on the update count."""
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def apply_update(optimizer: torch.optim.Adam, cfg: TrainConfig, step: int) -> None:
    """One Adam update at the staircase learning rate of update ``step``
    (optax's schedule reads its count before incrementing it)."""
    lr = staircase_lr(step, cfg.batch_size, cfg.learning_rate, cfg.decay_step,
                      cfg.decay_rate)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


class Trainer:
    """Trainer A's state (model, Adam, step) and its step."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig):
        self.model = model
        self.cfg = cfg
        self.optimizer = make_optimizer(model.parameters(), cfg)
        self.step = 0  # updates applied; skipped steps do not count
        # the BN statistics as they were before the step's forward, for the
        # guard; allocated once, refilled by one foreach copy a step
        self._stats = [b.detach().clone() for b in model.buffers()]

    def train_step(self, batch: dict, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """One optimizer step on ``batch``; every draw (noise, FPS starts,
        dropout) comes from ``generator``. Returns the loss scalars on the
        device and ``skipped`` (1.0 when the guard kept the old state).
        The gradients stay on the parameters until the next step."""
        cfg = self.cfg
        momentum = staircase_bn_momentum(self.step, cfg.batch_size, cfg.bn_decay_step,
                                         cfg.bn_init_momentum, cfg.bn_decay_rate,
                                         cfg.bn_momentum_clip)
        pts = batch["point_cloud"]
        if cfg.add_noise:
            pts = add_noise(generator, pts, batch["normals"], cfg.noise_sigma)
            batch = dict(batch, point_cloud=pts)
        torch._foreach_copy_(self._stats, list(self.model.buffers()))
        self.optimizer.zero_grad(set_to_none=True)
        x_raw, w_raw = self.model(pts, train=True, bn_momentum=momentum,
                                  generator=generator)
        heads = assemble_heads(x_raw, w_raw, cfg.pred_seg, cfg.pred_bb,
                               k=batch["extrusion_axes"].shape[1])
        total, aux = proxy_losses(heads, batch, cfg)
        total.backward()
        skipped = not guard_finite(total, [self.model], self._stats)
        if not skipped:
            apply_update(self.optimizer, cfg, self.step)
            self.step += 1
        aux = {key: val.detach() for key, val in aux.items()}
        aux["skipped"] = total.new_tensor(float(skipped))
        return aux

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def guard_finite(loss: torch.Tensor, modules: Sequence[torch.nn.Module],
                 stats: list[torch.Tensor]) -> bool:
    """The non-finite guard: True when the loss and every gradient of the
    ``modules`` are finite. Otherwise their buffers (BN statistics and
    counts) go back to ``stats``, what they were before the forward
    updated them in place, in the order of ``module_buffers(modules)``,
    and False is returned; the caller then applies no update. One host
    sync."""
    grads = [p.grad.reshape(-1) for mod in modules for p in mod.parameters()
             if p.grad is not None]
    if bool(torch.isfinite(torch.cat([loss.reshape(1), *grads])).all()):
        return True
    with torch.no_grad():
        torch._foreach_copy_(module_buffers(modules), stats)
    return False


def module_buffers(modules: Sequence[torch.nn.Module]) -> list[torch.Tensor]:
    """Every buffer of ``modules``, in order: what the guard restores."""
    return [buf for mod in modules for buf in mod.buffers()]


def log_epoch_aux(logger, aux_steps: list[dict[str, torch.Tensor]], gstep0: int) -> int:
    """Record each step's loss scalars, leaving out the steps the guard
    skipped (their values are not finite and would poison the epoch
    means). One host sync for the epoch. Returns the skipped count."""
    if not aux_steps:
        return 0
    keys = list(aux_steps[0])
    table = torch.stack([torch.stack([a[k] for k in keys]) for a in aux_steps]).tolist()
    skipped = 0
    for j, row in enumerate(table):
        vals = dict(zip(keys, row))
        if vals.pop("skipped"):
            skipped += 1
            continue
        for tag, val in vals.items():
            logger.scalar(f"Loss/{tag}", val, gstep0 + j)
    return skipped


def handle_skipped_epoch(logger, ckpt, trainer, skipped: int,
                         steps_per_epoch: int, epoch: int) -> None:
    """Log skipped steps; when a whole epoch was skipped (a persistent
    fault, not a transient), roll back to the last checkpoint on disk."""
    if not skipped:
        return
    logger.log(f"! Epoch {epoch:04d}: {skipped}/{steps_per_epoch} non-finite "
               "steps skipped (state kept)")
    if skipped >= steps_per_epoch and ckpt.exists("model"):
        trainer.load_state_dict(ckpt.load("model", trainer.device))
        logger.log("! Entire epoch non-finite: restored last checkpoint")
