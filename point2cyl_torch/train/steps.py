"""Head assembly shared by serving, evaluation and training, and Trainer
A's step (the port of the JAX ``train/steps.py``).

One step: optional normal-direction noise, a train-mode forward (batch
statistics, dropout, random FPS starts), the heads, the proxy losses
(Hungarian matching, relaxed mIoU, normal, base/barrel CE, closed-form
axis and centre), backpropagation through the kernels' autograd
Functions, optax's Adam on the staircase learning rate, and the
non-finite guard (JAX ``steps.py:190-257``). On the card the step's phases
carry markers (``core/profiling.py``): ``train_forward`` (noise, the
forward, the heads), ``train_loss`` (the proxy losses and the matching),
``train_backward``, ``train_update`` (the guard, Adam, the kept state, the
step count) and ``end``.

The step is one program, as JAX's jitted step is: the step count lives on
the device, the learning rate and the BN momentum are computed from it
there, and the guard is a device-side select. ``ok`` (the loss and every
gradient finite) picks, for the parameters, Adam's moments, the BN
statistics and the step count alike, the new value or the old one, so a
non-finite step keeps the whole previous state and nothing reads a value
back to the host. On the card the step runs as a captured CUDA graph
(``core/graphs.py``) after its first call on each batch shape;
``graph=False`` runs it eagerly every time. The gradients live in one
flat buffer (each parameter's ``grad`` a view of it) that the step
zeroes and the backward accumulates into, so every graph and the eager
step share them.

Data parallel (a ``parallel.mesh.Mesh``): each rank runs the step on its
rows of the global batch, with BN statistics over the global batch
(``parallel.mesh.use_global_batch_norm``) and every draw made at the
global batch's size (``parallel.distributed.RowDraws``, built inside the
step from the generator it is handed); after the backward one all-reduce
of the flat gradient buffer, whose tail holds the loss scalars, averages
both over the ranks (:func:`mean_over_ranks`), and the guard decides on
the averaged values, so every rank applies or skips the same update. The
losses are per-sample means, so with equal shards the mean of the ranks'
means is the global batch's, and the step is the one-process step. A
data-parallel step over NCCL is captured with its collectives (the BN
sums, their backward and the gradient all-reduce); a mesh whose
collectives go through host memory (``make_mesh(host_staged=True)``, a
gloo group on cards, its creator's choice) runs eagerly, and its
``graphs.eager_because`` says so (:func:`~point2cyl_torch.core.graphs.step_graphs`).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Sequence

import torch

from point2cyl_torch.core.config import TrainConfig
from point2cyl_torch.core.graphs import step_graphs
from point2cyl_torch.core.profiling import mark
from point2cyl_torch.core.schedules import staircase_bn_momentum, staircase_lr
from point2cyl_torch.losses.aggregate import base_barrel_ce_loss, compute_all_losses
from point2cyl_torch.losses.normal import normal_loss
from point2cyl_torch.losses.segmentation import reorder_w
from point2cyl_torch.ops.geometry import add_noise, estimate_extrusion_centers
from point2cyl_torch.ops.linalg import estimate_extrusion_axis
from point2cyl_torch.ops.matching import mask_gt_from_labels, reduce_mean_masked_instance
from point2cyl_torch.parallel import collectives
from point2cyl_torch.parallel.distributed import RowDraws
from point2cyl_torch.parallel.mesh import replicate, use_global_batch_norm


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


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax's adam defaults


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: TrainConfig) -> torch.optim.Adam:
    """``torch.optim.Adam`` with optax's ``adam`` settings: b1 0.9, b2
    0.999, eps 1e-8 outside the square root, bias correction. Trainer A
    keeps its state in this optimizer's layout (its checkpoint format)
    and updates with :func:`adam_select`."""
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(ADAM_B1, ADAM_B2),
                            eps=ADAM_EPS)


AUX_KEYS = ("total", "normal", "miou", "bb", "extrusion", "center", "skipped")


@torch.no_grad()
def adam_select(params: Sequence[torch.Tensor], grad: torch.Tensor,
                moments: torch.Tensor, step: torch.Tensor, lr: torch.Tensor,
                ok: torch.Tensor) -> None:
    """optax's ``adam`` update of ``params`` in place from the flat
    gradient ``grad`` (n,) and the flat moments ``moments`` (2, n), kept
    where ``ok`` (a 0-dim bool) is False: each of the parameters and the
    moments is ``where(ok, new, old)``, never arithmetic with the mask,
    since a NaN times 0 is NaN. ``step`` is the count of updates before
    this one (bias correction takes ``step + 1``), ``lr`` the learning
    rate, both 0-dim tensors on the device."""
    count = (step + 1).to(torch.float32)
    m, v = moments[0], moments[1]
    m_new = (1.0 - ADAM_B1) * grad + ADAM_B1 * m
    v_new = (1.0 - ADAM_B2) * (grad * grad) + ADAM_B2 * v
    m_hat = m_new / (1.0 - torch.pow(ADAM_B1, count))
    v_hat = v_new / (1.0 - torch.pow(ADAM_B2, count))
    flat = torch.cat([p.reshape(-1) for p in params])
    flat_new = flat + (m_hat / (torch.sqrt(v_hat) + ADAM_EPS)) * -lr
    moments.copy_(torch.where(ok, torch.stack([m_new, v_new]), moments))
    torch._foreach_copy_(list(params), _views(torch.where(ok, flat_new, flat), params))


def _views(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``flat`` cut into views shaped as the tensors of ``like``."""
    return [chunk.view_as(t) for chunk, t in
            zip(flat.split([t.numel() for t in like]), like)]


class FlatGrads:
    """The gradients of ``params`` in one flat buffer, ``extra`` entries
    longer (room for the loss scalars of :func:`mean_over_ranks`), on the
    device and in the dtype of the first parameter (or of ``like``). Each
    parameter's ``grad`` is a view of it, into which the backward
    accumulates in place, so every graph of an owner and its eager step
    share them; ``grad`` is the parameters' part of ``buffer``."""

    def __init__(self, params: Sequence[torch.nn.Parameter], extra: int = 0,
                 like: torch.Tensor | None = None):
        self.params = list(params)
        like = self.params[0] if like is None else like
        n = sum(p.numel() for p in self.params)
        self.buffer = torch.zeros(n + extra, device=like.device, dtype=like.dtype)
        self.grad = self.buffer[:n]
        self.views = _views(self.grad, self.params) if self.params else []
        self.zero()

    def zero(self) -> None:
        """Zero the buffer, and make each ``grad`` its view again where a
        caller set it to None (``zero_grad``)."""
        for p, g in zip(self.params, self.views):
            if p.grad is not g:
                p.grad = g
        self.buffer.zero_()


class KeptState:
    """A list of tensors (BN statistics and counts, a step count) that a
    guarded step keeps when its update is refused: :meth:`take` copies
    them, one flat copy for each dtype, before the step changes them, and
    :meth:`keep_unless` writes ``where(ok, now, taken)`` back in place."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.groups: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            self.groups.setdefault(t.dtype, []).append(t)

    @torch.no_grad()
    def take(self) -> list[torch.Tensor]:
        return [torch.cat([t.reshape(-1) for t in group]) for group in self.groups.values()]

    @torch.no_grad()
    def keep_unless(self, ok: torch.Tensor, taken: list[torch.Tensor]) -> None:
        for group, old in zip(self.groups.values(), taken):
            now = torch.cat([t.reshape(-1) for t in group])
            torch._foreach_copy_(group, _views(torch.where(ok, now, old), group))


class Trainer:
    """Trainer A's state (model, Adam's moments, step count) and its step;
    with a ``mesh`` the data-parallel step (the model is replicated from
    rank 0).

    ``step`` is a 0-dim int64 tensor on the model's device: the updates
    applied (a skipped step does not count). ``optimizer`` is a
    ``torch.optim.Adam`` that holds the state in its layout (each
    parameter's ``exp_avg``, ``exp_avg_sq`` and ``step``), so checkpoints
    keep torch's format; the update itself is :func:`adam_select`.
    ``graph=False`` runs every step eagerly on the card too.
    """

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, mesh=None,
                 graph: bool = True):
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            use_global_batch_norm(model, mesh)
            replicate(mesh, model)
        self.optimizer = make_optimizer(model.parameters(), cfg)
        self._params = list(model.parameters())
        self._kept = KeptState(list(model.buffers()))
        dev = self._params[0].device
        n = sum(p.numel() for p in self._params)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self._grads = FlatGrads(self._params, len(AUX_KEYS) - 1)
        self._moments = torch.zeros(2, n, device=dev)
        for p, m, v in zip(self._params, _views(self._moments[0], self._params),
                           _views(self._moments[1], self._params)):
            self.optimizer.state[p] = {"step": self.step, "exp_avg": m, "exp_avg_sq": v}
        self.graphs = step_graphs(dev, graph, mesh)

    def train_step(self, batch: dict, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """One optimizer step on ``batch``; every draw (noise, FPS starts,
        dropout) comes from ``generator``. Returns the loss scalars on the
        device and ``skipped`` (1.0 when the guard kept the old state),
        fresh tensors at every call. The gradients stay on the parameters
        until the next step."""
        vals = self.graphs(self._step, batch, generator).clone()
        return dict(zip(AUX_KEYS, vals.unbind()))

    def _step(self, batch: dict, generator) -> torch.Tensor:
        """The step's body, with no host read: the loss scalars stacked in
        ``AUX_KEYS`` order."""
        cfg = self.cfg
        pts = batch["point_cloud"]
        mark("train_forward", pts)
        generator = step_generator(self.mesh, generator, pts.shape[0])
        momentum = staircase_bn_momentum(self.step, cfg.batch_size, cfg.bn_decay_step,
                                         cfg.bn_init_momentum, cfg.bn_decay_rate,
                                         cfg.bn_momentum_clip)
        if cfg.add_noise:
            pts = add_noise(generator, pts, batch["normals"], cfg.noise_sigma)
            batch = dict(batch, point_cloud=pts)
        stats = self._kept.take()
        self._grads.zero()
        x_raw, w_raw = self.model(pts, train=True, bn_momentum=momentum,
                                  generator=generator)
        heads = assemble_heads(x_raw, w_raw, cfg.pred_seg, cfg.pred_bb,
                               k=batch["extrusion_axes"].shape[1])
        mark("train_loss", pts)
        total, aux = proxy_losses(heads, batch, cfg)
        mark("train_backward", pts)
        total.backward()
        aux = mean_over_ranks(self.mesh, self._grads.buffer, aux)
        mark("train_update", pts)
        with torch.no_grad():
            ok = torch.isfinite(aux["total"]) & torch.isfinite(self._grads.grad).all()
            lr = staircase_lr(self.step, cfg.batch_size, cfg.learning_rate,
                              cfg.decay_step, cfg.decay_rate)
            adam_select(self._params, self._grads.grad, self._moments, self.step, lr, ok)
            self._kept.keep_unless(ok, stats)
            self.step.copy_(torch.where(ok, self.step + 1, self.step))
        aux["skipped"] = 1.0 - ok.to(total.dtype)
        vals = torch.stack([aux[key] for key in AUX_KEYS])
        mark("end", pts)
        return vals

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> dict:
        """Model, Adam (torch's ``Adam.state_dict`` layout, each
        parameter's ``step`` a CPU float32 count) and ``step`` as an int.
        One host read."""
        step = int(self.step)
        opt = self.optimizer.state_dict()
        opt["state"] = {i: dict(st, step=torch.tensor(float(step)))
                        for i, st in opt["state"].items()}
        return {"model": self.model.state_dict(), "optimizer": opt, "step": step}

    def load_state_dict(self, state: dict) -> None:
        """Write ``state`` into the trainer's tensors in place, so that
        captured steps keep reading them. A parameter without Adam state
        (a checkpoint from before its first update) gets zero moments."""
        self.model.load_state_dict(state["model"], strict=True)
        saved = state["optimizer"]["state"]
        with torch.no_grad():
            for i, (m, v) in enumerate(zip(_views(self._moments[0], self._params),
                                           _views(self._moments[1], self._params))):
                if i in saved:
                    m.copy_(saved[i]["exp_avg"])
                    v.copy_(saved[i]["exp_avg_sq"])
                else:
                    m.zero_()
                    v.zero_()
            self.step.fill_(int(state["step"]))


def step_generator(mesh, generator, rows: int):
    """``generator`` for a step over ``rows`` local rows: as it is on one
    process (or where it already is a ``RowDraws``); on a mesh a
    ``RowDraws`` over the global batch of ``rows`` times the rank count,
    cut to this rank's rows."""
    if mesh is None or generator is None or isinstance(generator, RowDraws):
        return generator
    return RowDraws(generator, slice(mesh.rank * rows, (mesh.rank + 1) * rows),
                    rows * mesh.world)


def mean_over_ranks(mesh, flat: torch.Tensor,
                    aux: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The loss scalars ``aux``, detached, and in place the gradients in
    the flat buffer ``flat`` (:attr:`FlatGrads.buffer`), averaged over
    ``mesh``'s ranks: the scalars go into the buffer's last ``len(aux)``
    entries and the whole buffer takes one all-reduce; the averaged
    scalars returned are views of them, valid until the buffer's next
    step. Without a mesh, ``aux`` detached. A non-finite value on any rank
    makes the average non-finite on every rank."""
    aux = {key: val.detach() for key, val in aux.items()}
    if mesh is None:
        return aux
    with torch.no_grad():
        tail = flat[flat.numel() - len(aux):]
        tail.copy_(torch.stack(list(aux.values())))
        collectives.psum_(flat, mesh)
        flat.div_(mesh.world)
    return dict(zip(aux, tail.unbind()))


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
    if skipped >= steps_per_epoch and ckpt.exists_global("model"):
        trainer.load_state_dict(ckpt.load("model", trainer.device))
        logger.log("! Entire epoch non-finite: restored last checkpoint")
