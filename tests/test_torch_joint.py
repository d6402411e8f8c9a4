"""The port's joint trainer and IGR pretrainer
(point2cyl_torch.train.train_joint) against the JAX package on the CPU at
a small size.

The JAX side composes the joint loss as ``make_joint_train_step``'s
``loss_fn`` does (``point2cyl_tpu/train/train_joint.py:175-273``),
written out here with the draws that cannot cross frameworks fed to both
sides: the FPS starts JAX draws (recorded), dropout 0, the deterministic
segment draw (``key=None``; the port's ``generator=None``) and numpy
off-surface samples. The clouds are synthetic solids; the parity cases
use samples whose K slots are all live, as the reference parity test
does, plus one with a dead slot (both sides zero its sketch rows).
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from point2cyl_torch.core.checkpoint import restore_backbone, restore_implicit_stack
from point2cyl_torch.core.config import BackboneConfig as TorchConfig
from point2cyl_torch.core.config import TrainConfig as TorchTrainConfig
from point2cyl_torch.core.convert import (backbone_state_dict_from_jax,
                                          encoder_state_dict_from_jax,
                                          implicit_state_dict_from_jax)
from point2cyl_torch.data.pipeline import InputPipeline as TorchPipeline
from point2cyl_torch.data.synthetic import generate_dataset as torch_generate
from point2cyl_torch.eval import evaluator
from point2cyl_torch.models.backbone import Backbone as TorchBackbone
from point2cyl_torch.models.implicit import ImplicitNet, PointNetEncoder
from point2cyl_torch.train import train_joint as TJ
from point2cyl_torch.train import train_pc
from point2cyl_tpu.core.config import BackboneConfig, TrainConfig
from point2cyl_tpu.data.pipeline import InputPipeline
from point2cyl_tpu.data.synthetic import generate_dataset
from point2cyl_tpu.losses import igr as JIGR
from point2cyl_tpu.losses.segmentation import reorder_w
from point2cyl_tpu.models import backbone as jax_backbone_module
from point2cyl_tpu.models import implicit as JI
from point2cyl_tpu.ops import geometry as JG
from point2cyl_tpu.ops.matching import (_permutation_onehots, hungarian_matching,
                                        mask_gt_from_labels, relaxed_iou_cost)
from point2cyl_tpu.train import steps as jsteps
from point2cyl_tpu.train.train_joint import make_joint_optimizer

K = 4
N = 128
B = 2
S = 32  # sketch points, and segment samples of the projections
L = 16
CFG = BackboneConfig(
    num_points=N, sa_npoints=(32, 8), sa_radii=(0.3, 0.6), sa_nsamples=(16, 8),
    sa_mlps=((16, 32), (32, 64)), sa_global_mlp=(64, 128),
    fp_mlps=((64,), (32,), (32, 32)), fc_width=32, dropout_rate=0.0,
    output_sizes=(3, 2 * K), approx_neighbors=False,
)
DECODER = dict(d_in=2 + L, hidden=(32,) * 4, skip_in=(2,))
LOSS_FLAGS = dict(pred_seg=True, pred_normal=True, pred_bb=True, pred_extrusion=True,
                  pred_center=True)
MOMENTUM = 0.5  # the staircase's at step 0
PROXY = ("normal", "miou", "bb", "extrusion", "center")
IGR_PARTS = ("manifold", "eikonal", "sald", "latent", "im_total", "total")


def bn_drawn(variables, seed: int):
    """Flax variables with BN affine parameters and statistics drawn from a
    numpy seed (a fresh net's are 1 and 0)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape, where = path[-1].key, np.shape(leaf), str(path)
        if "BatchNorm" not in where:
            return np.asarray(leaf)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0.0, 0.1, shape).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(draw, jax.device_get(variables["params"])),
            jax.tree_util.tree_map_with_path(draw, jax.device_get(variables["batch_stats"])))


def jax_nets(seed: int):
    """The JAX backbone, decoder, trainable and loaded encoders, each with
    its (params, stats)."""
    key = jax.random.key(seed)
    backbone = jax_backbone_module.Backbone(CFG)
    pc = bn_drawn(backbone.init({"params": key, "sample": key, "dropout": key},
                                jnp.zeros((1, N, 3)), train=False), seed)
    return ((backbone, pc), *jax_implicit_stack(seed))


def jax_implicit_stack(seed: int):
    """The JAX decoder with its params, and the trainable and loaded
    encoders with their (params, stats)."""
    implicit = JI.ImplicitNet(**DECODER)
    im = jax.device_get(implicit.init(jax.random.key(seed + 1),
                                      jnp.zeros((1, DECODER["d_in"])))["params"])
    encoder = JI.PointNetEncoder(L, 2, True)
    enc = bn_drawn(encoder.init(jax.random.key(seed + 2), jnp.zeros((1, S, 4)),
                                train=False), seed + 2)
    loaded = bn_drawn(encoder.init(jax.random.key(seed + 3), jnp.zeros((1, S, 4)),
                                   train=False), seed + 3)
    return (implicit, im), (encoder, enc), loaded


def port_nets(jnets):
    (_, pc), (_, im), (_, enc), loaded = jnets
    backbone = TorchBackbone(TorchConfig.from_dict(dataclasses.asdict(CFG)))
    backbone.load_state_dict(backbone_state_dict_from_jax(*pc), strict=True)
    implicit = ImplicitNet(**DECODER)
    implicit.load_state_dict(implicit_state_dict_from_jax(im), strict=True)
    encoders = []
    for params, stats in (enc, loaded):
        e = PointNetEncoder(L, 2, True)
        e.load_state_dict(encoder_state_dict_from_jax(params, stats), strict=True)
        encoders.append(e)
    return backbone, implicit, *encoders


def synthetic_pool():
    return generate_dataset(12, resolution=512, max_instances=K, num_sketch_points=S,
                            seed=4)


def numpy_batch(dead_slot: bool) -> dict[str, np.ndarray]:
    """Two solids of the pool subsampled to N points: the first two with
    all K slots live, or with ``dead_slot`` the first live one and the
    first with fewer instances than K. The subsample is the first, from
    numpy seed 5 on, with no point pair within 1e-5 of a squared
    ball-query radius (the JAX CPU path measures distances by expansion,
    the port by differences, and may part there)."""
    ds = synthetic_pool()
    live = [i for i in range(ds.num_samples) if ds.n_instances[i] == K]
    dead = [i for i in range(ds.num_samples) if ds.n_instances[i] < K]
    rows = np.array([live[0], dead[0]] if dead_slot else live[:2])
    for seed in range(5, 50):
        rng = np.random.default_rng(seed)
        sub = np.stack([rng.permutation(512)[:N] for _ in range(B)])
        pts = np.take_along_axis(ds.point_cloud[rows], sub[..., None], 1).astype(np.float64)
        d2 = ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)
        if all(np.abs(d2 - r * r).min() > 1e-5 for r in CFG.sa_radii):
            break
    take = lambda a: np.take_along_axis(a[rows], sub if a.ndim == 2 else sub[..., None], 1)
    batch = {
        "point_cloud": take(ds.point_cloud), "normals": take(ds.normals),
        "extrusion_labels": take(ds.extrusion_labels).astype(np.int32),
        "base_barrel_labels": take(ds.base_barrel_labels).astype(np.int32),
        "extrusion_axes": ds.extrusion_axes[rows].astype(np.float32),
        "extrusion_centers": ds.extrusion_centers[rows].astype(np.float32),
        "sketches": ds.sketches[rows].astype(np.float32),
    }
    assert all(np.abs(d2 - r * r).min() > 1e-5 for r in CFG.sa_radii)
    return batch


def off_surface(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.8, 1.8, (B * K, S + S // 8, 2)).astype(np.float32)


def jax_joint_loss(jnets, batch, off, *, is_pc_train: bool, is_im_train: bool,
                   use_gt_im: bool):
    """``loss_fn`` of ``make_joint_train_step`` with the injected draws:
    a function of the {"pc", "enc"} params -> (total, (aux with the found
    mask of the projected sketches, new backbone statistics, new encoder
    statistics, soft segmentation))."""
    (backbone, (_, pc_bn)), (implicit, im), (encoder, (_, enc_bn)), loaded = jnets
    jcfg = TrainConfig(batch_size=B, **LOSS_FLAGS)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    pts, i_gt, gt_bb = bj["point_cloud"], bj["extrusion_labels"], bj["base_barrel_labels"]
    mask_gt = mask_gt_from_labels(i_gt, K)
    sk = bj["sketches"]
    gt_latents = encoder.apply({"params": loaded[0], "batch_stats": loaded[1]},
                               sk.reshape(B * K, S, 4), train=False).reshape(B, K, L)
    key = jax.random.key(17)

    def loss_fn(train_params):
        pc_vars = {"params": train_params["pc"], "batch_stats": pc_bn}
        if is_pc_train:
            (x_raw, w_raw), mut = backbone.apply(
                pc_vars, pts, train=True, bn_momentum=MOMENTUM,
                rngs={"sample": key, "dropout": key}, mutable=["batch_stats"])
            new_pc_bn = mut["batch_stats"]
        else:
            x_raw, w_raw = backbone.apply(pc_vars, pts, train=False)
            new_pc_bn = pc_bn
        heads = jsteps.assemble_heads(x_raw, w_raw, True, True, k=K)
        proxy_total, aux = jsteps.proxy_losses(heads, bj, jcfg)
        if use_gt_im:
            proj = (bj["normals"], i_gt, gt_bb)
        else:
            matching, mask = hungarian_matching(heads.w, i_gt)
            w_re = reorder_w(heads.w, matching)
            w_re = jnp.where(mask[:, None, :], w_re, 0.0)
            bb_probs = jnp.stack([jnp.sum(heads.w_2k[:, :, ::2], -1),
                                  jnp.sum(heads.w_2k[:, :, 1::2], -1)], axis=-1)
            proj = (heads.normals, jnp.argmax(w_re, -1), jnp.argmax(bb_probs, -1))
        p2d, n2d, _, found = JG.sketch_projection(
            None, pts, *proj, bj["extrusion_axes"], bj["extrusion_centers"], num_samples=S)
        _, _, gt_scales, _ = JG.sketch_projection(
            None, pts, bj["normals"], i_gt, gt_bb, bj["extrusion_axes"],
            bj["extrusion_centers"], num_samples=S)
        enc_in = jnp.concatenate([p2d / gt_scales[..., None, None], n2d], -1)
        enc_vars = {"params": train_params["enc"], "batch_stats": enc_bn}
        if is_im_train:
            latents, mut = encoder.apply(enc_vars, enc_in.reshape(B * K, S, 4), train=True,
                                         bn_momentum=MOMENTUM, mutable=["batch_stats"])
            new_enc_bn = mut["batch_stats"]
        else:
            latents = encoder.apply(enc_vars, enc_in.reshape(B * K, S, 4), train=False)
            new_enc_bn = enc_bn
        latents = latents.reshape(B, K, L)
        igr = JIGR.igr_losses(lambda x: implicit.apply({"params": im}, x), key,
                              sk[..., :2], sk[..., 2:], latents, mask_gt,
                              eikonal_weight=0.1, normals_weight=1.0, off_pts=off)
        lat = JIGR.latent_loss(latents, gt_latents, mask_gt, False)
        im_total = igr.total + lat
        total = proxy_total + im_total if is_pc_train else im_total
        aux = dict(aux, manifold=igr.manifold, eikonal=igr.eikonal, sald=igr.normals,
                   latent=lat, im_total=im_total, total=total, found=found)
        return total, (aux, new_pc_bn, new_enc_bn, heads.w)

    return loss_fn


@pytest.fixture
def recorded_fps(monkeypatch):
    """A list that holds the FPS starts JAX draws in train mode, traced
    values a jitted function returns."""
    starts = []
    fps = jax_backbone_module.farthest_point_sample

    def recording_fps(xyz, npoint, key=None, start_idx=0):
        if key is not None:
            b, n, _ = xyz.shape
            starts.append(jax.random.randint(key, (b,), 0, n, dtype=jnp.int32))
        return fps(xyz, npoint, key=key, start_idx=start_idx)

    monkeypatch.setattr(jax_backbone_module, "farthest_point_sample", recording_fps)
    return starts


def float64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32
        else np.asarray(a), tree)


# the jitted JAX step of each set of flags, traced once: the cases of one
# set share its compilation (the FPS starts come back as outputs)
_JAX_STEPS: dict = {}


def jax_joint_step(jnets, batch, off, starts: list, **flags):
    """The JAX loss, its parts, the new BN statistics, the soft
    segmentation, the FPS starts and the gradients, jitted, in float64."""
    modules = [net for net, _ in jnets[:3]]
    key = tuple(sorted(flags.items()))
    if key not in _JAX_STEPS:
        def with_starts(params, variables, batch, off):
            starts.clear()
            nets = [*zip(modules, variables[:3]), variables[3]]
            total, aux = jax_joint_loss(nets, batch, off, **flags)(params)
            return total, (aux, tuple(starts))

        _JAX_STEPS[key] = jax.jit(jax.value_and_grad(with_starts, has_aux=True))
    with jax.enable_x64(True):
        variables = [float64(v) for _, v in jnets[:3]] + [float64(jnets[3])]
        params = {"pc": variables[0][0], "enc": variables[2][0]}
        out = _JAX_STEPS[key](params, variables, float64(batch), float64(off))
        return jax.tree_util.tree_map(np.asarray, jax.device_get(out))


def matching_margin(w: np.ndarray, labels: np.ndarray, mask_gt: np.ndarray) -> float:
    """How far the best matching's score stands above that of any matching
    that assigns another column to a live instance, the least over the
    batch (dead instances score 0 under every assignment, and the step
    masks their columns out): a margin above float64 noise means both
    sides solve the same matching."""
    with jax.enable_x64(True):
        cost = np.asarray(relaxed_iou_cost(jnp.asarray(w), jnp.asarray(labels)))
    onehots = _permutation_onehots(K).astype(np.float64)  # (K!, K, K)
    perms = onehots.argmax(-1)  # the column of each row
    margins = []
    for b in range(len(w)):
        scores = np.einsum("kj,pkj->p", cost[b], onehots)
        best = perms[scores.argmax()]
        other = (perms[:, mask_gt[b]] != best[mask_gt[b]]).any(-1)
        margins.append(scores.max() - scores[other].max())
    return min(margins)


def assert_grads(named, want: dict, what: str) -> None:
    """Trainer A's rule: each gradient within 1e-3 of its own largest
    entry plus 1e-5 of the largest of the net's."""
    named = list(named)
    top = max(float(want[n].abs().max()) for n, _ in named)
    for name, p in named:
        ref = want[name]
        scale = float(ref.abs().max())
        err = float((p.grad - ref).abs().max())
        assert err <= 1e-3 * scale + 1e-5 * top, (what, name, err, scale, top)


@pytest.mark.parametrize("case", ["trained", "dead_slot", "pc_frozen_gt_im"])
def test_joint_step_matches_jax(case, recorded_fps):
    """One joint step's loss from identical weights, batch and draws: the
    proxy parts within 1e-5, the IGR parts and the totals within 1e-4,
    every backbone and encoder gradient within Trainer A's rule, and the
    BN statistics within 1e-5. With the backbone frozen (here with
    ``use_gt_im``: the GT labels and normals project the sketches) the
    total is the implicit total and no backbone parameter gets a
    gradient.

    Both sides run in float64. In float32 the step's gradients are not
    determined to the rule's tolerance: the encoder's train-mode batch
    statistics, summed in another order, can flip the winner of a
    near-tied max-pool, which reroutes that channel's gradient (the same
    JAX step eager and jitted gives encoder gradients that part by several
    per cent of their largest entry), while the losses agree within 2e-5."""
    use_gt_im = case == "pc_frozen_gt_im"
    is_pc_train = not use_gt_im
    jnets = jax_nets(3)
    batch, off = numpy_batch(case == "dead_slot"), off_surface(6)
    (loss, ((aux, new_pc_bn, new_enc_bn, w_jax), starts)), grads = jax_joint_step(
        jnets, batch, off, recorded_fps, is_pc_train=is_pc_train, is_im_train=True,
        use_gt_im=use_gt_im)
    assert len(starts) == (len(CFG.sa_npoints) if is_pc_train else 0)
    mask_gt = np.asarray(mask_gt_from_labels(jnp.asarray(batch["extrusion_labels"]), K))
    assert mask_gt.all() == (case != "dead_slot")
    # most live segments are found, so the encoder sees sketches, not the
    # zero rows of unfound ones (with zero batch variance its BN would
    # amplify rounding by 1/sqrt(eps) a layer)
    assert aux["found"][mask_gt].mean() >= 0.5
    assert matching_margin(w_jax, batch["extrusion_labels"], mask_gt) > 1e-9

    backbone, implicit, encoder, loaded = (net.double() for net in port_nets(jnets))
    trainer = TJ.JointTrainer(backbone, implicit, encoder, loaded,
                              TorchTrainConfig(batch_size=B, **LOSS_FLAGS), num_sk_points=S,
                              is_pc_train=is_pc_train, is_im_train=True, with_im_loss=True,
                              use_gt_im=use_gt_im)
    batch_t = {k: torch.from_numpy(v) for k, v in float64(batch).items()}
    total, aux_t = trainer.loss(batch_t, None, off_pts=torch.from_numpy(float64(off)),
                                fps_starts=[torch.from_numpy(s.copy()) for s in starts])
    total.backward()
    for name in PROXY:
        np.testing.assert_allclose(aux_t[name].item(), float(aux[name]), atol=1e-5,
                                   err_msg=name)
    for name in IGR_PARTS:
        np.testing.assert_allclose(aux_t[name].item(), float(aux[name]), atol=1e-4,
                                   err_msg=name)
    assert total is aux_t["total"]
    if not is_pc_train:
        assert float(aux_t["total"]) == float(aux_t["im_total"])

    assert_grads(encoder.named_parameters(),
                 encoder_state_dict_from_jax(grads["enc"], jnets[2][1][1]), "encoder")
    if is_pc_train:
        assert_grads(backbone.named_parameters(),
                     backbone_state_dict_from_jax(grads["pc"], jnets[0][1][1]), "backbone")
    else:
        assert all(p.grad is None for p in backbone.parameters())
    assert all(p.grad is None for p in [*implicit.parameters(), *loaded.parameters()])

    want_bn = {**{f"pc.{k}": v for k, v in backbone_state_dict_from_jax(
        jnets[0][1][0], new_pc_bn).items()},
        **{f"enc.{k}": v for k, v in encoder_state_dict_from_jax(
            jnets[2][1][0], new_enc_bn).items()}}
    for prefix, net in (("pc", backbone), ("enc", encoder)):
        for name, buf in net.named_buffers():
            if name.endswith("num_batches_tracked"):
                assert int(buf) == 1
                continue
            np.testing.assert_allclose(buf.numpy(), want_bn[f"{prefix}.{name}"].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{prefix}.{name}")


def test_pretrain_step_matches_jax():
    """The IGR pretrainer's loss (encoder in train mode at its default
    momentum, decoder trainable) within 1e-5 of JAX's, and the gradients
    of every encoder and decoder weight within Trainer A's rule."""
    (implicit_j, im), (encoder_j, (enc_p, enc_bn)), _ = jax_implicit_stack(5)
    batch = numpy_batch(False)
    off = off_surface(7)
    sk = jnp.asarray(batch["sketches"])
    mask_gt = mask_gt_from_labels(jnp.asarray(batch["extrusion_labels"]), K)

    def loss_fn(p):
        latents, _ = encoder_j.apply({"params": p["enc"], "batch_stats": enc_bn},
                                     sk.reshape(B * K, S, 4), train=True,
                                     mutable=["batch_stats"])
        igr = JIGR.igr_losses(lambda x: implicit_j.apply({"params": p["im"]}, x),
                              jax.random.key(0), sk[..., :2], sk[..., 2:],
                              latents.reshape(B, K, L), mask_gt, off_pts=off)
        return igr.total, igr

    (loss, igr), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        {"im": im, "enc": enc_p})
    implicit = ImplicitNet(**DECODER)
    implicit.load_state_dict(implicit_state_dict_from_jax(im), strict=True)
    encoder = PointNetEncoder(L, 2, True)
    encoder.load_state_dict(encoder_state_dict_from_jax(enc_p, enc_bn), strict=True)
    pre = TJ.ImPretrainer(implicit, encoder)
    total, aux = pre.loss({k: torch.from_numpy(v) for k, v in batch.items()}, None,
                          off_pts=torch.from_numpy(off))
    total.backward()
    for name, want in zip(("total", "manifold", "eikonal", "sald"), igr):
        np.testing.assert_allclose(aux[name].item(), float(want), atol=1e-5, err_msg=name)
    assert_grads(implicit.named_parameters(), implicit_state_dict_from_jax(grads["im"]),
                 "decoder")
    assert_grads(encoder.named_parameters(),
                 encoder_state_dict_from_jax(grads["enc"], enc_bn), "encoder")


def small_trainer(**kw) -> TJ.JointTrainer:
    gen = torch.Generator().manual_seed(0)
    backbone = TorchBackbone(TorchConfig.from_dict(dataclasses.asdict(CFG)))
    backbone.reset_parameters(gen)
    encoder, loaded = PointNetEncoder(L, 2, True), PointNetEncoder(L, 2, True)
    encoder.reset_parameters(gen)
    loaded.reset_parameters(gen)
    args = dict(num_sk_points=S, is_pc_train=True, is_im_train=True, with_im_loss=True)
    args.update(kw)
    cfg = args.pop("cfg", TorchTrainConfig(batch_size=B, **LOSS_FLAGS))
    return TJ.JointTrainer(backbone, ImplicitNet(**DECODER), encoder, loaded, cfg, **args)


def test_joint_adam_matches_optax_multi_transform():
    """Three updates of both groups across a staircase boundary, from a
    carried step of 3: the backbone's group on the staircase of the step
    (JAX: ``lr_step_offset`` 3 on a fresh count), the encoder's at 1e-3,
    both within float32 rounding of ``optax.multi_transform``."""
    jcfg = TrainConfig(batch_size=2, learning_rate=1e-2, decay_step=4, decay_rate=0.5)
    tcfg = TorchTrainConfig(batch_size=2, learning_rate=1e-2, decay_step=4, decay_rate=0.5)
    trainer = small_trainer(cfg=tcfg, step=3)
    nets = {"pc": trainer.backbone, "enc": trainer.encoder}
    jp = {g: {n: jnp.asarray(p.detach().numpy()) for n, p in net.named_parameters()}
          for g, net in nets.items()}
    tx = make_joint_optimizer(jcfg, True, True, lr_step_offset=3)
    state = tx.init(jp)
    rng = np.random.default_rng(8)
    for _ in range(3):
        g = {grp: {n: rng.normal(size=v.shape).astype(np.float32) for n, v in tree.items()}
             for grp, tree in jp.items()}
        updates, state = jax.jit(tx.update)(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for grp, net in nets.items():
            for n, p in net.named_parameters():
                p.grad = torch.from_numpy(g[grp][n])
        trainer.apply_update()
    assert trainer.step == 6
    for grp, net in nets.items():
        for n, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[grp][n]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{grp}.{n}")


def test_guard_keeps_the_whole_joint_state():
    """A NaN loss (NaN normals) leaves both trained nets' parameters and
    BN statistics (counts included), both Adam groups and the step as
    they were, though the forward had moved the statistics."""
    trainer = small_trainer()
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(False).items()}
    gen = torch.Generator().manual_seed(1)
    aux = trainer.train_step(batch, gen)
    assert float(aux["skipped"]) == 0.0 and trainer.step == 1
    nets = (trainer.backbone, trainer.encoder)
    before = [{k: v.clone() for k, v in net.state_dict().items()} for net in nets]
    adam = {i: {k: v.clone() for k, v in st.items()}
            for i, st in trainer.optimizer.state_dict()["state"].items()}
    assert len(trainer.optimizer.param_groups) == 2
    bad = dict(batch, normals=torch.full_like(batch["normals"], float("nan")))
    aux = trainer.train_step(bad, gen)
    assert float(aux["skipped"]) == 1.0 and trainer.step == 1
    for net, want in zip(nets, before):
        for k, v in net.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    after = trainer.optimizer.state_dict()["state"]
    for i, st in adam.items():
        for k, v in st.items():
            torch.testing.assert_close(after[i][k], v, rtol=0, atol=0)


@pytest.mark.parametrize("frozen", ["pc", "im"])
def test_a_frozen_net_takes_no_update(frozen):
    """Without ``--is_pc_train`` (or ``--is_im_train``) the backbone (or
    the encoder) is in no Adam group, runs in eval mode and leaves the
    step as it was, parameters and statistics; the other net trains. The
    decoder and the loaded encoder never change."""
    trainer = small_trainer(is_pc_train=frozen != "pc", is_im_train=frozen != "im")
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(False).items()}
    nets = {"pc": trainer.backbone, "im": trainer.encoder}
    still = [nets[frozen], trainer.implicit, trainer.loaded_encoder]
    moving = nets["im" if frozen == "pc" else "pc"]
    before = [{k: v.clone() for k, v in net.state_dict().items()} for net in still]
    moved = {k: v.clone() for k, v in moving.named_parameters()}
    assert [g["name"] for g in trainer.optimizer.param_groups] == [
        "enc" if frozen == "pc" else "pc"]
    aux = trainer.train_step(batch, torch.Generator().manual_seed(2))
    assert float(aux["skipped"]) == 0.0 and trainer.step == 1
    if frozen == "pc":
        assert float(aux["total"]) == float(aux["im_total"])
    for net, want in zip(still, before):
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[k]), k
    assert any(not torch.equal(p, moved[k]) for k, p in moving.named_parameters())


@pytest.mark.parametrize("layout", ["igr", "joint"])
def test_staged_init_restore(layout, tmp_path):
    """Trainer A's backbone and step from its checkpoint, the decoder and
    the loaded encoder from either implicit layout, and with
    ``is_im_init`` the trainable encoder as well, in tensors of its own;
    no implicit checkpoint keeps the fresh decoder with a warning."""
    src = small_trainer()
    pc_dir, im_dir = tmp_path / "pc", tmp_path / "im"
    pc_dir.mkdir()
    im_dir.mkdir()
    torch.save({"model": src.backbone.state_dict(), "optimizer": {}, "step": 7},
               pc_dir / "model.pth")
    names = (("model", "model_state_dict", "encoder_state_dict") if layout == "igr"
             else ("im_model", "implicit_net", "pn_encoder"))
    im_src = ImplicitNet(**DECODER)
    im_src.reset_parameters(torch.Generator().manual_seed(9))
    torch.save({names[1]: im_src.state_dict(), names[2]: src.loaded_encoder.state_dict()},
               im_dir / f"{names[0]}.pth")
    dst = small_trainer()
    lines = []
    step = TJ.staged_init_restore(
        dst.backbone, dst.implicit, dst.encoder, dst.loaded_encoder, is_pc_init=True,
        pc_logdir=str(pc_dir), pc_ckpt="model", is_im_init=True, im_logdir=str(im_dir),
        im_ckpt=names[0], log=lines.append, carry_step=True)
    assert step == 7
    assert lines == ["carrying trainer-A global step 7", "3D model loaded.",
                     "Pre-trained fixed implicit model loaded."]
    for got, want in ((dst.backbone, src.backbone), (dst.implicit, im_src),
                      (dst.encoder, src.loaded_encoder), (dst.loaded_encoder, src.loaded_encoder)):
        for key, val in want.state_dict().items():
            assert torch.equal(got.state_dict()[key], val), key
    for (_, a), (_, b) in zip(dst.encoder.named_parameters(),
                              dst.loaded_encoder.named_parameters()):
        assert a.data_ptr() != b.data_ptr()
    fresh = small_trainer()
    lines = []
    assert TJ.staged_init_restore(
        fresh.backbone, fresh.implicit, fresh.encoder, fresh.loaded_encoder,
        is_pc_init=False, pc_logdir="", pc_ckpt="model", is_im_init=True,
        im_logdir=str(tmp_path), im_ckpt="model", log=lines.append) == 0
    assert lines and lines[0].startswith("WARNING: no implicit checkpoint")
    with pytest.raises(ValueError, match="needs --is_pc_init"):
        TJ.staged_init_restore(fresh.backbone, fresh.implicit, fresh.encoder,
                               fresh.loaded_encoder, is_pc_init=False, pc_logdir="",
                               pc_ckpt="model", is_im_init=False, im_logdir="",
                               im_ckpt="model", carry_step=True)


def test_pipeline_sketch_batch_equals_jax_gather_batch():
    """With ``num_sketch_points`` the batch carries each item's sketch
    points at its own permutation, equal to JAX's ``_gather_batch`` at the
    indices its key draws; without it the batch is what it was."""
    ds_j = generate_dataset(4, resolution=256, max_instances=K, num_sketch_points=48, seed=2)
    ds_t = torch_generate(4, resolution=256, max_instances=K, num_sketch_points=48, seed=2)
    rows = np.array([3, 1], np.int32)
    key = jax.random.key(6)
    want = InputPipeline(ds_j, 64, K, num_sketch_points=S).batch(rows, key)
    k_pt, k_sk = jax.random.split(key)
    fold = jax.vmap(jax.random.fold_in, in_axes=(None, 0))
    sub_idx = jax.vmap(lambda kk: jax.random.permutation(kk, 256)[:64])(fold(k_pt, jnp.arange(2)))
    sk_idx = jax.vmap(lambda kk: jax.random.permutation(kk, 48)[:S])(fold(k_sk, jnp.arange(2)))
    assert not np.array_equal(np.asarray(sk_idx[0]), np.asarray(sk_idx[1]))
    pipe = TorchPipeline(ds_t, 64, K, "cpu", num_sketch_points=S)
    got = pipe.gather(torch.from_numpy(rows), torch.from_numpy(np.array(sub_idx)),
                      torch.from_numpy(np.array(sk_idx)))
    assert got["sketches"].shape == (2, K, S, 4) and got["sketches_norms"].shape == (2, K)
    for name in ("sketches", "sketches_norms", "point_cloud"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), name)

    drawn = pipe.batch(torch.from_numpy(rows), torch.Generator().manual_seed(3))
    plain = TorchPipeline(ds_t, 64, K, "cpu").batch(torch.from_numpy(rows),
                                                   torch.Generator().manual_seed(3))
    assert set(drawn) - set(plain) == {"sketches", "sketches_norms"}
    for name, val in plain.items():
        assert torch.equal(val, drawn[name]), name
    for b in range(2):  # a fresh order of the same points for each item
        row = torch.from_numpy(ds_t.sketches[rows[b]])
        for k in range(K):
            hits = (drawn["sketches"][b, k][:, None, :] == row[k][None]).all(-1)
            assert bool((hits.sum(1) >= 1).all())
    with pytest.raises(ValueError, match="sketch points"):
        TorchPipeline(ds_t, 64, K, "cpu", num_sketch_points=64)


def _epoch_lines(logdir: str) -> list[str]:
    with open(os.path.join(logdir, "log.txt")) as f:
        return re.findall(r"> Epoch (\d+) done", f.read())


def test_cli_pretrain_joint_resume_and_read_back(tmp_path):
    """On the CPU at a tiny size: Trainer A, then ``--pretrain_im`` (the
    IGR layout), then the joint CLI with ``--is_pc_init --init_global_step
    -1`` (both load lines, the carried step, the three files), a resume
    that continues at the checkpoint's epoch, and the evaluator and the
    restores reading the joint logdir; the deferred flags raise."""
    pc, igr, joint = (str(tmp_path / d) for d in ("pc", "igr", "joint"))
    tiny = ["--synthetic", "8", "--num_point", str(N), "--K", str(K), "--batch_size", "2",
            "--synthetic_resolution", "512", "--device", "cpu", "--num_epochs", "2"]
    heads = ["--pred_seg", "--pred_normal", "--pred_bb", "--pred_extrusion", "--pred_center"]
    assert train_pc.cli_main(tiny + heads + ["--logdir", pc]).step == 8
    pre = TJ.cli_main(tiny + ["--num_sk_point", str(S), "--pretrain_im", "--logdir", igr])
    assert isinstance(pre, TJ.ImPretrainer) and pre.step == 8
    state = torch.load(os.path.join(igr, "model.pth"), weights_only=True)
    assert set(state) == {"model_state_dict", "encoder_state_dict"}
    joint_args = tiny + heads + [
        "--num_sk_point", str(S), "--logdir", joint, "--is_pc_init", "--pc_logdir", pc,
        "--is_im_init", "--im_logdir", igr, "--is_pc_train", "--is_im_train",
        "--with_im_loss", "--init_global_step", "-1"]
    trainer = TJ.cli_main(joint_args)
    assert trainer.step == 16
    with open(os.path.join(joint, "log.txt")) as f:
        log = f.read()
    assert "carrying trainer-A global step 8" in log and "3D model loaded." in log
    assert "Pre-trained fixed implicit model loaded." in log
    losses = [float(v) for v in re.findall(r"Loss/\w+: (\S+)", log)]
    assert len(losses) == 2 * 11 and np.isfinite(losses).all()
    files = {n: torch.load(os.path.join(joint, f"{n}.pth"), weights_only=True)
             for n in ("model", "pc_model", "im_model")}
    assert {"model", "implicit_net", "pn_encoder"} <= set(files["model"])
    assert files["model"]["epoch"] == 2 and files["model"]["step"] == 16
    assert set(files["pc_model"]) == {"model"}
    assert set(files["im_model"]) == {"implicit_net", "pn_encoder"}
    for key, val in trainer.encoder.state_dict().items():
        assert torch.equal(files["im_model"]["pn_encoder"][key], val), key

    resumed = TJ.cli_main(joint_args[:-1] + ["0", "--resume", "--num_epochs", "3"])
    assert resumed.step == 20
    assert _epoch_lines(joint) == ["0001", "0002", "0003"]
    with open(os.path.join(joint, "log.txt")) as f:
        assert "epoch 2, step 16" in f.read()

    backbone = train_pc.build_model(TorchTrainConfig(**LOSS_FLAGS), N, K, "cpu")
    implicit, encoder = ImplicitNet(), PointNetEncoder()
    assert restore_backbone(joint, backbone) == "model"
    assert restore_implicit_stack(joint, implicit, encoder) == "model"
    assert restore_implicit_stack(joint, implicit, encoder, "im_model") == "im_model"
    alone = tmp_path / "pc_alone"
    alone.mkdir()
    shutil.copy(os.path.join(joint, "pc_model.pth"), alone / "pc_model.pth")
    assert restore_backbone(str(alone), backbone) == "pc_model"
    means = evaluator.cli_main(["--synthetic", "4", "--num_point", str(N), "--K", str(K),
                                "--batch_size", "2", "--num_sk_point", str(S),
                                "--synthetic_resolution", "512", "--device", "cpu",
                                "--logdir", joint, "--im_logdir", joint])
    assert all(np.isfinite(v) for v in means.values())
    assert means["fit_cyl_loss"] > 0 and means["fit_global_loss"] > 0
    with open(os.path.join(joint, "log_evaluate.txt")) as f:
        assert f"Restored implicit stack from {joint}/model" in f.read()

    for flag in (["--multihost"], ["--data_parallel", "2"]):
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            TJ.cli_main(tiny + ["--logdir", str(tmp_path / "x")] + flag)


@pytest.mark.parametrize("flag,m,want", [(-1, 128, None), (0, 32, None), (0, 128, 32),
                                         (5, 8, 5)])
def test_resolve_igr_chunk(flag, m, want):
    assert TJ.resolve_igr_chunk(flag, m) == want
