"""The port's evaluator (point2cyl_torch.eval) against the JAX evaluator, on
the CPU at a small size.

Each new geometry, loss and metric function is held against its JAX
counterpart on the same numpy inputs (the metric functions under all
eight oracle-substitution combinations, with and without norm_eig); the
eval step and ``evaluate()`` run on the batches of the JAX evaluator's
own ``InputPipeline(shuffle=False)`` through a backbone with the JAX
weights, carried across by core/convert.py. Random draws do not cross
frameworks: the segment sampling is compared in its deterministic mode
and the keyed draw on its own.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.core.config import BackboneConfig as TorchConfig
from point2cyl_torch.core.config import EvalConfig as TorchEvalConfig
from point2cyl_torch.core.convert import backbone_state_dict_from_jax
from point2cyl_torch.data.pipeline import InputPipeline as TorchPipeline
from point2cyl_torch.data.synthetic import generate_dataset as torch_generate
from point2cyl_torch.eval import ab_pack
from point2cyl_torch.eval import evaluator as tev
from point2cyl_torch.eval import metrics as TM
from point2cyl_torch.losses import normal as TLN
from point2cyl_torch.losses import segmentation as TLS
from point2cyl_torch.models.backbone import Backbone as TorchBackbone
from point2cyl_torch.ops import geometry as TG
from point2cyl_torch.ops.matching import hungarian_matching as torch_matching
from point2cyl_torch.train import train_pc
from point2cyl_torch.train.steps import assemble_heads as torch_assemble_heads
from point2cyl_tpu.core.config import BackboneConfig, EvalConfig
from point2cyl_tpu.core.torch_compat import import_backbone
from point2cyl_tpu.data.pipeline import InputPipeline
from point2cyl_tpu.data.synthetic import generate_dataset
from point2cyl_tpu.eval import evaluator as jev
from point2cyl_tpu.eval import metrics as JM
from point2cyl_tpu.losses import normal as JLN
from point2cyl_tpu.losses import segmentation as JLS
from point2cyl_tpu.models.backbone import Backbone
from point2cyl_tpu.ops import geometry as JG
from point2cyl_tpu.ops.matching import hungarian_matching as jax_matching

from test_torch_implicit import (draw_deterministically, jax_encoder, jax_implicit,
                                 port_encoder, port_implicit)

B, N, K, S = 3, 96, 4, 16
CFG = BackboneConfig(
    num_points=N,
    sa_npoints=(32, 8),
    sa_radii=(0.3, 0.6),
    sa_nsamples=(16, 8),
    sa_mlps=((16, 32), (32, 64)),
    sa_global_mlp=(64, 128),
    fp_mlps=((64,), (32,), (32, 32)),
    fc_width=32,
    output_sizes=(3, 2 * K),
    approx_neighbors=False,
)
FLAGS = list(itertools.product([False, True], repeat=3))
# tolerances of the metric means: mIoU and bb accuracy are ratios of
# counts, the angles go through arccos near 0 and 180 degrees
MEAN_ATOL = {"miou": 1e-5, "bb_accuracy": 1e-5, "normal_error_deg": 2e-3,
             "axis_error_deg": 2e-3, "centroid_difference": 1e-5}


def labeled_cloud(seed: int) -> dict[str, np.ndarray]:
    """Points in the unit ball, unit normals, contiguous instance labels
    (each of 2..K instances at least twice), iid base/barrel labels, unit
    axes and centres."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((B, N, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts *= rng.uniform(0.2, 1.0, (B, N, 1)).astype(np.float32)
    normals = rng.standard_normal((B, N, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    n_inst = rng.integers(2, K + 1, (B,))
    seg = np.stack([rng.integers(0, ni, (N,)) for ni in n_inst]).astype(np.int32)
    for b in range(B):
        for i in range(n_inst[b]):
            seg[b, 2 * i: 2 * i + 2] = i
    axes = rng.standard_normal((B, K, 3)).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    return {
        "points": pts, "normals": normals, "seg": seg,
        "bb": rng.integers(0, 2, (B, N)).astype(np.int32), "axes": axes,
        "centers": rng.uniform(-0.5, 0.5, (B, K, 3)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def cloud():
    return labeled_cloud(7)


def both(x: np.ndarray):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def close(got: torch.Tensor, want, atol: float, rtol: float = 0.0) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


# ---- losses ----------------------------------------------------------------


@pytest.mark.parametrize("in_radians,collapse", [(True, True), (False, False)])
def test_normal_difference_matches_jax(cloud, in_radians, collapse):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x[0, :4] = cloud["normals"][0, :4]  # parallel: the clamp at 1 - 1e-6
    x[1, :4] = -cloud["normals"][1, :4]
    xj, xt = both(x)
    nj, nt = both(cloud["normals"])
    close(TLN.normal_difference(xt, nt, in_radians, collapse),
          JLN.normal_difference(xj, nj, in_radians, collapse),
          atol=2e-3 if not in_radians else 4e-5)


def test_segmentation_ious_match_jax(cloud):
    w = np.random.default_rng(2).dirichlet(np.ones(K), (B, N)).astype(np.float32)
    wj, wt = both(w)
    ij, it = both(cloud["seg"])
    mj, mask_j = jax_matching(wj, ij)
    mt, mask_t = torch_matching(wt, it)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    close(TLS.segmentation_iou(wt, it, mt, mask_t),
          JLS.segmentation_iou(wj, ij, mj, mask_j), atol=1e-6)
    weights = np.stack([(cloud["seg"] == k).sum(1) for k in range(K)], 1).astype(np.float32)
    close(TLS.weighted_segmentation_iou(wt, it, mt, torch.from_numpy(weights)),
          JLS.weighted_segmentation_iou(wj, ij, mj, jnp.asarray(weights)), atol=1e-6)


# ---- geometry --------------------------------------------------------------


@pytest.mark.parametrize("with_bb", [True, False])
def test_segment_masks_and_deterministic_draw_match_jax(cloud, with_bb):
    """The masks equal, and the deterministic draw's indices equal, an
    empty segment included (instance K-1 of a sample with fewer)."""
    bb = cloud["bb"] if with_bb else None
    mj = JG.segment_masks(jnp.asarray(cloud["seg"]),
                          None if bb is None else jnp.asarray(bb), K)
    mt = TG.segment_masks(torch.from_numpy(cloud["seg"]),
                          None if bb is None else torch.from_numpy(bb), K)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    idx_j, found_j = JG.sample_segment_points(None, mj, S)
    idx_t, found_t = TG.sample_segment_points(None, mt, S)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    if with_bb:
        assert bool((mt.sum(-1) == 0).any()), "no empty segment exercised"


def test_keyed_draw_stays_in_range_and_repeats(cloud):
    """The generator's draw picks members only, every member of a segment
    can come up, and the same seed gives the same draw."""
    masks = TG.segment_masks(torch.from_numpy(cloud["seg"]),
                             torch.from_numpy(cloud["bb"]), K)
    draw = lambda seed: TG.sample_segment_points(  # noqa: E731
        torch.Generator().manual_seed(seed), masks, 512)
    idx, found = draw(3)
    again, _ = draw(3)
    other, _ = draw(4)
    assert torch.equal(idx, again) and not torch.equal(idx, other)
    count = masks.sum(-1)
    for b, k in itertools.product(range(B), range(K)):
        picked = idx[b, k]
        if count[b, k] == 0:
            assert bool((picked == 0).all())
            continue
        assert bool(masks[b, k, picked].all())
        if count[b, k] <= 32:  # 512 draws reach every one of a few members
            assert set(picked.tolist()) == set(torch.nonzero(masks[b, k])[:, 0].tolist())
    np.testing.assert_array_equal(found.numpy(), (count > 1).numpy())


def test_rotation_to_z_reference_matches_jax(cloud):
    """Random axes plus +-z, axes within 1e-4 of z (the Taylor branch)
    and the x axis, atol 1e-6."""
    axes = np.concatenate([
        cloud["axes"].reshape(-1, 3),
        np.array([[0, 0, 1], [0, 0, -1], [1e-4, 0, 1], [0, -1e-4, -1], [1, 0, 0],
                  [0.6, 0.0, 0.8]], np.float32),
    ]).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    aj, at = both(axes)
    close(TG.rotation_to_z_reference(at), JG.rotation_to_z_reference(aj), atol=1e-6)


@pytest.mark.parametrize("rotation_mode,with_bb", [("exact", True), ("reference", True),
                                                   ("exact", False), ("reference", False)])
def test_sketch_projection_matches_jax(cloud, rotation_mode, with_bb):
    bb = cloud["bb"] if with_bb else None
    want = JG.sketch_projection(
        None, jnp.asarray(cloud["points"]), jnp.asarray(cloud["normals"]),
        jnp.asarray(cloud["seg"]), None if bb is None else jnp.asarray(bb),
        jnp.asarray(cloud["axes"]), jnp.asarray(cloud["centers"]), num_samples=S,
        rotation_mode=rotation_mode)
    got = TG.sketch_projection(
        None, torch.from_numpy(cloud["points"]), torch.from_numpy(cloud["normals"]),
        torch.from_numpy(cloud["seg"]), None if bb is None else torch.from_numpy(bb),
        torch.from_numpy(cloud["axes"]), torch.from_numpy(cloud["centers"]),
        num_samples=S, rotation_mode=rotation_mode)
    for g, w in zip(got[:3], want[:3]):
        close(g, w, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_extrusion_extents_and_fused_path_match_jax(cloud):
    """The general path against JAX, and the serving path's fused
    extents and projection equal to the general path's."""
    pts, nrm, seg, bb, axes, centers = (torch.from_numpy(cloud[key]) for key in (
        "points", "normals", "seg", "bb", "axes", "centers"))
    want, found_j = JG.extrusion_extents(
        None, *(jnp.asarray(cloud[key]) for key in ("points", "seg", "bb", "axes",
                                                      "centers")), num_samples=S)
    got, found = TG.extrusion_extents(None, pts, seg, bb, axes, centers, num_samples=S)
    close(got, want, atol=1e-5)
    np.testing.assert_array_equal(found.numpy(), np.asarray(found_j))
    fused = TG.extents_and_sketch_projection(pts, nrm, seg, bb, axes, centers,
                                             num_samples=S)
    general = TG.sketch_projection(None, pts, nrm, seg, bb, axes, centers, num_samples=S)
    assert torch.equal(fused[0], got)
    for f, g in zip(fused[1:], general):
        assert torch.equal(f, g)


# ---- metrics ---------------------------------------------------------------


@pytest.mark.parametrize("norm_eig", [False, True])
@pytest.mark.parametrize("use_gt_normals,use_gt_seg,use_gt_bb", FLAGS)
def test_eval_metrics_substitution_matrix_match_jax(cloud, use_gt_normals, use_gt_seg,
                                                   use_gt_bb, norm_eig):
    """The JAX side of test_eval_substitution_matrix_parity: weights atol
    1e-5, axis error atol 2e-3 degrees; also the segmentation metrics, the
    base/barrel accuracy, the centres and the centroid metric."""
    rng = np.random.default_rng(17)
    w_raw = (2.0 * rng.standard_normal((B, N, 2 * K))).astype(np.float32)
    x_pred = rng.standard_normal((B, N, 3)).astype(np.float32)
    x_pred /= np.linalg.norm(x_pred, axis=-1, keepdims=True)
    flags = dict(use_gt_normals=use_gt_normals, use_gt_segmentation=use_gt_seg,
                 use_gt_bb=use_gt_bb, norm_eig=norm_eig)
    jcfg, tcfg = EvalConfig(**flags), TorchEvalConfig(**flags)

    w2k_j = jax.nn.softmax(jnp.asarray(w_raw), axis=-1)
    w2k_t = torch.softmax(torch.from_numpy(w_raw), dim=-1)
    wj, wt = w2k_j[:, :, ::2] + w2k_j[:, :, 1::2], w2k_t[:, :, ::2] + w2k_t[:, :, 1::2]
    ij, it = both(cloud["seg"])
    bj, bt = both(cloud["bb"])
    seg_j, seg_t = JM.segmentation_metrics(wj, ij), TM.segmentation_metrics(wt, it)
    np.testing.assert_array_equal(seg_t.matching.numpy(), np.asarray(seg_j.matching))
    np.testing.assert_array_equal(seg_t.mask.numpy(), np.asarray(seg_j.mask))
    close(seg_t.miou, seg_j.miou, atol=1e-6)
    acc_j, pred_j = JM.base_barrel_accuracy(w2k_j, bj)
    acc_t, pred_t = TM.base_barrel_accuracy(w2k_t, bt)
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))
    close(acc_t, acc_j, atol=1e-7)

    wb_j, wc_j, ea_j = JM.axis_estimation_weights(
        jcfg, seg_j, wj, w2k_j[:, :, ::2], w2k_j[:, :, 1::2], w2k_j, ij, bj)
    wb_t, wc_t, ea_t = TM.axis_estimation_weights(
        tcfg, seg_t, wt, w2k_t[:, :, ::2], w2k_t[:, :, 1::2], w2k_t, it, bt)
    for g, w in ((wb_t, wb_j), (wc_t, wc_j), (ea_t, ea_j)):
        close(g, w, atol=1e-5)
    nj, nt = both(cloud["normals"])
    aj, at = both(cloud["axes"])
    err_j, axes_j = JM.axis_metrics(jcfg, jnp.asarray(x_pred), nj, wb_j, wc_j, ij, bj, aj)
    err_t, axes_t = TM.axis_metrics(tcfg, torch.from_numpy(x_pred), nt, wb_t, wc_t, it,
                                    bt, at)
    close(err_t, err_j, atol=2e-3)
    pj, pt = both(cloud["points"])
    cen_j, found_j = JM.hard_segment_centers(pj, ea_j)
    cen_t, found_t = TM.hard_segment_centers(pt, ea_t)
    close(cen_t, cen_j, atol=1e-6)
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    cj, ct = both(cloud["centers"])
    close(TM.centroid_metric(cen_t, ct, it), JM.centroid_metric(cen_j, cj, ij), atol=1e-5)


# ---- the eval step and evaluate() -----------------------------------------


def jax_and_port_weights(k: int = K, seed: int = 0):
    """JAX variables and the port's model with K=``k`` (heads [3, 2k]) on
    the same weights: random
    dense layers and BN affine parameters, and BN statistics taken from
    the evaluation's own clouds, as a trained model's are. (With a fresh
    model's arbitrary statistics the heads are the same at every point to
    1e-3, so every axis matrix has rank 1 and its axis is any vector in a
    plane: the float32 eigensolver picks one by rounding.)"""
    cfg = dataclasses.replace(CFG, output_sizes=(3, 2 * k))
    model = Backbone(cfg)
    key = jax.random.key(5)
    variables = model.init({"params": key, "sample": key, "dropout": key},
                           jnp.zeros((1, N, 3)), train=False)
    rng = np.random.default_rng(5)

    def bn(path, leaf):
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, np.shape(leaf)).astype(np.float32)
        if path[-1].key == "bias" and "TorchBatchNorm" in str(path):
            return rng.normal(0.0, 0.1, np.shape(leaf)).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(bn, jax.device_get(variables["params"]))
    stats = jax.device_get(variables["batch_stats"])
    torch_model = TorchBackbone(TorchConfig.from_dict(dataclasses.asdict(cfg)))
    torch_model.load_state_dict(backbone_state_dict_from_jax(params, stats), strict=True)
    clouds = torch.from_numpy(np.concatenate(
        [np.asarray(b["point_cloud"]) for b in jax_batches(seed, k)]))
    with torch.no_grad():  # momentum 1: the running statistics become the batch's
        torch_model(clouds, train=True, bn_momentum=1.0,
                    generator=torch.Generator().manual_seed(0),
                    fps_starts=[torch.zeros(len(clouds), dtype=torch.int64)] * 2)
    params, stats = import_backbone(torch_model.state_dict(), params, stats)
    return model, {"params": params, "batch_stats": stats}, torch_model


@pytest.fixture(scope="module")
def weights():
    return jax_and_port_weights()


def jax_pipeline(k: int = K) -> InputPipeline:
    ds = generate_dataset(2 * B, resolution=256, max_instances=k, num_sketch_points=S,
                          seed=1)
    return InputPipeline(ds, N, k, num_sketch_points=S)


def jax_batches(seed: int = 0, k: int = K) -> list[dict]:
    """The batches JAX ``evaluate`` reads, with no point pair within 1e-5
    of a squared ball-query radius (the JAX CPU path measures distances by
    expansion, the port by differences)."""
    batches = list(jax_pipeline(k).epochs(B, jax.random.key(seed), shuffle=False))
    for batch in batches:
        pts = np.asarray(batch["point_cloud"], np.float64)
        d2 = ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)
        for r in CFG.sa_radii:
            assert np.abs(d2 - r * r).min() > 1e-5, "a pair sits at a radius"
    return batches


def to_torch(batch: dict) -> dict:
    return {key: torch.from_numpy(np.array(val)) for key, val in batch.items()}


HEADS = {
    "all heads": {},
    "seg off": dict(pred_seg=False),
    "bb off": dict(pred_bb=False),
    "normal off, gt normals": dict(pred_normal=False, use_gt_normals=True),
    "gt seg and bb, norm_eig": dict(use_gt_segmentation=True, use_gt_bb=True,
                                    norm_eig=True),
}


def heads_model(weights, flags):
    """The JAX model and variables and the port's model for ``flags``:
    a switched-off head is a dense layer of width 1 on both sides."""
    model, variables, torch_model = weights
    sizes = (3 if flags.get("pred_normal", True) else 1,
             2 * K if flags.get("pred_bb", True) and flags.get("pred_seg", True)
             else (K if flags.get("pred_seg", True) else 1))
    if sizes == CFG.output_sizes:
        return model, variables, torch_model
    cfg = dataclasses.replace(CFG, output_sizes=sizes)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(9)
    for i, width in enumerate(sizes):
        head = params[f"TorchDense_{i + 1}"]  # TorchDense_0 is fc1
        if head["kernel"].shape[-1] != width:
            head["kernel"] = rng.normal(0, 0.1, head["kernel"].shape[:-1]
                                        + (width,)).astype(np.float32)
            head["bias"] = np.zeros((width,), np.float32)
    new_vars = {"params": params, "batch_stats": variables["batch_stats"]}
    tm = TorchBackbone(TorchConfig.from_dict(dataclasses.asdict(cfg)))
    tm.load_state_dict(backbone_state_dict_from_jax(params, variables["batch_stats"]),
                       strict=True)
    return Backbone(cfg), new_vars, tm


@pytest.mark.parametrize("heads", list(HEADS))
def test_evaluate_matches_jax(weights, heads):
    """``evaluate()``'s metric means against JAX ``evaluate`` on the JAX
    pipeline's own batches, line for line; and one eval step's labels
    equal and its extents (the deterministic draw) against JAX's."""
    flags = HEADS[heads]
    model, variables, torch_model = heads_model(weights, flags)
    jlines, tlines = [], []
    jcfg, tcfg = EvalConfig(**flags), TorchEvalConfig(**flags)
    want = jev.evaluate(variables, None, None, model, None, None, jax_pipeline(), jcfg,
                        B, seed=0, log=jlines.append)
    batches = jax_batches()
    got = tev.evaluate(torch_model, [to_torch(b) for b in batches], tcfg, B, seed=0,
                       log=tlines.append)
    assert set(got) == set(want)
    for name, atol in MEAN_ATOL.items():
        assert abs(got[name] - want[name]) <= atol, (name, got[name], want[name])
    block_j = [line for line in jlines if not line.startswith("Time elapsed")]
    block_t = [line for line in tlines if not line.startswith("Time elapsed")]
    assert len(block_t) == len(block_j) == 9
    for lt, lj in zip(block_t, block_j):
        assert lt.rsplit("=", 1)[0] == lj.rsplit("=", 1)[0]
    if not flags.get("pred_seg", True):
        assert got["miou"] == 1.0

    # one step: the labels, and the extents through the deterministic draw
    batch = batches[0]
    step = tev.make_eval_step(torch_model, tcfg, S)
    out = step(to_torch(batch), None)
    x_raw, w_raw = model.apply(variables, batch["point_cloud"], train=False)
    heads_j = jev.assemble_heads(x_raw, w_raw, jcfg.pred_seg, jcfg.pred_bb, k=K)
    if jcfg.pred_seg:
        seg = JM.segmentation_metrics(heads_j.w, batch["extrusion_labels"])
        w_vis = jnp.where(seg.mask[:, None, :],
                          JLS.reorder_w(seg.w_hard, seg.matching), -1.0)
        np.testing.assert_array_equal(out["pred_labels"].numpy(),
                                      np.asarray(jnp.argmax(w_vis, axis=-1)))
    else:
        assert "pred_labels" not in out
    if jcfg.pred_bb:
        _, pred_bb = JM.base_barrel_accuracy(heads_j.w_2k, batch["base_barrel_labels"])
        np.testing.assert_array_equal(out["pred_bb_labels"].numpy(), np.asarray(pred_bb))
    extents, _ = JG.extrusion_extents(
        None, batch["point_cloud"], batch["extrusion_labels"],
        batch["base_barrel_labels"], batch["extrusion_axes"], batch["extrusion_centers"],
        num_samples=S)
    close(out["extents"], extents, atol=1e-5)
    heads_t = torch_assemble_heads(*torch_model(to_torch(batch)["point_cloud"]),
                                   tcfg.pred_seg, tcfg.pred_bb, k=K)
    close(heads_t.w.detach(), heads_j.w, atol=1e-5)


def test_evaluate_above_eight_instances_matches_jax():
    """K=10: the metric block's means against JAX ``evaluate`` on the JAX
    pipeline's batches, both matching through the Jonker-Volgenant
    solver, and one step's labels equal. (Epoch seeds 0-10 draw a pair
    at a ball-query radius; 11 is the first that does not.)"""
    k, seed = 10, 11
    model, variables, torch_model = jax_and_port_weights(k, seed)
    batches = jax_batches(seed, k)
    assert max(int(np.asarray(b["extrusion_labels"]).max()) for b in batches) + 1 > 8
    jlines, tlines = [], []
    want = jev.evaluate(variables, None, None, model, None, None, jax_pipeline(k),
                        EvalConfig(), B, seed=seed, log=jlines.append)
    got = tev.evaluate(torch_model, [to_torch(b) for b in batches], TorchEvalConfig(), B,
                       seed=seed, log=tlines.append)
    assert set(got) == set(want)
    for name, atol in MEAN_ATOL.items():
        assert abs(got[name] - want[name]) <= atol, (name, got[name], want[name])
    block_j = [line for line in jlines if not line.startswith("Time elapsed")]
    block_t = [line for line in tlines if not line.startswith("Time elapsed")]
    assert [line.rsplit("=", 1)[0] for line in block_t] \
        == [line.rsplit("=", 1)[0] for line in block_j]
    out = tev.make_eval_step(torch_model, TorchEvalConfig(), S)(to_torch(batches[0]), None)
    x_raw, w_raw = model.apply(variables, batches[0]["point_cloud"], train=False)
    heads_j = jev.assemble_heads(x_raw, w_raw, True, True, k=k)
    seg = JM.segmentation_metrics(heads_j.w, batches[0]["extrusion_labels"])
    w_vis = jnp.where(seg.mask[:, None, :], JLS.reorder_w(seg.w_hard, seg.matching), -1.0)
    np.testing.assert_array_equal(out["pred_labels"].numpy(),
                                  np.asarray(jnp.argmax(w_vis, axis=-1)))


def test_eval_step_noise_and_normal_head_rules(weights):
    """Noise draws from the generator (the same seed, the same metrics);
    without a generator it raises; the 1-wide dummy normal head without
    GT normals raises."""
    torch_model = weights[2]
    batch = to_torch(jax_batches()[0])
    step = tev.make_eval_step(torch_model, TorchEvalConfig(add_noise=True), S)
    a = step(batch, torch.Generator().manual_seed(1))
    b = step(batch, torch.Generator().manual_seed(1))
    c = step(batch, torch.Generator().manual_seed(2))
    for key in ("miou", "normal_error_deg", "extents"):
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["extents"], c["extents"])
    with pytest.raises(ValueError, match="generator"):
        step(batch, None)
    with pytest.raises(ValueError, match="use_gt_normals"):
        tev.make_eval_step(torch_model, TorchEvalConfig(pred_normal=False), S)
    assert not torch_model.training


# ---- the pipeline and the CLI ---------------------------------------------


def test_pipeline_epochs_without_shuffle_in_row_order():
    ds = torch_generate(5, resolution=256, max_instances=K, num_sketch_points=S, seed=2)
    pipe = TorchPipeline(ds, N, K, "cpu")
    gen = torch.Generator().manual_seed(0)
    batches = list(pipe.epochs(2, gen, shuffle=False))
    assert len(batches) == 2  # the ragged tail dropped
    for i, batch in enumerate(batches):
        for j in range(2):
            row = 2 * i + j
            cloud = torch.from_numpy(ds.point_cloud[row].astype(np.float32))
            # every point of the batch is a point of dataset row `row`
            same = (batch["point_cloud"][j][:, None, :] == cloud[None]).all(-1)
            assert bool(same.any(-1).all())
    shuffled = list(pipe.epochs(2, torch.Generator().manual_seed(0)))
    assert len(shuffled) == 2


@pytest.fixture(scope="module")
def trained_logdir(tmp_path_factory):
    logdir = str(tmp_path_factory.mktemp("torch_eval_run"))
    train_pc.cli_main(["--synthetic", "4", "--num_point", "128", "--K", "4",
                       "--batch_size", "2", "--num_epochs", "1", "--device", "cpu",
                       "--pred_seg", "--pred_normal", "--pred_bb", "--pred_extrusion",
                       "--pred_center", "--synthetic_resolution", "512",
                       "--logdir", logdir])
    return logdir


EVAL_ARGS = ["--synthetic", "4", "--num_point", "128", "--K", "4", "--batch_size", "2",
             "--no_implicit", "--synthetic_resolution", "512"]


def test_cli_restores_the_trainers_checkpoint_and_prints_the_block(trained_logdir,
                                                                   capsys):
    means = tev.cli_main(EVAL_ARGS + ["--device", "cpu", "--logdir", trained_logdir])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"Restored backbone from {trained_logdir}/model"
    block = out[out.index("=" * 20) + 1:]
    labels = ["Num evaluated", "Mean mIOU", "Mean normal angle error (degrees) ",
              "Mean base/barrel accuracy", "Mean extrusion angle error (degrees) ",
              "Mean centroid difference ", "Mean per-extrusion cylinder fitting loss",
              "Mean global fitting loss"]
    assert [line.rsplit("=", 1)[0] for line in block] == labels
    assert block[0] == "Num evaluated= 4" and block[-1].endswith("= 0.0")
    assert all(np.isfinite(v) for v in means.values())
    with open(os.path.join(trained_logdir, "log_evaluate.txt")) as f:
        assert f.read().splitlines() == out


def test_cli_fresh_init_warns(tmp_path, capsys):
    tev.cli_main(EVAL_ARGS + ["--device", "cpu", "--logdir", str(tmp_path)])
    assert capsys.readouterr().out.splitlines()[0] == (
        f"WARNING: no checkpoint at {tmp_path}/model — fresh init")


def test_cli_needs_the_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.cli_main(EVAL_ARGS + ["--logdir", str(tmp_path)])


@pytest.mark.parametrize("flags,match", [
    (["--visu"], "matplotlib"), (["--visu", "--use_gt_im"], "matplotlib"),
    (["--visu", "--use_whole_pc"], "matplotlib"),
    (["--visu", "--use_extrusion_axis_feat"], "matplotlib"),
])
def test_cli_deferred_flags_raise(tmp_path, monkeypatch, flags, match):
    """--visu with the implicit stack draws SDF contour plots: where
    matplotlib cannot be imported, each mode raises before its first
    batch (no plot is skipped quietly)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    def no_batch(*args, **kwargs):
        raise AssertionError("the sweep started")

    monkeypatch.setattr(tev, "make_eval_step", no_batch)
    args = [a for a in EVAL_ARGS if a != "--no_implicit"] + flags
    with pytest.raises(ImportError, match=match):
        tev.cli_main(args + ["--device", "cpu", "--logdir", str(tmp_path),
                             "--dump_dir", str(tmp_path / "dump")])


def test_cli_visu_writes_labelled_clouds_and_render_scripts(trained_logdir, tmp_path,
                                                            capsys):
    """Without the implicit stack: one pred and one gt cloud per sample,
    named ``{batch}_{row}_{miou:.3f}``, render.sh and image_files.sh, as
    the JAX evaluator writes them; no plot."""
    dump = tmp_path / "dump"
    means = tev.cli_main(EVAL_ARGS + ["--visu", "--device", "cpu", "--logdir",
                                      trained_logdir, "--dump_dir", str(dump)])
    files = sorted(os.listdir(dump))
    clouds = [f for f in files if f.endswith("_pred.pts")]
    assert len(clouds) == 4 and len([f for f in files if f.endswith("_gt.pts")]) == 4
    assert {f.rsplit("_", 2)[0] for f in clouds} == {"0_0", "0_1", "1_0", "1_1"}
    assert not [f for f in files if f.endswith(".png")]
    render = (dump / "render.sh").read_text().splitlines()
    assert render[0] == "#!/bin/sh" and len(render) == 1 + 8
    out = capsys.readouterr().out
    assert f"Wrote {dump}/render.sh and {dump}/image_files.sh" in out
    assert np.isfinite(means["miou"])


def test_cli_visu_plots_each_instance_with_the_implicit_stack(trained_logdir, tmp_path):
    """With the implicit stack, also one SDF contour plot (PNG) per
    ground-truth instance of each sample."""
    gen = torch.Generator().manual_seed(3)
    implicit, encoder = tev.ImplicitNet(d_in=258), tev.encoder_for(TorchEvalConfig())
    implicit.reset_parameters(gen)
    encoder.reset_parameters(gen)
    im_dir = tmp_path / "igr"
    im_dir.mkdir()
    torch.save({"model_state_dict": implicit.state_dict(),
                "encoder_state_dict": encoder.state_dict()}, im_dir / "model.pth")
    dump = tmp_path / "dump"
    args = [a for a in EVAL_ARGS if a != "--no_implicit"]
    args[args.index("--synthetic") + 1] = "2"  # one batch: a plot takes ~0.3 s
    tev.cli_main(args + ["--visu", "--device", "cpu", "--logdir", trained_logdir,
                         "--im_logdir", str(im_dir), "--dump_dir", str(dump)])
    ds = torch_generate(2, resolution=512, max_instances=K, num_sketch_points=2048)
    want = sorted(f"igr_2d_0_{i}_{kk}.png" for i in range(2)
                  for kk in range(int(ds.n_instances[i])))
    pngs = sorted(f for f in os.listdir(dump) if f.endswith(".png"))
    assert pngs == want
    assert all((dump / f).stat().st_size > 0 for f in pngs)
    assert (dump / "render.sh").exists()


def test_cli_store_false_quirk():
    args = tev.build_argparser().parse_args(["--pred_seg", "--pred_bb"])
    assert (args.pred_seg, args.pred_normal, args.pred_bb) == (False, True, False)


def test_ab_pack_runs_the_protocol(tmp_path, monkeypatch):
    """The run check passes the protocol's flags (``tools/tpu_queue_r4.sh:
    75-80``) to the two CLIs and reads the last epoch's loss back."""
    calls = []

    def fake_train(argv):
        calls.append(train_pc.build_argparser().parse_args(argv))
        os.makedirs(calls[-1].logdir)
        with open(os.path.join(calls[-1].logdir, "log.txt"), "w") as f:
            f.write("> Epoch 0149 done in 0.3s | Loss/total: 2.5000\n"
                    "> Epoch 0150 done in 0.3s | Loss/total: 1.2345 | Loss/bb: 0.5\n")

    def fake_eval(argv):
        calls.append(tev.build_argparser().parse_args(argv))
        return {"miou": 0.5}

    monkeypatch.setattr(ab_pack.train_pc, "cli_main", fake_train)
    monkeypatch.setattr(ab_pack.evaluator, "cli_main", fake_eval)
    rows = ab_pack.main(["--seeds", "7", "--out_dir", str(tmp_path), "--device", "cpu"])
    train, ev = calls
    assert (train.data_dir, train.data_split, train.num_point, train.batch_size,
            train.num_epochs, train.seed) == ("ab_data", "train", 512, 8, 150, 7)
    assert all((train.pred_seg, train.pred_normal, train.pred_bb, train.pred_extrusion,
                train.pred_center))
    assert (ev.logdir, ev.data_split, ev.num_point, ev.batch_size, ev.no_implicit,
            ev.seed, ev.device) == (train.logdir, "test", 512, 8, True, 0, "cpu")
    assert ev.pred_seg and ev.pred_normal and ev.pred_bb
    assert rows[0]["seed"] == 7 and rows[0]["final_train_loss"] == 1.2345
    assert rows[0]["miou"] == 0.5 and "card" in rows[0]


# ---- the implicit stack: latents and the fitting metrics -------------------

L = 16  # latent width of the test's narrow stack
IMPLICIT = dict(d_in=2 + L, hidden=(32,) * 4, skip_in=(2,))
MODES = {
    "sketch": {},
    "gt im": dict(use_gt_im=True),
    "whole pc": dict(use_whole_pc=True),
    "whole pc, axis": dict(use_whole_pc=True, use_extrusion_axis_feat=True),
    "whole pc, gt im": dict(use_whole_pc=True, use_gt_im=True),
}
# the fitting metrics' means: |SDF| of a narrow decoder (about 0.1-1)
# at projected points, through axes within 2e-3 degrees of JAX's
FIT_ATOL = {"fit_cyl_loss": 1e-4, "fit_global_loss": 1e-4}


def implicit_stack(flags: dict):
    """The JAX decoder and encoder for ``flags`` (narrow, random BN
    statistics) and the port's on the same weights."""
    cfg = TorchEvalConfig(**flags)
    enc_args = (L, 2, True)
    if cfg.use_whole_pc:
        enc_args = (L, 7 if cfg.use_extrusion_axis_feat else 4, False)
    implicit, im_params = jax_implicit(IMPLICIT, seed=13)
    encoder, enc_params, enc_stats = jax_encoder(enc_args, seed=14)
    return ((implicit, {"params": im_params}, encoder,
             {"params": enc_params, "batch_stats": enc_stats}),
            (port_implicit(IMPLICIT, im_params), port_encoder(enc_args, enc_params,
                                                               enc_stats)))


@pytest.mark.parametrize("mode", list(MODES))
def test_evaluate_with_implicit_stack_matches_jax(weights, monkeypatch, mode):
    """In each encoder mode, ``evaluate()``'s means against JAX
    ``evaluate`` (MEAN_ATOL, the fitting metrics within 1e-4)
    with the same block of lines, and one step's latents within 1e-5 and
    per-cloud fitting metrics within 1e-4 of JAX's step."""
    # every segment draw of both evaluators in the deterministic mode
    draw_deterministically(monkeypatch, (jev, "sketch_projection"),
                           (jev, "extrusion_extents"), (JM, "sketch_projection"),
                           (tev, "sketch_projection"), (tev, "extrusion_extents"),
                           (TM, "sketch_projection"))
    flags = MODES[mode]
    model, variables, torch_model = weights
    (j_im, j_im_vars, j_enc, j_enc_vars), (t_im, t_enc) = implicit_stack(flags)
    # JAX evaluate samples the pipeline's num_sketch_points (S), the port
    # the config's (the CLIs set both from --num_sk_point)
    jcfg = EvalConfig(**flags, num_sketch_samples=S)
    tcfg = TorchEvalConfig(**flags, num_sketch_samples=S)
    jlines, tlines = [], []
    want = jev.evaluate(variables, j_im_vars, j_enc_vars, model, j_im, j_enc,
                        jax_pipeline(), jcfg, B, seed=0, log=jlines.append)
    batches = jax_batches()
    got = tev.evaluate(torch_model, [to_torch(b) for b in batches], tcfg, B, seed=0,
                       log=tlines.append, implicit=t_im, encoder=t_enc)
    assert set(got) == set(want) and set(FIT_ATOL) <= set(got)
    for name, atol in {**MEAN_ATOL, **FIT_ATOL}.items():
        assert abs(got[name] - want[name]) <= atol, (name, got[name], want[name])
    assert all(got[name] > 0 for name in FIT_ATOL)
    block_j = [line for line in jlines if not line.startswith("Time elapsed")]
    block_t = [line for line in tlines if not line.startswith("Time elapsed")]
    assert [lt.rsplit("=", 1)[0] for lt in block_t] == [lj.rsplit("=", 1)[0]
                                                         for lj in block_j]

    step = tev.make_eval_step(torch_model, tcfg, S, t_im, t_enc)
    out = step(to_torch(batches[0]), None)
    want_step = jev.make_eval_step(model, j_im, j_enc, jcfg, S)(
        variables, j_im_vars, j_enc_vars, batches[0], jax.random.key(0))
    assert out["latents"].shape == (B, K, L)
    close(out["latents"], want_step["latents"], atol=1e-5)
    for name, atol in FIT_ATOL.items():
        close(out[name], want_step[name], atol=atol)


def test_eval_step_needs_both_implicit_modules(weights):
    with pytest.raises(ValueError, match="both"):
        tev.make_eval_step(weights[2], TorchEvalConfig(), S, port_implicit(
            IMPLICIT, jax_implicit(IMPLICIT)[1]), None)


@pytest.mark.parametrize("layout,name", [
    (("model_state_dict", "encoder_state_dict"), "model"),
    (("implicit_net", "pn_encoder"), "im_model"),
])
def test_cli_restores_the_implicit_stack(trained_logdir, tmp_path, capsys, layout, name):
    """The CLI restores the reference's IGR layout (model.pth) and joint
    layout (im_model.pth) at full width and prints a block with non-zero
    fitting lines; with the whole cloud and its axis feature the encoder
    has 7 channels."""
    whole = name == "im_model"
    gen = torch.Generator().manual_seed(3)
    implicit = tev.ImplicitNet(d_in=258)
    implicit.reset_parameters(gen)
    encoder = tev.encoder_for(TorchEvalConfig(use_whole_pc=whole,
                                              use_extrusion_axis_feat=whole))
    encoder.reset_parameters(gen)
    torch.save({layout[0]: implicit.state_dict(), layout[1]: encoder.state_dict()},
               tmp_path / f"{name}.pth")
    flags = ["--use_whole_pc", "--use_extrusion_axis_feat"] if whole else []
    args = [a for a in EVAL_ARGS if a != "--no_implicit"] + flags
    means = tev.cli_main(args + ["--device", "cpu", "--logdir", trained_logdir,
                                 "--im_logdir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == [f"Restored backbone from {trained_logdir}/model",
                       f"Restored implicit stack from {tmp_path}/{name}"]
    block = out[out.index("=" * 20) + 1:]
    assert len(block) == 8 and all(np.isfinite(float(line.rsplit("=", 1)[1]))
                                   for line in block)
    assert means["fit_cyl_loss"] > 0 and means["fit_global_loss"] > 0
    assert float(block[-1].rsplit("=", 1)[1]) == means["fit_global_loss"]


def test_cli_implicit_stack_missing_warns_and_mismatch_raises(trained_logdir, tmp_path,
                                                              capsys):
    args = [a for a in EVAL_ARGS if a != "--no_implicit"]
    args += ["--device", "cpu", "--logdir", trained_logdir, "--im_logdir", str(tmp_path)]
    means = tev.cli_main(args)
    assert capsys.readouterr().out.splitlines()[1] == (
        f"WARNING: no implicit checkpoint at {tmp_path} — fresh init "
        "(fitting metrics not meaningful)")
    assert np.isfinite(means["fit_cyl_loss"])
    # a 4-channel encoder's checkpoint does not load into the 7-channel one
    torch.save({"model_state_dict": tev.ImplicitNet().state_dict(),
                "encoder_state_dict": tev.PointNetEncoder(256, 2, True).state_dict()},
               tmp_path / "model.pth")
    with pytest.raises(RuntimeError, match="size mismatch"):
        tev.cli_main(args + ["--use_whole_pc", "--use_extrusion_axis_feat"])
