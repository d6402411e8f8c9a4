"""The training steps of Point2Cyl in plain PyTorch: Trainer A's proxy
losses (``train_Point2Cyl_without_sketch.py``) and the joint step's
sketch, IGR and latent losses (``train_Point2Cyl.py``), each followed by
optax's Adam.

:func:`run_steps` follows a trainer from its first weights through a few
steps on the batches it was fed and the generator state it started from,
and returns each step's loss, the first step's gradients and the
parameters after the last step. The draws come in the order the published
step makes them: SA1's and SA2's FPS starts, the dropout mask, the
predicted and the GT sketches' segment samples, then the off-surface
samples.
"""

from __future__ import annotations

import torch

from p2cbench.reference import nets, ops

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
IM_LR = 1e-3


def heads(x_raw: torch.Tensor, w_raw: torch.Tensor) -> dict:
    """Unit normals and the 2K-way softmax split into barrel (even) and
    base (odd) columns."""
    norms = torch.linalg.vector_norm(x_raw, dim=-1, keepdim=True)
    w_2k = torch.softmax(w_raw, dim=-1)
    w_barrel, w_base = w_2k[:, :, ::2], w_2k[:, :, 1::2]
    return {"normals": x_raw / torch.clamp(norms, min=1e-12), "w": w_barrel + w_base,
            "w_barrel": w_barrel, "w_base": w_base, "w_barrel_raw": w_raw[:, :, ::2],
            "w_base_raw": w_raw[:, :, 1::2], "w_2k": w_2k}


def proxy_losses(h: dict, batch: dict, weights: dict):
    """The weighted sum of the mIoU, normal, base/barrel, axis and centre
    losses, the matching and its mask."""
    w = h["w"]
    i_gt = batch["extrusion_labels"]
    k = w.shape[-1]
    mask_gt = ops.mask_gt_from_labels(i_gt, k)
    matching, mask = ops.hungarian_matching(w, i_gt)
    normal = (1.0 - torch.abs((h["normals"] * batch["normals"]).sum(-1))).mean(-1).mean()
    w_re = ops.reorder_w(w, matching)
    w_gt = ops.one_hot_labels(i_gt, k, w.dtype)
    dot = (w_gt * w_re).sum(dim=1)
    miou = 1.0 - dot / (w_gt.sum(dim=1) + w_re.sum(dim=1) - dot + 1e-10)
    miou = ops.reduce_mean_masked_instance(miou, mask_gt).mean()
    total = weights["seg"] * miou + weights["normal"] * normal
    # base/barrel CE weighted by the matched, masked, renormalised W
    w_masked = torch.where(mask[:, None, :], w_re, torch.zeros_like(w_re))
    w_soft = torch.softmax(w_masked, dim=-1)
    logp = torch.log_softmax(torch.stack([h["w_barrel_raw"], h["w_base_raw"]], dim=-1),
                             dim=-1)
    gt = batch["base_barrel_labels"][:, :, None]
    ce = -torch.where(gt == 0, logp[..., 0], logp[..., 1])
    bb = (ce * w_soft).sum(dim=-1).mean()
    total = total + weights["base_barrel"] * bb
    axes = ops.extrusion_axes(h["normals"], ops.reorder_w(h["w_barrel"], matching),
                              ops.reorder_w(h["w_base"], matching))
    ax = 1.0 - torch.abs((axes * batch["extrusion_axes"]).sum(-1))
    total = total + weights["extrusion_axis"] * ops.reduce_mean_masked_instance(
        ax, mask_gt).mean()
    centers = torch.einsum("bnk,bnc->bkc", w_re, batch["point_cloud"]) / w.shape[1]
    diff = ((centers - batch["extrusion_centers"]) ** 2).sum(dim=-1)
    total = total + weights["center"] * ops.reduce_mean_masked_instance(diff, mask_gt).mean()
    return total, matching, mask


def sketch_projection(generator, pts, normals, labels, bb_labels, axes, centers, samples):
    """The barrel points of each segment, sampled by the generator, on
    their sketch planes: p2d, n2d (B, K, S, 2) and scales (B, K)."""
    k = axes.shape[1]
    rows, found = ops.barrel_rows(torch.cat([pts, normals], dim=-1), labels, bb_labels, k,
                                  samples, generator)
    return ops.project_to_sketch(rows[..., :3], rows[..., 3:], found, axes, centers)


def igr_losses(p_dec: dict, cfg: dict, generator, sk: torch.Tensor, latents, mask_gt):
    """Manifold + 0.1 eikonal + SALD normal loss of the GT sketches under
    ``latents``, through the decoder; its gradient in the 2D points comes
    from one create-graph backward over the on-sketch and off-surface
    points together."""
    b, k, s, _ = sk.shape
    m = b * k
    pts = sk[..., :2].reshape(m, s, 2)
    normals = sk[..., 2:].reshape(m, s, 2)
    lat = latents.reshape(m, -1)
    local = pts + 0.01 * torch.randn(tuple(pts.shape), generator=generator,
                                     dtype=pts.dtype, device=pts.device)
    glob = torch.rand((m, s // 8, 2), generator=generator, dtype=pts.dtype, device=pts.device)
    off = torch.cat([local, (2.0 * glob - 1.0) * 1.8], dim=1)
    x = torch.cat([pts, off], dim=1).requires_grad_()
    inp = torch.cat([lat[:, None, :].expand(-1, x.shape[1], -1), x], dim=-1)
    sdf = nets.decoder(p_dec, inp, len(cfg["decoder_hidden"]) + 1, cfg["decoder_skip_in"])
    (grad,) = torch.autograd.grad(sdf.sum(), x, create_graph=True)
    mnfld = sdf[:, :s, 0].abs().mean(dim=-1)
    eik = ((torch.linalg.vector_norm(grad[:, s:], dim=-1) - 1.0) ** 2).mean(dim=-1)
    g = grad[:, :s]
    sald = torch.minimum(torch.linalg.vector_norm(g - normals, dim=-1),
                         torch.linalg.vector_norm(g + normals, dim=-1)).mean(dim=-1)
    mean = [ops.reduce_mean_masked_instance(t.reshape(b, k), mask_gt).mean()
            for t in (mnfld, eik, sald)]
    return mean[0] + cfg["igr_eikonal"] * mean[1] + cfg["igr_normal"] * mean[2]


def joint_loss(nets_p: dict, cfg: dict, batch: dict, generator) -> torch.Tensor:
    """The joint step's loss: the proxy losses, the latents of the predicted
    sketches (projected onto the GT axes and centres, scaled by the GT
    projection's scale) through the trained encoder, the IGR losses of the
    GT sketches under them, and 1 - cos against a frozen encoder's latents
    of the GT sketches."""
    pts = batch["point_cloud"]
    i_gt, gt_bb = batch["extrusion_labels"], batch["base_barrel_labels"]
    axes, centers = batch["extrusion_axes"], batch["extrusion_centers"]
    b, k = axes.shape[:2]
    mask_gt = ops.mask_gt_from_labels(i_gt, k)
    sk = batch["sketches"]
    samples = cfg["num_sk_point"]
    with torch.no_grad():
        gt_latents = nets.encoder(nets_p["loaded_encoder"],
                                  sk.reshape(b * k, sk.shape[2], 4)).reshape(b, k, -1)
    x_raw, w_raw = nets.backbone(nets_p["backbone"], cfg, pts, train=True, generator=generator)
    h = heads(x_raw, w_raw)
    proxy, matching, mask = proxy_losses(h, batch, cfg["loss_weights"])
    w_re = ops.reorder_w(h["w"], matching)
    w_re = torch.where(mask[:, None, :], w_re, torch.zeros_like(w_re))
    proj_label = w_re.argmax(dim=-1)
    bb_probs = torch.stack([h["w_2k"][:, :, ::2].sum(-1), h["w_2k"][:, :, 1::2].sum(-1)], -1)
    proj_bb = bb_probs.argmax(dim=-1)
    p2d, n2d, _ = sketch_projection(generator, pts, h["normals"], proj_label, proj_bb, axes,
                                    centers, samples)
    _, _, gt_scales = sketch_projection(generator, pts, batch["normals"], i_gt, gt_bb, axes,
                                        centers, samples)
    p2d = p2d / gt_scales[..., None, None]
    enc_in = torch.cat([p2d, n2d], dim=-1).reshape(b * k, samples, 4)
    latents = nets.encoder(nets_p["encoder"], enc_in, train=True).reshape(b, k, -1)
    im_total = igr_losses(nets_p["decoder"], cfg, generator, sk, latents, mask_gt)
    lat = ops.reduce_mean_masked_instance(1.0 - (latents * gt_latents).sum(-1), mask_gt).mean()
    return proxy + (im_total + cfg["loss_weights"]["sketch_latent"] * lat)


def staircase_lr(step: int, cfg: dict) -> float:
    return cfg["learning_rate"] * cfg["decay_rate"] ** (step * cfg["batch"] // cfg["decay_step"])


@torch.no_grad()
def adam(params: dict, grads: dict, state: dict, lr: float) -> None:
    """optax's Adam in place: b1 0.9, b2 0.999, eps 1e-8 outside the root,
    bias-corrected by the update count in ``state``."""
    state["count"] += 1
    c = state["count"]
    for name, g in grads.items():
        m = state.setdefault("m", {}).get(name, torch.zeros_like(g))
        v = state.setdefault("v", {}).get(name, torch.zeros_like(g))
        m = (1.0 - ADAM_B1) * g + ADAM_B1 * m
        v = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v
        state["m"][name], state["v"][name] = m, v
        m_hat = m / (1.0 - ADAM_B1 ** c)
        v_hat = v / (1.0 - ADAM_B2 ** c)
        params[name] -= lr * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS))


def run_steps(cfg: dict, weights: dict, batches: list, gen_state: torch.Tensor, device):
    """Follow the trainer of ``cfg`` from ``weights`` (net -> name ->
    tensor, copied here) over ``batches``, drawing from a generator on
    ``device`` set to ``gen_state``. Returns (losses [float], first-step
    gradients {net.name: tensor}, final trained parameters {net.name:
    tensor})."""
    generator = torch.Generator(device=device)
    generator.set_state(gen_state)
    p = {net: {n: t.detach().clone() for n, t in w.items()} for net, w in weights.items()}
    trained = {"backbone": p["backbone"]}
    if cfg["sketch_stack"]:
        trained["encoder"] = p["encoder"]
    leaves = {f"{net}.{n}": t for net, w in trained.items() for n, t in w.items()
              if t.is_floating_point() and not n.endswith(("running_mean", "running_var"))}
    states = {net: {"count": 0} for net in trained}
    losses, first = [], None
    for step, batch in enumerate(batches):
        for t in leaves.values():
            t.requires_grad_(True)
            t.grad = None
        if cfg["sketch_stack"]:
            loss = joint_loss(p, cfg, batch, generator)
        else:
            x_raw, w_raw = nets.backbone(p["backbone"], cfg, batch["point_cloud"], train=True,
                                         generator=generator)
            loss = proxy_losses(heads(x_raw, w_raw), batch, cfg["loss_weights"])[0]
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        grads = dict(zip(names, grads))
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        for t in leaves.values():
            t.requires_grad_(False)
        for net in trained:
            lr = staircase_lr(step, cfg) if net == "backbone" else IM_LR
            sub = {n.split(".", 1)[1]: g for n, g in grads.items() if n.startswith(net + ".")}
            adam(p[net], sub, states[net], lr)
    final = {n: t.detach() for n, t in leaves.items()}
    return losses, first, final
