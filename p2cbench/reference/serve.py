"""The served decomposition in plain PyTorch, and how a served answer is
judged against it.

A decomposition of a cloud (``eval.py`` of the published code, without
ground truth): per point an instance label (the argmax of the soft
segmentation over the non-null columns) and a base/barrel label, and per
instance slot an axis (the smallest eigenvector of the barrel/base
weighted normals' second moment; its sign is arbitrary), a centre (the
mean of the slot's hard members), extents along the axis and a sketch
scale from the slot's barrel points sampled in point order, whether the
slot was found, and, with the sketch stack, the latent of its sketch.

Labels are decided by an argmax, so two implementations that agree to
rounding can label a near-tied point differently, and every later
quantity moves with such a point. So :func:`judge` judges each served
discrete choice by the reference's own scores, the way a served token is
judged by the gap of its logit below the best, and then recomputes the
rest from the served labels and axes (teacher forcing), so that what is
compared after that differs only by rounding.
"""

from __future__ import annotations

import torch

from p2cbench.reference import nets, ops
from p2cbench.reference.train import heads

NULL_SHARE = 0.005  # a column whose soft mass is below this share of N is null


def soft_outputs(p: dict, cfg: dict, pts: torch.Tensor) -> dict:
    """The eval-mode heads of clouds (B, N, 3)."""
    x_raw, w_raw = nets.backbone(p, cfg, pts, train=False)
    return heads(x_raw, w_raw)


def decompose(p: dict, cfg: dict, pts: torch.Tensor, encoder=None) -> dict:
    """The reference's own decomposition (used in a reference's place, as
    the control): labels, bb_labels, axes, centers, extents, scales,
    found, and with ``encoder`` (its weights) latents."""
    h = soft_outputs(p, cfg, pts)
    w = h["w"]
    n, k = w.shape[1], w.shape[2]
    hard = torch.nn.functional.one_hot(torch.argmax(w, dim=-1), k).to(w.dtype)
    hard = hard * (1.0 - (w.sum(dim=1) < n * NULL_SHARE).to(w.dtype)[:, None, :])
    valid = hard.sum(dim=1) > 0
    labels = torch.argmax(torch.where(valid[:, None, :], w, torch.full_like(w, -1.0)), dim=-1)
    bb = torch.argmax(_bb_probs(h), dim=-1)
    axes = ops.extrusion_axes(h["normals"], h["w_barrel"], h["w_base"])
    return _rest(cfg, pts, h, labels, bb, axes, hard, encoder)


def _bb_probs(h: dict) -> torch.Tensor:
    return torch.stack([h["w_2k"][:, :, ::2].sum(-1), h["w_2k"][:, :, 1::2].sum(-1)], -1)


def _rest(cfg, pts, h, labels, bb, axes, hard, encoder) -> dict:
    """Centres, extents, scales, found and latents from the labels, the
    axes and the hard membership."""
    member = (hard == 1.0).to(pts.dtype)
    count = member.sum(dim=1)
    centers = torch.einsum("bnk,bnc->bkc", member, pts) / torch.clamp(count, min=1.0)[..., None]
    centers = centers * (count > 1)[..., None]
    k = axes.shape[1]
    rows, found_rows = ops.barrel_rows(torch.cat([pts, h["normals"]], dim=-1), labels, bb, k,
                                       cfg["num_sk_point"])
    spts, snrm = rows[..., :3], rows[..., 3:]
    centered = spts * found_rows[..., None, None].to(spts.dtype) - centers[:, :, None, :]
    dist = torch.einsum("bksj,bkj->bks", centered, axes)
    extents = torch.stack([dist.amin(dim=-1), dist.amax(dim=-1)], dim=-1)
    p2d, n2d, scales = ops.project_to_sketch(spts, snrm, found_rows, axes, centers)
    out = {"labels": labels, "bb_labels": bb, "axes": axes, "centers": centers,
           "extents": extents, "scales": scales, "found": (hard.sum(dim=1) > 0) & found_rows}
    if encoder is not None:
        b = scales.shape[0]
        enc_in = torch.cat([p2d / scales[..., None, None], n2d], dim=-1)
        out["latents"] = nets.encoder(encoder, enc_in.reshape(b * k, -1, 4)).reshape(b, k, -1)
    return out


def judge(p: dict, cfg: dict, pts: torch.Tensor, served: dict, encoder=None) -> dict:
    """The numbers that judge a served decomposition of ``pts`` (B, N, 3):

    - ``label_gap``: the largest gap, over the points, by which the served
      label's score (the soft segmentation over the non-null columns, -1
      for a null one) lies below the reference's best;
    - ``bb_gap``: the same for the base/barrel labels' probabilities;
    - ``axis_gap``: the largest excess of the served axis's Rayleigh
      quotient over the reference matrix's smallest eigenvalue, as a share
      of its eigenvalue spread, over the slots found on both sides (a slot
      of a null column has a matrix near zero, whose closed-form axis is
      rounding);
    - from the served labels and axes: ``center_err``, ``extent_err`` (the
      largest absolute errors), ``scale_err`` (the largest relative one),
      ``found_diff`` (slots found on one side only), and with ``encoder``
      ``latent_err`` (the largest absolute error of a found slot's latent).
    """
    h = soft_outputs(p, cfg, pts)
    w = h["w"]
    n, k = w.shape[1], w.shape[2]
    best = torch.argmax(w, dim=-1)
    nonnull = w.sum(dim=1) >= n * NULL_SHARE
    hard_ref = torch.nn.functional.one_hot(best, k).to(w.dtype) * nonnull[:, None, :].to(w.dtype)
    valid = hard_ref.sum(dim=1) > 0
    score = torch.where(valid[:, None, :], w, torch.full_like(w, -1.0))
    labels = served["labels"].long()
    label_gap = score.amax(dim=-1) - torch.gather(score, -1, labels[..., None])[..., 0]
    bb_p = _bb_probs(h)
    bb = served["bb_labels"].long()
    bb_gap = bb_p.amax(dim=-1) - torch.gather(bb_p, -1, bb[..., None])[..., 0]
    m = ops.axis_matrices(h["normals"], h["w_barrel"], h["w_base"])
    m = 0.5 * (m + m.transpose(-1, -2))
    lam = torch.linalg.eigvalsh(m.double())
    a = served["axes"].double()
    rayleigh = torch.einsum("bki,bkij,bkj->bk", a, m.double(), a) / (a * a).sum(-1)
    spread = (lam[..., 2] - lam[..., 0]).clamp(min=1e-30)
    axis_gap = (rayleigh - lam[..., 0]) / spread
    # teacher forcing: the served labels wherever the reference's best
    # column is not null (a null best leaves the point out, as served)
    keep = torch.gather(nonnull, 1, best).to(w.dtype)
    hard = torch.nn.functional.one_hot(labels, k).to(w.dtype) * keep[..., None]
    ref = _rest(cfg, pts, h, labels, bb, served["axes"], hard, encoder)
    out = {
        "label_gap": float(label_gap.max()),
        "bb_gap": float(bb_gap.max()),
        "axis_gap": float(torch.where(served["found"] & ref["found"], axis_gap,
                                      torch.zeros_like(axis_gap)).max()),
        "center_err": float((served["centers"] - ref["centers"]).abs().max()),
        "extent_err": float((served["extents"] - ref["extents"]).abs().max()),
        "scale_err": float(((served["scales"] - ref["scales"]).abs()
                            / ref["scales"].abs().clamp(min=1e-12)).max()),
        "found_diff": float((served["found"] != ref["found"]).sum()),
    }
    if encoder is not None:
        both = (served["found"] & ref["found"])[..., None]
        err = torch.where(both, (served["latents"] - ref["latents"]).abs(),
                          torch.zeros_like(ref["latents"]))
        out["latent_err"] = float(err.max())
    return out
