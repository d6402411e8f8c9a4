"""Serving forward, the GT-free decomposition, and the port's artifact.

An artifact is a zip holding ``meta.json`` (the same keys as the JAX
package's ``.p2cx`` meta, with ``torch_version`` in place of
``jax_version``) and ``weights.pt`` (``torch.save`` of the backbone
state_dict under the reference key names). There are no traced programs:
the session rebuilds the model from the meta and serves it eagerly, one
call per bucket-shaped chunk.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Sequence

import numpy as np
import torch

from point2cyl_torch.core.config import BackboneConfig
from point2cyl_torch.eval.metrics import base_barrel_probs, hard_segment_centers
from point2cyl_torch.ops.geometry import extents_and_sketch_projection
from point2cyl_torch.ops.linalg import estimate_extrusion_axis
from point2cyl_torch.ops.matching import hard_w_encoding
from point2cyl_torch.train.steps import assemble_heads

FORMAT = "p2cx-torch/1"

DECOMP_KEYS = ("axes", "centers", "extents", "scales", "found")
DECOMP_POINT_KEYS = ("labels", "bb_labels")

# geometry lanes of the packed tensor: axes(3) + centers(3) + extents(2)
# + scales(1) + found(1), fp32 -> 20 16-bit lanes
_PACK_GEO_LANES = 20


def head_output_sizes(
    k: int, pred_seg: bool, pred_normal: bool, pred_bb: bool
) -> tuple[int, int]:
    """Head widths, as the trainers wire them."""
    first = 3 if pred_normal else 1
    if pred_seg and pred_bb:
        second = 2 * k
    elif pred_seg:
        second = k
    else:
        second = 1
    return first, second


def pack_decomposition(out: dict) -> torch.Tensor:
    """The O(K) geometry as ONE (B, K, 20) int16 tensor: each float32 of
    axes | centers | extents | scales | found is reinterpreted as two
    16-bit lanes (low half first), the layout of the JAX
    ``pack_decomposition``. One device-to-host copy fetches it all."""
    geo = torch.cat(
        [
            out["axes"], out["centers"], out["extents"],
            out["scales"][..., None], out["found"].to(torch.float32)[..., None],
        ],
        dim=-1,
    ).contiguous()  # (B, K, 10) float32
    return geo.view(torch.int16)


def unpack_decomposition(raw: np.ndarray) -> dict:
    """Host-side inverse of :func:`pack_decomposition`, bitwise.
    ``raw``: (B, K, 20) 16-bit lanes (uint16 or int16)."""
    geo = np.ascontiguousarray(raw[..., :_PACK_GEO_LANES]).view(np.uint16).view(np.float32)
    return {
        "axes": geo[..., 0:3],
        "centers": geo[..., 3:6],
        "extents": geo[..., 6:8],
        "scales": geo[..., 8],
        "found": geo[..., 9] > 0.5,
    }


def _decomposition(heads, points: torch.Tensor, num_sk_points: int) -> dict:
    """GT-free decomposition from assembled heads: per-point labels,
    per-instance axes, centres, extents and sketch scales, and which
    instance slots are real (non-null columns with >= 2 barrel members).
    Segment sampling is deterministic, so a request always gets the same
    answer."""
    w_hard = hard_w_encoding(heads.w, to_null_mask=True)  # (B, N, K)
    col_valid = w_hard.sum(dim=1) > 0  # (B, K) non-null columns
    w_lab = torch.where(col_valid[:, None, :], heads.w, torch.full_like(heads.w, -1.0))
    labels = torch.argmax(w_lab, dim=-1)  # (B, N)
    bb_labels = torch.argmax(base_barrel_probs(heads.w_2k), dim=-1)
    axes = estimate_extrusion_axis(heads.normals, heads.w_barrel, heads.w_base)
    centers, _ = hard_segment_centers(points, w_hard)
    extents, _, _, scales, found_p = extents_and_sketch_projection(
        points, heads.normals, labels, bb_labels, axes, centers,
        num_samples=num_sk_points,
    )
    out = {
        "axes": axes,
        "centers": centers,
        "extents": extents,
        "scales": scales,
        "found": col_valid & found_p,
        "labels": labels.to(torch.int8),
        "bb_labels": bb_labels.to(torch.int8),
    }
    out["packed"] = pack_decomposition(out)
    return out


def _backbone_forward(
    model,
    points: torch.Tensor,
    *,
    k: int | None = None,
    pred_seg: bool = True,
    pred_bb: bool = True,
    num_sk_points: int | None = None,
) -> dict:
    """Model + serving forward on one batch: raw heads, and with ``k`` the
    assembled heads (unit ``normals``, softmaxed ``w`` and, with the bb
    head, ``w_barrel``/``w_base``); with ``num_sk_points`` also the
    decomposition (see :func:`_decomposition`)."""
    if num_sk_points is not None and not (pred_seg and pred_bb and k):
        raise ValueError("decomposition needs seg+bb heads and k")
    x_raw, w_raw = model(points)
    out = {"x_raw": x_raw, "w_raw": w_raw}
    if k is not None:
        heads = assemble_heads(x_raw, w_raw, pred_seg, pred_bb, k=k)
        out["normals"] = heads.normals
        out["w"] = heads.w
        if pred_seg and pred_bb:
            out["w_barrel"] = heads.w_barrel
            out["w_base"] = heads.w_base
        if num_sk_points is not None:
            out.update(_decomposition(heads, points, num_sk_points))
    return out


def export_artifact(
    out_path: str,
    state_dict: dict[str, torch.Tensor],
    *,
    k: int,
    num_points: int | None = None,
    backbone_config: BackboneConfig | None = None,
    pred_seg: bool = True,
    pred_normal: bool = True,
    pred_bb: bool = True,
    buckets: Sequence[int] = (1, 4, 16, 64),
    num_sk_points: int | None = None,
) -> dict:
    """Write a port artifact; returns its meta.

    Pass either ``num_points`` (reference stage geometry) or a full
    ``backbone_config``. With ``num_sk_points`` (needs the seg and bb
    heads) the artifact serves decompositions.
    """
    if backbone_config is None:
        if num_points is None:
            raise ValueError("need num_points or backbone_config")
        backbone_config = BackboneConfig(
            num_points=num_points,
            output_sizes=head_output_sizes(k, pred_seg, pred_normal, pred_bb),
        )
    decomp = num_sk_points is not None
    if decomp and not (pred_seg and pred_bb):
        raise ValueError("decomposition export needs seg+bb heads")
    meta = {
        "format": FORMAT,
        "num_points": backbone_config.num_points,
        "k": k,
        "pred_seg": pred_seg,
        "pred_normal": pred_normal,
        "pred_bb": pred_bb,
        "output_sizes": list(backbone_config.output_sizes),
        "assembled": True,
        "decomposition": decomp,
        "packed": decomp,
        "num_sk_points": num_sk_points,
        "with_latents": False,
        "latent_size": None,
        "backbone_config": dataclasses.asdict(backbone_config),
        "buckets": sorted({int(b) for b in buckets}),
        "platforms": ["cuda", "cpu"],
        "torch_version": torch.__version__,
    }
    weights = io.BytesIO()
    torch.save({key: v.detach().cpu() for key, v in state_dict.items()}, weights)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("weights.pt", weights.getvalue())
    return meta


@dataclasses.dataclass
class LoadedArtifact:
    meta: dict
    weights: dict[str, torch.Tensor]  # backbone state_dict, on the CPU


def load_artifact(path: str) -> LoadedArtifact:
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != FORMAT:
            raise ValueError(f"unknown artifact format {meta.get('format')!r}")
        weights = torch.load(io.BytesIO(z.read("weights.pt")), map_location="cpu",
                             weights_only=True)
    return LoadedArtifact(meta=meta, weights=weights)
