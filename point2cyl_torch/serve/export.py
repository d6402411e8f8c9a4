"""Serving forward, the GT-free decomposition, and the port's artifact.

An artifact is a zip holding ``meta.json`` (the same keys as the JAX
package's ``.p2cx`` meta, with ``torch_version`` in place of
``jax_version``), ``weights.pt`` (``torch.save`` of the backbone
state_dict under the reference key names) and, where it serves sketch
latents (``with_latents``), ``encoder.pt`` (the sketch encoder's
state_dict). There are no traced programs: the session rebuilds the
models from the meta and serves them eagerly, one call per bucket-shaped
chunk.

    python -m point2cyl_torch.serve.export --logdir runs/joint --out m.p2ct \
        --num_point 8192 --K 8 --im_logdir runs/igr --buckets 1 4 16

The CLI takes the JAX exporter's flags (the reference's store_false
``--pred_*`` quirk included) and ``--device`` (where the checkpoints are
restored; default the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import zipfile
from typing import Sequence

import numpy as np
import torch

from point2cyl_torch.core.checkpoint import restore_backbone, restore_implicit_stack
from point2cyl_torch.core.config import BackboneConfig
from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.eval.metrics import base_barrel_probs, hard_segment_centers
from point2cyl_torch.models.backbone import Backbone
from point2cyl_torch.models.implicit import PointNetEncoder
from point2cyl_torch.ops.geometry import extents_and_sketch_projection
from point2cyl_torch.ops.linalg import estimate_extrusion_axis
from point2cyl_torch.ops.matching import hard_w_encoding
from point2cyl_torch.train.steps import assemble_heads

FORMAT = "p2cx-torch/1"

DECOMP_KEYS = ("axes", "centers", "extents", "scales", "found", "latents")
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
    """The O(K) outputs as ONE (B, K, 20 [+ L]) int16 tensor, the layout of
    the JAX ``pack_decomposition``: each float32 of axes | centers |
    extents | scales | found is reinterpreted as two 16-bit lanes (low
    half first), bit-exact; the latents, where ``out`` has them, follow
    as float16, one lane each. One device-to-host copy fetches it all."""
    geo = torch.cat(
        [
            out["axes"], out["centers"], out["extents"],
            out["scales"][..., None], out["found"].to(torch.float32)[..., None],
        ],
        dim=-1,
    ).contiguous()  # (B, K, 10) float32
    lanes = geo.view(torch.int16)
    if "latents" not in out:
        return lanes
    return torch.cat([lanes, out["latents"].to(torch.float16).view(torch.int16)], dim=-1)


def unpack_decomposition(raw: np.ndarray, with_latents: bool = False) -> dict:
    """Host-side inverse of :func:`pack_decomposition`: the geometry
    bitwise, the latents (``with_latents``) as float32 from their float16
    lanes. ``raw``: (B, K, 20 [+ L]) 16-bit lanes (uint16 or int16)."""
    lanes = np.ascontiguousarray(raw).view(np.uint16)
    geo = np.ascontiguousarray(lanes[..., :_PACK_GEO_LANES]).view(np.float32)
    out = {
        "axes": geo[..., 0:3],
        "centers": geo[..., 3:6],
        "extents": geo[..., 6:8],
        "scales": geo[..., 8],
        "found": geo[..., 9] > 0.5,
    }
    if with_latents:
        lat = np.ascontiguousarray(lanes[..., _PACK_GEO_LANES:])
        out["latents"] = lat.view(np.float16).astype(np.float32)
    return out


def _decomposition(heads, points: torch.Tensor, num_sk_points: int,
                   encoder: PointNetEncoder | None = None) -> dict:
    """GT-free decomposition from assembled heads: per-point labels,
    per-instance axes, centres, extents and sketch scales, and which
    instance slots are real (non-null columns with >= 2 barrel members);
    with ``encoder`` also each instance's sketch latent (B, K, L) from its
    ``[p2d / scale | n2d]`` samples (``eval.py:463-543``). Segment
    sampling is deterministic, so a request always gets the same
    answer."""
    w_hard = hard_w_encoding(heads.w, to_null_mask=True)  # (B, N, K)
    col_valid = w_hard.sum(dim=1) > 0  # (B, K) non-null columns
    w_lab = torch.where(col_valid[:, None, :], heads.w, torch.full_like(heads.w, -1.0))
    labels = torch.argmax(w_lab, dim=-1)  # (B, N)
    bb_labels = torch.argmax(base_barrel_probs(heads.w_2k), dim=-1)
    axes = estimate_extrusion_axis(heads.normals, heads.w_barrel, heads.w_base)
    centers, _ = hard_segment_centers(points, w_hard)
    extents, p2d, n2d, scales, found_p = extents_and_sketch_projection(
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
    if encoder is not None:
        b, k = scales.shape
        enc_in = torch.cat([p2d / scales[..., None, None], n2d], dim=-1)
        out["latents"] = encoder(enc_in.reshape(b * k, num_sk_points, 4)).reshape(b, k, -1)
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
    encoder: PointNetEncoder | None = None,
) -> dict:
    """Model + serving forward on one batch: raw heads, and with ``k`` the
    assembled heads (unit ``normals``, softmaxed ``w`` and, with the bb
    head, ``w_barrel``/``w_base``); with ``num_sk_points`` also the
    decomposition, with ``encoder`` its latents (see
    :func:`_decomposition`)."""
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
            out.update(_decomposition(heads, points, num_sk_points, encoder))
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
    encoder_state_dict: dict[str, torch.Tensor] | None = None,
    encoder_latent: int = 256,
) -> dict:
    """Write a port artifact; returns its meta.

    Pass either ``num_points`` (reference stage geometry) or a full
    ``backbone_config``. With ``num_sk_points`` (needs the seg and bb
    heads) the artifact serves decompositions; with
    ``encoder_state_dict`` (a ``PointNetEncoder(encoder_latent, 2,
    with_normals=True)``'s, which needs the decomposition) also the
    per-instance sketch latents.
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
    latents = encoder_state_dict is not None
    if latents and not decomp:
        raise ValueError("latents ride the decomposition: export with num_sk_points")
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
        "with_latents": latents,
        "latent_size": encoder_latent if latents else None,
        "backbone_config": dataclasses.asdict(backbone_config),
        "buckets": sorted({int(b) for b in buckets}),
        "platforms": ["cuda", "cpu"],
        "torch_version": torch.__version__,
    }
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("weights.pt", _state_bytes(state_dict))
        if latents:
            z.writestr("encoder.pt", _state_bytes(encoder_state_dict))
    return meta


def _state_bytes(state_dict: dict[str, torch.Tensor]) -> bytes:
    buf = io.BytesIO()
    torch.save({key: v.detach().cpu() for key, v in state_dict.items()}, buf)
    return buf.getvalue()


def _state_from(z: zipfile.ZipFile, name: str) -> dict[str, torch.Tensor]:
    return torch.load(io.BytesIO(z.read(name)), map_location="cpu", weights_only=True)


@dataclasses.dataclass
class LoadedArtifact:
    meta: dict
    weights: dict[str, torch.Tensor]  # backbone state_dict, on the CPU
    encoder_weights: dict[str, torch.Tensor] | None = None  # with latents


def load_artifact(path: str) -> LoadedArtifact:
    """Read an artifact. One that claims latents must carry the encoder's
    weights (nothing is served without them)."""
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != FORMAT:
            raise ValueError(f"unknown artifact format {meta.get('format')!r}")
        weights = _state_from(z, "weights.pt")
        encoder = None
        if meta.get("with_latents"):
            if "encoder.pt" not in z.namelist():
                raise ValueError(f"{path} claims sketch latents but holds no encoder.pt")
            encoder = _state_from(z, "encoder.pt")
    return LoadedArtifact(meta=meta, weights=weights, encoder_weights=encoder)


def restore_backbone_from_logdir(
    logdir: str, *, num_points: int, k: int, pred_seg: bool = True,
    pred_normal: bool = True, pred_bb: bool = True,
    device: str | torch.device | None = None,
) -> tuple[dict[str, torch.Tensor], bool]:
    """The backbone state_dict (on the CPU) from a trainer logdir's
    ``model.pth`` or ``pc_model.pth`` (``{"model": state_dict}``), loaded
    into the model on ``device`` with ``strict=True``; without either, a
    fresh init drawn from seed 0. Returns (state_dict, restored)."""
    cfg = BackboneConfig(num_points=num_points, approx_neighbors=False,
                         output_sizes=head_output_sizes(k, pred_seg, pred_normal, pred_bb))
    model = Backbone(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    restored = restore_backbone(logdir, model.to(resolve_device(device))) is not None
    return {key: v.cpu() for key, v in model.state_dict().items()}, restored


def restore_encoder_from_logdir(
    im_logdir: str, *, latent: int = 256, device: str | torch.device | None = None,
) -> tuple[dict[str, torch.Tensor], bool]:
    """The sketch encoder's state_dict (on the CPU) from an IGR or joint
    logdir (``core/checkpoint.py:restore_implicit_stack``: ``model.pth``,
    then ``im_model.pth``, either reference layout), loaded into a
    ``PointNetEncoder(latent, 2, with_normals=True)`` on ``device`` with
    ``strict=True``; without either, the fresh encoder. Returns
    (state_dict, restored)."""
    encoder = PointNetEncoder(latent, 2, with_normals=True).to(resolve_device(device))
    restored = restore_implicit_stack(im_logdir, None, encoder) is not None
    return {key: v.cpu() for key, v in encoder.state_dict().items()}, restored


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export a trained backbone (and sketch encoder) as a port "
        "serving artifact.")
    p.add_argument("--logdir", required=True, type=str)
    p.add_argument("--out", required=True, type=str)
    p.add_argument("--num_point", type=int, default=8192)
    p.add_argument("--K", type=int, default=8)
    # store_false head flags, the reference CLI's quirk
    p.add_argument("--pred_seg", action="store_false")
    p.add_argument("--pred_normal", action="store_false")
    p.add_argument("--pred_bb", action="store_false")
    p.add_argument("--num_sk_point", type=int, default=2048,
                   help="sketch samples per instance of the decomposition")
    p.add_argument("--no_decomp", action="store_true",
                   help="export per-point heads only (no decomposition)")
    p.add_argument("--im_logdir", type=str, default=None,
                   help="IGR/joint logdir to restore the sketch encoder from; "
                   "adds per-instance latents to the decomposition")
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 4, 16, 64])
    p.add_argument("--device", type=str, default=None,
                   help="torch device the checkpoints are restored on "
                   "(default: the card)")
    return p


def cli_main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    state_dict, restored = restore_backbone_from_logdir(
        args.logdir, num_points=args.num_point, k=args.K, pred_seg=args.pred_seg,
        pred_normal=args.pred_normal, pred_bb=args.pred_bb, device=args.device)
    print("Restored backbone" if restored
          else "WARNING: no checkpoint found — exporting fresh init")
    decomp = not args.no_decomp and args.pred_seg and args.pred_bb
    encoder = None
    if decomp and args.im_logdir:
        encoder, enc_restored = restore_encoder_from_logdir(args.im_logdir,
                                                            device=args.device)
        print("Restored sketch encoder" if enc_restored
              else f"WARNING: no encoder checkpoint in {args.im_logdir} "
              "— exporting without latents")
        if not enc_restored:
            encoder = None
    meta = export_artifact(
        args.out, state_dict, num_points=args.num_point, k=args.K,
        pred_seg=args.pred_seg, pred_normal=args.pred_normal, pred_bb=args.pred_bb,
        buckets=args.buckets, num_sk_points=args.num_sk_point if decomp else None,
        encoder_state_dict=encoder)
    print(f"Wrote {args.out} ({os.path.getsize(args.out)} bytes): "
          f"buckets={meta['buckets']} with_latents={meta['with_latents']}")
    return meta


if __name__ == "__main__":
    cli_main()
