"""Head assembly shared by serving, evaluation and (later) training."""

from __future__ import annotations

from typing import NamedTuple

import torch


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
