"""Chamfer nearest-neighbour distances, plain PyTorch (the port of the JAX
``ops/chamfer.py``, which replaces the reference's ``chamferdist`` CUDA
extension, ``losses.py:14-15``).

The JAX package has no kernel here (XLA computes it), so plain PyTorch is
the port. Distances use the expansion ``|a|^2 + |b|^2 - 2 a.b`` of the
JAX ``square_distance`` (``ops/grouping.py:17``), so both sides agree to
float noise.
"""

from __future__ import annotations

import torch


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, D) x (B, M, D) -> (B, N, M) squared distances by expansion."""
    cross = torch.einsum("bnc,bmc->bnm", a, b)
    return (a * a).sum(-1)[:, :, None] + (b * b).sum(-1)[:, None, :] - 2.0 * cross


def chamfer_distances(a: torch.Tensor, b: torch.Tensor,
                      block_size: int | None = None) -> torch.Tensor:
    """Squared distance from each point of ``a`` (B, N, D) to its nearest
    neighbour in ``b`` (B, M, D), (B, N): the forward direction of
    chamferdist.

    With ``block_size`` (which must divide M), blocks of ``b`` stream
    through a running minimum and (N, M) is never materialised.
    """
    m = b.shape[1]
    if block_size is None or m <= block_size:
        return square_distance(a, b).amin(dim=-1)
    if m % block_size:
        raise ValueError(f"block_size {block_size} must divide M={m}")
    running = torch.full(a.shape[:2], float("inf"), dtype=a.dtype, device=a.device)
    for start in range(0, m, block_size):
        blk = b[:, start:start + block_size]
        running = torch.minimum(running, square_distance(a, blk).amin(dim=-1))
    return running


def chamfer_loss(a: torch.Tensor, b: torch.Tensor,
                 bidirectional: bool = True) -> torch.Tensor:
    """Mean chamfer loss per batch element, (B,)."""
    fwd = chamfer_distances(a, b).mean(dim=-1)
    if not bidirectional:
        return fwd
    return fwd + chamfer_distances(b, a).mean(dim=-1)
