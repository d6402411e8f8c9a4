"""Hard segment encodings (the serving part of the JAX
``ops/matching.py``; the Hungarian matching comes with training)."""

from __future__ import annotations

import torch


def hard_w_encoding(
    w: torch.Tensor, to_null_mask: bool = False, null_threshold: float = 0.005
) -> torch.Tensor:
    """One-hot of the argmax of a soft segmentation (B, N, K).

    With ``to_null_mask``, columns whose soft mass is below
    ``null_threshold * N`` are zeroed entirely (null segments).
    """
    n, k = w.shape[1], w.shape[2]
    hard = torch.nn.functional.one_hot(torch.argmax(w, dim=-1), k).to(w.dtype)
    if to_null_mask:
        null = (w.sum(dim=1) < n * null_threshold).to(w.dtype)  # (B, K)
        hard = hard * (1.0 - null[:, None, :])
    return hard
