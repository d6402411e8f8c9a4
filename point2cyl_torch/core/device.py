"""Device resolution: the card by default, the CPU only on request."""

from __future__ import annotations

import torch

# Full float32 everywhere: the reference runs float32 products and the
# ball-query / 3-NN selections are compared bit for bit. A float32 matmul
# on the card is already full precision by default, but a float32
# convolution goes through cuDNN in TF32 unless told otherwise; set both.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card (``cuda``); raises when there is none.

    The CPU is used only when the caller names it (``device="cpu"``), as
    the tests do. Nothing falls back from the card to the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
