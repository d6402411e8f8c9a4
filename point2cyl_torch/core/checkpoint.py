"""Trainer checkpoints with ``torch.save``.

Reference cadence (``train_Point2Cyl_without_sketch.py:395-430``):
``checkpoint_{epoch:04d}`` every N epochs, a rolling ``model`` and a
``best_model`` after epoch 20 when the mean epoch loss improved. Each is
``<logdir>/<name>.pth`` holding the reference's ``{"model": state_dict}``
plus what an exact resume needs: ``optimizer`` (Adam's moments and
count), ``step``, ``epoch`` and ``best_loss``. The backbone weights load
into the reference model as they are.
"""

from __future__ import annotations

import os

import torch


class CheckpointManager:
    def __init__(self, logdir: str):
        self.logdir = os.path.abspath(logdir)
        os.makedirs(self.logdir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.logdir, f"{name}.pth")

    def exists(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

    def save(self, name: str, state: dict) -> None:
        """Write ``state`` atomically (a crash never leaves half a file)."""
        tmp = self.path(name) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(name))

    def load(self, name: str, device: str | torch.device) -> dict:
        return torch.load(self.path(name), map_location=device, weights_only=True)

    def save_epoch(self, epoch: int, state: dict, mean_loss: float,
                   best_loss: float, every: int = 10, best_after: int = 20) -> float:
        """Reference cadence; returns the (possibly updated) best loss.
        ``state`` is the trainer's state without epoch and best loss."""
        if epoch % every == 0:
            if epoch > best_after and mean_loss < best_loss:
                best_loss = mean_loss
                self.save("best_model", {**state, "epoch": epoch, "best_loss": best_loss})
            full = {**state, "epoch": epoch, "best_loss": best_loss}
            self.save(f"checkpoint_{epoch:04d}", full)
            self.save("model", full)
        return best_loss
