"""Trainer checkpoints with ``torch.save``.

Reference cadence (``train_Point2Cyl_without_sketch.py:395-430``):
``checkpoint_{epoch:04d}`` every N epochs, a rolling ``model`` and a
``best_model`` after epoch 20 when the mean epoch loss improved. Each is
``<logdir>/<name>.pth`` holding the reference's ``{"model": state_dict}``
plus what an exact resume needs: ``optimizer`` (Adam's moments and
count), ``step``, ``epoch`` and ``best_loss``. The backbone weights load
into the reference model as they are.

The implicit stack (decoder and sketch encoder) is read from
``<im_logdir>/model.pth``, then ``im_model.pth`` (or a named file), in
either of the reference's layouts (``torch_compat.py:3-7``): the IGR
pretrainer's ``{"model_state_dict", "encoder_state_dict"}``
(``eval.py:206-210``) or the joint trainer's ``{"implicit_net",
"pn_encoder"}`` (``train_Point2Cyl.py:753-777``).
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


IMPLICIT_NAMES = ("model", "im_model")
IMPLICIT_LAYOUTS = (("model_state_dict", "encoder_state_dict"),
                    ("implicit_net", "pn_encoder"))


def _first_checkpoint(logdir: str, names: tuple[str, ...]) -> tuple[str, dict] | None:
    """The name and contents (on the CPU) of the first ``<name>.pth`` in
    ``logdir``, or None where there is none."""
    for name in names:
        path = os.path.join(logdir, f"{name}.pth")
        if os.path.isfile(path):
            return name, torch.load(path, map_location="cpu", weights_only=True)
    return None


def restore_backbone(logdir: str, model: torch.nn.Module) -> str | None:
    """Load ``model`` from ``<logdir>/model.pth``, else ``pc_model.pth``
    (``{"model": state_dict}``) with ``strict=True``. Returns the name, or
    None where there is neither (the model keeps its weights)."""
    found = _first_checkpoint(logdir, ("model", "pc_model"))
    if found is None:
        return None
    model.load_state_dict(found[1]["model"], strict=True)
    return found[0]


def restore_implicit_stack(im_logdir: str, implicit: torch.nn.Module | None,
                           encoder: torch.nn.Module | None,
                           name: str | None = None) -> str | None:
    """Load the decoder and the encoder, each where given, from
    ``<name>.pth`` in ``im_logdir``, or without a name from the first of
    ``model.pth`` and ``im_model.pth``, with ``strict=True``: mismatched
    keys or shapes, or a file in neither layout, raise. Returns the name,
    or None where there is no such file (the modules keep their
    weights)."""
    found = _first_checkpoint(im_logdir, IMPLICIT_NAMES if name is None else (name,))
    if found is None:
        return None
    name, state = found
    for dec_key, enc_key in IMPLICIT_LAYOUTS:
        if dec_key in state and enc_key in state:
            for module, key in ((implicit, dec_key), (encoder, enc_key)):
                if module is not None:
                    module.load_state_dict(state[key], strict=True)
            return name
    raise KeyError(f"{im_logdir}/{name}.pth holds neither implicit layout "
                   f"{IMPLICIT_LAYOUTS}: keys {sorted(state)}")
