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

In a data-parallel run (a ``parallel.mesh.Mesh``) rank 0 alone writes,
and every rank reads rank 0's view: :meth:`CheckpointManager.exists_global`
and :meth:`CheckpointManager.load` broadcast it, so no rank enters a
restore alone (JAX ``core/checkpoint.py:46-60, 92-105``).
"""

from __future__ import annotations

import io
import os

import torch

from point2cyl_torch.parallel.collectives import broadcast_object


class CheckpointManager:
    def __init__(self, logdir: str, mesh=None):
        self.logdir = os.path.abspath(logdir)
        self.mesh = mesh
        self.primary = mesh is None or mesh.rank == 0
        os.makedirs(self.logdir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.logdir, f"{name}.pth")

    def exists(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

    def exists_global(self, name: str) -> bool:
        """Rank 0's :meth:`exists`, on every rank."""
        if self.mesh is None:
            return self.exists(name)
        return broadcast_object(self.exists(name) if self.primary else None, self.mesh)

    def save(self, name: str, state: dict) -> None:
        """Write ``state`` atomically (a crash never leaves half a file);
        only rank 0 writes."""
        if not self.primary:
            return
        tmp = self.path(name) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(name))

    def load(self, name: str, device: str | torch.device) -> dict:
        """``<name>.pth`` on ``device``; in a data-parallel run rank 0's
        file, broadcast (call it on every rank)."""
        if self.mesh is None:
            return torch.load(self.path(name), map_location=device, weights_only=True)
        data = None
        if self.primary:
            with open(self.path(name), "rb") as f:
                data = f.read()
        data = broadcast_object(data, self.mesh)
        return torch.load(io.BytesIO(data), map_location=device, weights_only=True)

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


def restore_backbone(logdir: str, model: torch.nn.Module,
                     names: tuple[str, ...] = ("model", "pc_model")) -> str | None:
    """Load ``model`` from the first ``<logdir>/<name>.pth`` of ``names``
    (``{"model": state_dict}``) with ``strict=True``. Returns the name, or
    None where there is none (the model keeps its weights)."""
    found = _first_checkpoint(logdir, names)
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
    if not _load_implicit(state, implicit, encoder):
        raise KeyError(f"{im_logdir}/{name}.pth holds neither implicit layout "
                       f"{IMPLICIT_LAYOUTS}: keys {sorted(state)}")
    return name


def _load_implicit(state: dict, implicit: torch.nn.Module | None,
                   encoder: torch.nn.Module | None) -> bool:
    """Load the decoder and the encoder, each where given, from ``state``
    in either layout (``strict=True``); False where it holds neither."""
    for dec_key, enc_key in IMPLICIT_LAYOUTS:
        if dec_key in state and enc_key in state:
            for module, key in ((implicit, dec_key), (encoder, enc_key)):
                if module is not None:
                    module.load_state_dict(state[key], strict=True)
            return True
    return False


def restore_implicit_stack_from(sources: list[tuple[str, str]],
                                implicit: torch.nn.Module | None,
                                encoder: torch.nn.Module | None) -> str | None:
    """Load the decoder and the encoder from the first ``(logdir, name)``
    of ``sources`` whose ``<logdir>/<name>.pth`` holds an implicit layout
    (a file in neither, such as Trainer A's ``model.pth``, is passed
    over; mismatched keys or shapes raise). Returns that logdir, or None
    where no source has one."""
    for logdir, name in sources:
        found = _first_checkpoint(logdir, (name,))
        if found is not None and _load_implicit(found[1], implicit, encoder):
            return logdir
    return None
