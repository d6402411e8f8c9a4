"""The data axis of a multi-process run and the helpers that place work
on it (the port of ``point2cyl_tpu/parallel/mesh.py``).

JAX shards the batch over a 1-D ``data`` mesh axis inside one program and
lets XLA insert the reductions. Here each rank is a process with one
device: a :class:`Mesh` names the process group, this rank's place in it
and its device, :func:`shard_batch` keeps this rank's rows,
:func:`replicate` makes every rank hold rank 0's parameters, buffers and
optimizer state, and :func:`use_global_batch_norm` has each BatchNorm
take its train-mode statistics over the global batch, as JAX's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.distributed as dist

from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.models.layers import BatchNorm
from point2cyl_torch.parallel import collectives
from point2cyl_torch.parallel.distributed import process_batch_slice


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One data axis of ``world`` ranks.

    ``group`` is the process group (``None`` outside one: a single rank
    whose collectives return their input); ``device`` this rank's device;
    ``host_staged`` moves card tensors through host memory for every
    collective (a gloo group on cards).
    """

    group: Any
    rank: int
    world: int
    device: torch.device
    host_staged: bool = False


def make_mesh(
    n_data: int | None = None,
    devices: Sequence[str | torch.device] | None = None,
    *,
    host_staged: bool = False,
) -> Mesh:
    """The data axis over every rank of the process group (one rank
    without one). ``n_data``, where given, must be that rank count: each
    rank is a process, and the count was fixed when they started.
    ``devices`` holds one device a rank (this rank takes its own); by
    default the card the rank was given (``torch.cuda.current_device()``).
    """
    if dist.is_initialized():
        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, world = None, 0, 1
    if n_data is not None and n_data != world:
        raise ValueError(f"a mesh of {n_data} ranks asked of a run of {world}")
    if devices is not None:
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = resolve_device(devices[rank])
    else:
        resolve_device(None)  # raises without a card
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank, world, device, host_staged)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of every array of a global batch, on its device."""
    out = {}
    for key, val in batch.items():
        val = torch.as_tensor(val)
        out[key] = val[process_batch_slice(val.shape[0], mesh.rank, mesh.world)].to(
            mesh.device)
    return out


def replicate(mesh: Mesh, obj: Any) -> Any:
    """Make every rank hold rank 0's values, in place: a module's
    parameters and buffers, or an optimizer's state tensors (the same
    structure on every rank, as after a restore). Returns ``obj``."""
    if isinstance(obj, torch.nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
    elif isinstance(obj, torch.optim.Optimizer):
        tensors = [val for state in obj.state.values() for val in state.values()
                   if isinstance(val, torch.Tensor)]
    else:
        raise TypeError(f"cannot replicate a {type(obj).__name__}")
    for t in tensors:
        collectives.broadcast(t.data, mesh)
    return obj


def use_global_batch_norm(module: torch.nn.Module, mesh: Mesh | None) -> None:
    """Every BatchNorm of ``module`` takes its train-mode statistics over
    ``mesh``'s global batch (``None``: its own rows again)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = mesh
