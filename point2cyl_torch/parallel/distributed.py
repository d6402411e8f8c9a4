"""Joining a multi-process run, and the rows and draws of each rank (the
port of ``point2cyl_tpu/parallel/distributed.py``).

One process a rank and one device a rank, as PyTorch runs data
parallelism: :func:`initialize` joins the ranks through
``torch.distributed`` (NCCL between cards, gloo on the CPU), every rank
derives the same epoch order from the shared seed and assembles only its
rows of each global batch (:func:`process_batch_slice`).

A JAX data-parallel step is one program over the global batch, so every
random draw in it (FPS starts, the dropout mask, noise, segment samples,
off-surface samples) covers the global batch. :class:`RowDraws` gives a
rank the same: each draw whose leading axis is the batch is made at the
global batch's size from the shared generator and cut to the rank's
rows, so a two-rank step draws what the one-process step draws.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the multi-process run (idempotent; a no-op at one process,
    as JAX's is). ``coordinator_address`` is ``host:port`` (TCP) or a URL
    that ``init_process_group`` takes (``tcp://...``, ``file://...``)."""
    if num_processes == 1 or dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --coordinator_address, "
                         "--num_processes and --process_id")
    url = coordinator_address if "://" in coordinator_address else (
        f"tcp://{coordinator_address}")
    join(url, num_processes, process_id, backend)


def join(url: str, world: int, rank: int, backend: str | None = None) -> None:
    """``init_process_group`` for rank ``rank`` of ``world`` meeting at
    ``url``, a world of 1 included. ``backend`` defaults to NCCL where a
    card is present and gloo otherwise; under NCCL the rank takes
    ``cuda:(rank % device_count)`` as its current device."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)


def process_batch_slice(
    global_batch_size: int,
    process_id: int | None = None,
    process_count: int | None = None,
) -> slice:
    """This rank's contiguous rows of every global batch (default: the
    process group's rank and size, or 0 of 1 outside one)."""
    pid = process_id if process_id is not None else (
        dist.get_rank() if dist.is_initialized() else 0)
    pcount = process_count if process_count is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    if global_batch_size % pcount:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{pcount} processes")
    per = global_batch_size // pcount
    return slice(pid * per, (pid + 1) * per)


def shard_batch_multihost(mesh, local_batch: Any, global_batch_size: int) -> Any:
    """This rank's rows of a global batch, placed on the rank's device.

    ``local_batch`` holds only the :func:`process_batch_slice` rows of
    ``mesh``'s rank (each rank assembles its own). In JAX this assembles a
    globally sharded array; here the global batch exists only as the
    ranks' rows, so this checks their count and moves them to the device.
    """
    rows = process_batch_slice(global_batch_size, mesh.rank, mesh.world)
    want = rows.stop - rows.start
    out = {}
    for key, val in local_batch.items():
        if val.shape[0] != want:
            raise ValueError(f"{key}: {val.shape[0]} rows, rank {mesh.rank} holds {want}")
        out[key] = torch.as_tensor(val).to(mesh.device)
    return out


class RowDraws:
    """A generator whose batch-leading draws cover a global batch of
    ``global_rows`` rows, of which this rank holds ``rows``.

    Pass it where a ``torch.Generator`` goes; the draw sites call
    :func:`batch_draw`, which draws at the global size and returns this
    rank's rows. A draw whose leading axis is a multiple of the local
    batch (B * K instances) scales the rows by that multiple.
    """

    def __init__(self, generator: torch.Generator, rows: slice, global_rows: int):
        self.generator = generator
        self.rows = rows
        self.global_rows = global_rows

    def draw(self, fn, *args, size, **kwargs) -> torch.Tensor:
        local = self.rows.stop - self.rows.start
        if size[0] % local:
            raise ValueError(f"a draw of leading size {size[0]} is not over the "
                             f"{local} rows of this rank")
        per_row = size[0] // local
        full = fn(*args, (self.global_rows * per_row, *size[1:]),
                  generator=self.generator, **kwargs)
        return full[self.rows.start * per_row:self.rows.stop * per_row]


def batch_draw(generator, fn, *args, size, **kwargs) -> torch.Tensor:
    """``fn(*args, size, generator=generator, **kwargs)`` (``torch.rand``,
    ``randn``, ``randint``), or through a :class:`RowDraws` this rank's
    rows of the draw over the global batch."""
    if isinstance(generator, RowDraws):
        return generator.draw(fn, *args, size=tuple(size), **kwargs)
    return fn(*args, tuple(size), generator=generator, **kwargs)
