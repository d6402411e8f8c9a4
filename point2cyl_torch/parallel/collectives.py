"""The collectives the JAX code gets from ``jax.lax`` (``psum``, ``pmax``,
``pmin``, ``all_gather``, ``ppermute``), over the ranks of a
:class:`point2cyl_torch.parallel.mesh.Mesh`.

Each takes this rank's tensor and returns the result on this rank, as
the ``jax.lax`` ops do inside ``shard_map``. A mesh without a process
group (one process, none initialised) returns the input; a world-1 group
runs the collective, except :func:`ppermute`. A mesh formed with
``host_staged=True`` moves a card tensor through host memory for every
collective: that is how a gloo group (which sends and receives CPU
tensors only) carries card tensors, and the mesh's creator chooses it.
Every result comes back on the input's device.
:func:`psum` is differentiable: its backward sums the cotangent over the
ranks, which is what a sum over the global batch needs. :func:`psum_`
sums a buffer in place (the trainers' flat gradients).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def _transport(mesh) -> torch.device:
    """The device the group's transport takes: the host where the mesh
    stages through it or lives on the CPU, else the mesh's card (so a CPU
    tensor crosses NCCL too)."""
    on_host = mesh.host_staged or mesh.device.type == "cpu"
    return torch.device("cpu") if on_host else mesh.device


def _staged(x: torch.Tensor, mesh) -> torch.Tensor:
    """A contiguous copy of ``x`` on the transport's device."""
    return torch.empty(x.shape, dtype=x.dtype, device=_transport(mesh)).copy_(x.detach())


def _all_reduce(x: torch.Tensor, mesh, op) -> torch.Tensor:
    out = _staged(x, mesh)
    dist.all_reduce(out, op=op, group=mesh.group)
    return out.to(x.device)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad, ctx.mesh), None


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank; differentiable."""
    if mesh.group is None:
        return x
    return _PSum.apply(x, mesh)


def psum_(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``x`` over the ranks in place, in one all-reduce of the buffer
    itself where it lies on the transport's device; returns ``x``."""
    if mesh.group is None:
        return x
    if x.device == _transport(mesh) and x.is_contiguous():
        dist.all_reduce(x, group=mesh.group)
    else:
        buf = _staged(x, mesh)
        dist.all_reduce(buf, group=mesh.group)
        x.copy_(buf)
    return x


def pmax(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks."""
    if mesh.group is None:
        return x
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the ranks."""
    if mesh.group is None:
        return x
    return _all_reduce(x, mesh, dist.ReduceOp.MIN)


def all_gather(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` (one shape on every rank) concatenated along
    ``dim`` in rank order (``jax.lax.all_gather(..., tiled=True)``), in one
    ``all_gather_into_tensor`` from ``x`` itself where it lies contiguous
    on the transport's device, which a CUDA graph can capture over NCCL."""
    if mesh.group is None:
        return x
    dim %= x.dim()
    transport = _transport(mesh)
    src = x.detach() if x.device == transport and x.is_contiguous() else _staged(x, mesh)
    out = torch.empty((mesh.world * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=transport)
    dist.all_gather_into_tensor(out, src, group=mesh.group)
    if dim:
        out = out.view(mesh.world, *src.shape).movedim(0, dim).reshape(
            *x.shape[:dim], -1, *x.shape[dim + 1:])
    return out.to(x.device)


def ppermute(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` of the previous rank on the ring; this rank's goes to the
    next (``jax.lax.ppermute`` with the perm ``i -> i + 1``). The identity
    at world 1: torch refuses a send to one's own rank."""
    if mesh.world == 1:
        return x
    src = _staged(x, mesh)
    out = torch.empty_like(src)
    to_rank = dist.get_global_rank(mesh.group, (mesh.rank + 1) % mesh.world)
    from_rank = dist.get_global_rank(mesh.group, (mesh.rank - 1) % mesh.world)
    ops = [dist.P2POp(dist.isend, src, to_rank, group=mesh.group),
           dist.P2POp(dist.irecv, out, from_rank, group=mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device)


def broadcast(x: torch.Tensor, mesh, src: int = 0) -> None:
    """Overwrite ``x`` in place with rank ``src``'s."""
    if mesh.group is None:
        return
    buf = _staged(x, mesh)
    dist.broadcast(buf, dist.get_global_rank(mesh.group, src), group=mesh.group)
    with torch.no_grad():
        x.copy_(buf)


def broadcast_object(obj: Any, mesh, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj``, on every rank."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, dist.get_global_rank(mesh.group, src),
                               group=mesh.group, device=_transport(mesh))
    return box[0]
