"""Farthest point sampling, plain PyTorch, and the random subsampling of
training clouds.

The plain versions of the FPS kernels (``ops/cuda_fps.py``): the CPU path,
and what ``chip_smoke.py`` holds the kernels against on the card.
:func:`farthest_point_sample_plain`'s indices equal the JAX
``ops/sampling.py:farthest_point_sample`` bit for bit: the same running
minimum from 1e10, the same sum order ``((dx*dx + dy*dy) + dz*dz)`` in
separate (never fused) operations, and ``argmax`` ties going to the lowest
index. :func:`fps_ring_step_plain` is one step of the same loop over a
point-sharded cloud (``parallel/point_sharding.py``).
"""

from __future__ import annotations

import torch


def start_indices(
    b: int, n: int, start_idx: int | torch.Tensor, device: torch.device,
    dtype: torch.dtype = torch.int64,
) -> torch.Tensor:
    """(B,) start index per row from a scalar or a (B,) tensor, in one
    operation. Raises ``ValueError`` for a start that lies outside [0, n)
    where the host can see it without waiting for the card: a scalar or a
    CPU tensor. A CUDA tensor is not read back here (the FPS kernel
    asserts its range)."""
    if isinstance(start_idx, torch.Tensor):
        if start_idx.shape != (b,):
            raise ValueError(f"start_idx must be ({b},), got {tuple(start_idx.shape)}")
        bad = start_idx.device.type == "cpu" and bool(
            ((start_idx < 0) | (start_idx >= n)).any())
    else:
        bad = not 0 <= start_idx < n
    if bad:
        raise ValueError(f"FPS start indices must lie in [0, {n})")
    if isinstance(start_idx, torch.Tensor):
        return start_idx.to(device=device, dtype=dtype).contiguous()
    return torch.full((b,), int(start_idx), dtype=dtype, device=device)


def farthest_point_sample_plain(
    xyz: torch.Tensor, npoint: int, start_idx: int | torch.Tensor = 0
) -> torch.Tensor:
    """Iterative farthest point sampling.

    Args:
      xyz: (B, N, 3) float32 points.
      npoint: number of samples.
      start_idx: first index, one for all rows or a (B,) tensor. Serving
        starts at 0; a random start is drawn by the caller.

    Returns:
      (B, npoint) int32 indices.
    """
    b, n, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=xyz.device)
    farthest = start_indices(b, n, start_idx, xyz.device)
    distance = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    centroids = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        centroids[:, i] = farthest
        cx = x[rows, farthest][:, None]
        cy = y[rows, farthest][:, None]
        cz = z[rows, farthest][:, None]
        dx, dy, dz = x - cx, y - cy, z - cz
        dist = dx * dx + dy * dy + dz * dz
        distance = torch.minimum(distance, dist)
        farthest = torch.argmax(distance, dim=-1)
    return centroids.to(torch.int32)


LOW32 = 0xFFFFFFFF  # an offer key's low half: the complement of the global index


NAN_BITS = 0x7FFFFFFF  # a NaN distance's bits in a key: above inf's, as the kernels' min.NaN


def fps_ring_offers(index: torch.Tensor, coords: torch.Tensor,
                    dist: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 4) int64 offers of the (B,) global indices ``index`` at
    float32 ``coords`` (B, 3): the key ``dist``'s float32 bits (0 where
    None; a NaN's as ``NAN_BITS``, whatever its payload) shifted left 32
    over ``LOW32 - index`` (non-negative floats order as their bits, so the
    largest key is the largest distance at the lowest index, a NaN above
    all, as argmax takes it), then the coordinates' bits, sign-extended."""
    bits = 0 if dist is None else torch.where(
        dist.isnan(), NAN_BITS, dist.view(torch.int32)).long() << 32
    key = bits | (LOW32 - index)
    return torch.cat([key[:, None], coords.view(torch.int32).long()], dim=-1)


def fps_ring_step_plain(xyz: torch.Tensor, every: torch.Tensor, distance: torch.Tensor,
                        centroids: torch.Tensor, step: int, off: int) -> torch.Tensor:
    """One step of FPS over this rank's shard ``xyz`` (B, Nl, 3) float32
    of a cloud whose global indices start at ``off``: take the previous
    step's winner, the largest key of the ranks' gathered offers ``every``
    (P, B, 4) (the start's at step 0), write its global index into
    ``centroids[:, step]``, fold its squared distances into the running
    minimum ``distance`` (B, Nl) in place, and return this rank's (B, 4)
    offer of its farthest point (:func:`fps_ring_offers`). The kernel
    (``csrc/fps_ring.cu``) computes the same bit for bit (a NaN distance
    is a NaN, its payload aside)."""
    win = torch.gather(every, 0, every[..., :1].argmax(dim=0)[None].expand(1, -1, 4))[0]
    centroids[:, step] = LOW32 - (win[:, 0] & LOW32)
    c = win[:, 1:].to(torch.int32).view(torch.float32)
    dx, dy, dz = (xyz[..., k] - c[:, k:k + 1] for k in range(3))
    torch.minimum(distance, dx * dx + dy * dy + dz * dz, out=distance)
    local = torch.argmax(distance, dim=-1)
    lmax = torch.gather(distance, 1, local[:, None])[:, 0]
    coords = torch.gather(xyz, 1, local[:, None, None].expand(-1, 1, 3))[:, 0]
    return fps_ring_offers(local + off, coords, lmax)


def random_subsample_indices(
    generator: torch.Generator, resolution: int, num_points: int, batch: int
) -> torch.Tensor:
    """(batch, num_points) int64: the first ``num_points`` of a fresh
    random permutation of ``range(resolution)`` per sample, on the
    generator's device (the reference Dataset's per-item
    ``torch.randperm(resolution)[:num_points]``, ``dataloader.py:71-75``)."""
    return torch.stack([
        torch.randperm(resolution, generator=generator,
                       device=generator.device)[:num_points]
        for _ in range(batch)
    ])
