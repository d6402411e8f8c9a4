"""Farthest point sampling, plain PyTorch, and the random subsampling of
training clouds.

The plain version of the FPS kernel (``ops/cuda_fps.py``): the CPU path,
and what ``chip_smoke.py`` holds the kernel against on the card. Its
indices equal the JAX ``ops/sampling.py:farthest_point_sample`` bit for
bit: the same running minimum from 1e10, the same sum order
``((dx*dx + dy*dy) + dz*dz)`` in separate (never fused) operations, and
``argmax`` ties going to the lowest index.
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
