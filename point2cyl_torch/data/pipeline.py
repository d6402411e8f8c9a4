"""Device-resident input pipeline (the port of the JAX
``data/pipeline.py:30-237``, without the multi-host slicing).

The packed dataset is copied to the device once. Each step selects batch
rows, draws a fresh random subsample of each cloud and gathers the
per-point labels there; the host sends nothing but the row indices of the
epoch order, which is drawn on the device as well. With
``num_sketch_points`` each batch also carries the GT sketches of its
rows, each item's points in a fresh random order cut to that count (the
joint trainer's input). Every draw comes from
the caller's ``torch.Generator``, so a run seeded per epoch replays the
same batches after a resume.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from point2cyl_torch.data.h5_io import PackedDataset
from point2cyl_torch.ops.matching import one_hot_labels
from point2cyl_torch.ops.sampling import random_subsample_indices


def _pad_k(arr: np.ndarray, k: int) -> np.ndarray:
    """Slice or zero-pad the instance axis (axis 1) to exactly K (the
    reference slices ``[:self.K]``, ``dataloader.py:86-87``)."""
    arr = np.asarray(arr)
    dtype = np.float32 if np.issubdtype(arr.dtype, np.floating) else arr.dtype
    if arr.shape[1] >= k:
        return arr[:, :k].astype(dtype)
    pad = [(0, 0)] * arr.ndim
    pad[1] = (0, k - arr.shape[1])
    return np.pad(arr, pad).astype(dtype)


class InputPipeline:
    """The dataset on ``device`` and the batches drawn from it.

    A batch is a dict like the reference Dataset's returns
    (``dataloader.py:89-124``): point_cloud, normals (B, N, 3);
    extrusion_labels, base_barrel_labels (B, N) int32; extrusion_axes
    (B, K, 3); extrusion_distances (B, K); per_point_axes (B, N, 3);
    per_point_distances (B, N); and, where the pack has them,
    extrusion_centers (B, K, 3), extrusion_extents (B, K, 2) and
    extrusion_operation (B, N); with ``num_sketch_points`` S also sketches
    (B, K, S, 4) (2D points and normals) and sketches_norms (B, K).
    """

    def __init__(self, ds: PackedDataset, num_points: int, max_instances: int,
                 device: str | torch.device, num_sketch_points: int = 0):
        if ds.resolution < num_points:
            raise ValueError(f"cannot sample {num_points} points from resolution "
                             f"{ds.resolution} clouds")
        if num_sketch_points and ds.sketches is None:
            raise ValueError("num_sketch_points needs a pack with sketches")
        if num_sketch_points and ds.sketches.shape[2] < num_sketch_points:
            raise ValueError(f"cannot sample {num_sketch_points} sketch points from "
                             f"sketches of {ds.sketches.shape[2]}")
        self.num_points = num_points
        self.num_sketch_points = num_sketch_points
        self.k = max_instances
        self.num_samples = ds.num_samples
        self.resolution = ds.resolution
        self.device = torch.device(device)
        host = {
            "point_cloud": ds.point_cloud.astype(np.float32),
            "normals": ds.normals.astype(np.float32),
            "extrusion_labels": ds.extrusion_labels.astype(np.int32),
            "base_barrel_labels": ds.base_barrel_labels.astype(np.int32),
            "extrusion_axes": _pad_k(ds.extrusion_axes, max_instances),
            "extrusion_distances": _pad_k(ds.extrusion_distances, max_instances),
        }
        if ds.extrusion_centers is not None:
            host["extrusion_centers"] = _pad_k(ds.extrusion_centers, max_instances)
        if ds.extrusion_extents is not None:
            host["extrusion_extents"] = _pad_k(ds.extrusion_extents, max_instances)
        if ds.extrusion_operation is not None:
            host["extrusion_operation"] = ds.extrusion_operation.astype(np.int32)
        if num_sketch_points:
            host["sketches"] = _pad_k(ds.sketches, max_instances)
            host["sketches_norms"] = _pad_k(ds.sketches_norms, max_instances)
        self._dev = {key: torch.from_numpy(np.ascontiguousarray(val)).to(self.device)
                     for key, val in host.items()}

    def gather(self, rows: torch.Tensor, sub_idx: torch.Tensor,
               sketch_idx: torch.Tensor | None = None) -> dict:
        """The batch of dataset ``rows`` (B,) subsampled at ``sub_idx``
        (B, N) (``_gather_batch``, ``dataloader.py:69-87``), and with
        sketches, their points at ``sketch_idx`` (B, S) of each item."""
        rows = rows.to(self.device, torch.int64)
        sub_idx = sub_idx.to(self.device, torch.int64)
        dev = self._dev

        def sub_points(x: torch.Tensor) -> torch.Tensor:  # (M, R, ...) -> (B, N, ...)
            x = x[rows]
            idx = sub_idx if x.dim() == 2 else sub_idx[..., None].expand(-1, -1, x.shape[2])
            return torch.gather(x, 1, idx)

        labels = sub_points(dev["extrusion_labels"])
        axes = dev["extrusion_axes"][rows]
        dists = dev["extrusion_distances"][rows]
        onehot = one_hot_labels(labels, axes.shape[1], axes.dtype)  # -1 -> zero row
        out = {
            "point_cloud": sub_points(dev["point_cloud"]),
            "normals": sub_points(dev["normals"]),
            "extrusion_labels": labels,
            "base_barrel_labels": sub_points(dev["base_barrel_labels"]),
            "extrusion_axes": axes,
            "extrusion_distances": dists,
            "per_point_axes": torch.einsum("bnk,bkc->bnc", onehot, axes),
            "per_point_distances": torch.einsum("bnk,bk->bn", onehot, dists),
        }
        for key in ("extrusion_centers", "extrusion_extents"):
            if key in dev:
                out[key] = dev[key][rows]
        if "extrusion_operation" in dev:
            out["extrusion_operation"] = sub_points(dev["extrusion_operation"])
        if self.num_sketch_points:
            sk = dev["sketches"][rows]  # (B, K, Ssk, 4)
            idx = sketch_idx.to(self.device, torch.int64)[:, None, :, None]
            out["sketches"] = torch.gather(
                sk, 2, idx.expand(-1, sk.shape[1], -1, sk.shape[3]))
            out["sketches_norms"] = dev["sketches_norms"][rows]
        return out

    def batch(self, rows: torch.Tensor, generator: torch.Generator) -> dict:
        """The batch of ``rows`` with a fresh random subsample of each cloud
        and, with sketches, a fresh order of each item's sketch points
        (JAX ``_gather_batch``, ``pipeline.py:222-236``)."""
        sub_idx = random_subsample_indices(generator, self.resolution,
                                           self.num_points, len(rows))
        sketch_idx = None
        if self.num_sketch_points:
            sketch_idx = random_subsample_indices(
                generator, self._dev["sketches"].shape[2], self.num_sketch_points,
                len(rows))
        return self.gather(rows, sub_idx, sketch_idx)

    def epochs(self, batch_size: int, generator: torch.Generator,
               shuffle: bool = True) -> Iterator[dict]:
        """One epoch of batches in an order drawn from ``generator``, or in
        row order without ``shuffle`` (the evaluator's); each cloud's
        subsample is drawn from ``generator`` either way. The ragged tail
        is dropped, as a drop_last loader does."""
        if shuffle:
            order = torch.randperm(self.num_samples, generator=generator,
                                   device=generator.device)
        else:
            order = torch.arange(self.num_samples, device=generator.device)
        for i in range(self.num_samples // batch_size):
            yield self.batch(order[i * batch_size:(i + 1) * batch_size], generator)
