"""h5 dataset input, schema-compatible with the reference packed files
(the port's copy of the loader half of the JAX ``data/h5_io.py``).

Dataset keys follow ``utils.py:1159-1315``: point_cloud, normals,
extrusion_labels, base_barrel_labels, n_instances, extrusion_axes,
extrusion_distances, and optionally extrusion_operation, extrusion_centers,
extrusion_extents, sketches, sketches_norms. ``h5py`` is imported by the
loader only, so the synthetic path runs where it is not installed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

_REQUIRED = (
    "point_cloud",
    "normals",
    "extrusion_labels",
    "base_barrel_labels",
    "n_instances",
    "extrusion_axes",
    "extrusion_distances",
)
_OPTIONAL = (
    "extrusion_operation",
    "extrusion_centers",
    "extrusion_extents",
    "sketches",
    "sketches_norms",
)


@dataclasses.dataclass
class PackedDataset:
    """Host-side packed dataset (M samples of R-point clouds).

    Shapes: point_cloud/normals (M, R, 3); extrusion_labels /
    base_barrel_labels (M, R); n_instances (M,); extrusion_axes (M, Kd, 3);
    extrusion_distances (M, Kd); optional centers (M, Kd, 3), extents
    (M, Kd, 2), operation (M, R) per-point op labels, sketches
    (M, Kd, Ssk, 4) 2D points+normals, sketches_norms (M, Kd).
    """

    point_cloud: np.ndarray
    normals: np.ndarray
    extrusion_labels: np.ndarray
    base_barrel_labels: np.ndarray
    n_instances: np.ndarray
    extrusion_axes: np.ndarray
    extrusion_distances: np.ndarray
    extrusion_operation: Optional[np.ndarray] = None
    extrusion_centers: Optional[np.ndarray] = None
    extrusion_extents: Optional[np.ndarray] = None
    sketches: Optional[np.ndarray] = None
    sketches_norms: Optional[np.ndarray] = None

    @property
    def num_samples(self) -> int:
        return self.point_cloud.shape[0]

    @property
    def resolution(self) -> int:
        return self.point_cloud.shape[1]

    def validate(self) -> None:
        m, r, _ = self.point_cloud.shape
        checks = {
            "normals": self.normals.shape == (m, r, 3),
            "extrusion_labels": self.extrusion_labels.shape == (m, r),
            "base_barrel_labels": self.base_barrel_labels.shape == (m, r),
            "n_instances": self.n_instances.shape == (m,),
            "extrusion_axes": (self.extrusion_axes.shape[0] == m
                               and self.extrusion_axes.shape[2] == 3),
        }
        bad = [key for key, ok in checks.items() if not ok]
        if bad:
            raise ValueError(f"packed dataset: {bad} do not fit point_cloud "
                             f"{self.point_cloud.shape}")


def load_h5(path: str) -> PackedDataset:
    """Read a reference-schema h5 file; all optional keys that exist are
    loaded (superset of the reference's flag-gated loads,
    ``utils.py:1195-1230,1276-1315``)."""
    import h5py

    kwargs = {}
    with h5py.File(path, "r") as f:
        for key in _REQUIRED:
            kwargs[key] = f[key][:]
        for key in _OPTIONAL:
            if key in f:
                kwargs[key] = f[key][:]
    ds = PackedDataset(**kwargs)
    ds.validate()
    return ds
