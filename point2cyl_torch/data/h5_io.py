"""h5 dataset I/O, schema-compatible with the reference packed files
(the port of the JAX ``data/h5_io.py``).

Dataset keys follow ``utils.py:1159-1315``: point_cloud, normals,
extrusion_labels, base_barrel_labels, n_instances, extrusion_axes,
extrusion_distances, and optionally extrusion_operation, extrusion_centers,
extrusion_extents, sketches, sketches_norms. The files are read and
written by the port's own numpy reader and writer (``data/h5_reader.py``,
``data/h5_writer.py``): the card's machine has no ``h5py``. What the
port writes is uncompressed, where JAX's ``save_h5`` deflates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from point2cyl_torch.data.h5_reader import read_datasets
from point2cyl_torch.data.h5_writer import write_datasets

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
    arrays = read_datasets(path)
    missing = [key for key in _REQUIRED if key not in arrays]
    if missing:
        raise KeyError(f"{path} lacks {missing}")
    ds = PackedDataset(**{key: arrays[key] for key in _REQUIRED + _OPTIONAL
                          if key in arrays})
    ds.validate()
    return ds


def _stored(val) -> np.ndarray:
    """JAX's dtype rule: integers are stored as int32, all else float32."""
    val = np.asarray(val)
    return val.astype(np.int32 if np.issubdtype(val.dtype, np.integer) else np.float32,
                      copy=False)


def save_h5(path: str, ds: PackedDataset) -> None:
    """Write a reference-schema h5 file (``utils.py:1159-1193,1233-1274``):
    the keys that are set."""
    write_datasets(path, {key: _stored(getattr(ds, key)) for key in _REQUIRED + _OPTIONAL
                          if getattr(ds, key) is not None})


def save_model_h5(path: str, model: dict) -> None:
    """Write a single-model h5 in the ``get_model`` schema."""
    write_datasets(path, {key: _stored(val) for key, val in model.items()})


def load_model_h5(path: str, mesh_info: bool = False) -> dict:
    """Single-model h5 loader (``utils.py:1115-1154``): keys point_cloud,
    normals, extrusion_labels, extrusion_axes, extrusion_distances,
    n_instances, plus optional mesh arrays (vertices, faces, face_normals,
    face_extrusion_labels, norm_factor) and operation."""
    arrays = read_datasets(path)
    keys = ["point_cloud", "normals", "extrusion_labels", "extrusion_axes",
            "extrusion_distances", "n_instances"]
    if "operation" in arrays:
        keys.append("operation")
    if mesh_info:
        keys += ["vertices", "faces", "face_normals", "face_extrusion_labels",
                 "norm_factor"]
    missing = [key for key in keys if key not in arrays]
    if missing:
        raise KeyError(f"{path} lacks {missing}")
    return {key: arrays[key] for key in keys}
