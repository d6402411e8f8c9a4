"""Backbone configuration (the port's own copy of the JAX
``BackboneConfig``, same fields and defaults).

The neighbour-op switches take ``"auto"`` (the kernel wrapper: a CUDA
tensor launches the kernel, a CPU tensor takes the plain version),
``"kernel"`` (the kernel; a CPU tensor raises) or ``"plain"`` (the plain
PyTorch version on any device). ``approx_neighbors`` is accepted so that
configs written by the JAX package load, but the port always selects
neighbours exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

IMPLS = ("auto", "kernel", "plain")


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """PointNet++ backbone hyperparameters (reference channel plan:
    512/0.2/64 -> [64,64,128]; 128/0.4/64 -> [128,128,256]; group-all ->
    [256,512,1024]; three feature-propagation stages; a 128-wide FC stage;
    one head per output size)."""

    num_points: int = 8192
    sa_npoints: Sequence[int] = (512, 128)
    sa_radii: Sequence[float] = (0.2, 0.4)
    sa_nsamples: Sequence[int] = (64, 64)
    sa_mlps: Sequence[Sequence[int]] = ((64, 64, 128), (128, 128, 256))
    sa_global_mlp: Sequence[int] = (256, 512, 1024)
    fp_mlps: Sequence[Sequence[int]] = ((256, 256), (256, 128), (128, 128, 128))
    fc_width: int = 128
    dropout_rate: float = 0.5
    output_sizes: Sequence[int] = (3, 16)
    compute_dtype: str = "float32"
    approx_neighbors: bool = True
    knn_impl: str = "auto"
    fps_impl: str = "auto"
    ballquery_impl: str = "auto"
    bq_oversample: int = 0

    def __post_init__(self):
        for name in ("knn_impl", "fps_impl", "ballquery_impl"):
            value = getattr(self, name)
            if value not in IMPLS:
                raise ValueError(f"{name} must be one of {IMPLS}, got {value!r}")
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                "the port computes in float32 only "
                f"(compute_dtype={self.compute_dtype!r})"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "BackboneConfig":
        """Rebuild from ``dataclasses.asdict`` output (lists -> tuples)."""
        d = dict(d)
        for key in ("sa_npoints", "sa_radii", "sa_nsamples", "output_sizes",
                    "sa_global_mlp"):
            if key in d:
                d[key] = tuple(d[key])
        for key in ("sa_mlps", "fp_mlps"):
            if key in d:
                d[key] = tuple(tuple(m) for m in d[key])
        return cls(**d)
