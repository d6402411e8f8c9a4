"""Backbone, trainer and evaluator configuration (the port's own copies of
the JAX ``BackboneConfig``, ``LossWeights``, ``TrainConfig`` and
``EvalConfig``, same fields and
defaults, less what the port does not run: the multi-device axis and the
blocked ball query's oversampling), and the reference's constants that
geometry and preprocessing read (``ZERO_TOL``, ``EXTRUSION_OPERATIONS``).

The neighbour-op switches take ``"auto"`` (the kernel wrapper: a CUDA
tensor launches the kernel, a CPU tensor takes the plain version),
``"kernel"`` (the kernel; a CPU tensor raises) or ``"plain"`` (the plain
PyTorch version on any device). ``approx_neighbors`` is accepted so that
configs written by the JAX package load, but the port always selects
neighbours exactly.

``compute_dtype`` is JAX's: ``"float32"``, or ``"bfloat16"`` /
``"float16"``, in which the backbone's dense layers multiply in that type
with float32 results (``models/layers.py:Dense``, ``ops/lowp_dense.py``);
everything else stays float32. ``dense_impl`` picks the low-precision
product as the neighbour-op switches pick theirs; the JAX config has no
such field, and a JAX-written config loads without it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

IMPLS = ("auto", "kernel", "plain")

# Tolerance below which an angle/quantity is treated as zero
# (reference: global_variables.py:15, g_zero_tol = 1e-6).
ZERO_TOL = 1e-6

# Extrusion CSG operation codes (reference: global_variables.py:19-22).
EXTRUSION_OPERATIONS = {
    "NewBodyFeatureOperation": 0,
    "JoinFeatureOperation": 0,
    "CutFeatureOperation": 1,
    "IntersectFeatureOperation": 2,
}


COMPUTE_DTYPES = ("float32", "bfloat16", "float16")


def check_compute_dtype(compute_dtype: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype!r}"
        )


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
    dense_impl: str = "auto"

    def __post_init__(self):
        for name in ("knn_impl", "fps_impl", "ballquery_impl", "dense_impl"):
            value = getattr(self, name)
            if value not in IMPLS:
                raise ValueError(f"{name} must be one of {IMPLS}, got {value!r}")
        check_compute_dtype(self.compute_dtype)

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


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Loss multipliers (reference: train_Point2Cyl_without_sketch.py:53-57,
    107-130; a disabled head zeroes its multiplier)."""

    seg: float = 1.0
    normal: float = 1.0
    base_barrel: float = 1.0
    extrusion_axis: float = 1.0
    center: float = 1.0
    # the joint trainer's (reference: train_Point2Cyl.py:60-68); the
    # manifold term enters the IGR total unweighted, as in the JAX package
    sketch_latent: float = 1.0
    igr_manifold: float = 1.0
    igr_eikonal: float = 0.1
    igr_normal: float = 1.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer A hyperparameters.

    The staircase schedules follow ``train_Point2Cyl_without_sketch.py:
    142-164``: lr = lr0 * 0.7^floor(step*bs / 200k), bn_momentum =
    max(0.5 * 0.5^floor(step*bs / 200k), 0.01).
    """

    batch_size: int = 4
    num_epochs: int = 300
    learning_rate: float = 1e-3
    decay_step: int = 200_000
    decay_rate: float = 0.7
    bn_decay_step: int = 200_000
    bn_init_momentum: float = 0.5
    bn_decay_rate: float = 0.5
    bn_momentum_clip: float = 0.99  # momentum >= 1 - clip
    add_noise: bool = False
    noise_sigma: float = 0.01
    pred_seg: bool = True
    pred_normal: bool = True
    pred_bb: bool = True
    pred_extrusion: bool = True
    pred_center: bool = True
    norm_eig: bool = False
    weights: LossWeights = dataclasses.field(default_factory=LossWeights)
    logdir: str = "runs/point2cyl_torch"
    checkpoint_every_epochs: int = 10
    best_after_epoch: int = 20
    seed: int = 0
    compute_dtype: str = "float32"
    ballquery_impl: str = "auto"
    resume: bool = False
    tensorboard: bool = False

    def __post_init__(self):
        check_compute_dtype(self.compute_dtype)
        if self.ballquery_impl not in IMPLS:
            raise ValueError(f"ballquery_impl must be one of {IMPLS}, "
                             f"got {self.ballquery_impl!r}")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluator oracle-substitution flags (reference: eval.py:53-69 uses
    store_false so pred_* default ON)."""

    pred_seg: bool = True
    pred_normal: bool = True
    pred_bb: bool = True
    use_gt_normals: bool = False
    use_gt_segmentation: bool = False
    use_gt_bb: bool = False
    use_gt_sketch: bool = False
    use_gt_im: bool = False
    use_whole_pc: bool = False
    use_extrusion_axis_feat: bool = False
    num_sketch_samples: int = 2048
    norm_eig: bool = False
    # Perturb input points along their normals before the forward pass
    # (reference eval.py:239-240).
    add_noise: bool = False
    noise_sigma: float = 0.01
