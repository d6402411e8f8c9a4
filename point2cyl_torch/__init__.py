"""PyTorch/CUDA port of point2cyl for one NVIDIA H100 (sm_90a).

A second package beside ``point2cyl_tpu`` (the JAX reference, which stays
as it is). This slice serves extrusion-cylinder decompositions:
:class:`point2cyl_torch.serve.session.InferenceSession` runs the backbone
and the GT-free decomposition on the card, through four kernels written by
hand in CUDA C++ (``csrc/``): farthest point sampling, the two fused ball
queries with gather, and the 3-NN interpolation.

The package imports ``torch`` and never JAX, flax or ``point2cyl_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from point2cyl_torch.core import device as _device  # noqa: F401  (TF32 off)
