"""The backbone's dense layers in bf16 (or fp16) with float32 results: the
port of JAX's ``TorchDense`` with a compute dtype
(``point2cyl_tpu/models/layers.py:32-51``).

JAX casts the input and the kernel to the compute dtype, multiplies them
with ``jnp.dot(..., preferred_element_type=float32)`` and adds the float32
bias; the parameters stay float32. Its transpose makes each operand's
cotangent as a float32-result product of the float32 cotangent with the
other, rounded, operand, and rounds that once to the compute dtype and
back to float32.

- :func:`dense_lowp_plain` is that arithmetic in float32 PyTorch: the
  operands rounded to the compute dtype and widened back, a float32
  product (TF32 off, ``core/device.py``) and the bias. A product of two
  bf16 values is exact in float32, so it matches JAX on the CPU to float32
  summation order, and autograd rounds at JAX's points: the backward of
  ``.to(float32)`` rounds the product's gradient to the compute dtype, the
  backward of ``.to(dtype)`` widens it back.
- :class:`LowpDense` is the card's: a tensor-core product of the rounded
  operands with a float32 result (ATen's ``mm.dtype`` / ``addmm.dtype``
  through cuBLAS; ``torch.matmul`` of bf16 tensors would round the output
  to bf16, a rounding JAX does not make), the bias added in the GEMM's
  epilogue. Its backward makes the same products for ``dx = g W`` and
  ``dW = g^T x`` and rounds each to the compute dtype and back, as JAX's
  converts do; ``db`` is the float32 sum of ``g``. The cotangent ``g`` is
  rounded to the compute dtype to enter the tensor cores: one rounding
  more than JAX on the CPU, the one the TPU's MXU makes at DEFAULT
  precision. It saves the rounded operands, half the bytes of float32.

In a data-parallel step each rank rounds its own weight gradient before
the average over the ranks (``train/steps.py:mean_over_ranks``), where
JAX's sharded program may round the summed gradient once: the two part
by about an ulp of bf16.

No TPU kernel stands behind these products: JAX leaves them to XLA outside
any Pallas kernel, and the port leaves them to cuBLAS. Reduction widths
that are not multiples of 8 (3, 131 and 259 in the backbone, the heads' 3
and 16 in the input gradient) take cuBLAS's align-1 tensor-core kernels;
``chip_smoke.py`` holds every backbone shape against the plain version.

:func:`dense_lowp` dispatches: ``impl="auto"`` takes the plain version for
a CPU tensor and :class:`LowpDense` for a CUDA tensor, ``"kernel"``
:class:`LowpDense` (a CPU tensor raises), ``"plain"`` the plain version on
any device. Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from point2cyl_torch.core.config import IMPLS, check_compute_dtype

LOWP_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def lowp_dtype(compute_dtype: str) -> torch.dtype | None:
    """The torch dtype of a low-precision ``compute_dtype``; None for
    ``"float32"``. Raises on a name the port does not take."""
    check_compute_dtype(compute_dtype)
    return LOWP_DTYPES.get(compute_dtype)


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (to nearest even) and widened to float32."""
    return t.to(dtype).to(torch.float32)


def dense_lowp_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """``x`` (..., in) times ``w`` (out, in) transposed, plus ``b``, with
    both operands rounded to ``dtype``: float32 PyTorch on any device."""
    return torch.matmul(_rounded(x, dtype), _rounded(w, dtype).t()) + b


def lowp_gemm(a: torch.Tensor, b: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """``a @ b`` (+ ``bias``) of two low-precision card matrices with a
    float32 result; ``.launches`` counts the calls."""
    lowp_gemm.launches += 1
    if bias is None:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.addmm(bias, a, b, out_dtype=torch.float32)


lowp_gemm.launches = 0  # GEMM launches, for chip_smoke.py


class LowpDense(torch.autograd.Function):
    """The card's low-precision dense layer and its backward (module
    docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        xb = x.to(dtype).reshape(-1, x.shape[-1])
        wb = w.to(dtype)
        ctx.save_for_backward(xb, wb)
        ctx.x_shape = x.shape
        y = lowp_gemm(xb, wb.t(), b)
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        xb, wb = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gb = g2.to(xb.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _rounded(lowp_gemm(gb, wb), xb.dtype).reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            dw = _rounded(lowp_gemm(gb.t(), xb), xb.dtype)
        if ctx.needs_input_grad[2]:
            db = g2.sum(0)
        return dx, dw, db, None


def dense_lowp(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               dtype: torch.dtype, impl: str = "auto") -> torch.Tensor:
    """The dense layer in ``dtype`` with a float32 result, by ``impl``
    (module docstring): ``x`` (..., in) float32, ``w`` (out, in), ``b``
    (out,)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "plain" or (impl == "auto" and x.device.type == "cpu"):
        return dense_lowp_plain(x, w, b, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"LowpDense needs CUDA tensors, got {x.device}")
    return LowpDense.apply(x, w, b, dtype)
