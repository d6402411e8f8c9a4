"""Serving replicas in which each float32 per-point layer is one GEMM.

In eval mode a per-point layer is ``relu(bn(dense(x)))``: a GEMM, the
bias, four broadcast passes of BN over the whole activation and a ReLU
pass. :func:`fold_for_serving` returns a copy of a :class:`Backbone` or a
:class:`PointNetEncoder` in which every such layer is a
:class:`FoldedDense` (BN folded into the weights once, here; the bias and
ReLU in the GEMM's epilogue) and each head is the GEMM with its bias. A
model whose dense layers compute in bf16 or fp16 is served as it is:
folding the BN scale into weights that are then rounded to bf16 would
give another result.

The copy runs eval mode only and gives the module's eval outputs up to
float32 rounding. It keeps its classes' forwards: only the layer loop
``mlp`` (of each shared-MLP stage and of the encoder) and the backbone's
``fc_stage`` are the served ones. Its unfolded dense and BN modules are
gone from it, so nothing of them runs. Only the serving session builds such copies: the
trainers, the evaluator and reconstruction run the modules themselves.
"""

from __future__ import annotations

import copy
import functools

import torch
from torch import nn

from point2cyl_torch.models.backbone import Backbone
from point2cyl_torch.models.implicit import PointNetEncoder
from point2cyl_torch.models.layers import BatchNorm, Dense, PointMLP


class FoldedDense(nn.Module):
    """A per-point dense layer with what follows it folded in:
    ``relu(x @ weight.T + bias)`` as one GEMM with the bias and ReLU in
    its epilogue (``torch._addmm_activation``, cuBLASLt's RELU_BIAS
    epilogue on the card), or with ``relu=False`` the GEMM with the bias
    alone (``torch.addmm``). ``weight`` is (out, in). Built by
    :func:`fold_dense`."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, relu: bool):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gemm = torch._addmm_activation if self.relu else torch.addmm
        y = gemm(self.bias, x.reshape(-1, x.shape[-1]), self.weight.t())
        return y.reshape(*x.shape[:-1], y.shape[-1])


def fold_dense(dense: Dense, bn: BatchNorm | None = None) -> FoldedDense:
    """``relu(bn(dense(x)))`` with ``bn`` in eval mode, or without ``bn``
    the bare ``dense(x)`` of a head, as one :class:`FoldedDense`.

    The fold is ``W' = W * s[:, None]`` and ``b' = (b - mean) * s + beta``
    with ``s = gamma * rsqrt(var + eps)``, computed in float64 on the host
    and rounded once to the parameters' dtype, on their device. A dense
    layer with a low-precision compute dtype does not fold (its product
    would round the scaled weights): that raises."""
    if dense.compute_dtype is not None:
        raise ValueError("a low-precision dense layer does not fold")
    dtype, device = dense.weight.dtype, dense.weight.device
    host = lambda t: t.detach().to("cpu", torch.float64)  # noqa: E731
    w = host(dense.weight).reshape(dense.weight.shape[0], dense.weight.shape[1])
    b = host(dense.bias)
    if bn is not None:
        s = host(bn.weight) * torch.rsqrt(host(bn.running_var) + bn.eps)
        w = w * s[:, None]
        b = (b - host(bn.running_mean)) * s + host(bn.bias)
    return FoldedDense(w.to(device, dtype).contiguous(), b.to(device, dtype),
                       relu=bn is not None)


def _eval_only(train: bool) -> None:
    if train:
        raise ValueError("a folded serving replica runs eval mode only")


class _ServedMLP:
    """A copied shared-MLP stage or sketch encoder whose per-point layers
    are ``self.served``; the rest of its forward is its class's own."""

    def mlp(self, x: torch.Tensor, train: bool = False, momentum: float = 0.1):
        _eval_only(train)
        for layer in self.served:
            x = layer(x)
        return x


class _ServedBackbone:
    """A copied backbone whose FC stage is ``self.served_fc``; the
    pyramid and the heads are ``Backbone.forward``'s."""

    def fc_stage(self, x: torch.Tensor, train: bool = False, momentum: float = 0.1):
        _eval_only(train)
        return self.served_fc(x)


@functools.cache
def _served_class(cls: type, mixin: type) -> type:
    return type(f"Served{cls.__name__}", (mixin, cls), {})


def _become(module: nn.Module, mixin: type) -> None:
    module.__class__ = _served_class(type(module), mixin)


def fold_for_serving(model: Backbone | PointNetEncoder) -> nn.Module:
    """A folded eval-mode copy of ``model``, on its device, or ``model``
    itself where a dense layer computes in low precision (see the
    module's docstring); ``model`` is left as it is."""
    if not isinstance(model, (Backbone, PointNetEncoder)):
        raise TypeError(f"no serving fold for {type(model).__name__}")
    if any(m.compute_dtype is not None for m in model.modules() if isinstance(m, Dense)):
        return model
    served = copy.deepcopy(model).eval()
    if isinstance(served, PointNetEncoder):
        served.served = nn.ModuleList(fold_dense(d, b) for d, b in served._layers())
        del served.mlp1, served.mlp2
        _become(served, _ServedMLP)
        return served
    for stage in list(served.modules()):
        if isinstance(stage, PointMLP):
            stage.served = nn.ModuleList(map(fold_dense, stage.mlp_convs, stage.mlp_bns))
            del stage.mlp_convs, stage.mlp_bns
            _become(stage, _ServedMLP)
    served.served_fc = fold_dense(served.fc1, served.bn1)
    served.fc2 = nn.ModuleList(map(fold_dense, served.fc2))
    del served.fc1, served.bn1
    _become(served, _ServedBackbone)
    return served


def layer_counts(served: nn.Module) -> tuple[int, int]:
    """(folded, unfolded) dense-BN-ReLU layers of what
    :func:`fold_for_serving` returned; the heads, which have no BN, are in
    neither."""
    folded = sum(isinstance(m, FoldedDense) and m.relu for m in served.modules())
    return folded, sum(isinstance(m, BatchNorm) for m in served.modules())
