"""Weights from the JAX package's variable trees: the backbone, the
implicit decoder and the sketch encoder.

``backbone_state_dict_from_jax`` takes the JAX backbone's ``params`` and
``batch_stats`` as nested dicts of numpy arrays (what
``jax.device_get(variables)`` or a msgpack restore gives) and returns the
port's ``state_dict``, keyed as the reference PyTorch model names its
modules, so ``Backbone.load_state_dict(..., strict=True)`` takes it, and a
reference ``.pth`` too. The mapping (flax scope -> reference module):

  SetAbstraction_{i}/PointMLP_0/TorchDense_{j}  -> sa{i+1}.mlp_convs.{j}
  GlobalAbstraction_0/PointMLP_0/...           -> sa{num_sa+1}.mlp_convs.{j}
  FeaturePropagation_{i}/PointMLP_0/...        -> fp{num_fp-i}.mlp_convs.{j}
  .../TorchBatchNorm_{j} (+ batch_stats)       -> *.mlp_bns.{j}
  TorchDense_0 / TorchBatchNorm_0 (top level)  -> fc1 / bn1
  TorchDense_{i+1}                             -> fc2.{i}

Dense kernels (in, out) become conv weights (out, in, 1, 1) for the
set-abstraction stages (Conv2d in the reference) and (out, in, 1) for the
rest (Conv1d).

``implicit_state_dict_from_jax`` maps the JAX ``ImplicitNet``'s
``Dense_{i}`` to the reference's ``lin{i}`` (Linear weights (out, in)),
and ``encoder_state_dict_from_jax`` the JAX ``PointNetEncoder``'s
``TorchDense_{j}`` / ``TorchBatchNorm_{j}`` to the reference's
``mlp1`` / ``mlp2`` Sequential indices (Conv1d weights (out, in, 1),
BatchNorm1d with ``num_batches_tracked``) and ``fc``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from point2cyl_torch.models.implicit import ENCODER_BNS, ENCODER_CONVS


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path + "/"))
        else:
            flat[path] = np.asarray(val)
    return flat


def _module_names(flat_params: dict[str, np.ndarray]) -> dict[str, str]:
    """flax stage scope -> reference module name."""
    scopes = {k.split("/")[0] for k in flat_params}
    num_sa = sum(s.startswith("SetAbstraction_") for s in scopes)
    num_fp = sum(s.startswith("FeaturePropagation_") for s in scopes)
    names = {f"SetAbstraction_{i}": f"sa{i + 1}" for i in range(num_sa)}
    names["GlobalAbstraction_0"] = f"sa{num_sa + 1}"
    for i in range(num_fp):
        names[f"FeaturePropagation_{i}"] = f"fp{num_fp - i}"
    return names


def _conv_weight(kernel: np.ndarray, rank: int) -> np.ndarray:
    w = kernel.T
    return w.reshape(w.shape + (1,) * (rank - 2))


def backbone_state_dict_from_jax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> dict[str, torch.Tensor]:
    """JAX backbone ``params``/``batch_stats`` -> the port's state_dict."""
    flat_p = _flatten(params)
    flat_s = _flatten(batch_stats)
    names = _module_names(flat_p)
    out: dict[str, np.ndarray] = {}
    for key, val in flat_p.items():
        parts = key.split("/")
        if parts[0] in names:
            mod = names[parts[0]]
            layer, leaf = parts[2], parts[3]
            j = int(layer.split("_")[1])
            if layer.startswith("TorchDense"):
                if leaf == "kernel":
                    rank = 4 if mod.startswith("sa") else 3
                    out[f"{mod}.mlp_convs.{j}.weight"] = _conv_weight(val, rank)
                else:
                    out[f"{mod}.mlp_convs.{j}.bias"] = val
            else:
                name = {"scale": "weight", "bias": "bias"}[leaf]
                out[f"{mod}.mlp_bns.{j}.{name}"] = val
        elif parts[0] == "TorchDense_0":
            if parts[1] == "kernel":
                out["fc1.weight"] = _conv_weight(val, 3)
            else:
                out["fc1.bias"] = val
        elif parts[0] == "TorchBatchNorm_0":
            name = {"scale": "weight", "bias": "bias"}[parts[1]]
            out[f"bn1.{name}"] = val
        elif parts[0].startswith("TorchDense_"):
            i = int(parts[0].split("_")[1]) - 1
            if parts[1] == "kernel":
                out[f"fc2.{i}.weight"] = _conv_weight(val, 3)
            else:
                out[f"fc2.{i}.bias"] = val
        else:
            raise KeyError(f"unexpected backbone parameter {key}")
    for key, val in flat_s.items():
        parts = key.split("/")
        leaf = {"mean": "running_mean", "var": "running_var"}[parts[-1]]
        if parts[0] in names:
            j = int(parts[2].split("_")[1])
            out[f"{names[parts[0]]}.mlp_bns.{j}.{leaf}"] = val
        elif parts[0] == "TorchBatchNorm_0":
            out[f"bn1.{leaf}"] = val
        else:
            raise KeyError(f"unexpected backbone statistic {key}")
    return _tensors(out)


def _tensors(out: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in out.items()}


def implicit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``ImplicitNet`` ``params`` -> the port's ``ImplicitNet``
    state_dict (``lin{i}.weight`` (out, in), ``lin{i}.bias``)."""
    out: dict[str, np.ndarray] = {}
    for key, val in _flatten(params).items():
        layer, leaf = key.split("/")
        if not layer.startswith("Dense_") or leaf not in ("kernel", "bias"):
            raise KeyError(f"unexpected implicit parameter {key}")
        i = int(layer.split("_")[1])
        out[f"lin{i}.weight" if leaf == "kernel" else f"lin{i}.bias"] = (
            val.T if leaf == "kernel" else val)
    return _tensors(out)


def encoder_state_dict_from_jax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> dict[str, torch.Tensor]:
    """JAX ``PointNetEncoder`` ``params``/``batch_stats`` -> the port's
    ``PointNetEncoder`` state_dict, ``num_batches_tracked`` 0."""
    flat_p = _flatten(params)
    flat_s = _flatten(batch_stats)
    fc = len(ENCODER_CONVS)
    expected = ({f"TorchDense_{j}/{leaf}" for j in range(fc + 1)
                 for leaf in ("kernel", "bias")}
                | {f"TorchBatchNorm_{j}/{leaf}" for j in range(fc)
                   for leaf in ("scale", "bias")})
    if set(flat_p) != expected:
        raise KeyError(f"unexpected encoder parameters {sorted(set(flat_p) ^ expected)}")
    out: dict[str, np.ndarray] = {}
    for j, (mod, idx) in enumerate(ENCODER_CONVS):
        out[f"{mod}.{idx}.weight"] = _conv_weight(flat_p[f"TorchDense_{j}/kernel"], 3)
        out[f"{mod}.{idx}.bias"] = flat_p[f"TorchDense_{j}/bias"]
    for j, (mod, idx) in enumerate(ENCODER_BNS):
        out[f"{mod}.{idx}.weight"] = flat_p[f"TorchBatchNorm_{j}/scale"]
        out[f"{mod}.{idx}.bias"] = flat_p[f"TorchBatchNorm_{j}/bias"]
        out[f"{mod}.{idx}.running_mean"] = flat_s[f"TorchBatchNorm_{j}/mean"]
        out[f"{mod}.{idx}.running_var"] = flat_s[f"TorchBatchNorm_{j}/var"]
    out["fc.weight"] = flat_p[f"TorchDense_{fc}/kernel"].T
    out["fc.bias"] = flat_p[f"TorchDense_{fc}/bias"]
    sd = _tensors(out)
    for mod, idx in ENCODER_BNS:
        sd[f"{mod}.{idx}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
