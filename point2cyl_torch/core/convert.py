"""Backbone weights from the JAX package's variable trees.

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
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


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
    return {
        k: torch.tensor(np.asarray(v, dtype=np.float32))
        for k, v in out.items()
    }
