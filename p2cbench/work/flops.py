"""Model FLOPs of Point2Cyl's dense layers, counted from a configuration's
widths: 2 operations a multiply-add, every dense layer of the backbone,
the sketch encoder and the IGR decoder, nothing else (matching, softmax,
BN and the neighbour operations are not counted).

A trained layer costs three times its forward (the forward, and the
backward's products for the input and for the weight). The IGR block is
counted as its forward, the input gradient and the double backward's two
passes, one product a layer each, with the decoder frozen.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def peak_flop_per_s(dtype: str) -> float:
    return PEAKS["flop_per_s"][dtype]


def backbone_macs(cfg: dict) -> int:
    """Multiply-adds of one cloud's backbone forward."""
    n = cfg["num_points"]
    macs, widths, centres = 0, [0], [n]
    for npoint, nsample, mlp in zip(cfg["sa_npoints"], cfg["sa_nsamples"], cfg["sa_mlps"]):
        dims = [widths[-1] + 3, *mlp]
        macs += npoint * nsample * sum(a * b for a, b in zip(dims, dims[1:]))
        widths.append(mlp[-1])
        centres.append(npoint)
    dims = [widths[-1] + 3, *cfg["sa_global_mlp"]]
    macs += centres[-1] * sum(a * b for a, b in zip(dims, dims[1:]))
    up = cfg["sa_global_mlp"][-1]
    for i, mlp in enumerate(cfg["fp_mlps"]):
        dims = [widths[-(i + 1)] + up, *mlp]
        macs += centres[-(i + 1)] * sum(a * b for a, b in zip(dims, dims[1:]))
        up = mlp[-1]
    macs += n * up * cfg["fc_width"]
    macs += n * cfg["fc_width"] * sum(cfg["output_sizes"])
    return macs


def encoder_macs_per_point(cfg: dict) -> int:
    dims = [cfg["encoder_in"], *cfg["encoder_widths"]]
    return sum(a * b for a, b in zip(dims, dims[1:]))


def encoder_macs(cfg: dict, sketches: int) -> int:
    """Multiply-adds of encoding ``sketches`` sketches of ``num_sk_point``."""
    per_sketch = (encoder_macs_per_point(cfg) * cfg["num_sk_point"]
                  + cfg["encoder_widths"][-1] * cfg["latent_size"])
    return sketches * per_sketch


def decoder_macs_per_point(cfg: dict) -> int:
    d_in = 2 + cfg["latent_size"]
    dims = [d_in, *cfg["decoder_hidden"], 1]
    macs = 0
    for layer in range(len(dims) - 1):
        cout = dims[layer + 1] - (d_in if layer + 1 in cfg["decoder_skip_in"] else 0)
        macs += dims[layer] * cout
    return macs


def train_step_flop(cfg: dict, batch: int) -> float:
    """FLOPs of one training step of ``batch`` clouds."""
    flop = 3 * 2.0 * backbone_macs(cfg) * batch
    if cfg["sketch_stack"]:
        sketches = batch * cfg["k"]
        s = cfg["num_sk_point"]
        flop += 3 * 2.0 * encoder_macs(cfg, sketches)  # the trained encoder
        flop += 2.0 * encoder_macs(cfg, sketches)  # the frozen one, on the GT sketches
        igr_points = sketches * (2 * s + s // 8)  # on-sketch + off-surface samples
        flop += 4 * 2.0 * decoder_macs_per_point(cfg) * igr_points
    return flop


def serve_flop(cfg: dict, clouds: int) -> float:
    """FLOPs of decomposing ``clouds`` clouds (with the sketch stack, their
    K sketches' latents too)."""
    flop = 2.0 * backbone_macs(cfg) * clouds
    if cfg["sketch_stack"]:
        flop += 2.0 * encoder_macs(cfg, clouds * cfg["k"])
    return flop
