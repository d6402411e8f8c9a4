"""The weights of each network as the published state_dicts name and shape
them, and how the benchmark draws them.

Each entry is ``(name, shape, init)``. ``init`` is one of
``("uniform", bound)`` (U(-bound, bound)), ``("normal", mean, std)``,
``("const", value)``, ``("count", value)``. Dense layers take PyTorch's
default for a convolution, U(+-1/sqrt(fan_in)), which the published
trainers start from; BN layers weight 1, bias 0 and unit statistics
(:func:`p2cbench.reference.nets.calibrate` sets the statistics of served
weights).
"""

from __future__ import annotations

import math


def _dense(name: str, cin: int, cout: int, rank: int) -> list:
    bound = 1.0 / math.sqrt(cin)
    return [(name + ".weight", (cout, cin) + (1,) * (rank - 2), ("uniform", bound)),
            (name + ".bias", (cout,), ("uniform", bound))]


def _bn(name: str, width: int, tracked: bool = False) -> list:
    out = [(name + ".weight", (width,), ("const", 1.0)),
           (name + ".bias", (width,), ("const", 0.0)),
           (name + ".running_mean", (width,), ("const", 0.0)),
           (name + ".running_var", (width,), ("const", 1.0))]
    if tracked:
        out.append((name + ".num_batches_tracked", (), ("count", 0)))
    return out


def backbone(cfg: dict) -> list:
    """The PointNet++ backbone's state_dict entries for a config's widths."""
    out, widths = [], [0]
    num_sa = len(cfg["sa_npoints"])
    for i, mlp in enumerate(cfg["sa_mlps"]):
        dims = [widths[-1] + 3, *mlp]
        for j in range(len(mlp)):
            out += _dense(f"sa{i + 1}.mlp_convs.{j}", dims[j], dims[j + 1], 4)
            out += _bn(f"sa{i + 1}.mlp_bns.{j}", dims[j + 1])
        widths.append(mlp[-1])
    dims = [widths[-1] + 3, *cfg["sa_global_mlp"]]
    for j in range(len(cfg["sa_global_mlp"])):
        out += _dense(f"sa{num_sa + 1}.mlp_convs.{j}", dims[j], dims[j + 1], 4)
        out += _bn(f"sa{num_sa + 1}.mlp_bns.{j}", dims[j + 1])
    up = cfg["sa_global_mlp"][-1]
    for i, mlp in enumerate(cfg["fp_mlps"]):
        dims = [widths[-(i + 1)] + up, *mlp]
        for j in range(len(mlp)):
            out += _dense(f"fp{num_sa + 1 - i}.mlp_convs.{j}", dims[j], dims[j + 1], 3)
            out += _bn(f"fp{num_sa + 1 - i}.mlp_bns.{j}", dims[j + 1])
        up = mlp[-1]
    out += _dense("fc1", up, cfg["fc_width"], 3)
    out += _bn("bn1", cfg["fc_width"])
    for i, width in enumerate(cfg["output_sizes"]):
        out += _dense(f"fc2.{i}", cfg["fc_width"], width, 3)
    return out


def encoder(cfg: dict) -> list:
    """The sketch encoder's (``PointNetEncoder(L, 2, with_normals=True)``)."""
    widths = cfg["encoder_widths"]
    dims = [cfg["encoder_in"], *widths]
    names = (("mlp1.0", "mlp1.1"), ("mlp1.3", "mlp1.4"), ("mlp2.0", "mlp2.1"),
             ("mlp2.3", "mlp2.4"), ("mlp2.6", "mlp2.7"))
    out = []
    for j, (conv, bn) in enumerate(names):
        out += _dense(conv, dims[j], dims[j + 1], 3)
        out += _bn(bn, dims[j + 1], tracked=True)
    bound = 1.0 / math.sqrt(widths[-1])
    out += [("fc.weight", (cfg["latent_size"], widths[-1]), ("uniform", bound)),
            ("fc.bias", (cfg["latent_size"],), ("uniform", bound))]
    return out


def decoder(cfg: dict) -> list:
    """The IGR decoder's, with its geometric initialisation: hidden layers
    N(0, sqrt(2)/sqrt(out)) with zero bias, the last N(sqrt(pi)/sqrt(in),
    1e-5) with bias -1, the SDF of the unit circle."""
    d_in = 2 + cfg["latent_size"]
    dims = [d_in, *cfg["decoder_hidden"], 1]
    skip = cfg["decoder_skip_in"]
    out = []
    last = len(dims) - 2
    for layer in range(len(dims) - 1):
        cout = dims[layer + 1] - (d_in if layer + 1 in skip else 0)
        cin = dims[layer]
        if layer == last:
            init = ("normal", math.sqrt(math.pi) / math.sqrt(cin), 1e-5)
            bias = ("const", -1.0)
        else:
            init = ("normal", 0.0, math.sqrt(2.0) / math.sqrt(cout))
            bias = ("const", 0.0)
        out += [(f"lin{layer}.weight", (cout, cin), init), (f"lin{layer}.bias", (cout,), bias)]
    return out
