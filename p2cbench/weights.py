"""Weights drawn from the seed, on the device, in a few large calls.

One uniform and one normal draw from a ``torch.Generator`` on the device
cover every tensor of a layout (:mod:`p2cbench.reference.layout`); each
tensor is then a scaled slice of one of them. The same seed gives the same
weights, which the program and the reference are both handed.
"""

from __future__ import annotations

import math

import torch


def make(layout: list, generator: torch.Generator, device) -> dict[str, torch.Tensor]:
    """The tensors of ``layout`` as a dict name -> float32 tensor (an int64
    counter for a ``count`` entry), drawn from ``generator``."""
    sizes = {"uniform": 0, "normal": 0}
    for _, shape, init in layout:
        if init[0] in sizes:
            sizes[init[0]] += math.prod(shape)
    uniform = torch.rand(sizes["uniform"], generator=generator, device=device)
    normal = torch.randn(sizes["normal"], generator=generator, device=device)
    offsets = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, init in layout:
        kind = init[0]
        if kind == "const":
            out[name] = torch.full(shape, float(init[1]), device=device)
        elif kind == "count":
            out[name] = torch.full(shape, int(init[1]), dtype=torch.int64, device=device)
        else:
            n = math.prod(shape)
            draw = (uniform if kind == "uniform" else normal)[offsets[kind]:offsets[kind] + n]
            offsets[kind] += n
            if kind == "uniform":
                out[name] = ((2.0 * draw - 1.0) * init[1]).reshape(shape)
            else:
                out[name] = (init[1] + init[2] * draw).reshape(shape)
    return out
