"""2D SDF sketch visualization (the port of the JAX ``recon/plots.py``).

Equivalent of ``IGR/plots.py``: evaluate the latent-conditioned SDF over a
uniform 2D grid in one decoder call on the decoder's device (instead of
100k-point host chunks, ``IGR/plots.py:50-56``) and draw the zero level
set + input points with matplotlib (contour extraction by matplotlib
itself, replacing ``skimage.measure.find_contours``). matplotlib is
imported only where a plot is drawn, and its absence raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from point2cyl_torch.models.implicit import add_latent


def get_grid_uniform_2d(resolution: int, half_extent: float = 1.2):
    """Uniform 2D evaluation grid (``IGR/plots.py:99-116`` semantics)."""
    lin = np.linspace(-half_extent, half_extent, resolution)
    xx, yy = np.meshgrid(lin, lin)
    pts = np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1)
    return pts.astype(np.float32), lin


@torch.inference_mode()
def eval_sdf_grid_2d(decoder: torch.nn.Module, latent, resolution: int = 512,
                     half_extent: float = 1.2) -> np.ndarray:
    """Decode the SDF over the grid on the decoder's device. decoder:
    (1, P, L+2) -> (1, P, 1); latent (L,), a tensor or an array.
    Returns (resolution, resolution) float32."""
    dev = next(decoder.parameters()).device
    pts, _ = get_grid_uniform_2d(resolution, half_extent)
    lat = torch.as_tensor(latent, dtype=torch.float32, device=dev)
    z = decoder(add_latent(torch.from_numpy(pts).to(dev)[None], lat[None]))
    return z.cpu().numpy().reshape(resolution, resolution)


def require_matplotlib():
    """matplotlib with the Agg backend, or an ImportError that names it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the SDF contour plots need matplotlib, which cannot be "
                          "imported here") from e
    matplotlib.use("Agg")
    return matplotlib


def plot_surface_2d(
    decoder: torch.nn.Module,
    path: str,
    epoch,
    shapename,
    latent,
    points: np.ndarray | None = None,
    resolution: int = 512,
    mc_value: float = 0.0,
    half_extent: float = 1.2,
) -> str:
    """Save a contour plot of the SDF zero level set
    (``IGR/plots.py:9-96`` capability; png output). Returns the file path."""
    require_matplotlib()
    import matplotlib.pyplot as plt

    z = eval_sdf_grid_2d(decoder, latent, resolution, half_extent)
    _, lin = get_grid_uniform_2d(resolution, half_extent)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.contourf(lin, lin, z, levels=20, cmap="RdBu")
    ax.contour(lin, lin, z, levels=[mc_value], colors="k", linewidths=2)
    if points is not None:
        ax.scatter(points[:, 0], points[:, 1], s=2, c="lime")
    ax.set_aspect("equal")
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"igr_2d_{epoch}_{shapename}.png")
    fig.savefig(out, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out
