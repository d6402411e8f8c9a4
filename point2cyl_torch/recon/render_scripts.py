"""External-renderer shell-script emission.

Capability twin of the reference's OSMesaRenderer orchestration
(``utils.py:953-1111``, ``data_utils.py:1744-2020``): write labeled point
clouds + ``render.sh`` / ``image_files.sh`` scripts that drive an external
offline rasterizer binary. The binary itself is out of scope (SURVEY.md
N5); the emitted CLI contract is kept compatible so an existing renderer
drop-in works. The port's copy of the JAX package's
``recon/render_scripts.py``: it writes the same files byte for byte.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_RENDERER = os.environ.get("P2C_RENDERER_BIN", "OSMesaRenderer")

# Distinct segment colors (RGB 0-255) for up to K=8 instances + unknown.
SEGMENT_COLORS = np.array(
    [
        [202, 51, 51],
        [51, 115, 202],
        [62, 168, 62],
        [221, 155, 38],
        [130, 64, 181],
        [36, 180, 180],
        [213, 91, 164],
        [120, 120, 120],
        [30, 30, 30],
    ],
    dtype=np.int32,
)


def write_labeled_pointcloud(
    path: str, points: np.ndarray, labels: np.ndarray
) -> None:
    """Write a colored .pts file (x y z r g b per line)."""
    colors = SEGMENT_COLORS[np.clip(labels, 0, len(SEGMENT_COLORS) - 1)]
    with open(path, "w") as f:
        for p, c in zip(points, colors):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


class RenderScriptWriter:
    """Accumulates renderer CLI commands into render.sh + image_files.sh
    (the reference writes these incrementally from open file handles,
    ``eval.py:659-692``)."""

    def __init__(self, dump_dir: str, renderer: str = DEFAULT_RENDERER):
        os.makedirs(dump_dir, exist_ok=True)
        self.dump_dir = dump_dir
        self.renderer = renderer
        self._render_lines: list[str] = []
        self._image_lines: list[str] = []

    def add_pointcloud(
        self,
        name: str,
        points: np.ndarray,
        pred_labels: np.ndarray,
        gt_labels: np.ndarray | None = None,
    ) -> None:
        """Equivalent of visualize_segmentation_pc[_bb_v2]
        (``data_utils.py:1744-2020``): emit pred (and gt) colored clouds and
        the render commands for each."""
        images = []
        for tag, labels in (("pred", pred_labels), ("gt", gt_labels)):
            if labels is None:
                continue
            pts_file = os.path.join(self.dump_dir, f"{name}_{tag}.pts")
            write_labeled_pointcloud(pts_file, points, labels)
            png = os.path.join(self.dump_dir, f"{name}_{tag}.png")
            self._render_lines.append(
                f"{self.renderer} -i {pts_file} -o {png} -t pointcloud"
            )
            images.append(png)
        self._image_lines.append(" ".join(images))

    def add_mesh(self, name: str, ply_path: str) -> None:
        png = os.path.join(self.dump_dir, f"{name}_mesh.png")
        self._render_lines.append(
            f"{self.renderer} -i {ply_path} -o {png} -t mesh"
        )
        self._image_lines.append(png)

    def finalize(self) -> tuple[str, str]:
        render_sh = os.path.join(self.dump_dir, "render.sh")
        image_sh = os.path.join(self.dump_dir, "image_files.sh")
        with open(render_sh, "w") as f:
            f.write("#!/bin/sh\n" + "\n".join(self._render_lines) + "\n")
        with open(image_sh, "w") as f:
            f.write("\n".join(self._image_lines) + "\n")
        os.chmod(render_sh, 0o755)
        return render_sh, image_sh
