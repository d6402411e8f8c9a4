"""Bucketed inference session over a port artifact.

Requests of any batch size are served by chunking to the largest bucket
and zero-padding the tail chunk up to the smallest bucket that fits, as
the JAX session does; the padding rows are sliced off before returning.
At inference the backbone and the sketch encoder are strictly per-sample
(BatchNorm runs on stored statistics), so padding rows cannot perturb
real rows.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from point2cyl_torch.core.config import BackboneConfig
from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.models.backbone import build_backbone
from point2cyl_torch.models.implicit import PointNetEncoder
from point2cyl_torch.serve.export import (
    LoadedArtifact,
    _backbone_forward,
    head_output_sizes,
    load_artifact,
    unpack_decomposition,
)


class InferenceSession:
    """Load once, serve many.

    >>> sess = InferenceSession("model.p2ct")     # on the card
    >>> out = sess.decompose(points)               # (n, num_points, 3) any n
    >>> out["axes"].shape                          # (n, K, 3)
    >>> out["latents"].shape                       # (n, K, 256), with_latents
    """

    def __init__(self, artifact: str | LoadedArtifact,
                 device: str | torch.device | None = None):
        """``device``: default the card; ``"cpu"`` only on request."""
        self.device = resolve_device(device)
        art = load_artifact(artifact) if isinstance(artifact, str) else artifact
        self.meta = art.meta
        if self.meta.get("backbone_config"):
            cfg = BackboneConfig.from_dict(self.meta["backbone_config"])
        else:
            k = int(self.meta["k"])
            cfg = BackboneConfig(
                num_points=int(self.meta["num_points"]),
                output_sizes=head_output_sizes(
                    k, self.meta["pred_seg"], self.meta["pred_normal"],
                    self.meta["pred_bb"],
                ),
            )
        self.model = build_backbone(cfg, state_dict=art.weights, device=self.device)
        self.encoder = None
        if self.meta.get("with_latents"):
            self.encoder = PointNetEncoder(int(self.meta["latent_size"]), 2,
                                           with_normals=True)
            self.encoder.load_state_dict(art.encoder_weights, strict=True)
            self.encoder = self.encoder.to(self.device).eval()
        self._buckets = sorted(int(b) for b in self.meta["buckets"])
        self.stats = {"requests": 0, "clouds": 0, "padded": 0}

    @property
    def num_points(self) -> int:
        return int(self.meta["num_points"])

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _run_raw(self, pts: np.ndarray, keys: tuple[str, ...],
                 decompose: bool = False) -> dict[str, np.ndarray]:
        """Run one request of any batch size; fetch ``keys`` to the host."""
        n = pts.shape[0]
        if pts.shape[1:] != (self.num_points, 3):
            raise ValueError(f"expected (n, {self.num_points}, 3), got {pts.shape}")
        meta = self.meta
        max_b = self._buckets[-1]
        chunks = []
        i = 0
        with torch.inference_mode():
            while i < n:
                take = min(max_b, n - i)
                b = self._bucket_for(take)
                chunk = pts[i:i + take]
                if take < b:
                    pad = np.zeros((b - take, self.num_points, 3), pts.dtype)
                    chunk = np.concatenate([chunk, pad], axis=0)
                    self.stats["padded"] += b - take
                x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
                out = _backbone_forward(
                    self.model, x, k=int(meta["k"]),
                    pred_seg=bool(meta["pred_seg"]), pred_bb=bool(meta["pred_bb"]),
                    num_sk_points=meta["num_sk_points"] if decompose else None,
                    encoder=self.encoder if decompose else None,
                )
                chunks.append({key: out[key].cpu().numpy()[:take] for key in keys})
                i += take
        self.stats["requests"] += 1
        self.stats["clouds"] += n
        return {key: np.concatenate([c[key] for c in chunks], axis=0) for key in keys}

    def predict(self, points: Any, assemble: bool = True) -> dict:
        """Per-point heads for a batch of clouds: raw (``x_raw``, ``w_raw``)
        or assembled (unit ``normals``, softmaxed ``w`` and, with the bb
        head, ``w_barrel``/``w_base``)."""
        pts = np.asarray(points, np.float32)
        squeeze = pts.ndim == 2
        if squeeze:
            pts = pts[None]
        if not assemble:
            keys = ("x_raw", "w_raw")
        else:
            seg_bb = bool(self.meta["pred_seg"]) and bool(self.meta["pred_bb"])
            keys = ("normals", "w") + (("w_barrel", "w_base") if seg_bb else ())
        out = self._run_raw(pts, keys)
        if squeeze:
            out = {k: v[0] for k, v in out.items()}
        return out

    def decompose(self, points: Any, include_labels: bool = True,
                  exact_latents: bool = False) -> dict:
        """Extrusion-cylinder decompositions: per cloud, K slots of axes,
        centers, extents, scales and ``found``, with a ``with_latents``
        artifact each slot's sketch ``latents`` (K, L), and (by default)
        int8 per-point ``labels`` / ``bb_labels``. The O(K) outputs come
        to the host as one packed tensor: the geometry unpacks bitwise,
        the latents at float16 precision; ``exact_latents=True`` fetches
        the float32 arrays instead."""
        if not self.meta.get("decomposition"):
            raise ValueError(
                "artifact was exported without decomposition outputs "
                "(export with num_sk_points)"
            )
        pts = np.asarray(points, np.float32)
        squeeze = pts.ndim == 2
        if squeeze:
            pts = pts[None]
        with_latents = self.encoder is not None
        packed = not exact_latents
        keys = (("packed",) if packed else
                ("axes", "centers", "extents", "scales", "found")
                + (("latents",) if with_latents else ()))
        if include_labels:
            keys += ("labels", "bb_labels")
        out = self._run_raw(pts, keys, decompose=True)
        if packed:
            out.update(unpack_decomposition(out.pop("packed"), with_latents))
        if squeeze:
            out = {k: v[0] for k, v in out.items()}
        return out

    def benchmark(self, batch: int | None = None, iters: int = 20) -> dict:
        """Steady-state decompositions per second through :meth:`decompose`
        (host arrays in and out, transfers included) at one batch size,
        timed with CUDA events after one warm-up request."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark times the card with CUDA events; the "
                               "session is not on a CUDA device")
        b = batch or self._buckets[-1]
        pts = np.random.default_rng(0).standard_normal(
            (b, self.num_points, 3), dtype=np.float32)
        self.decompose(pts)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            self.decompose(pts)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        return {"batch": b, "iters": iters, "ms_per_request": ms,
                "decompositions_per_sec": b * 1000.0 / ms,
                "device": torch.cuda.get_device_name(self.device)}
