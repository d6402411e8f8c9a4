"""Bucketed inference session over a port artifact.

Requests of any batch size are served by chunking to the largest bucket
and zero-padding the tail chunk up to the smallest bucket that fits, as
the JAX session does; the padding rows are sliced off before returning.
At inference the backbone and the sketch encoder are strictly per-sample
(BatchNorm runs on stored statistics), so padding rows cannot perturb
real rows.

The replicas served are folded copies of ``session.model`` and
``session.encoder`` (``models/folded.py``; the first device's are
``session.served`` and ``session.served_encoder``): each float32 dense
layer with its eval BN and ReLU is one GEMM with the bias and ReLU in
its epilogue, its weights folded once at load; a model whose dense
layers compute in bf16 or fp16 is served as loaded. ``stats["folded_layers"]``
and ``stats["unfolded_layers"]`` count one replica's layers of each
kind.

With ``devices=`` the session holds one replica of the models on each
device and deals the chunks out round-robin, as the JAX session does
(``point2cyl_tpu/serve/session.py:41-95, 150-163``): every chunk is
dispatched before any result is fetched, so chunks on different cards
overlap, and the cursor persists across requests, so a stream of
one-chunk requests spreads over every device.

On the card each (replica, bucket, decompose, fetched keys) runs as a
captured CUDA graph (``core/graphs.py``), the counterpart of the JAX
session's one jitted program per bucket with the output selection jitted
in: the first chunk of a kind runs eagerly, the second captures, later
ones replay. A replay's outputs are the graph's own buffers, so each
chunk's selected outputs are copied to pinned host memory on the
replica's stream right after its replay, before the next chunk can
overwrite them, and the request waits for the copies once at its end.
``graph=False`` runs every chunk eagerly.

Under a profiler a request is a ``p2c.session.request`` span
(``core/profiling.py``) holding, per chunk, ``p2c.session.stage`` (slice,
padding, the pageable copy to the card), ``p2c.session.launch`` (the
graph's input copy and replay launch) and ``p2c.session.fetch`` (the
copies to pinned memory), then ``p2c.session.wait`` (the closing
synchronise) and ``p2c.session.assemble`` (concatenation, unpacking).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from point2cyl_torch.core.config import BackboneConfig
from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.core.graphs import StepGraphs
from point2cyl_torch.core.profiling import span
from point2cyl_torch.models.backbone import build_backbone
from point2cyl_torch.models.folded import fold_for_serving, layer_counts
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
                 device: str | torch.device | None = None,
                 devices: list[str | torch.device] | None = None,
                 graph: bool = True):
        """``device``: default the card; ``"cpu"`` only on request.
        ``devices``: serve over these instead, one replica each.
        ``graph=False``: run every chunk eagerly on the card too."""
        if devices is not None and device is not None:
            raise ValueError("pass device= or devices=, not both")
        self.devices = ([resolve_device(d) for d in devices] if devices
                        else [resolve_device(device)])
        self.device = self.devices[0]
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
        models = [build_backbone(cfg, state_dict=art.weights, device=d)
                  for d in self.devices]
        encoders = [None] * len(self.devices)
        if self.meta.get("with_latents"):
            for i, d in enumerate(self.devices):
                enc = PointNetEncoder(int(self.meta["latent_size"]), 2, with_normals=True)
                enc.load_state_dict(art.encoder_weights, strict=True)
                encoders[i] = enc.to(d).eval()
        self.model, self.encoder = models[0], encoders[0]
        self._models = [fold_for_serving(m) for m in models]
        self._encoders = [None if e is None else fold_for_serving(e) for e in encoders]
        self.served, self.served_encoder = self._models[0], self._encoders[0]
        counts = [layer_counts(net) for net in (self.served, self.served_encoder)
                  if net is not None]
        self._graphs = [StepGraphs(d, enabled=graph) for d in self.devices]
        self._buckets = sorted(int(b) for b in self.meta["buckets"])
        self._next_dev = 0  # the round-robin cursor, kept across requests
        self.stats = {"requests": 0, "clouds": 0, "padded": 0,
                      "folded_layers": sum(c[0] for c in counts),
                      "unfolded_layers": sum(c[1] for c in counts)}

    @property
    def num_points(self) -> int:
        return int(self.meta["num_points"])

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _forward(self, d: int, keys: tuple[str, ...], decompose: bool):
        """Replica ``d``'s step for one chunk: the outputs in ``keys``."""
        meta = self.meta

        def step(inputs: dict, _generator) -> dict[str, torch.Tensor]:
            out = _backbone_forward(
                self._models[d], inputs["points"], k=int(meta["k"]),
                pred_seg=bool(meta["pred_seg"]), pred_bb=bool(meta["pred_bb"]),
                num_sk_points=meta["num_sk_points"] if decompose else None,
                encoder=self._encoders[d] if decompose else None,
            )
            return {key: out[key] for key in keys}

        return step

    def _run_raw(self, points: Any, keys: tuple[str, ...],
                 decompose: bool = False) -> dict[str, np.ndarray]:
        """Run one request of any batch size (one cloud: its leading axis
        dropped); fetch ``keys`` to the host, a packed decomposition
        unpacked."""
        with span("session.request"):
            return self._request(points, keys, decompose)

    def _request(self, points: Any, keys: tuple[str, ...],
                 decompose: bool) -> dict[str, np.ndarray]:
        pts = np.asarray(points, np.float32)
        squeeze = pts.ndim == 2
        if squeeze:
            pts = pts[None]
        n = pts.shape[0]
        if pts.shape[1:] != (self.num_points, 3):
            raise ValueError(f"expected (n, {self.num_points}, 3), got {pts.shape}")
        max_b = self._buckets[-1]
        fetched = []  # each chunk's selected outputs, on the host once copied
        used = set()
        i = 0
        with torch.inference_mode():
            while i < n:
                with span("session.stage"):
                    take = min(max_b, n - i)
                    b = self._bucket_for(take)
                    chunk = pts[i:i + take]
                    if take < b:
                        pad = np.zeros((b - take, self.num_points, 3), pts.dtype)
                        chunk = np.concatenate([chunk, pad], axis=0)
                        self.stats["padded"] += b - take
                    d = self._next_dev
                    self._next_dev = (d + 1) % len(self.devices)
                    used.add(d)
                    x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.devices[d])
                with span("session.launch"):
                    out = self._graphs[d](self._forward(d, keys, decompose), {"points": x},
                                          static=(decompose, keys))
                with span("session.fetch"):
                    fetched.append({key: _to_host(out[key][:take]) for key in keys})
                i += take
            with span("session.wait"):
                for d in used:
                    if self.devices[d].type == "cuda":
                        torch.cuda.synchronize(self.devices[d])
        with span("session.assemble"):
            out = {key: np.concatenate([c[key].numpy() for c in fetched], axis=0)
                   for key in keys}
            if "packed" in out:
                out.update(unpack_decomposition(out.pop("packed"), self.encoder is not None))
            if squeeze:
                out = {k: v[0] for k, v in out.items()}
        self.stats["requests"] += 1
        self.stats["clouds"] += n
        return out

    def predict(self, points: Any, assemble: bool = True) -> dict:
        """Per-point heads for a batch of clouds: raw (``x_raw``, ``w_raw``)
        or assembled (unit ``normals``, softmaxed ``w`` and, with the bb
        head, ``w_barrel``/``w_base``)."""
        if not assemble:
            keys = ("x_raw", "w_raw")
        else:
            seg_bb = bool(self.meta["pred_seg"]) and bool(self.meta["pred_bb"])
            keys = ("normals", "w") + (("w_barrel", "w_base") if seg_bb else ())
        return self._run_raw(points, keys)

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
        keys = (("packed",) if not exact_latents else
                ("axes", "centers", "extents", "scales", "found")
                + (("latents",) if self.encoder is not None else ()))
        if include_labels:
            keys += ("labels", "bb_labels")
        return self._run_raw(points, keys, decompose=True)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: from the card copied into pinned memory,
    enqueued on the current stream without waiting (the caller
    synchronises before reading); a CPU tensor as it is."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)
