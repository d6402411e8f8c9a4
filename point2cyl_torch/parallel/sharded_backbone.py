"""The backbone's eval forward with one cloud's points sharded across
ranks (the port of ``point2cyl_tpu/parallel/sharded_backbone.py``), so a
cloud larger than one device's memory can be decomposed.

The stages split as JAX's do:

- **SA1**, the only set abstraction whose memory grows with N: the ring
  FPS, ring ball query and ring gather of ``parallel/point_sharding.py``
  (exact selection, index for index the single-device ops'), then SA1's
  own shared MLP and neighbourhood max on this rank's slice of the
  centres. At one rank, the single-device FPS and fused ball query
  instead of the ring (one launch each on the card).
- **The middle of the pyramid** (SA2, group-all, the feature
  propagations above FP1): after SA1 the cloud is ``sa_npoints[0]``
  centres, so one all-gather brings them and their features to every
  rank, and each runs these stages replicated through the model's own
  modules, whose kernels run on the card.
- **FP1, FC and the heads**, per point again: each rank interpolates from
  the replicated centres onto its resident shard (FP1's 3-NN kernel) and
  runs the per-point layers there; the heads stay sharded over N.

Memory per rank is O(N / P + npoint). Eval mode only, as in JAX.

:func:`backbone_apply_point_sharded` runs the forward eagerly;
:class:`ShardedForward` runs it as one captured program on the card (JAX
runs it as one XLA program): the ring FPS's steps, a kernel launch and
an all-gather each (one FPS launch at one rank), and every other stage
replay from one CUDA graph.
"""

from __future__ import annotations

import torch

from point2cyl_torch.core.config import BackboneConfig
from point2cyl_torch.core.graphs import step_graphs
from point2cyl_torch.models.backbone import Backbone
from point2cyl_torch.parallel import collectives
from point2cyl_torch.parallel.point_sharding import _fps_local, _group_local, _owned_gather


@torch.no_grad()
def backbone_apply_point_sharded(
    mesh,
    model: Backbone,
    cfg: BackboneConfig,
    pts: torch.Tensor,
    feats: torch.Tensor | None = None,
) -> list[torch.Tensor]:
    """``model(pts_global)`` in eval mode, from this rank's shard ``pts``
    (B, N / P, 3) of each cloud (rank r holds rows r * N / P onwards).
    Returns this rank's rows (B, N / P, out) of each head of
    ``cfg.output_sizes``. ``cfg.sa_npoints[0]`` must divide over the
    ranks. The port's backbone takes no input features, so ``feats``
    (JAX's optional per-point features) must be None.
    """
    if feats is not None:
        raise ValueError("the port's Backbone takes points only; feats must be None")
    np0 = cfg.sa_npoints[0]
    if np0 % mesh.world:
        raise ValueError(f"sa_npoints[0] {np0} must divide over {mesh.world} ranks")
    if model.training:
        raise ValueError("the point-sharded forward is eval mode only; call model.eval()")
    num_sa = len(cfg.sa_npoints)

    # SA1 on the ring: the eval forward's FPS starts at point 0
    fps_idx = _fps_local(pts, np0, 0, mesh, impl=cfg.fps_impl)
    centres = _owned_gather(pts, fps_idx, mesh)  # (B, np0, 3), alike on every rank
    spl = np0 // mesh.world
    q = centres[:, mesh.rank * spl:(mesh.rank + 1) * spl]
    grouped = _group_local(cfg.sa_radii[0], cfg.sa_nsamples[0], pts, None, q, mesh,
                           impl=cfg.ballquery_impl)
    f = collectives.all_gather(model.sa1.mlp(grouped).amax(dim=2), mesh, dim=1)

    # the middle of the pyramid, replicated
    xyz = centres
    skips = [(pts, None), (xyz, f)]
    for i in range(1, num_sa):
        xyz, f = getattr(model, f"sa{i + 1}")(xyz, f)
        skips.append((xyz, f))
    xyz_up, feats_up = getattr(model, f"sa{num_sa + 1}")(xyz, f)

    # the feature propagations, the last (FP1) onto this rank's shard
    for i in range(num_sa + 1):
        dst_xyz, dst_f = skips[-(i + 1)]
        feats_up = getattr(model, f"fp{num_sa + 1 - i}")(dst_xyz, xyz_up, dst_f, feats_up)
        xyz_up = dst_xyz
    h = torch.relu(model.bn1(model.fc1(feats_up)))
    return [head(h) for head in model.fc2]


class ShardedForward:
    """:func:`backbone_apply_point_sharded` of ``model`` over ``mesh`` as
    one captured program: through :func:`~point2cyl_torch.core.graphs.step_graphs`,
    the first call with a shape runs eagerly (it also creates the NCCL
    communicator), the second captures the forward, collectives included,
    in ``thread_local`` mode and replays it, and later calls copy their
    points in and replay. Over a host-staged mesh (``make_mesh(
    host_staged=True)``) and on the CPU every call runs eagerly, and
    ``graphs.eager_because`` says why; :func:`backbone_apply_point_sharded`
    is the eager path on the card. A failed capture or replay raises. Eval
    mode only."""

    def __init__(self, mesh, model: Backbone, cfg: BackboneConfig):
        self.mesh = mesh
        self.model = model
        self.cfg = cfg
        self.graphs = step_graphs(mesh.device, True, mesh)

    def __call__(self, pts: torch.Tensor) -> list[torch.Tensor]:
        """This rank's rows (B, N / P, out) of each head, from its shard
        ``pts`` (B, N / P, 3) on the mesh's device; fresh tensors at every
        call."""
        if self.model.training:
            raise ValueError("the point-sharded forward is eval mode only; call model.eval()")
        if pts.device != self.mesh.device:
            raise ValueError(f"points on {pts.device}, the mesh's device is {self.mesh.device}")
        heads = self.graphs(self._forward, {"pts": pts})
        return [h.clone() for h in heads]

    def _forward(self, inputs: dict[str, torch.Tensor], generator) -> list[torch.Tensor]:
        return backbone_apply_point_sharded(self.mesh, self.model, self.cfg, inputs["pts"])
