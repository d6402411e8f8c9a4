"""Neighbour ops over a cloud whose points are sharded across ranks (the
port of ``point2cyl_tpu/parallel/point_sharding.py``).

Data parallelism shards the batch; this shards the points of one cloud,
so that N can grow past one device's memory. Each rank holds a
contiguous shard of the points (rank r holds global rows ``r * Nl`` to
``(r + 1) * Nl``). Queries stay resident; key shards travel around the
ring (:func:`collectives.ppermute`), and each rank folds the visiting
shard into a fixed-size running selection: the ``nsample`` smallest
in-radius indices for the ball query, the 3 nearest sources for 3-NN. A
gather of selected rows is a second ring pass. FPS keeps its running
minimum distances sharded and settles each step's global farthest point
in one collective.

At one rank (``mesh.world == 1``) there is no ring: FPS and the ball
queries call the single-device ops (``ops/cuda_fps.py``,
``ops/cuda_ballquery.py``: one kernel launch each on the card, no
collective), which give the ring's results index for index.

Selections are over global indices with the single-device ops' own
arithmetic (``ops/grouping.py``'s exact squared differences, the FPS
plain version's sum order) and tie-breaks (the lowest index), so every
index equals the single-device op's and every gathered value is a copy:
the ring moves the work, not the arithmetic. The ring is plain PyTorch,
as the JAX module is XLA code without a hand kernel, apart from each FPS
step (``csrc/fps_ring.cu``).

The functions take this rank's shard and a
:class:`~point2cyl_torch.parallel.mesh.Mesh`, where JAX's take a global
array and wrap a ``shard_map``.
"""

from __future__ import annotations

import torch

from point2cyl_torch.models.backbone import _pick
from point2cyl_torch.ops import cuda_ballquery, cuda_fps
from point2cyl_torch.ops.grouping import (ball_query_plain, radius_squared,
                                          square_distance_exact)
from point2cyl_torch.ops.sampling import (farthest_point_sample_plain, fps_ring_offers,
                                          fps_ring_step_plain, start_indices)
from point2cyl_torch.parallel import collectives


def _shard_offsets(mesh, nl: int):
    """The global offset of the key shard a rank holds at each ring step:
    its own first, then the previous rank's, and so on."""
    return [((mesh.rank - step) % mesh.world) * nl for step in range(mesh.world)]


def _ring(keys: torch.Tensor, mesh):
    """(offset, key shard) at each ring step; the shards travel one rank
    on between steps (none after the last)."""
    offsets = _shard_offsets(mesh, keys.shape[1])
    for step, off in enumerate(offsets):
        yield off, keys
        if step + 1 < len(offsets):
            keys = collectives.ppermute(keys, mesh)


# ---------------------------------------------------------------------------
# Ring gather: rows of a point-sharded array by global index
# ---------------------------------------------------------------------------


def _ring_gather_local(points: torch.Tensor, idx: torch.Tensor, mesh) -> torch.Tensor:
    """``points[b, idx]`` where ``points`` is this rank's (B, Nl, C) shard
    and ``idx`` any (B, ...) global indices: each visiting shard fills the
    rows it owns (exactly one shard owns each index)."""
    b, nl, c = points.shape
    flat = idx.reshape(b, -1).long()
    out = torch.zeros((*flat.shape, c), dtype=points.dtype, device=points.device)
    for off, keys in _ring(points, mesh):
        local = (flat - off).clamp(0, nl - 1)
        got = torch.gather(keys, 1, local[..., None].expand(-1, -1, c))
        owned = (flat >= off) & (flat < off + nl)
        out = torch.where(owned[..., None], got, out)
    return out.reshape(*idx.shape, c)


def _owned_gather(points: torch.Tensor, idx: torch.Tensor, mesh) -> torch.Tensor:
    """``points[b, idx]`` for (B, M) global indices that every rank holds
    alike, on every rank, in one all-gather of each rank's owned rows."""
    b, nl, c = points.shape
    off = mesh.rank * nl
    flat = idx.long()
    got = torch.gather(points, 1, (flat - off).clamp(0, nl - 1)[..., None].expand(-1, -1, c))
    owned = ((flat >= off) & (flat < off + nl)).to(points.dtype)[..., None]
    both = collectives.all_gather(torch.cat([got, owned], dim=-1)[None], mesh, dim=0)
    owner = both[..., -1].argmax(dim=0)  # (B, M)
    rows = torch.gather(both[..., :-1], 0, owner[None, ..., None].expand(1, -1, -1, c))
    return rows[0]


# ---------------------------------------------------------------------------
# Ring ball query
# ---------------------------------------------------------------------------


def _ring_ball_query_local(radius: float, nsample: int, xyz: torch.Tensor,
                           queries: torch.Tensor, mesh, *, impl: str = "auto") -> torch.Tensor:
    """``ops.grouping.ball_query_plain`` with resident queries (B, Sl, 3)
    and ring-rotating key shards (B, Nl, 3): per query the ``nsample``
    smallest global in-radius indices, ascending, a short row padded with
    its first, an empty one N - 1. The running state is the current
    smallest ``nsample`` (N standing for none), merged with each visiting
    shard's in-radius indices by one ``topk``; the keys are distinct
    global indices (equal only as the N of none), so the merge has no tie
    to break. At one rank, the single-device query
    (``ops.cuda_ballquery.ball_query``), picked by ``impl`` as
    ``BackboneConfig.ballquery_impl`` does."""
    if mesh.world == 1:
        return _pick(impl, cuda_ballquery.ball_query, ball_query_plain)(
            radius, nsample, xyz, queries)
    nl = xyz.shape[1]
    n = nl * mesh.world
    b, sl = queries.shape[:2]
    r2 = radius_squared(radius)
    best = torch.full((b, sl, nsample), n, dtype=torch.int64, device=xyz.device)
    cols = torch.arange(nl, device=xyz.device)
    for off, keys in _ring(xyz, mesh):
        inside = square_distance_exact(queries, keys) <= r2
        cand = torch.where(inside, cols + off, n)
        best = torch.topk(torch.cat([best, cand], dim=-1), nsample, dim=-1,
                          largest=False, sorted=True).values
    idx = torch.where(best == n, best[..., :1], best)
    return idx.clamp(max=n - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# Ring 3-NN
# ---------------------------------------------------------------------------


def _ring_three_nn_local(xyz_dst: torch.Tensor, xyz_src: torch.Tensor,
                         mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The global 3 nearest sources of each resident destination point:
    (dists, gidx), each (B, Dl, 3), ascending by (distance, global index),
    the single-device tie-break. Each visiting shard gives its own 3 by a
    stable sort (its columns ascend in global index); the merge orders the
    6 candidates by global index and then stably by distance. ``topk``
    promises nothing on ties, so sorts do the selecting."""
    b, dl = xyz_dst.shape[:2]
    best_d = torch.full((b, dl, 3), float("inf"), dtype=xyz_dst.dtype,
                        device=xyz_dst.device)
    best_i = torch.zeros((b, dl, 3), dtype=torch.int64, device=xyz_dst.device)
    for off, keys in _ring(xyz_src, mesh):
        d, i = torch.sort(square_distance_exact(xyz_dst, keys), dim=-1, stable=True)
        cd = torch.cat([best_d, d[..., :3]], dim=-1)
        ci = torch.cat([best_i, i[..., :3] + off], dim=-1)
        by_index = torch.argsort(ci, dim=-1, stable=True)
        cd, ci = torch.gather(cd, -1, by_index), torch.gather(ci, -1, by_index)
        best_d, pos = torch.sort(cd, dim=-1, stable=True)
        best_d, best_i = best_d[..., :3], torch.gather(ci, -1, pos[..., :3])
    return best_d, best_i


# ---------------------------------------------------------------------------
# Sharded FPS
# ---------------------------------------------------------------------------


def _fps_local(xyz: torch.Tensor, npoint: int, start_idx: int | torch.Tensor,
               mesh, *, impl: str = "auto") -> torch.Tensor:
    """Farthest point sampling over a point-sharded float32 cloud, equal
    to ``ops.sampling.farthest_point_sample_plain`` index for index: the
    (B, N) minimum distances live sharded as (B, Nl), with the plain
    version's sum order. Each step settles the global farthest point and
    its coordinates in one all-gather: every rank offers its local
    maximum as one int64 key, the distance's float32 bits (monotone for
    non-negative floats) over the complement of its global index (so the
    largest key is the largest distance at the lowest index, argmax's
    first occurrence), beside that point's coordinate bits
    (``ops.sampling.fps_ring_offers``). JAX's ring spends a psum, a pmax
    and a pmin a step on the same. At one rank there is no ring: the
    single-device FPS (``ops.cuda_fps.farthest_point_sample``: one launch,
    no collective); at more, :func:`_fps_ring`. ``impl`` picks the kernel
    or the plain version as ``BackboneConfig.fps_impl`` does. Returns (B,
    npoint) int32 global indices, alike on every rank."""
    if xyz.dtype != torch.float32:
        raise ValueError(f"sharded FPS takes float32 points, got {xyz.dtype}")
    if mesh.world == 1:
        return _pick(impl, cuda_fps.farthest_point_sample, farthest_point_sample_plain)(
            xyz, npoint, start_idx)
    return _fps_ring(xyz, npoint, start_idx, mesh, impl=impl)


def _fps_ring(xyz: torch.Tensor, npoint: int, start_idx: int | torch.Tensor,
              mesh, *, impl: str = "auto") -> torch.Tensor:
    """The ring of :func:`_fps_local` at any world size, one rank
    included: a step is one launch of the ring-step kernel
    (``ops.cuda_fps.fps_ring_step``) and one all-gather of the ranks'
    offers. Returns (B, npoint) int32 global indices."""
    step = _pick(impl, cuda_fps.fps_ring_step, fps_ring_step_plain)
    b, nl, _ = xyz.shape
    off = mesh.rank * nl
    farthest = start_indices(b, nl * mesh.world, start_idx, xyz.device)
    c = _owned_gather(xyz, farthest[:, None], mesh)[:, 0]  # (B, 3)
    every = fps_ring_offers(farthest, c)[None]  # the start, as a winning offer
    distance = torch.full((b, nl), 1e10, dtype=xyz.dtype, device=xyz.device)
    centroids = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        offer = step(xyz, every, distance, centroids, i, off)
        every = collectives.all_gather(offer[None], mesh, dim=0)  # (P, B, 4)
    return centroids.to(torch.int32)


# ---------------------------------------------------------------------------
# Sample and group
# ---------------------------------------------------------------------------


def _group_local(radius: float, nsample: int, xyz_s: torch.Tensor,
                 feats_s: torch.Tensor | None, q: torch.Tensor, mesh, *,
                 impl: str = "auto") -> torch.Tensor:
    """``ops.grouping.group_points`` of the resident centres ``q`` (B, Sl,
    3) over the sharded cloud: the ring ball query, then one ring gather
    of the [xyz | feats] rows, centred. At one rank without features, the
    single-device fused query and gather (``ops.cuda_ballquery.
    ball_query_grouped``, SA1's); ``impl`` picks the ball query as
    ``BackboneConfig.ballquery_impl`` does."""
    if mesh.world == 1 and feats_s is None:
        return _pick(impl, cuda_ballquery.ball_query_grouped,
                     cuda_ballquery.ball_query_grouped_plain)(radius, nsample, xyz_s, q)[1]
    idx = _ring_ball_query_local(radius, nsample, xyz_s, q, mesh, impl=impl)
    table = xyz_s if feats_s is None else torch.cat([xyz_s, feats_s], dim=-1)
    g = _ring_gather_local(table, idx, mesh)
    grouped = g[..., :3] - q[:, :, None, :]
    return grouped if feats_s is None else torch.cat([grouped, g[..., 3:]], dim=-1)


def _sample_and_group_local(radius: float, nsample: int, xyz_s: torch.Tensor,
                            feats_s: torch.Tensor | None, fps_full: torch.Tensor,
                            mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The body of :func:`sample_and_group_sharded`: the centres of the
    (B, npoint) global indices ``fps_full`` that every rank holds, this
    rank's slice of them (B, npoint / P, 3) and its grouped
    neighbourhoods."""
    spl = fps_full.shape[1] // mesh.world
    q = _owned_gather(xyz_s, fps_full, mesh)[:, mesh.rank * spl:(mesh.rank + 1) * spl]
    return q, _group_local(radius, nsample, xyz_s, feats_s, q, mesh)


# ---------------------------------------------------------------------------
# Public API: this rank's shards in, this rank's results out
# ---------------------------------------------------------------------------


def ball_query_sharded(mesh, radius: float, nsample: int, xyz: torch.Tensor,
                       new_xyz: torch.Tensor) -> torch.Tensor:
    """``ops.grouping.ball_query_plain`` with the points (B, Nl, 3) and
    the queries (B, Sl, 3) of this rank's shard; returns its queries'
    (B, Sl, nsample) int32 global indices."""
    return _ring_ball_query_local(radius, nsample, xyz, new_xyz, mesh)


def index_points_sharded(mesh, points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``ops.grouping.index_points`` of this rank's rows ``points`` (B, Nl,
    C) of a sharded table by its (B, ...) global indices ``idx``."""
    return _ring_gather_local(points, idx, mesh)


def three_nn_interpolate_sharded(mesh, xyz_dst: torch.Tensor, xyz_src: torch.Tensor,
                                 feats_src: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``ops.grouping.three_nn_interpolate_plain`` with every point axis
    sharded: ring pass 1 finds the global 3-NN, ring pass 2 gathers their
    feature rows, and the blend is the plain version's, on this rank's
    destination points."""
    d, gidx = _ring_three_nn_local(xyz_dst, xyz_src, mesh)
    g = _ring_gather_local(feats_src, gidx, mesh)  # (B, Dl, 3, C)
    recip = 1.0 / (d + eps)
    w = (recip / (recip[..., 0] + recip[..., 1] + recip[..., 2])[..., None])[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]


def farthest_point_sample_sharded(mesh, xyz: torch.Tensor, npoint: int,
                                  start_idx: int | torch.Tensor = 0) -> torch.Tensor:
    """Exact FPS over the sharded cloud (this rank's (B, Nl, 3)); returns
    (B, npoint) int32 global indices, alike on every rank."""
    return _fps_local(xyz, npoint, start_idx, mesh)


def sample_and_group_sharded(mesh, radius: float, nsample: int, xyz: torch.Tensor,
                             feats: torch.Tensor | None,
                             fps_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``ops.grouping.sample_and_group`` across the sharded cloud (this
    rank's xyz (B, Nl, 3) and feats (B, Nl, C) or None) from (B, npoint)
    global FPS indices that every rank holds: this rank's slice of the
    centres (B, npoint / P, 3) and its [xyz - centre | feats] groups."""
    if fps_idx.shape[1] % mesh.world:
        raise ValueError(f"npoint {fps_idx.shape[1]} must divide over {mesh.world} ranks")
    return _sample_and_group_local(radius, nsample, xyz, feats, fps_idx, mesh)
