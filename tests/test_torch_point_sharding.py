"""The port's point sharding (point2cyl_torch.parallel.point_sharding and
sharded_backbone) on the CPU over gloo, at P = 2 and 4 ranks.

The ranks of both sizes are started once for the module
(``tests/torch_rank_worker.py``); each holds its contiguous shard of every
cloud and runs the ring ops and the point-sharded backbone forward. Their
results, joined over the ranks, are held against the port's
single-device ops (indices and gathered values bit for bit: the ring
keeps their arithmetic) and against JAX's ring ops on a ``make_mesh(P)``
of the virtual CPU devices (``tests/test_point_sharding.py``'s cases and
tolerances), computed here while the ranks run.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from point2cyl_torch.core.config import BackboneConfig as TorchConfig
from point2cyl_torch.core.convert import backbone_state_dict_from_jax
from point2cyl_torch.models.backbone import Backbone as TorchBackbone
from point2cyl_torch.ops.grouping import (ball_query_plain, index_points,
                                          sample_and_group, three_nn_interpolate_plain,
                                          three_nn_weights_plain)
from point2cyl_torch.ops import cuda_fps
from point2cyl_torch.ops.sampling import (NAN_BITS, farthest_point_sample_plain,
                                          fps_ring_offers, fps_ring_step_plain)
from point2cyl_torch.parallel import point_sharding as torch_ps
from point2cyl_torch.parallel.mesh import make_mesh as torch_make_mesh
from point2cyl_torch.parallel.sharded_backbone import (ShardedForward,
                                                       backbone_apply_point_sharded)
from point2cyl_tpu.core.config import BackboneConfig
from point2cyl_tpu.models.backbone import Backbone
from point2cyl_tpu.ops.sampling import farthest_point_sample as jax_fps
from point2cyl_tpu.parallel import point_sharding as ps
from point2cyl_tpu.parallel.mesh import make_mesh
from point2cyl_tpu.parallel.sharded_backbone import backbone_apply_point_sharded as jax_apply
from test_torch_parallel import finish_ranks, start_ranks

SIZES = (2, 4)
CFG = BackboneConfig(  # tests/test_point_sharding.py's
    num_points=256, sa_npoints=(64, 16), sa_radii=(0.4, 0.8), sa_nsamples=(16, 8),
    sa_mlps=((8, 16), (16, 32)), sa_global_mlp=(32, 32), fp_mlps=((16,), (16,), (8, 8)),
    fc_width=8, output_sizes=(3, 4), approx_neighbors=False,
)
FPS_START = 5


def cloud(rng, b, n):
    return rng.uniform(-1.0, 1.0, (b, n, 3)).astype(np.float32)


def clear_of_radius(q: np.ndarray, xyz: np.ndarray, radius: float) -> bool:
    """No query-point pair within 1e-5 of the squared radius (the JAX
    ring measures distances by expansion, the port by differences)."""
    d2 = ((q.astype(np.float64)[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    return bool(np.abs(d2 - radius * radius).min() > 1e-5)


def make_inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    xyz = cloud(rng, 2, 256)
    q = cloud(rng, 2, 64)
    q[:, :32] = xyz[:, ::8][:, :32]  # queries on points: no empty row there
    src = cloud(rng, 2, 64)
    src[:, 32:40] = src[:, 0:8]  # duplicated sources in other shards: distance ties
    src[:, 60:64] = src[:, 8:12]
    sag_xyz = cloud(rng, 2, 256)
    inp = {
        "bq_xyz": xyz, "bq_q": q,
        "g_pts": rng.normal(size=(2, 128, 5)).astype(np.float32),
        "g_idx": rng.integers(0, 128, (2, 64, 7)).astype(np.int32),
        "nn_dst": cloud(rng, 2, 256), "nn_src": src,
        "nn_feats": rng.normal(size=(2, 64, 9)).astype(np.float32),
        "fps_xyz": cloud(rng, 3, 512), "fps_start": FPS_START,
        "fps_dup_xyz": np.tile(cloud(rng, 2, 128), (1, 4, 1)),
        "sag_xyz": sag_xyz, "sag_feats": rng.normal(size=(2, 256, 6)).astype(np.float32),
        "pts": cloud(rng, 2, 256),
    }
    inp["sag_fps"] = farthest_point_sample_plain(torch.from_numpy(sag_xyz), 64).numpy()
    assert clear_of_radius(q, xyz, 0.4)
    centres = np.take_along_axis(sag_xyz, inp["sag_fps"][..., None].astype(np.int64), 1)
    assert clear_of_radius(centres, sag_xyz, 0.4)
    return inp


def jax_references(p: int, inp: dict, variables) -> dict:
    """JAX's ring ops and point-sharded backbone on ``make_mesh(p)``."""
    mesh = make_mesh(p)
    j = {k: jax.numpy.asarray(v) for k, v in inp.items() if isinstance(v, np.ndarray)}
    three_nn = jax.shard_map(
        partial(ps._ring_three_nn_local, axis="data", n_shards=p), mesh=mesh,
        in_specs=(P(None, "data", None), P(None, "data", None)),
        out_specs=(P(None, "data", None), P(None, "data", None)))
    out = {
        "ball_query": ps.ball_query_sharded(mesh, 0.4, 16, j["bq_xyz"], j["bq_q"]),
        "gather": ps.index_points_sharded(mesh, j["g_pts"], j["g_idx"]),
        "three_nn_idx": three_nn(j["nn_dst"], j["nn_src"])[1],
        "three_nn": ps.three_nn_interpolate_sharded(mesh, j["nn_dst"], j["nn_src"],
                                                    j["nn_feats"]),
        "fps": ps.farthest_point_sample_sharded(mesh, j["fps_xyz"], 64, start_idx=FPS_START),
        "fps_dup": ps.farthest_point_sample_sharded(mesh, j["fps_dup_xyz"], 64),
        # jitted: shard_map's loops run op by op otherwise (about 20x slower)
        "sag": jax.jit(partial(ps.sample_and_group_sharded, mesh, 0.4, 16))(
            j["sag_xyz"], j["sag_feats"], j["sag_fps"]),
        "sag_nofeats": jax.jit(lambda x, f: ps.sample_and_group_sharded(
            mesh, 0.4, 16, x, None, f))(j["sag_xyz"], j["sag_fps"]),
        "backbone": jax.jit(partial(jax_apply, mesh, cfg=CFG))(variables, pts=j["pts"]),
    }
    return jax.tree_util.tree_map(np.asarray, jax.device_get(out))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Start the ranks of both sizes, compute the references meanwhile, and
    return ({P: the ranks' results}, inputs, {P: JAX's}, the port's
    single-device backbone heads, the port model)."""
    inp = make_inputs()
    variables = jax.jit(partial(Backbone(CFG).init, train=False))(
        {"params": jax.random.key(13)}, jax.numpy.asarray(inp["pts"]))
    tcfg = TorchConfig.from_dict(dataclasses.asdict(CFG))
    state = backbone_state_dict_from_jax(jax.device_get(variables["params"]),
                                         jax.device_get(variables["batch_stats"]))
    payload = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in inp.items()}
    payload.update(cfg=tcfg, state=state)
    roots = {p: str(tmp_path_factory.mktemp(f"p{p}")) for p in SIZES}
    procs = {p: start_ranks("sharding", p, roots[p], payload) for p in SIZES}
    try:
        jax_refs = {p: jax_references(p, inp, variables) for p in SIZES}
        one = make_mesh(1)
        jax_refs[1] = {key: np.asarray(ps.farthest_point_sample_sharded(
            one, jax.numpy.asarray(inp[key + "_xyz"]), 64, start_idx=start))
            for key, start in (("fps", FPS_START), ("fps_dup", 0))}
        model = TorchBackbone(tcfg)
        model.load_state_dict(state)
        model.eval()
        with torch.no_grad():
            heads = model(payload["pts"])
    finally:
        results = {p: finish_ranks(procs[p], roots[p]) for p in SIZES}
    return results, payload, jax_refs, heads, model


def joined(results: list[dict], key: str, dim: int = 1) -> torch.Tensor:
    """One result of every rank, concatenated over its point axis."""
    return torch.cat([r[key] for r in results], dim=dim)


@pytest.mark.parametrize("p", SIZES)
def test_collectives(sharded, p):
    """Rank r holds (r, -r, 1): every rank gets the sums, maxima, minima
    and the rows in rank order, and the previous rank's row from the
    ring."""
    results = sharded[0][p]
    ranks = torch.arange(p, dtype=torch.float32)
    rows = torch.stack([ranks, -ranks, torch.ones(p)], dim=1)
    for r, got in enumerate(results):
        torch.testing.assert_close(got["psum"], rows.sum(0), rtol=0, atol=0)
        torch.testing.assert_close(got["pmax"], rows.amax(0), rtol=0, atol=0)
        torch.testing.assert_close(got["pmin"], rows.amin(0), rtol=0, atol=0)
        torch.testing.assert_close(got["all_gather"], rows, rtol=0, atol=0)
        torch.testing.assert_close(got["ppermute"], rows[(r - 1) % p], rtol=0, atol=0)


@pytest.mark.parametrize("p", SIZES)
def test_ring_ball_query(sharded, p):
    """Per query the 16 smallest in-radius global indices, bit-equal to the
    single-device ball query and, on every non-empty row, to JAX's ring
    (an empty row gives N - 1 in the port, N in JAX's ring)."""
    results, inp, jax_refs, _, _ = sharded
    got = joined(results[p], "ball_query")
    want = ball_query_plain(0.4, 16, inp["bq_xyz"], inp["bq_q"])
    assert got.dtype == torch.int32 and got.shape == (2, 64, 16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jax_idx = jax_refs[p]["ball_query"]
    live = jax_idx[..., 0] < 256
    assert live[:, :32].all()
    np.testing.assert_array_equal(got.numpy()[live], jax_idx[live])


@pytest.mark.parametrize("p", SIZES)
def test_ring_gather(sharded, p):
    results, inp, jax_refs, _, _ = sharded
    got = joined(results[p], "gather")
    torch.testing.assert_close(got, index_points(inp["g_pts"], inp["g_idx"]), rtol=0, atol=0)
    np.testing.assert_array_equal(got.numpy(), jax_refs[p]["gather"])


@pytest.mark.parametrize("p", SIZES)
def test_ring_three_nn_with_distance_ties(sharded, p):
    """Sources duplicated across shards tie in distance: the ring's global
    3-NN keeps the lowest index, as the single-device op and JAX's ring
    do, and the interpolation is the single-device op's bit for bit
    (JAX's within rtol 2e-4, atol 1e-5)."""
    results, inp, jax_refs, _, _ = sharded
    idx = joined(results[p], "three_nn_idx")
    want_idx, _ = three_nn_weights_plain(inp["nn_dst"], inp["nn_src"])
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    np.testing.assert_array_equal(idx.numpy(), jax_refs[p]["three_nn_idx"])
    tied = np.isin(want_idx.numpy(), [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11])
    assert tied.any()  # the duplicated sources are among the nearest somewhere
    got = joined(results[p], "three_nn")
    want = three_nn_interpolate_plain(inp["nn_dst"], inp["nn_src"], inp["nn_feats"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), jax_refs[p]["three_nn"], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("p", SIZES)
def test_sharded_fps(sharded, p):
    """Every rank holds the same 64 global indices: the single-device
    FPS's from the same start, and JAX's sharded FPS's."""
    results, inp, jax_refs, _, _ = sharded
    want = farthest_point_sample_plain(inp["fps_xyz"], 64, FPS_START)
    for r in results[p]:
        torch.testing.assert_close(r["fps"], want, rtol=0, atol=0)
    np.testing.assert_array_equal(want.numpy(), jax_refs[p]["fps"])


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("with_feats", [True, False], ids=["feats", "no_feats"])
def test_sharded_sample_and_group(sharded, p, with_feats):
    """Each rank's slice of the centres and its [xyz - centre | feats]
    groups, joined, equal the single-device ``sample_and_group`` and
    JAX's sharded one bit for bit."""
    results, inp, jax_refs, _, _ = sharded
    key = "sag" if with_feats else "sag_nofeats"
    q = torch.cat([r[key][0] for r in results[p]], dim=1)
    g = torch.cat([r[key][1] for r in results[p]], dim=1)
    feats = inp["sag_feats"] if with_feats else None
    want_q, want_g = sample_and_group(0.4, 16, inp["sag_xyz"], feats, inp["sag_fps"])
    torch.testing.assert_close(q, want_q, rtol=0, atol=0)
    torch.testing.assert_close(g, want_g, rtol=0, atol=0)
    np.testing.assert_array_equal(q.numpy(), jax_refs[p][key][0])
    np.testing.assert_array_equal(g.numpy(), jax_refs[p][key][1])


@pytest.mark.parametrize("p", SIZES)
def test_point_sharded_backbone(sharded, p):
    """The eval forward with the points sharded: each rank's rows of the
    heads, joined, match the single-device forward and JAX's
    ``backbone_apply_point_sharded`` within rtol 2e-4, atol 1e-5
    (``tests/test_point_sharding.py:140-162``), and stay sharded."""
    results, _, jax_refs, heads, _ = sharded
    for i, want in enumerate(heads):
        parts = [r["backbone"][i] for r in results[p]]
        assert all(part.shape == (2, 256 // p, want.shape[-1]) for part in parts)
        got = torch.cat(parts, dim=1)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), jax_refs[p]["backbone"][i], rtol=2e-4,
                                   atol=1e-5)


def test_point_sharded_backbone_on_one_rank_is_the_forward(sharded):
    """Without a process group (one rank, no collectives) the sharded
    forward is ``Backbone.forward`` bit for bit."""
    _, inp, _, heads, model = sharded
    got = backbone_apply_point_sharded(torch_make_mesh(devices=["cpu"]), model,
                                       model.cfg, inp["pts"])
    for g, w in zip(got, heads):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    model.train()
    with pytest.raises(ValueError, match="eval mode"):
        backbone_apply_point_sharded(torch_make_mesh(devices=["cpu"]), model, model.cfg,
                                     inp["pts"])
    model.eval()


def _loop_ring_step_plain(xyz: torch.Tensor, steps: int) -> torch.Tensor:
    """The plain ring step looped at P = 1 from ``FPS_START``'s offer, each
    step's offer taken as the next step's gathered offers; each offer
    checked to be the farthest point's key and coordinates, a NaN
    distance's key bits ``NAN_BITS``. Returns the centroids."""
    b, n, _ = xyz.shape
    start = torch.full((b,), FPS_START, dtype=torch.int64)
    every = fps_ring_offers(start, xyz[:, FPS_START])[None]
    distance = torch.full((b, n), 1e10)
    centroids = torch.empty((b, steps), dtype=torch.int64)
    for i in range(steps):
        offer = fps_ring_step_plain(xyz, every, distance, centroids, i, 0)
        far = distance.argmax(dim=-1)
        assert torch.equal(offer[:, 0] & 0xFFFFFFFF, 0xFFFFFFFF - far)
        assert torch.equal(offer[:, 1:].int(), xyz[torch.arange(b), far].view(torch.int32))
        assert torch.equal(offer[:, 0] >> 32 == NAN_BITS, distance.isnan().any(dim=-1))
        every = offer[None]
    return centroids


def test_ring_step_plain_looped_on_one_rank(sharded):
    """P = 1: the plain ring step looped from the start's offer, each
    step's offer taken as the next step's gathered offers, gives the
    single-device FPS's indices and JAX's sharded FPS's on a one-device
    mesh; each offer is the farthest point's key and coordinates."""
    _, inp, jax_refs, _, _ = sharded
    xyz = inp["fps_xyz"]
    centroids = _loop_ring_step_plain(xyz, 64)
    want = farthest_point_sample_plain(xyz, 64, FPS_START)
    torch.testing.assert_close(centroids.int(), want, rtol=0, atol=0)
    np.testing.assert_array_equal(want.numpy(), jax_refs[1]["fps"])


def test_ring_step_plain_with_nan_and_inf_on_one_rank(sharded):
    """The same loop over clouds with a NaN and an inf coordinate: the NaN
    point wins the step after the start (as torch's and JAX's argmax take
    a NaN), then every distance is NaN and the lowest index wins; next to
    the inf point every distance is inf and the point itself NaN. The
    indices equal the single-device FPS's and JAX's FPS's."""
    _, inp, _, _, _ = sharded
    xyz = inp["fps_xyz"].clone()
    xyz[0, 100] = float("nan")
    xyz[1, 7, 2] = float("inf")
    centroids = _loop_ring_step_plain(xyz, 64)
    want = farthest_point_sample_plain(xyz, 64, FPS_START)
    torch.testing.assert_close(centroids.int(), want, rtol=0, atol=0)
    assert int(centroids[0, 1]) == 100
    np.testing.assert_array_equal(want.numpy(), np.asarray(
        jax_fps(jax.numpy.asarray(xyz.numpy()), 64, start_idx=FPS_START)))


@pytest.mark.parametrize("p", (1, *SIZES))
def test_sharded_fps_with_cross_rank_ties(sharded, p):
    """Every shard holds the same points (P = 2 and 4) or the cloud the
    same 128 points four times (P = 1, through the ring itself:
    ``_fps_ring``), so every step's farthest distance
    ties across ranks: the lowest global index wins, as in the
    single-device FPS and JAX's sharded FPS."""
    results, inp, jax_refs, _, _ = sharded
    want = farthest_point_sample_plain(inp["fps_dup_xyz"], 64)
    if p == 1:
        got = [torch_ps._fps_ring(inp["fps_dup_xyz"], 64, 0,
                                  torch_make_mesh(devices=["cpu"]))]
    else:
        got = [r["fps_dup"] for r in results[p]]
    for g in got:
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    assert int(want.max()) < 128  # the first copy's indices, never a later one's
    np.testing.assert_array_equal(want.numpy(), jax_refs[p]["fps_dup"])


@pytest.mark.parametrize("p", (1, *SIZES))
def test_sharded_forward_owner_on_the_cpu(sharded, p):
    """``ShardedForward`` on the CPU runs eagerly and says why; its heads
    equal ``backbone_apply_point_sharded``'s bit for bit at every call; in
    train mode it raises."""
    results, inp, _, _, model = sharded
    if p == 1:
        owner = ShardedForward(torch_make_mesh(devices=["cpu"]), model, model.cfg)
        want = backbone_apply_point_sharded(owner.mesh, model, model.cfg, inp["pts"])
        got = [owner(inp["pts"]) for _ in range(2)]
        reasons = [owner.graphs.eager_because]
        assert owner.graphs.eager_calls == 2 and owner.graphs.captures == 0
        model.train()
        with pytest.raises(ValueError, match="eval mode"):
            owner(inp["pts"])
        model.eval()
        pairs = [(g, want) for g in got]
    else:
        pairs = [(g, r["backbone"]) for r in results[p] for g in r["owner"]]
        reasons = [r["owner_eager_because"] for r in results[p]]
    assert reasons == ["cpu"] * len(reasons)
    for got, want in pairs:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ring_fps_kernel_choice_raises_on_the_cpu(sharded):
    """``fps_impl="kernel"`` (or the kernel's wrapper) with CPU tensors
    raises: no silent plain version."""
    _, inp, _, _, model = sharded
    mesh = torch_make_mesh(devices=["cpu"])
    xyz = inp["fps_xyz"]
    with pytest.raises(ValueError, match="CUDA"):
        torch_ps._fps_local(xyz, 8, 0, mesh, impl="kernel")
    every = fps_ring_offers(torch.zeros(3, dtype=torch.int64), xyz[:, 0])[None]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fps.fps_ring_step_kernel(xyz, every, torch.full((3, 512), 1e10),
                                      torch.empty((3, 8), dtype=torch.int64), 0, 0)
    kernel_cfg = dataclasses.replace(model.cfg, fps_impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        backbone_apply_point_sharded(mesh, model, kernel_cfg, inp["pts"])
