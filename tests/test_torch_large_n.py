"""Clouds beyond 16,384 points: the launch plans of the FPS kernels above
16,384 points (the cluster route, ``csrc/fps_cluster.cu``, and the grid
route, ``csrc/fps_grid.cu``), of the ring FPS step (``csrc/fps_ring.cu``)
and of the streamed SA1 ball query above 11,944 points
(``csrc/ballquery.cu``), their layout headers, the world-1 point-sharded
ops against the ring at two ranks (gloo), and the port's backbone at
N = 20,480 against the JAX package, all on the CPU. The kernels
themselves run on the card only (``chip_smoke.py --only-large``).
"""

from __future__ import annotations

import dataclasses
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.core.config import BackboneConfig as TorchConfig
from point2cyl_torch.core.convert import backbone_state_dict_from_jax
from point2cyl_torch.models.backbone import build_backbone
from point2cyl_torch.ops import _build, cuda_ballquery, cuda_fps
from point2cyl_torch.ops.grouping import ball_query_plain, index_points
from point2cyl_torch.ops.sampling import farthest_point_sample_plain
from point2cyl_torch.parallel import point_sharding as torch_ps
from point2cyl_torch.parallel.mesh import make_mesh as torch_make_mesh
from point2cyl_tpu.core.config import BackboneConfig
from point2cyl_tpu.models.backbone import Backbone
from point2cyl_tpu.ops.grouping import ball_query as jax_ball_query
from point2cyl_tpu.ops.sampling import farthest_point_sample as jax_fps
from test_torch_parallel import finish_ranks, start_ranks

SMS = cuda_fps.H100_SMS
LARGE_N = (16385, 16386, 19999, 20000, 24575, 32768, 65537, 131072, 500001, 2**20)
BATCHES = (1, 2, 3, 4, 8, 16, 33, 64)


# ---- launch plans ------------------------------------------------------------


@pytest.mark.parametrize("b", BATCHES)
def test_fps_grid_plan_covers_large_n(b):
    """Every (B, N) gets one route. The cluster route, up to the
    cluster's capacity: one cluster of 2-16 CTAs a cloud whose registers
    (8 points a thread) hold the cloud, with no more CTAs than it needs.
    The grid route, only beyond: CTAs all resident at once (B x ctas
    within the SMs' blocks), whose registers and streamed points cover the
    cloud, with no more CTAs than it needs, streaming only where the
    card's share of a cloud cannot hold it."""
    for n in LARGE_N:
        plan = cuda_fps.fps_grid_plan(b, n)
        assert plan.threads in (32, 64, 128, 256, 512, 1024)
        held = plan.ctas * plan.threads * cuda_fps.GRID_PPT
        assert plan.streamed == max(0, n - held) and held + plan.streamed >= n
        if n <= cuda_fps.CLUSTER_CAPACITY:
            assert plan.route == "cluster" and 2 <= plan.ctas <= cuda_fps.CLUSTER_MAX_CTAS
            assert plan.streamed == 0 and held // 2 < n  # half the cluster would not hold it
        else:
            assert plan.route == "grid", (b, n, plan)
            blocks = cuda_fps.grid_blocks_per_sm(plan.threads)
            assert b * plan.ctas <= SMS * blocks, (b, n, plan)
            if plan.streamed:
                assert b * (plan.ctas + 1) > SMS * blocks, (b, n, plan)
            else:
                assert held - plan.threads * cuda_fps.GRID_PPT < n  # no more CTAs than needed


def test_fps_grid_plan_main_shapes_and_limits():
    """The slice's shapes: one cluster of 16 CTAs a cloud up to 131,072
    points, 128 CTAs of 1,024 threads at 2^20, all in registers; a batch
    that cannot be resident at once, an empty one, or a cloud beyond one
    cluster forced onto the cluster route raises ValueError."""
    assert cuda_fps.fps_grid_plan(1, 2**20) == ("grid", 128, 1024, 0)
    assert cuda_fps.fps_grid_plan(4, 131072) == ("cluster", 16, 1024, 0)
    assert cuda_fps.fps_grid_plan(4, 32768) == ("cluster", 16, 256, 0)
    assert cuda_fps.fps_grid_plan(16, 32768) == ("cluster", 16, 256, 0)
    assert cuda_fps.fps_grid_plan(1, 16385) == ("cluster", 16, 256, 0)
    cap = cuda_fps.CLUSTER_CAPACITY
    assert cuda_fps.fps_grid_plan(2, cap + 1).route == "grid"
    # the grid wrapper's own plan below the capacity
    assert cuda_fps.fps_grid_plan(4, 32768, route="grid") == ("grid", 4, 1024, 0)
    # small CTAs where the batch outnumbers the SMs
    assert cuda_fps.fps_grid_plan(64, cap + 1)[:3] == ("grid", 2, 1024)
    assert cuda_fps.fps_grid_plan(200, cap + 1)[:3] == ("grid", 1, 512)
    most = SMS * cuda_fps.grid_blocks_per_sm(32)
    assert cuda_fps.fps_grid_plan(most, cap + 1).ctas == 1
    for b, n, route in ((most + 1, cap + 1, None), (0, 20000, None), (1, 0, None),
                        (1, cap + 1, "cluster"), (1, 20000, "ring")):
        with pytest.raises(ValueError):
            cuda_fps.fps_grid_plan(b, n, route=route)


@pytest.mark.parametrize("b", BATCHES)
def test_fps_ring_plan_covers_shards(b):
    """Every (B, Nl) of a ring step gets one cluster a cloud: at most 16
    CTAs of 256 or 512 threads, the fewest CTAs, then threads, that give a
    thread about 4 points of the shard (the most there are beyond 16 x
    512 x 4); B=0 and Nl=0 raise."""
    per = cuda_fps.RING_POINTS_PER_THREAD
    for nl in (1, 4096, 8192, 65536, 65537, 131072, 524288):
        plan = cuda_fps.fps_ring_plan(b, nl)
        assert plan.threads in (256, 512) and 1 <= plan.cluster <= cuda_fps.RING_MAX_CLUSTER
        if plan.cluster * plan.threads * per < nl:
            assert plan == (cuda_fps.RING_MAX_CLUSTER, cuda_fps.RING_MAX_THREADS), (nl, plan)
        elif plan.cluster > 1:
            assert (plan.cluster // 2) * cuda_fps.RING_THREADS * per < nl, (nl, plan)
    assert cuda_fps.fps_ring_plan(4, 8192) == (8, 256)
    assert cuda_fps.fps_ring_plan(1, 131072) == (16, 512)
    for b, nl in ((0, 8192), (4, 0)):
        with pytest.raises(ValueError):
            cuda_fps.fps_ring_plan(b, nl)


# the idx-only query's last staged scan and first streamed N, the grid's
# last N at nsample 64, the streamed query's first, the band the staged
# scan took until the streamed query beat it there, and beyond
STREAM_N = (1535, 1536, 11944, 11945, 16384, *LARGE_N)


@pytest.mark.parametrize("b", BATCHES)
def test_stream_plan_covers_large_n(b):
    """SA1 and the idx-only query get a plan at every N: SA1 the grid
    where it fits (N up to 11,944 at nsample 64), else the streamed query
    (N=16,384 too: it beat the staged scan there); the idx-only query the
    staged scan below STREAM_MIN_N points, the streamed query from there
    (where it beat the scan). The streamed plan serves every query with
    whole queries a CTA (its warps a query dividing the CTA's), fits the
    launch's limits and fills at least half the card's SMs with CTAs,
    and its shared memory is the header's and within the limit."""
    cb = cuda_ballquery
    for n in STREAM_N:
        for gather in (True, False):
            plan = cb.ball_query_plan(b, n, 512, 64, gather=gather)
            assert plan is not None and plan.smem <= cb.SMEM_LIMIT, (b, n)
            grid = cb._grid_plan(b, n, 512, 64, SMS) is not None
            assert grid == (n <= 11944), (b, n)
            streams = n > 11944 if gather else n >= cb.STREAM_MIN_N
            assert (plan.select == "stream") == streams, (b, n, plan)
            if plan.select != "stream":
                assert plan.select == ("grid" if gather else "scan"), (b, n, plan)
                continue
            per_cta = plan.warps // plan.group
            assert plan.warps % plan.group == 0 and 1 <= plan.warps <= 32
            assert plan.ctas * per_cta >= 512 and plan.ctas == -(-512 // per_cta)
            assert 2 * b * plan.ctas >= SMS, (b, n, plan)
            assert plan.smem == cb._stream_smem(64, plan.warps, plan.group, gather)
            assert plan.store == ("coords" if gather else "none")


@pytest.mark.parametrize("b, n, want", [
    # phase 17b's shapes and Trainer A's: 16 queries of 2 warps a CTA at
    # B=4, 4 of 4 at B=1
    (4, 32768, ("stream", "coords", 32, 32, 2)),
    (4, 131072, ("stream", "coords", 32, 32, 2)),
    (1, 131072, ("stream", "coords", 128, 16, 4)),
    (1, 2**20, ("stream", "coords", 128, 16, 4)),
    # the band the staged scan held, and clouds in several waves
    (1, 16384, ("stream", "coords", 128, 16, 4)),
    (4, 16384, ("stream", "coords", 32, 32, 2)),
    (16, 32768, ("stream", "coords", 16, 32, 1)),
])
def test_stream_plan_main_shapes(b, n, want):
    """The streamed plans of the shapes the card measured (PERF.md); a
    block is 1,024 points a warp of a query."""
    plan = cuda_ballquery.ball_query_plan(b, n, 512, 64)
    assert (*plan[:4], plan.group) == want
    assert cuda_ballquery._stream_block(plan.group) == 1024 * plan.group


def test_stream_plan_forced_and_limits():
    """``select="stream"`` takes the streamed query at any N, and SA1 has
    no other route to select (its staged scan went); the idx-only query's
    ``select="scan"`` stages the row where it fits; overrides that do not
    fit give None; a nsample whose slots exceed shared memory even at one
    warp a query has no plan, and the wrappers' check raises there."""
    cb = cuda_ballquery
    plan = cb.ball_query_plan(4, 8192, 512, 64, select="stream")
    assert (*plan[:4], plan.group) == ("stream", "coords", 32, 32, 2)
    for select in ("scan", "ballot", "grid"):
        assert cb.ball_query_plan(4, 16384, 512, 64, select=select) is None, select
    assert cb.ball_query_plan(4, 16384, 512, 64, gather=False,
                              select="scan")[:4] == ("scan", "none", 16, 32)
    # the idx-only row does not fit
    assert cb.ball_query_plan(4, 32768, 512, 64, gather=False, select="scan") is None
    for over in ({"group": 16, "warps": 24}, {"group": 64}, {"group": 32},
                 {"warps": 33}):
        assert cb.ball_query_plan(1, 2**20, 512, 64, select="stream", **over) is None, over
    # the slots' limits: a query's slots and centred points in shared
    # memory with the gather, its slots alone without
    for gather, most in ((True, 12216), (False, 48866)):
        assert cb.ball_query_plan(1, 2**20, 512, most, gather=gather).group == 1
        assert cb.ball_query_plan(1, 2**20, 512, most + 1, gather=gather) is None
    assert cb.ball_query_plan(1, 2**20, 512, 60000) is None
    with pytest.raises(ValueError, match="exceed shared memory"):
        cb.plan_or_raise("sa1", 1, 2**20, 512, 60000)
    # SA2 keeps its staged row: no stream route with features
    assert cb.ball_query_plan(4, 32768, 128, 64, 128) is None


@pytest.mark.skipif(shutil.which("c++") is None, reason="needs a host C++ compiler")
def test_large_n_layouts_match_headers(tmp_path):
    """The plans' constants and sizes are the kernels' own: the headers
    (csrc/fps_grid_layout.cuh, csrc/ballquery_layout.cuh) compiled on the
    host give the same FPS limits, meeting size, cluster capacity, blocks
    a SM and streamed points, and the same streamed query's header,
    blocks in flight, chunks a warp, block and stage and shared memory
    over nsample, warps a CTA and a query, and gather."""
    cf, cb = cuda_fps, cuda_ballquery
    exprs = {"kGridMaxThreads": cf.GRID_MAX_THREADS, "kGridPPT": cf.GRID_PPT,
             "kGridRegs": cf.GRID_REGS, "kSmRegs": cf.SM_REGS,
             "kGridMeetWords": cf.GRID_MEET_WORDS, "kClusterMaxCtas": cf.CLUSTER_MAX_CTAS,
             "kClusterCapacity": cf.CLUSTER_CAPACITY, "kStreamHeader": cb.STREAM_HEADER,
             "kStreamStages": cb.STREAM_STAGES, "kStreamChunks": cb.STREAM_CHUNKS}
    for threads in (32, 64, 128, 256, 512, 1024):
        exprs[f"grid_blocks_per_sm({threads})"] = cf.grid_blocks_per_sm(threads)
    for b in (1, 4, 64):
        for n in LARGE_N:
            plan = cf.fps_grid_plan(b, n)
            exprs[f"grid_streamed({n}, {plan.ctas}, {plan.threads})"] = plan.streamed
    for group in (1, 2, 4, 8, 16):
        exprs[f"stream_block({group})"] = cb._stream_block(group)
        exprs[f"stream_stage_bytes({cb._stream_block(group)})"] = (
            12 * cb._stream_block(group) + 16)
    for ns in (1, 63, 64, 128, 1024):
        for warps, group in ((1, 1), (4, 4), (8, 8), (16, 4), (32, 2), (32, 1), (16, 16)):
            for gather in (0, 1):
                exprs[f"stream_smem({ns}, {warps}, {group}, {gather})"] = cb._stream_smem(
                    ns, warps, group, bool(gather))
    src = tmp_path / "layout.cpp"
    src.write_text('#include <cstdio>\n#include "fps_grid_layout.cuh"\n'
                   '#include "ballquery_layout.cuh"\nint main() {\n'
                   + "".join(f'  std::printf("%lld\\n", (long long)({e}));\n' for e in exprs)
                   + "}\n")
    subprocess.run(["c++", "-std=c++17", "-I", str(_build.CSRC), str(src), "-o",
                    str(tmp_path / "layout")], check=True, capture_output=True)
    out = subprocess.run([str(tmp_path / "layout")], check=True, capture_output=True,
                         text=True).stdout.split()
    assert len(out) == len(exprs) and dict(zip(exprs, map(int, out))) == exprs
    assert _build.CSRC / "fps_grid_layout.cuh" in _build._hashed()


def test_new_kernels_refuse_cpu_tensors():
    """The new kernels' wrappers raise on CPU tensors, and a large cloud
    on the CPU takes the plain versions (no kernel, no fallback the other
    way): ``impl="kernel"`` raises on the CPU at any N."""
    xyz = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 16400, 3))
                           .astype(np.float32))
    big = xyz.repeat(1, 8, 1)  # 131,200 points: the grid route's size
    for kernel, pts in ((cuda_fps.farthest_point_sample_cluster_kernel, xyz),
                        (cuda_fps.farthest_point_sample_grid_kernel, xyz),
                        (cuda_fps.farthest_point_sample_grid_kernel, big)):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(pts, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ballquery.ball_query_stream_kernel(0.2, 8, xyz, xyz[:, :4].contiguous())
    counters = (cuda_fps.farthest_point_sample_cluster_kernel,
                cuda_fps.farthest_point_sample_grid_kernel,
                cuda_ballquery.ball_query_stream_kernel)
    before = [c.launches for c in counters]
    for pts in (xyz, big):
        torch.testing.assert_close(cuda_fps.farthest_point_sample(pts, 8),
                                   farthest_point_sample_plain(pts, 8), rtol=0, atol=0)
    centres = xyz[:, :4].contiguous()
    torch.testing.assert_close(cuda_ballquery.ball_query_grouped(0.2, 8, xyz, centres)[0],
                               ball_query_plain(0.2, 8, xyz, centres), rtol=0, atol=0)
    assert [c.launches for c in counters] == before
    cfg = dataclasses.replace(_torch_config(), fps_impl="kernel")
    model = build_backbone(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        model.eval()(xyz)


# ---- world 1 against the ring ------------------------------------------------


def test_world1_sharded_ops_equal_the_ring(tmp_path):
    """At one rank ``_fps_local`` and ``_ring_ball_query_local`` take the
    single-device ops; their indices equal the ring's at two ranks (gloo)
    and at one (``_fps_ring``) index for index: FPS from a start tensor,
    FPS over a cloud of repeated points (ties across the ranks' shards)
    and the ball query."""
    rng = np.random.default_rng(17)
    xyz = rng.uniform(-1.0, 1.0, (2, 4096, 3)).astype(np.float32)
    inp = {"xyz": torch.from_numpy(xyz),
           "dup_xyz": torch.from_numpy(np.tile(xyz[:, :512], (1, 8, 1))),
           "q": torch.from_numpy(xyz[:, ::32].copy()), "start": torch.tensor([5, 4000]),
           "npoint": 128, "radius": 0.3, "nsample": 32}
    procs = start_ranks("large_n", 2, str(tmp_path), inp)
    one = torch_make_mesh(devices=["cpu"])
    want = {"fps": torch_ps._fps_local(inp["xyz"], 128, inp["start"], one),
            "fps_dup": torch_ps._fps_local(inp["dup_xyz"], 128, 0, one),
            "ball_query": torch_ps._ring_ball_query_local(0.3, 32, inp["xyz"], inp["q"], one)}
    ranks = finish_ranks(procs, str(tmp_path))
    torch.testing.assert_close(want["fps"], farthest_point_sample_plain(
        inp["xyz"], 128, inp["start"]), rtol=0, atol=0)
    torch.testing.assert_close(want["ball_query"], ball_query_plain(
        0.3, 32, inp["xyz"], inp["q"]), rtol=0, atol=0)
    assert int(want["fps_dup"].max()) < 512  # the first copy's indices win the ties
    torch.testing.assert_close(torch_ps._fps_ring(inp["xyz"], 128, inp["start"], one),
                               want["fps"], rtol=0, atol=0)
    for r in ranks:
        torch.testing.assert_close(r["fps"], want["fps"], rtol=0, atol=0)
        torch.testing.assert_close(r["fps_dup"], want["fps_dup"], rtol=0, atol=0)
    joined = torch.cat([r["ball_query"] for r in ranks], dim=1)
    torch.testing.assert_close(joined, want["ball_query"], rtol=0, atol=0)


def test_world1_sharded_ops_make_no_collective(monkeypatch):
    """At one rank the FPS and the ball queries call no collective: no
    ring step, no all-gather, no ring rotation."""
    from point2cyl_torch.parallel import collectives

    def refuse(*args, **kwargs):
        raise AssertionError("a collective at one rank")

    for name in ("all_gather", "ppermute", "psum", "pmax", "pmin"):
        monkeypatch.setattr(collectives, name, refuse)
    rng = np.random.default_rng(18)
    xyz = torch.from_numpy(rng.uniform(-1.0, 1.0, (2, 2048, 3)).astype(np.float32))
    one = torch_make_mesh(devices=["cpu"])
    idx = torch_ps._fps_local(xyz, 64, 3, one)
    torch.testing.assert_close(idx, farthest_point_sample_plain(xyz, 64, 3), rtol=0, atol=0)
    q = index_points(xyz, idx)
    torch.testing.assert_close(torch_ps._ring_ball_query_local(0.3, 16, xyz, q, one),
                               ball_query_plain(0.3, 16, xyz, q), rtol=0, atol=0)
    grouped = torch_ps._group_local(0.3, 16, xyz, None, q, one)
    torch.testing.assert_close(grouped, cuda_ballquery.ball_query_grouped_plain(
        0.3, 16, xyz, q)[1], rtol=0, atol=0)


# ---- the backbone at N = 20,480 against JAX ---------------------------------

N_LARGE = 20480
K = 4
CFG = BackboneConfig(
    num_points=N_LARGE, sa_npoints=(512, 128), sa_radii=(0.2, 0.4), sa_nsamples=(64, 64),
    sa_mlps=((16, 32), (32, 64)), sa_global_mlp=(64, 128), fp_mlps=((64,), (32,), (32, 32)),
    fc_width=32, output_sizes=(3, 2 * K), approx_neighbors=False,
)
# JAX's CPU path measures a ball query's distances by expansion (|q|^2 +
# |p|^2 - 2 q.p, about 1e-6 off at these magnitudes), the port by exact
# differences: no centre-point pair may lie within RADIUS_MARGIN of a
# squared radius, or the two would select differently for that reason.
RADIUS_MARGIN = 1e-5
# The heads differ by float32 summation order in the dense layers and by
# JAX's expansion distances in the 3-NN weights (about 6e-8 on this
# cloud); 1e-5 holds them well clear of a wrong neighbour or weight.
HEADS_ATOL = 1e-5


def _torch_config() -> TorchConfig:
    return TorchConfig.from_dict(dataclasses.asdict(CFG))


def _near_radius(q: np.ndarray, pts: np.ndarray, radius: float) -> np.ndarray:
    """Indices of ``pts`` within RADIUS_MARGIN of ``radius``^2 from any of ``q``."""
    q, pts = q.astype(np.float64), pts.astype(np.float64)
    d2 = (q * q).sum(-1)[:, None] + (pts * pts).sum(-1)[None] - 2.0 * q @ pts.T
    return np.nonzero((np.abs(d2 - radius * radius) < RADIUS_MARGIN).any(axis=0))[0]


def screened_cloud(seed: int) -> np.ndarray:
    """A unit-sphere cloud of N_LARGE points, its points nudged outward by
    1e-3 of their norm until no SA1 or SA2 centre (FPS from 0, the eval
    forward's start) has a point within RADIUS_MARGIN of its squared
    radius."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(N_LARGE, 3))
    pts = (pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(np.float32)
    for _ in range(20):
        fps1 = farthest_point_sample_plain(torch.from_numpy(pts[None]), 512)[0].numpy()
        c1 = pts[fps1]
        fps2 = farthest_point_sample_plain(torch.from_numpy(c1[None]), 128)[0].numpy()
        bad = np.union1d(_near_radius(c1, pts, CFG.sa_radii[0]),
                         fps1[_near_radius(c1[fps2], c1, CFG.sa_radii[1])])
        if bad.size == 0:
            return pts[None]
        pts[bad] *= np.float32(1.001)
    raise AssertionError("the cloud did not clear the radii")


def jax_variables(seed: int):
    """JAX init with non-trivial BN affine parameters and statistics."""
    model = Backbone(CFG)
    key = jax.random.key(seed)
    variables = jax.jit(lambda k, x: model.init(
        {"params": k, "sample": k, "dropout": k}, x, train=False))(key, jnp.zeros((1, 1024, 3)))
    rng = np.random.default_rng(seed)

    def bn(path, leaf):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, np.shape(leaf)).astype(np.float32)
        if name in ("bias", "mean") and "TorchBatchNorm" in str(path):
            return rng.normal(0.0, 0.1, np.shape(leaf)).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(bn, jax.device_get(variables["params"]))
    stats = jax.tree_util.tree_map_with_path(bn, jax.device_get(variables["batch_stats"]))
    return model, {"params": params, "batch_stats": stats}


def test_backbone_at_20480_points_matches_jax():
    """B=1, N=20,480 (past the old 16,384-point limit), K=4, narrow
    widths, exact neighbours, the eval forward's FPS start (point 0): the
    port's SA1 and SA2 FPS and ball-query indices equal JAX's (the
    screened cloud keeps every pair off the radii), and its heads lie
    within HEADS_ATOL of JAX's eval forward."""
    pts = screened_cloud(20)
    model, variables = jax_variables(3)
    sd = backbone_state_dict_from_jax(variables["params"], variables["batch_stats"])
    port = build_backbone(_torch_config(), state_dict=sd, device="cpu")
    x = torch.from_numpy(pts)
    with torch.inference_mode():
        fps1 = cuda_fps.farthest_point_sample(x, 512)
        c1 = index_points(x, fps1)
        idx1 = cuda_ballquery.ball_query_grouped(CFG.sa_radii[0], 64, x, c1)[0]
        fps2 = cuda_fps.farthest_point_sample(c1, 128)
        idx2 = ball_query_plain(CFG.sa_radii[1], 64, c1, index_points(c1, fps2))
        heads = port(x)
    xj = jnp.asarray(pts)
    fps1_j = jax_fps(xj, 512)
    c1_j = jnp.take_along_axis(xj, fps1_j[..., None], axis=1)
    fps2_j = jax_fps(c1_j, 128)
    np.testing.assert_array_equal(fps1.numpy(), np.asarray(fps1_j))
    np.testing.assert_array_equal(fps2.numpy(), np.asarray(fps2_j))
    query = jax.jit(jax_ball_query, static_argnums=(0, 1))
    np.testing.assert_array_equal(idx1.numpy(), np.asarray(
        query(CFG.sa_radii[0], 64, xj, c1_j)))
    np.testing.assert_array_equal(idx2.numpy(), np.asarray(query(
        CFG.sa_radii[1], 64, c1_j, jnp.take_along_axis(c1_j, fps2_j[..., None], axis=1))))
    want = jax.jit(lambda v, p: model.apply(v, p, train=False))(variables, xj)
    assert np.abs(np.asarray(want[0])).max() > 0.1  # a forward worth comparing
    for got, w in zip(heads, want):
        assert got.shape == (1, N_LARGE, w.shape[-1])
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=HEADS_ATOL, rtol=0)
