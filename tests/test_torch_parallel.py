"""The port's data parallelism (point2cyl_torch.parallel, the trainers'
parallel flags, multi-device serving) on the CPU over gloo.

Two ranks are started once for the module (``tests/torch_rank_worker.py``,
meeting at a file in the test's temporary directory) and run every
multi-rank case; each test below then holds one case's results against
the port's one-process step and against the JAX package's data-parallel
step on a ``make_mesh(2)`` of the virtual CPU devices, while the JAX
references are computed here as the ranks run. The small shapes are
``tests/test_torch_train.py``'s and ``tests/test_torch_joint.py``'s.
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_joint as TJT
from point2cyl_torch.core.config import TrainConfig as TorchTrainConfig
from point2cyl_torch.core.convert import backbone_state_dict_from_jax
from point2cyl_torch.data.pipeline import InputPipeline as TorchPipeline
from point2cyl_torch.data.synthetic import generate_dataset as torch_generate
from point2cyl_torch.models.implicit import ImplicitNet, PointNetEncoder
from point2cyl_torch.models.layers import BatchNorm
from point2cyl_torch.parallel import distributed as tdist
from point2cyl_torch.parallel import mesh as tmesh
from point2cyl_torch.serve.export import export_artifact
from point2cyl_torch.serve.session import InferenceSession
from point2cyl_torch.train import steps as tsteps
from point2cyl_torch.train import train_joint as TJ
from point2cyl_torch.train import train_pc
from point2cyl_tpu.core.config import TrainConfig
from point2cyl_tpu.data.pipeline import InputPipeline
from point2cyl_tpu.data.synthetic import generate_dataset
from point2cyl_tpu.models import backbone as jax_backbone_module
from point2cyl_tpu.parallel import distributed as jdist
from point2cyl_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from point2cyl_tpu.train import steps as jsteps
from test_torch_train import LOSS_FLAGS, backbone_config, jax_variables, numpy_batch, \
    torch_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_rank_worker.py")
K, N, B = 4, 96, 4  # Trainer A's step: 2 rows a rank
SEED = 1  # a batch with no point pair at a ball-query radius
MOMENTUM = 0.5
PROXY = ("normal", "miou", "bb", "extrusion", "center")


def start_ranks(suite: str, world: int, root: str, inputs: dict) -> list[subprocess.Popen]:
    """Write ``inputs`` and start ``world`` worker ranks meeting at a file
    under ``root``."""
    os.makedirs(root, exist_ok=True)
    torch.save(inputs, os.path.join(root, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, suite, str(r), str(world),
                              os.path.join(root, "rdv"), root],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env) for r in range(world)]


def finish_ranks(procs: list[subprocess.Popen], root: str) -> list[dict]:
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def fixed_fps(starts_by_npoint: dict):
    """JAX's backbone FPS with given per-row starts (by npoint) instead of
    its draw."""
    fps = jax_backbone_module.farthest_point_sample

    def patched(xyz, npoint, key=None, start_idx=0):
        return fps(xyz, npoint, key=None, start_idx=jnp.asarray(starts_by_npoint[npoint]))

    return patched


def jax_dp_trainer_a(params, stats, batch, starts):
    """JAX's data-parallel Trainer A losses and BN statistics on
    ``make_mesh(2)``: one jitted program over the sharded batch."""
    cfg = backbone_config(K, N)
    model = jax_backbone_module.Backbone(cfg)
    jcfg = TrainConfig(batch_size=B, **LOSS_FLAGS)
    mesh = make_mesh(2)
    key = jax.random.key(0)

    def loss_fn(p, stats, bj):
        (x_raw, w_raw), mut = model.apply(
            {"params": p, "batch_stats": stats}, bj["point_cloud"], train=True,
            bn_momentum=MOMENTUM, rngs={"sample": key, "dropout": key},
            mutable=["batch_stats"])
        heads = jsteps.assemble_heads(x_raw, w_raw, True, True, k=K)
        total, aux = jsteps.proxy_losses(heads, bj, jcfg)
        return total, (aux, mut["batch_stats"])

    patched = fixed_fps(dict(zip(cfg.sa_npoints, starts)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backbone_module, "farthest_point_sample", patched)
        _, (aux, new_stats) = jax.jit(loss_fn)(replicate(mesh, params),
                                               replicate(mesh, stats), shard_batch(mesh, batch))
    return jax.device_get((aux, new_stats))


def jax_dp_joint(jnets, batch, off, starts):
    """JAX's data-parallel joint loss (``make_joint_train_step``'s
    ``loss_fn``, ``tests/test_torch_joint.py``'s composition) on
    ``make_mesh(2)``, float32, the draws injected."""
    mesh = make_mesh(2)
    loss_fn = TJT.jax_joint_loss(jnets, batch, off, is_pc_train=True, is_im_train=True,
                                 use_gt_im=False)
    params = {"pc": jnets[0][1][0], "enc": jnets[2][1][0]}
    patched = fixed_fps(dict(zip(TJT.CFG.sa_npoints, starts)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backbone_module, "farthest_point_sample", patched)
        fn = jax.jit(lambda p: loss_fn(p)[1][0])
        aux = fn(replicate(mesh, params))
    return jax.device_get(aux)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks, compute the references meanwhile, and return
    (the ranks' results, the references)."""
    root = str(tmp_path_factory.mktemp("ranks"))
    cfg = backbone_config(K, N)
    _, params, stats = jax_variables(SEED, cfg)
    batch = numpy_batch(SEED, B, K, N)
    rng = np.random.default_rng(SEED)
    starts = [rng.integers(0, n, B).astype(np.int32) for n in (N, cfg.sa_npoints[0])]
    state = backbone_state_dict_from_jax(params, stats)
    tcfg = TorchTrainConfig(batch_size=B, **LOSS_FLAGS)
    jnets = TJT.jax_nets(3)
    backbone, implicit, encoder, loaded = TJT.port_nets(jnets)
    jbatch = TJT.numpy_batch(dead_slot=False)
    jstarts = [rng.integers(0, n, TJT.B).astype(np.int32)
               for n in (TJT.N, TJT.CFG.sa_npoints[0])]
    off = TJT.off_surface(9)
    cli_logdir = os.path.join(root, "cli_run")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    inputs = {
        "cfg": torch_config(cfg), "state": state, "k": K, "momentum": MOMENTUM,
        "batch": {k: t(v) for k, v in batch.items()}, "starts": [t(s) for s in starts],
        "tcfg": tcfg, "seed": 11,
        "tcfg_noise": dataclasses.replace(tcfg, add_noise=True),
        "x": t(rng.normal(1.0, 2.0, (4, 10, 6)).astype(np.float32)),
        "cot": t(rng.normal(size=(4, 10, 6)).astype(np.float32)),
        "bn_state": {"weight": t(rng.uniform(0.5, 1.5, 6).astype(np.float32)),
                     "bias": t(rng.normal(size=6).astype(np.float32)),
                     "running_mean": torch.zeros(6), "running_var": torch.ones(6)},
        "joint_cfg": torch_config(TJT.CFG),
        "joint_states": [m.state_dict() for m in (backbone, implicit, encoder, loaded)],
        "decoder": TJT.DECODER, "latent": TJT.L, "sk": TJT.S,
        "joint_tcfg": TorchTrainConfig(batch_size=TJT.B, **TJT.LOSS_FLAGS),
        "joint_batch": {k: t(v) for k, v in jbatch.items()},
        "joint_starts": [t(s) for s in jstarts], "off": t(off),
        "cli_args": ["--synthetic", "8", "--num_point", "128", "--K", str(K),
                     "--batch_size", "4", "--synthetic_resolution", "512",
                     "--device", "cpu", "--logdir", cli_logdir, "--pred_seg",
                     "--pred_normal", "--pred_bb", "--pred_extrusion", "--pred_center"],
    }
    procs = start_ranks("parallel", 2, root, inputs)
    try:
        refs = {"inputs": inputs, "cli_logdir": cli_logdir,
                "jax_a": jax_dp_trainer_a(params, stats, batch, starts),
                "jax_joint": jax_dp_joint(jnets, jbatch, off, jstarts)}
    finally:
        results = finish_ranks(procs, root)
    return results, refs


def one_process_forward(inp: dict):
    """The port's one-process Trainer A loss and gradients with the given
    FPS starts."""
    model = train_pc.Backbone(inp["cfg"])
    model.load_state_dict(inp["state"])
    x_raw, w_raw = model(inp["batch"]["point_cloud"], train=True, bn_momentum=MOMENTUM,
                         fps_starts=inp["starts"])
    heads = tsteps.assemble_heads(x_raw, w_raw, True, True, k=K)
    total, aux = tsteps.proxy_losses(heads, inp["batch"], inp["tcfg"])
    total.backward()
    return model, {key: val.detach() for key, val in aux.items()}


def assert_step_equal(rank_rec: dict, modules, aux: dict, loss_tol: float = 1e-5) -> None:
    """Loss scalars within ``loss_tol``; each gradient within 1e-3 of its
    own largest entry plus 1e-4 of the largest of any; buffers within
    1e-5."""
    for key, val in aux.items():
        np.testing.assert_allclose(float(rank_rec["aux"][key]), float(val), rtol=loss_tol,
                                   atol=loss_tol, err_msg=key)
    for i, mod in enumerate(modules):
        grads = rank_rec[f"grads{i}"]
        named = [(n, p) for n, p in mod.named_parameters() if p.grad is not None]
        assert set(grads) == {n for n, _ in named}
        top = max(float(p.grad.abs().max()) for _, p in named)
        for name, p in named:
            err = float((grads[name] - p.grad).abs().max())
            assert err <= 1e-3 * float(p.grad.abs().max()) + 1e-4 * top, (name, err, top)
        for name, buf in mod.named_buffers():
            torch.testing.assert_close(rank_rec[f"buffers{i}"][name], buf, rtol=1e-5,
                                       atol=1e-5, msg=name)


def test_dp_step_matches_one_process(ranks):
    """Two ranks of 2 rows each: the averaged loss, every averaged
    gradient and the BN statistics (taken over the global batch) are the
    one-process step's on the 4 rows."""
    results, refs = ranks
    model, aux = one_process_forward(refs["inputs"])
    for rec in results:
        assert_step_equal(rec["dp_forward"], [model], aux)
    for name, g in results[0]["dp_forward"]["grads0"].items():
        torch.testing.assert_close(g, results[1]["dp_forward"]["grads0"][name], rtol=0,
                                   atol=0, msg=name)


def test_dp_step_matches_jax_dp_step(ranks):
    """The same step against JAX's data-parallel step over two virtual
    devices, same weights, batch and FPS starts: the losses at
    ``tests/test_parallel.py``'s tolerances (6e-3 for the axis term and
    the total, 1e-4 else, rtol 2e-4) and the BN statistics within 1e-5."""
    results, refs = ranks
    aux, new_stats = refs["jax_a"]
    rec = results[0]["dp_forward"]
    for name in ("total", *PROXY):
        tol = 6e-3 if name in ("extrusion", "total") else 1e-4
        np.testing.assert_allclose(float(rec["aux"][name]), float(aux[name]), rtol=2e-4,
                                   atol=tol, err_msg=name)
    _, params, _ = jax_variables(SEED, backbone_config(K, N))
    want = backbone_state_dict_from_jax(params, new_stats)
    for name, buf in rec["buffers0"].items():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_dp_train_step_draws_over_the_global_batch(ranks):
    """``Trainer.train_step`` with noise and dropout on: each rank draws
    the global batch's noise, FPS starts and dropout mask from the shared
    generator and keeps its rows, so the step is the one-process step
    with the same generator."""
    results, refs = ranks
    inp = refs["inputs"]
    cfg = dataclasses.replace(inp["cfg"], dropout_rate=0.5)
    model = train_pc.Backbone(cfg)
    model.load_state_dict(inp["state"])
    trainer = tsteps.Trainer(model, inp["tcfg_noise"])
    aux = trainer.train_step(inp["batch"], torch.Generator().manual_seed(inp["seed"]))
    assert float(aux.pop("skipped")) == 0.0
    for rec in results:
        rec = rec["dp_step"]
        assert float(rec["aux"].pop("skipped")) == 0.0
        assert_step_equal(rec, [model], aux)


def test_batch_norm_over_two_ranks_equals_the_concatenated_batch(ranks):
    """Train-mode BN under a 2-rank group: each rank's outputs are the
    one-process BN's rows of the concatenated batch, the running
    statistics are the global ones, and the backward (through the
    all-reduced sums) gives each rank its rows of the input gradient and
    its share of the affine gradients."""
    results, refs = ranks
    inp = refs["inputs"]
    bn = BatchNorm(6)
    bn.load_state_dict(inp["bn_state"])
    x = inp["x"].clone().requires_grad_()
    y = bn(x, train=True, momentum=0.3)
    (y * inp["cot"]).sum().backward()
    got_y = torch.cat([r["bn"]["y"] for r in results])
    torch.testing.assert_close(got_y, y.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat([r["bn"]["x_grad"] for r in results]), x.grad,
                               rtol=1e-5, atol=1e-6)
    for name in ("weight_grad", "bias_grad"):
        got = results[0]["bn"][name] + results[1]["bn"][name]
        want = getattr(bn, name.split("_")[0]).grad
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for r in results:
        for name, buf in bn.named_buffers():
            torch.testing.assert_close(r["bn"]["buffers"][name], buf, rtol=1e-6, atol=1e-6)


def test_non_finite_loss_on_one_rank_skips_on_both(ranks):
    """A step that is finite on rank 0 and not on rank 1 (its normals are
    NaN) is skipped on both ranks, which keep their parameters, BN
    statistics, Adam state and step, after a good step."""
    results, _ = ranks
    for r in results:
        g = r["guard"]
        assert g["first_skipped"] == 0.0 and g["skipped"] == 1.0 and g["step"] == 1
        assert g["kept"] and g["kept_adam"]


def joint_one_process(inp: dict, dtype) -> TJ.JointTrainer:
    """The one-process joint trainer on the nets the ranks load."""
    nets = [train_pc.Backbone(inp["joint_cfg"]), ImplicitNet(**inp["decoder"]),
            PointNetEncoder(inp["latent"], 2, True), PointNetEncoder(inp["latent"], 2, True)]
    for net, state in zip(nets, inp["joint_states"]):
        net.load_state_dict(state, strict=True)
    return TJ.JointTrainer(*(n.to(dtype) for n in nets), inp["joint_tcfg"],
                           num_sk_points=inp["sk"], is_pc_train=True, is_im_train=True,
                           with_im_loss=True)


def cast(batch: dict, dtype) -> dict:
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}


def test_joint_dp_step_matches_one_process(ranks):
    """The joint step (backbone, encoder, IGR double backward) over two
    ranks of one row each, in float64 (as ``tests/test_torch_joint.py``
    holds it), with the draws injected: the loss parts, every backbone
    and encoder gradient and both nets' BN statistics are the one-process
    step's."""
    results, refs = ranks
    inp = refs["inputs"]
    trainer = joint_one_process(inp, torch.float64)
    total, aux = trainer.loss(cast(inp["joint_batch"], torch.float64), None,
                              fps_starts=inp["joint_starts"],
                              off_pts=inp["off"].to(torch.float64))
    total.backward()
    for rec in results:
        assert_step_equal(rec["joint_forward64"], [trainer.backbone, trainer.encoder],
                          {k: v.detach() for k, v in aux.items()})


def test_joint_dp_step_matches_jax_dp_step(ranks):
    """The float32 joint step over two ranks against JAX's joint loss over
    two virtual devices (``tests/test_parallel.py:105``'s tolerances:
    rtol 3e-4, atol 8e-3 for the terms downstream of the predicted axis,
    2e-3 else)."""
    results, refs = ranks
    want = refs["jax_joint"]
    rec = results[0]["joint_forward32"]["aux"]
    axis_path = ("manifold", "eikonal", "sald", "latent", "im_total", "total")
    for name in (*PROXY, *axis_path):
        atol = 8e-3 if name in axis_path else 2e-3
        np.testing.assert_allclose(float(rec[name]), float(want[name]), rtol=3e-4, atol=atol,
                                   err_msg=name)


def test_joint_train_step_draws_over_the_global_batch(ranks):
    """``JointTrainer.train_step`` with every draw from the generator
    (FPS starts, the two segment draws, off-surface samples): the
    two-rank step is the one-process step with the same generator."""
    results, refs = ranks
    inp = refs["inputs"]
    trainer = joint_one_process(inp, torch.float64)
    aux = trainer.train_step(cast(inp["joint_batch"], torch.float64),
                             torch.Generator().manual_seed(inp["seed"]))
    assert float(aux.pop("skipped")) == 0.0
    for rec in results:
        rec = rec["joint_step"]
        assert float(rec["aux"].pop("skipped")) == 0.0
        assert_step_equal(rec, [trainer.backbone, trainer.encoder], aux)


def test_process_batch_slice_matches_jax():
    for gbs, count in ((64, 4), (8, 2), (6, 3), (5, 1)):
        for pid in range(count):
            assert tdist.process_batch_slice(gbs, pid, count) == \
                jdist.process_batch_slice(gbs, process_id=pid, process_count=count)
    with pytest.raises(ValueError):
        tdist.process_batch_slice(10, 0, 4)
    assert tdist.process_batch_slice(8) == slice(0, 8)  # outside a group: one rank


def test_shard_batch_multihost_on_one_rank_equals_shard_batch():
    """On one rank the rows a rank assembles are ``shard_batch``'s, and
    rows that are not this rank's count are refused."""
    mesh = tmesh.make_mesh(devices=["cpu"])
    rng = np.random.default_rng(0)
    batch = {"a": torch.from_numpy(rng.normal(size=(16, 32, 3)).astype(np.float32)),
             "b": torch.from_numpy(rng.integers(0, 5, (16, 32)).astype(np.int32))}
    local = {k: v[tdist.process_batch_slice(16, 0, 1)].numpy() for k, v in batch.items()}
    got = tdist.shard_batch_multihost(mesh, local, 16)
    want = tmesh.shard_batch(mesh, batch)
    for key in batch:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    with pytest.raises(ValueError):
        tdist.shard_batch_multihost(mesh, {"a": local["a"][:8]}, 16)


def test_rows_slice_keeps_each_ranks_rows():
    """With ``rows_slice`` each rank's batches are its rows of the
    one-process batches drawn from the same generator, and their dataset
    rows are the ones JAX's pipeline gives that slice."""
    ds = generate_dataset(6, resolution=128, max_instances=K, num_sketch_points=8, seed=2)
    port = TorchPipeline(torch_generate(6, resolution=128, max_instances=K,
                                        num_sketch_points=8, seed=2), 32, K, "cpu",
                         num_sketch_points=8)
    jpipe = InputPipeline(ds, 32, K, num_sketch_points=8)
    whole = list(port.epochs(3, torch.Generator().manual_seed(4), shuffle=False))
    for pid in range(3):
        rows = tdist.process_batch_slice(3, pid, 3)
        part = list(port.epochs(3, torch.Generator().manual_seed(4), shuffle=False,
                                rows_slice=rows))
        jrows = list(jpipe.epochs(3, jax.random.key(0), shuffle=False, rows_slice=rows))
        assert len(part) == len(whole) == len(jrows) == 2
        for i, (got, want) in enumerate(zip(part, whole)):
            for key, val in want.items():
                torch.testing.assert_close(got[key], val[rows], rtol=0, atol=0, msg=key)
            # the per-row GT (not drawn) identifies the dataset rows
            for key in ("extrusion_axes", "extrusion_distances"):
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(jrows[i][key]))


def test_two_process_cli_writes_once_and_resumes(ranks):
    """Trainer A's CLI as two processes on one logdir (``--multihost``,
    gloo): two epochs of 8 clouds at a global batch of 4 (2 steps an
    epoch), then a resume to 3. Only rank 0 writes checkpoints and the
    log, both ranks resume at step 4 and end at step 6 with the same
    weights."""
    results, refs = ranks
    first, second = results[0]["cli"], results[1]["cli"]
    assert first["steps"] == second["steps"] == [4, 6]
    assert "model.pth.tmp" in first["saves"] and not second["all_saves"]
    assert os.path.isfile(os.path.join(refs["cli_logdir"], "model.pth"))
    state = torch.load(os.path.join(refs["cli_logdir"], "model.pth"), weights_only=True)
    assert state["epoch"] == 3 and state["step"] == 6
    for name, p in first["params"].items():
        torch.testing.assert_close(p, second["params"][name], rtol=0, atol=0, msg=name)
    with open(os.path.join(refs["cli_logdir"], "log.txt")) as f:
        log = f.read()
    assert log.count("> Epoch 0001 done") == 1 and log.count("Resumed from") == 1
    assert "epoch 2, step 4" in log and "data-parallel over 2 rank(s)" in log


def test_data_parallel_flag_spawns_ranks(tmp_path):
    """``--data_parallel 3 --device cpu`` at batch 4 runs 2 ranks (the
    largest count that divides the batch) in processes of their own, and
    rank 0 leaves the checkpoint of an epoch of 2 steps."""
    logdir = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-m", "point2cyl_torch.train.train_pc", "--synthetic", "8",
         "--num_point", "64", "--K", str(K), "--batch_size", "4",
         "--synthetic_resolution", "128", "--num_epochs", "1", "--device", "cpu",
         "--logdir", logdir, "--data_parallel", "3", "--pred_seg", "--pred_normal"],
        capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert res.stdout.count("> Epoch 0001 done") == 2  # every rank prints
    state = torch.load(os.path.join(logdir, "model.pth"), weights_only=True)
    assert state["step"] == 2 and state["epoch"] == 1
    with open(os.path.join(logdir, "log.txt")) as f:
        log = f.read()
    assert log.count("> Epoch 0001 done") == 1  # rank 0 alone writes
    assert re.search(r"data-parallel over 2 rank\(s\)", log)


def test_data_parallel_never_shares_a_card():
    """More ranks than cards raise before anything starts (here: none)."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has cards for 2 ranks")
    with pytest.raises(ValueError, match="ranks never share a card"):
        train_pc.cli_main(["--synthetic", "8", "--batch_size", "4", "--data_parallel", "2"])


def test_joint_cli_takes_the_parallel_flags():
    args = TJ.build_argparser().parse_args(["--data_parallel", "2", "--multihost",
                                            "--coordinator_address", "h:1",
                                            "--num_processes", "2", "--process_id", "1"])
    assert (args.data_parallel, args.multihost, args.coordinator_address,
            args.num_processes, args.process_id) == (2, True, "h:1", 2, 1)


def test_parallel_exports_jax_names():
    import point2cyl_torch.parallel as tp
    import point2cyl_tpu.parallel as jp

    names = [n for n in dir(jp) if not n.startswith("_") and callable(getattr(jp, n))]
    assert names and all(callable(getattr(tp, n)) for n in names)
    assert set(names) <= set(tp.__all__)


def test_multidevice_session_matches_single(tmp_path):
    """``devices=`` eight CPU replicas: the round-robin dispatch gives the
    one-device session's heads bit for bit, and the cursor persists
    across requests (``tests/test_serve.py:418-447``)."""
    cfg = torch_config(backbone_config(K, 64))
    model = train_pc.Backbone(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = model.state_dict()
    path = str(tmp_path / "m.p2ct")
    export_artifact(path, state, k=K, backbone_config=cfg, buckets=(1, 2))
    single = InferenceSession(path, device="cpu")
    multi = InferenceSession(path, devices=["cpu"] * 8)
    pts = np.random.default_rng(0).normal(size=(7, 64, 3)).astype(np.float32)
    a = single.predict(pts, assemble=False)
    b = multi.predict(pts, assemble=False)
    np.testing.assert_array_equal(a["x_raw"], b["x_raw"])
    np.testing.assert_array_equal(a["w_raw"], b["w_raw"])
    assert multi.stats["clouds"] == 7
    assert multi._next_dev == 4  # 7 clouds at buckets (1, 2): chunks 2, 2, 2, 1
    c = multi.predict(pts[:2], assemble=False)
    np.testing.assert_array_equal(a["x_raw"][:2], c["x_raw"])
    assert multi._next_dev == 5
    with pytest.raises(ValueError):
        InferenceSession(path, device="cpu", devices=["cpu"])
