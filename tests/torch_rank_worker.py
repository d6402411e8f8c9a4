"""One rank of the port's multi-process CPU tests (gloo).

    python tests/torch_rank_worker.py <suite> <rank> <world> <rendezvous file> <dir>

Each rank joins the group at ``file://<rendezvous file>``, reads the
inputs the test wrote to ``<dir>/inputs.pt``, runs every case of the
suite (``parallel``: ``tests/test_torch_parallel.py``; ``sharding``:
``tests/test_torch_point_sharding.py``; ``bf16``:
``tests/test_torch_bf16.py``; ``graphs``:
``tests/test_torch_graphs_joint.py``; ``large_n``:
``tests/test_torch_large_n.py``) and writes what it found to
``<dir>/rank<rank>.pt``. It imports torch and the port only, so the
ranks start in a second or two; the tests hold the results against the
one-process port and the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from point2cyl_torch.core.config import BackboneConfig
from point2cyl_torch.models.backbone import Backbone
from point2cyl_torch.models.implicit import ImplicitNet, PointNetEncoder
from point2cyl_torch.models.layers import BatchNorm
from point2cyl_torch.parallel import collectives
from point2cyl_torch.parallel import point_sharding as ps
from point2cyl_torch.parallel.distributed import join, process_batch_slice
from point2cyl_torch.parallel.mesh import make_mesh, shard_batch, use_global_batch_norm
from point2cyl_torch.parallel.sharded_backbone import (ShardedForward,
                                                       backbone_apply_point_sharded)
from point2cyl_torch.train import steps
from point2cyl_torch.train import train_joint as TJ
from point2cyl_torch.train import train_pc


def step_record(modules, aux) -> dict:
    """The loss scalars, every gradient and every buffer of ``modules``."""
    out = {"aux": {k: v.detach().clone() for k, v in aux.items()}}
    for i, mod in enumerate(modules):
        out[f"grads{i}"] = {n: p.grad.clone() for n, p in mod.named_parameters()
                            if p.grad is not None}
        out[f"buffers{i}"] = {n: b.clone() for n, b in mod.named_buffers()}
    return out


def backbone(cfg: BackboneConfig, state: dict, dtype=torch.float32) -> Backbone:
    model = Backbone(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(dtype)


# ---- suite "parallel" -------------------------------------------------------


def dp_forward_step(mesh, inp: dict) -> dict:
    """Trainer A's loss and its averaged gradients on this rank's rows,
    with the FPS starts given (the JAX comparison)."""
    model = backbone(inp["cfg"], inp["state"])
    use_global_batch_norm(model, mesh)
    grads = steps.FlatGrads(list(model.parameters()), len(steps.AUX_KEYS) - 1)
    batch = shard_batch(mesh, inp["batch"])
    rows = process_batch_slice(inp["batch"]["point_cloud"].shape[0], mesh.rank, mesh.world)
    x_raw, w_raw = model(batch["point_cloud"], train=True, bn_momentum=inp["momentum"],
                         fps_starts=[s[rows] for s in inp["starts"]])
    heads = steps.assemble_heads(x_raw, w_raw, True, True, k=inp["k"])
    total, aux = steps.proxy_losses(heads, batch, inp["tcfg"])
    total.backward()
    return step_record([model], steps.mean_over_ranks(mesh, grads.buffer, aux))


def dp_train_step(mesh, inp: dict) -> dict:
    """``Trainer.train_step`` on this rank's rows with the draws of the
    generator: noise, FPS starts and a dropout mask over the global batch."""
    cfg = dataclasses.replace(inp["cfg"], dropout_rate=0.5)
    trainer = steps.Trainer(backbone(cfg, inp["state"]), inp["tcfg_noise"], mesh)
    aux = trainer.train_step(shard_batch(mesh, inp["batch"]),
                             torch.Generator().manual_seed(inp["seed"]))
    return step_record([trainer.model], aux)


def guard_step(mesh, inp: dict) -> dict:
    """A step whose loss is finite on rank 0 and not on rank 1, after a
    good one: both ranks must skip and keep their state."""
    trainer = steps.Trainer(backbone(inp["cfg"], inp["state"]), inp["tcfg"], mesh)
    batch = shard_batch(mesh, inp["batch"])
    gen = torch.Generator().manual_seed(1)
    first = trainer.train_step(batch, gen)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    adam = [{k: v.clone() for k, v in st.items()} for st in trainer.optimizer.state.values()]
    if mesh.rank == 1:
        batch = dict(batch, normals=torch.full_like(batch["normals"], float("nan")))
    second = trainer.train_step(batch, gen)
    kept = all(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    kept_adam = all(torch.equal(a[k], st[k]) for a, st in
                    zip(adam, trainer.optimizer.state.values()) for k in a)
    return {"first_skipped": float(first["skipped"]), "skipped": float(second["skipped"]),
            "step": trainer.step, "kept": kept, "kept_adam": kept_adam}


def bn_case(mesh, inp: dict) -> dict:
    """One train-mode BatchNorm over a 2-rank group, forward and backward."""
    bn = BatchNorm(inp["x"].shape[-1])
    bn.load_state_dict(inp["bn_state"])
    use_global_batch_norm(bn, mesh)
    rows = process_batch_slice(inp["x"].shape[0], mesh.rank, mesh.world)
    x = inp["x"][rows].clone().requires_grad_()
    y = bn(x, train=True, momentum=0.3)
    (y * inp["cot"][rows]).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "buffers": {n: b.clone() for n, b in bn.named_buffers()}}


def joint_nets(inp: dict, dtype):
    b_cfg, (pc, im, enc, loaded), dec = inp["joint_cfg"], inp["joint_states"], inp["decoder"]
    nets = [backbone(b_cfg, pc, dtype), ImplicitNet(**dec)]
    nets[1].load_state_dict(im)
    for state in (enc, loaded):
        e = PointNetEncoder(inp["latent"], 2, True)
        e.load_state_dict(state)
        nets.append(e)
    return [n.to(dtype) for n in nets]


def joint_trainer(mesh, inp: dict, dtype) -> TJ.JointTrainer:
    return TJ.JointTrainer(*joint_nets(inp, dtype), inp["joint_tcfg"],
                           num_sk_points=inp["sk"], is_pc_train=True, is_im_train=True,
                           with_im_loss=True, mesh=mesh)


def joint_forward_step(mesh, inp: dict, dtype) -> dict:
    """The joint loss with the injected draws (FPS starts, the
    deterministic segment draw, off-surface samples), backward, averaged."""
    trainer = joint_trainer(mesh, inp, dtype)
    rows = process_batch_slice(inp["joint_batch"]["point_cloud"].shape[0], mesh.rank,
                               mesh.world)
    k = inp["joint_batch"]["extrusion_axes"].shape[1]
    batch = {key: v.to(dtype) if v.is_floating_point() else v
             for key, v in shard_batch(mesh, inp["joint_batch"]).items()}
    off = inp["off"].to(dtype)[rows.start * k:rows.stop * k]
    total, aux = trainer.loss(batch, None, fps_starts=[s[rows] for s in inp["joint_starts"]],
                              off_pts=off)
    total.backward()
    aux = steps.mean_over_ranks(mesh, trainer._grads.buffer, aux)
    return step_record([trainer.backbone, trainer.encoder], aux)


def joint_train_step(mesh, inp: dict) -> dict:
    """``JointTrainer.train_step`` (float64) with every draw from the
    generator, over the global batch."""
    trainer = joint_trainer(mesh, inp, torch.float64)
    batch = {key: v.double() if v.is_floating_point() else v
             for key, v in shard_batch(mesh, inp["joint_batch"]).items()}
    aux = trainer.train_step(batch, torch.Generator().manual_seed(inp["seed"]))
    return step_record([trainer.backbone, trainer.encoder], aux)


def cli_case(mesh, inp: dict) -> dict:
    """Trainer A's CLI as rank ``mesh.rank`` of a two-process run on a
    shared logdir, then its resume; records every torch.save call."""
    saved = []
    real_save = torch.save

    def recording_save(obj, path, *a, **kw):
        saved.append(os.path.basename(str(path)))
        return real_save(obj, path, *a, **kw)

    torch.save = recording_save
    try:
        argv = [*inp["cli_args"], "--multihost", "--coordinator_address", "unused:0",
                "--num_processes", str(mesh.world), "--process_id", str(mesh.rank)]
        done = train_pc.cli_main(argv + ["--num_epochs", "2"])
        saves_first = list(saved)
        resumed = train_pc.cli_main(argv + ["--num_epochs", "3", "--resume"])
    finally:
        torch.save = real_save
    return {"steps": [done.step, resumed.step], "saves": saves_first, "all_saves": saved,
            "params": {n: p.detach().clone() for n, p in resumed.model.named_parameters()}}


def parallel_suite(mesh, inp: dict) -> dict:
    return {
        "dp_forward": dp_forward_step(mesh, inp),
        "dp_step": dp_train_step(mesh, inp),
        "guard": guard_step(mesh, inp),
        "bn": bn_case(mesh, inp),
        "joint_forward32": joint_forward_step(mesh, inp, torch.float32),
        "joint_forward64": joint_forward_step(mesh, inp, torch.float64),
        "joint_step": joint_train_step(mesh, inp),
        "cli": cli_case(mesh, inp),
    }


# ---- suite "sharding" -------------------------------------------------------


def local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous shard of a global (B, N, ...) point axis."""
    n = x.shape[1] // mesh.world
    return x[:, mesh.rank * n:(mesh.rank + 1) * n]


def sharding_suite(mesh, inp: dict) -> dict:
    mine = torch.tensor([float(mesh.rank), -float(mesh.rank), 1.0])
    out = {"psum": collectives.psum(mine, mesh), "pmax": collectives.pmax(mine, mesh),
           "pmin": collectives.pmin(mine, mesh),
           "all_gather": collectives.all_gather(mine[None], mesh, dim=0),
           "ppermute": collectives.ppermute(mine, mesh)}
    sh = lambda x: local_rows(x, mesh)  # noqa: E731
    out["ball_query"] = ps.ball_query_sharded(mesh, 0.4, 16, sh(inp["bq_xyz"]),
                                              sh(inp["bq_q"]))
    out["gather"] = ps.index_points_sharded(mesh, sh(inp["g_pts"]), sh(inp["g_idx"]))
    d, gi = ps._ring_three_nn_local(sh(inp["nn_dst"]), sh(inp["nn_src"]), mesh)
    out["three_nn_idx"], out["three_nn_d"] = gi, d
    out["three_nn"] = ps.three_nn_interpolate_sharded(mesh, sh(inp["nn_dst"]),
                                                      sh(inp["nn_src"]), sh(inp["nn_feats"]))
    out["fps"] = ps.farthest_point_sample_sharded(mesh, sh(inp["fps_xyz"]), 64,
                                                  start_idx=inp["fps_start"])
    out["fps_dup"] = ps.farthest_point_sample_sharded(mesh, sh(inp["fps_dup_xyz"]), 64)
    for name, feats in (("sag", sh(inp["sag_feats"])), ("sag_nofeats", None)):
        q, g = ps.sample_and_group_sharded(mesh, 0.4, 16, sh(inp["sag_xyz"]), feats,
                                           inp["sag_fps"])
        out[name] = (q, g)
    model = backbone(inp["cfg"], inp["state"]).eval()
    out["backbone"] = backbone_apply_point_sharded(mesh, model, inp["cfg"], sh(inp["pts"]))
    owner = ShardedForward(mesh, model, inp["cfg"])
    out["owner"] = [owner(sh(inp["pts"])) for _ in range(2)]
    out["owner_eager_because"] = owner.graphs.eager_because
    return out


# ---- suite "bf16" -----------------------------------------------------------


def bf16_suite(mesh, inp: dict) -> dict:
    """Trainer A's data-parallel step and the point-sharded forward with
    the backbone's dense layers in bf16 (``inp["cfg"]``)."""
    model = backbone(inp["cfg"], inp["state"]).eval()
    return {"dp_forward": dp_forward_step(mesh, inp),
            "sharded": backbone_apply_point_sharded(mesh, model, inp["cfg"],
                                                    local_rows(inp["pts"], mesh))}


# ---- suite "graphs" ---------------------------------------------------------


def graphs_suite(mesh, inp: dict) -> dict:
    """Trainer A's data-parallel ``train_step``, whose body builds the
    global batch's ``RowDraws`` from the generator it is handed, beside
    the body called with the ``RowDraws`` built by the caller, as the
    data-parallel step was called before it could be captured: both
    from the same weights and a generator of the same seed."""
    local = shard_batch(mesh, inp["batch"])
    rows = local["point_cloud"].shape[0]
    out = {}
    for name in ("inside", "caller"):
        trainer = steps.Trainer(backbone(inp["cfg"], inp["state"]), inp["tcfg"], mesh)
        gen = torch.Generator().manual_seed(inp["seed"])
        if name == "inside":
            aux = trainer.train_step(local, gen)
            vals = torch.stack([aux[k] for k in steps.AUX_KEYS])
        else:
            vals = trainer._step(local, steps.step_generator(mesh, gen, rows)).clone()
        out[name] = {"vals": vals, "generator": gen.get_state(),
                     "grads": [p.grad.clone() for p in trainer.model.parameters()],
                     "state": {k: v.clone() for k, v in trainer.model.state_dict().items()},
                     "moments": trainer._moments.clone(), "step": int(trainer.step)}
    return out


# ---- suite "large_n" --------------------------------------------------------


def large_n_suite(mesh, inp: dict) -> dict:
    """The ring FPS (from a start tensor, and on a cloud of repeated
    points) and the ring ball query on this rank's shards."""
    sh = lambda x: local_rows(x, mesh)  # noqa: E731
    return {"fps": ps._fps_local(sh(inp["xyz"]), inp["npoint"], inp["start"], mesh),
            "fps_dup": ps._fps_local(sh(inp["dup_xyz"]), inp["npoint"], 0, mesh),
            "ball_query": ps._ring_ball_query_local(inp["radius"], inp["nsample"],
                                                    sh(inp["xyz"]), sh(inp["q"]), mesh)}


SUITES = {"parallel": parallel_suite, "sharding": sharding_suite, "bf16": bf16_suite,
          "graphs": graphs_suite, "large_n": large_n_suite}


def main() -> None:
    suite, rank, world, rdv, root = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    join("file://" + rdv, world, rank, backend="gloo")
    try:
        mesh = make_mesh(devices=["cpu"] * world)
        inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
        torch.save(SUITES[suite](mesh, inp), os.path.join(root, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
