"""The port's captured steps II on the CPU, where the step bodies run
eagerly: the joint step, the IGR pretrain step, reconstruction's
fine-tune step and the data-parallel Trainer A body.

The joint and pretrain bodies against JAX's jitted ``make_joint_train_step``
and ``make_im_pretrain_step`` from the same weights, batch and injected
draws as ``tests/test_torch_joint.py``'s parity tests; each body with
every Python-level host read made to raise; the joint trainer's per-group
Adam against ``optax.multi_transform`` across a checkpoint from a carried
step; the joint guard's kept state; the joint checkpoint round trip; the
reusable fine-tuner; the data-parallel body's global draws on two gloo
ranks. The card's side (capture, replay, NCCL) is ``chip_smoke.py``'s
phase 15.
"""

from __future__ import annotations

import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_joint as TJT
from point2cyl_torch.core.config import TrainConfig as TorchTrainConfig
from point2cyl_torch.core.convert import (encoder_state_dict_from_jax,
                                          implicit_state_dict_from_jax)
from point2cyl_torch.losses import igr as port_igr
from point2cyl_torch.models.backbone import Backbone as TorchBackbone
from point2cyl_torch.models.implicit import ImplicitNet, PointNetEncoder
from point2cyl_torch.parallel.mesh import Mesh
from point2cyl_torch.recon import reconstruct as TR
from point2cyl_torch.train import steps as tsteps
from point2cyl_torch.train import train_joint as TJ
from point2cyl_tpu.core.config import TrainConfig
from point2cyl_tpu.losses import igr as jax_igr
from point2cyl_tpu.train import train_joint as JTJ
from test_torch_graphs import _no_host_reads
from test_torch_parallel import finish_ranks, start_ranks
from test_torch_train import LOSS_FLAGS, backbone_config, numpy_batch, torch_config

B, K, S, L = TJT.B, TJT.K, TJT.S, TJT.L


def torch_batch(dead_slot: bool = False, dtype=torch.float32) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32 else torch.from_numpy(v)
            for k, v in TJT.numpy_batch(dead_slot).items()}


def assert_rule(got: dict, want: dict, what: str) -> None:
    """Trainer A's rule: each tensor within 1e-3 of its own largest entry
    plus 1e-5 of the largest of any."""
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= 1e-3 * float(w.abs().max()) + 1e-5 * top, (what, name, err, top)


def first_moments(trainer_params, optimizer) -> list[torch.Tensor]:
    return [optimizer.state[p]["exp_avg"] for p in trainer_params]


def jax_implicit_stack(seed: int):
    """``test_torch_joint.jax_implicit_stack`` with the encoders' inits
    jitted (the same weights in a fraction of the time; the decoder's
    geometric init, jitted, moves a weight by an ulp)."""
    implicit = TJT.JI.ImplicitNet(**TJT.DECODER)
    im = jax.device_get(implicit.init(jax.random.key(seed + 1),
                                      jnp.zeros((1, TJT.DECODER["d_in"])))["params"])
    encoder = TJT.JI.PointNetEncoder(L, 2, True)
    enc, loaded = jax.device_get(jax.jit(lambda: tuple(
        encoder.init(jax.random.key(seed + i), jnp.zeros((1, S, 4)), train=False)
        for i in (2, 3)))())
    return ((implicit, im), (encoder, TJT.bn_drawn(enc, seed + 2)),
            TJT.bn_drawn(loaded, seed + 3))


def jax_nets(seed: int):
    """``test_torch_joint.jax_nets`` with the inits jitted."""
    key = jax.random.key(seed)
    backbone = TJT.jax_backbone_module.Backbone(TJT.CFG)
    variables = jax.jit(lambda k: backbone.init({"params": k, "sample": k, "dropout": k},
                                                jnp.zeros((1, TJT.N, 3)), train=False))(key)
    return ((backbone, TJT.bn_drawn(variables, seed)), *jax_implicit_stack(seed))


def test_joint_step_body_matches_jax_jitted_step(monkeypatch):
    """The joint trainer's step body (one ``train_step``, run eagerly on
    the CPU) against JAX's jitted ``make_joint_train_step`` from the same
    weights and batch, with the deterministic segment draw and the same
    off-surface samples on both sides, in float64 as
    ``tests/test_torch_joint.py`` holds the joint loss: the loss parts
    within that test's 1e-5 (proxy) and 1e-4 (implicit) absolute, the
    encoder's BN statistics within 1e-5, Adam's first moment (a tenth of
    the gradient) by Trainer A's rule, and the step, the group's count and
    ``skipped`` exactly. The flags are ``use_gt_im`` with the backbone
    frozen: the jitted program with the backbone's backward takes about
    35 s to compile on a CPU (``test_torch_joint.py`` holds the
    trained backbone's loss and gradients against JAX's)."""
    jnets = jax_nets(3)
    (backbone_j, (pc_p, pc_bn)), (implicit_j, im), (encoder_j, (enc_p, enc_bn)), loaded = jnets
    batch, off = TJT.numpy_batch(False), TJT.off_surface(6)
    jcfg = TrainConfig(batch_size=B, **LOSS_FLAGS)
    real_projection = JTJ.sketch_projection
    monkeypatch.setattr(JTJ, "sketch_projection",
                        lambda key, *a, **kw: real_projection(None, *a, **kw))
    monkeypatch.setattr(jax_igr, "sample_off_surface",
                        lambda key, pts: jnp.asarray(off, dtype=pts.dtype))
    with jax.enable_x64(True):
        tx = JTJ.make_joint_optimizer(jcfg, False, True)
        params = TJT.float64({"pc": pc_p, "enc": enc_p})
        state = JTJ.JointTrainState(
            pc_params=params["pc"], pc_bn=TJT.float64(pc_bn), enc_params=params["enc"],
            enc_bn=TJT.float64(enc_bn), im_params=TJT.float64(im),
            loaded_enc_params=TJT.float64(loaded[0]), loaded_enc_bn=TJT.float64(loaded[1]),
            opt_state=tx.init(params), step=jnp.int32(0))
        step = JTJ.make_joint_train_step(backbone_j, implicit_j, encoder_j, encoder_j, jcfg,
                                         tx, S, is_pc_train=False, is_im_train=True,
                                         with_im_loss=True, is_l2=False, use_gt_im=True)
        new, aux = jax.device_get(step(state, TJT.float64(batch), jax.random.key(17)))

    off64 = torch.from_numpy(off.astype(np.float64))
    monkeypatch.setattr(port_igr, "sample_off_surface", lambda generator, pts: off64)
    nets = [net.double() for net in TJT.port_nets(jnets)]
    trainer = TJ.JointTrainer(*nets, TorchTrainConfig(batch_size=B, **LOSS_FLAGS),
                              num_sk_points=S, is_pc_train=False, is_im_train=True,
                              with_im_loss=True, use_gt_im=True)
    got = trainer.train_step(torch_batch(dtype=torch.float64), None)
    for name in TJT.PROXY:
        np.testing.assert_allclose(float(got[name]), float(aux[name]), atol=1e-5, err_msg=name)
    for name in TJT.IGR_PARTS:
        np.testing.assert_allclose(float(got[name]), float(aux[name]), atol=1e-4, err_msg=name)
    assert float(got["skipped"]) == float(aux["skipped"]) == 0.0
    assert int(trainer.step) == int(new.step) == 1
    assert [int(g.count) for g in trainer._groups] == [1]

    encoder = trainer.encoder
    want_bn = encoder_state_dict_from_jax(new.enc_params, new.enc_bn)
    for name, buf in encoder.named_buffers():
        if name.endswith("num_batches_tracked"):
            assert int(buf) == 1
            continue
        np.testing.assert_allclose(buf.numpy(), want_bn[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    mu = encoder_state_dict_from_jax(optax.tree_utils.tree_get(new.opt_state, "mu")["enc"],
                                     new.enc_bn)
    names = [n for n, _ in encoder.named_parameters()]
    assert_rule(dict(zip(names, first_moments(encoder.parameters(), trainer.optimizer))),
                {n: mu[n] for n in names}, "encoder first moment")


def test_pretrain_step_body_matches_jax_jitted_step(monkeypatch):
    """The pretrainer's step body against JAX's jitted
    ``make_im_pretrain_step`` (``optax.adam(1e-3)``) from the same weights
    and batch with the same off-surface samples, in float32 as
    ``tests/test_torch_joint.py::test_pretrain_step_matches_jax``: the
    loss parts within 1e-5, the encoder's BN statistics within 1e-5,
    Adam's first moment of every decoder and encoder weight by Trainer
    A's rule, one step."""
    (implicit_j, im), (encoder_j, (enc_p, enc_bn)), _ = jax_implicit_stack(5)
    batch, off = TJT.numpy_batch(False), TJT.off_surface(7)
    monkeypatch.setattr(jax_igr, "sample_off_surface", lambda key, pts: jnp.asarray(off))
    tx = optax.adam(1e-3)
    params = {"im": im, "enc": enc_p}
    step = JTJ.make_im_pretrain_step(implicit_j, encoder_j, tx)
    new_p, new_bn, new_opt, aux = jax.device_get(
        step(params, enc_bn, tx.init(params), batch, jax.random.key(0)))

    monkeypatch.setattr(port_igr, "sample_off_surface",
                        lambda generator, pts: torch.from_numpy(off))
    implicit = ImplicitNet(**TJT.DECODER)
    implicit.load_state_dict(implicit_state_dict_from_jax(im), strict=True)
    encoder = PointNetEncoder(L, 2, True)
    encoder.load_state_dict(encoder_state_dict_from_jax(enc_p, enc_bn), strict=True)
    pre = TJ.ImPretrainer(implicit, encoder)
    got = pre.train_step(torch_batch(), None)
    for name in ("total", "manifold", "eikonal", "sald"):
        np.testing.assert_allclose(float(got[name]), float(aux[name]), atol=1e-5,
                                   err_msg=name)
    assert float(got["skipped"]) == 0.0 and int(pre.step) == 1

    want_bn = encoder_state_dict_from_jax(new_p["enc"], new_bn)
    for name, buf in encoder.named_buffers():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(buf.numpy(), want_bn[name].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    mu = optax.tree_utils.tree_get(new_opt, "mu")
    want = {**{f"im.{k}": v for k, v in implicit_state_dict_from_jax(mu["im"]).items()},
            **{f"enc.{k}": v for k, v in encoder_state_dict_from_jax(mu["enc"],
                                                                     enc_bn).items()}}
    named = [(f"im.{n}", p) for n, p in implicit.named_parameters()] + [
        (f"enc.{n}", p) for n, p in encoder.named_parameters()]
    moments = tsteps._views(pre._moments[0], [p for _, p in named])
    assert_rule({n: m for (n, _), m in zip(named, moments)}, {n: want[n] for n, _ in named},
                "first moment")


def joint_trainer(**kw) -> TJ.JointTrainer:
    return TJT.small_trainer(**kw)


@pytest.mark.parametrize("which", ["joint", "joint_chunked", "pretrain", "finetune"])
def test_step_bodies_read_nothing_back(which, monkeypatch):
    """The joint step (with and without IGR chunks), the pretrain step and
    one fine-tune step, twice each, with ``__bool__``, ``item``,
    ``tolist``, ``cpu``, ``numpy``, ``__float__`` and ``__int__`` of every
    tensor raising: a captured step may hold no host sync."""
    batch = torch_batch()
    gen = torch.Generator().manual_seed(3)
    if which.startswith("joint"):
        trainer = joint_trainer(igr_chunk=4 if which == "joint_chunked" else None)
        _no_host_reads(monkeypatch)
        for _ in range(2):
            trainer.train_step(batch, gen)
    elif which == "pretrain":
        implicit, encoder = ImplicitNet(**TJT.DECODER), PointNetEncoder(L, 2, True)
        encoder.reset_parameters(torch.Generator().manual_seed(4))
        pre = TJ.ImPretrainer(implicit, encoder)
        _no_host_reads(monkeypatch)
        for _ in range(2):
            pre.train_step(batch, gen)
    else:
        tuner = TR.FineTuner(ImplicitNet(**TJT.DECODER))
        sk = batch["sketches"][0, 0]
        inputs = {"lat": torch.nn.functional.normalize(torch.ones(1, 1, L), dim=-1),
                  "pts": sk[None, None, :, :2], "nrm": sk[None, None, :, 2:]}
        _no_host_reads(monkeypatch)
        for _ in range(2):
            tuner._step(inputs, gen)


def test_joint_adam_counts_per_group_across_a_checkpoint():
    """From a carried step of 5 (``--init_global_step 5``): two updates
    of both groups, a checkpoint, and two more on a trainer that loaded it
    equal ``optax.multi_transform`` (the backbone's staircase offset by 5,
    the encoder at 1e-3) after four updates, within float32 rounding: the
    checkpoint carries each group's count (2) apart from the step (7), and
    the bias correction takes the group's count, not the step."""
    jcfg = TrainConfig(batch_size=2, learning_rate=1e-2, decay_step=8, decay_rate=0.5)
    tcfg = TorchTrainConfig(batch_size=2, learning_rate=1e-2, decay_step=8, decay_rate=0.5)
    trainer = joint_trainer(cfg=tcfg, step=5)
    nets = {"pc": trainer.backbone, "enc": trainer.encoder}
    jp = {g: {n: jnp.asarray(p.detach().numpy()) for n, p in net.named_parameters()}
          for g, net in nets.items()}
    tx = JTJ.make_joint_optimizer(jcfg, True, True, lr_step_offset=5)
    state = tx.init(jp)
    rng = np.random.default_rng(12)
    for i in range(4):
        if i == 2:
            saved = io.BytesIO()
            torch.save(trainer.state_dict(), saved)
            ckpt = torch.load(io.BytesIO(saved.getvalue()), weights_only=True)
            assert ckpt["step"] == 7 and all(
                float(st["step"]) == 2.0 for st in ckpt["optimizer"]["state"].values())
            trainer = joint_trainer(cfg=tcfg, step=0)
            trainer.load_state_dict(ckpt)
            nets = {"pc": trainer.backbone, "enc": trainer.encoder}
        g = {grp: {n: rng.normal(size=v.shape).astype(np.float32) for n, v in tree.items()}
             for grp, tree in jp.items()}
        updates, state = jax.jit(tx.update)(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for grp, net in nets.items():
            for n, p in net.named_parameters():
                p.grad.copy_(torch.from_numpy(g[grp][n]))
        trainer._update(torch.tensor(True))
    assert int(trainer.step) == 9 and [int(g.count) for g in trainer._groups] == [4, 4]
    for grp, net in nets.items():
        for n, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[grp][n]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{grp}.{n}")


def joint_state(trainer) -> dict[str, torch.Tensor]:
    """Every tensor of a joint trainer's state."""
    out = {f"{name}.{k}": v for name in ("backbone", "implicit", "encoder", "loaded_encoder")
           for k, v in getattr(trainer, name).state_dict().items()}
    for g in trainer._groups:
        out[f"{g.name}.moments"], out[f"{g.name}.count"] = g.moments, g.count
    out["step"] = trainer.step
    return out


def test_joint_guard_keeps_state_and_the_next_step_matches():
    """After a finite step, a batch with NaN normals leaves every state
    tensor (both nets' parameters and BN statistics and counts, both Adam
    groups' moments and counts, the step) bit for bit; the next finite
    step then equals, bit for bit, the step of a trainer that never saw
    the bad batch (the same draws)."""
    batch = torch_batch()
    bad = dict(batch, normals=torch.full_like(batch["normals"], float("nan")))
    seen, unseen = joint_trainer(step=3), joint_trainer()
    unseen.load_state_dict(seen.state_dict())  # the decoder too
    for trainer in (seen, unseen):
        trainer.train_step(batch, torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in joint_state(seen).items()}
    aux = seen.train_step(bad, torch.Generator().manual_seed(2))
    assert float(aux["skipped"]) == 1.0 and not np.isfinite(float(aux["total"]))
    for name, val in joint_state(seen).items():
        assert torch.equal(val, before[name]), name
    assert int(seen.step) == 4 and [int(g.count) for g in seen._groups] == [1, 1]
    got = seen.train_step(batch, torch.Generator().manual_seed(3))
    want = unseen.train_step(batch, torch.Generator().manual_seed(3))
    assert float(got["skipped"]) == 0.0
    assert all(torch.equal(got[k], want[k]) for k in want)
    want_state = joint_state(unseen)
    for name, val in joint_state(seen).items():
        assert torch.equal(val, want_state[name]), name


def test_joint_checkpoint_round_trip_in_place_and_old_layout():
    """``state_dict`` keeps the reference's 3-net layout, the step as an
    int and Adam in torch's layout with each parameter's ``step`` its
    group's count; ``load_state_dict`` writes every tensor in place (what
    a captured step reads keeps its address). A checkpoint of the eager
    joint trainer (torch's ``Adam.state_dict`` of two named groups after
    ``Adam.step``, its per-parameter CPU step counts) loads."""
    batch = torch_batch()
    src = joint_trainer(step=4)
    src.train_step(batch, torch.Generator().manual_seed(1))
    buf = io.BytesIO()
    torch.save(src.state_dict(), buf)
    state = torch.load(io.BytesIO(buf.getvalue()), weights_only=True)
    assert type(state["step"]) is int and state["step"] == 5
    assert {"model", "implicit_net", "pn_encoder", "loaded_encoder"} <= set(state)
    assert [g["name"] for g in state["optimizer"]["param_groups"]] == ["pc", "enc"]
    dst = joint_trainer()
    tensors = lambda t: [*joint_state(t).values()]  # noqa: E731
    ptrs = [v.data_ptr() for v in tensors(dst)]
    dst.load_state_dict(state)
    assert ptrs == [v.data_ptr() for v in tensors(dst)]
    want = joint_state(src)
    for name, val in joint_state(dst).items():
        assert torch.equal(val, want[name]), name

    # the eager trainer's layout: torch's Adam stepped once on random grads
    old = joint_trainer()
    groups = [{"params": list(net.parameters()), "name": name}
              for net, name in ((old.backbone, "pc"), (old.encoder, "enc"))]
    opt = TJ._adam(groups)
    gen = torch.Generator().manual_seed(6)
    for group in groups:
        for p in group["params"]:
            p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    ckpt = {"model": old.backbone.state_dict(), "implicit_net": old.implicit.state_dict(),
            "pn_encoder": old.encoder.state_dict(),
            "loaded_encoder": old.loaded_encoder.state_dict(),
            "optimizer": opt.state_dict(), "step": 11}
    dst.load_state_dict(ckpt)
    assert int(dst.step) == 11 and [int(g.count) for g in dst._groups] == [1, 1]
    params = [p for group in groups for p in group["params"]]
    for p, st in zip(params, dst.optimizer.state.values()):
        assert torch.equal(st["exp_avg"], opt.state[p]["exp_avg"])
        assert torch.equal(st["exp_avg_sq"], opt.state[p]["exp_avg_sq"])
    for (name, a), b in zip(dst.backbone.named_parameters(), old.backbone.parameters()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="Adam groups"):
        joint_trainer(is_pc_train=False).load_state_dict(ckpt)


def sketch_instance(seed: int):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=L).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, 40)
    ring = np.stack([np.cos(th), np.sin(th)], -1)
    return (torch.from_numpy(lat / np.linalg.norm(lat)),
            torch.from_numpy((ring * [0.8, 0.5]).astype(np.float32)),
            torch.from_numpy(ring.astype(np.float32)))


def test_fine_tuner_reused_equals_fresh_calls():
    """One ``FineTuner`` tuning two instances in a row (each from the
    start weights, loaded in place into the same decoder) gives, bit for
    bit, the weights and steps of two fresh ``igr_finetune`` calls with
    generators of the same seeds; the tuned decoder keeps its tensors."""
    start = ImplicitNet(**TJT.DECODER)
    start.reset_parameters(torch.Generator().manual_seed(7))
    tuner = TR.FineTuner(start)
    ptrs = [p.data_ptr() for p in tuner.decoder.parameters()]
    for i, (eps, want_steps) in enumerate(((1e-12, 6), (1e3, 4))):
        inst = sketch_instance(20 + i)
        steps = tuner.tune(start, *inst, torch.Generator().manual_seed(30 + i), max_steps=6,
                           eps_loss=eps, check_every=2)
        got = tuner.tuned_copy()
        want, want_n = TR.igr_finetune(start, *inst, torch.Generator().manual_seed(30 + i),
                                       max_steps=6, eps_loss=eps, check_every=2)
        assert steps == want_n == want_steps
        for (name, a), b in zip(got.state_dict().items(), want.state_dict().values()):
            assert torch.equal(a, b), name
            assert not torch.equal(a, start.state_dict()[name]), f"{name} did not move"
    assert ptrs == [p.data_ptr() for p in tuner.decoder.parameters()]


def test_step_graphs_of_a_mesh():
    """A data-parallel owner's graphs: captured in ``thread_local`` error
    mode over a mesh on the card, eager over a host-staged mesh with
    ``eager_because`` saying so, eager on the CPU and with
    ``graph=False``."""
    card = torch.device("cuda", 0)
    nccl = Mesh(group=object(), rank=0, world=2, device=card)
    staged = dataclasses.replace(nccl, host_staged=True)
    g = tsteps.step_graphs(card, True, nccl)
    assert g.enabled and g.eager_because is None and g.capture_error_mode == "thread_local"
    g = tsteps.step_graphs(card, True, None)
    assert g.enabled and g.capture_error_mode == "global"
    g = tsteps.step_graphs(card, True, staged)
    assert not g.enabled and g.eager_because == "host-staged mesh"
    assert tsteps.step_graphs(card, False, nccl).eager_because == "graph=False"
    assert tsteps.step_graphs(torch.device("cpu"), True, None).eager_because == "cpu"


def test_dp_body_builds_row_draws_inside(tmp_path):
    """Two gloo ranks of 2 rows each, noise and dropout on: Trainer A's
    data-parallel ``train_step``, whose body builds the global batch's
    ``RowDraws`` from the generator it is handed, equals bit for bit the
    body called with the ``RowDraws`` built by its caller (the step
    before capture): the loss scalars, every gradient, the weights, BN
    statistics and Adam's moments, the step and the generator's state;
    and its loss equals the one-process step on the 4 rows within 1e-5."""
    cfg = torch_config(backbone_config(K, 96), dropout_rate=0.5)
    model = TorchBackbone(cfg)
    model.reset_parameters(torch.Generator().manual_seed(2))
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(1, 4, K, 96).items()}
    tcfg = TorchTrainConfig(batch_size=4, add_noise=True, **LOSS_FLAGS)
    inputs = {"cfg": cfg, "state": model.state_dict(), "batch": batch, "tcfg": tcfg,
              "seed": 13}
    root = str(tmp_path / "graphs")
    procs = start_ranks("graphs", 2, root, inputs)
    try:
        one = tsteps.Trainer(model, tcfg).train_step(batch, torch.Generator().manual_seed(13))
    finally:
        results = finish_ranks(procs, root)
    for rank in results:
        inside, caller = rank["inside"], rank["caller"]
        assert torch.equal(inside["vals"], caller["vals"])
        assert torch.equal(inside["generator"], caller["generator"])
        assert all(torch.equal(a, b) for a, b in zip(inside["grads"], caller["grads"]))
        assert all(torch.equal(v, caller["state"][k]) for k, v in inside["state"].items())
        assert torch.equal(inside["moments"], caller["moments"])
        assert inside["step"] == caller["step"] == 1
        for key, val in zip(tsteps.AUX_KEYS, inside["vals"]):
            np.testing.assert_allclose(float(val), float(one[key]), rtol=1e-5, atol=1e-5,
                                       err_msg=key)
    assert os.path.exists(os.path.join(root, "rank1.pt"))
