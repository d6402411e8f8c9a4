"""Trainer A of the port (point2cyl_torch.train) against the JAX
package's trainer, on the CPU at a small size.

One train-mode step's loss, parameter gradients and BN running statistics
are held against ``jax.value_and_grad`` of the JAX step's loss function
(``point2cyl_tpu/train/steps.py:208-226``) from the same weights, batch
and FPS starts (recorded from JAX's own draw), with dropout at 0; Adam
against optax; the schedules, the synthetic generator and the batch
assembly against their JAX counterparts; and the CLI end to end.
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

from point2cyl_torch.core.config import BackboneConfig as TorchConfig
from point2cyl_torch.core.config import TrainConfig as TorchTrainConfig
from point2cyl_torch.core.convert import backbone_state_dict_from_jax
from point2cyl_torch.core.schedules import staircase_bn_momentum, staircase_lr
from point2cyl_torch.data.h5_io import load_h5 as torch_load_h5
from point2cyl_torch.data.pipeline import InputPipeline as TorchPipeline
from point2cyl_torch.data.synthetic import generate_dataset as torch_generate
from point2cyl_torch.models.backbone import Backbone as TorchBackbone
from point2cyl_torch.models.layers import dropout
from point2cyl_torch.ops.matching import hungarian_matching as torch_matching
from point2cyl_torch.train import steps as tsteps
from point2cyl_torch.train.train_pc import cli_main
from point2cyl_tpu.core import schedules as jax_schedules
from point2cyl_tpu.core.config import BackboneConfig, TrainConfig
from point2cyl_tpu.data.h5_io import save_h5
from point2cyl_tpu.data.pipeline import InputPipeline
from point2cyl_tpu.data.synthetic import generate_dataset
from point2cyl_tpu.models import backbone as jax_backbone_module
from point2cyl_tpu.models.backbone import Backbone
from point2cyl_tpu.ops.matching import _permutation_onehots
from point2cyl_tpu.ops.matching import hungarian_matching as jax_matching
from point2cyl_tpu.ops.matching import relaxed_iou_cost
from point2cyl_tpu.train import steps as jsteps

K = 4
N = 128
CFG = BackboneConfig(
    num_points=N,
    sa_npoints=(32, 8),
    sa_radii=(0.3, 0.6),
    sa_nsamples=(16, 8),
    sa_mlps=((16, 32), (32, 64)),
    sa_global_mlp=(64, 128),
    fp_mlps=((64,), (32,), (32, 32)),
    fc_width=32,
    dropout_rate=0.0,
    output_sizes=(3, 2 * K),
    approx_neighbors=False,
)
LOSS_FLAGS = dict(pred_seg=True, pred_normal=True, pred_bb=True, pred_extrusion=True,
                  pred_center=True)


def torch_config(**kw) -> TorchConfig:
    return dataclasses.replace(TorchConfig.from_dict(dataclasses.asdict(CFG)), **kw)


def jax_variables(seed: int):
    """JAX init with non-trivial BN affine parameters and statistics."""
    model = Backbone(CFG)
    key = jax.random.key(seed)
    variables = model.init({"params": key, "sample": key, "dropout": key},
                           jnp.zeros((1, N, 3)), train=False)
    rng = np.random.default_rng(seed)

    def bn(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "scale" or name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("bias", "mean") and "TorchBatchNorm" in str(path):
            return rng.normal(0.0, 0.1, shape).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(bn, jax.device_get(variables["params"]))
    stats = jax.tree_util.tree_map_with_path(bn, jax.device_get(variables["batch_stats"]))
    return model, params, stats


def numpy_batch(seed: int, b: int = 2) -> dict[str, np.ndarray]:
    """A batch of ``b`` synthetic solids subsampled to N points, with no
    point pair within 1e-5 of either squared ball-query radius (the JAX
    CPU path measures distances by expansion, the port by differences)."""
    ds = generate_dataset(b, resolution=512, max_instances=K, num_sketch_points=16,
                          seed=seed)
    rng = np.random.default_rng(seed)
    sub = np.stack([rng.permutation(512)[:N] for _ in range(b)])
    take = lambda a: np.take_along_axis(a, sub if a.ndim == 2 else sub[..., None], 1)
    batch = {
        "point_cloud": take(ds.point_cloud), "normals": take(ds.normals),
        "extrusion_labels": take(ds.extrusion_labels).astype(np.int32),
        "base_barrel_labels": take(ds.base_barrel_labels).astype(np.int32),
        "extrusion_axes": ds.extrusion_axes.astype(np.float32),
        "extrusion_centers": ds.extrusion_centers.astype(np.float32),
    }
    pts = batch["point_cloud"].astype(np.float64)
    d2 = ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)
    for r in CFG.sa_radii:
        assert np.abs(d2 - r * r).min() > 1e-5, f"seed {seed}: a pair sits at radius {r}"
    return batch


@pytest.mark.parametrize("seed", [1, 2])
def test_train_step_loss_grads_and_bn_match_jax(seed, monkeypatch):
    """One train-mode step from identical weights, batch and FPS starts:
    the loss and its parts within 1e-5, every parameter's gradient within
    1e-3 of its own scale plus 1e-5 of the largest (a bias in front of
    batch-statistics BN has a zero gradient and carries only summation
    noise; chip_smoke.py holds the card's atomics to 1e-4), and the
    updated BN running statistics within 1e-5 (absolute and relative; the
    two sides sum the batch in different orders)."""
    model, params, stats = jax_variables(seed)
    batch = numpy_batch(seed)
    jcfg = TrainConfig(batch_size=2, **LOSS_FLAGS)
    momentum = 0.5
    starts = []
    fps = jax_backbone_module.farthest_point_sample

    def recording_fps(xyz, npoint, key=None, start_idx=0):
        b, n, _ = xyz.shape
        starts.append(np.asarray(jax.random.randint(key, (b,), 0, n, dtype=jnp.int32)))
        return fps(xyz, npoint, key=key, start_idx=start_idx)

    monkeypatch.setattr(jax_backbone_module, "farthest_point_sample", recording_fps)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(100 + seed)

    def loss_fn(p):
        (x_raw, w_raw), mutated = model.apply(
            {"params": p, "batch_stats": stats}, batch_j["point_cloud"], train=True,
            bn_momentum=momentum, rngs={"sample": key, "dropout": key},
            mutable=["batch_stats"])
        heads = jsteps.assemble_heads(x_raw, w_raw, True, True, k=K)
        total, aux = jsteps.proxy_losses(heads, batch_j, jcfg)
        return total, (aux, mutated["batch_stats"], heads.w)

    (loss, (aux, new_stats, w_jax)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert len(starts) == len(CFG.sa_npoints)
    # the matching must be clear-cut for a gradient comparison: the best
    # permutation beats the second by more than float noise
    cost = relaxed_iou_cost(w_jax, batch_j["extrusion_labels"])
    scores = np.sort(np.einsum("bkj,pkj->bp", np.asarray(cost), _permutation_onehots(K)), -1)
    assert (scores[:, -1] - scores[:, -2]).min() > 1e-4

    port = TorchBackbone(torch_config())
    port.load_state_dict(backbone_state_dict_from_jax(params, stats), strict=True)
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    x_raw, w_raw = port(batch_t["point_cloud"], train=True, bn_momentum=momentum,
                        fps_starts=[torch.from_numpy(s.copy()) for s in starts])
    heads = tsteps.assemble_heads(x_raw, w_raw, True, True, k=K)
    total, aux_t = tsteps.proxy_losses(heads, batch_t, TorchTrainConfig(**LOSS_FLAGS))
    total.backward()

    matching_j, _ = jax_matching(w_jax, batch_j["extrusion_labels"])
    matching_t, _ = torch_matching(heads.w, batch_t["extrusion_labels"])
    np.testing.assert_array_equal(matching_t.numpy(), np.asarray(matching_j))
    np.testing.assert_allclose(total.item(), float(loss), rtol=1e-5, atol=1e-5)
    for name in ("normal", "miou", "bb", "extrusion", "center"):
        np.testing.assert_allclose(aux_t[name].item(), float(aux[name]), atol=1e-5,
                                   err_msg=name)

    want = backbone_state_dict_from_jax(grads, stats)
    top = max(float(v.abs().max()) for v in want.values())
    for name, p in port.named_parameters():
        ref = want[name]
        scale = float(ref.abs().max())
        err = float((p.grad - ref).abs().max())
        assert err <= 1e-3 * scale + 1e-5 * top, (name, err, scale, top)
    stats_want = backbone_state_dict_from_jax(params, new_stats)
    for name, buf in port.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats_want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_dropout_mask_rate_and_scale():
    """Kept elements are scaled by 1/(1-rate); the dropped share is the
    rate (1e-2 at 2e5 draws, about 4.5 standard deviations)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    for rate in (0.5, 0.2):
        y = dropout(x, rate, gen)
        kept = y != 0
        assert abs(1.0 - kept.float().mean().item() - rate) < 1e-2
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1.0 / (1.0 - rate)))
    assert dropout(x, 0.0, gen) is x


def test_adam_step_matches_optax():
    """Three updates across a staircase boundary: the port's Adam (the
    Trainer's ``apply_update``) equals optax's adam on the same schedule
    within float32 rounding."""
    jcfg = TrainConfig(batch_size=2, learning_rate=1e-2, decay_step=4, decay_rate=0.5)
    tcfg = TorchTrainConfig(batch_size=2, learning_rate=1e-2, decay_step=4,
                            decay_rate=0.5)
    rng = np.random.default_rng(3)
    init = {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]
    tx = jsteps.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = tsteps.make_optimizer(tp.values(), tcfg)
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        tsteps.apply_update(opt, tcfg, step)
    for k in init:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 49_999, 50_000, 100_000, 1_000_000])
def test_schedules_match_jax(step):
    got_lr = staircase_lr(step, 4, 1e-3)
    got_m = staircase_bn_momentum(step, 4)
    np.testing.assert_allclose(got_lr, float(jax_schedules.staircase_lr(step, 4, 1e-3)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        got_m, float(jax_schedules.staircase_bn_momentum(step, 4)), rtol=1e-6)


def test_guard_keeps_the_whole_state_on_a_non_finite_step():
    """A NaN loss (from NaN normals, which the forward never reads) leaves
    parameters, BN statistics, Adam's state and the step as they were,
    though the forward had already moved the BN statistics."""
    model = TorchBackbone(torch_config(dropout_rate=0.5))
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = tsteps.Trainer(model, TorchTrainConfig(batch_size=2, **LOSS_FLAGS))
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(1).items()}
    gen = torch.Generator().manual_seed(1)
    aux = trainer.train_step(batch, gen)
    assert float(aux["skipped"]) == 0.0 and trainer.step == 1
    before = {k: v.clone() for k, v in model.state_dict().items()}
    adam = {i: {k: v.clone() for k, v in st.items()}
            for i, st in trainer.optimizer.state_dict()["state"].items()}
    bad = dict(batch, normals=torch.full_like(batch["normals"], float("nan")))
    aux = trainer.train_step(bad, gen)
    assert float(aux["skipped"]) == 1.0 and trainer.step == 1
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    after = trainer.optimizer.state_dict()["state"]
    for i, st in adam.items():
        for k, v in st.items():
            torch.testing.assert_close(after[i][k], v, rtol=0, atol=0)


def test_synthetic_generator_equals_jax():
    want = generate_dataset(3, resolution=256, max_instances=K, num_sketch_points=16,
                            seed=3)
    got = torch_generate(3, resolution=256, max_instances=K, num_sketch_points=16,
                         seed=3)
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        assert a.dtype == b.dtype, field.name
        np.testing.assert_array_equal(a, b, err_msg=field.name)


def test_gather_equals_jax_gather_batch():
    """The port's batch of given rows and subsample indices equals JAX's
    ``_gather_batch`` with the indices its key draws."""
    ds = generate_dataset(4, resolution=512, max_instances=K, num_sketch_points=16,
                          seed=0)
    rows = np.array([2, 0], np.int32)
    key = jax.random.key(5)
    want = InputPipeline(ds, N, K).batch(rows, key)
    k_pt, _ = jax.random.split(key)
    sub_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(k_pt, jnp.arange(2))
    sub_idx = jax.vmap(lambda kk: jax.random.permutation(kk, 512)[:N])(sub_keys)
    got = TorchPipeline(torch_generate(4, resolution=512, max_instances=K,
                                       num_sketch_points=16, seed=0), N, K, "cpu"
                        ).gather(torch.from_numpy(rows), torch.from_numpy(np.asarray(sub_idx).copy()))
    assert set(got) <= set(want)
    for name, val in got.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(want[name]), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_h5_pack_loads_as_written(tmp_path):
    ds = generate_dataset(2, resolution=128, max_instances=K, num_sketch_points=16, seed=1)
    path = str(tmp_path / "pack.h5")
    save_h5(path, ds)
    back = torch_load_h5(path)
    for field in dataclasses.fields(ds):
        np.testing.assert_allclose(getattr(back, field.name), getattr(ds, field.name),
                                   atol=1e-7, err_msg=field.name)


def test_synthetic_path_imports_no_h5py():
    code = ("import sys\nimport point2cyl_torch.train.train_pc\n"
            "assert 'h5py' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def _epoch_losses(logdir: str) -> list[float]:
    with open(os.path.join(logdir, "log.txt")) as f:
        return [float(m) for m in re.findall(r"> Epoch \d+ done .*?Loss/total: ([0-9.]+)",
                                             f.read())]


def test_cli_trains_on_cpu_and_resumes(tmp_path):
    """Two epochs of 32 synthetic solids at N=128 on the CPU: the epoch
    mean of the loss falls, a checkpoint in the reference layout is
    written, and a resume (with tensorboard scalars) continues the step
    and the epoch."""
    logdir = str(tmp_path / "run")
    args = ["--synthetic", "32", "--num_point", str(N), "--K", str(K),
            "--batch_size", "2", "--synthetic_resolution", "512",
            "--learning_rate", "0.003", "--device", "cpu", "--logdir", logdir,
            "--pred_seg", "--pred_normal", "--pred_bb", "--pred_extrusion",
            "--pred_center"]
    trainer = cli_main(args + ["--num_epochs", "2"])
    assert trainer.step == 32
    losses = _epoch_losses(logdir)
    assert len(losses) == 2 and losses[1] < losses[0], losses
    state = torch.load(os.path.join(logdir, "model.pth"), weights_only=True)
    assert state["epoch"] == 2 and state["step"] == 32
    assert set(state["model"]) == set(trainer.model.state_dict())
    resumed = cli_main(args + ["--num_epochs", "3", "--resume", "--tensorboard"])
    assert resumed.step == 48
    with open(os.path.join(logdir, "log.txt")) as f:
        assert "epoch 2, step 32" in f.read()
    assert len(_epoch_losses(logdir)) == 3
    assert os.listdir(os.path.join(logdir, "tb"))  # scalars only when asked


def test_matching_above_eight_instances_waits_for_lap():
    """K > 8 needs the Jonker-Volgenant solver, which waits in ROADMAP
    queue 1: the port raises rather than enumerate 9! permutations."""
    w = torch.softmax(torch.randn(1, 16, 9), dim=-1)
    with pytest.raises(NotImplementedError, match="queue 1"):
        torch_matching(w, torch.zeros(1, 16, dtype=torch.int64))
