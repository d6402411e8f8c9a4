"""bf16 compute in the port (``compute_dtype="bfloat16"``; ``"float16"``
takes the same code) against the JAX package's bf16 path, on the CPU at a
small size (B, N, K = 3, 96, 4, exact neighbours), where the port's dense
layers take the plain version of ``ops/lowp_dense.py``.

JAX's ``TorchDense`` rounds the input and the kernel to the compute dtype,
multiplies them with a float32 result and adds the float32 bias; its
transpose rounds each operand's gradient once to the compute dtype and
back. The plain version rounds at the same points and multiplies in
float32, and a product of two bf16 values is exact in float32, so a dense
layer agrees with JAX's up to float32 summation order: one ulp of the
compute dtype where a sum lands on a rounding boundary. Trainer A's bf16
step is in ``tests/test_torch_train.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.core.config import BackboneConfig as TorchConfig
from point2cyl_torch.core.config import TrainConfig
from point2cyl_torch.core.convert import backbone_state_dict_from_jax
from point2cyl_torch.eval import evaluator
from point2cyl_torch.models.backbone import build_backbone
from point2cyl_torch.models.layers import Dense
from point2cyl_torch.ops.lowp_dense import dense_lowp, dense_lowp_plain
from point2cyl_torch.serve import export as torch_export
from point2cyl_torch.serve.session import InferenceSession as TorchSession
from point2cyl_torch.train import train_joint as TJ
from point2cyl_torch.train import train_pc
from point2cyl_tpu.models.layers import TorchDense
from point2cyl_tpu.serve import InferenceSession, export_artifact
from test_torch_parallel import finish_ranks, one_process_forward, start_ranks
from test_torch_train import LOSS_FLAGS, backbone_config, jax_variables, numpy_batch, \
    torch_config

K, N, B = 4, 96, 3
SEED = 1  # a batch with no point pair at a ball-query radius (test_torch_parallel's)
BITS = {"bfloat16": 8, "float16": 11}  # significand bits, the implicit one included
CFG = dataclasses.replace(backbone_config(K, N), compute_dtype="bfloat16")
HEADS = ["--pred_seg", "--pred_normal", "--pred_bb", "--pred_extrusion", "--pred_center"]
TINY = ["--synthetic", "8", "--num_point", "64", "--K", str(K), "--batch_size", "4",
        "--synthetic_resolution", "128", "--device", "cpu", "--num_epochs", "1"]


def ulp(v: torch.Tensor, dtype: str) -> torch.Tensor:
    """One ulp of ``dtype`` at each magnitude of ``v`` (normal numbers)."""
    _, e = torch.frexp(v.abs())
    return torch.ldexp(torch.ones_like(v), e - BITS[dtype])


def summation_slack(abs_terms: torch.Tensor) -> torch.Tensor:
    """What two float32 summation orders may part by: 2^-20 of the sum of
    the terms' magnitudes (sums of at most a few hundred terms)."""
    return abs_terms * 2.0**-20


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("cin,cout", [(3, 16), (131, 32), (64, 3), (259, 16)])
def test_dense_matches_torch_dense(cin, cout, dtype):
    """One dense layer against ``TorchDense(dtype=...)`` on the same
    inputs (the backbone's unaligned widths 3, 131 and 259, the heads' 3
    and 16): the forward within float32 summation order of JAX's, the
    gradients of x and of the kernel within one ulp of the compute dtype
    plus that summation slack (a sum near a rounding boundary rounds the
    other way; where it cancels to below the slack, fp16's finer ulps
    show the slack itself), and the bias's within the slack. The result
    is not the float32 layer's."""
    rng = np.random.default_rng(cin + cout)
    x = rng.normal(size=(B, 24, 4, cin)).astype(np.float32)
    kernel = (rng.uniform(-1, 1, (cin, cout)) / np.sqrt(cin)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
    g = rng.normal(size=(B, 24, 4, cout)).astype(np.float32)
    mod = TorchDense(cout, dtype=jnp.dtype(dtype))
    y, vjp = jax.vjp(lambda p, v: mod.apply({"params": p}, v),
                     {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)},
                     jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))

    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(kernel.T.copy()).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    yt = dense_lowp(xt, wt, bt, tdt)
    yt.backward(torch.from_numpy(g))

    xa = torch.from_numpy(x).to(tdt).float().abs()
    wa = torch.from_numpy(kernel).to(tdt).float().abs()
    ga = torch.from_numpy(g).abs()
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    assert bool(((yt.detach() - t(y)).abs() <= summation_slack(xa @ wa + bt.abs())).all())
    for got, want, terms in ((xt.grad, t(gx), ga @ wa.t()),
                             (wt.grad.t(), t(gp["kernel"]),
                              xa.reshape(-1, cin).t() @ ga.reshape(-1, cout))):
        bound = ulp(torch.maximum(got.abs(), want.abs()), dtype) + summation_slack(terms)
        assert bool(((got - want).abs() <= bound).all())
    assert bool(((bt.grad - t(gp["bias"])).abs()
                 <= summation_slack(ga.reshape(-1, cout).sum(0))).all())
    with torch.no_grad():
        f32 = torch.from_numpy(x) @ torch.from_numpy(kernel) + bt
    assert not torch.equal(yt.detach(), f32)


def test_dense_module_routes_by_compute_dtype():
    """``Dense`` keeps float32 as the product it always was, takes the
    low-precision product for bf16 (the CPU's plain version under
    ``"auto"``), keeps its state_dict, and refuses a CPU tensor under
    ``impl="kernel"``."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 131, generator=gen)
    f32, bf16 = Dense(131, 16), Dense(131, 16, compute_dtype="bfloat16")
    f32.reset_parameters(gen)
    bf16.load_state_dict(f32.state_dict(), strict=True)
    w = f32.weight.reshape(16, 131)
    with torch.no_grad():
        assert torch.equal(f32(x), torch.matmul(x, w.t()) + f32.bias)
        assert torch.equal(bf16(x), dense_lowp_plain(x, w, bf16.bias, torch.bfloat16))
        bf16.impl = "kernel"
        with pytest.raises(ValueError, match="CUDA"):
            bf16(x)


@pytest.mark.parametrize("seed", [0, 3])
def test_backbone_eval_forward_matches_jax_bf16(seed):
    """The bf16 eval forward: x_raw and w_raw within 1e-4 of JAX's bf16
    forward (the float32 test's tolerance in ``tests/test_torch_backbone
    .py``), and more than that from the port's float32 forward on the same
    weights, so that a bf16 path that did nothing would fail."""
    model, params, stats = jax_variables(seed, CFG)
    pts = numpy_batch(10 + seed, B, K, N)["point_cloud"]
    want = jax.jit(lambda v, p: model.apply(v, p, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(pts))
    sd = backbone_state_dict_from_jax(params, stats)
    outs = {}
    for dtype in ("bfloat16", "float32"):
        port = build_backbone(torch_config(CFG, compute_dtype=dtype), state_dict=sd,
                              device="cpu")
        with torch.inference_mode():
            outs[dtype] = port(torch.from_numpy(pts))
    apart = 0.0
    for got, ref, f32 in zip(outs["bfloat16"], want, outs["float32"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
        apart = max(apart, float((got - f32).abs().max()))
    assert apart > 1e-4, apart


def test_bf16_artifact_serves_like_jax(tmp_path):
    """A JAX artifact whose ``backbone_config`` is bf16: its meta builds
    the port's config, the port's artifact of the same weights and config
    serves in bf16 on the CPU, and a request of 3 clouds (bucket 2: one
    chunk and a padded one) gives JAX's raw heads within 1e-4."""
    model, params, stats = jax_variables(5, CFG)
    jax_path, torch_path = str(tmp_path / "m.p2cx"), str(tmp_path / "m.p2ct")
    export_artifact(jax_path, {"params": params, "batch_stats": stats}, k=K,
                    backbone_config=CFG, buckets=(2,))
    with zipfile.ZipFile(jax_path) as z:
        meta = json.loads(z.read("meta.json"))
    cfg = TorchConfig.from_dict(meta["backbone_config"])
    assert cfg.compute_dtype == "bfloat16"
    torch_export.export_artifact(torch_path, backbone_state_dict_from_jax(params, stats),
                                 k=K, backbone_config=cfg, buckets=(2,))
    sess = TorchSession(torch_path, device="cpu")
    assert all(m.compute_dtype == torch.bfloat16 for m in sess.model.modules()
               if isinstance(m, Dense))
    pts = numpy_batch(20, B, K, N)["point_cloud"]
    want = InferenceSession(jax_path).predict(pts, assemble=False)
    got = sess.predict(pts, assemble=False)
    assert sess.stats["padded"] == 1
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, atol=1e-4, rtol=0, err_msg=key)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks (``tests/torch_rank_worker.py``'s ``bf16`` suite):
    Trainer A's data-parallel bf16 step with given FPS starts, and the
    point-sharded bf16 forward; the one-process references are computed
    while they run."""
    root = str(tmp_path_factory.mktemp("bf16_ranks"))
    _, params, stats = jax_variables(SEED, CFG)
    rng = np.random.default_rng(SEED)
    batch = numpy_batch(SEED, 4, K, N)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    inputs = {
        "cfg": torch_config(CFG), "state": backbone_state_dict_from_jax(params, stats),
        "k": K, "momentum": 0.5, "batch": {k: t(v) for k, v in batch.items()},
        "starts": [t(rng.integers(0, n, 4).astype(np.int32)) for n in (N, CFG.sa_npoints[0])],
        "tcfg": TrainConfig(batch_size=4, **LOSS_FLAGS),
        "pts": t(batch["point_cloud"][:2]),
    }
    procs = start_ranks("bf16", 2, root, inputs)
    try:
        model = build_backbone(inputs["cfg"], state_dict=inputs["state"], device="cpu")
        with torch.no_grad():
            heads = model(inputs["pts"])
        one = one_process_forward(inputs)
    finally:
        results = finish_ranks(procs, root)
    return results, heads, one


def test_two_rank_bf16_step_matches_one_process(ranks):
    """Two ranks of 2 rows each in bf16 against the one-process bf16 step:
    the averaged loss scalars within 1e-5 and the global BN statistics
    within 1e-5, the float32 data-parallel test's rule
    (``tests/test_torch_parallel.py``); each averaged gradient within 2^-6
    of its norm (L2; measured 0.0073 at most) plus, as there, 1e-4 of the
    largest gradient entry (a bias in front of batch-statistics BN has a
    zero gradient and carries only summation noise). Each rank rounds its
    own weight gradients to bf16 before the average, and the gradients
    pass through a rounding to bf16 at every dense layer's input gradient,
    which the ranks' BN sums, summed in another order, move by an ulp
    (2^-8 relative): float32's rule of 1e-3 of the largest entry cannot
    hold that. The two ranks' gradients are equal."""
    results, _, (model, aux) = ranks
    for rec in (r["dp_forward"] for r in results):
        for key, val in aux.items():
            np.testing.assert_allclose(float(rec["aux"][key]), float(val), rtol=1e-5,
                                       atol=1e-5, err_msg=key)
        grads = rec["grads0"]
        assert set(grads) == {n for n, _ in model.named_parameters()}
        top = max(float(p.grad.abs().max()) for p in model.parameters())
        for name, p in model.named_parameters():
            err = float((grads[name] - p.grad).norm())
            assert err <= 2.0**-6 * float(p.grad.norm()) + 1e-4 * top, name
        for name, buf in model.named_buffers():
            torch.testing.assert_close(rec["buffers0"][name], buf, rtol=1e-5, atol=1e-5,
                                       msg=name)
    for name, g in results[0]["dp_forward"]["grads0"].items():
        torch.testing.assert_close(g, results[1]["dp_forward"]["grads0"][name], rtol=0,
                                   atol=0, msg=name)


def test_sharded_bf16_forward_matches_single_device(ranks):
    """The P=2 point-sharded bf16 forward, its rows joined over the ranks,
    against the single-device bf16 forward (rtol 2e-4, atol 1e-5, the
    float32 sharding test's)."""
    results, heads, _ = ranks
    for i, want in enumerate(heads):
        got = torch.cat([r["sharded"][i] for r in results], dim=1)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)


def test_joint_cli_compute_dtype_reaches_the_backbone(tmp_path):
    """The joint CLI's ``--compute_dtype bfloat16`` builds the backbone of
    the joint step in bf16 (every dense layer), leaves the decoder and the
    encoders float32, and trains to finite losses."""
    logdir = str(tmp_path / "joint")
    trainer = TJ.cli_main(TINY + HEADS + ["--num_sk_point", "16", "--logdir", logdir,
                                          "--is_pc_train", "--is_im_train",
                                          "--compute_dtype", "bfloat16"])
    dense = [m for m in trainer.backbone.modules() if isinstance(m, Dense)]
    assert len(dense) == 19 and all(m.compute_dtype == torch.bfloat16 for m in dense)
    assert all(m.compute_dtype is None for net in (trainer.encoder, trainer.loaded_encoder)
               for m in net.modules() if isinstance(m, Dense))
    assert all(p.dtype == torch.float32 for p in trainer.backbone.parameters())
    with open(os.path.join(logdir, "log.txt")) as f:
        log = f.read()
    assert "compute_dtype='bfloat16'" in log
    assert "nan" not in log.split("config:")[1].split("\n", 1)[1].lower()


def test_bf16_data_parallel_run_saves_float32_for_the_float32_evaluator(tmp_path):
    """Trainer A's CLI with ``--compute_dtype bfloat16 --data_parallel 2``
    on the CPU: the checkpoint holds float32 parameters and statistics,
    and the evaluator, which builds its backbone in float32 as JAX's does,
    loads it strictly."""
    logdir = str(tmp_path / "run")
    assert train_pc.cli_main(TINY + HEADS + ["--logdir", logdir, "--compute_dtype",
                                             "bfloat16", "--data_parallel", "2"]) is None
    with open(os.path.join(logdir, "log.txt")) as f:
        assert "compute_dtype='bfloat16'" in f.read()
    state = torch.load(os.path.join(logdir, "model.pth"), weights_only=True)
    tensors = [v for v in state["model"].values() if v.is_floating_point()]
    assert tensors and all(v.dtype == torch.float32 for v in tensors)
    means = evaluator.cli_main(["--synthetic", "4", "--num_point", "64", "--K", str(K),
                                "--batch_size", "2", "--no_implicit",
                                "--synthetic_resolution", "128", "--device", "cpu",
                                "--logdir", logdir])
    assert all(np.isfinite(v) for v in means.values())
    with open(os.path.join(logdir, "log_evaluate.txt")) as f:
        assert f.readline().strip() == f"Restored backbone from {logdir}/model"
