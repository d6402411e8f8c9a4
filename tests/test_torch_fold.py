"""The serving fold (point2cyl_torch.models.folded): each float32 per-point
dense layer with its eval BN and ReLU as one GEMM, on the CPU.

One folded layer against dense, BN, ReLU; the folded serving session
against the unfolded eval forward of the same weights (raw heads,
decompositions, latents); the layer counts; a bf16 artifact, which folds
nothing and serves as before; and what the fold leaves unchanged (the
modules, their state_dicts, the artifact).
"""

from __future__ import annotations

import collections
import copy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from point2cyl_torch.core.config import BackboneConfig
from point2cyl_torch.models.backbone import Backbone
from point2cyl_torch.models.folded import fold_dense, fold_for_serving, layer_counts
from point2cyl_torch.models.implicit import PointNetEncoder
from point2cyl_torch.models.layers import BatchNorm, Dense
from point2cyl_torch.serve import export
from point2cyl_torch.serve.session import InferenceSession

K, L, SK = 4, 32, 32
# the reference channel plan (17 dense-BN-ReLU layers) on small clouds
CFG = BackboneConfig(num_points=256, sa_npoints=(64, 16), sa_nsamples=(16, 16),
                     output_sizes=(3, 2 * K), approx_neighbors=False)


def draw_bn(bn: BatchNorm, g: torch.Generator, var: str = "calibrated") -> None:
    """BN affine parameters and statistics drawn from ``g``: variances as
    calibrated (0.5-2), near 0 (1e-9-1e-6, under eps) or large (1e3-1e5)."""
    c = bn.weight.shape[0]
    lo, hi = {"calibrated": (0.5, 2.0), "near0": (1e-9, 1e-6), "large": (1e3, 1e5)}[var]
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.2, generator=g)
        bn.running_mean.normal_(0.0, 0.3, generator=g)
        bn.running_var.copy_(lo * (hi / lo) ** torch.rand(c, generator=g))


def drawn(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``net`` with weights and BN affine parameters drawn from ``seed``
    and BN statistics calibrated on clouds (sketches for an encoder) of
    their own, as a trained network's are."""
    g = torch.Generator().manual_seed(seed)
    net.reset_parameters(g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.2, generator=g)
        if isinstance(net, Backbone):
            net(torch.from_numpy(clouds(seed, 4)), train=True, bn_momentum=1.0, generator=g)
        else:
            net(torch.randn(8, SK, 4, generator=g), train=True, momentum=1.0)
    return net.eval()


def clouds(seed: int, b: int) -> np.ndarray:
    pts = np.random.default_rng(seed).normal(size=(b, CFG.num_points, 3))
    return (pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(np.float32)


def assert_close_to_peak(got: torch.Tensor, want: torch.Tensor, rel: float) -> None:
    peak = float(want.abs().max())
    assert peak > 0
    err = float((got - want).abs().max())
    assert err <= rel * peak, (err, peak)


@pytest.mark.parametrize("var", ["calibrated", "near0", "large"])
@pytest.mark.parametrize("shape", [(7, 40), (2, 9, 5, 40)])
def test_folded_layer_matches_dense_bn_relu(var, shape):
    """``relu(bn(dense(x)))`` and the bare head ``dense(x)`` against their
    folded layers, within 1e-6 of the output's largest magnitude, on 2-D
    and grouped 4-D activations, with variances calibrated, under eps and
    large."""
    g = torch.Generator().manual_seed(3)
    dense, bn = Dense(40, 24, conv_rank=len(shape)), BatchNorm(24)
    dense.reset_parameters(g)
    draw_bn(bn, g, var)
    x = torch.randn(shape, generator=g)
    folded, head = fold_dense(dense, bn), fold_dense(dense)
    assert folded.relu and not head.relu
    assert folded.weight.dtype == torch.float32 and folded.weight.shape == (24, 40)
    with torch.no_grad():
        want = torch.relu(bn(dense(x)))
        got = folded(x)
        assert got.shape == want.shape
        assert bool((got >= 0).all()) and bool(((got == 0) == (want == 0)).float().mean() > 0.9)
        assert_close_to_peak(got, want, 1e-6)
        assert torch.equal(head(x), torch.addmm(dense.bias, x.reshape(-1, 40),
                                                folded_weight(dense).t()).reshape(want.shape))
        assert_close_to_peak(head(x), dense(x), 1e-6)


def folded_weight(dense: Dense) -> torch.Tensor:
    return dense.weight.reshape(dense.weight.shape[0], dense.weight.shape[1])


def test_fold_is_computed_in_float64_and_rounded_once():
    """The folded weights and bias are the float64 fold rounded once to
    float32, bit for bit."""
    g = torch.Generator().manual_seed(4)
    dense, bn = Dense(16, 8), BatchNorm(8)
    dense.reset_parameters(g)
    draw_bn(bn, g)
    f = fold_dense(dense, bn)
    d = lambda t: t.detach().double()  # noqa: E731
    s = d(bn.weight) / torch.sqrt(d(bn.running_var) + bn.eps)
    assert torch.equal(f.weight, (d(folded_weight(dense)) * s[:, None]).float())
    assert torch.equal(f.bias, ((d(dense.bias) - d(bn.running_mean)) * s + d(bn.bias)).float())


def test_low_precision_dense_does_not_fold():
    with pytest.raises(ValueError, match="low-precision"):
        fold_dense(Dense(8, 8, compute_dtype="bfloat16"), BatchNorm(8))


class AtenOps(TorchDispatchMode):
    """Counts the ATen operators a forward dispatches (not those inside them)."""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def test_folded_backbone_and_encoder_run_one_gemm_a_layer():
    """The folded forwards dispatch one ``_addmm_activation`` a
    dense-BN-ReLU layer and one ``addmm`` a head, and no BN arithmetic or
    ReLU of their own; the modules they were copied from still do."""
    model, enc = drawn(Backbone(CFG), 5), drawn(PointNetEncoder(L, 2, True), 6)
    pts, sketches = torch.from_numpy(clouds(7, 2)), torch.randn(3, SK, 4)
    served = {"backbone": fold_for_serving(model), "encoder": fold_for_serving(enc)}
    ops = {}
    with torch.inference_mode():
        for name, net, x in (("backbone", served["backbone"], pts),
                             ("encoder", served["encoder"], sketches),
                             ("unfolded", model, pts)):
            with AtenOps() as seen:
                net(x)
            ops[name] = seen.count
    assert ops["backbone"]["_addmm_activation"] == 17 and ops["backbone"]["addmm"] == 2
    assert ops["encoder"]["_addmm_activation"] == 5
    for name in ("backbone", "encoder"):
        assert not {"relu", "rsqrt", "matmul", "mm", "bmm"} & set(ops[name]), ops[name]
    assert ops["unfolded"]["relu"] == 17 and ops["unfolded"]["rsqrt"] == 17
    assert "_addmm_activation" not in ops["unfolded"]


def test_fold_leaves_the_module_as_it_was():
    """The folded copy shares nothing with its module, which keeps its
    class, state_dict and forward; the copy keeps its classes' forwards
    (only the layer loops and the FC stage are served ones) and refuses
    train mode."""
    model = drawn(Backbone(CFG), 8)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    served = fold_for_serving(model)
    assert type(model) is Backbone and isinstance(served, Backbone)
    assert type(served).forward is Backbone.forward
    assert type(served.sa1).forward is type(model.sa1).forward
    assert type(served.fp1).forward is type(model.fp1).forward
    assert type(served).fc_stage is not Backbone.fc_stage
    assert model.state_dict().keys() == before.keys()
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())
    assert not hasattr(served, "fc1") and not hasattr(served.sa1, "mlp_convs")
    shared = {t.data_ptr() for t in model.state_dict().values()}
    assert not shared & {t.data_ptr() for t in served.state_dict().values()}
    with pytest.raises(ValueError, match="eval mode"):
        served(torch.zeros(1, CFG.num_points, 3), train=True, generator=torch.Generator())
    enc = fold_for_serving(PointNetEncoder(L, 2, True))
    assert type(enc).forward is PointNetEncoder.forward
    with pytest.raises(ValueError, match="eval mode"):
        enc(torch.zeros(1, SK, 4), train=True)
    with pytest.raises(TypeError, match="no serving fold"):
        fold_for_serving(Dense(4, 4))


@pytest.fixture(scope="module")
def nets():
    return drawn(Backbone(CFG), 11), drawn(PointNetEncoder(L, 2, True), 12)


@pytest.fixture(scope="module")
def artifact(nets, tmp_path_factory):
    model, enc = nets
    path = str(tmp_path_factory.mktemp("fold") / "m.p2ct")
    export.export_artifact(path, model.state_dict(), k=K, backbone_config=CFG,
                           buckets=(2, 4), num_sk_points=SK,
                           encoder_state_dict=enc.state_dict(), encoder_latent=L)
    return path


def unfolded_forward(nets, pts: np.ndarray, dtype=torch.float32,
                     decompose: bool = False) -> dict:
    """The serving forward through the unfolded modules, in ``dtype``."""
    model, enc = (copy.deepcopy(n).to(dtype) for n in nets)
    kw = dict(num_sk_points=SK, encoder=enc) if decompose else {}
    with torch.inference_mode():
        return export._backbone_forward(model, torch.from_numpy(pts).to(dtype), k=K, **kw)


# Against each other the folded and the unfolded float32 forwards differ by
# the rounding of both: their raw heads by 1.0-1.5e-5 of a head's peak at
# the reference channel plan, where the unfolded one lies 0.8-1.4e-5 and
# the folded one 0.6-0.9e-5 from the float64 forward. So the folded
# session is held to the float64 forward of the same weights.


def test_folded_session_heads_match_unfolded_forward(nets, artifact):
    """Raw heads of a 4-cloud request (one bucket-4 chunk) within 1e-5 of
    each head's largest magnitude from the unfolded eval forward in
    float64."""
    sess = InferenceSession(artifact, device="cpu")
    pts = clouds(20, 4)
    got = sess.predict(pts, assemble=False)
    want = unfolded_forward(nets, pts, torch.float64)
    unfolded = unfolded_forward(nets, pts)
    for key in ("x_raw", "w_raw"):
        assert got[key].shape == tuple(want[key].shape)
        assert_close_to_peak(torch.from_numpy(got[key]).double(), want[key], 1e-5)
        assert not np.array_equal(got[key], unfolded[key].numpy())  # the folded path ran


@pytest.mark.parametrize("n", [3, 4])
def test_folded_session_decomposes_as_unfolded(nets, artifact, n):
    """Labels, bb_labels and found equal the unfolded float32 and float64
    forwards'; latents (exact) within 1e-5 and the geometry within 1e-4
    (the JAX session test's) of the float64 forward's; 3 clouds pad a
    bucket-4 chunk."""
    sess = InferenceSession(artifact, device="cpu")
    pts = clouds(30 + n, n)
    got = sess.decompose(pts, exact_latents=True)
    padded = np.concatenate([pts, np.zeros((4 - n, *pts.shape[1:]), np.float32)])
    want, want64 = ({k: v[:n].numpy() for k, v in unfolded_forward(
        nets, padded, dtype, decompose=True).items()}
        for dtype in (torch.float32, torch.float64))
    for key in ("labels", "bb_labels", "found"):
        np.testing.assert_array_equal(got[key], want[key], key)
        np.testing.assert_array_equal(got[key], want64[key], key)
    assert got["found"].any()
    dots = np.abs(np.sum(got["axes"] * want64["axes"], axis=-1))
    assert dots.min() > 1.0 - 1e-5, dots.min()
    for key, atol in (("centers", 1e-4), ("extents", 1e-4), ("scales", 1e-4),
                      ("latents", 1e-5)):
        np.testing.assert_allclose(got[key], want64[key], rtol=0, atol=atol, err_msg=key)


def test_session_counts_folded_layers(nets, artifact, tmp_path):
    """17 folded layers for the backbone, 22 with the sketch encoder, none
    left; the replicas served are folded copies and ``session.model`` /
    ``session.encoder`` the modules loaded from the artifact."""
    sess = InferenceSession(artifact, device="cpu")
    assert (sess.stats["folded_layers"], sess.stats["unfolded_layers"]) == (22, 0)
    assert layer_counts(sess.served) == (17, 0)
    assert layer_counts(sess.served_encoder) == (5, 0)
    assert type(sess.model) is Backbone and type(sess.encoder) is PointNetEncoder
    path = str(tmp_path / "geo.p2ct")
    export.export_artifact(path, nets[0].state_dict(), k=K, backbone_config=CFG,
                           buckets=(2,), num_sk_points=SK)
    geo = InferenceSession(path, device="cpu")
    assert (geo.stats["folded_layers"], geo.stats["unfolded_layers"]) == (17, 0)
    assert geo.encoder is None and geo._encoders == [None]


def test_multi_device_replicas_are_folded_alike(artifact):
    """Two replicas (both on the CPU), each its own folded copy; a request
    dealt over both equals the one-replica session's, bit for bit."""
    two = InferenceSession(artifact, devices=["cpu", "cpu"])
    one = InferenceSession(artifact, device="cpu")
    assert two._models[0] is not two._models[1]
    assert all(layer_counts(m) == (17, 0) for m in two._models)
    assert two.stats["folded_layers"] == 22
    pts = clouds(40, 8)
    got, want = two.decompose(pts, exact_latents=True), one.decompose(pts, exact_latents=True)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, key)


def test_bf16_artifact_folds_nothing_and_serves_as_before(tmp_path):
    """A bf16 backbone folds nothing (17 layers left): its replica is the
    module the session loaded, and the raw heads equal the unfolded eval
    forward's bit for bit."""
    cfg = BackboneConfig(**{**CFG.__dict__, "compute_dtype": "bfloat16"})
    model = drawn(Backbone(cfg), 13)
    path = str(tmp_path / "bf16.p2ct")
    export.export_artifact(path, model.state_dict(), k=K, backbone_config=cfg, buckets=(2,))
    sess = InferenceSession(path, device="cpu")
    assert (sess.stats["folded_layers"], sess.stats["unfolded_layers"]) == (0, 17)
    assert sess.served is sess.model and fold_for_serving(model) is model
    pts = clouds(50, 2)
    got = sess.predict(pts, assemble=False)
    with torch.inference_mode():
        want = model(torch.from_numpy(pts))
    for key, val in zip(("x_raw", "w_raw"), want):
        np.testing.assert_array_equal(got[key], val.numpy(), key)


def test_artifact_round_trip_keeps_the_state_dicts(nets, artifact):
    """Exporting and loading gives the exported state_dicts under the
    reference keys, and the session's modules hold them unchanged."""
    model, enc = nets
    art = export.load_artifact(artifact)
    sess = InferenceSession(art, device="cpu")
    for want, loaded, held in ((model.state_dict(), art.weights, sess.model.state_dict()),
                               (enc.state_dict(), art.encoder_weights,
                                sess.encoder.state_dict())):
        assert list(loaded) == list(want) == list(held)
        assert all(torch.equal(loaded[k], v) and torch.equal(held[k], v)
                   for k, v in want.items())
