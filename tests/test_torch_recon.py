"""The port's reconstruction (point2cyl_torch.recon and point2cyl_torch.native)
against the JAX package's, on the CPU at a small size.

Meshes, PLY files and render scripts must be equal (the same numpy code
on the same inputs, and the same C++ extractor). The composited volumes
come from decoders with the JAX weights (core/convert.py) and are held
within 1e-5 of their largest magnitude; the meshes of one volume are held
equal. Random draws do not cross frameworks: the segment samples take the
deterministic draw on both sides, and the fine-tune's off-surface
samples are JAX's own, made by replaying its key schedule and handed to
the port's ``sampler``.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point2cyl_torch.core.convert import implicit_state_dict_from_jax
from point2cyl_torch.models.implicit import ImplicitNet
from point2cyl_torch.recon import isosurface as TI
from point2cyl_torch.recon import plots as TPL
from point2cyl_torch.recon import ply as TPLY
from point2cyl_torch.recon import reconstruct as TR
from point2cyl_torch.recon import render_scripts as TRS
from point2cyl_tpu.models import implicit as JI
from point2cyl_tpu.models.backbone import Backbone
from point2cyl_tpu.recon import isosurface as JIS
from point2cyl_tpu.recon import plots as JPL
from point2cyl_tpu.recon import ply as JPLY
from point2cyl_tpu.recon import reconstruct as JR
from point2cyl_tpu.recon import render_scripts as JRS

from test_torch_eval import CFG, K, S, jax_and_port_weights, jax_batches
from test_torch_implicit import jax_encoder, port_encoder

NARROW = dict(d_in=10, hidden=(32,) * 4, skip_in=(2,))
# a geometric init of radius 2 is negative on the unit disc of the sketch
# plane for a unit latent (radius 1 is positive all over it: no surface)
FULL = dict(d_in=258, radius_init=2.0)
VOLUME_RTOL = 1e-5  # of the volume's largest magnitude


def sphere_volume(r=32, radius=0.55):
    lin = np.linspace(-1, 1, r)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.sqrt(x**2 + y**2 + z**2) - radius, (lin[1] - lin[0],) * 3


def random_volume():
    return np.random.default_rng(3).normal(size=(9, 10, 11)).astype(np.float32), (1, 1, 1)


def two_spheres():
    lin = np.linspace(-1, 1, 40)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    big = np.sqrt((x + 0.4) ** 2 + y**2 + z**2) - 0.45
    small = np.sqrt((x - 0.7) ** 2 + y**2 + z**2) - 0.1
    return np.minimum(big, small)


# ---- isosurface, PLY and render scripts ------------------------------------


@pytest.mark.parametrize("impl", ["numpy", "native"])
@pytest.mark.parametrize("volume", [sphere_volume, random_volume])
def test_marching_tetrahedra_matches_jax(impl, volume):
    vol, spacing = volume()
    got = TI.marching_tetrahedra(vol, 0.0, spacing=spacing, impl=impl)
    want = JIS.marching_tetrahedra(vol, 0.0, spacing=spacing, impl=impl)
    assert len(got[1]) > 50
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output;
    nothing falls back to the numpy extractor."""
    from point2cyl_torch import native

    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build native/broken.cpp"):
        native.load("broken")
    with pytest.raises(ValueError, match="impl"):
        TI.marching_tetrahedra(sphere_volume(8)[0], impl="auto")


def test_native_library_is_named_by_its_source():
    from point2cyl_torch import native

    path = native.library_path("isosurface")
    assert path.parent == native.BUILD_DIR and path.name.startswith("libisosurface_")
    native.load("isosurface")
    assert path.exists()


def test_convert_sdf_samples_and_ply_bytes_match_jax(tmp_path):
    vol, _ = sphere_volume(24, 0.5)
    got = TI.convert_sdf_samples_to_ply(vol, [-1.0, -1.0, -1.0], 2 / 24, str(tmp_path / "t.ply"),
                                        offset=np.array([0.1, 0.0, 0.0]), scale=2.0)
    want = JIS.convert_sdf_samples_to_ply(vol, [-1.0, -1.0, -1.0], 2 / 24,
                                          str(tmp_path / "j.ply"),
                                          offset=np.array([0.1, 0.0, 0.0]), scale=2.0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for binary in (True, False):
        TPLY.write_ply(str(tmp_path / "a.ply"), *got, binary=binary)
        JPLY.write_ply(str(tmp_path / "b.ply"), *got, binary=binary)
        assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
        v, f = TPLY.read_ply(str(tmp_path / "a.ply"))
        jv, jf = JPLY.read_ply(str(tmp_path / "a.ply"))
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)


def test_split_and_drop_components_match_jax():
    verts, faces = TI.marching_tetrahedra(two_spheres(), 0.0, impl="numpy")
    got = TI.split_components(verts, faces)
    want = JIS.split_components(verts, faces)
    assert len(got) == len(want) == 2
    for (gv, gf), (wv, wf) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gf, wf)
    kept = TI.drop_small_components(verts, faces, 0.1)
    kept_j = JIS.drop_small_components(verts, faces, 0.1)
    assert len(TI.split_components(*kept)) == 1
    for a, b in zip(kept, kept_j):
        np.testing.assert_array_equal(a, b)
    assert TI.mesh_volume(verts, faces) == JIS.mesh_volume(verts, faces)


def test_render_scripts_are_byte_equal(tmp_path):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    pred, gt = rng.integers(-1, 11, 50), rng.integers(0, 8, 50)
    for mod, name in ((TRS, "t"), (JRS, "j")):
        writer = mod.RenderScriptWriter(str(tmp_path / name), renderer="R")
        writer.add_pointcloud("0_1_0.500", pts, pred, gt)
        writer.add_pointcloud("0_2_0.250", pts, pred)
        writer.add_mesh("m", "out/m.ply")
        writer.finalize()
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j")) and "render.sh" in files
    for f in files:
        got = (tmp_path / "t" / f).read_bytes().replace(b"/t/", b"/j/")
        assert got == (tmp_path / "j" / f).read_bytes(), f
    assert os.access(tmp_path / "t" / "render.sh", os.X_OK)


# ---- the composited volume -------------------------------------------------


def jax_decoder(kw: dict, seed: int):
    net = JI.ImplicitNet(**kw)
    return net, jax.device_get(net.init(jax.random.key(seed),
                                        jnp.zeros((1, kw["d_in"])))["params"])


def port_decoder(kw: dict, params) -> ImplicitNet:
    net = ImplicitNet(**{k: v for k, v in kw.items() if k != "radius_init"})
    net.load_state_dict(implicit_state_dict_from_jax(params), strict=True)
    return net.eval()


def instances(latent: int, seed: int = 5) -> dict[str, np.ndarray]:
    """Three instances: unit latents and axes, centres near the origin,
    sketch scales 0.4-0.6, and instance 2 too shallow to composite."""
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(3, latent)).astype(np.float32)
    axes = rng.normal(size=(3, 3)).astype(np.float32)
    return {"latents": lat / np.linalg.norm(lat, axis=-1, keepdims=True),
            "axes": axes / np.linalg.norm(axes, axis=-1, keepdims=True),
            "centers": rng.uniform(-0.15, 0.15, (3, 3)).astype(np.float32),
            "scales": rng.uniform(0.4, 0.6, 3).astype(np.float32),
            "extents": np.array([[-0.4, 0.3], [-0.2, 0.5], [0.1, 0.105]], np.float32)}


# decoder, design option, instances' seed (checked to hold no voxel within
# 1e-5 of the level)
VOLUMES = {
    "narrow, option 1": (NARROW, 1, 5),
    "narrow, option 2": (NARROW, 2, 5),
    "full, option 2": (FULL, 2, 7),
}


@functools.lru_cache(maxsize=None)
def volumes(case: str):
    """JAX's and the port's volumes and intermediates for ``case`` at R=16,
    the port in chunks of 1,000 points (not a whole number of z slices)."""
    kw, option, seed = VOLUMES[case]
    net, params = jax_decoder(kw, seed=6)
    c = instances(kw["d_in"] - 2, seed)
    ops, perm = JR.DESIGN_OPTIONS[option]
    want = JR.composite_volume(net, [params] * 3, jnp.asarray(c["latents"]),
                               jnp.asarray(c["axes"]), jnp.asarray(c["centers"]),
                               c["scales"], c["extents"], ops, perm, 3, resolution=16)
    dec = port_decoder(kw, params)
    got = TR.composite_volume([dec] * 3, torch.from_numpy(c["latents"]),
                              torch.from_numpy(c["axes"]), torch.from_numpy(c["centers"]),
                              c["scales"], c["extents"], ops, perm, 3, resolution=16,
                              chunk_points=1000)
    return want, got


@pytest.mark.parametrize("case", list(VOLUMES))
def test_composite_volume_matches_jax(case):
    (want, want_inter), (got, got_inter) = volumes(case)
    assert got.shape == (16, 16, 16) and got.dtype == np.float32
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=VOLUME_RTOL * top)
    assert len(got_inter) == len(want_inter) == 2  # instance 2 is too shallow
    for g, w in zip(got_inter, want_inter):
        np.testing.assert_allclose(g, w, rtol=0, atol=VOLUME_RTOL * np.abs(w).max())
    # no voxel within 1e-5 of the level, so the meshes cannot part on a sign
    assert np.abs(want).min() > 1e-5 and (want > 0).any() and (want < 0).any()


@pytest.mark.parametrize("case", list(VOLUMES))
def test_reconstruct_mesh_matches_jax(case, tmp_path):
    """The same volume gives the same faces and vertices (with a cut, after
    the small-component cleanup)."""
    (want, _), _ = volumes(case)
    has_cut = VOLUMES[case][1] == 2
    got_v, got_f = TR.reconstruct_mesh(want, str(tmp_path / "t.ply"), has_cut=has_cut)
    want_v, want_f = JR.reconstruct_mesh(want, str(tmp_path / "j.ply"), has_cut=has_cut)
    assert len(got_f) > 20
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_composite_grid_is_z_y_x():
    """Voxel [z, y, x] of the grid sits at (x_lin[x], x_lin[y], z_lin[z]),
    with the half-cell offsets -1/2 for x and y and +1/2 for z."""
    xy, z = TR.composite_grid(4)
    assert xy.dtype == z.dtype == np.float32
    lin = np.linspace(-1, 1, 4, endpoint=False)
    np.testing.assert_allclose(z, lin + 0.25)
    grid = xy.reshape(4, 4, 2)
    np.testing.assert_allclose(grid[1, 2], [lin[2] - 0.25, lin[1] - 0.25])


def test_composite_volume_refuses_more_instances_than_the_option_lists():
    with pytest.raises(ValueError, match="composes 3 instances"):
        TR.composite_volume([port_decoder(NARROW, jax_decoder(NARROW, 0)[1])] * 4,
                            torch.zeros(4, 8), torch.zeros(4, 3), torch.zeros(4, 3),
                            np.ones(4), np.zeros((4, 2)), *TR.DESIGN_OPTIONS[2], 4,
                            resolution=4)


# ---- extraction, latents, fine-tune and the 2D grid ------------------------


@pytest.fixture(scope="module")
def weights(monkeypatch_module):
    """``jax_and_port_weights`` of the eval tests, with the JAX model's init
    jitted (the same variables, 5 s sooner)."""
    init = Backbone.init
    monkeypatch_module.setattr(Backbone, "init", lambda self, rngs, x, train: jax.jit(
        functools.partial(init, self, train=train))(rngs, x))
    return jax_and_port_weights()


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_extraction_and_latents_match_jax(weights):
    """The deterministic draw on both sides: labels equal; axes, centres,
    extents and latents within 1e-5, the heads within 1e-4 (float32
    through the backbone)."""
    model, variables, torch_model = weights
    batch = jax_batches()[0]
    pts, gt = batch["point_cloud"], batch["extrusion_labels"]
    # eager, as the JAX CLI calls it (jitted, XLA's rounding moves the axes
    # by 3e-5 on these weights)
    want = JR.extract_extrusion_params(model, variables, pts, gt, K, None)
    got = TR.extract_extrusion_params(torch_model.eval(), torch.from_numpy(np.array(pts)),
                                      torch.from_numpy(np.array(gt)), K)
    for key in ("label", "pred_bb", "mask", "found"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key, atol in (("axes", 1e-5), ("centers", 1e-5), ("extents", 1e-5),
                      ("normals", 1e-4), ("w_soft_reordered", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=atol, err_msg=key)

    enc, enc_params, enc_stats = jax_encoder((16, 2, True), seed=3)
    proj = ("normals", "label", "pred_bb", "axes", "centers")
    want_l = jax.jit(lambda v, *a: JR.extract_sketch_latents(enc, v, None, pts, *a, S))(
        {"params": enc_params, "batch_stats": enc_stats}, *(want[k] for k in proj))
    got_l = TR.extract_sketch_latents(port_encoder((16, 2, True), enc_params, enc_stats),
                                      None, torch.from_numpy(np.array(pts)),
                                      *(got[k] for k in proj), S)
    assert got_l[0].shape == (pts.shape[0], K, 16)
    # latents, scales, p2d / scale, n2d (rotated normals: the heads' 1e-4)
    for g, w, atol in zip(got_l[:4], want_l[:4], (1e-5, 1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
    np.testing.assert_array_equal(got_l[4].numpy(), np.asarray(want_l[4]))
    assert CFG.approx_neighbors is False


def jax_off_surface_draws(key, pts, chunks: int, check_every: int) -> list[np.ndarray]:
    """The off-surface samples JAX ``igr_finetune`` draws, in order: per
    chunk ``key, k = split(key)``, per step ``split(k, check_every)[i]``."""
    draws = []
    for _ in range(chunks):
        key, k = jax.random.split(key)
        for sk in jax.random.split(k, check_every):
            draws.append(np.array(JI.sample_off_surface(sk, pts[None])))
    return draws


@pytest.mark.parametrize("max_steps,eps_loss,chunks", [(6, 1e-5, 2), (9, 1e3, 2)],
                         ids=["runs out", "plateau"])
def test_igr_finetune_matches_jax(monkeypatch, max_steps, eps_loss, chunks):
    """Parameters within 1e-4 of each tensor's largest entry after the same
    number of chunks: all of them, or (with a plateau threshold above any
    change) the second, where both stop."""
    net, params = jax_decoder(NARROW, seed=8)
    rng = np.random.default_rng(8)
    lat = rng.normal(size=8).astype(np.float32)
    lat /= np.linalg.norm(lat)
    th = rng.uniform(0, 2 * np.pi, 40)
    sk_pts = (np.stack([np.cos(th), np.sin(th)], -1) * 0.8).astype(np.float32)
    sk_nrm = np.stack([np.cos(th), np.sin(th)], -1).astype(np.float32)
    key = jax.random.key(4)

    outer = []  # the JAX loop's host-side splits, one a chunk
    real_split = jax.random.split

    def counting_split(k, num=2):
        if not isinstance(k, jax.core.Tracer) and num == 2:
            outer.append(1)
        return real_split(k, num)

    monkeypatch.setattr(jax.random, "split", counting_split)
    want = JR.igr_finetune(net, params, jnp.asarray(lat), jnp.asarray(sk_pts),
                           jnp.asarray(sk_nrm), key, max_steps=max_steps, check_every=3,
                           eps_loss=eps_loss)
    monkeypatch.setattr(jax.random, "split", real_split)
    assert len(outer) == chunks
    draws = iter(jax_off_surface_draws(key, jnp.asarray(sk_pts), max_steps // 3, 3))
    tuned, steps = TR.igr_finetune(port_decoder(NARROW, params), torch.from_numpy(lat),
                                   torch.from_numpy(sk_pts), torch.from_numpy(sk_nrm),
                                   max_steps=max_steps, check_every=3, eps_loss=eps_loss,
                                   sampler=lambda p: torch.from_numpy(next(draws)))
    assert steps == 3 * chunks
    want_sd = implicit_state_dict_from_jax(want)
    start = port_decoder(NARROW, params).state_dict()
    for name, t in tuned.state_dict().items():
        w = want_sd[name]
        assert not t.requires_grad
        np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()), err_msg=name)
        assert not torch.equal(t, start[name]), f"{name} did not move"


def test_eval_sdf_grid_2d_matches_jax():
    net, params = jax_decoder(NARROW, seed=9)
    lat = np.random.default_rng(9).normal(size=8).astype(np.float32)
    want = JPL.eval_sdf_grid_2d(lambda x: net.apply({"params": params}, x), lat, 32)
    got = TPL.eval_sdf_grid_2d(port_decoder(NARROW, params), lat, 32)
    assert got.shape == (32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(TPL.get_grid_uniform_2d(7)[0], JPL.get_grid_uniform_2d(7)[0])


# ---- the CLI ---------------------------------------------------------------

CLI = ["--synthetic", "--num_points", "512", "--num_sk_point", "128", "--resolution", "16",
       "--synthetic_resolution", "512", "--device", "cpu"]


def logdirs(path) -> tuple[str, str]:
    """A joint trainer's logdir (pc_model.pth and im_model.pth) and an IGR
    pretrainer's (model.pth), at full width from a seed. The backbone's
    BN statistics are those of the synthetic clouds, as a trained
    model's are (with a fresh model's every point gets the same labels
    and no segment is found); the decoder is a geometric init of radius
    2, so each sketch becomes a disc."""
    from point2cyl_torch.core.config import BackboneConfig
    from point2cyl_torch.data.synthetic import generate_dataset
    from point2cyl_torch.models.backbone import Backbone
    from point2cyl_torch.models.implicit import PointNetEncoder

    gen = torch.Generator().manual_seed(1)
    backbone = Backbone(BackboneConfig(num_points=512, output_sizes=(3, 16),
                                       approx_neighbors=False))
    backbone.reset_parameters(gen)
    clouds = torch.from_numpy(generate_dataset(6, resolution=512, num_sketch_points=128,
                                               seed=0).point_cloud)
    with torch.no_grad():
        backbone(clouds, train=True, bn_momentum=1.0, generator=gen)
    implicit, encoder = ImplicitNet(radius_init=2.0), PointNetEncoder(256, 2, True)
    implicit.reset_parameters(gen)
    encoder.reset_parameters(gen)
    joint, igr = path / "joint", path / "igr"
    joint.mkdir()
    igr.mkdir()
    torch.save({"model": backbone.state_dict()}, joint / "pc_model.pth")
    torch.save({"implicit_net": implicit.state_dict(), "pn_encoder": encoder.state_dict()},
               joint / "im_model.pth")
    torch.save({"model_state_dict": implicit.state_dict(),
                "encoder_state_dict": encoder.state_dict()}, igr / "model.pth")
    return str(joint), str(igr)


@pytest.mark.parametrize("flags", [
    [],
    ["--seg_post_process", "--scale_post_process", "--extent_post_process",
     "--design_option", "2", "--model_id", "4", "--use_pretrained_2d"],
], ids=["plain", "post-processed, cut, pretrained 2d"])
def test_cli_writes_the_reconstruction(tmp_path, capsys, flags):
    """The joint logdir's implicit stack by default; with
    --use_pretrained_2d the IGR checkpoint of --im_logdir."""
    joint, igr = logdirs(tmp_path)
    out, dump = tmp_path / "out", tmp_path / "dump"
    res = TR.cli_main(CLI + flags + ["--logdir", joint, "--im_logdir", igr,
                                     "--output_dir", str(out), "--dump_dir", str(dump)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["Model loaded.", "Pre-trained fixed implicit model loaded "
                         f"({igr if flags else joint})."]
    model_id = "4" if flags else "0"
    assert res["faces"] > 0 and res["out_ply"] == str(out / "reconstruction" / f"{model_id}.ply")
    verts, faces = TPLY.read_ply(res["out_ply"])
    assert len(faces) == res["faces"] and np.isfinite(verts).all()
    # the grid's box: the PLY's origin is voxel [0, 0, 0], as in JAX
    assert verts.min() >= 0.0 and verts.max() <= 2.0 * 15 / 16
    assert len(os.listdir(out / "intermediate_volumes")) == res["intermediates"] >= 1
    assert os.listdir(out / "input_point_clouds") == [f"{model_id}.ply"]
    assert {"render.sh", "image_files.sh", f"{model_id}_pred.pts"} <= set(os.listdir(dump))
    if flags:
        assert {"Segmentation post-processed.", "Scales post-processed.",
                "Extents post-processed."} <= set(lines)
    assert set(res["timings"]) >= {"backbone_and_extraction", "latents", "compositing",
                                   "marching_tetrahedra", "intermediates", "writes"}


def test_cli_needs_the_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.cli_main([a for a in CLI if a not in ("--device", "cpu")]
                    + ["--output_dir", str(tmp_path)])
