"""Reconstruction / visualization entry point (the port of the JAX
``recon/reconstruct.py``).

    python -m point2cyl_torch.recon.reconstruct --logdir runs/joint \
        --synthetic --model_id 0 --resolution 512      # on the card
    python -m point2cyl_torch.recon.reconstruct ... --device cpu

Capability twin of ``visualizer.py``: forward a single model, match the
hard segmentation against GT labels, estimate axes / centers / extents,
extract per-instance sketch latents, optionally post-process (consensus
relabeling, RANSAC scale, extent clustering) and per-instance IGR
fine-tune, then composite a signed volume with CSG add/cut operations and
extract the mesh.

The compositing runs on the decoder's device: per instance the whole R^3
grid streams through the decoder in chunks of points (so activations stay
bounded at R = 512) and the CSG update is a masked ``where`` on the
device; only the final and the per-instance volumes come to the host.
The isosurface is the native streaming extractor (``native/``), which
raises where it cannot be built.
"""

from __future__ import annotations

import argparse
import copy
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from point2cyl_torch.core.checkpoint import restore_backbone, restore_implicit_stack_from
from point2cyl_torch.core.config import IMPLS, BackboneConfig
from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.core.graphs import StepGraphs
from point2cyl_torch.eval import metrics as M
from point2cyl_torch.losses.igr import igr_losses
from point2cyl_torch.losses.segmentation import reorder_w
from point2cyl_torch.models.backbone import Backbone
from point2cyl_torch.models.implicit import (ImplicitNet, PointNetEncoder, add_latent,
                                             sample_off_surface)
from point2cyl_torch.ops.geometry import extrusion_extents, rotation_to_z, sketch_projection
from point2cyl_torch.ops.linalg import estimate_extrusion_axis
from point2cyl_torch.ops.matching import hard_w_encoding, hungarian_matching
from point2cyl_torch.recon.isosurface import (convert_sdf_samples_to_ply,
                                              drop_small_components)
from point2cyl_torch.recon.ply import read_ply, write_ply
from point2cyl_torch.train import steps as train_steps
from point2cyl_torch.train.steps import assemble_heads

# Design options: CSG op (+1 add / -1 cut) and composition order per
# instance (``visualizer.py:122-143``).
DESIGN_OPTIONS = {
    1: (np.ones(8), np.arange(8)),
    2: (np.array([-1, 1, 1]), np.array([1, 0, 2])),
    3: (np.array([-1, -1, 1, 1]), np.array([2, 1, 0, 3])),
    4: (np.array([1, -1, 1]), np.array([0, 1, 2])),
    5: (np.array([1, 1, -1]), np.array([0, 1, 2])),
}
# points of the grid a decoder call takes: 2 GiB a 512-wide activation
COMPOSITE_CHUNK_POINTS = 1 << 20


@torch.inference_mode()
def extract_extrusion_params(
    backbone: Backbone, pts: torch.Tensor, gt_labels: torch.Tensor, k: int,
    generator: torch.Generator | None = None, norm_eig: bool = False,
    num_extent_samples: int = 1024,
) -> dict[str, torch.Tensor]:
    """Forward + hard matching vs GT + axes/centers/extents
    (``visualizer.py:330-419``). pts (1, N, 3) on the backbone's device,
    which is in eval mode; ``generator=None`` takes the deterministic
    segment draw."""
    x_raw, w_raw = backbone(pts)
    heads = assemble_heads(x_raw, w_raw, True, True, k=k)
    w_hard = hard_w_encoding(heads.w, to_null_mask=True)
    matching, mask = hungarian_matching(w_hard, gt_labels)
    w_soft_reordered = reorder_w(heads.w, matching)
    w_hard_reordered = reorder_w(w_hard, matching)
    label = torch.argmax(w_soft_reordered, dim=-1)
    pred_bb = torch.argmax(M.base_barrel_probs(heads.w_2k), dim=-1)
    wb = reorder_w(heads.w_barrel, matching)
    wc = reorder_w(heads.w_base, matching)
    axes = estimate_extrusion_axis(heads.normals, wb, wc, pred_bb, label,
                                   normalize=norm_eig)
    centers, found = M.hard_segment_centers(pts, w_hard_reordered)
    extents, _ = extrusion_extents(generator, pts, label, pred_bb, axes, centers,
                                   num_samples=num_extent_samples)
    return {
        "normals": heads.normals,
        "label": label,
        "pred_bb": pred_bb,
        "axes": axes,
        "centers": centers,
        "extents": extents,
        "w_soft_reordered": w_soft_reordered,
        "mask": mask,
        "found": found,
    }


@torch.inference_mode()
def extract_sketch_latents(
    encoder: PointNetEncoder, generator: torch.Generator | None, pts: torch.Tensor,
    normals: torch.Tensor, label: torch.Tensor, bb: torch.Tensor, axes: torch.Tensor,
    centers: torch.Tensor, num_sk_points: int,
) -> tuple[torch.Tensor, ...]:
    """Project + scale-normalize + encode (``visualizer.py:436-463``) with
    the exact rotation; the encoder is in eval mode. Returns latents
    (B, K, L), scales (B, K), p2d / scale and n2d (B, K, S, 2), found."""
    p2d, n2d, scales, found = sketch_projection(
        generator, pts, normals, label, bb, axes, centers, num_samples=num_sk_points)
    p2d_n = p2d / scales[..., None, None]
    b, k = scales.shape
    enc_in = torch.cat([p2d_n, n2d], dim=-1).reshape(b * k, num_sk_points, 4)
    latents = encoder(enc_in).reshape(b, k, -1)
    return latents, scales, p2d_n, n2d, found


class FineTuner:
    """Per-instance IGR fine-tuning (``visualizer.py:659-810``) with one
    tuned decoder and its Adam state for a whole reconstruction: each
    :meth:`tune` loads the instance's starting weights into them in place.

    A step is Adam (optax's, ``train.steps.adam_select``) on manifold +
    0.1 eikonal + SALD (``igr_losses`` of one instance) with each step's
    off-surface samples drawn from the generator; on the card it is one
    captured CUDA graph (``core/graphs.py``), replayed ``check_every``
    times a chunk, and the host reads the loss once a chunk for the
    plateau check, as JAX's jitted ``lax.scan`` of a chunk does
    (``recon/reconstruct.py:150-194`` of the JAX package). ``sampler``
    (points (1, S, 2) -> off-surface samples) replaces the draw; it runs
    inside the step, so on the card it needs ``graph=False`` (the CPU
    parity test feeds JAX's samples through it).
    """

    def __init__(self, implicit: ImplicitNet, lr: float = 1e-3,
                 sampler: Callable[[torch.Tensor], torch.Tensor] | None = None,
                 graph: bool = True):
        self.decoder = copy.deepcopy(implicit).requires_grad_(True)
        self._params = list(self.decoder.parameters())
        dev = self._params[0].device
        if sampler is not None and graph and dev.type == "cuda":
            raise ValueError("a custom sampler runs inside the captured step; pass "
                             "graph=False to fine-tune with it on the card")
        self.sampler = sampler
        self._grads = train_steps.FlatGrads(self._params)
        self._moments = torch.zeros(2, self._grads.grad.numel(), device=dev)
        self._count = torch.zeros((), dtype=torch.int64, device=dev)
        self._lr = torch.full((), lr, device=dev)
        self._ok = torch.ones((), dtype=torch.bool, device=dev)
        self.graphs = StepGraphs(dev, enabled=graph)

    @torch.no_grad()
    def load(self, start: torch.nn.Module) -> None:
        """``start``'s weights into the tuned decoder, Adam's state to zero."""
        for p, q in zip(self._params, start.parameters()):
            p.copy_(q)
        self._moments.zero_()
        self._count.zero_()

    def tune(self, start: torch.nn.Module, latent: torch.Tensor, sk_pts: torch.Tensor,
             sk_normals: torch.Tensor, generator: torch.Generator | None = None,
             max_steps: int = 10_000, eps_loss: float = 1e-5,
             check_every: int = 100) -> int:
        """Fine-tune from ``start``'s weights on one projected sketch, in
        chunks of ``check_every`` steps with the host's plateau check
        ``|loss - prev| < eps_loss`` between chunks; the tuned weights stay
        in ``decoder``. Args: latent (L,); sk_pts/sk_normals (S, 2), on the
        decoder's device. Returns the steps taken."""
        self.load(start)
        # clones: the inputs may be inference tensors, which autograd cannot save
        inputs = {"lat": latent.detach().clone()[None, None],
                  "pts": sk_pts.detach().clone()[None, None],
                  "nrm": sk_normals.detach().clone()[None, None]}
        prev, steps = None, 0
        for _ in range(max_steps // check_every):
            for _ in range(check_every):
                loss = self.graphs(self._step, inputs, generator)
            steps += check_every
            loss = float(loss)
            if prev is not None and abs(loss - prev) < eps_loss:
                break
            prev = loss
        return steps

    def _step(self, inputs: dict, generator) -> torch.Tensor:
        """One Adam step, with no host read; returns the loss before it."""
        pts = inputs["pts"]
        self._grads.zero()
        off = (sample_off_surface(generator, pts[0]) if self.sampler is None
               else self.sampler(pts[0]))
        mask = torch.ones((1, 1), dtype=torch.bool, device=pts.device)
        loss = igr_losses(self.decoder, None, pts, inputs["nrm"], inputs["lat"], mask,
                          off_pts=off).total
        loss.backward()
        with torch.no_grad():
            train_steps.adam_select(self._params, self._grads.grad, self._moments,
                                    self._count, self._lr, self._ok)
            self._count.add_(1)
        return loss.detach()

    def tuned_copy(self) -> ImplicitNet:
        """The tuned weights as a decoder of their own (no gradients), for
        the compositing, which takes one decoder an instance."""
        return copy.deepcopy(self.decoder).requires_grad_(False)


def igr_finetune(
    implicit: ImplicitNet,
    latent: torch.Tensor,
    sk_pts: torch.Tensor,
    sk_normals: torch.Tensor,
    generator: torch.Generator | None = None,
    max_steps: int = 10_000,
    lr: float = 1e-3,
    eps_loss: float = 1e-5,
    check_every: int = 100,
    sampler: Callable[[torch.Tensor], torch.Tensor] | None = None,
    graph: bool = True,
) -> tuple[ImplicitNet, int]:
    """One instance's fine-tune (:class:`FineTuner`) from ``implicit``'s
    weights: returns the tuned copy (no gradients) and the steps it took.
    Each step's off-surface samples come from ``sampler(points (1, S,
    2))``, by default ``sample_off_surface`` drawn from ``generator``."""
    tuner = FineTuner(implicit, lr, sampler, graph)
    steps = tuner.tune(implicit, latent, sk_pts, sk_normals, generator, max_steps, eps_loss,
                       check_every)
    return tuner.decoder.requires_grad_(False), steps


def composite_grid(resolution: int, half_range: float = 1.0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The compositing grid as the JAX package builds it: (R*R, 2) float32
    (x, y) rows of ``np.meshgrid`` in its default "xy" indexing, and (R,)
    float32 z values, replicating compute_grid2D's half-cell quirk
    (``data_utils.py:2255-2269``): the offset is -half_cell for x/y,
    +half for z."""
    r = resolution
    lo, hi = -half_range, half_range
    xy_lin = np.linspace(lo, hi, r, endpoint=False) + (lo - hi) / r * 0.5
    z_lin = np.linspace(lo, hi, r, endpoint=False) + (hi - lo) / r * 0.5
    xg, yg = np.meshgrid(xy_lin, xy_lin)
    xy = np.stack([xg.reshape(-1), yg.reshape(-1)], -1).astype(np.float32)
    return xy, z_lin.astype(np.float32)


@torch.inference_mode()
def composite_volume(
    decoders: Sequence[torch.nn.Module],
    latents: torch.Tensor,
    axes: torch.Tensor,
    centers: torch.Tensor,
    scales: np.ndarray,
    extents: np.ndarray,
    ops: np.ndarray,
    perm: np.ndarray,
    n_instances: int,
    resolution: int = 256,
    half_range: float = 1.0,
    chunk_points: int = COMPOSITE_CHUNK_POINTS,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """CSG volume compositing (``visualizer.py:711-918``).

    Per instance (in ``perm`` order): evaluate the 2D sketch SDF over the
    projected grid, build the extrusion signed distance
    min(|sdf_2d|, extent_dist) with inside/outside sign, and write
    add (+) / cut (-) contributions into the volume under the reference's
    occupancy-threshold masks.

    Args: ``decoders[j]``, instance j's decoder; latents (K, L), axes and
    centers (K, 3) on its device; scales (K,) and extents (K, 2) on the
    host. The grid goes through the decoder ``chunk_points`` points at a
    time. Returns (volume (R, R, R) indexed [z, y, x], the list of
    per-instance volumes), float32 numpy.
    """
    if n_instances > len(ops):
        raise ValueError(f"the design option composes {len(ops)} instances; the "
                         f"model has {n_instances}")
    dev = latents.device
    r = resolution
    rr, total = r * r, r ** 3
    xy, z = composite_grid(r, half_range)
    xy_flat = torch.from_numpy(xy).to(dev)
    z_vals = torch.from_numpy(z).to(dev)
    eps_base = 2 * half_range / r
    volume = torch.full((total,), -1.0, device=dev)
    intermediates = []
    first = True
    for i in range(n_instances):
        j = int(perm[i]) if i < len(perm) else i
        if j >= n_instances:
            continue
        extent = np.asarray(extents)[j]
        if abs(extent[0] - extent[1]) < 0.01:
            continue  # too shallow (visualizer.py:720-723)
        max_ext = float(np.abs(extent).max())
        eps = eps_base if ops[j] != -1 else max_ext * 0.5
        op, scale = float(ops[j]), float(scales[j])
        thresh = 0.0001 if ops[j] == -1 else 0.05
        ax, c, lat = axes[j], centers[j], latents[j]
        rot = rotation_to_z(ax[None])[0]
        c2 = (rot @ c)[:2]
        curr = torch.empty((total,), device=dev)
        for a in range(0, total, chunk_points):
            idx = torch.arange(a, min(a + chunk_points, total), device=dev)
            xyz = torch.cat([xy_flat[idx % rr], z_vals[idx // rr, None]], dim=-1)
            proj = ((xyz @ rot.T)[:, :2] - c2) / scale
            sdf = decoders[j](add_latent(proj[None], lat[None]))[0, :, 0]
            dist = (xyz - c) @ ax
            occ_ext = dist.abs() <= max_ext + eps
            inside = (sdf <= 0.0) & occ_ext
            field = torch.minimum(sdf.abs(), (max_ext - dist.abs()).abs()) * scale
            field = torch.where(inside, field, -field)
            curr[a:a + len(idx)] = field
            if first:
                volume[a:a + len(idx)] = field * op
            else:
                volume[a:a + len(idx)] = torch.where((sdf <= thresh) & occ_ext,
                                                     field * op, volume[a:a + len(idx)])
        first = False
        intermediates.append(curr.reshape(r, r, r).cpu().numpy())
    return volume.reshape(r, r, r).cpu().numpy(), intermediates


def reconstruct_mesh(
    volume: np.ndarray,
    out_path: str,
    half_range: float = 1.0,
    level: float = 0.0,
    has_cut: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Marching tetrahedra -> PLY (+ cut-op small-component cleanup,
    ``visualizer.py:913-944``)."""
    r = volume.shape[0]
    verts, faces = convert_sdf_samples_to_ply(
        volume, [0.0, 0.0, 0.0], 2 * half_range / r, out_path, level=level)
    if has_cut and len(faces):
        verts, faces = read_ply(out_path)
        verts, faces = drop_small_components(verts, faces)
        write_ply(out_path, verts, faces)
    return verts, faces


def build_argparser() -> argparse.ArgumentParser:
    """Reference-compatible CLI (``visualizer.py:49-111``)."""
    p = argparse.ArgumentParser(description="Reconstruction of the PyTorch/CUDA port")
    p.add_argument("--logdir", default="results/Point2Cyl", type=str)
    p.add_argument("--ckpt", default="model", type=str)
    p.add_argument("--im_logdir", default="results/IGR_dense", type=str)
    p.add_argument("--im_ckpt", default="model", type=str)
    p.add_argument("--data_dir", type=str, default="data/")
    p.add_argument("--model_id", default="0", type=str)
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--num_sk_point", type=int, default=2048)
    p.add_argument("--K", type=int, default=8)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--range", dest="half_range", type=float, default=1.0)
    p.add_argument("--level", type=float, default=0.0)
    p.add_argument("--design_option", type=int, default=1)
    p.add_argument("--seg_post_process", action="store_true")
    p.add_argument("--scale_post_process", action="store_true")
    p.add_argument("--extent_post_process", action="store_true")
    p.add_argument("--igr_post_process", action="store_true")
    p.add_argument("--igr_post_process_reinit", "--igr_pp_init",
                   dest="igr_post_process_reinit", action="store_true",
                   help="fine-tune from a fresh geometric init instead of "
                   "the loaded implicit params (visualizer.py:728-735)")
    p.add_argument("--use_pretrained_2d", action="store_true",
                   help="take the implicit stack from --im_logdir (the "
                   "sketch-only pretrained ckpt) instead of the joint "
                   "trainer's combined ckpt in --logdir "
                   "(visualizer.py:309-317,457-460)")
    p.add_argument("--norm_eig", action="store_true")
    p.add_argument("--use_gt_3d", action="store_true",
                   help="reconstruct from GT extrusion parameters (the "
                   "reference declares this flag but exits 'Non-"
                   "implemented', visualizer.py:424-426; implemented here)")
    p.add_argument("--dump_dir", default="dump_visu/", type=str)
    p.add_argument("--output_dir", default="output_visu/", type=str)
    p.add_argument("--synthetic", action="store_true",
                   help="reconstruct a synthetic sample (model_id = index)")
    p.add_argument("--synthetic_resolution", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ballquery_impl", choices=IMPLS, default="auto",
                   help="the ball queries' route, as in the trainers")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p


def cli_main(argv: list[str] | None = None) -> dict:
    """Reconstruct one model; returns the mesh's vertex and face counts,
    its path, the wall seconds of each stage (``timings``) and, with
    ``--igr_post_process``, the steps each instance's fine-tune took
    (``finetune_steps``)."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    timings: dict[str, float] = {}

    def lap(name: str, t0: float) -> float:
        """Close stage ``name`` begun at ``t0`` (after the device's work)."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        timings[name] = now - t0
        return now

    t_start = t = time.perf_counter()
    os.makedirs(args.dump_dir, exist_ok=True)
    k = args.K

    # ---- load one model's data ----
    if args.synthetic:
        from point2cyl_torch.data.synthetic import generate_dataset

        idx = int(args.model_id)
        ds = generate_dataset(idx + 1, resolution=args.synthetic_resolution,
                              max_instances=k, num_sketch_points=args.num_sk_point,
                              seed=args.seed)
    else:
        from point2cyl_torch.data.h5_io import load_h5

        idx = 0
        ds = load_h5(os.path.join(args.data_dir, args.model_id + ".h5"))
    pc = ds.point_cloud[idx]
    gt_labels = ds.extrusion_labels[idx]
    n_instances = int(ds.n_instances[idx])

    rng = np.random.default_rng(args.seed)
    sel = rng.permutation(pc.shape[0])[: args.num_points]
    pts = torch.from_numpy(np.ascontiguousarray(pc[sel][None])).to(dev)
    gt_lab = torch.from_numpy(gt_labels[sel][None].astype(np.int64)).to(dev)

    # ---- nets + checkpoints ----
    backbone = Backbone(BackboneConfig(num_points=args.num_points, output_sizes=(3, 2 * k),
                                       approx_neighbors=False,
                                       ballquery_impl=args.ballquery_impl))
    gen = torch.Generator().manual_seed(args.seed)
    backbone.reset_parameters(gen)
    implicit = ImplicitNet(d_in=258)
    implicit.reset_parameters(gen)
    encoder = PointNetEncoder(256, 2, with_normals=True)
    encoder.reset_parameters(gen)
    if restore_backbone(args.logdir, backbone, (args.ckpt, "pc_model")) is not None:
        print("Model loaded.")
    # Implicit-stack source (visualizer.py:309-317): by default the joint
    # trainer's combined checkpoint (same logdir as the backbone); with
    # --use_pretrained_2d the sketch-only pretrained stack from im_logdir.
    if args.use_pretrained_2d:
        im_sources = [(args.im_logdir, args.im_ckpt), (args.im_logdir, "im_model")]
    else:
        im_sources = [(args.logdir, "im_model"), (args.logdir, args.im_ckpt),
                      (args.im_logdir, args.im_ckpt), (args.im_logdir, "im_model")]
    im_from = restore_implicit_stack_from(im_sources, implicit, encoder)
    if im_from is not None:
        print(f"Pre-trained fixed implicit model loaded ({im_from}).")
    backbone, implicit, encoder = (m.to(dev).eval() for m in (backbone, implicit, encoder))
    t = lap("setup", t)

    # ---- extrusion parameter extraction ----
    draw = torch.Generator(dev).manual_seed(args.seed)
    if args.use_gt_3d:
        def gt(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)[None]).to(dev)

        params = {
            "normals": gt(ds.normals[idx][sel]),
            "label": gt_lab,
            "pred_bb": gt(ds.base_barrel_labels[idx][sel].astype(np.int64)),
            "axes": gt(ds.extrusion_axes[idx][:k]),
            "centers": gt(ds.extrusion_centers[idx][:k]),
            "extents": gt(ds.extrusion_extents[idx][:k]),
            "w_soft_reordered": torch.nn.functional.one_hot(gt_lab, k).float(),
            "mask": torch.ones((1, k), dtype=torch.bool, device=dev),
            "found": torch.ones((1, k), dtype=torch.bool, device=dev),
        }
    else:
        params = extract_extrusion_params(backbone, pts, gt_lab, k, draw,
                                          norm_eig=args.norm_eig)
    label = params["label"][0].cpu().numpy()
    pred_bb = params["pred_bb"][0].cpu().numpy()
    axes = params["axes"][0].cpu().numpy()
    centers = params["centers"][0].cpu().numpy()
    extents = params["extents"][0].cpu().numpy()
    pc_np = pts[0].cpu().numpy()
    t = lap("backbone_and_extraction", t)

    # ---- post-processing ----
    if args.seg_post_process:
        from point2cyl_torch.recon.postprocess import consensus_relabel

        label = consensus_relabel(
            pc_np, label,
            params["w_soft_reordered"][0, :, :n_instances].cpu().numpy(), n_instances)
        print("Segmentation post-processed.")
        t = lap("seg_post_process", t)

    def host(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)[None]).to(dev)

    latents, scales, p2d_n, n2d, found = extract_sketch_latents(
        encoder, draw, pts, params["normals"], host(label), host(pred_bb), host(axes),
        host(centers), args.num_sk_point)
    scales_np = scales[0].cpu().numpy()
    t = lap("latents", t)

    if args.scale_post_process:
        from point2cyl_torch.recon.postprocess import scale_ransac

        # un-normalize the projections for RANSAC (it expects raw scale)
        raw = p2d_n[0].cpu().numpy() * scales_np[:, None, None]
        scales_np = scale_ransac(raw[None], found.cpu().numpy(), seed=args.seed)[0]
        print("Scales post-processed.")
        t = lap("scale_post_process", t)
    if args.extent_post_process:
        from point2cyl_torch.recon.postprocess import extents_clustering

        extents, _ = extents_clustering(pc_np[None], label[None], pred_bb[None],
                                        axes[None], centers[None])
        extents = extents[0]
        print("Extents post-processed.")
        t = lap("extent_post_process", t)

    # ---- optional per-instance IGR fine-tuning ----
    decoders = [implicit] * k
    finetune_steps: list[int] = []
    if args.igr_post_process:
        start = implicit
        if args.igr_post_process_reinit:
            # fresh geometric init per the reference's reinit branch
            # (visualizer.py:734-736)
            start = ImplicitNet(d_in=258)
            start.reset_parameters(torch.Generator().manual_seed(args.seed + 1))
            start = start.to(dev)
        tuner = FineTuner(start)
        for j in range(n_instances):
            finetune_steps.append(tuner.tune(start, latents[0, j], p2d_n[0, j], n2d[0, j],
                                             draw))
            decoders[j] = tuner.tuned_copy()
            print(f"IGR fine-tuned instance {j} ({finetune_steps[-1]} steps).")
        t = lap("igr_finetune", t)

    # ---- CSG compositing + mesh ----
    ops, perm = DESIGN_OPTIONS.get(args.design_option, DESIGN_OPTIONS[1])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    volume, intermediates = composite_volume(
        decoders, latents[0], torch.from_numpy(axes).to(dev),
        torch.from_numpy(centers).to(dev), scales_np, extents, ops, perm, n_instances,
        resolution=args.resolution, half_range=args.half_range)
    t = lap("compositing", t)
    if dev.type == "cuda":
        print(f"Compositing peak memory: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    # Output layout mirrors the reference (visualizer.py:158-170):
    # OUTPUT_DIR/{reconstruction,input_point_clouds,intermediate_volumes};
    # DUMP_DIR receives the debug render scripts.
    recons_fol = os.path.join(args.output_dir, "reconstruction")
    pc_input_fol = os.path.join(args.output_dir, "input_point_clouds")
    intermediate_fol = os.path.join(args.output_dir, "intermediate_volumes")
    for d in (recons_fol, pc_input_fol, intermediate_fol):
        os.makedirs(d, exist_ok=True)
    out_ply = os.path.join(recons_fol, f"{args.model_id}.ply")
    verts, faces = reconstruct_mesh(volume, out_ply, half_range=args.half_range,
                                    level=args.level,
                                    has_cut=(-1 in list(ops[:n_instances])))
    t = lap("marching_tetrahedra", t)
    for i, vol in enumerate(intermediates):
        convert_sdf_samples_to_ply(
            vol, [0.0, 0.0, 0.0], 2 * args.half_range / args.resolution,
            os.path.join(intermediate_fol, f"{args.model_id}_{i}.ply"), level=args.level)
    t = lap("intermediates", t)
    write_ply(os.path.join(pc_input_fol, f"{args.model_id}.ply"), pc_np,
              np.zeros((0, 3), np.int32))
    from point2cyl_torch.recon.render_scripts import RenderScriptWriter

    writer = RenderScriptWriter(args.dump_dir)
    writer.add_pointcloud(str(args.model_id), pc_np, label, gt_lab[0].cpu().numpy())
    writer.add_mesh(str(args.model_id), out_ply)
    writer.finalize()
    lap("writes", t)
    print(f"Reconstructed {len(verts)} verts / {len(faces)} faces -> {out_ply}")
    print(f"Total time: {time.perf_counter() - t_start:.1f}s")
    return {"verts": len(verts), "faces": len(faces), "out_ply": out_ply,
            "intermediates": len(intermediates), "timings": timings,
            "finetune_steps": finetune_steps}


if __name__ == "__main__":
    cli_main()
