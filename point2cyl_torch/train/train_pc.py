"""Trainer A: proxy-loss training of the backbone without the implicit
sketch stack (the port of ``point2cyl_tpu/train/train_pc.py``).

    python -m point2cyl_torch.train.train_pc --synthetic 16 --num_point 8192 \
        --K 8 --batch_size 4 --pred_seg --pred_normal --pred_bb \
        --pred_extrusion --pred_center            # on the card
    python -m point2cyl_torch.train.train_pc ... --device cpu

The flag names are the reference's (``train_Point2Cyl_without_sketch.py:
28-61``), with ``--synthetic N`` to train on the built-in generator,
``--seed``, ``--resume``, ``--tensorboard``, ``--ballquery_impl`` and
``--device`` (default the card). Every random draw of an epoch comes from
one generator seeded by (seed, epoch), so a resumed run replays the
batches an uninterrupted one would have seen.

Data parallel, as the JAX trainer's flags ask for it:

    python -m point2cyl_torch.train.train_pc ... --data_parallel 4
        # 4 ranks on this host, rank r on cuda:r (NCCL); with --device cpu
        # on the CPU (gloo)
    python -m point2cyl_torch.train.train_pc ... --multihost \
        --coordinator_address host:port --num_processes P --process_id i
        # one process a card, started by the caller on each host

Each rank trains on its rows of every global batch of ``--batch_size``
(``train/steps.py``: global BN statistics and draws, averaged gradients),
rank 0 writes the checkpoints and the log. Without either flag the run is
one process on one device.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from point2cyl_torch.core.checkpoint import CheckpointManager
from point2cyl_torch.core.config import BackboneConfig, LossWeights, TrainConfig
from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.core.logging import TrainLogger
from point2cyl_torch.data.h5_io import load_h5
from point2cyl_torch.data.pipeline import InputPipeline
from point2cyl_torch.data.synthetic import generate_dataset
from point2cyl_torch.models.backbone import Backbone
from point2cyl_torch.parallel.distributed import initialize, join, process_batch_slice
from point2cyl_torch.parallel.mesh import make_mesh
from point2cyl_torch.serve.export import head_output_sizes
from point2cyl_torch.train import steps


def build_model(cfg: TrainConfig, num_points: int, k: int,
                device: str | torch.device | None = None) -> Backbone:
    """A fresh full-width backbone on ``device`` (default the card), its
    weights drawn from ``cfg.seed``."""
    dev = resolve_device(device)
    model = Backbone(BackboneConfig(num_points=num_points,
                                    output_sizes=head_output_sizes(
                                        k, cfg.pred_seg, cfg.pred_normal, cfg.pred_bb),
                                    compute_dtype=cfg.compute_dtype,
                                    approx_neighbors=False,
                                    ballquery_impl=cfg.ballquery_impl))
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    return model.to(dev)


def build_trainer(cfg: TrainConfig, num_points: int, k: int,
                  device: str | torch.device | None = None, mesh=None) -> steps.Trainer:
    """A Trainer with a fresh full-width backbone (``build_model``), data
    parallel over ``mesh`` where given."""
    return steps.Trainer(build_model(cfg, num_points, k, device), cfg, mesh)


def build_pipeline(cfg: TrainConfig, num_points: int, k: int, device: torch.device,
                   h5_path: str | None = None, synthetic: int | None = None,
                   synthetic_resolution: int = 8192) -> InputPipeline:
    """The training set on ``device``: ``synthetic`` generated solids
    (seeded by ``cfg.seed``) or the h5 pack at ``h5_path``."""
    if synthetic:
        ds = generate_dataset(synthetic, resolution=synthetic_resolution,
                              max_instances=k, seed=cfg.seed)
    else:
        ds = load_h5(h5_path)
    return InputPipeline(ds, num_points, k, device)


def epoch_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    """The generator of every draw in ``epoch``, a function of (seed, epoch)."""
    state = int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def train(
    cfg: TrainConfig,
    num_points: int,
    k: int,
    h5_path: str | None = None,
    synthetic: int | None = None,
    synthetic_resolution: int = 8192,
    device: str | torch.device | None = None,
    mesh=None,
) -> steps.Trainer:
    """Train on ``device``, or with a ``parallel.mesh.Mesh`` as one rank of
    a data-parallel run on the mesh's device (``cfg.batch_size`` is the
    global batch)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    logger = TrainLogger(cfg.logdir, use_tensorboard=cfg.tensorboard,
                         primary=mesh is None or mesh.rank == 0)
    logger.log(f"config: {cfg}")
    pipeline = build_pipeline(cfg, num_points, k, dev, h5_path, synthetic,
                              synthetic_resolution)
    trainer = build_trainer(cfg, num_points, k, dev, mesh)
    logger.log(f"device {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                                  if dev.type == "cuda" else ""))
    rows_slice = None
    if mesh is not None:
        rows_slice = process_batch_slice(cfg.batch_size, mesh.rank, mesh.world)
        logger.log(f"data-parallel over {mesh.world} rank(s): rank {mesh.rank} "
                   f"takes rows {rows_slice.start}:{rows_slice.stop} of each batch")

    ckpt = CheckpointManager(cfg.logdir, mesh)
    best_loss = float("inf")
    steps_per_epoch = max(pipeline.num_samples // cfg.batch_size, 1)
    start_epoch = 1
    if cfg.resume and ckpt.exists_global("model"):
        state = ckpt.load("model", dev)
        trainer.load_state_dict(state)
        done = int(state["epoch"])
        best_loss = float(state["best_loss"])
        start_epoch = done + 1
        logger.log(f"Resumed from {ckpt.path('model')}: epoch {done}, "
                   f"step {int(trainer.step)}, best {best_loss:.4f}")

    for epoch in range(start_epoch, cfg.num_epochs + 1):
        t0 = time.time()
        gen = epoch_generator(cfg.seed, epoch, dev)
        aux_steps = []
        for i, batch in enumerate(pipeline.epochs(cfg.batch_size, gen,
                                                  rows_slice=rows_slice)):
            aux = trainer.train_step(batch, gen)
            aux_steps.append(aux)
            if i % 10 == 0:
                a = {key: float(val) for key, val in aux.items()}
                logger.log(
                    "Epoch: {}/{} | Batch [{:04d}/{:04d}] | total {:.4f} | "
                    "normal {:.4f} | mIOU {:.4f} | bb {:.4f} | ext {:.4f} | "
                    "center {:.4f}".format(
                        epoch, cfg.num_epochs, i, steps_per_epoch, a["total"],
                        a["normal"], a["miou"], a["bb"], a["extrusion"], a["center"]))
        skipped = steps.log_epoch_aux(logger, aux_steps, (epoch - 1) * steps_per_epoch)
        steps.handle_skipped_epoch(logger, ckpt, trainer, skipped, steps_per_epoch,
                                   epoch)
        means = logger.epoch_means()
        logger.log(f"> Epoch {epoch:04d} done in {time.time() - t0:.1f}s | "
                   + " | ".join(f"{key}: {val:.4f}" for key, val in means.items()))
        best_loss = ckpt.save_epoch(epoch, trainer.state_dict(),
                                    means.get("Loss/total", float("inf")), best_loss,
                                    every=cfg.checkpoint_every_epochs,
                                    best_after=cfg.best_after_epoch)
    # a final rolling save whatever the cadence (the reference saves only
    # on 10-epoch boundaries and loses the tail epochs)
    ckpt.save("model", {**trainer.state_dict(),
                        "epoch": max(cfg.num_epochs, start_epoch - 1),
                        "best_loss": best_loss})
    logger.close()
    return trainer


def build_argparser() -> argparse.ArgumentParser:
    """Reference-compatible CLI (``train_Point2Cyl_without_sketch.py:28-61``)."""
    p = argparse.ArgumentParser(description="Trainer A of the PyTorch/CUDA port")
    p.add_argument("--num_point", type=int, default=8192)
    p.add_argument("--K", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--logdir", default="Point2Cyl_without_sketch", type=str)
    p.add_argument("--data_dir", type=str, default="data/")
    p.add_argument("--data_split", default="train", type=str)
    p.add_argument("--num_epochs", type=int, default=300)
    p.add_argument("--decay_step", type=int, default=200_000)
    p.add_argument("--bn_decay_step", type=int, default=200_000)
    p.add_argument("--decay_rate", type=float, default=0.7)
    p.add_argument("--learning_rate", type=float, default=0.001)
    # parsed but inert in the reference too: the BN schedule overwrites it
    # (train_Point2Cyl_without_sketch.py:92,208,357-360)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--pred_seg", action="store_true")
    p.add_argument("--pred_normal", action="store_true")
    p.add_argument("--pred_bb", action="store_true")
    p.add_argument("--pred_extrusion", action="store_true")
    p.add_argument("--pred_center", action="store_true")
    p.add_argument("--norm_eig", action="store_true")
    p.add_argument("--weight_seg", type=float, default=1.0)
    p.add_argument("--weight_normal", type=float, default=1.0)
    p.add_argument("--weight_bb", type=float, default=1.0)
    p.add_argument("--weight_extrusion", type=float, default=1.0)
    p.add_argument("--weight_center", type=float, default=1.0)
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("--noise_sigma", type=float, default=0.01)
    p.add_argument("--resume", action="store_true",
                   help="restore model, Adam, step and epoch from "
                   "<logdir>/model.pth and continue")
    p.add_argument("--synthetic", type=int, default=None,
                   help="train on N synthetic solids instead of h5 data")
    p.add_argument("--synthetic_resolution", type=int, default=8192)
    p.add_argument("--compute_dtype", type=str, default="float32")
    p.add_argument("--ballquery_impl", type=str, default="auto",
                   choices=["auto", "kernel", "plain"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tensorboard", action="store_true",
                   help="also write tensorboard scalars to <logdir>/tb")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    add_parallel_args(p)
    return p


def add_parallel_args(p: argparse.ArgumentParser) -> None:
    """JAX Trainer A's data-parallel flags (``train_pc.py:222-233``)."""
    p.add_argument("--data_parallel", type=int, default=None,
                   help="ranks on this host, one card each (rank r on cuda:r, NCCL; "
                   "gloo with --device cpu), reduced until they divide --batch_size")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-process run: this process is rank "
                   "--process_id of --num_processes, meeting at "
                   "--coordinator_address (host:port or an init URL)")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def run_data_parallel(args: argparse.Namespace, fn):
    """``fn(args, mesh)`` as the parallel flags ask: ``mesh=None`` without
    them; with ``--multihost`` as this process's rank of the run (the
    batch must divide over the ranks); with ``--data_parallel N`` as N
    ranks on this host, N reduced until it divides the batch (JAX
    ``train_pc.py:83-98``), one process each (a spawn; a single rank runs
    here). Returns ``fn``'s result where it ran in this process, else
    None. ``fn`` is a module-level function (the spawn pickles it)."""
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if args.multihost:
        created = not dist.is_initialized()
        initialize(args.coordinator_address, args.num_processes, args.process_id,
                   backend="gloo" if cpu else "nccl")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if args.batch_size % world:
            raise ValueError(f"--batch_size {args.batch_size} must divide over "
                             f"{world} processes for multi-host runs")
        try:
            return fn(args, make_mesh(devices=["cpu"] * world if cpu else None))
        finally:
            if created and dist.is_initialized():
                dist.destroy_process_group()
    if args.data_parallel is None:
        return fn(args, None)
    world = max(args.data_parallel, 1)
    while args.batch_size % world:
        world -= 1  # the largest rank count that divides the batch
    if not cpu and world > torch.cuda.device_count():
        raise ValueError(f"--data_parallel {world} needs {world} cards; this host has "
                         f"{torch.cuda.device_count()} (ranks never share a card)")
    rdv = tempfile.mkdtemp(prefix="p2c_rdv_")
    try:
        url = "file://" + os.path.join(rdv, "rdv")
        if world == 1:
            return _rank_main(0, fn, args, 1, url, cpu)
        mp.spawn(_rank_main, args=(fn, args, world, url, cpu), nprocs=world, join=True)
        return None
    finally:
        shutil.rmtree(rdv, ignore_errors=True)


def _rank_main(rank: int, fn, args: argparse.Namespace, world: int, url: str, cpu: bool):
    """One rank of a ``--data_parallel`` run: join the group (a world of
    1 too, so that its collectives run), run ``fn``, leave. Ranks on the
    CPU split its cores between them."""
    if cpu and world > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    join(url, world, rank, backend="gloo" if cpu else "nccl")
    try:
        return fn(args, make_mesh(devices=["cpu"] * world if cpu else None))
    finally:
        dist.destroy_process_group()


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        learning_rate=args.learning_rate,
        decay_step=args.decay_step,
        decay_rate=args.decay_rate,
        bn_decay_step=args.bn_decay_step,
        add_noise=args.add_noise,
        noise_sigma=args.noise_sigma,
        pred_seg=args.pred_seg,
        pred_normal=args.pred_normal,
        pred_bb=args.pred_bb,
        pred_extrusion=args.pred_extrusion,
        pred_center=args.pred_center,
        norm_eig=args.norm_eig,
        weights=LossWeights(seg=args.weight_seg, normal=args.weight_normal,
                            base_barrel=args.weight_bb,
                            extrusion_axis=args.weight_extrusion,
                            center=args.weight_center),
        logdir=args.logdir,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        ballquery_impl=args.ballquery_impl,
        resume=args.resume,
        tensorboard=args.tensorboard,
    )


def cli_main(argv: list[str] | None = None) -> steps.Trainer | None:
    """Train as the flags say; returns the trainer, or None where the
    ranks ran in processes of their own (``--data_parallel`` above 1)."""
    return run_data_parallel(build_argparser().parse_args(argv), _train_main)


def _train_main(args: argparse.Namespace, mesh) -> steps.Trainer:
    h5_path = None
    if not args.synthetic:
        h5_path = os.path.join(args.data_dir, args.data_split + ".h5")
    return train(config_from_args(args), num_points=args.num_point, k=args.K,
                 h5_path=h5_path, synthetic=args.synthetic,
                 synthetic_resolution=args.synthetic_resolution, device=args.device,
                 mesh=mesh)


if __name__ == "__main__":
    cli_main()
