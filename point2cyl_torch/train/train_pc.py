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
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from point2cyl_torch.core.checkpoint import CheckpointManager
from point2cyl_torch.core.config import BackboneConfig, LossWeights, TrainConfig
from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.core.logging import TrainLogger
from point2cyl_torch.data.h5_io import load_h5
from point2cyl_torch.data.pipeline import InputPipeline
from point2cyl_torch.data.synthetic import generate_dataset
from point2cyl_torch.models.backbone import Backbone
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
                  device: str | torch.device | None = None) -> steps.Trainer:
    """A Trainer with a fresh full-width backbone (``build_model``)."""
    return steps.Trainer(build_model(cfg, num_points, k, device), cfg)


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
) -> steps.Trainer:
    dev = resolve_device(device)
    logger = TrainLogger(cfg.logdir, use_tensorboard=cfg.tensorboard)
    logger.log(f"config: {cfg}")
    pipeline = build_pipeline(cfg, num_points, k, dev, h5_path, synthetic,
                              synthetic_resolution)
    trainer = build_trainer(cfg, num_points, k, dev)
    logger.log(f"device {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                                  if dev.type == "cuda" else ""))

    ckpt = CheckpointManager(cfg.logdir)
    best_loss = float("inf")
    steps_per_epoch = max(pipeline.num_samples // cfg.batch_size, 1)
    start_epoch = 1
    if cfg.resume and ckpt.exists("model"):
        state = ckpt.load("model", dev)
        trainer.load_state_dict(state)
        done = int(state["epoch"])
        best_loss = float(state["best_loss"])
        start_epoch = done + 1
        logger.log(f"Resumed from {ckpt.path('model')}: epoch {done}, "
                   f"step {trainer.step}, best {best_loss:.4f}")

    for epoch in range(start_epoch, cfg.num_epochs + 1):
        t0 = time.time()
        gen = epoch_generator(cfg.seed, epoch, dev)
        aux_steps = []
        for i, batch in enumerate(pipeline.epochs(cfg.batch_size, gen)):
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
    return p


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


def cli_main(argv: list[str] | None = None) -> steps.Trainer:
    args = build_argparser().parse_args(argv)
    h5_path = None
    if not args.synthetic:
        h5_path = os.path.join(args.data_dir, args.data_split + ".h5")
    return train(config_from_args(args), num_points=args.num_point, k=args.K,
                 h5_path=h5_path, synthetic=args.synthetic,
                 synthetic_resolution=args.synthetic_resolution, device=args.device)


if __name__ == "__main__":
    cli_main()
