"""The trained-accuracy run check on the committed A/B pack.

For each seed: Trainer A on ``ab_data/train.h5`` with the protocol's
flags (N=512, B=8, all five heads, 150 epochs), then the evaluator on
``ab_data/test.h5`` (``--no_implicit --seed 0``), both through their
CLIs, as ``tools/tpu_queue_r4.sh:75-80`` runs the JAX package:

    python -m point2cyl_torch.eval.ab_pack --seeds 5 6 7 8 9 10

Each run writes ``<out_dir>/torch_ab_s<seed>/{log.txt,log_evaluate.txt}``
and its checkpoints. One JSON row a seed: the last epoch's mean train
loss, the metric means, the wall seconds of training and of evaluation,
and the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time

import torch

from point2cyl_torch.eval import evaluator
from point2cyl_torch.train import train_pc

HEADS = ["--pred_seg", "--pred_normal", "--pred_bb", "--pred_extrusion", "--pred_center"]
EPOCHS = 150


def card_line() -> str | None:
    """``name, power limit`` of the first card, or None without nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def _wall(fn):
    t0 = time.perf_counter()
    result = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def run_seed(seed: int, data_dir: str, out_dir: str, device: str | None) -> dict:
    logdir = os.path.join(out_dir, f"torch_ab_s{seed}")
    dev = ["--device", device] if device else []
    _, train_s = _wall(lambda: train_pc.cli_main(
        ["--data_dir", data_dir, "--data_split", "train", "--num_point", "512",
         "--batch_size", "8", "--num_epochs", str(EPOCHS), *HEADS,
         "--seed", str(seed), "--logdir", logdir, *dev]))
    means, eval_s = _wall(lambda: evaluator.cli_main(
        ["--logdir", logdir, "--data_dir", data_dir, "--data_split", "test",
         "--num_point", "512", "--batch_size", "8", "--no_implicit", "--seed", "0",
         *dev]))
    with open(os.path.join(logdir, "log.txt")) as f:
        last = [line for line in f if line.startswith("> Epoch")][-1]
    loss = float(re.search(r"Loss/total: ([0-9.eE+-]+|nan|inf)", last).group(1))
    return {"seed": seed, "final_train_loss": loss, **means, "train_s": train_s,
            "eval_s": eval_s}


def main(argv: list[str] | None = None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[5, 6, 7, 8, 9, 10])
    p.add_argument("--data_dir", default="ab_data")
    p.add_argument("--out_dir", default="runs")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)
    card = card_line()
    rows = []
    for seed in args.seeds:
        rows.append({**run_seed(seed, args.data_dir, args.out_dir, args.device),
                     "card": card})
        print("AB_ROW " + json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
