"""Training logs: ``log.txt`` in the logdir and stdout, plus tensorboard
scalars when asked for (the port of the JAX ``core/logging.py``;
reference ``train_Point2Cyl_without_sketch.py:137-140, 386-391``).

Tensorboard is opt-in: asked for and not installed, it raises.
"""

from __future__ import annotations

import os
from collections import defaultdict


class TrainLogger:
    def __init__(self, logdir: str, use_tensorboard: bool = False):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._fout = open(os.path.join(logdir, "log.txt"), "a")
        self.scalars: dict[str, list[float]] = defaultdict(list)
        self._tb = None
        if use_tensorboard:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(logdir, "tb"))

    def log(self, msg: str) -> None:
        self._fout.write(msg + "\n")
        self._fout.flush()
        print(msg, flush=True)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.scalars[tag].append(float(value))
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def epoch_means(self) -> dict[str, float]:
        means = {k: sum(v) / max(len(v), 1) for k, v in self.scalars.items()}
        self.scalars.clear()
        return means

    def close(self) -> None:
        self._fout.close()
        if self._tb is not None:
            self._tb.close()
