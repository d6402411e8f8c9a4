"""A run with the timed path broken underneath comes out not correct: the
program driven on the CPU at a small size with each fault a cell can have
planted in it (one process, one card: there is no exchange between chips
to leave out), and on the card, at each cell's own size, with a fault
planted only where a captured graph is replayed (graphs are off on the
CPU)."""

import numpy as np
import pytest
import torch

from p2cbench.run import execute
from p2cbench.spec import Bench


def _unchanged_step(monkeypatch):
    import point2cyl_torch.train.steps as steps

    monkeypatch.setattr(steps, "adam_select", lambda *a, **k: None)


def _half_batch_step(monkeypatch, trainer_cls):
    real = trainer_cls.train_step

    def train_step(self, batch, generator):
        return real(self, {k: v[:len(v) // 2] for k, v in batch.items()}, generator)

    monkeypatch.setattr(trainer_cls, "train_step", train_step)


def _altered_loss(monkeypatch, trainer_cls):
    real = trainer_cls.train_step

    def train_step(self, batch, generator):
        out = real(self, batch, generator)
        return dict(out, total=out["total"] * 1.5)

    monkeypatch.setattr(trainer_cls, "train_step", train_step)


def _serve_fault(monkeypatch, fault):
    from point2cyl_torch.serve.session import InferenceSession

    real = InferenceSession.decompose
    last = {}

    def decompose(self, points, **kw):
        out = real(self, points, **kw)
        if fault == "altered":
            out["labels"] = out["labels"].copy()
            out["labels"][0, 0] = (out["labels"][0, 0] + 1) % out["axes"].shape[1]
        elif fault == "half_batch":
            cut = len(points) // 2
            out = {k: np.concatenate([v[:cut], np.zeros_like(v[cut:])]) for k, v in out.items()}
        elif fault == "stale":
            out, last["out"] = last.get("out", out), out
        return out

    monkeypatch.setattr(InferenceSession, "decompose", decompose)


def _replay_fault(monkeypatch, fault):
    """A fault in every replay of a captured graph and nowhere else:
    ``stale`` leaves the static inputs as they were (the previous call's),
    ``half_batch`` hands the graph the first half of the rows twice, so the
    mean is taken over that half."""
    from point2cyl_torch.core.graphs import StepGraphs

    real = StepGraphs._replay

    def _replay(self, entry, inputs, generator):
        if fault == "stale":
            inputs = entry.inputs
        else:
            half = {k: len(v) // 2 for k, v in inputs.items()}
            inputs = {k: torch.cat([v[:half[k]], v[:half[k]], v[2 * half[k]:]])
                      for k, v in inputs.items()}
        return real(self, entry, inputs, generator)

    monkeypatch.setattr(StepGraphs, "_replay", _replay)


@pytest.mark.parametrize("stack", ["pc", "joint"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_p2cbench_train_fault_is_caught(tiny_root, monkeypatch, stack, fault):
    from point2cyl_torch.train.steps import Trainer
    from point2cyl_torch.train.train_joint import JointTrainer

    cls = Trainer if stack == "pc" else JointTrainer
    if fault == "unchanged":
        if stack == "joint":
            import point2cyl_torch.train.train_joint as joint

            monkeypatch.setattr(joint.steps, "adam_select", lambda *a, **k: None)
        else:
            _unchanged_step(monkeypatch)
    elif fault == "half_batch":
        _half_batch_step(monkeypatch, cls)
    else:
        _altered_loss(monkeypatch, cls)
    result = execute(Bench(tiny_root), f"tiny-{stack}-train", 5, 0.2, False,
                     torch.device("cpu"))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("stack", ["pc", "joint"])
@pytest.mark.parametrize("fault", ["altered", "half_batch", "stale"])
def test_p2cbench_serve_fault_is_caught(tiny_root, monkeypatch, stack, fault):
    _serve_fault(monkeypatch, fault)
    result = execute(Bench(tiny_root), f"tiny-{stack}-serve", 6, 0.3, False,
                     torch.device("cpu"))
    assert not result["correct"], result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["pc-train-b4", "pc-serve-r16", "joint-train-b4",
                                  "joint-serve-r16"])
@pytest.mark.parametrize("fault", ["stale", "half_batch"])
def test_p2cbench_replay_fault_is_caught(card, monkeypatch, cell, fault):
    _replay_fault(monkeypatch, fault)
    result = execute(Bench(), cell, 21, 1.0, False, card)
    assert not result["correct"], result["checks"]
