"""The frozen FLOP and byte counts against sums worked out by hand."""

import json

import pytest
import torch

from p2cbench.spec import HERE
from p2cbench.work import flops, neighbour

PC = json.loads((HERE / "configs" / "p2c-pc-k8-n8192.json").read_text())
JOINT = json.loads((HERE / "configs" / "p2c-joint-k8-n8192.json").read_text())


def test_p2cbench_backbone_forward_flop():
    # SA1 512*64 rows of 3->64->64->128, SA2 128*64 rows of 131->128->128->256,
    # SA3 128 rows of 259->256->512->1024, FP3 128 rows of 1280->256->256,
    # FP2 512 rows of 384->256->128, FP1 8192 rows of 128->128->128->128,
    # fc1 8192 rows of 128->128, heads 8192 rows of 128->19
    by_hand = (32768 * 12480 + 8192 * 65920 + 128 * 721664 + 128 * 393216
               + 512 * 131072 + 8192 * 49152 + 8192 * 16384 + 8192 * 2432)
    assert flops.backbone_macs(PC) == by_hand
    assert 2 * by_hand / 1e9 == pytest.approx(3.43, abs=0.01)


def test_p2cbench_encoder_and_decoder_macs():
    assert flops.encoder_macs_per_point(JOINT) == 4 * 64 + 64 * 64 + 64 * 64 + 64 * 128 + 128 * 1024
    assert flops.encoder_macs_per_point(JOINT) == 147_712
    # 258->512, 512->512 x2, 512->254, 512->512 x4, 512->1
    assert flops.decoder_macs_per_point(JOINT) == 1_835_520


def test_p2cbench_step_flop():
    fwd = 2.0 * flops.backbone_macs(PC)
    assert flops.train_step_flop(PC, 4) == 3 * fwd * 4
    assert flops.serve_flop(PC, 16) == fwd * 16
    igr = 4 * 2.0 * 1_835_520 * 32 * (2 * 2048 + 256)
    enc = 2.0 * 32 * (147_712 * 2048 + 1024 * 256)
    assert flops.train_step_flop(JOINT, 4) == pytest.approx(3 * fwd * 4 + 4 * enc + igr)


def test_p2cbench_neighbour_bounds():
    b, n = 4, 8192
    idx1 = torch.arange(64).repeat(b, 512, 1).int()  # every query full by point 63
    idx2 = torch.zeros(b, 128, 64, dtype=torch.int32)  # every query short
    stages = [{"n": n, "npoint": 512, "c": 0, "idx": idx1},
              {"n": 512, "npoint": 128, "c": 128, "idx": idx2}]
    nbytes, ops = neighbour.fps(PC, b, stages, True)
    assert ops == 10.0 * b * (512 * n + 128 * 512)
    nbytes, ops = neighbour.ball_query(PC, b, stages, True)
    assert ops == 9.0 * (b * 512 * 64 + b * 128 * 512) + 3.0 * (idx1.numel() + idx2.numel())
    nbytes, ops = neighbour.knn3(PC, b, stages, True)
    assert ops == 9.0 * b * (512 * 128 + n * 512) + 5.0 * b * (512 * 256 + n * 128)
    assert neighbour.neighbour_backward(PC, b, stages, False) == (0.0, 0.0)
    assert neighbour.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
