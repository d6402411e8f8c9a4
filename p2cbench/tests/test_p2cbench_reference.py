"""At a small size on the CPU, the frozen reference against the program's
plain path: the same heads from the same weights, the same first training
step, and every served answer judged as the reference's own."""

import numpy as np
import pytest
import torch

from p2cbench import weights
from p2cbench.kinds.common import backbone_config
from p2cbench.reference import layout, nets
from p2cbench.reference import serve as ref_serve
from p2cbench.run import execute
from p2cbench.spec import Bench
from p2cbench.tests.tiny import TINY_JOINT, TINY_PC


def test_p2cbench_reference_backbone_matches_program():
    from point2cyl_torch.models.backbone import Backbone

    g = torch.Generator().manual_seed(0)
    w = weights.make(layout.backbone(TINY_PC), g, "cpu")
    pts = torch.rand(2, TINY_PC["num_points"], 3, generator=g) * 2 - 1
    nets.calibrate(w, nets.backbone, pts, TINY_PC)
    model = Backbone(backbone_config(TINY_PC))
    model.load_state_dict(w, strict=True)
    model.eval()
    with torch.no_grad():
        ours = nets.backbone(w, TINY_PC, pts)
        theirs = model(pts)
    for a, b in zip(ours, theirs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_p2cbench_reference_encoder_matches_program():
    from point2cyl_torch.models.implicit import PointNetEncoder

    g = torch.Generator().manual_seed(1)
    w = weights.make(layout.encoder(TINY_JOINT), g, "cpu")
    sk = torch.rand(6, 32, 4, generator=g)
    nets.calibrate(w, nets.encoder, sk)
    enc = PointNetEncoder(TINY_JOINT["latent_size"], 2, with_normals=True)
    enc.load_state_dict(w, strict=True)
    with torch.no_grad():
        torch.testing.assert_close(nets.encoder(w, sk), enc.eval()(sk), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", ["tiny-pc-train", "tiny-joint-train", "tiny-pc-serve",
                                  "tiny-joint-serve"])
def test_p2cbench_run_on_cpu_is_correct(tiny_root, cell):
    result = execute(Bench(tiny_root), cell, 2**31 + 11, 0.3, False, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    checks = result["checks"]
    assert list(result)[-1] == "checks"
    if "grad_gap" in checks:
        # the first step agrees to rounding: later steps part by Adam's
        # near-sign updates of the elements whose gradient is rounding
        assert checks["grad_gap"]["value"] < 1e-5
    else:
        assert checks["label_gap"]["value"] == 0.0
        assert checks["center_err"]["value"] < 1e-6


def test_p2cbench_served_decomposition_judged_exactly():
    g = torch.Generator().manual_seed(2)
    w = weights.make(layout.backbone(TINY_PC), g, "cpu")
    pts = torch.rand(3, TINY_PC["num_points"], 3, generator=g) * 2 - 1
    nets.calibrate(w, nets.backbone, pts, TINY_PC)
    with torch.no_grad():
        own = ref_serve.decompose(w, TINY_PC, pts)
        judged = ref_serve.judge(w, TINY_PC, pts, own)
    assert judged["label_gap"] == 0.0 and judged["found_diff"] == 0.0
    assert max(judged["center_err"], judged["extent_err"], judged["scale_err"]) == 0.0
    assert np.isfinite(judged["axis_gap"]) and judged["axis_gap"] < 1e-6
