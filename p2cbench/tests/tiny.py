"""A copy of the benchmark with tiny configurations and traffic, for runs on
the CPU in tests: the published widths of the sketch encoder (the program
fixes them), everything else cut down."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from p2cbench.spec import HERE

TINY_PC = {
    "name": "tiny-pc", "source": "https://github.com/mikacuy/point2cyl", "model": "tiny",
    "sketch_stack": False, "num_points": 256, "k": 4, "sa_npoints": [64, 16],
    "sa_radii": [0.3, 0.6], "sa_nsamples": [16, 8], "sa_mlps": [[8, 8, 16], [16, 16, 32]],
    "sa_global_mlp": [32, 32, 64], "fp_mlps": [[32, 32], [32, 16], [16, 16, 16]],
    "fc_width": 16, "dropout_rate": 0.5, "output_sizes": [3, 8], "compute_dtype": "float32",
    "num_sk_point": 32, "buckets": [1, 4], "learning_rate": 0.001, "decay_step": 200000,
    "decay_rate": 0.7,
    "loss_weights": {"seg": 1.0, "normal": 1.0, "base_barrel": 1.0, "extrusion_axis": 1.0,
                     "center": 1.0, "sketch_latent": 1.0},
    "reduced": [], "assumed": {},
}
TINY_JOINT = dict(TINY_PC, name="tiny-joint", sketch_stack=True, latent_size=16,
                  encoder_in=4, encoder_widths=[64, 64, 64, 128, 1024],
                  decoder_hidden=[32, 32, 32, 32], decoder_skip_in=[2], igr_eikonal=0.1,
                  igr_normal=1.0)
TRAFFIC = {
    "tiny-train": {"kind": "train", "batch": 2, "pool_batches": 4, "check_steps": 3,
                   "trace_steps": 2},
    "tiny-serve": {"kind": "serve", "request_clouds": 4,
                   "pool_clouds": 8, "labels": True, "warm_requests": 1,
                   "check_requests": 2, "trace_requests": 2},
}
CELLS = {"tiny-pc-train": ("tiny-pc", "tiny-train"), "tiny-pc-serve": ("tiny-pc", "tiny-serve"),
         "tiny-joint-train": ("tiny-joint", "tiny-train"),
         "tiny-joint-serve": ("tiny-joint", "tiny-serve")}
# at these sizes a few elements of a leaf decide its norm, and Adam's
# near-sign updates of the elements whose gradient is rounding part the
# trajectories after the first step: the later steps' limits are loose
LOOSE = {"train": {"loss_gap": 0.05, "grad_gap": 1e-4, "change_gap": 0.5},
         "serve": {"label_gap": 1e-3, "bb_gap": 1e-3, "axis_gap": 1e-3, "center_err": 1e-4,
                   "extent_err": 1e-4, "scale_err": 1e-4, "found_diff": 0.0,
                   "latent_err": 1e-3}}


def tiny_bench(root: Path) -> Path:
    """A benchmark root under ``root``: this harness's files, the tiny
    configurations, mixes and limits, and a BENCHMARK.json of the tiny
    cells with the real one's metrics."""
    shutil.copytree(HERE, root / HERE.name, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    d = root / HERE.name
    spec["configs"] = []
    for cfg in (TINY_PC, TINY_JOINT):
        (d / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                "file": f"{HERE.name}/configs/{cfg['name']}.json",
                                "reduced": [], "why": "tiny"})
    for name, mix in TRAFFIC.items():
        (d / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    spec["workloads"] = []
    for cell, (cfg, mix) in CELLS.items():
        spec["workloads"].append({"name": cell, "config": cfg, "traffic": mix, "chips": 1,
                                  "why": "tiny"})
        limits = dict(LOOSE[TRAFFIC[mix]["kind"]])
        if not cfg.endswith("joint"):
            limits.pop("latent_err", None)
        (d / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    kinds = {c: TRAFFIC[m]["kind"] for c, (_, m) in CELLS.items()}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = "train" if m["name"].endswith("train") or "train_" in m["name"] else "serve"
            m["workloads"] = [c for c, k in kinds.items() if k == kind]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
