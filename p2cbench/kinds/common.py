"""What the kinds of traffic share in driving the program."""

from __future__ import annotations


def backbone_config(cfg: dict):
    """The program's ``BackboneConfig`` of a configuration's widths, with
    exact neighbour selection, as its trainers build it."""
    from point2cyl_torch.core.config import BackboneConfig

    return BackboneConfig(num_points=cfg["num_points"], sa_npoints=tuple(cfg["sa_npoints"]),
                          sa_radii=tuple(cfg["sa_radii"]), sa_nsamples=tuple(cfg["sa_nsamples"]),
                          sa_mlps=tuple(map(tuple, cfg["sa_mlps"])),
                          sa_global_mlp=tuple(cfg["sa_global_mlp"]),
                          fp_mlps=tuple(map(tuple, cfg["fp_mlps"])), fc_width=cfg["fc_width"],
                          dropout_rate=cfg["dropout_rate"],
                          output_sizes=tuple(cfg["output_sizes"]),
                          compute_dtype=cfg["compute_dtype"], approx_neighbors=False)


CALIBRATION_SOLIDS = 4


def calibration(run) -> dict:
    """Solids of their own from the seed, on which served and frozen
    networks' BN statistics are calibrated: their clouds (B, N, 3) and the
    sketches of their real instances (M, S, 4)."""
    import numpy as np
    import torch

    from p2cbench import solids

    cfg = run.cfg
    host = solids.pool(np.random.SeedSequence([run.seed, 2]), CALIBRATION_SOLIDS,
                       cfg["num_points"], cfg["k"], cfg["num_sk_point"],
                       keys=["point_cloud", "sketches"])
    sk = host["sketches"].reshape(-1, cfg["num_sk_point"], 4)
    sk = sk[np.abs(sk).sum(axis=(1, 2)) > 0]
    return {"points": torch.from_numpy(host["point_cloud"]).to(run.device),
            "sketches": torch.from_numpy(np.ascontiguousarray(sk)).to(run.device)}
