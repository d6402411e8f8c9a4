"""Training traffic: a trainer's step back to back on a pool of batches.

Set-up makes the weights and a pool of distinct batches of synthetic
solids on the device from the seed and builds the trainer of the
configuration around them. Two warm-up steps on the pool's last batches
run the step eagerly and capture its graph; the trainer's state and the
generator are then set back in place to where they started, and its first
``check_steps`` steps on the pool's first batches are replays of the graph
the window replays: those are what the reference follows. The window then
calls the step on the next batch in turn until ``seconds`` have passed, at
most two steps ahead of the card, and ends in a synchronise.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from p2cbench import solids, weights
from p2cbench.kinds.common import backbone_config, calibration
from p2cbench.reference import layout, nets
from p2cbench.reference import train as ref_train

LAG = 2  # steps the host may run ahead of the card
WARM_STEPS = 2  # the step's eager first call and its capture
# an element of a leaf takes part in ``change_gap`` where the reference's
# first gradient there is at least this share of the median leaf's RMS
ELEMENT_FLOOR = 1e-3


def _keys(cfg: dict) -> list[str]:
    keys = ["point_cloud", "normals", "extrusion_labels", "base_barrel_labels",
            "extrusion_axes", "extrusion_centers"]
    return keys + (["sketches"] if cfg["sketch_stack"] else [])


def make_inputs(run) -> None:
    """Weights and the pool of batches, from the seed; the frozen encoder's
    BN statistics calibrated on solids of their own."""
    cfg, tr, dev = run.cfg, run.traffic, run.device
    gen = torch.Generator(device=dev).manual_seed(run.subseed("weights"))
    run.weights = {"backbone": weights.make(layout.backbone(cfg), gen, dev)}
    if cfg["sketch_stack"]:
        run.weights["decoder"] = weights.make(layout.decoder(cfg), gen, dev)
        run.weights["encoder"] = weights.make(layout.encoder(cfg), gen, dev)
        run.weights["loaded_encoder"] = weights.make(layout.encoder(cfg), gen, dev)
        nets.calibrate(run.weights["loaded_encoder"], nets.encoder,
                       calibration(run)["sketches"])
    b, count = tr["batch"], tr["pool_batches"]
    host = solids.pool(np.random.SeedSequence([run.seed, 1]), b * count, cfg["num_points"],
                       cfg["k"], cfg["num_sk_point"], keys=_keys(cfg))
    pool = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    run.batches = [{k: v[i * b:(i + 1) * b] for k, v in pool.items()} for i in range(count)]


def build_trainer(run):
    """The program's trainer of the configuration, holding the benchmark's
    weights."""
    from point2cyl_torch.core.config import LossWeights, TrainConfig
    from point2cyl_torch.models.backbone import Backbone

    cfg, dev = run.cfg, run.device
    bcfg = backbone_config(cfg)
    backbone = Backbone(bcfg).to(dev)
    backbone.load_state_dict(run.weights["backbone"], strict=True)
    lw = cfg["loss_weights"]
    tcfg = TrainConfig(batch_size=run.traffic["batch"], learning_rate=cfg["learning_rate"],
                       decay_step=cfg["decay_step"], decay_rate=cfg["decay_rate"],
                       compute_dtype=cfg["compute_dtype"],
                       weights=LossWeights(seg=lw["seg"], normal=lw["normal"],
                                           base_barrel=lw["base_barrel"],
                                           extrusion_axis=lw["extrusion_axis"],
                                           center=lw["center"],
                                           sketch_latent=lw["sketch_latent"],
                                           igr_eikonal=cfg.get("igr_eikonal", 0.1),
                                           igr_normal=cfg.get("igr_normal", 1.0)))
    if not cfg["sketch_stack"]:
        from point2cyl_torch.train.steps import Trainer

        return Trainer(backbone, tcfg)
    from point2cyl_torch.models.implicit import ImplicitNet, PointNetEncoder
    from point2cyl_torch.train.train_joint import JointTrainer, resolve_igr_chunk

    implicit = ImplicitNet(d_in=2 + cfg["latent_size"], hidden=tuple(cfg["decoder_hidden"]),
                           skip_in=tuple(cfg["decoder_skip_in"])).to(dev)
    implicit.load_state_dict(run.weights["decoder"], strict=True)
    nets = []
    for name in ("encoder", "loaded_encoder"):
        enc = PointNetEncoder(cfg["latent_size"], 2, with_normals=True).to(dev)
        enc.load_state_dict(run.weights[name], strict=True)
        nets.append(enc)
    return JointTrainer(backbone, implicit, nets[0], nets[1], tcfg,
                        num_sk_points=cfg["num_sk_point"], is_pc_train=True, is_im_train=True,
                        with_im_loss=True,
                        igr_chunk=resolve_igr_chunk(0, run.traffic["batch"] * cfg["k"]))


def _trained(trainer, cfg: dict) -> dict:
    """The trained parameters by the reference's names (net.name)."""
    nets = {"backbone": trainer.backbone if cfg["sketch_stack"] else trainer.model}
    if cfg["sketch_stack"]:
        nets["encoder"] = trainer.encoder
    return {f"{net}.{n}": p for net, m in nets.items() for n, p in m.named_parameters()}


def setup(run) -> None:
    """Inputs, the trainer, its warm-up, and its first ``check_steps``
    steps as replays, with what the reference needs of them: their losses,
    the first step's gradients (from Adam's first moment after it) and the
    parameters after the last."""
    make_inputs(run)
    run.mark("inputs")
    run.trainer = build_trainer(run)
    run.mark("trainer")
    run.gen = torch.Generator(device=run.device).manual_seed(run.subseed("steps"))
    run.gen_state = run.gen.get_state()
    start = copy.deepcopy(run.trainer.state_dict())
    for i, batch in enumerate(run.batches[-WARM_STEPS:]):
        run.trainer.train_step(batch, run.gen)
        _sync(run)
        run.mark(f"warm{i + 1}")
    run.trainer.load_state_dict(start)
    run.gen.set_state(run.gen_state)
    graphs = run.trainer.graphs
    warm = (graphs.eager_calls, graphs.captures)
    params = _trained(run.trainer, run.cfg)
    losses = []
    for i in range(run.traffic["check_steps"]):
        aux = run.trainer.train_step(run.batches[i], run.gen)
        losses.append(aux["total"])
        _sync(run)
        run.mark(f"step{i + 1}")
        if i == 0:
            # optax's first moment after one update is (1 - b1) g
            state = run.trainer.optimizer.state
            run.first_grads = {n: state[p]["exp_avg"].detach().clone() / (1.0 - ref_train.ADAM_B1)
                               for n, p in params.items()}
    if graphs.enabled and (graphs.eager_calls, graphs.captures) != warm:
        raise RuntimeError(f"the checked steps were not replays: {warm} -> "
                           f"{(graphs.eager_calls, graphs.captures)}")
    run.after = {n: p.detach().clone() for n, p in params.items()}
    run.losses = [float(v) for v in losses]
    run.next_batch = run.traffic["check_steps"]
    run.notes["addresses"] = {"batch0": hex(run.batches[0]["point_cloud"].data_ptr()),
                              "param0": hex(next(iter(params.values())).data_ptr())}
    _sync(run)


def _sync(run) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def _step(run):
    batch = run.batches[run.next_batch % len(run.batches)]
    run.next_batch += 1
    return run.trainer.train_step(batch, run.gen)


def window(run, seconds: float) -> None:
    """Steps back to back for ``seconds``; with tracing, a slice of
    ``trace_steps`` steps a third of the way in, whose time is left out of
    the steps counted for the rate."""
    from p2cbench import trace

    graphs = run.trainer.graphs
    before = (graphs.eager_calls, graphs.captures)
    skipped = torch.zeros((), device=run.device)
    stamps = []  # an event after each step
    steps, traced_s = 0, 0.0
    trace_at = seconds / 3 if run.trace else None
    _sync(run)
    t0 = time.perf_counter()
    while True:
        aux = _step(run)
        skipped += aux["skipped"]
        steps += 1
        if run.device.type == "cuda":
            stamps.append(torch.cuda.Event(enable_timing=True))
            stamps[-1].record()
            if len(stamps) > LAG:
                stamps[-LAG - 1].synchronize()
        now = time.perf_counter()
        if trace_at is not None and now - t0 >= trace_at:
            trace_at = None
            _sync(run)
            t1 = time.perf_counter()
            run.slice = trace.traced(run.traffic["trace_steps"], lambda i: _step(run))
            traced_s = time.perf_counter() - t1
            run.slice_steps = run.traffic["trace_steps"]
        if now - t0 >= seconds:
            break
    _sync(run)
    run.elapsed = time.perf_counter() - t0 - traced_s
    run.attempted, run.failed = steps, int(float(skipped))
    run.units, run.unit_clouds = steps, run.traffic["batch"]
    if graphs.enabled and (graphs.eager_calls, graphs.captures) != before:
        raise RuntimeError(f"the window ran the step eagerly or captured it: "
                           f"{before} -> {(graphs.eager_calls, graphs.captures)}")
    run.e2e = {"train_clouds_per_s": steps * run.traffic["batch"] / run.elapsed}
    if len(stamps) > 2:
        gaps = np.array([a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])])
        run.notes["step_ms"] = {q: float(np.percentile(gaps, p)) for q, p in
                                (("p10", 10), ("median", 50), ("p90", 90), ("max", 100))}


def release(run) -> None:
    run.trainer = None


def check(run, control: bool = False) -> dict:
    """The reference follows the first steps from the same weights, batches
    and generator state; the numbers compared are the first step's loss
    gap, the worst leaf's relative gap of the first gradient's norm, and
    the worst leaf's relative gap of the parameters' change after the last
    step, taken element by element (:func:`compare`). The later steps'
    losses are recorded in ``run.notes`` and not compared. With
    ``control``, the reference in TF32 stands in the program's place."""
    ref_cfg = dict(run.cfg, batch=run.traffic["batch"])
    batches = run.batches[:run.traffic["check_steps"]]
    losses, first, final = ref_train.run_steps(ref_cfg, run.weights, batches, run.gen_state,
                                               run.device)
    if control:
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            p_losses, p_first, p_final = ref_train.run_steps(ref_cfg, run.weights, batches,
                                                             run.gen_state, run.device)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    else:
        p_losses, p_first, p_final = run.losses, run.first_grads, run.after
    numbers, detail = compare(losses, first, final, p_losses, p_first, p_final,
                              _initial(run.weights, final))
    run.notes["check_detail" if not control else "control_detail"] = detail
    return numbers


def _initial(w: dict, final: dict) -> dict:
    return {n: w[n.split(".", 1)[0]][n.split(".", 1)[1]] for n in final}


def compare(losses, first, final, p_losses, p_first, p_final, initial):
    """``loss_gap`` (the first step's), ``grad_gap``, ``change_gap`` and
    ``change_vec_gap`` of a program's (p_*) steps against the reference's,
    and what is recorded beside them.

    ``grad_gap`` and ``change_gap`` compare norms by the worst leaf: the gap
    between the program's norm of a leaf's first gradient, or of its change
    after the last step, and the reference's, over the larger of the
    reference's norm and the median leaf's. Leaves whose reference
    gradient norm is below a thousandth of the median leaf's are rounding
    (a bias before train-mode BN) and are left out. The change is taken
    over the elements whose reference first gradient is at least
    ``ELEMENT_FLOOR`` of the median leaf's RMS: Adam's first updates are
    about ``lr * sign(g)``, so an element whose gradient is rounding moves
    by a full step of either sign, or none where one side's gradient is an
    exact zero. ``change_vec_gap`` is the worst leaf's norm of the
    difference of the changes over those elements, which also sees a
    change of sign, and ``change_vec_median`` the median leaf's, over that
    leaf's own norm of the change. The detail gives the leaf that the norm of the change
    over all elements would pick and how much of its difference lies in
    elements below the floor."""
    gaps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(p_losses, losses)]
    g_norm = {n: float(g.norm()) for n, g in first.items()}
    median = float(np.median(list(g_norm.values())))
    kept = [n for n, v in g_norm.items() if v >= 1e-3 * median]
    ref_norm = {n: g_norm[n] for n in kept}
    grad_gap, grad_leaf = _worst(_norm_gap({n: float(p_first[n].norm()) for n in kept},
                                           ref_norm), ref_norm)
    floor = ELEMENT_FLOOR * float(np.median([float(g.pow(2).mean().sqrt())
                                             for g in first.values()]))
    above = {n: first[n].abs() >= floor for n in kept}
    moved = [n for n in kept if bool(above[n].any())]
    ref_change = {n: float((final[n] - initial[n])[above[n]].norm()) for n in moved}
    change_gap, change_leaf = _worst(_norm_gap(
        {n: float((p_final[n] - initial[n])[above[n]].norm()) for n in moved}, ref_change),
        ref_change)
    vec = {n: float((p_final[n] - final[n])[above[n]].norm()) for n in moved}
    change_vec_gap, vec_leaf = _worst(vec, ref_change)
    change_vec_median = _nanmedian([vec[n] / ref_change[n] if ref_change[n] > 0 else
                                    float("inf") for n in moved])
    ref_all = {n: float((final[n] - initial[n]).norm()) for n in kept}
    all_gap, all_leaf = _worst(_norm_gap({n: float((p_final[n] - initial[n]).norm())
                                          for n in kept}, ref_all), ref_all)
    detail = {"step_loss_gaps": gaps, "grad_worst_leaf": grad_leaf,
              "change_worst_leaf": change_leaf, "change_vec_worst_leaf": vec_leaf,
              "leaves": len(first), "compared": len(kept),
              "elements_below_floor": _share(sum(int((~above[n]).sum()) for n in kept),
                                             sum(above[n].numel() for n in kept)),
              "grad_diff_over_floor": max(float((p_first[n] - first[n]).abs().max())
                                          for n in kept) / max(floor, 1e-30),
              "all_elements_change_gap": all_gap, "all_elements_leaf": all_leaf}
    if all_leaf is not None:
        d2 = (p_final[all_leaf] - final[all_leaf]).pow(2)
        g = first[all_leaf]
        detail["its_difference_below_floor"] = _share(float(d2[g.abs() < floor].sum()),
                                                      float(d2.sum()))
        detail["its_difference_at_zero_gradient"] = _share(float(d2[g == 0].sum()),
                                                           float(d2.sum()))
    return {"loss_gap": _nanmax(gaps[:1]), "grad_gap": grad_gap, "change_gap": change_gap,
            "change_vec_gap": change_vec_gap, "change_vec_median": change_vec_median}, detail


def _share(part: float, whole: float) -> float:
    return part / whole if whole > 0 else 0.0


def _worst(gap: dict, ref: dict):
    """The largest of a leaf's ``gap`` against the larger of that leaf's
    reference norm ``ref`` and the median leaf's, and that leaf."""
    if not ref:
        return float("inf"), None
    median = float(np.median(list(ref.values())))
    rel = {n: gap[n] / max(ref[n], median) for n in ref}
    if any(v != v for v in rel.values()):
        return float("inf"), None
    leaf = max(rel, key=rel.get)
    return rel[leaf], leaf


def _norm_gap(prog: dict, ref: dict) -> dict:
    return {n: abs(prog[n] - ref[n]) for n in ref}


def _nanmedian(values) -> float:
    """The median, or inf where a value is not a number or there is none."""
    values = list(values)
    return float("inf") if not values or any(v != v for v in values) else float(
        np.median(values))


def _nanmax(values) -> float:
    """The largest value, or inf where one is not a number."""
    values = list(values)
    return float("inf") if any(v != v for v in values) else max(values)
