"""Serving traffic: one client in a closed loop, sending its next request
of decompositions as soon as the last one's answer is on the host.

Set-up makes the weights and a pool of synthetic solids from the seed
(the BN statistics calibrated on solids of their own), exports the
configuration's artifact into ``TMPDIR`` and opens an ``InferenceSession``
on it, then warms the request size the traffic sends (its bucket's eager
first chunk, its capture and a replay). A request
takes ``request_clouds`` clouds of the pool in the order of a seeded
shuffle, as host arrays. Latency is the host clock around ``decompose``;
the rate is the clouds decomposed over the window. A seeded sample of the
finished requests is kept, and judged by the reference once the window has
closed.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from p2cbench import solids, weights
from p2cbench.kinds.common import backbone_config, calibration
from p2cbench.reference import layout, nets
from p2cbench.reference import serve as ref_serve

GEOMETRY = ("axes", "centers", "extents", "scales")


def make_inputs(run) -> None:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    gen = torch.Generator(device=dev).manual_seed(run.subseed("weights"))
    cal = calibration(run)
    run.weights = {"backbone": weights.make(layout.backbone(cfg), gen, dev)}
    nets.calibrate(run.weights["backbone"], nets.backbone, cal["points"], cfg)
    if cfg["sketch_stack"]:
        run.weights["encoder"] = weights.make(layout.encoder(cfg), gen, dev)
        nets.calibrate(run.weights["encoder"], nets.encoder, cal["sketches"])
    run.pool = solids.pool(np.random.SeedSequence([run.seed, 1]), tr["pool_clouds"],
                           cfg["num_points"], cfg["k"], cfg["num_sk_point"],
                           keys=["point_cloud"])["point_cloud"]
    run.order = np.random.default_rng([run.seed, 4])


def open_session(run):
    from point2cyl_torch.serve.export import export_artifact
    from point2cyl_torch.serve.session import InferenceSession

    cfg = run.cfg
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.p2ct")
        export_artifact(path, {k: v.cpu() for k, v in run.weights["backbone"].items()},
                        k=cfg["k"], backbone_config=backbone_config(cfg), buckets=cfg["buckets"],
                        num_sk_points=cfg["num_sk_point"],
                        encoder_state_dict=({k: v.cpu() for k, v in
                                             run.weights["encoder"].items()}
                                            if cfg["sketch_stack"] else None),
                        encoder_latent=cfg.get("latent_size", 256))
        return InferenceSession(path, device=run.device)


def _requests(run):
    """The pool's clouds in seeded shuffles, ``request_clouds`` a request."""
    size = run.traffic["request_clouds"]
    while True:
        perm = run.order.permutation(len(run.pool))
        for i in range(0, len(perm) - size + 1, size):
            yield perm[i:i + size]


def _decompose(run, clouds: np.ndarray) -> dict:
    return run.session.decompose(clouds, include_labels=run.traffic["labels"])


def setup(run) -> None:
    make_inputs(run)
    run.mark("inputs")
    run.session = open_session(run)
    run.mark("session")
    run.request_ids = _requests(run)
    for i in range(run.traffic["warm_requests"]):
        _decompose(run, run.pool[next(run.request_ids)])
        run.mark(f"request{i + 1}")


def window(run, seconds: float) -> None:
    """Requests back to back for ``seconds``; with tracing, a slice of
    ``trace_requests`` a third of the way in, left out of the rate."""
    from p2cbench import trace

    graphs = run.session._graphs[0]
    before = (graphs.eager_calls, graphs.captures)
    keep = run.traffic["check_requests"]
    sample_rng = np.random.default_rng([run.seed, 5])
    run.sample = []  # (request number, clouds, answer), a reservoir
    latencies, failed, traced_s = [], 0, 0.0
    trace_at = seconds / 3 if run.trace else None
    t0 = time.perf_counter()
    while True:
        idx = next(run.request_ids)
        clouds = run.pool[idx]
        start = time.perf_counter()
        out = _decompose(run, clouds)
        now = time.perf_counter()
        latencies.append(now - start)
        if not all(np.isfinite(out[k]).all() for k in GEOMETRY):
            failed += 1
        n = len(latencies)
        if n <= keep:
            run.sample.append((n, idx, out))
        else:
            j = int(sample_rng.integers(0, n))
            if j < keep:
                run.sample[j] = (n, idx, out)
        if trace_at is not None and now - t0 >= trace_at:
            trace_at = None
            t1 = time.perf_counter()
            run.slice = trace.traced(run.traffic["trace_requests"],
                                     lambda i: _decompose(run, run.pool[next(run.request_ids)]))
            traced_s = time.perf_counter() - t1
            run.slice_steps = run.traffic["trace_requests"]
            now = time.perf_counter()
        if now - t0 >= seconds:
            break
    run.elapsed = time.perf_counter() - t0 - traced_s
    clouds = run.traffic["request_clouds"]
    run.attempted, run.failed = len(latencies), failed
    run.units, run.unit_clouds = len(latencies), clouds
    if graphs.enabled and (graphs.eager_calls, graphs.captures) != before:
        raise RuntimeError(f"the window ran a chunk eagerly or captured one: "
                           f"{before} -> {(graphs.eager_calls, graphs.captures)}")
    p95 = float(np.percentile(np.asarray(latencies) * 1e3, 95))
    run.notes["requests"] = len(latencies)
    run.notes["requests_beyond_p95"] = int(sum(1 for v in latencies if v * 1e3 > p95))
    run.notes["request_ms"] = {q: float(np.percentile(np.asarray(latencies) * 1e3, p)) for q, p in
                               (("p10", 10), ("median", 50), ("p90", 90), ("max", 100))}
    run.e2e = {"decomp_per_s": len(latencies) * clouds / run.elapsed,
               "request_p95_ms": p95}


def release(run) -> None:
    run.session = None


def check(run, control: bool = False) -> dict:
    """Each kept request judged by the reference (:func:`reference.serve.
    judge`), the worst of each number over them. With ``control``, the
    reference's own decomposition in TF32 stands in the program's place."""
    cfg = run.cfg
    p = run.weights["backbone"]
    enc = run.weights.get("encoder")
    worst: dict[str, float] = {}
    with torch.no_grad():
        for _, idx, out in run.sample:
            pts = torch.from_numpy(run.pool[idx]).to(run.device)
            if control:
                prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
                try:
                    served = ref_serve.decompose(p, cfg, pts, enc)
                finally:
                    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
            else:
                served = {k: torch.from_numpy(np.asarray(v)).to(run.device)
                          for k, v in out.items()}
            for key, value in ref_serve.judge(p, cfg, pts, served, enc).items():
                value = float("inf") if value != value else value
                worst[key] = max(worst.get(key, value), value)
    return worst
