"""One run of one cell of the benchmark of ``point2cyl_torch`` on the card.

    python -m p2cbench.run --workload pc-train-b4 --seed 7 --seconds 10 --trace 0

Set-up (counted in ``setup_s`` from the process's start: imports, the
kernels' build or load, inputs and weights from the seed, the warm-up
that captures every graph the cell's traffic uses), then the window of
``--seconds``, then the reference's check of what the window's path
produced. The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a traced slice of the window. The numbers the
check compared, each beside its limit, close standard error and the JSON
line (``checks``). Without a card, or with fewer than the cell asks for,
the run fails and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "point2cyl_tpu")


class Run:
    """One run's settings and what its stages leave for the next ones and
    for the metric readers."""

    def __init__(self, bench, workload: str, seed: int, trace: bool, device):
        self.bench = bench
        self.workload = bench.workload(workload)
        self.cfg = bench.config(self.workload["config"])
        self.traffic = bench.traffic(self.workload["traffic"])
        self.seed = int(seed)
        self.trace = trace
        self.device = device
        self.slice = None
        self.notes: dict = {"setup_marks": {}}

    def mark(self, stage: str) -> None:
        """Record the seconds since the process started at the end of a
        set-up stage."""
        self.notes["setup_marks"][stage] = round(time.perf_counter() - T0, 3)

    def subseed(self, stream: str) -> int:
        """A 63-bit seed of one stream of draws, a function of the seed."""
        tag = int.from_bytes(stream.encode()[:8], "little")
        return int(np.random.SeedSequence([self.seed, tag]).generate_state(1, np.uint64)[0]
                   >> np.uint64(1))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def execute(bench, workload: str, seed: int, seconds: float, trace: bool, device,
            t0: float = T0) -> dict:
    """Set up, measure and check one run; returns the result's fields."""
    import torch

    run = Run(bench, workload, seed, trace, device)
    run.mark("imports")
    kind = bench.kind(run.traffic["kind"])
    kind.setup(run)
    setup_s = time.perf_counter() - t0
    kind.window(run, seconds)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package is loaded: {', '.join(found)}")
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        run.notes["card_after_window"] = card_note()
    if trace:
        metrics = {}
        for m in bench.per_layer(workload):
            value = bench.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(workload)}
    kind.release(run)
    if on_card:
        torch.cuda.empty_cache()
    numbers = kind.check(run)
    limits = bench.limits(workload)
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v} for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    run.notes["not_compared"] = {k: v for k, v in numbers.items() if k not in limits}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": run.workload["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace and run.slice is not None:
        dev["busy_s"] = run.slice.busy_us / 1e6
        dev["window_s"] = run.slice.window_us / 1e6
        result["breakdown"] = {"device_ops": run.slice.top_device_ops(),
                               "idle_gaps": run.slice.idle_gaps()}
    result["notes"] = dict(run.notes, setup_s=setup_s, window_s=run.elapsed,
                           units=run.units, seed=seed)
    result["checks"] = checks
    return result


CARD_QUERY = "name,power.limit,clocks.sm,clocks.mem,temperature.gpu,power.draw"


def card_note() -> str:
    """The card's name, power limit, clocks, temperature and draw now, as
    ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={CARD_QUERY}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not math.isfinite(args.seconds) or args.seconds <= 0:
        p.error("--seconds must be positive")

    from p2cbench.spec import Bench

    bench = Bench()
    chips = bench.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"p2cbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    card = card_note()
    print(f"p2cbench: {card}", file=sys.stderr, flush=True)
    result = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    result["notes"]["card_at_start"] = card
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
