"""The readings that the limits of ``correct`` are set from, on the card.

    python -m p2cbench.control --workload pc-train-b4 --seeds 1 2 3 --seconds 2

For each seed, in one process: the cell's set-up and a short window of
its traffic, then the numbers its check compares for

- ``program``: the program, as a run compares them (the lower reading is
  the largest over a dozen seeds or more);
- ``control``: the reference computed with TF32 products standing in the
  program's place (float32 with TF32 off is what the configurations
  state), which has to fail one of the cell's numbers;
- faults planted in the reference put in the program's place, each of
  which has to fail one: a training step over half the batch, the mean
  taken over the rest (``half_batch``); a served answer altered where it
  is produced (``altered``: one point's label set to its worst column),
  half of a request's answers left out (``half_batch``), and a request
  answered with the previous request's answer (``stale``). A training
  step that leaves the state unchanged reads 1 in ``grad_gap``,
  ``change_gap`` and ``change_vec_gap`` by their measure and needs no run;
- for training, ``reference_repeat``: the reference run again with
  PyTorch's deterministic algorithms in the program's place, whose
  reductions (the gathers' backward above all) add in another order: the
  spread of the reference against itself.

One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings

import numpy as np
import torch

from p2cbench.reference import serve as ref_serve
from p2cbench.reference import train as ref_train
from p2cbench.run import Run
from p2cbench.spec import Bench


def train_faults(run, kind) -> dict:
    ref_cfg = dict(run.cfg, batch=run.traffic["batch"])
    steps = run.traffic["check_steps"]
    batches = run.batches[:steps]
    losses, first, final = ref_train.run_steps(ref_cfg, run.weights, batches, run.gen_state,
                                               run.device)
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    h_losses, h_first, h_final = ref_train.run_steps(dict(ref_cfg, batch=ref_cfg["batch"] // 2),
                                                     run.weights, half, run.gen_state,
                                                     run.device)
    initial = kind._initial(run.weights, final)
    numbers, detail = kind.compare(losses, first, final, h_losses, h_first, h_final, initial)
    return {"half_batch": dict(numbers, detail=detail)}


def reference_repeat(run, kind) -> dict:
    """The reference against itself, the second run with deterministic
    algorithms (another order of its reductions)."""
    ref_cfg = dict(run.cfg, batch=run.traffic["batch"])
    batches = run.batches[:run.traffic["check_steps"]]
    losses, first, final = ref_train.run_steps(ref_cfg, run.weights, batches, run.gen_state,
                                               run.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            r_losses, r_first, r_final = ref_train.run_steps(ref_cfg, run.weights, batches,
                                                             run.gen_state, run.device)
        finally:
            torch.use_deterministic_algorithms(False)
    identical = all(torch.equal(first[n], r_first[n]) for n in first)
    numbers, detail = kind.compare(losses, first, final, r_losses, r_first, r_final,
                                   kind._initial(run.weights, final))
    return dict(numbers, detail=dict(detail, first_gradients_identical=identical))


def serve_faults(run, kind) -> dict:
    cfg, p, enc = run.cfg, run.weights["backbone"], run.weights.get("encoder")
    rng = np.random.default_rng([run.seed, 9])
    out: dict[str, dict] = {}

    def judged(name, pts, served):
        for key, value in ref_serve.judge(p, cfg, pts, served, enc).items():
            value = float("inf") if value != value else value
            out.setdefault(name, {})
            out[name][key] = max(out[name].get(key, value), value)

    with torch.no_grad():
        previous = None
        for _, idx, answer in run.sample:
            pts = torch.from_numpy(run.pool[idx]).to(run.device)
            served = {k: torch.from_numpy(np.asarray(v)).to(run.device)
                      for k, v in answer.items()}
            # one point's label set to the column the reference scores lowest
            h = ref_serve.soft_outputs(p, cfg, pts)
            b, n = int(rng.integers(0, pts.shape[0])), int(rng.integers(0, pts.shape[1]))
            altered = dict(served, labels=served["labels"].clone())
            altered["labels"][b, n] = int(torch.argmin(h["w"][b, n]))
            judged("altered", pts, altered)
            cut = pts.shape[0] // 2
            half = {k: torch.cat([v[:cut], torch.zeros_like(v[cut:])]) for k, v in served.items()}
            judged("half_batch", pts, half)
            if previous is not None:
                judged("stale", pts, previous)
            previous = served
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("p2cbench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = Bench()
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = Run(bench, args.workload, seed, False, device)
        kind = bench.kind(run.traffic["kind"])
        kind.setup(run)
        kind.window(run, args.seconds)
        kind.release(run)
        row = {"workload": args.workload, "seed": seed, "program": kind.check(run),
               "control": kind.check(run, control=True)}
        row["notes"] = {k: v for k, v in run.notes.items() if k.endswith("detail")}
        train = run.traffic["kind"] == "train"
        row["faults"] = (train_faults if train else serve_faults)(run, kind)
        if train:
            row["reference_repeat"] = reference_repeat(run, kind)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
