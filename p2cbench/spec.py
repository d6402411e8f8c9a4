"""What a run is made of, found by name.

``BENCHMARK.json`` at the root lists the cells, configurations and
metrics. Everything that belongs to one of them sits in a file of its
own under this folder, found by its name:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<name>.json``, read by the kind of driver its
  ``kind`` key names (``kinds/<kind>.py``);
- a per-layer metric: ``metrics/<name>.py``, whose ``read(run)`` returns
  the number or None where the run gave it nothing to read;
- a neighbour operation's kernels: ``kernels/<op>.json``;
- a cell's limits on the numbers that decide ``correct``:
  ``limits/<cell>.json`` (the numbers it names are compared; any other
  number the check gives is recorded beside them, not compared).

So a new configuration, mix, metric, kernel mapping or cell adds files and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it leads to; the
    harness's own files are looked up in ``root / <harness folder>``."""

    def __init__(self, root: Path | str | None = None):
        self.root = Path(root) if root is not None else HERE.parent
        self.spec = _read_json(self.root / "BENCHMARK.json")
        self.dir = self.root / HERE.name

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _read_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _read_json(self.dir / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return _read_json(self.dir / "limits" / f"{workload}.json")

    def end_to_end(self, workload: str) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]

    def metric_reader(self, name: str):
        """``read`` of ``metrics/<name>.py``."""
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"p2cbench_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def kernel_maps(self) -> dict[str, dict]:
        """Each neighbour operation's kernel-name patterns and work, by the
        operation's name."""
        return {p.stem: _read_json(p) for p in sorted((self.dir / "kernels").glob("*.json"))}

    def kind(self, name: str):
        """The driver module of a traffic kind."""
        path = self.dir / "kinds" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"p2cbench_kind_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
