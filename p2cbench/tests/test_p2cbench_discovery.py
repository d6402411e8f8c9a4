"""A configuration, a traffic mix, a per-layer metric and a kernel mapping
added as new files in a copy of the benchmark are found by name, and the
new cell runs, with no edit to any file the benchmark had."""

import json

import torch

from p2cbench.run import execute
from p2cbench.spec import Bench
from p2cbench.tests.tiny import TINY_PC


def test_p2cbench_new_files_are_found(tiny_root):
    d = tiny_root / "p2cbench"
    before = {p: p.read_bytes() for p in d.rglob("*") if p.is_file()}
    (d / "configs" / "dummy-cfg.json").write_text(json.dumps(dict(TINY_PC, name="dummy-cfg", k=3,
                                                                  output_sizes=[3, 6])))
    (d / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"kind": "serve", "request_clouds": 3,
         "pool_clouds": 6, "labels": True, "warm_requests": 1, "check_requests": 2,
         "trace_requests": 2}))
    (d / "limits" / "dummy-cell.json").write_text(json.dumps(
        {"label_gap": 1e-4, "bb_gap": 1e-4, "axis_gap": 1e-4, "center_err": 1e-5,
         "extent_err": 1e-5, "scale_err": 1e-5, "found_diff": 0.0}))
    (d / "metrics" / "dummy.metric.py").write_text("def read(run):\n    return 42.0\n")
    (d / "kernels" / "dummy_op.json").write_text(json.dumps(
        {"op": "dummy", "patterns": ["dummy_kernel"], "work": "fps"}))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy-cfg", "source": "https://example.org",
                            "file": "p2cbench/configs/dummy-cfg.json", "reduced": [],
                            "why": "dummy"})
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy-cfg",
                              "traffic": "dummy-mix", "chips": 1, "why": "dummy"})
    for m in spec["end_to_end"]:
        if m["name"] in ("decomp_per_s", "request_p95_ms"):
            m["workloads"].append("dummy-cell")
    spec["per_layer"].append({"name": "dummy.metric", "unit": "%", "better": "higher",
                              "source": "host_clock", "layer": "dummy",
                              "moves": "decomp_per_s", "workloads": ["dummy-cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(tiny_root)
    assert bench.config("dummy-cfg")["k"] == 3
    assert bench.traffic("dummy-mix")["request_clouds"] == 3
    assert "dummy.metric" in [m["name"] for m in bench.per_layer("dummy-cell")]
    assert bench.metric_reader("dummy.metric")(None) == 42.0
    assert bench.kernel_maps()["dummy_op"]["patterns"] == ["dummy_kernel"]
    result = execute(bench, "dummy-cell", 3, 0.3, False, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"decomp_per_s", "request_p95_ms", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} changed"
