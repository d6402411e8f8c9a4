"""The port's tracing (point2cyl_torch/core/profiling.py) on the CPU: host
spans under ``torch.profiler`` and the no-op without one, the phase
markers' table against ``csrc/marks.cu``, where each step body and the
serving forward start their phases, and the session's spans around a
request. The markers' kernels run only on the card
(``p2cbench/tests/test_p2cbench_phases.py``'s ``card`` test)."""

from __future__ import annotations

import dataclasses
import re

import pytest
import torch

import test_torch_joint as TJT
from point2cyl_torch.core import profiling
from point2cyl_torch.core.config import BackboneConfig as TorchConfig
from point2cyl_torch.core.config import TrainConfig as TorchTrainConfig
from point2cyl_torch.core.graphs import StepGraphs
from point2cyl_torch.models.backbone import Backbone as TorchBackbone
from point2cyl_torch.models.implicit import ImplicitNet, PointNetEncoder
from point2cyl_torch.ops import _build
from point2cyl_torch.serve import export as torch_export
from point2cyl_torch.serve.session import InferenceSession
from point2cyl_torch.train import steps as tsteps
from point2cyl_torch.train import train_joint as TJ
from test_torch_backbone import K as SERVE_K
from test_torch_backbone import clouds
from test_torch_backbone import torch_config as serve_config
from test_torch_train import LOSS_FLAGS, backbone_config, numpy_batch, torch_config

SK = 32
CPU = [torch.profiler.ProfilerActivity.CPU]


def p2c_events(prof) -> list[tuple[str, float, float]]:
    """(name, start, end) of every ``p2c.`` host range, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(profiling.SPAN_PREFIX)), key=lambda e: e[1])


def within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    """No profiler: every span is one shared no-op and no range opens."""
    def refuse(*args, **kwargs):
        raise AssertionError("a range opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = profiling.span("session.stage")
    assert first is profiling.span("session.request") is profiling._NO_SPAN
    with first:
        torch.ones(2).sum()


def test_spans_nest_under_the_profiler():
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(8).sum()
            with profiling.span("inner"):
                torch.ones(8).sum()
    events = p2c_events(prof)
    assert [e[0] for e in events] == ["p2c.outer", "p2c.inner", "p2c.inner"]
    assert within(events[1], events[0]) and within(events[2], events[0])
    assert events[1][2] <= events[2][1]
    assert profiling.span("inner") is profiling._NO_SPAN


@pytest.mark.parametrize("phase", profiling.PHASES)
def test_mark_on_cpu_launches_nothing(phase, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU marker reached the kernels' library")

    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    profiling.mark(phase, torch.zeros(3))


def test_mark_refuses_an_unknown_phase():
    with pytest.raises(ValueError, match="unknown phase"):
        profiling.mark("train_everything", torch.zeros(1))


def test_phases_agree_with_the_marker_kernels():
    """``PHASES`` in order is ``csrc/marks.cu``'s table, and each has its
    empty ``extern "C"`` kernel named ``p2c_mark_<phase>``."""
    text = (_build.CSRC / "marks.cu").read_text()
    defined = re.findall(r"__global__ void p2c_mark_(\w+)\(\) \{\}", text)
    table = re.search(r"kMarks\[\] = \{(.*?)\};", text, re.S).group(1)
    assert re.findall(r"p2c_mark_(\w+)", table) == list(profiling.PHASES)
    assert defined == list(profiling.PHASES)
    assert len(set(profiling.PHASES)) == len(profiling.PHASES)


def recorded_marks(monkeypatch, module) -> list[str]:
    """The phases ``module``'s ``mark`` is called with, in order."""
    seen: list[str] = []

    def record(phase, like):
        assert phase in profiling.PHASES and isinstance(like, torch.Tensor)
        seen.append(phase)

    monkeypatch.setattr(module, "mark", record)
    return seen


def test_trainer_step_marks_its_phases_in_order(monkeypatch):
    model = TorchBackbone(torch_config(backbone_config(4, 96)))
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = tsteps.Trainer(model, TorchTrainConfig(batch_size=2, **LOSS_FLAGS))
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(1, 2, 4, 96).items()}
    seen = recorded_marks(monkeypatch, tsteps)
    trainer.train_step(batch, torch.Generator().manual_seed(1))
    assert seen == ["train_forward", "train_loss", "train_backward", "train_update", "end"]


def test_joint_step_marks_its_phases_in_order(monkeypatch):
    torch.manual_seed(0)
    backbone = TorchBackbone(TorchConfig.from_dict(dataclasses.asdict(TJT.CFG)))
    nets = (backbone, ImplicitNet(**TJT.DECODER), PointNetEncoder(TJT.L, 2, True),
            PointNetEncoder(TJT.L, 2, True))
    trainer = TJ.JointTrainer(*nets, TorchTrainConfig(batch_size=TJT.B, **TJT.LOSS_FLAGS),
                              num_sk_points=TJT.S, is_pc_train=True, is_im_train=True,
                              with_im_loss=True)
    batch = {k: torch.from_numpy(v) for k, v in TJT.numpy_batch(False).items()}
    seen = recorded_marks(monkeypatch, TJ)
    trainer.train_step(batch, torch.Generator().manual_seed(2))
    assert seen == ["train_forward", "train_loss", "train_sketch", "train_igr",
                    "train_backward", "train_update", "end"]


@pytest.mark.parametrize("with_encoder", [False, True])
def test_serving_forward_marks_its_phases_in_order(with_encoder, monkeypatch):
    model = TorchBackbone(serve_config()).eval()
    encoder = PointNetEncoder(16, 2, True).eval() if with_encoder else None
    seen = recorded_marks(monkeypatch, torch_export)
    with torch.inference_mode():
        torch_export._backbone_forward(model, torch.from_numpy(clouds(3, 2)), k=SERVE_K,
                                       num_sk_points=SK, encoder=encoder)
    assert seen == (["serve_backbone", "serve_decomposition"]
                    + (["serve_encoder"] if with_encoder else []) + ["serve_pack", "end"])


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A CPU session over fresh weights, buckets 2 and 4."""
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("profiling") / "m.p2ct")
    torch_export.export_artifact(path, TorchBackbone(serve_config()).state_dict(),
                                 k=SERVE_K, backbone_config=serve_config(), buckets=(2, 4),
                                 num_sk_points=SK)
    return InferenceSession(path, device="cpu")


@pytest.mark.parametrize("sizes", [(1,), (3, 5)])
def test_decompose_spans_each_request(session, sizes):
    """One ``p2c.session.request`` a request, holding a stage, launch and
    fetch a chunk (5 clouds: chunks of 4 and 2), then the wait and the
    assembly; each launch holds the step's eager path."""
    with torch.profiler.profile(activities=CPU) as prof:
        for n in sizes:
            out = session.decompose(clouds(40 + n, n))
            assert out["axes"].shape == (n, SERVE_K, 3)
    events = p2c_events(prof)
    requests = [e for e in events if e[0] == "p2c.session.request"]
    assert len(requests) == len(sizes)
    assert all(a[2] <= b[1] for a, b in zip(requests, requests[1:]))
    for n, req in zip(sizes, requests):
        inside = [e for e in events if e is not req and within(e, req)]
        names = [e[0] for e in inside if e[0].startswith("p2c.session.")]
        chunks = -(-n // 4)
        assert names == (["p2c.session.stage", "p2c.session.launch",
                          "p2c.session.fetch"] * chunks
                         + ["p2c.session.wait", "p2c.session.assemble"])
        launches = [e for e in inside if e[0] == "p2c.session.launch"]
        eager = [e for e in inside if e[0] == "p2c.graphs.eager"]
        assert len(eager) == chunks and all(within(g, s) for g, s in zip(eager, launches))


def test_step_graphs_names_the_path_taken():
    graphs = StepGraphs("cpu")
    with torch.profiler.profile(activities=CPU) as prof:
        graphs(lambda inputs, gen: inputs["x"] * 2, {"x": torch.ones(3)})
    assert [e[0] for e in p2c_events(prof)] == ["p2c.graphs.eager"]


def test_kernel_library_load_is_a_build_span(monkeypatch, tmp_path):
    """The build or load of the kernels' library opens ``p2c.build``."""
    lib = tmp_path / "libp2c_kernels_test.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_library_path", lambda inputs: lib)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))
    with torch.profiler.profile(activities=CPU) as prof:
        assert _build.library() == ("loaded", str(lib))
    assert [e[0] for e in p2c_events(prof)] == ["p2c.build"]

