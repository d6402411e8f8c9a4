"""The phase readers (``p2cbench/phases.py`` and the ``step.*``,
``forward.*``, ``session.stage_ms`` and ``session.assemble_ms`` metrics)
on synthetic slices, and on the card the markers a captured step or
served chunk carries into a traced slice."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from p2cbench import phases
from p2cbench.spec import Bench
from p2cbench.trace import Slice
from point2cyl_torch.core.profiling import MARK_PREFIX, PHASES, SPAN_PREFIX

TRAIN_METRICS = {"step.forward_ms.train": "train_forward", "step.loss_ms.train": "train_loss",
                 "step.sketch_ms.train": "train_sketch", "step.igr_ms.train": "train_igr",
                 "step.backward_ms.train": "train_backward",
                 "step.update_ms.train": "train_update"}
SERVE_METRICS = ("forward.backbone_ms.serve", "forward.decomposition_ms.serve",
                 "forward.encoder_ms.serve", "session.stage_ms.serve",
                 "session.assemble_ms.serve")
PC_TRAIN = ("train_forward", "train_loss", "train_backward", "train_update", "end")
JOINT_TRAIN = ("train_forward", "train_loss", "train_sketch", "train_igr", "train_backward",
               "train_update", "end")
PC_SERVE = ("serve_backbone", "serve_decomposition", "serve_pack", "end")
JOINT_SERVE = ("serve_backbone", "serve_decomposition", "serve_encoder", "serve_pack", "end")


def marked(sequence, gaps, steps: int, period: float, names=None) -> list:
    """Device events of ``steps`` steps: each phase's marker (1 us), then
    one kernel filling the phase's ``gaps`` us, a step every ``period``."""
    events = []
    for i in range(steps):
        t = i * period
        for phase, gap in zip(sequence, gaps):
            name = (names or {}).get(phase, MARK_PREFIX + phase)
            events.append((name, t, t + 1.0))
            if gap:
                events.append(("void at::native::reduce_kernel<128, 4>()", t + 1.0, t + gap))
            t += gap
    return events


def reader(name: str):
    return Bench().metric_reader(name)


def run_of(kind: str, device, host=(), steps: int = 2):
    return SimpleNamespace(traffic={"kind": kind}, slice_steps=steps,
                           slice=Slice(device, list(host), (0.0, 1e6), []))


@pytest.mark.parametrize("sequence", [PC_TRAIN, JOINT_TRAIN], ids=["pc", "joint"])
def test_p2cbench_train_phase_arithmetic(sequence):
    """A phase runs from its marker to the next one; the steps' phase
    times sum to their marked span; phases a step lacks read None."""
    gaps = [100.0 * (i + 1) for i in range(len(sequence) - 1)] + [0.0]
    # a suffix on one name, as a demangled kernel name would carry
    device = marked(sequence, gaps, steps=2, period=5000.0,
                    names={"train_loss": MARK_PREFIX + "train_loss()"})
    run = run_of("train", device)
    want = dict(zip(sequence, gaps))
    total = 0.0
    for metric, phase in TRAIN_METRICS.items():
        got = reader(metric)(run)
        if phase in sequence:
            assert got == pytest.approx(want[phase] / 1e3)
            total += got
        else:
            assert got is None
    assert total == pytest.approx(sum(gaps) / 1e3)
    assert all(reader(m)(run) is None for m in SERVE_METRICS)


@pytest.mark.parametrize("sequence", [PC_SERVE, JOINT_SERVE], ids=["pc", "joint"])
def test_p2cbench_serve_phase_arithmetic(sequence):
    gaps = {"serve_backbone": 300.0, "serve_decomposition": 120.0, "serve_encoder": 500.0,
            "serve_pack": 10.0, "end": 0.0}
    host = [("p2c.session.request", 0.0, 900.0),
            ("p2c.session.stage", 10.0, 150.0), ("p2c.session.launch", 150.0, 170.0),
            ("p2c.session.assemble", 850.0, 880.0),
            ("p2c.session.request", 1000.0, 1900.0),
            ("p2c.session.stage", 1010.0, 1090.0), ("p2c.session.assemble", 1850.0, 1870.0)]
    run = run_of("serve", marked(sequence, [gaps[p] for p in sequence], 2, 1000.0), host)
    assert reader("forward.backbone_ms.serve")(run) == pytest.approx(0.3)
    assert reader("forward.decomposition_ms.serve")(run) == pytest.approx(0.13)
    encoder = reader("forward.encoder_ms.serve")(run)
    assert encoder == (pytest.approx(0.5) if "serve_encoder" in sequence else None)
    assert reader("session.stage_ms.serve")(run) == pytest.approx((140.0 + 80.0) / 2 / 1e3)
    assert reader("session.assemble_ms.serve")(run) == pytest.approx(0.025)
    assert all(reader(m)(run) is None for m in TRAIN_METRICS)


def test_p2cbench_a_program_without_markers_or_spans_reads_nothing():
    """The parent of the markers: every phase metric is None, none raises."""
    kernels = [("void at::native::reduce_kernel<128, 4>()", 10.0, 400.0)]
    host = [("cudaGraphLaunch", 0.0, 9.0)]
    for kind, names in (("train", TRAIN_METRICS), ("serve", SERVE_METRICS)):
        run = run_of(kind, kernels, host)
        assert all(reader(m)(run) is None for m in names)
        run.slice = None
        assert all(reader(m)(run) is None for m in names)


def test_p2cbench_marker_and_span_names_stay_out_of_other_readers():
    """No marker matches a neighbour kernel's pattern; the spans are not
    counted as launches and name the idle gaps they hold."""
    for op, kmap in Bench().kernel_maps().items():
        for phase in PHASES:
            assert not any(p in MARK_PREFIX + phase for p in kmap["patterns"]), (op, phase)
    assert not SPAN_PREFIX.startswith("cu")
    host = [("p2c.session.stage", 0.0, 100.0), ("p2c.graphs.replay", 100.0, 120.0),
            ("cudaGraphLaunch", 105.0, 115.0)]
    s = Slice([(MARK_PREFIX + "serve_backbone", 120.0, 121.0), ("gemm", 121.0, 200.0)], host,
              (0.0, 200.0), [(0.0, 200.0)])
    assert s.launches() == 1
    assert s.idle_gaps()[0][0] == "p2c.session.stage"


CARD_PHASES = {"tiny-pc-train": PC_TRAIN, "tiny-joint-train": JOINT_TRAIN,
               "tiny-pc-serve": PC_SERVE, "tiny-joint-serve": JOINT_SERVE}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CARD_PHASES))
def test_p2cbench_replays_carry_each_marker_once_in_order(card, tiny_root, cell):
    """Set up a tiny cell on the card (its graphs captured), trace three
    replayed steps or requests: each marker shows once a replay, in the
    phases' order, and the phases sum to the marked span."""
    from p2cbench import trace
    from p2cbench.run import Run

    bench = Bench(tiny_root)
    run = Run(bench, cell, 2**31 + 11, True, card)
    kind = bench.kind(run.traffic["kind"])
    kind.setup(run)
    if run.traffic["kind"] == "train":
        unit = lambda i: kind._step(run)  # noqa: E731
    else:
        unit = lambda i: kind._decompose(run, run.pool[next(run.request_ids)])  # noqa: E731
    run.slice, run.slice_steps = trace.traced(3, unit), 3
    got = phases.markers(run.slice)
    assert [p for p, _ in got] == list(CARD_PHASES[cell]) * 3
    per = phases.phase_us(run.slice)
    span = sum(b for p, b in got if p == "end") - sum(a for p, a in got if p == got[0][0])
    assert sum(per.values()) == pytest.approx(span)
    assert all(v > 0 for v in per.values())
    kind.release(run)
