"""The control on the card, at each cell's own size on three seeds: the
reference in TF32 in the program's place, and each planted fault, fail the
cell's limits where the program, and for training the reference against
itself, pass them (a short window each; about a minute a cell). The readings the limits were set from come from
``python -m p2cbench.control`` over a dozen seeds (PERF.md gives them)."""

import json

import pytest

from p2cbench import control
from p2cbench.spec import Bench


@pytest.mark.card
@pytest.mark.parametrize("cell", ["pc-train-b4", "pc-serve-r16", "joint-train-b4",
                                  "joint-serve-r16"])
def test_p2cbench_control_fails_where_program_passes(card, cell, capsys):
    assert control.main(["--workload", cell, "--seeds", "11", "12", "13",
                         "--seconds", "1"]) == 0
    limits = Bench().limits(cell)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(rows) == 3
    for row in rows:
        assert all(row["program"][k] <= v for k, v in limits.items()), row["program"]
        if "reference_repeat" in row:
            assert all(row["reference_repeat"][k] <= v for k, v in limits.items()), row[
                "reference_repeat"]
        assert any(row["control"][k] > v for k, v in limits.items()), row["control"]
        for fault in row["faults"].values():
            assert any(fault[k] > v for k, v in limits.items()), fault
