"""Without a card the run fails and prints no result; it does not fall
back to the CPU."""

import shutil
import subprocess
import sys

import pytest

from p2cbench import run
from p2cbench.spec import HERE


def test_p2cbench_run_without_card_fails(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "pc-train-b4", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_p2cbench_harness_alone_fails(tmp_path):
    """A checkout of only BENCHMARK.json and the harness cannot run a cell."""
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "p2cbench.run", "--workload", "pc-serve-r16",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout == ""
