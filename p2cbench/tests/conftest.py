"""The benchmark's own tests: ``python -m pytest p2cbench/tests -q``.

Tests marked ``card`` need a CUDA device; each decides inside the test
whether one is present and skips here otherwise."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path):
    from p2cbench.tests.tiny import tiny_bench

    return tiny_bench(tmp_path)
