"""The port's exact assignment for K > 8 (point2cyl_torch/ops/lap.py and
``hungarian_matching`` past K=8) and its profiling utilities
(point2cyl_torch/core/profiling.py) against the JAX package's, on the
CPU.

The solver must pick JAX's columns, not merely an optimum: real
relaxed-IoU costs tie all the time (rows past a sample's instance count
are zero, a dead segment is a zero column), so the costs here include
integer costs in {0, 1, 2} and zero rows and columns. scipy's
``linear_sum_assignment`` gives the optimum each must reach.
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from point2cyl_torch.core import profiling as tprof
from point2cyl_torch.ops.lap import solve_lap_max, solve_lap_min
from point2cyl_torch.ops.matching import hungarian_matching as torch_matching
from point2cyl_tpu.core import profiling as jprof
from point2cyl_tpu.ops import lap as jlap
from point2cyl_tpu.ops.matching import hungarian_matching as jax_matching

jax_min = jax.jit(jlap.solve_lap_min)


def costs(kind: str, b: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((b, k, k)).astype(np.float32)
    if kind == "integer":
        return rng.integers(0, 3, (b, k, k)).astype(np.float32)
    c = rng.uniform(size=(b, k, k)).astype(np.float32)  # zero rows and columns
    for i in range(b):
        c[i, rng.integers(1, k):] = 0.0
        c[i, :, rng.choice(k, size=k // 3, replace=False)] = 0.0
    return c


def assert_optimal(cost: np.ndarray, cols: np.ndarray, maximize: bool = False) -> None:
    for c, col in zip(cost, cols):
        assert sorted(col.tolist()) == list(range(len(col)))  # a permutation
        rows, want = linear_sum_assignment(c, maximize=maximize)
        got = c[np.arange(len(col)), col].sum(dtype=np.float64)
        assert abs(got - c[rows, want].sum(dtype=np.float64)) <= 1e-4 * len(col)


@pytest.mark.parametrize("kind", ["random", "integer", "zeros"])
@pytest.mark.parametrize("k", [2, 5, 9, 12, 16, 24])
def test_solve_lap_min_equals_jax_column_for_column(k, kind):
    cost = costs(kind, 6, k, seed=k)
    got = solve_lap_min(torch.from_numpy(cost))
    assert got.dtype == torch.int64 and got.shape == (6, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_min(cost)))
    assert_optimal(cost, got.numpy())


def test_solve_lap_max_is_the_maximum_affinity():
    cost = costs("random", 4, 10, seed=3)
    got = solve_lap_max(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jlap.solve_lap_max)(cost)))
    assert_optimal(cost, got, maximize=True)


@pytest.mark.parametrize("k", [9, 12])
def test_hungarian_matching_above_eight_equals_jax(k):
    """Relaxed-IoU costs of soft segmentations against labels with fewer
    instances than K (zero rows), a label never predicted and a dead
    segment (zero columns): matching and mask equal JAX's."""
    rng = np.random.default_rng(k)
    b, n = 5, 64
    logits = 3.0 * rng.standard_normal((b, n, k)).astype(np.float32)
    logits[:, :, 1] = -30.0  # a dead segment
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    n_inst = rng.integers(2, k + 1, b)
    n_inst[0] = k
    labels = np.stack([rng.integers(0, m, n) for m in n_inst]).astype(np.int32)
    for i, m in enumerate(n_inst):
        labels[i, :m] = np.arange(m)  # every instance present
    labels[:, -3:] = -1  # background
    mj, maskj = jax_matching(jnp.asarray(w), jnp.asarray(labels))
    mt, maskt = torch_matching(torch.from_numpy(w), torch.from_numpy(labels))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(maskt.numpy(), np.asarray(maskj))
    assert maskt.sum(1).tolist() == n_inst.tolist()


# ---- profiling ---------------------------------------------------------------


class Clock:
    def __init__(self, times):
        self.times = iter(times)

    def __call__(self) -> float:
        return next(self.times)


def test_fence_equals_jax(monkeypatch):
    """Under the same patched clock both fences return the timestamp
    taken after the wait, over nested dicts, tuples and ``None`` leaves."""
    monkeypatch.setattr(time, "perf_counter", Clock([7.0, 7.0]))
    assert tprof.fence({"x": torch.ones(2), "y": (torch.zeros(1), None)}) \
        == jprof.fence({"x": jnp.ones(2), "y": (jnp.zeros(1), None)}) == 7.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        x = torch.ones(64, 64)
        (x @ x).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        assert '"traceEvents"' in f.read()
