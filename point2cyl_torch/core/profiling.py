"""Profiling and step timing (the port of the JAX ``core/profiling.py``).

``trace`` captures a ``torch.profiler`` trace of a region, host and card,
and writes it under ``logdir`` as a Chrome trace that TensorBoard's
profiler plugin and Perfetto open. ``StepTimer`` reports steps per second
over windows of ``fence_every`` steps, paying a sync only at each
window's end (``fence``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile the body on the host and, where there is one, the card;
    the trace lands in ``logdir`` as ``<worker>.<time>.pt.trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    ):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _cuda_devices(tree, found: set) -> None:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            _cuda_devices(leaf, found)
    elif isinstance(tree, (list, tuple)):
        for leaf in tree:
            _cuda_devices(leaf, found)


def fence(tree) -> float:
    """Wait for every CUDA device that holds a tensor of the nested dicts,
    lists and tuples ``tree`` (CPU tensors are done when they exist) and
    return a host timestamp after it. ``torch.cuda.synchronize`` waits
    reliably, so the JAX version's scalar that data-depends on every leaf
    is not needed."""
    found: set = set()
    _cuda_devices(tree, found)
    for device in found:
        torch.cuda.synchronize(device)
    return time.perf_counter()


class StepTimer:
    """Rolling per-step wall-clock statistics with periodic fencing.

    Fencing every step would serialize the host with the card; only every
    ``fence_every`` steps pay the sync, and throughput is computed over the
    fenced window.
    """

    def __init__(self, fence_every: int = 20):
        self.fence_every = fence_every
        self._t0: float | None = None
        self._steps = 0
        self.last_steps_per_sec = 0.0

    def step(self, outputs) -> float | None:
        """Count one step; returns steps/sec when a fence fires (None at
        the first fence, which only opens the window)."""
        self._steps += 1
        if self._steps % self.fence_every != 0:
            return None
        t = fence(outputs)
        if self._t0 is not None:
            self.last_steps_per_sec = self.fence_every / (t - self._t0)
        self._t0 = t
        return self.last_steps_per_sec or None
