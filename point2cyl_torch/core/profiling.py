"""The port's tracing: host spans and device phase markers on the
profiler's clock, a Chrome-trace exporter, and ``fence``.

``span(name)`` names a stretch of host work. With no ``torch.profiler``
recording it returns one shared no-op context, at the cost of one read of
the profiler's flag; under a profiler it opens a ``record_function`` range
``p2c.<name>``. A span's name is fixed: the ranges of one request are the
ones its ``p2c.session.request`` holds, and a trace's reader sums them by
name (the profiler keeps no ``args`` string of a range, and a request
number in the name would split those sums by request).

``mark(phase, like)`` starts a phase of the card's work: on a CUDA
``like`` it launches the phase's empty marker kernel
(``csrc/marks.cu``, named ``p2c_mark_<phase>``) on the current stream; on
the CPU it does nothing. Launched inside a step body, the markers are
captured into the step's CUDA graph, so every replay carries them into the
profiler's device trace, where a captured graph shows no host range. The
phases are flat: a marker starts its phase and the next marker (or
``end``) ends it. ``PHASES`` is the one table of them, which
``csrc/marks.cu`` mirrors in order. There is no switch: with no profiler
the markers cost an empty kernel node each (a few a step).

``trace`` records a region, host and card, into a Chrome trace that
Perfetto and TensorBoard's profiler plugin open: the spans, the markers
and every kernel on one timeline.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import ContextManager, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "p2c."
MARK_PREFIX = "p2c_mark_"

# the phases of the captured steps, in csrc/marks.cu's order
PHASES = (
    "train_forward", "train_loss", "train_sketch", "train_igr", "train_backward",
    "train_update", "serve_backbone", "serve_decomposition", "serve_encoder", "serve_pack",
    "end",
)
_PHASE_INDEX = {phase: i for i, phase in enumerate(PHASES)}

_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A host range ``p2c.<name>`` while a profiler records; else the
    shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def mark(phase: str, like: torch.Tensor) -> None:
    """Start ``phase`` (one of ``PHASES``) on ``like``'s card: its marker
    kernel on the current stream, recorded into a capture under way. A
    CPU ``like`` launches nothing."""
    index = _PHASE_INDEX.get(phase)
    if index is None:
        raise ValueError(f"unknown phase {phase!r}; the phases are {PHASES}")
    if like.device.type != "cuda":
        return
    from point2cyl_torch.ops import _build

    fn = _build.function("p2c_mark", [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(like.device):
        status = fn(index, torch.cuda.current_stream(like.device).cuda_stream)
    _build.check("p2c_mark", status)


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
