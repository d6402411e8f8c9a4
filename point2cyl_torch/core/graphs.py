"""Captured steps: the port's counterpart of the JAX package's ``jax.jit``.

JAX runs each step (Trainer A's, a serving bucket's, the evaluator's) as
one compiled program per input shape, with no host work between its
operations. :class:`StepGraphs` does the same with CUDA graphs, following
PyTorch's whole-network capture recipe:

1. The first call with a new key (the inputs' shapes and dtypes plus the
   caller's static flags) runs the step eagerly on a side stream. That
   call is a real step, and it sets up everything the step creates
   lazily: the kernels' build and attributes, the FPS kernel's cached
   occupancy query, cuBLAS handles, cached constants.
2. The second call with that key captures the step on the side stream
   into a ``torch.cuda.CUDAGraph`` and replays it.
3. Every later call copies its inputs into the graph's static buffers and
   replays.

All graphs of one owner (a trainer, a session replica, an evaluator) share
one memory pool. A graph's outputs are its static buffers: the next replay
of that graph rewrites them, so the owner consumes or copies them first.

Random draws come from a generator the owner passes. On the card the step
draws from a generator of this object's own, registered with every graph;
its state is set from the caller's before each call and written back
after, so the caller's generator advances as an eager step would advance
it, and a replay draws what the eager step would draw from the same state.

A capture or a replay that fails raises; nothing runs eagerly in its
place. ``enabled=False`` (the owners' ``graph=False``, or a data-parallel
owner whose mesh stages its collectives through host memory) and a CPU
device run the step eagerly on every call, with the caller's generator;
``eager_because`` says which.

A step with NCCL collectives (a data-parallel owner on the card) is
captured too: its first, eager call creates the communicator, and the
capture runs in ``capture_error_mode="thread_local"``, so that the
process group's watchdog thread, which queries CUDA events, cannot
invalidate it.

Under a profiler each call shows the path it took as a host span
(``p2c.graphs.eager``, ``p2c.graphs.capture``, ``p2c.graphs.replay``), so a
recapture shows in any trace.
"""

from __future__ import annotations

from typing import Any, Callable, Hashable, NamedTuple

import torch

from point2cyl_torch.core.profiling import span

StepFn = Callable[[dict[str, torch.Tensor], "torch.Generator | None"], Any]


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: dict[str, torch.Tensor]  # static input buffers
    outputs: Any  # static outputs


class StepGraphs:
    """One owner's captured steps on ``device``, one graph per key."""

    def __init__(self, device: str | torch.device, enabled: bool = True, *,
                 eager_because: str = "graph=False", capture_error_mode: str = "global"):
        self.device = torch.device(device)
        self.enabled = enabled and self.device.type == "cuda"
        self.eager_because = (None if self.enabled else
                              "cpu" if self.device.type != "cuda" else eager_because)
        self.capture_error_mode = capture_error_mode
        self._graphs: dict[Hashable, _Captured] = {}
        self._warm: set[Hashable] = set()  # keys whose eager first call ran
        self._pool = None
        self._stream: torch.cuda.Stream | None = None
        self._generator: torch.Generator | None = None
        self.eager_calls = 0
        self.captures = 0
        self.replays = 0

    def __call__(self, fn: StepFn, inputs: dict[str, torch.Tensor],
                 generator: torch.Generator | None = None,
                 static: Hashable = ()) -> Any:
        """``fn(inputs, generator)``: eager, or captured and replayed.

        ``inputs`` are tensors on ``device``; ``static`` holds the flags
        that select a different program (a key of this object's graphs
        together with the inputs' shapes and dtypes, and whether a
        generator is passed). ``fn`` reads every tensor that changes from
        call to call from ``inputs`` or from state it owns in place.
        """
        if not self.enabled:
            self.eager_calls += 1
            with span("graphs.eager"):
                return fn(inputs, generator)
        key = (static, generator is None,
               tuple((name, tuple(x.shape), x.dtype) for name, x in inputs.items()))
        with torch.cuda.device(self.device):
            entry = self._graphs.get(key)
            if entry is None and key not in self._warm:
                with span("graphs.eager"):
                    out = self._on_side_stream(fn, inputs, generator)
                self._warm.add(key)
                self.eager_calls += 1
                return out
            if entry is None:
                with span("graphs.capture"):
                    entry = self._capture(key, fn, inputs, generator is not None)
            with span("graphs.replay"):
                return self._replay(entry, inputs, generator)

    @property
    def stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _on_side_stream(self, fn: StepFn, inputs, generator):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn(inputs, generator)
        current.wait_stream(self.stream)
        return out

    def _own_generator(self) -> torch.Generator:
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        return self._generator

    def _capture(self, key: Hashable, fn: StepFn, inputs, draws: bool) -> _Captured:
        static_inputs = {name: x.clone() for name, x in inputs.items()}
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        gen = None
        if draws:
            gen = self._own_generator()
            graph.register_generator_state(gen)
        # during a capture the allocator cannot hand cached memory back to
        # the device, so other pools' free blocks go back first, as
        # torch.cuda.graph does (its collection of Python garbage and of
        # the pinned host memory's cache a step's capture does not need)
        torch.cuda.empty_cache()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            graph.capture_begin(self._pool, capture_error_mode=self.capture_error_mode)
            try:
                outputs = fn(static_inputs, gen)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        entry = self._graphs[key] = _Captured(graph, static_inputs, outputs)
        self.captures += 1
        return entry

    def _replay(self, entry: _Captured, inputs, generator):
        for name, buf in entry.inputs.items():
            buf.copy_(inputs[name], non_blocking=True)
        if generator is not None:
            own = self._own_generator()
            own.set_state(generator.get_state())
        entry.graph.replay()
        if generator is not None:
            generator.set_state(own.get_state())
        self.replays += 1
        return entry.outputs


def step_graphs(device: torch.device, graph: bool, mesh) -> StepGraphs:
    """A step owner's :class:`StepGraphs`: captured on the card unless
    ``graph`` is False or ``mesh`` stages its collectives through host
    memory (a graph cannot hold a host round trip; such a step runs
    eagerly, ``eager_because`` "host-staged mesh"). A mesh's captures run
    in ``thread_local`` error mode, out of reach of NCCL's watchdog."""
    staged = mesh is not None and mesh.group is not None and mesh.host_staged
    return StepGraphs(device, enabled=graph and not staged,
                      eager_because="host-staged mesh" if graph and staged else "graph=False",
                      capture_error_mode="global" if mesh is None else "thread_local")
