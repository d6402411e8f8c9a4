"""A traced slice of the window: ``torch.profiler`` over a few steady steps
or requests, reduced to device intervals, host ranges and launch counts.

The slice is one host range (``p2cbench.slice``) that ends in a
synchronise; each step or request inside it is a range of its own
(``p2cbench.unit``). Device and host times share the profiler's clock, in
microseconds. Nothing is written to disk.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable

import torch

SLICE, UNIT = "p2cbench.slice", "p2cbench.unit"
LAUNCH_NAMES = ("LaunchKernel", "GraphLaunch", "cuLaunch", "MemcpyAsync", "MemsetAsync")


class Slice:
    """What one traced slice holds: ``device`` (name, start, end) of every
    kernel, copy and set on the card; ``host`` (name, start, end) of every
    host event; the slice's and each unit's span."""

    def __init__(self, device, host, span, units):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = host
        self.span = span
        self.units = units
        self.merged = _merge([(s, e) for _, s, e in self.device], *span)

    @property
    def window_us(self) -> float:
        return self.span[1] - self.span[0]

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in self.merged)

    def busy_within(self, start: float, end: float) -> float:
        return sum(max(0.0, min(e, end) - max(s, start)) for s, e in self.merged)

    def device_time(self, patterns) -> float:
        """Summed device time (us) of the events whose name holds any of
        ``patterns``."""
        return sum(e - s for name, s, e in self.device if any(p in name for p in patterns))

    def launches(self) -> int:
        """Host calls that put work on the card: kernel, graph, copy and
        set launches."""
        return sum(1 for name, _, _ in self.host
                   if name.startswith(("cuda", "cu")) and any(k in name for k in LAUNCH_NAMES))

    def top_device_ops(self, count: int = 10) -> list:
        by_name = defaultdict(float)
        for name, s, e in self.device:
            by_name[name[:120]] += e - s
        top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:count]
        return [[name, us / 1e6] for name, us in top]

    def idle_gaps(self, count: int = 10) -> list:
        """The card's idle time in the slice, by the innermost host event
        under way in the middle of each gap, the largest totals first."""
        gaps, prev = [], self.span[0]
        for s, e in self.merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.span[1] > prev:
            gaps.append((prev, self.span[1]))
        by_name = defaultdict(float)
        ranges = self.host + [(UNIT, s, e) for s, e in self.units]
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inner = [h for h in ranges if h[1] <= mid <= h[2]]
            name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "(between units)"
            if name == UNIT:
                name = "host work outside torch operations (Python, numpy)"
            by_name[name[:120]] += e - s
        top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:count]
        return [[name, us / 1e6] for name, us in top]


def _merge(intervals, lo, hi):
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def traced(units: int, run_unit: Callable[[int], None]) -> Slice:
    """Run ``run_unit(i)`` for ``i < units`` under the profiler, each in a
    unit range, the whole in a slice range that ends synchronised."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SLICE):
            for i in range(units):
                with torch.profiler.record_function(UNIT):
                    run_unit(i)
            torch.cuda.synchronize()
    device, host, span, unit_spans = [], [], None, []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                device.append((e.name, start, end))
            continue
        if e.name == SLICE:
            span = (start, end)
        elif e.name == UNIT:
            unit_spans.append((start, end))
        else:
            host.append((e.name, start, end))
    if span is None:
        raise RuntimeError("the profiler recorded no slice range")
    return Slice(device, host, span, sorted(unit_spans))
