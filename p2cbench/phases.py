"""Phase times read from a traced slice, for the readers in ``metrics/``:
the program's device phase markers (empty kernels named
``p2c_mark_<phase>``, captured into its CUDA graphs, so every replay
carries them) and its host spans (``p2c.<name>`` ranges).

A phase on the card runs from its marker's start to the next marker's
start; the marker ``end`` closes a step's or a chunk's last phase and
starts none. A phase's time is summed over the slice and divided by the
slice's steps or requests (``run.slice_steps``), in ms. A slice of a
program without the markers or spans gives None, as does a cell of the
other kind.
"""

from __future__ import annotations

import re
from collections import defaultdict

MARKER = re.compile(r"p2c_mark_(\w+)")
END = "end"
SPAN_PREFIX = "p2c."


def markers(slice_) -> list[tuple[str, float]]:
    """(phase, start in us) of every marker kernel of the slice, in time
    order."""
    out = []
    for name, start, _ in slice_.device:
        found = MARKER.search(name)
        if found:
            out.append((found.group(1), start))
    return sorted(out, key=lambda m: m[1])


def phase_us(slice_) -> dict[str, float]:
    """Each phase's summed device time (us) over the slice: from its
    marker to the next one."""
    marks = markers(slice_)
    total: dict[str, float] = defaultdict(float)
    for (phase, start), (_, after) in zip(marks, marks[1:]):
        if phase != END:
            total[phase] += after - start
    return dict(total)


def device_ms(run, kind: str, phases: tuple[str, ...]) -> float | None:
    """The summed device time of ``phases`` a traced step or request (ms)
    in a cell of traffic ``kind``; None where none of them has a
    marker."""
    if run.traffic["kind"] != kind or run.slice is None:
        return None
    per = phase_us(run.slice)
    if not any(p in per for p in phases):
        return None
    return sum(per.get(p, 0.0) for p in phases) / run.slice_steps / 1e3


def host_ms(run, span: str) -> float | None:
    """The summed duration of the host spans ``p2c.<span>`` a traced
    request (ms) in a serving cell; None where there is none."""
    if run.traffic["kind"] != "serve" or run.slice is None:
        return None
    name = SPAN_PREFIX + span
    times = [end - start for n, start, end in run.slice.host if n == name]
    if not times:
        return None
    return sum(times) / run.slice_steps / 1e3
