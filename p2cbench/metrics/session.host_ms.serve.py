"""A traced request's host time (ms): its wall time less the card's busy
time inside it (the H2D copy's wait, the launches, the D2H wait and the
numpy assembly)."""


def read(run):
    if run.traffic["kind"] != "serve" or run.slice is None or not run.slice.units:
        return None
    idle = [(e - s) - run.slice.busy_within(s, e) for s, e in run.slice.units]
    return sum(idle) / len(idle) / 1e3
