"""Host calls that put work on the card (kernel, graph, copy and set
launches) a traced training step: a captured step is one graph launch and
its input copies."""


def read(run):
    if run.traffic["kind"] != "train" or run.slice is None:
        return None
    return run.slice.launches() / run.slice_steps
