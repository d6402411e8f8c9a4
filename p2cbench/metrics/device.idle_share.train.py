"""The card's idle share of the traced training steps (%)."""


def read(run):
    if run.traffic["kind"] != "train" or run.slice is None:
        return None
    return 100.0 * (1.0 - run.slice.busy_us / run.slice.window_us)
