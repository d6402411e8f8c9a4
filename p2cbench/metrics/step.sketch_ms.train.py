"""Device time of the joint step's sketch projections and encoder a traced step
(ms), from the ``train_sketch`` marker to the next; None in a step without it."""
from p2cbench.phases import device_ms


def read(run):
    return device_ms(run, "train", ("train_sketch",))
