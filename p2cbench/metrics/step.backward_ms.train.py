"""Device time of the training step's backward a traced step (ms), from the
``train_backward`` marker to the next."""
from p2cbench.phases import device_ms


def read(run):
    return device_ms(run, "train", ("train_backward",))
