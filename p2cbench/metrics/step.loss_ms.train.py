"""Device time of the training step's proxy losses and K!-matching a traced step
(ms), from the ``train_loss`` marker to the next."""
from p2cbench.phases import device_ms


def read(run):
    return device_ms(run, "train", ("train_loss",))
