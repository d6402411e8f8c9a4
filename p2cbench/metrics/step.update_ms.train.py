"""Device time of the training step's update (the guard, Adam, the kept state,
the step count) a traced step (ms), from the ``train_update`` marker to ``end``."""
from p2cbench.phases import device_ms


def read(run):
    return device_ms(run, "train", ("train_update",))
