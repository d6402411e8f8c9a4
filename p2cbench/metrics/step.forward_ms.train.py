"""Device time of the training step's forward phase (noise, backbone, heads; the
joint step's frozen encoder too) a traced step (ms), from its marker to the next."""
from p2cbench.phases import device_ms


def read(run):
    return device_ms(run, "train", ("train_forward",))
