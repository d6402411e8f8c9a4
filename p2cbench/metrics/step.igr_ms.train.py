"""Device time of the joint step's IGR and latent losses a traced step (ms), from
the ``train_igr`` marker to the next; None in a step without it."""
from p2cbench.phases import device_ms


def read(run):
    return device_ms(run, "train", ("train_igr",))
