"""The training step's model FLOPs a second over the card's peak (%)."""
from p2cbench.readers import mfu_percent


def read(run):
    return mfu_percent(run, "train")
