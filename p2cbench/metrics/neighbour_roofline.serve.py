"""The neighbour operations' share of their roofline in the traced requests (%)."""
from p2cbench.readers import neighbour_roofline_percent


def read(run):
    return neighbour_roofline_percent(run, "serve")
