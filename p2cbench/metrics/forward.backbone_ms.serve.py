"""Device time of the served backbone and heads a traced request (ms), from the
``serve_backbone`` marker to the next."""
from p2cbench.phases import device_ms


def read(run):
    return device_ms(run, "serve", ("serve_backbone",))
