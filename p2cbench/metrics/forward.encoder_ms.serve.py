"""Device time of the served sketch encoder a traced request (ms), from the
``serve_encoder`` marker to the next; None where the artifact has no encoder."""
from p2cbench.phases import device_ms


def read(run):
    return device_ms(run, "serve", ("serve_encoder",))
