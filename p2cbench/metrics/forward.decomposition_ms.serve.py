"""Device time of the served decomposition without its encoder, and of the
packing, a traced request (ms): the ``serve_decomposition`` and ``serve_pack``
phases."""
from p2cbench.phases import device_ms


def read(run):
    return device_ms(run, "serve", ("serve_decomposition", "serve_pack"))
