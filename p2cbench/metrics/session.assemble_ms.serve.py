"""Host time of the session's assembly a traced request (ms): the
``p2c.session.assemble`` spans (concatenation, unpacking) after the wait."""
from p2cbench.phases import host_ms


def read(run):
    return host_ms(run, "session.assemble")
