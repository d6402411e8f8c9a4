"""Host time of the session's staging a traced request (ms): the
``p2c.session.stage`` spans (slice, padding, the pageable copy to the card)."""
from p2cbench.phases import host_ms


def read(run):
    return host_ms(run, "session.stage")
