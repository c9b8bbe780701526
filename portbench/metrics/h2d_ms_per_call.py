"""Device ms a call of the host-to-device copies (the batch into the card),
from the traced segment's memcpy events."""


def read(r):
    if r.trace is None or not r.trace.calls or not r.trace.h2d_s:
        return None
    return 1e3 * r.trace.h2d_s / r.trace.calls
