"""Device ms a call of the device-to-host copies (the outputs into pinned
host memory, ``start_download``), from the traced segment's memcpy events."""


def read(r):
    if r.trace is None or not r.trace.calls or not r.trace.d2h_s:
        return None
    return 1e3 * r.trace.d2h_s / r.trace.calls
