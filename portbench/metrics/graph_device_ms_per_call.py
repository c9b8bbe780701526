"""Device ms a call of every kernel (copies and memsets apart), from the
traced segment."""


def read(r):
    if r.trace is None or not r.trace.calls or not r.trace.kernel_s:
        return None
    return 1e3 * r.trace.kernel_s / r.trace.calls
