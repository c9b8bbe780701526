"""Hand-written kernel launches a call, from the program's counters
(``ops.launch_counts()``) over the untraced window."""


def read(r):
    if not r.window.calls or not r.launches:
        return None
    return r.launches / r.window.calls
