"""Host ms a call spent in the call into the program's graph functions (the
benchmark's own span around them, ``harness/entries.py``), over the untraced
window."""


def read(r):
    if not r.window.calls:
        return None
    return 1e3 * r.enqueue_s / r.window.calls
