"""SIGTERM/SIGINT flag helper for clean process shutdown (a copy of
``pycusdr_tpu/utils/graceful.py``).

Capability parity with ``pyCuSDR/lib/gracefullKiller.py:6-16``.
"""

import signal


class GracefulKiller:
    def __init__(self, signals=(signal.SIGINT, signal.SIGTERM)):
        self.kill_now = False
        for s in signals:
            try:
                signal.signal(s, self._exit)
            except (ValueError, OSError):  # not in main thread
                pass

    def _exit(self, signum, frame):
        self.kill_now = True

