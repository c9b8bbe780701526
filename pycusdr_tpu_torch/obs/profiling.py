"""Tracing and profiling helpers: the port of ``pycusdr_tpu/obs/profiling.py``.

``StageTimer`` is a copy of the JAX package's named-stage wall-clock
accounting. ``device_trace`` captures a ``torch.profiler`` trace of the
enclosed block (host and, on a card, device activity) and writes it as a
Chrome trace (``chrome://tracing`` or Perfetto).
"""

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger(__name__)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``log_dir/trace.json`` (a Chrome trace). Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        log.info("device trace written to %s", path)


class StageTimer:
    """Named-stage wall-clock accounting with running averages.

    ``with timer("doppler"): ...`` — read ``timer.report()`` anytime.
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}
        self._stack = []

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[stage] = self.totals.get(stage, 0.0) + dt
            self.counts[stage] = self.counts.get(stage, 0) + 1

    def mean(self, stage: str) -> float:
        return self.totals.get(stage, 0.0) / max(self.counts.get(stage, 0), 1)

    def report(self) -> str:
        lines = [
            f"{k:>20}: {self.mean(k) * 1e3:8.3f} ms avg x{self.counts[k]}"
            for k in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
