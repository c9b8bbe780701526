"""The traced segment of a ``--trace 1`` run and what is read from it.

``torch.profiler`` (CUPTI) records the device's kernels and copies over a
closed-loop segment that follows the measured window, with the device's
activity alone: recording every host op as well slows the host by a large
share of a call (the host-paced cells' idle share doubled) and so would
misstate the idle share. A trace now and then comes back with device events
missing, so one that does not hold a whole number of host-to-device copies
a call is taken again, three times at most. A second, shorter segment
records the host too, with the benchmark's own spans (``portbench.dispatch``,
``portbench.finish``), and labels the idle gaps by what the host was doing
(at the host's slower pace under that profiler).

Each kernel is given to the stage of the graph whose hand-written kernel (or
transform) ran last before it (``STAGES``), so an elementwise kernel counts
in the stage that queued it; copies and memsets are counted apart.
"""

import bisect
import re
import time
from dataclasses import dataclass

import torch

#: the graph's stages and the device functions that open each
STAGES = {
    "channelize": r"channelize",
    "clip": r"thr_(cluster|pass)",
    "fft": r"fft",
    "doppler": r"doppler_(energy_k|estimate)",
    "mask_bank": r"mf_(pass|mid)",
    "timing": r"band_(partial|argmax)",
    "centres": r"symbol_detect",
}
_STAGE_RE = [(s, re.compile(p, re.IGNORECASE)) for s, p in STAGES.items()]
H2D, D2H = re.compile(r"Memcpy HtoD"), re.compile(r"Memcpy DtoH")
COPY = re.compile(r"^Mem(cpy|set)")
SPAN = "portbench."
RETAKES = 3


@dataclass
class Trace:
    calls: int
    window_s: float  # host seconds of the traced segment
    busy_s: float  # seconds in which a kernel or a copy ran
    h2d_s: float
    d2h_s: float
    kernel_s: float
    stage_s: dict
    ops: list  # [(name, seconds)] summed by name, largest first
    gaps: list  # [(what the host was doing, seconds)] of the idle time, largest first
    complete: bool  # a whole number of host-to-device copies a call was found
    n_events: int = 0


def _union(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _gaps(dev_iv, spans, t0, t1):
    """Idle stretches of [t0, t1] (us) between device intervals, each summed
    under the host span open at its midpoint ("harness" where none is)."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s for _, s, _ in spans]
    out = {}
    end = t0
    for a, b in sorted(dev_iv) + [(t1, t1)]:
        if a > end:
            mid = 0.5 * (a + end)
            j = bisect.bisect_right(starts, mid) - 1
            name = spans[j][0] if j >= 0 and spans[j][2] >= mid else "harness"
            out[name] = out.get(name, 0.0) + (a - end) * 1e-6
        end = max(end, b)
    return sorted(out.items(), key=lambda kv: -kv[1])


def read(prof, calls: int, window_s: float) -> Trace:
    evs = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    # the host spans also show on the device's timeline (as user annotations)
    dev = sorted((e for e in evs if e.device_type == cuda and not e.name.startswith(SPAN)),
                 key=lambda e: e.time_range.start)
    spans = [(e.name[len(SPAN):], e.time_range.start, e.time_range.end)
             for e in evs if e.device_type != cuda and e.name.startswith(SPAN)]
    iv = [(e.time_range.start, e.time_range.end) for e in dev]
    h2d = sum(e.time_range.elapsed_us() for e in dev if H2D.search(e.name)) * 1e-6
    d2h = sum(e.time_range.elapsed_us() for e in dev if D2H.search(e.name)) * 1e-6
    n_h2d = sum(1 for e in dev if H2D.search(e.name))
    stage = dict.fromkeys(STAGES, 0.0)
    ops, cur = {}, None
    for e in dev:
        us = e.time_range.elapsed_us()
        ops[e.name] = ops.get(e.name, 0.0) + us * 1e-6
        if COPY.search(e.name):
            continue
        cur = next((s for s, p in _STAGE_RE if p.search(e.name)), cur)
        if cur is not None:
            stage[cur] += us * 1e-6
    kernel = sum(e.time_range.elapsed_us() for e in dev if not COPY.search(e.name)) * 1e-6
    if spans:
        t0 = min(s for _, s, _ in spans)
        t1 = max(max(e for _, _, e in spans), max((b for _, b in iv), default=t0))
    else:
        t0 = t1 = 0.0
    return Trace(calls=calls, window_s=window_s, busy_s=_union(iv) * 1e-6, h2d_s=h2d,
                 d2h_s=d2h, kernel_s=kernel, stage_s=stage,
                 ops=sorted(ops.items(), key=lambda kv: -kv[1]),
                 gaps=_gaps(iv, spans, t0, t1) if spans else [],
                 complete=n_h2d > 0 and n_h2d % max(calls, 1) == 0, n_events=len(dev))


def _traced(run_segment, host: bool, seconds: float) -> Trace:
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    span = (lambda name: torch.profiler.record_function(SPAN + name)) if host else None
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        w = run_segment(span, seconds)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return read(prof, w.calls, window_s)


def segment(run_segment, seconds: float, label_seconds: float) -> Trace:
    """Trace ``run_segment(span, seconds)`` (which drives the closed loop
    for ``seconds`` with ``span`` as its host-span factory, None for none,
    and returns its Window) with the device's activity alone, taken again
    while the trace lost copies; then label its idle gaps from a trace of
    ``label_seconds`` that records the host too."""
    best = None
    for _ in range(RETAKES):
        tr = _traced(run_segment, False, seconds)
        if tr.complete:
            best = tr
            break
        if best is None or tr.n_events > best.n_events:
            best = tr
    best.gaps = _traced(run_segment, True, label_seconds).gaps
    return best
