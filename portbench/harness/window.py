"""The closed-loop window: calls stay in flight through the program's own
``runtime.pipeline.InflightPipeline`` at the station's pipeline depth, and
the next batch is dispatched as soon as the pipeline takes the last one.

A call is timed from when its batch is handed to the entry to when its
outputs are in host memory. The window runs from the first hand-in to the
moment the last call dispatched before ``seconds`` ran out has its outputs
back, so every call and all of the time count.

The outputs of ``keep`` calls, drawn uniformly from the window's calls by
reservoir sampling with a generator seeded from the run's seed, are kept for
the comparison (their pinned buffers, no copy).
"""

import contextlib
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

#: the station's pipeline depth (pyCuSDR config/base.json GPU.UHF.TPU.pipelineDepth)
PIPELINE_DEPTH = 2


@dataclass
class Window:
    calls: int = 0
    seconds: float = 0.0
    latencies_s: list = field(default_factory=list)
    failed_blocks: int = 0
    kept: dict = field(default_factory=dict)  # call index -> outputs in host memory


def _nan_blocks(out) -> int:
    """Blocks whose outputs hold a NaN (a dot with ones carries any NaN; the
    -inf an idle block's SNR reads is no failure). Integer outputs hold none."""
    arrays = out.values() if isinstance(out, dict) else [out]
    bad = 0
    for v in arrays:
        if v.dtype.kind == "f":
            v = v.reshape(v.shape[0], -1)
            bad = bad | np.isnan(v @ np.ones(v.shape[1], v.dtype))
    return int(np.count_nonzero(bad))


def run(entry, pool, *, seconds: float = None, calls: int = None, first_call: int = 0,
        keep: int = 0, seed: int = 0, depth: int = PIPELINE_DEPTH, span=None) -> Window:
    """Drive ``entry`` over the pool for ``seconds`` (or exactly ``calls``
    calls), starting at the pool cycle's call ``first_call``. ``span(name)``:
    a context manager around each dispatch ("dispatch") and each wait for a
    call's outputs ("finish"): the trace's host spans."""
    from pycusdr_tpu_torch.runtime.pipeline import InflightPipeline

    w = Window()
    rng = np.random.default_rng([int(seed) % (2 ** 63), 0x5EED])
    n_blocks = pool.blocks_per_call

    span = span or (lambda name: contextlib.nullcontext())

    def emit(pending, t0, i):
        try:
            with span("finish"):
                out = entry.finish(pending)
        except Exception:  # a call that raised: its blocks failed, the window goes on
            traceback.print_exc()
            w.failed_blocks += n_blocks
            return
        w.latencies_s.append(time.perf_counter() - t0)
        w.failed_blocks += _nan_blocks(out)
        n = i - first_call
        if n < keep:
            w.kept[i] = out
        elif keep:
            j = rng.integers(0, n + 1)
            if j < keep:
                w.kept.pop(sorted(w.kept)[j])
                w.kept[i] = out

    pipe = InflightPipeline(depth, emit)
    P = len(pool)
    start = time.perf_counter()
    i = first_call
    while (time.perf_counter() - start < seconds) if calls is None else (i - first_call < calls):
        t0 = time.perf_counter()
        try:
            with span("dispatch"):
                pending = entry.dispatch(pool.batches[i % P])
        except Exception:
            traceback.print_exc()
            w.failed_blocks += n_blocks
        else:
            pipe.push(pending, t0, i)
        i += 1
    pipe.flush()
    w.seconds = time.perf_counter() - start
    w.calls = i - first_call
    return w
