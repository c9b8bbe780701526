"""Run one cell of the port's benchmark on the card and print its metrics.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
Set-up (``setup_s``, from the start of this process): the kernels are built
or loaded (``build/torch_kernels/`` in the checkout), the seed's input pool is
made on the card and pinned, and the cell's entry runs ``WARM_CALLS`` calls,
which plans every transform and fills the allocators. Then the closed-loop
window (``harness/window.py``) runs for ``--seconds``. With ``--trace 1`` a
traced segment of ``TRACE_SECONDS`` follows (and a shorter one that labels
its idle gaps) and the per-layer metrics are read from it, the window's
spans and the program's launch counters. Last,
with the program's objects freed, the kept calls are held against the
reference (``harness/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (blocks), ``metrics``, ``device`` [,
``breakdown``], and last ``checks``, each number compared beside its limit;
the same numbers end standard error. The run exits non-zero and prints no
result without the cards, or when jax, jaxlib, flax or the JAX package
(``pycusdr_tpu``) is loaded in this process once the window has closed.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the host's BLAS and OpenMP pools would
# contend with the dispatching thread for the host's cores
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import cells, check, entries, traffic, window  # noqa: E402
from portbench.harness import trace as tracing  # noqa: E402

#: calls through the whole entry before the window: the pipeline's depth and
#: more, so every shape is planned and every buffer allocated
WARM_CALLS = 6
#: seconds of the traced segment of a --trace 1 run, and of the one that
#: labels its idle gaps
TRACE_SECONDS = 1.0
LABEL_SECONDS = 0.5
#: top-level modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "pycusdr_tpu")


def forbidden_modules() -> list:
    """The FORBIDDEN names loaded, by whole top-level module name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _p95(values) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values), 95))


#: end-to-end metrics, taken by the benchmark itself
END_TO_END = {
    "msps": lambda r: r.pool.samples_per_call * r.window.calls / r.window.seconds / 1e6,
    "call_p95_ms": lambda r: 1e3 * _p95(r.window.latencies_s),
    "setup_s": lambda r: r.setup_s,
}


def _card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()), "power_limit": limit}


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float = None, entry_factory=entries.build, n_batches: int = None) -> dict:
    """One run of ``cell``; returns the result object. ``entry_factory``
    builds the program's entry (the tests break it underneath);
    ``n_batches``: the pool's size in batches instead of the mix's (the CPU
    tests' size)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        from pycusdr_tpu_torch.ops import _lib

        _lib.lib()
    pool = traffic.make_pool(cell.conf, cell.traffic, seed, dev, n_batches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    entry = entry_factory(cell.traffic, cell.conf, None if dev.type == "cuda" else "cpu")
    window.run(entry, pool, calls=WARM_CALLS)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    from pycusdr_tpu_torch import ops

    before = ops.launch_counts()
    entry.enqueue_s = 0.0
    w = window.run(entry, pool, seconds=seconds, first_call=WARM_CALLS,
                   keep=int(cell.traffic["checked_calls"]), seed=seed)
    launches = sum(ops.launch_counts().values()) - sum(before.values())
    enqueue_s = entry.enqueue_s
    tr = None
    if trace and dev.type == "cuda":
        tr = tracing.segment(lambda span, secs: window.run(
            entry, pool, seconds=secs, first_call=WARM_CALLS + w.calls, span=span),
            TRACE_SECONDS, LABEL_SECONDS)
    card = _card(dev)
    del entry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    t = check.tally(cell, pool, w.kept, dev)
    reference_s = time.perf_counter() - t_ref
    numbers = t.numbers()
    correct = bool(w.kept) and w.failed_blocks == 0 and check.verdict(numbers, cell.limits)
    r = SimpleNamespace(pool=pool, window=w, setup_s=setup_s, trace=tr, launches=launches,
                        enqueue_s=enqueue_s, cell=cell, bounds={})
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cells.reader(m["name"], cell.root)(r)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(END_TO_END[m["name"]](r)), "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": correct, "attempted": w.calls * pool.blocks_per_call,
              "failed": w.failed_blocks, "metrics": metrics, "device": card}
    if tr is not None:
        card.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in tr.ops[:10]],
                               "idle_gaps": [[n, s] for n, s in tr.gaps[:10]]}
        result["bounds"] = r.bounds
    result["diagnosis"] = {"reference_s": reference_s, "gaps": t.gaps,
                           "decision_fields": t.fields,
                           "decisions_differ": t.differ, "calls": w.calls,
                           "checked_calls": sorted(w.kept)}
    result["checks"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of the JAX side are loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
