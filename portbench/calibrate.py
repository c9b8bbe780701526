"""The readings the limits of a cell's comparison are set from, on the card at
the cell's own size, in one process: the program's numbers on each of
``--seeds`` (set-up, warm-up and a closed-loop window of ``--seconds`` as
``run.py`` makes them, the entry built once), and the control's on each of
``--control-seeds`` (the reference in TF32 in the program's place, on the
same calls of the same pools). The benchmark's runs do not run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 --seconds 2 [--out readings.json]

Prints one JSON line a seed and a summary line: the largest reading of each
number over the program's seeds, the smallest over the control's.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

from portbench.harness import cells, check, entries, traffic, window  # noqa: E402
from portbench.run import WARM_CALLS  # noqa: E402


def readings(cell, seeds, control_seeds, seconds, device="cuda", n_batches=None):
    import torch

    torch.set_num_threads(1)
    dev = torch.device(device)
    entry = None
    rows = []
    keep = int(cell.traffic["checked_calls"])
    for seed in seeds:
        t0 = time.perf_counter()
        pool = traffic.make_pool(cell.conf, cell.traffic, seed, dev, n_batches)
        if entry is None:
            entry = entries.build(cell.traffic, cell.conf, None if dev.type == "cuda" else "cpu")
        window.run(entry, pool, calls=WARM_CALLS)
        w = window.run(entry, pool, seconds=seconds, first_call=WARM_CALLS, keep=keep, seed=seed)
        t = check.tally(cell, pool, w.kept, dev)
        rows.append({"kind": "program", "seed": seed, **t.numbers(), "gaps": t.gaps,
                     "fields": t.fields, "differ": t.differ, "failed": w.failed_blocks,
                     "calls": w.calls, "msps": pool.samples_per_call * w.calls / w.seconds / 1e6,
                     "seconds": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
    for seed in control_seeds:
        pool = traffic.make_pool(cell.conf, cell.traffic, seed, dev, n_batches)
        kept = {WARM_CALLS + i: None for i in range(keep)}
        t = check.tally(cell, pool, kept, dev, control=True)
        rows.append({"kind": "control", "seed": seed, **t.numbers(), "gaps": t.gaps,
                     "fields": t.fields, "differ": t.differ})
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": cell.name}
    for k in ("decisions", "analog"):
        prog = [r[k] for r in rows if r["kind"] == "program"]
        ctl = [r[k] for r in rows if r["kind"] == "control"]
        summary[k] = {"lower": max(prog, default=None), "upper": min(ctl, default=None)}
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    rows, summary = readings(cell, args.seeds, args.control_seeds, args.seconds)
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
