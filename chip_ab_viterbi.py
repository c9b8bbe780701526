"""K7 and ``ViterbiStream.feed`` of two checkouts, timed in turns on one card.

    python3 chip_ab_viterbi.py PARENT_DIR

PARENT_DIR is another checkout of the repo (for example ``git archive`` of
the parent commit unpacked under ``build/``); the other tree is the one
that holds this script. Each turn is a fresh process run from one tree's
root, which builds that tree's kernels and times, on card 0:

- K7 (``viterbi_sweep``, soft ±1/0 symbols, streaming) at chip_smoke's
  shapes: S=1, T=2144, decode; S=2, T=2016/2015, metric-only; S=64,
  T=2144, decode (CUDA events, chip_smoke's ``cuda_ms``);
- the host ms per ``ViterbiStream.feed`` of one flagship block (4032 soft
  symbols) over BLOCKS blocks, through K7 and through the plain version
  (chip_smoke's ``time_feed``).

The turns run parent, change, change, parent, so a drift of the card or
the host shows as a difference between the two runs of one tree. Each
turn prints one JSON line; the card's name and power limit come first.
Both trees' ``chip_smoke.py`` must have ``viterbi_inputs``, ``cuda_ms``
and ``time_feed``. Needs a card: a turn fails without one.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: flagship blocks fed per feed timing (the first is not timed)
BLOCKS = 200

#: run with ``python -c`` from a tree's root, so that it imports that tree
TURN = """
import json, sys
import torch
assert torch.cuda.is_available(), "no card"
import chip_smoke as c
from pycusdr_tpu_torch.ops import viterbi as vit
out = {}
for S, lengths, decode in ((1, [2144], True), (2, [2016, 2015], False), (64, [2144] * 64, True)):
    x = c.viterbi_inputs("soft_pm1", lengths)
    out[f"K7 S={S} ms"] = c.cuda_ms(lambda: vit.viterbi_sweep(
        x, lengths, soft=True, terminated=False, decode=decode))
out["feed host ms"], out["feed plain host ms"] = c.time_feed(blocks=int(sys.argv[1]))
print(json.dumps(out))
"""


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path, help="root of the other checkout")
    args = ap.parse_args()
    trees = {"parent": args.parent.resolve(), "change": HERE}
    for name, root in trees.items():
        if not (root / "chip_smoke.py").is_file():
            raise SystemExit(f"{name}: no chip_smoke.py under {root}")
    print(card_line(), flush=True)
    runs = {name: [] for name in trees}
    for name in ("parent", "change", "change", "parent"):
        p = subprocess.run([sys.executable, "-c", TURN, str(BLOCKS)], cwd=trees[name],
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            sys.stderr.write(p.stdout + p.stderr)
            raise SystemExit(f"{name}: the turn failed with code {p.returncode}")
        runs[name].append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps({"tree": name, **runs[name][-1]}), flush=True)
    for key in runs["parent"][0]:
        old = [r[key] for r in runs["parent"]]
        new = [r[key] for r in runs["change"]]
        print(f"{key}: parent {old} change {new} parent/change "
              f"{min(old) / max(new):.3f}-{max(old) / min(new):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
