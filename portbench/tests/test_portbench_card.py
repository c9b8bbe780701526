"""The benchmark on the card: each cell's run with a short window comes out
correct and prints its result line as the contract sets it, a traced run
reads its per-layer metrics, the control (the reference in TF32 in the
program's place) comes out not correct at the cell's own size, and a
checkout holding only BENCHMARK.json and portbench/ prints no result.

Marked ``cuda``; run on the card with ``python -m pytest portbench/tests -m
cuda``.
"""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

pytestmark = pytest.mark.cuda
CELLS = ["uhf_gfsk.c64", "stx.c64"]


def _run(cwd, cell, seed, trace, seconds=2):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                         cwd=cwd, capture_output=True, text=True, timeout=600)
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_is_correct(cell, trace, card):
    out = _run(ROOT, cell, 2 ** 31 + 99 + trace, trace)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert list(res)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] >= dev["busy_s"]
        for m, v in res["metrics"].items():
            if m.endswith("_roofline"):
                assert 0 < v["value"] <= 100, (m, v)
        assert {"device_ops", "idle_gaps"} <= set(res["breakdown"])
    else:
        assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, card):
    from portbench.harness import cells, check, traffic

    c = cells.load(cell)
    pool = traffic.make_pool(c.conf, c.traffic, 2 ** 31 + 7, card)
    kept = {6 + i: None for i in range(int(c.traffic["checked_calls"]))}
    numbers = check.tally(c, pool, kept, card, control=True).numbers()
    assert not check.verdict(numbers, c.limits), numbers


def test_only_the_benchmark_gives_no_result(tmp_path, card):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "uhf_gfsk.c64", 5, 0, seconds=1)
    assert out.returncode != 0 and out.stdout == ""
