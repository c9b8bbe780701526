"""BENCHMARK.json and its data files: the contract's shape, discovery of
cells, mixes, limits and metric readers by name, the characters names and
units may hold, and a cell, configuration, mix and metric added as new files
and entries alone."""

import json
import re
import shutil

import pytest

from conftest import ROOT
from portbench.harness import cells

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == TOP
    assert BENCH["paths"] == ["portbench"] and not BENCH["paths"][0].endswith("_torch")
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] == "msps" and LINE.match(m["layer"])
    assert [m["name"] for m in BENCH["end_to_end"]] == ["msps", "call_p95_ms", "setup_s"]


def test_names_are_unique_and_legal():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for n in names:
            cells.check_name(n)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        cells.check_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", "é", "-x", "x" * 65])
def test_bad_names_are_refused(bad):
    with pytest.raises(ValueError):
        cells.check_name(bad)


@pytest.mark.parametrize("bad", ["", "tokens per second", "µs", "x" * 17])
def test_bad_units_are_refused(bad):
    with pytest.raises(ValueError):
        cells.check_unit(bad)


def test_every_cell_finds_its_files(workloads):
    assert workloads == ["uhf_gfsk.c64", "stx.c64"]
    for name in workloads:
        cell = cells.load(name)
        assert cell.traffic["entry"] in ("batch", "wideband")
        assert set(cell.limits) == {"decisions", "analog"}
        assert {m["name"] for m in cell.end_to_end} == {"msps", "call_p95_ms", "setup_s"}
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))
    rooflines = {n: {m["name"] for m in cells.load(n).per_layer if "roofline" in m["name"]}
                 for n in workloads}
    assert rooflines == {
        "uhf_gfsk.c64": {"mask_bank_roofline", "doppler_roofline"},
        "stx.c64": {"mask_bank_roofline", "clip_roofline"}}


def test_the_wideband_cell_is_found_at_the_tests_size(tiny_root):
    cell = cells.load("uhf_gfsk.wb64", tiny_root)
    assert cell.traffic["entry"] == "wideband" and cell.conf["Wideband"]["M"] == 4
    assert {m["name"] for m in cell.per_layer if "roofline" in m["name"]} == \
        {"mask_bank_roofline"}


def test_unknown_cell_is_refused():
    with pytest.raises(ValueError):
        cells.load("uhf_gfsk.nope")


def test_a_cell_config_mix_and_metric_from_new_files_alone(tmp_path):
    """What a later change adds: a configuration file, a mix, a limits file,
    a metric reader and their BENCHMARK.json entries; no existing file of
    the benchmark is edited, and the harness finds them by name."""
    root = tmp_path
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((ROOT / "portbench/configs/uhf_gfsk.json").read_text())
    conf["GPU"]["UHF"]["blockSize"] = 15
    (root / "portbench/configs/uhf_gfsk_b15.json").write_text(json.dumps(conf))
    (root / "portbench/traffic/c8.json").write_text(json.dumps(
        {"entry": "batch", "channels": 8, "snr_db": [0.0, 9.0], "range_rate_mps": [0.0, 0.0],
         "bursts": None, "pool_bytes": 1000, "checked_calls": 2}))
    (root / "portbench/limits/uhf_gfsk_b15.c8.json").write_text('{"decisions": 1, "analog": 1}')
    (root / "portbench/metrics/calls_per_s.py").write_text(
        "def read(r):\n    return r.window.calls / r.window.seconds\n")
    bench["configs"].append({"name": "uhf_gfsk_b15", "source": "x",
                             "file": "portbench/configs/uhf_gfsk_b15.json",
                             "reduced": ["GPU"], "why": "y"})
    bench["workloads"].append({"name": "uhf_gfsk_b15.c8", "config": "uhf_gfsk_b15",
                               "traffic": "c8", "chips": 1, "why": "z"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "source": "host_clock", "layer": "host dispatch",
                               "moves": "msps", "workloads": ["uhf_gfsk_b15.c8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load("uhf_gfsk_b15.c8", root)
    assert cell.conf["GPU"]["UHF"]["blockSize"] == 15 and cell.traffic["channels"] == 8
    assert "calls_per_s" in [m["name"] for m in cell.per_layer]
    assert "calls_per_s" not in [m["name"] for m in cells.load("uhf_gfsk.c64", root).per_layer]

    class W:
        calls, seconds = 30, 2.0

    assert cells.reader("calls_per_s", root)(type("R", (), {"window": W})) == 15.0
    assert all(p.read_bytes() == b for p, b in before.items())
