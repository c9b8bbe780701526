"""A cell of ``BENCHMARK.json`` and the data files it is made of, found by
name.

- the configuration: the ``file`` its ``configs`` entry names (a pyCuSDR
  config, with ``source``, ``assumed`` and the rest beside it);
- the traffic mix: ``portbench/traffic/<traffic>.json``, the parameters the
  one generator (``traffic.py``) reads;
- the limits of the comparison: ``portbench/limits/<cell>.json``;
- each per-layer metric: a reader of its own, ``portbench/metrics/<name>.py``,
  with a ``read(ctx)`` that returns the value or None.

A later cell, configuration, mix or metric is new files and new entries in
``BENCHMARK.json``; nothing here names one.
"""

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

#: the root of the checkout: BENCHMARK.json and the portbench/ folder
ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise ValueError(f"not a unit: {unit!r}")
    return unit


@dataclass
class Cell:
    name: str
    chips: int
    conf: dict  # the configuration file's content
    traffic: dict
    limits: dict  # number compared -> limit
    end_to_end: list  # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1
    root: Path


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its data files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = configs[check_name(w["config"])]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in moved]
    for m in e2e + per_layer:
        check_name(m["name"])
        check_unit(m["unit"])
    return Cell(
        name=check_name(name), chips=int(w["chips"]), conf=_json(root / cfg["file"]),
        traffic=_json(root / "portbench" / "traffic" / f"{check_name(w['traffic'])}.json"),
        limits=_json(root / "portbench" / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer, root=root)


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` of the per-layer metric ``metric``."""
    path = root / "portbench" / "metrics" / f"{check_name(metric)}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
