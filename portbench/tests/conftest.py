"""Fixtures of the benchmark's tests: a checkout root holding the benchmark's
cells at the CPU tests' size (Nfft 2^9, four channels, a pool of four
batches), and the card marker.

Run from the root of the repository: ``python -m pytest portbench/tests``
(on the card: ``python -m pytest portbench/tests -m cuda``).
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the benchmark on the card); skipped without one")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's card tests run on the card")
    return torch.device("cuda")


#: the wideband cell the harness drives (``traffic/wb64.json``), which no cell
#: of BENCHMARK.json holds yet: the tests run it at their size
WIDEBAND = {"name": "uhf_gfsk.wb64", "config": "uhf_gfsk", "traffic": "wb64", "chips": 1,
            "why": "the channelizer into the channel-parallel step"}


def shrink(root: Path, dest: Path) -> Path:
    """A copy of ``root``'s benchmark (BENCHMARK.json, configurations, mixes,
    limits, metric readers) cut to the CPU tests' size under ``dest``, with
    the wideband cell added at the first cell's limits."""
    for d in ("configs", "traffic", "limits", "metrics"):
        (dest / "portbench" / d).mkdir(parents=True, exist_ok=True)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    first = bench["workloads"][0]["name"]
    bench["workloads"].append(WIDEBAND)
    shutil.copy(root / "portbench" / "limits" / f"{first}.json",
                dest / "portbench" / "limits" / f"{WIDEBAND['name']}.json")
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        conf = json.loads((root / c["file"]).read_text())
        (gpu,) = conf["GPU"].values()
        (rx,) = conf["Radios"]["Rx"].values()
        gpu.update(blockSize=9, overlap=7)
        rx.update(samplesPerSym=8, frequencyOffset_Hz=9600.0)
        if rx.get("doppCarrierSteps", 1) > 1:
            rx["doppCarrierSteps"] = gpu["doppCarrierSteps"] = 16
        if "Wideband" in conf:
            conf["Wideband"]["M"] = 4
        (dest / c["file"]).write_text(json.dumps(conf))
    for f in (root / "portbench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(checked_calls=2)
        if t["entry"] == "batch":
            t["channels"] = 4
        else:
            t["occupied"] = 2
        if t.get("bursts"):
            t["bursts"].update(per_hop=1, length=4)
        (dest / "portbench" / "traffic" / f.name).write_text(json.dumps(t))
    for d, pat in (("limits", "*.json"), ("metrics", "*.py")):
        for f in (root / "portbench" / d).glob(pat):
            shutil.copy(f, dest / "portbench" / d / f.name)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return shrink(ROOT, tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def workloads():
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
