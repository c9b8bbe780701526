"""The PyTorch port stands alone: importing every module of
``pycusdr_tpu_torch`` (the runtime, the RPC server and the config loader
among them), the module-level code of ``chip_smoke.py`` and
``chip_k9_phases.py`` and running
``python -m pycusdr_tpu_torch --help``, ``python -m
pycusdr_tpu_torch.control.hamlib_daemon --help`` and each station harness's
and the software front end's ``--help`` load neither ``jax`` nor the JAX
package, and its CUDA entry points, the CLI and the harnesses included,
raise without a card instead of running on the CPU. Each check runs in a fresh
interpreter (this test process has JAX loaded already)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import pycusdr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pycusdr_tpu_torch.__path__, "pycusdr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import chip_k9_phases
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib" or n.startswith("jaxlib.")
             or n == "pycusdr_tpu" or n.startswith("pycusdr_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""

CLI_HELP = r"""
import json, runpy, sys
sys.argv = ["pycusdr_tpu_torch", "--help"]
try:
    runpy.run_module("pycusdr_tpu_torch", run_name="__main__")
except SystemExit as e:
    code = e.code
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib" or n.startswith("jaxlib.")
             or n == "pycusdr_tpu" or n.startswith("pycusdr_tpu."))
cli = "pycusdr_tpu_torch.runtime.cli" in sys.modules
print(json.dumps({"code": code, "bad": bad, "runtime": cli}))
"""

DAEMON_HELP = r"""
import json, runpy, sys
sys.argv = ["hamlib_daemon", "--help"]
try:
    runpy.run_module("pycusdr_tpu_torch.control.hamlib_daemon", run_name="__main__")
except SystemExit as e:
    code = e.code
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib" or n.startswith("jaxlib.")
             or n == "pycusdr_tpu" or n.startswith("pycusdr_tpu."))
print(json.dumps({"code": code, "bad": bad}))
"""

NO_CARD = r"""
import json, numpy as np, torch
from pycusdr_tpu_torch.configs import RADIO, ccsds_conf, tiny_conf, tiny_spec
from pycusdr_tpu_torch.decode import Decoder
from pycusdr_tpu_torch.dsp.block import build_process_block
from pycusdr_tpu_torch.models import UHF, DopplerTracker
from pycusdr_tpu_torch.parallel import (Channelizer, build_sharded_demod_step,
                                        build_time_sharded_stream, make_global_mesh, make_mesh)
from pycusdr_tpu_torch.ops.viterbi import ViterbiStream, viterbi_decode
from pycusdr_tpu_torch.protocol import loadProtocol
from pycusdr_tpu_torch.runtime.channel_group_process import build_group_graph
from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR
assert not torch.cuda.is_available()
raised = []
conf = tiny_conf()
ccsds = loadProtocol("ccsds_conv")(conf=ccsds_conf())
for make in (lambda: build_process_block(tiny_spec()),
             lambda: build_process_block(tiny_spec(), device="cuda"),
             lambda: UHF.Demodulator(conf, loadProtocol("bench_GFSK")(conf=conf), RADIO),
             lambda: viterbi_decode(np.zeros(64)),
             lambda: ViterbiStream(),
             lambda: Decoder({}, ccsds).findFrames(np.zeros(100, np.uint8), 0),
             lambda: build_group_graph(tiny_spec(), 3, 1.2),
             lambda: PyCuSDR(dict(conf, Interfaces={})),
             lambda: Channelizer(64),
             lambda: DopplerTracker(spec=tiny_spec()),
             lambda: make_mesh({"channel": 1, "dopp": 1}),
             lambda: build_sharded_demod_step(tiny_spec(), make_mesh({"channel": 1})),
             lambda: build_time_sharded_stream(tiny_spec(), make_mesh({"time": 1})),
             lambda: build_sharded_demod_step(tiny_spec(), make_global_mesh(),
                                              force_generic=True)):
    try:
        make()
    except RuntimeError as e:
        raised.append("no CUDA device" in str(e))
print(json.dumps({"raised": raised}))
"""


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    env.pop("PYCUSDR_TORCH_DEVICE", None)
    return env


def _run(code: str) -> dict:
    env = _env()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax():
    res = _run(IMPORT_ALL)
    assert res["bad"] == []
    for name in ("pycusdr_tpu_torch.ops.demod_kernels", "pycusdr_tpu_torch.models.demodulator",
                 "pycusdr_tpu_torch.dsp.block", "pycusdr_tpu_torch.convert",
                 "pycusdr_tpu_torch.ops.viterbi", "pycusdr_tpu_torch.decode.frame_finder",
                 "pycusdr_tpu_torch.decode.rs", "pycusdr_tpu_torch.protocol.ccsds",
                 "pycusdr_tpu_torch.tx.modulator", "pycusdr_tpu_torch.tx.encoders",
                 "pycusdr_tpu_torch.parallel.vote", "pycusdr_tpu_torch.runtime.orchestrator",
                 "pycusdr_tpu_torch.runtime.demodulator_process",
                 "pycusdr_tpu_torch.runtime.channel_group_process",
                 "pycusdr_tpu_torch.runtime.decoder_process", "pycusdr_tpu_torch.runtime.sigfifo",
                 "pycusdr_tpu_torch.runtime.pipeline", "pycusdr_tpu_torch.runtime.cli",
                 "pycusdr_tpu_torch.__main__", "pycusdr_tpu_torch.control.rpc",
                 "pycusdr_tpu_torch.config.loader", "pycusdr_tpu_torch.obs.stats",
                 "pycusdr_tpu_torch.parallel.channelizer", "pycusdr_tpu_torch.parallel.mesh",
                 "pycusdr_tpu_torch.parallel.sharded_demod", "pycusdr_tpu_torch.parallel.halo",
                 "pycusdr_tpu_torch.models.tracking", "pycusdr_tpu_torch.parallel.collectives",
                 "pycusdr_tpu_torch.parallel.multihost", "pycusdr_tpu_torch.utils.xcorr",
                 "pycusdr_tpu_torch.utils.device_info", "pycusdr_tpu_torch.obs.profiling",
                 "pycusdr_tpu_torch.protocol.cc11xx", "pycusdr_tpu_torch.protocol.ax25",
                 "pycusdr_tpu_torch.protocol.gfsk2",
                 "pycusdr_tpu_torch.protocol.benchmark.bench_gmsk",
                 "pycusdr_tpu_torch.runtime.modulator_process", "pycusdr_tpu_torch.utils.gmsk",
                 "pycusdr_tpu_torch.utils.binops", "pycusdr_tpu_torch.utils.doppler",
                 "pycusdr_tpu_torch.combine", "pycusdr_tpu_torch.combine.votes",
                 "pycusdr_tpu_torch.combine.aligner", "pycusdr_tpu_torch.combine.worker",
                 "pycusdr_tpu_torch.combine.combiner", "pycusdr_tpu_torch.control.rig_server",
                 "pycusdr_tpu_torch.control.dummy_radios",
                 "pycusdr_tpu_torch.control.hamlib_daemon"):
        assert name in res["modules"]


def test_cuda_entry_points_raise_without_a_card():
    assert _run(NO_CARD)["raised"] == [True] * 14


def test_cli_help_imports_no_jax():
    res = _run(CLI_HELP)
    assert res == {"code": 0, "bad": [], "runtime": True}


def test_hamlib_daemon_entry_imports_no_jax():
    """``python -m pycusdr_tpu_torch.control.hamlib_daemon`` (the hamlib
    daemon that boots the port's modem per gpredict connection) loads
    neither ``jax`` nor the JAX package."""
    assert _run(DAEMON_HELP) == {"code": 0, "bad": []}


def test_cli_raises_without_a_card():
    """``python -m pycusdr_tpu_torch -c <config>`` runs on the card by
    default: without one (and without ``--device cpu``) it stops with the
    error before any child starts."""
    conf = REPO / "pycusdr_tpu_torch" / "config" / "configs" / "benchmark" / "bench_FSK.json"
    out = subprocess.run([sys.executable, "-m", "pycusdr_tpu_torch", "-c", str(conf)],
                         cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr



def test_cc11xx_cli_raises_without_a_card():
    """The station's operational entry point (``CC11xx.json``, a Tx and an
    Rx radio) stops with the same error before any child starts."""
    conf = REPO / "pycusdr_tpu_torch" / "config" / "configs" / "CC11xx.json"
    out = subprocess.run([sys.executable, "-m", "pycusdr_tpu_torch", "-c", str(conf)],
                         cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr


HARNESSES = ("hw_selfcheck", "ber", "ber_delta", "diversity", "streaming_rt")
#: the timing harnesses
TIMERS = ("profile_stages", "subsystems", "capture_probe", "scaling", "hw_leak_probe")

HARNESS_HELP = r"""
import json, runpy, sys
name = sys.argv[1]
sys.argv = [name, "--help"]
try:
    runpy.run_module(name, run_name="__main__")
except SystemExit as e:
    code = e.code
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib" or n.startswith("jaxlib.")
             or n == "pycusdr_tpu" or n.startswith("pycusdr_tpu."))
print(json.dumps({"code": code, "bad": bad}))
"""

HARNESS_NO_CARD = r"""
import json, os, tempfile
from pycusdr_tpu_torch.bench import ber, ber_delta, diversity, hw_selfcheck, streaming_rt
tmp = set(os.listdir(tempfile.gettempdir()))
raised = []
for call in (lambda: hw_selfcheck.run_selfcheck(out=lambda line: None),
             lambda: hw_selfcheck.main([]),
             lambda: ber_delta.run_delta(("FSK",), [10.0], 1, packetLen=200, blockSize=9,
                                         verbose=False),
             lambda: ber.run_ber_sweep("FSK", 1, [18.0], packetLen=200, basePort=19990),
             lambda: diversity.run_diversity("FSK", (18.0,), 1, packetLen=200, basePort=19990,
                                             verbose=False),
             lambda: streaming_rt.run_point(1.0, 3.0, basePort=19990, verbose=False)):
    try:
        call()
        raised.append(False)
    except RuntimeError as e:
        raised.append("no CUDA device" in str(e))
print(json.dumps({"raised": raised,
                  "files_left": sorted(set(os.listdir(tempfile.gettempdir())) - tmp)}))
"""


def test_new_modules_load_without_jax():
    """The numpy golden, the software front end, the station harnesses and
    the timing harnesses are among the modules ``test_port_imports_no_jax``
    loads without ``jax`` or the JAX package."""
    res = _run(IMPORT_ALL)
    assert res["bad"] == []
    for name in ("pycusdr_tpu_torch.dsp.reference", "pycusdr_tpu_torch.frontend.sim_frontend",
                 "pycusdr_tpu_torch.bench") + tuple(f"pycusdr_tpu_torch.bench.{h}"
                                                    for h in HARNESSES + TIMERS):
        assert name in res["modules"], name


@pytest.mark.parametrize("name", [f"pycusdr_tpu_torch.bench.{h}" for h in HARNESSES]
                         + ["pycusdr_tpu_torch.frontend.sim_frontend"]
                         + [f"pycusdr_tpu_torch.bench.{h}" for h in TIMERS])
def test_harness_help_imports_no_jax(name):
    """``python -m <harness> --help`` in a fresh interpreter loads neither
    ``jax`` nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", HARNESS_HELP, name], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"code": 0, "bad": []}


def test_harness_entry_points_raise_without_a_card():
    """Each harness runs on the card by default: without one (and without
    the CPU asked for) it raises before it starts a child, binds a port or
    writes a file."""
    res = _run(HARNESS_NO_CARD)
    assert res == {"raised": [True] * 6, "files_left": []}


TIMERS_NO_CARD = r"""
import json, os, tempfile
from pycusdr_tpu_torch.bench import capture_probe, hw_leak_probe, profile_stages, scaling, subsystems
from pycusdr_tpu_torch.configs import tiny_spec
tmp = set(os.listdir(tempfile.gettempdir()))
raised = []
for call in (lambda: profile_stages.run_profile((1,), 1, spec=tiny_spec()),
             lambda: profile_stages.main(["--spec", "tiny", "--batches", "1"]),
             lambda: profile_stages.cuda_ms(lambda: None),
             lambda: subsystems.channelizer_bench(M=8, taps_per_branch=4, n_samples=1024),
             lambda: subsystems.tracking_bench(tiny_spec(), n_blocks=4),
             lambda: subsystems.main(["--spec", "tiny"]),
             lambda: capture_probe.run_probe(K=2, spec=tiny_spec()),
             lambda: capture_probe.main(["--spec", "tiny"]),
             lambda: scaling.sharded_per_chip_msps(tiny_spec(), n_channels=2),
             lambda: scaling.run_scaling((1, 2), tiny_spec(), port=19940),
             lambda: scaling.main(["--per-chip"]),
             lambda: hw_leak_probe.run_probes(2, spec=tiny_spec()),
             lambda: hw_leak_probe.main(["--iters", "2"])):
    try:
        call()
        raised.append(False)
    except RuntimeError as e:
        raised.append("no CUDA device" in str(e))
print(json.dumps({"raised": raised,
                  "files_left": sorted(set(os.listdir(tempfile.gettempdir())) - tmp)}))
"""


def test_timing_harnesses_raise_without_a_card():
    """The timing harnesses and their timer run on the card by default:
    without one (and without the CPU asked for) each raises before it
    measures, spawns a rank or writes a file."""
    res = _run(TIMERS_NO_CARD)
    assert res == {"raised": [True] * 13, "files_left": []}
