"""The PyTorch port stands alone: importing every module of
``pycusdr_tpu_torch`` and the module-level code of ``chip_smoke.py``
loads neither ``jax`` nor the JAX package, and its CUDA entry points
raise without a card instead of running on the CPU. Each check runs in
a fresh interpreter (this test process has JAX loaded already)."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import pycusdr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pycusdr_tpu_torch.__path__, "pycusdr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib" or n.startswith("jaxlib.")
             or n == "pycusdr_tpu" or n.startswith("pycusdr_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""

NO_CARD = r"""
import json, numpy as np, torch
from pycusdr_tpu_torch.configs import RADIO, ccsds_conf, tiny_conf, tiny_spec
from pycusdr_tpu_torch.decode import Decoder
from pycusdr_tpu_torch.dsp.block import build_process_block
from pycusdr_tpu_torch.models import UHF
from pycusdr_tpu_torch.ops.viterbi import ViterbiStream, viterbi_decode
from pycusdr_tpu_torch.protocol import loadProtocol
assert not torch.cuda.is_available()
raised = []
conf = tiny_conf()
ccsds = loadProtocol("ccsds_conv")(conf=ccsds_conf())
for make in (lambda: build_process_block(tiny_spec()),
             lambda: build_process_block(tiny_spec(), device="cuda"),
             lambda: UHF.Demodulator(conf, loadProtocol("bench_GFSK")(conf=conf), RADIO),
             lambda: viterbi_decode(np.zeros(64)),
             lambda: ViterbiStream(),
             lambda: Decoder({}, ccsds).findFrames(np.zeros(100, np.uint8), 0)):
    try:
        make()
    except RuntimeError as e:
        raised.append("no CUDA device" in str(e))
print(json.dumps({"raised": raised}))
"""


def _run(code: str) -> dict:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
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
                 "pycusdr_tpu_torch.tx.modulator", "pycusdr_tpu_torch.tx.encoders"):
        assert name in res["modules"]


def test_cuda_entry_points_raise_without_a_card():
    assert _run(NO_CARD)["raised"] == [True] * 6

