"""The port's software front end (``pycusdr_tpu_torch/frontend/sim_frontend.py``,
the copy of ``examples/gnuradio/sim_frontend.py``): its bursts equal the
example's on the same seeds (a seeded bench packet, a CC11xx burst through
each package's Tx framer and LUT modulator), and, run as the operator runs
it, it feeds the port's modem (``PyCuSDR`` on the CPU, ``tests/test_sim_frontend.py``
is the model): a noise floor with seeded bench_FSK packets on a LEO
Doppler S-curve, decoded to the seeded bits. And it stops at its duration
with a Tx radio in the config: the example's Tx sink returns on its
context's termination with its socket open, so the example's ``main``
waits in ``Context.term`` for ever; the port's closes it. Ports 19520,
19540-19541 and 19620-19624; every wait is bounded."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import zmq

from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.dsp.signal_gen import packet_data
from pycusdr_tpu_torch.frontend import sim_frontend

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = os.path.join(REPO, "pycusdr_tpu_torch", "config", "configs")
BASE = 19520


def _jax_sim_frontend():
    sys.path.insert(0, os.path.join(REPO, "examples", "gnuradio"))
    try:
        import sim_frontend as example
    finally:
        sys.path.pop(0)
    return example


@pytest.mark.parametrize("config,radio,seed", [
    ("benchmark/bench_FSK.json", None, 1234),
    ("CC11xx.json", "UHF-H", 1234),
    ("CC11xx.json", "UHF-H", 1240),
])
def test_synth_packet_equals_the_example(config, radio, seed):
    from pycusdr_tpu.config.loader import load_modular_json as jax_load

    path = os.path.join(CONFIGS, config)
    conf, jconf = load_modular_json(path), jax_load(path)
    radio = radio or list(conf["Radios"]["Rx"])[0]
    got = sim_frontend.synth_packet(conf, radio, 48, seed)
    want = _jax_sim_frontend().synth_packet(jconf, radio, 48, seed)
    assert got.dtype == want.dtype == np.complex64 and len(got) > 1000
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def sim_conf(tmp_path):
    conf = load_modular_json(os.path.join(CONFIGS, "benchmark", "bench_FSK.json"))
    conf["Main"]["PacketLen"] = 4000
    rx = conf["Radios"]["Rx"]
    name = list(rx)[0]
    conf["Radios"]["Rx"] = {name: rx[name]}
    rx[name]["Interfaces"] = {
        "RxInPort": f"tcp://127.0.0.1:{BASE}",
        "demodOut": f"tcp://localhost:{BASE + 100}",
    }
    conf["Interfaces"]["Internal"].update({
        "demodIn": f"tcp://*:{BASE + 100}",
        "demodOut": f"tcp://localhost:{BASE + 100}",
        "decodeOut": f"tcp://localhost:{BASE + 101}",
        "decodeIn": f"tcp://*:{BASE + 101}",
    })
    conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"] = {"UHF": f"tcp://*:{BASE + 102}"}
    conf["Interfaces"]["External"]["XMLRpcIn"] = f"127.0.0.1:{BASE + 103}"
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=BASE + 104)
    p = tmp_path / "sim_conf.json"
    p.write_text(json.dumps(conf))
    return conf, str(p)


def test_sim_frontend_feeds_the_modem(sim_conf, monkeypatch):
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

    conf, conf_path = sim_conf
    sdr = PyCuSDR(dict(conf), args=None)
    sdr.start()
    ctx = zmq.Context()
    sink = ctx.socket(zmq.PULL)
    sink.connect(f"tcp://localhost:{BASE + 102}")
    sink.setsockopt(zmq.RCVTIMEO, 500)

    fe = threading.Thread(
        target=sim_frontend.main,
        args=(["-c", conf_path, "--snr", "15", "--interval", "5",
               "--duration", "30", "--doppler-max", "300",
               "--pass-duration", "110"],),
        daemon=True,
    )
    try:
        fe.start()
        got = []
        deadline = time.time() + 45
        while time.time() < deadline and not got:
            try:
                got.append(sink.recv())
            except zmq.error.Again:
                continue
        assert got, "modem decoded nothing from the simulated front-end"
        # bench packets: payload is the seeded bit sequence, one byte/bit
        bits = np.frombuffer(got[0], np.uint8)
        truth = packet_data(conf["Main"]["PacketLen"], 123)
        n = min(len(bits), len(truth))
        assert n > 3000
        assert np.mean(bits[:n] == truth[:n]) > 0.999
    finally:
        fe.join(timeout=45)
        sdr.terminate()
        sink.close()
        ctx.term()


def test_front_end_stops_at_its_duration(tmp_path):
    """CC11xx.json's Tx radio gives the front end a Tx sink (nothing binds
    its port here): ``main`` returns within seconds of ``--duration``."""
    from pycusdr_tpu_torch.bench.streaming_rt import _build_conf

    path = tmp_path / "cc11xx.json"
    path.write_text(json.dumps(_build_conf(19540, 2)))
    fe = threading.Thread(target=sim_frontend.main, args=(["-c", str(path), "--duration", "2"],),
                          daemon=True)
    t0 = time.time()
    fe.start()
    fe.join(timeout=30)
    assert not fe.is_alive(), "the front end did not return after its duration"
    assert time.time() - t0 < 20
