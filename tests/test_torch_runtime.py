"""The port's process pipeline (``pycusdr_tpu_torch.runtime``) on the CPU:
the ring buffer, the SigFIFO's re-blocking, the in-flight queue and the
config loader against the JAX package's copies on the same inputs, the
config keys the port once refused (a Tx radio, the softCombiner, planned
restarts and telegraf metrics: each builds a station, and the last two
decode a packet), and
``PyCuSDR`` end to end over real ZMQ with ``PYCUSDR_TORCH_DEVICE=cpu``:
one radio through a ``Demodulator_process``, and two clock-shared radios
through the lockstep channel group at pipeline depths 1 and 2 (cf. ``tests/test_runtime.py`` and
``tests/test_channel_group.py``).

Every socket lives on ports 16000-16499: below the kernel's ephemeral
range (Linux's default, 32768-60999), so no outgoing connection of a
concurrent test can hold one of them as its local port, and apart from
the ports of the JAX package's tests (20003-37560) and of
``tests/test_torch_multihost.py`` (16500-16999); the built, unstarted
softCombiner and Tx stations' RPC servers bind 18800 and 18801, in the
range of the combiner's and the hamlib daemon's tests (18500-18999), and
the stations with a cap or telegraf use 19000-19034, in the range of the
planned restarts' tests (19000-19299). Warming the
children and decoding have deadlines of their own, a failure names the
flag or socket that failed, the children are daemons that
``PyCuSDR.terminate`` stops, terminates and joins with timeouts, and
sockets close with LINGER 0."""

import os
import time
import xmlrpc.client

import numpy as np
import pytest
import zmq

from pycusdr_tpu.config.loader import load_modular_json as jax_load_modular_json
from pycusdr_tpu.runtime.pipeline import InflightPipeline as JaxInflightPipeline
from pycusdr_tpu.runtime.sigfifo import RingBuffer as JaxRingBuffer
from pycusdr_tpu.runtime.sigfifo import SigFIFO as JaxSigFIFO
from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.dsp.signal_gen import awgn, get_padded_packet, packet_data
from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR
from pycusdr_tpu_torch.runtime.pipeline import InflightPipeline
from pycusdr_tpu_torch.runtime.sigfifo import RingBuffer, SigFIFO
from pycusdr_tpu_torch.utils.logger import shutdown_logging

REPO = os.path.join(os.path.dirname(__file__), "..")
CONF_DIR = os.path.join(REPO, "pycusdr_tpu_torch", "config", "configs")
JAX_CONF_DIR = os.path.join(REPO, "pycusdr_tpu", "config", "configs")
CONFIGS = ["base.json", "CC11xx.json", "hamlib_sockets.json"] + [
    os.path.join("benchmark", n) for n in (
        "bench_base.json", "bench_FSK.json", "bench_GFSK.json", "bench_GMSK.json",
        "bench_BPSK.json", "bench_3_chan_rx.json")]
WARM_S = 60.0  # bound on the wait for the children to warm and the decoder to bind
DECODE_S = 60.0  # bound on the feed until decoded bytes arrive
HOP = 2**13 - 2**10

# (outLen, bufLen, operations): ("i", n) inserts the next n samples, ("p", n) pops n
RING_CASES = {
    "reblock": (100, 1000, [("i", 130), ("p", 100), ("p", 100), ("i", 120), ("p", 100)]),
    "wraparound": (64, 100, [op for _ in range(10) for op in (("i", 64), ("p", 64))]),
    "overflow": (10, 20, [("i", 15), ("i", 15), ("p", 10), ("p", 10)]),
    "oversize_chunk": (8, 16, [("i", 5), ("i", 40), ("p", 8), ("p", 8), ("p", 8)]),
    "ragged": (7, 30, [("i", 3), ("i", 11), ("p", 7), ("i", 13), ("p", 7), ("p", 7), ("i", 9),
                       ("p", 7), ("p", 7)]),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_buffer_matches_jax(case):
    outLen, bufLen, ops = RING_CASES[case]
    rings = (RingBuffer(outLen, bufLen=bufLen), JaxRingBuffer(outLen, bufLen=bufLen))
    pos = 0
    for op, n in ops:
        if op == "i":
            data = np.arange(pos, pos + n).astype(np.complex64)
            pos += n
            sizes = [r.insert(data) for r in rings]
            assert sizes[0] == sizes[1]
        else:
            a, b = (np.asarray(r.popBlock(n)) for r in rings)
            np.testing.assert_array_equal(a, b)
        assert [(r.headIdx, r.tailIdx, r.currentBufSize) for r in rings[:1]] == \
            [(r.headIdx, r.tailIdx, r.currentBufSize) for r in rings[1:]]


def test_sigfifo_reblocking_matches_jax():
    """One PUB feed, both SigFIFOs subscribed: chunks of ragged sizes come
    out as the same hops, with the same idle() answers."""
    ctx = zmq.Context()
    pub = ctx.socket(zmq.PUB)
    pub.setsockopt(zmq.LINGER, 0)
    pub.bind("tcp://127.0.0.1:16010")
    kw = dict(dtype=np.complex64, timeOut_ms=200, enableTimeoutException=True,
              timeoutRetries=25)
    port = SigFIFO("tcp://127.0.0.1:16010", 100, **kw)
    jax = JaxSigFIFO("tcp://127.0.0.1:16010", 100, **kw)
    try:
        time.sleep(0.5)  # let both SUB sockets connect
        sizes = [37, 90, 100, 13, 160, 55, 45]
        data = np.arange(sum(sizes)).astype(np.complex64)
        pos = 0
        for n in sizes:
            pub.send(data[pos:pos + n].tobytes())
            pos += n
        time.sleep(0.2)
        out = {}
        for name, f in (("port", port), ("jax", jax)):
            hops = [f.getBlock()] + f.getBlocks(3) + f.getBlocks(1)
            out[name] = (np.concatenate(hops), f.idle(), f.buf.currentBufSize)
        np.testing.assert_array_equal(out["port"][0], out["jax"][0])
        np.testing.assert_array_equal(out["port"][0], data[:500])
        assert out["port"][1:] == out["jax"][1:] == (True, 0)
    finally:
        port.close()
        jax.socket.close(linger=0)
        pub.close()
        ctx.term()


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_inflight_pipeline_matches_jax(depth):
    emitted = {"port": [], "jax": []}
    pipes = {"port": InflightPipeline(depth, lambda *a: emitted["port"].append(a)),
             "jax": JaxInflightPipeline(depth, lambda *a: emitted["jax"].append(a))}
    for i in range(7):
        for name, p in pipes.items():
            p.push(i, f"t{i}")
            if i == 4:
                p.flush()
        assert len(pipes["port"]) == len(pipes["jax"])
        assert emitted["port"] == emitted["jax"]
    for p in pipes.values():
        p.flush()
    assert emitted["port"] == emitted["jax"] == [(i, f"t{i}") for i in range(7)]


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_load_as_in_jax(name):
    assert load_modular_json(os.path.join(CONF_DIR, name)) == \
        jax_load_modular_json(os.path.join(JAX_CONF_DIR, name))


@pytest.mark.parametrize("key,value", [
    ("Tx", {"UHF": {"Protocol": "UHF"}}),
    ("softCombiner_enabled", True),
    ("maxWorkerRssMb", 2000),
    ("telegraf_ip", "127.0.0.1"),
])
def test_config_keys_build_and_run(key, value, monkeypatch):
    """Every key the port once refused builds a station: a Tx radio (one
    ``Modulator_process``), ``bench_3_chan_rx.json`` as shipped
    (``softCombiner_enabled`` with three radios: a ``SoftCombiner`` task
    that the RPC server asks), and, on one bench_FSK radio, a cap of 2000
    MB (the maintenance thread runs and restarts nothing: no child comes
    near it) and a telegraf address (without the ``telegraf`` package,
    as the JAX decoder, it exports nothing): both decode the payload."""
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    if key in ("Tx", "softCombiner_enabled"):
        conf = load_modular_json(os.path.join(CONF_DIR, "benchmark", "bench_3_chan_rx.json"))
        conf["Main"]["softCombiner_enabled"] = key == "softCombiner_enabled"
        rpc_port = 18800
        if key == "Tx":
            tx = load_modular_json(os.path.join(CONF_DIR, "CC11xx.json"))["Radios"]["Tx"]["UHF"]
            conf["Radios"]["Tx"] = {"UHF": dict(tx, **value["UHF"])}
            rpc_port = 18801
        conf["Interfaces"]["External"]["XMLRpcIn"] = f"127.0.0.1:{rpc_port}"
        sdr = PyCuSDR(conf, args=None)  # built, not started
        assert len(sdr.demodulators) == 3
        if key == "Tx":
            assert [type(m).__name__ for m in sdr.modulators] == ["Modulator_process"]
            assert sdr.modulators[0] in sdr.tasks and sdr.combiner is None
        else:
            assert type(sdr.combiner).__name__ == "SoftCombiner"
            assert sdr.combiner in sdr.tasks and sdr.rpcInt.softCombiner is sdr.combiner
            # a restart rebuilds the combiner from its factory and swaps it in
            i = sdr.tasks.index(sdr.combiner)
            new = sdr._task_factories[i]()
            sdr._replace_task(i, sdr.combiner, new)
            assert sdr.tasks[i] is new and sdr.combiner is new and sdr.rpcInt.softCombiner is new
        sdr.rpcInt.terminate()
        sdr.rpcInt.join(timeout=10)
        shutdown_logging()
        return
    port0 = 19000 if key == "maxWorkerRssMb" else 19020
    conf = _conf(port0)
    conf["Main"][key] = value

    def check(sdr):
        if key == "maxWorkerRssMb":
            assert sdr._maint_thread is not None and sdr._maint_thread.is_alive()
            assert sdr._max_rss_mb == value and not sdr._rss_restart_at
            assert sdr.demodulators[0].workerId == "rt-UHF0"

    payload, expected = _run_pipeline(conf, port0, 1, check=check)
    assert payload == expected


def _conf(port0, radios=("UHF-H",), depth=1):
    conf = load_modular_json(os.path.join(CONF_DIR, "benchmark", "bench_FSK.json"))
    conf["Main"].update(workerId="rt", PacketLen=1000, channelGroup_enabled=len(radios) > 1,
                        statsFolder=os.path.join("build", "test_stats"))
    conf["GPU"]["UHF"].update(blockSize=13, overlap=10)
    conf["GPU"]["UHF"]["TPU"]["pipelineDepth"] = depth
    base = conf["Radios"]["Rx"]["UHF-H"]
    conf["Radios"]["Rx"] = {
        r: dict(base, name=f"UHF{i}", doppCarrierSteps=16,
                Interfaces={"RxInPort": f"tcp://127.0.0.1:{port0 + i}",
                            "demodOut": f"tcp://localhost:{port0 + 10}"})
        for i, r in enumerate(radios)}
    conf["Demodulator"] = {"timeoutSeconds": 60}
    conf["Interfaces"]["Internal"].update({
        "demodIn": f"tcp://*:{port0 + 10}", "demodOut": f"tcp://localhost:{port0 + 10}",
        "decodeOut": f"tcp://localhost:{port0 + 11}", "decodeIn": f"tcp://*:{port0 + 11}"})
    conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"] = {"UHF": f"tcp://*:{port0 + 12}"}
    conf["Interfaces"]["External"]["XMLRpcIn"] = f"127.0.0.1:{port0 + 13}"
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=port0 + 14)
    return conf


def _run_pipeline(conf, port0, n_rx, check=None):
    """Start ``PyCuSDR``, wait (bounded) until its Rx children are warm,
    PUBlish a 1000-bit bench_FSK packet at 14 dB (independent noise per
    antenna) until decoded bytes arrive; returns (payload, expected)."""
    bits = packet_data(1000, 123)
    sig, _ = get_padded_packet("FSK", 16, 9600 * 16, offset_freq=38400, raw_bits=bits,
                               pad=6000)
    stream = np.r_[sig, np.zeros(6 * HOP, np.complex64)]
    ctx = zmq.Context()
    pubs = []
    for i in range(n_rx):
        s = ctx.socket(zmq.PUB)
        s.setsockopt(zmq.LINGER, 0)
        s.bind(f"tcp://127.0.0.1:{port0 + i}")
        pubs.append(s)
    sink = ctx.socket(zmq.PULL)
    sink.setsockopt(zmq.LINGER, 0)
    sink.setsockopt(zmq.RCVTIMEO, 1500)
    sdr = PyCuSDR(conf, args=None)
    sdr.start()
    try:
        t0 = time.time()
        flags = {f"{type(d).__name__}[{i}].warmedFlag": d.warmedFlag
                 for i, d in enumerate(sdr.demodulators)}
        flags["Decoder.boundFlag"] = sdr.dec.boundFlag
        while time.time() < t0 + WARM_S and not all(f.is_set() for f in flags.values()):
            dead = [getattr(t, "name", str(t)) for t in sdr.tasks if not t.is_alive()]
            assert not dead, f"children {dead} died while warming"
            time.sleep(0.2)
        unset = [k for k, f in flags.items() if not f.is_set()]
        assert not unset, f"{unset} not set within {WARM_S} s"
        assert [d.device for d in sdr.demodulators] == ["cpu"] * len(sdr.demodulators)
        # connect once the decoder has bound its PUSH socket
        sink.connect(f"tcp://localhost:{port0 + 12}")
        time.sleep(0.5)  # let the SUB sockets connect
        rng = np.random.RandomState(5)
        payload = None
        rounds, t1 = 0, time.time()
        while payload is None and time.time() < t1 + DECODE_S:
            rounds += 1
            chans = [awgn(stream, 14.0, rng=rng).astype(np.complex64) for _ in pubs]
            for pos in range(0, len(stream) - HOP, HOP):
                for s, c in zip(pubs, chans):
                    s.send(c[pos:pos + HOP].tobytes())
                time.sleep(0.02)
            try:
                payload = sink.recv()
            except zmq.error.Again:
                continue
        assert payload is not None, (
            f"no decoded bytes on the PULL socket tcp://localhost:{port0 + 12} after {rounds} "
            f"feeds of the packet to {[f'tcp://127.0.0.1:{port0 + i}' for i in range(n_rx)]} "
            f"within {DECODE_S} s (children warm after {t1 - t0:.1f} s)")
        if check is not None:
            check(sdr)
        expected = bytes(bytearray(sdr.protocols["UHF"].Packet(bits).getBinaryData()[0]))
        return payload, expected
    finally:
        sdr.terminate()
        assert not any(t.is_alive() for t in sdr.tasks), "a child outlived terminate()"
        for s in pubs + [sink]:
            s.close()
        ctx.term()


def test_single_radio_pipeline(monkeypatch):
    """PUB IQ -> Demodulator_process -> Decoder -> the payload's bytes on
    the external PULL socket; the RPC server answers while it runs."""
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    port0 = 16100

    def rpc(sdr):
        proxy = xmlrpc.client.ServerProxy(f"http://127.0.0.1:{port0 + 13}/RPC2")
        assert proxy.get_Rx_antenna_name(0) == "rt-UHF0"
        assert isinstance(proxy.get_Rx_SNR(0), float)

    conf = _conf(port0)
    payload, expected = _run_pipeline(conf, port0, 1, check=rpc)
    assert payload is not None, "no decoded packet emerged from the modem"
    assert payload == expected


@pytest.mark.parametrize("depth", [1, 2])
def test_channel_group_pipeline(monkeypatch, depth):
    """Two clock-shared radios as ONE lockstep child (one dispatch per
    block, the vote on the device): the payload decodes."""
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    port0 = 16200 + 50 * depth
    conf = _conf(port0, radios=("UHF-H", "UHF-V"), depth=depth)

    def one_child(sdr):
        assert len(sdr.demodulators) == 1
        assert type(sdr.demodulators[0]).__name__ == "ChannelGroup_process"

    payload, expected = _run_pipeline(conf, port0, 2, check=one_child)
    assert payload is not None, "channel group produced no decoded packet"
    assert payload == expected
