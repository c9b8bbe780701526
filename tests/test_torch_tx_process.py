"""The port's Tx process and the whole station over real ZMQ on the CPU
(``PYCUSDR_TORCH_DEVICE=cpu``): the counterparts of
``tests/test_loopback.py`` (payload bytes -> ``Modulator_process`` ->
simulated channel -> ``Demodulator_process`` -> ``Decoder`` -> decoded
bytes, at pipeline depths 1 and 2, with a live-modulator RPC round trip)
and of ``tests/test_multiprotocol.py`` (bench_FSK and bench_GMSK radios
in one ``PyCuSDR``, each protocol's bytes on its own output port).

Every socket lives on ports 18000-18499: below the kernel's ephemeral
range (32768-60999) and apart from ``tests/test_torch_runtime.py``'s
16000-16499, ``tests/test_torch_multihost.py``'s 16500-16999 and the
chip smoke run's 17400-17534. Warming the children and decoding have
deadlines of their own, and the children are stopped, terminated and
joined by ``PyCuSDR.terminate``."""

import os
import time
import xmlrpc.client

import numpy as np
import pytest
import zmq

from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.dsp.signal_gen import awgn, get_padded_packet, packet_data
from pycusdr_tpu_torch.protocol.benchmark.bench_base import MASKLEN, seeded_bits
from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

CONF_DIR = os.path.join(os.path.dirname(__file__), "..", "pycusdr_tpu_torch", "config",
                        "configs")
WARM_S = 60.0  # bound on the wait for the children to warm and bind
DECODE_S = 90.0  # bound on the feed until decoded bytes arrive
HOP = 2**13 - 2**10


def _conf(port0, depth=1):
    """bench_FSK.json cut to blockSize 13, every port from ``port0``."""
    conf = load_modular_json(os.path.join(CONF_DIR, "benchmark", "bench_FSK.json"))
    conf["Main"].update(workerId="tx", PacketLen=1000,
                        statsFolder=os.path.join("build", "test_stats"))
    conf["GPU"]["UHF"].update(blockSize=13, overlap=10)
    conf["GPU"]["UHF"].setdefault("TPU", {})["pipelineDepth"] = depth
    conf["Radios"]["Rx"]["UHF-H"].update(doppCarrierSteps=16, Interfaces={
        "RxInPort": f"tcp://127.0.0.1:{port0}", "demodOut": f"tcp://localhost:{port0 + 10}"})
    conf["Demodulator"] = {"timeoutSeconds": 60}
    conf["Interfaces"]["Internal"].update({
        "demodIn": f"tcp://*:{port0 + 10}", "demodOut": f"tcp://localhost:{port0 + 10}",
        "decodeOut": f"tcp://localhost:{port0 + 11}", "decodeIn": f"tcp://*:{port0 + 11}"})
    conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"] = {"UHF": f"tcp://*:{port0 + 12}"}
    conf["Interfaces"]["External"]["XMLRpcIn"] = f"127.0.0.1:{port0 + 13}"
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=port0 + 14)
    return conf


def _wait_warm(sdr):
    """Bounded wait until every Rx child is warm and the decoder and every
    modulator have bound; names what did not."""
    flags = {f"{type(d).__name__}[{i}].warmedFlag": d.warmedFlag
             for i, d in enumerate(sdr.demodulators)}
    flags["Decoder.boundFlag"] = sdr.dec.boundFlag
    flags.update({f"Modulator_process[{m.name}].boundFlag": m.boundFlag for m in sdr.modulators})
    t0 = time.time()
    while time.time() < t0 + WARM_S and not all(f.is_set() for f in flags.values()):
        dead = [getattr(t, "name", str(t)) for t in sdr.tasks if not t.is_alive()]
        assert not dead, f"children {dead} died while warming"
        time.sleep(0.2)
    unset = [k for k, f in flags.items() if not f.is_set()]
    assert not unset, f"{unset} not set within {WARM_S} s"
    assert all(d.device == "cpu" for d in sdr.demodulators)


def _socket(ctx, kind, addr, bind=False, timeout_ms=None):
    s = ctx.socket(kind)
    s.setsockopt(zmq.LINGER, 0)
    if timeout_ms is not None:
        s.setsockopt(zmq.RCVTIMEO, timeout_ms)
    (s.bind if bind else s.connect)(addr)
    return s


def _rpc_round_trip(sdr, port0):
    """The Tx surface reads and writes the live ``Modulator_process``."""
    proxy = xmlrpc.client.ServerProxy(f"http://127.0.0.1:{port0 + 13}/RPC2")
    assert sdr.modulators and type(sdr.rpcInt.modulator["UHF"]).__name__ == "Modulator_process"
    proxy.set_Tx_rangerate(1500.0)
    assert proxy.get_Tx_rangerate() == 1500.0
    assert sdr.modulators[0].rangerate == 1500.0
    proxy.set_Tx_freq_offset(250)
    assert proxy.get_Tx_freq_offset() == 250
    proxy.set_Tx_num_sync_flags(12)
    assert proxy.get_Tx_num_sync_flags() == 12
    radio = sdr.configFile["Radios"]["Tx"]["UHF"]
    want = radio["frequencyOffset_Hz"] + 250 + 1500.0 / 3e8 * radio["frequency_Hz"]
    t0 = time.time()  # the child publishes on its next poll (100 ms)
    while time.time() < t0 + 10 and abs(proxy.get_Tx_total_freq_offset() - want) > 0.01:
        time.sleep(0.1)
    assert abs(proxy.get_Tx_total_freq_offset() - want) <= 0.01
    assert proxy.get_Tx_baud_rate() == radio["baud"]


@pytest.mark.parametrize("depth", [1, 2])
def test_tx_rx_loopback_through_processes(monkeypatch, depth):
    """TxDataIn -> Modulator_process -> the waveform on TxModToUSRPPort ->
    AWGN at 25 dB -> RxInPort -> Demodulator_process -> Decoder: the
    payload's bytes on the output port; then the RPC round trip."""
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    port0 = 18000 + 100 * depth
    conf = _conf(port0, depth)
    conf["Radios"]["Tx"] = {"UHF": {
        "baud": 9600, "samplesPerSym": 16, "frequency_Hz": 437.3e6,
        "frequencyOffset_Hz": 38400, "Protocol": "UHF",
        "Interfaces": {"TxModToUSRPPort": f"tcp://127.0.0.1:{port0 + 20}",
                       "TxDataIn": f"tcp://127.0.0.1:{port0 + 21}"}}}
    ctx = zmq.Context()
    rx_in = _socket(ctx, zmq.PUB, f"tcp://127.0.0.1:{port0}", bind=True)
    socks = [rx_in]
    sdr = PyCuSDR(conf, args=None)
    sdr.start()
    try:
        _wait_warm(sdr)
        tx_in = _socket(ctx, zmq.PUSH, f"tcp://127.0.0.1:{port0 + 21}")
        wave_out = _socket(ctx, zmq.PULL, f"tcp://127.0.0.1:{port0 + 20}", timeout_ms=5000)
        sink = _socket(ctx, zmq.PULL, f"tcp://localhost:{port0 + 12}", timeout_ms=1500)
        socks += [tx_in, wave_out, sink]
        time.sleep(0.5)  # let the SUB and PULL sockets connect

        # the bench packet's first MASKLEN bits ARE the Rx header mask, so
        # the Tx payload is the remainder of the seeded sequence
        packet_bits = seeded_bits(1000, 123).astype(np.uint8)
        rng = np.random.RandomState(0)
        decoded, rounds, t1 = None, 0, time.time()
        while decoded is None and time.time() < t1 + DECODE_S:
            rounds += 1
            tx_in.send(packet_bits[MASKLEN:].tobytes())
            try:
                wave = np.frombuffer(wave_out.recv(), np.complex64)
            except zmq.error.Again:
                continue
            assert len(wave) >= 16384  # noise-padded for front-end warm-up
            chan = awgn(wave, 25.0, rng=rng).astype(np.complex64)
            chan = np.r_[chan, np.zeros(4 * HOP, np.complex64)]
            for pos in range(0, len(chan), HOP // 2):
                rx_in.send(chan[pos:pos + HOP // 2].tobytes())
                time.sleep(0.01)
            try:
                decoded = sink.recv()
            except zmq.error.Again:
                continue
        assert decoded is not None, (
            f"no decoded bytes on tcp://localhost:{port0 + 12} after {rounds} payloads pushed "
            f"within {DECODE_S} s")
        expected = bytes(bytearray(sdr.protocols["UHF"].Packet(packet_bits).getBinaryData()[0]))
        assert decoded == expected, "loopback payload mismatch"
        _rpc_round_trip(sdr, port0)
    finally:
        sdr.terminate()
        assert not any(t.is_alive() for t in sdr.tasks), "a child outlived terminate()"
        for s in socks:
            s.close()
        ctx.term()


def test_two_protocols_route_to_their_ports(monkeypatch):
    """A bench_FSK and a bench_GMSK radio in one ``PyCuSDR``: each
    protocol's packet arrives on its own decodeBytesOut port."""
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    port0 = 18300
    conf = _conf(port0)
    conf["Main"]["protocols"] = {"UHF": "bench_FSK", "SBAND": "bench_GMSK"}
    base = conf["Radios"]["Rx"]["UHF-H"]
    conf["Radios"]["Rx"] = {
        "UHF-H": base,
        "SBAND-H": dict(base, name="SBAND", Protocol="SBAND", Interfaces={
            "RxInPort": f"tcp://127.0.0.1:{port0 + 1}",
            "demodOut": f"tcp://localhost:{port0 + 10}"}),
    }
    conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"] = {
        "UHF": f"tcp://*:{port0 + 12}", "SBAND": f"tcp://*:{port0 + 15}"}

    bits = packet_data(1000, 123)
    fs = 9600 * 16
    streams = [np.r_[get_padded_packet(mod, 16, fs, offset_freq=38400, raw_bits=bits,
                                       pad=6000)[0].astype(np.complex64),
                     np.zeros(6 * HOP, np.complex64)] for mod in ("FSK", "GMSK")]
    ctx = zmq.Context()
    pubs = [_socket(ctx, zmq.PUB, f"tcp://127.0.0.1:{port0 + i}", bind=True) for i in (0, 1)]
    socks = list(pubs)
    sdr = PyCuSDR(conf, args=None)
    sdr.start()
    try:
        _wait_warm(sdr)
        assert not sdr.modulators
        sinks = [_socket(ctx, zmq.PULL, f"tcp://localhost:{port0 + p}", timeout_ms=1500)
                 for p in (12, 15)]
        socks += sinks
        time.sleep(0.5)
        got = [None, None]
        t1 = time.time()
        while None in got and time.time() < t1 + DECODE_S:
            for pos in range(0, max(map(len, streams)) - HOP, HOP):
                for s, x in zip(pubs, streams):
                    s.send(x[pos:pos + HOP].tobytes())
                time.sleep(0.02)
            for i, sink in enumerate(sinks):
                if got[i] is None:
                    try:
                        got[i] = sink.recv()
                    except zmq.error.Again:
                        pass
        assert got[0] is not None, "no packet on the UHF (FSK) output port"
        assert got[1] is not None, "no packet on the SBAND (GMSK) output port"
        for g, key in zip(got, ("UHF", "SBAND")):
            assert g == bytes(bytearray(sdr.protocols[key].Packet(bits).getBinaryData()[0]))
    finally:
        sdr.terminate()
        assert not any(t.is_alive() for t in sdr.tasks), "a child outlived terminate()"
        for s in socks:
            s.close()
        ctx.term()
