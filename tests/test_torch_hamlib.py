"""The port's hamlib control plane (``pycusdr_tpu_torch/control/``:
``rig_server``, ``dummy_radios``, ``hamlib_daemon``) against the JAX
package's, on the CPU.

Everything here is host code in both packages, so every comparison is
exact: the rig servers' replies byte for byte, the dummy radios' values.
The daemon tests bind ports 18700-18799 (below the kernel's ephemeral
range and apart from every other test file's ports), and every wait is
bounded: sockets time out after 5-10 s, a modem's boot and teardown
after ``JOIN_TIMEOUT``-based deadlines."""

import argparse
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from pycusdr_tpu.control import dummy_radios as jax_dummy
from pycusdr_tpu.control import rig_server as jax_rig
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu.runtime.demodulator_process import Demodulator_process as JaxDemodulator
from pycusdr_tpu.runtime.modulator_process import Modulator_process as JaxModulator
from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.control import dummy_radios as port_dummy
from pycusdr_tpu_torch.control import hamlib_daemon
from pycusdr_tpu_torch.control import rig_server as port_rig
from pycusdr_tpu_torch.control.hamlib_daemon import serve_all
from pycusdr_tpu_torch.protocol import loadProtocol
from pycusdr_tpu_torch.runtime.demodulator_process import Demodulator_process
from pycusdr_tpu_torch.runtime.modulator_process import Modulator_process
from pycusdr_tpu_torch.runtime.orchestrator import JOIN_TIMEOUT, STOP_TIMEOUT
from pycusdr_tpu_torch.utils.doppler import rangerate_from_freq

REPO = os.path.join(os.path.dirname(__file__), "..")
CONF_DIR = os.path.join(REPO, "pycusdr_tpu_torch", "config", "configs")
C = 299792458.0

#: one rigctld session: long and short forms, the Tx and Rx steers, the
#: rangerate pair, the VFO, unknown and unimplemented commands, a malformed
#: value (no reply, as in the reference), a ``\\``-prefixed dump request
#: and an empty line
SCRIPT = [b"\\chk_vfo", b"\\dump_state", b"F 437010000", b"f", b"I 145891813.5", b"i",
          b"\\set_rangerate 1234.5", b"\\get_rangerate", b"V VFOB", b"v", b"s",
          b"\\set_split_freq 145890000", b"\\get_split_freq", b"\\get_freq", b"Q 1",
          b"\\set_mode FM", b"m", b"\\get_bogus", b"F abc", b"\\\\dump_caps", b"",
          b"\\set_freq 437000000", b"f"]


def _session(rig_mod, radios_rx, radios_tx, script=SCRIPT):
    """Run ``script`` through a ``Rig_server`` of ``rig_mod`` over a
    socket pair; returns every byte it answered (a final ``\\chk_vfo``
    marks the end)."""
    a, b = socket.socketpair()
    srv = rig_mod.Rig_server(b, ("127.0.0.1", 0), radios_rx, radios_tx)
    srv.start()
    try:
        a.settimeout(10)
        # commands in two sends, split inside a line: the server buffers
        blob = b"\n".join(script) + b"\n\\chk_vfo\n"
        a.sendall(blob[:37])
        time.sleep(0.05)
        a.sendall(blob[37:])
        out, marks = b"", script.count(b"\\chk_vfo") + 1
        while not out.endswith(b"CHKVFO 0\n") or out.count(b"CHKVFO 0\n") < marks:
            chunk = a.recv(65536)
            assert chunk, "rig server closed the socket"
            out += chunk
        return out
    finally:
        srv.terminate()
        a.close()
        srv.join(timeout=5)
        b.close()


def test_rig_server_replies_byte_equal():
    got = _session(port_rig, [port_dummy.DummyRadio(437e6)], [port_dummy.DummyRadio(145.89e6)])
    want = _session(jax_rig, [jax_dummy.DummyRadio(437e6)], [jax_dummy.DummyRadio(145.89e6)])
    assert got == want
    lines = got.decode().split("\n")
    assert lines[0] == "CHKVFO 0" and "\n".join(lines[1:21]) == port_rig.DUMP_STATE
    assert "RPRT -4" in lines and "VFOB" in lines


def test_rig_server_default_radios_byte_equal():
    """No radios given: both packages steer their own DummyRadio()."""
    script = [b"F 186005000", b"f", b"I 186001000", b"i", b"\\get_rangerate"]
    got = _session(port_rig, [], [], script)
    assert got == _session(jax_rig, [], [], script)
    assert got.startswith(b"RPRT 0\n186005000.0")


def test_rig_server_tables_equal():
    assert port_rig.SHORT_TO_LONG_CMD == jax_rig.SHORT_TO_LONG_CMD
    assert port_rig.DUMP_STATE == jax_rig.DUMP_STATE
    assert {c.name: c.value for c in port_rig.Response_codes} == \
        {c.name: c.value for c in jax_rig.Response_codes}


@pytest.mark.parametrize("Fc", [145.89e6, 186e6, 437.3e6, 2.2e9])
def test_dummy_radio_equal(Fc):
    rng = np.random.RandomState(int(Fc) % 1000)
    port, jax = port_dummy.DummyRadio(Fc), jax_dummy.DummyRadio(Fc)
    for step in range(6):
        op, val = step % 3, float(rng.uniform(-8000, 8000))
        for r in (port, jax):
            if op == 0:
                r.freq_hl = Fc + val
            elif op == 1:
                r.rangerate = val
            else:
                r.doppler = val
        for attr in ("freq_hl", "Fc", "rangerate", "doppler"):
            assert getattr(port, attr) == getattr(jax, attr), (step, attr)
    port.Fc = jax.Fc = Fc / 2
    assert (port.freq_hl, port.Fc) == (jax.freq_hl, jax.Fc)


def _cc11xx_conf():
    conf = load_modular_json(os.path.join(CONF_DIR, "CC11xx.json"))
    conf["GPU"]["UHF"].update(blockSize=13, overlap=10)
    return conf


def test_rx_and_tx_steer_on_real_processes_equal():
    """``F``/``f`` on a real ``Demodulator_process`` (not started): neither
    package's has ``freq_hl``, so the steer stores a parent-side attribute
    that ``f`` reads back, and the child's values are untouched; both
    packages answer alike. ``I``/``i`` reach the ``Modulator_process``'s
    shared rangerate, against the hamlib centre frequency."""
    conf = _cc11xx_conf()
    replies, procs = {}, {}
    for k, (rig, demod, mod, load) in {
            "port": (port_rig, Demodulator_process, Modulator_process, loadProtocol),
            "jax": (jax_rig, JaxDemodulator, JaxModulator, jax_loadProtocol)}.items():
        prot = load("CC11xx")(conf=conf)
        d, m = demod(conf, prot, "UHF-H"), mod(conf, prot, "UHF")
        replies[k] = _session(rig, [d], [m], [b"F 401540000", b"f", b"I 145891813.5", b"i",
                                              b"\\get_rangerate"])
        procs[k] = (d, m)
    assert replies["port"] == replies["jax"]
    d, m = procs["port"]
    assert replies["port"].split(b"\n")[:2] == [b"RPRT 0", b"401540000.0"]
    assert not hasattr(type(d), "freq_hl") and d.freq_hl == 401540000.0
    assert d.Fc == 401.538e6 - 148320  # the child's centre, unsteered
    want = rangerate_from_freq(145891813.5, 145.89e6)
    assert abs(m.rangerate - want) <= 1e-6 * abs(want)
    assert abs(procs["jax"][1].rangerate - m.rangerate) == 0


class _FakeModem:
    """Stands in for a booted PyCuSDR: just the rig-facing surface."""

    def __init__(self, cfg_path):
        self.cfg_path = cfg_path
        self.demodulators = [port_dummy.DummyRadio(437e6)]
        self.modulators = [port_dummy.DummyRadio(437e6)]
        self._alive = True

    def is_alive(self):
        return self._alive

    def terminate(self):
        self._alive = False


def _cmd(f, c):
    f.write(c + b"\n")
    f.flush()
    return f.readline().strip()


def test_two_radios_served_concurrently():
    """The port of ``tests/test_hamlib_daemon.py``: two radio entries
    served at once, one modem booted per connection with its own config,
    steering per radio."""
    sockets = {"UHF": {"addr": "127.0.0.1", "port": 18711, "config": "uhf.json"},
               "STX": {"addr": "127.0.0.1", "port": 18712, "config": "stx.json"}}
    booted, boot_lock = [], threading.Lock()

    def modem_factory(cfg_path, args):
        m = _FakeModem(cfg_path)
        with boot_lock:
            booted.append(m)
        return m

    def rig_factory(sock, client, sdr):
        rig = port_rig.Rig_server(sock, client, sdr.demodulators, sdr.modulators)
        rig.start()
        return rig

    stop, ready = threading.Event(), {}
    threads = serve_all(sockets, "/tmp", args=None, modem_factory=modem_factory,
                        rig_factory=rig_factory, stop=stop, ready_events=ready)
    try:
        for ev in ready.values():
            assert ev.wait(5), "listener did not come up"
        sa = socket.create_connection(("127.0.0.1", 18711), timeout=5)
        sb = socket.create_connection(("127.0.0.1", 18712), timeout=5)
        fa, fb = sa.makefile("rwb"), sb.makefile("rwb")
        assert _cmd(fa, b"\\chk_vfo") == b"CHKVFO 0"
        assert _cmd(fb, b"\\chk_vfo") == b"CHKVFO 0"
        assert _cmd(fa, b"F 437010000") == b"RPRT 0"
        assert _cmd(fb, b"F 437020000") == b"RPRT 0"
        deadline = time.time() + 5
        while len(booted) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(booted) == 2
        assert {m.cfg_path for m in booted} == {"/tmp/uhf.json", "/tmp/stx.json"}
        rates = sorted(m.demodulators[0].rangerate for m in booted)
        assert abs(rates[0] - 10000 / 437e6 * C) < 10
        assert abs(rates[1] - 20000 / 437e6 * C) < 10
        sa.close()
        sb.close()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)


def test_daemon_boots_tears_down_and_reboots_the_station(tmp_path, monkeypatch):
    """``serve_all`` with the default factories on ``hamlib_sockets.json``
    moved to port 18720 and CC11xx.json cut to blockSize 13, under
    ``PYCUSDR_TORCH_DEVICE=cpu``: a connection boots the port's
    ``PyCuSDR`` (Tx and Rx), ``I`` reaches the Modulator_process child, a
    disconnect stops every child, and a second connection boots a second
    modem that answers."""
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    port0 = 18720
    conf = _cc11xx_conf()
    conf["Main"]["statsFolder"] = str(tmp_path / "stats")
    conf["Radios"]["Rx"]["UHF-H"]["Interfaces"] = {
        "RxInPort": f"tcp://127.0.0.1:{port0 + 1}", "demodOut": f"tcp://localhost:{port0 + 10}"}
    conf["Radios"]["Tx"]["UHF"]["Interfaces"] = {
        "TxModToUSRPPort": f"tcp://127.0.0.1:{port0 + 2}",
        "TxDataIn": f"tcp://127.0.0.1:{port0 + 3}", "TxManualIn": f"tcp://127.0.0.1:{port0 + 4}"}
    conf["Interfaces"]["Internal"].update({
        "demodIn": f"tcp://*:{port0 + 10}", "demodOut": f"tcp://localhost:{port0 + 10}",
        "decodeOut": f"tcp://localhost:{port0 + 11}", "decodeIn": f"tcp://*:{port0 + 11}"})
    conf["Interfaces"]["External"].update({
        "decodeBytesOut_ZMQ": {"UHF": f"tcp://*:{port0 + 12}"},
        "XMLRpcIn": f"127.0.0.1:{port0 + 13}", "TxManualIn": f"tcp://127.0.0.1:{port0 + 4}"})
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=port0 + 14)
    (tmp_path / "CC11xx.json").write_text(json.dumps(conf))
    sockets = load_modular_json(os.path.join(CONF_DIR, "hamlib_sockets.json"))
    sockets["CC11xx"].update(addr="127.0.0.1", port=port0)

    booted = []

    def modem_factory(cfg_path, args):
        sdr = hamlib_daemon._default_modem_factory(cfg_path, args)
        booted.append(sdr)
        return sdr

    stop, ready = threading.Event(), {}
    threads = serve_all(sockets, str(tmp_path), argparse.Namespace(v=0),
                        modem_factory=modem_factory, stop=stop, ready_events=ready)
    teardown_s = STOP_TIMEOUT + 2 * JOIN_TIMEOUT + 10
    try:
        assert ready["CC11xx"].wait(5), "listener did not come up"
        for n in (1, 2):
            s = socket.create_connection(("127.0.0.1", port0), timeout=30)
            f = s.makefile("rwb")
            assert _cmd(f, b"\\chk_vfo") == b"CHKVFO 0"
            assert _cmd(f, b"I 145891813.5") == b"RPRT 0"
            assert float(_cmd(f, b"i")) == pytest.approx(145891813.5, rel=1e-9)
            assert len(booted) == n
            sdr = booted[-1]
            assert [type(t).__name__ for t in sdr.modulators] == ["Modulator_process"]
            want = rangerate_from_freq(145891813.5, 145.89e6)
            assert abs(sdr.modulators[0].rangerate - want) <= 1e-6 * abs(want)
            deadline = time.time() + 60
            while time.time() < deadline and not sdr.demodulators[0].warmedFlag.is_set():
                time.sleep(0.2)
            assert sdr.demodulators[0].device == "cpu"
            f.close()
            s.close()
            deadline = time.time() + teardown_s
            while time.time() < deadline and any(t.is_alive() for t in sdr.tasks):
                time.sleep(0.2)
            assert not any(t.is_alive() for t in sdr.tasks), \
                f"children alive {teardown_s} s after the client left"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=teardown_s)
        for sdr in booted:
            if any(t.is_alive() for t in sdr.tasks):
                sdr.terminate()
