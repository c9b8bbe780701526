"""Planned restarts of the port's children (``Main.maxWorkerRssMb``,
``pycusdr_tpu_torch/runtime/orchestrator.py``) on the CPU, as
``tests/test_failure_detection.py`` runs the JAX package's: ``PyCuSDR``
on one bench_FSK radio at blockSize 13 over real ZMQ
(``PYCUSDR_TORCH_DEVICE=cpu``). The orchestrator's ``rss_mb`` is replaced
in the parent so that the child under test, and only it, reads above the
cap; the reader itself is held against psutil.

- make-before-break: the replacement ``rt-UHF0~r1`` warms beside the old
  demodulator child, a packet fed during the overlap comes out once
  (both children decode it, the decoder drops the copy), the old child
  is gone, and a packet fed afterwards decodes through the replacement;
- a replacement that dies while warming: break-before-make with an
  unsuffixed child, as in JAX;
- gate-less children (the decoder, the channel group: ``warmedFlag`` but
  no ``subscribeGate``) restart break-before-make;
- the storm guard: a child over the cap again right after its restart
  disables the cap;
- ``is_alive`` never runs the RSS check (the port's departure from JAX,
  whose ``is_alive`` does) and ignores a child that is being restarted.

Ports 19040-19099 and 19200-19289 (below the ephemeral range, apart from
every other test file's ports); every wait is bounded."""

import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import zmq

from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.dsp.signal_gen import get_padded_packet, packet_data
from pycusdr_tpu_torch.runtime import orchestrator
from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

REPO = os.path.join(os.path.dirname(__file__), "..")
CONF_DIR = os.path.join(REPO, "pycusdr_tpu_torch", "config", "configs")
WAIT_S = 90.0  # bound on every wait: warm-up, restart, decode
HOP = 2**13 - 2**10
OVERLAP_S = 8.0  # restartOverlapSeconds: the decoder's dedup window is 3 s longer


def _conf(port0, radios=("UHF-H",), cap=100, overlap=OVERLAP_S):
    conf = load_modular_json(os.path.join(CONF_DIR, "benchmark", "bench_FSK.json"))
    conf["Main"].update(workerId="rt", PacketLen=1000, channelGroup_enabled=len(radios) > 1,
                        statsFolder=os.path.join("build", "test_stats"),
                        maxWorkerRssMb=cap, restartOverlapSeconds=overlap)
    conf["GPU"]["UHF"].update(blockSize=13, overlap=10)
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


def _over_cap(monkeypatch, pids):
    """``rss_mb`` reads 1000 MB for the pids ``pids()`` names, 1 MB for
    every other; returns the list of pids the orchestrator read."""
    read = []

    def fake(pid):
        read.append(pid)
        return 1000.0 if pid in pids() else 1.0

    monkeypatch.setattr(orchestrator, "rss_mb", fake)
    return read


def _wait(cond, what):
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"{what} not within {WAIT_S} s")


def _record_factory(sdr, i, tweak=None):
    """Wrap task i's factory: every child it makes is appended to the
    returned list with whether the task it replaces was alive then;
    ``tweak(child, n)`` may change the n-th child before it starts."""
    made, f, old = [], sdr._task_factories[i], sdr.tasks[i]

    def factory():
        t = f()
        if tweak is not None:
            tweak(t, len(made))
        made.append((t, old.is_alive()))
        return t

    sdr._task_factories[i] = factory
    return made


def _packet():
    """The 1000-bit bench_FSK packet (``packet_data(1000, 123)``: the bench
    protocol finds its header and counts its errors against it)."""
    bits = packet_data(1000, 123)
    sig, _ = get_padded_packet("FSK", 16, 9600 * 16, offset_freq=38400, raw_bits=bits, pad=6000)
    return bits, np.r_[sig, np.zeros(6 * HOP, np.complex64)].astype(np.complex64)


def _feed(pub, stream):
    for pos in range(0, len(stream) - HOP, HOP):
        pub.send(stream[pos:pos + HOP].tobytes())
        time.sleep(0.02)


def _collect(sink, seconds):
    """What ``sink`` receives in ``seconds``, and when the first came."""
    out, first, deadline = [], None, time.time() + seconds
    while time.time() < deadline:
        try:
            out.append(sink.recv())
            first = first or time.time()
        except zmq.error.Again:
            pass
    return out, first


def test_planned_restart_make_before_break(monkeypatch):
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    port0 = 19040
    ctx = zmq.Context()
    pub = ctx.socket(zmq.PUB)
    pub.setsockopt(zmq.LINGER, 0)
    pub.bind(f"tcp://127.0.0.1:{port0}")
    sink = ctx.socket(zmq.PULL)
    sink.setsockopt(zmq.LINGER, 0)
    sink.setsockopt(zmq.RCVTIMEO, 200)
    sdr = PyCuSDR(_conf(port0), args=None)
    old = sdr.demodulators[0]
    _over_cap(monkeypatch, lambda: {old.pid})
    i = sdr.tasks.index(old)
    made = _record_factory(sdr, i)
    sdr.start()
    try:
        _wait(lambda: made and made[0][0].warmedFlag.is_set() and old.warmedFlag.is_set()
              and sdr.dec.boundFlag.is_set(), "both demodulator children warm")
        new = made[0][0]
        assert new.workerId == "rt-UHF0~r1" and made[0][1], "not make-before-break"
        assert old in sdr.tasks and new not in sdr.tasks
        sink.connect(f"tcp://localhost:{port0 + 12}")
        time.sleep(1.5)  # the replacement subscribes once the gate opens
        bits, stream = _packet()
        exp = bytes(bytearray(sdr.protocols["UHF"].Packet(bits).getBinaryData()[0]))
        _feed(pub, stream)
        got, t_got = _collect(sink, 4.0)
        assert got == [exp], f"the overlap's packet came out {len(got)} times"
        assert old.is_alive(), "the overlap ended before the packet was decoded"
        _wait(lambda: sdr.demodulators[0] is new, "the swap")
        assert sdr.tasks[i] is new and sdr.rpcInt.demodulator[0] is new
        assert not old.is_alive() and new.is_alive()
        assert sdr._restarts == 0 and len(made) == 1
        assert sdr.is_alive()
        # the same packet again once the dedup window (overlap + 3 s) is past
        time.sleep(max(0.0, t_got + OVERLAP_S + 3.0 + 0.5 - time.time()))
        got2 = []
        deadline = time.time() + WAIT_S
        while not got2 and time.time() < deadline:
            _feed(pub, stream)
            got2, _ = _collect(sink, 2.0)
        assert got2 == [exp], "no packet decoded after the planned restart"
    finally:
        sdr.terminate()
        pub.close()
        sink.close()
        ctx.term()
    assert not any(t.is_alive() for t in sdr.tasks)
    suc = {w["workerId"]: int(np.sum(w["packetSuc"])) for w in sdr.passStats}
    assert suc["rt-UHF0"] >= 1 and suc["rt-UHF0~r1"] >= 2, suc


def test_replacement_dying_while_warming_falls_back(monkeypatch):
    """The replacement crashes in its warm-up (a backend that does not
    exist): the old child is torn down, then a plain factory child
    (workerId unsuffixed) starts, as in JAX."""
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    sdr = PyCuSDR(_conf(19060), args=None)
    old = sdr.demodulators[0]
    _over_cap(monkeypatch, lambda: {old.pid})

    def broken(t, n):
        if n == 0:
            t.demodulatorName = "NO_SUCH_BACKEND"

    made = _record_factory(sdr, sdr.tasks.index(old), broken)
    sdr.start()
    try:
        _wait(lambda: len(made) == 2 and made[1][0].warmedFlag.is_set(), "the fallback child")
        (first, _), (second, old_alive) = made
        assert first.exitcode not in (None, 0) and first.workerId == "rt-UHF0~r1"
        assert not old_alive, "the fallback started before the old child was down"
        assert second.workerId == "rt-UHF0" and sdr.demodulators[0] is second
        assert not old.is_alive()
    finally:
        sdr.terminate()
    assert not any(t.is_alive() for t in sdr.tasks)


@pytest.mark.parametrize("which", ["Decoder", "ChannelGroup_process"])
def test_gateless_task_restarts_break_before_make(monkeypatch, which):
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    port0 = 19200 if which == "Decoder" else 19220
    radios = ("UHF-H",) if which == "Decoder" else ("UHF-H", "UHF-V")
    sdr = PyCuSDR(_conf(port0, radios), args=None)
    old = next(t for t in sdr.tasks if type(t).__name__ == which)
    _over_cap(monkeypatch, lambda: {old.pid})
    i = sdr.tasks.index(old)
    made = _record_factory(sdr, i)
    sdr.start()
    try:
        _wait(lambda: made and sdr.tasks[i] is made[0][0] and made[0][0].is_alive(),
              f"the {which} restart")
        new, old_alive = made[0]
        assert not old_alive, f"{which}: the new child was made before the old one was down"
        assert not old.is_alive() and len(made) == 1
        if which == "Decoder":
            assert sdr.dec is new
        else:
            assert sdr.demodulators == [new] and sdr.rpcInt.demodulator[0] is new
            assert "~r" not in new.workerId
        assert sdr.is_alive()
    finally:
        sdr.terminate()
    assert not any(t.is_alive() for t in sdr.tasks)


def test_storm_guard_disables_the_cap(monkeypatch):
    """Every child reads above the cap: the first check restarts the first
    task (the decoder, break-before-make); the next finds it above the cap
    again within the storm window and turns the cap off."""
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(orchestrator, "RSS_CHECK_S", 0.5)
    monkeypatch.setattr(orchestrator, "MAINT_PERIOD_S", 0.2)
    sdr = PyCuSDR(_conf(19240), args=None)
    dec0, demod0 = sdr.dec, sdr.demodulators[0]
    _over_cap(monkeypatch, lambda: {t.pid for t in sdr.tasks})
    sdr.start()
    try:
        _wait(lambda: sdr._max_rss_mb == 0, "the storm guard")
        assert sdr.dec is not dec0 and sdr.dec.is_alive() and not dec0.is_alive()
        assert sdr.demodulators[0] is demod0 and list(sdr._rss_restart_at) == [0]
        assert sdr.is_alive()
    finally:
        sdr.terminate()


def test_rss_reader_matches_psutil():
    psutil = pytest.importorskip("psutil")
    p = subprocess.Popen([sys.executable, "-c", "import time; x = bytearray(50_000_000); "
                          "print(1, flush=True); time.sleep(30)"],
                         stdout=subprocess.PIPE, text=True)
    try:
        p.stdout.readline()  # the child has allocated
        got = orchestrator.rss_mb(p.pid)
        assert got == psutil.Process(p.pid).memory_info().rss / 1e6
        assert got > 50
    finally:
        p.kill()
        p.wait(timeout=10)


class _Task:
    def __init__(self, alive=True, timed_out=False):
        self.alive, self.timed_out, self.name = alive, timed_out, "fake"

    def is_alive(self):
        return self.alive

    def GRCTimeout(self):
        return self.timed_out


def _fake_self(tasks, demods, restarting=()):
    checks = []
    return checks, types.SimpleNamespace(
        killer=None, tasks=tasks, _demodulators=demods,
        _maint_restarting={id(t) for t in restarting}, _restart_enabled=False,
        _check_rss_caps=lambda: checks.append(1))


def test_is_alive_never_runs_the_rss_check():
    """Departure from JAX: the JAX ``is_alive`` runs the RSS check on every
    poll, so a poller can become the restarter and wait out a warm-up and
    an overlap; the port's leaves it to the maintenance thread. Both treat
    a timed-out or dead child in the middle of a planned restart as alive."""
    from pycusdr_tpu.runtime.orchestrator import PyCuSDR as JaxPyCuSDR

    for cls, want in ((PyCuSDR, []), (JaxPyCuSDR, [1])):
        d = _Task()
        checks, me = _fake_self([d], [d])
        assert cls.is_alive(me) and checks == want, cls.__module__
        mid = _Task(alive=False, timed_out=True)
        checks, me = _fake_self([mid, d], [mid], restarting=[mid])
        assert cls.is_alive(me), cls.__module__
