"""The decoder child's restart side and telegraf metrics, the port's
(``pycusdr_tpu_torch/runtime/decoder_process.py``) against the JAX
package's, and the combiner's purge of superseded generations.

Each decoder runs its own ``Decoder.run`` loop in the main thread of a
fresh interpreter (it installs a SIGTERM handler), on real ZMQ sockets,
fed one scripted stream of worker dicts: CC11xx frames from the port's
framer on ``CC11xx.json``, from a worker ``st-UHF0`` and, from a planned
restart on, its replacement ``st-UHF0~r1``. The decoder module's and the
packet history's ``time.time`` read a clock that each dict sets when it is
received, so eviction at 60 s and the dedup window run on the script's
times. What comes out is compared exactly: the bytes forwarded, in order;
the log's registrations, evictions and duplicates; the stats each worker
ships at shutdown; and, with a stub ``telegraf/client.py`` on the
children's ``PYTHONPATH``, every metric call.

Two scripts show where the port departs from JAX, on purpose: a
straggler of an evicted generation (the JAX decoder then marks the live
one stale and later evicts it mid-packet; the port keeps it and delivers
the packet), and more than 40 packets inside the widened dedup window
(the JAX history drops the oldest hashes and forwards a duplicate; the
port's keeps every hash in the window).

Ports 19100-19199 (below the ephemeral range, apart from every other test
file's ports); every wait is bounded."""

import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import pycusdr_tpu.combine as jax_combine
import pycusdr_tpu_torch.combine as port_combine
from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.protocol import loadProtocol
from pycusdr_tpu_torch.runtime.decoder_process import generation, superseded
from pycusdr_tpu_torch.tx.encoders import CC11xxEncoder

REPO = Path(__file__).resolve().parent.parent
CC11XX_JSON = REPO / "pycusdr_tpu_torch" / "config" / "configs" / "CC11xx.json"
RUN_S = 120.0  # bound on one decoder run
BASE, NEW = "st-UHF0", "st-UHF0~r1"

RUNNER = r'''
import json, logging, pickle, sys, threading, time, types
import zmq

pkg, feed_path, port0, out_path = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
with open(feed_path, "rb") as f:
    conf, feed = pickle.load(f)
if pkg == "jax":
    from pycusdr_tpu.decode import packet_hist as ph
    from pycusdr_tpu.protocol import loadProtocol
    from pycusdr_tpu.runtime import decoder_process as dp
else:
    from pycusdr_tpu_torch.decode import packet_hist as ph
    from pycusdr_tpu_torch.protocol import loadProtocol
    from pycusdr_tpu_torch.runtime import decoder_process as dp

clock = [0.0]
dp.time = ph.time = types.SimpleNamespace(time=lambda: clock[0])
events = []


class Events(logging.Handler):
    def emit(self, record):
        m = record.getMessage()
        if m.startswith(("Adding new worker", "Evicting")) or "duplicate packet" in m:
            events.append(m)


logging.getLogger().addHandler(Events())
logging.getLogger().setLevel(logging.INFO)
conf["Interfaces"]["Internal"]["decodeIn"] = f"tcp://*:{port0}"
conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"] = {"UHF": f"tcp://*:{port0 + 1}"}
conf["decoder"] = dict(conf.get("decoder", {}), statsPort=port0 + 2)
dec = dp.Decoder(conf, {"UHF": loadProtocol("CC11xx")(conf=conf)})

orig = zmq.Socket.recv_pyobj
first = [True]


def recv_pyobj(self, flags=0):
    msg = orig(self, flags)
    if first[0]:  # the outputs are bound: let the sink connect
        first[0] = False
        time.sleep(0.5)
    if msg.get("_end"):
        time.sleep(1.0)  # let the sink drain the forwarded bytes
        dec.runStatus.clear()
        raise zmq.error.Again("end of the script")
    if "_t" in msg:  # a scripted worker dict, not the stats hand-off
        clock[0] = msg.pop("_t")
    return msg


zmq.Socket.recv_pyobj = recv_pyobj
ctx = zmq.Context()
feeder = ctx.socket(zmq.PUSH)
feeder.connect(f"tcp://localhost:{port0}")
for msg in feed:
    feeder.send_pyobj(msg)
forwarded, stats, done = [], [], threading.Event()


def sink(port, out, pyobj):
    s = ctx.socket(zmq.PULL)
    s.setsockopt(zmq.RCVTIMEO, 200)
    s.connect(f"tcp://localhost:{port}")
    while not done.is_set():
        try:
            out.append(s.recv_pyobj() if pyobj else s.recv().hex())
        except zmq.error.Again:
            pass
    s.close(linger=0)


threads = [threading.Thread(target=sink, args=(port0 + 1, forwarded, False)),
           threading.Thread(target=sink, args=(port0 + 2, stats, True))]
for t in threads:
    t.start()
dec.run()
time.sleep(1.5)
done.set()
for t in threads:
    t.join()
feeder.close(linger=0)
with open(out_path, "w") as f:
    json.dump({"forwarded": forwarded, "events": events,
               "stats": [{k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in w.items()}
                         for w in stats]}, f)
'''

STUB = r'''
import json, os


class TelegrafClient:
    def __init__(self, host, port):
        self.out = os.environ["TELEGRAF_STUB_OUT"]
        self._write({"init": [host, port]})

    def _write(self, rec):
        with open(self.out, "a") as f:
            f.write(json.dumps(rec, default=float, sort_keys=True) + "\n")

    def metric(self, name, values, tags=None, timestamp=None):
        self._write({"name": name, "values": values, "tags": tags, "timestamp": timestamp})
'''


def _conf(telegraf=True):
    conf = load_modular_json(str(CC11XX_JSON))
    conf["Main"].update(maxWorkerRssMb=4000, restartOverlapSeconds=5.0, plotBufferSize=200)
    if telegraf:
        conf["Main"].update(telegraf_ip="127.0.0.1", telegraf_port=8094)
    return conf


class Script:
    """Worker dicts of a scripted stream: CC11xx frames between random
    bits, each packet's block long enough to hold its FIXED window."""

    def __init__(self, seed):
        conf = load_modular_json(str(CC11XX_JSON))
        self.enc = CC11xxEncoder(loadProtocol("CC11xx")(conf=conf), {})
        self.rng = np.random.RandomState(seed)
        self.msgs, self.counts = [], {}

    def payload(self):
        return self.rng.randint(0, 256, int(self.rng.randint(2, 120))).astype(np.uint8)

    def frame(self, payload):
        return np.asarray(self.enc.encodeAndFrame(payload), np.uint8)

    def noise(self, n):
        return self.rng.randint(0, 2, n).astype(np.uint8)

    def send(self, t, workerId, bits):
        n = self.counts.get(workerId, 0)
        self.counts[workerId] = n + 1
        self.msgs.append({
            "_t": float(t), "workerId": workerId, "count": n, "timestamp": float(t),
            "voteGroup": 0, "doppler": 100.0 + n, "doppler_std": 1.5, "SNR": 12.0 + 0.25 * n,
            "spSymEst": 128.0, "rangerate": -3.0, "baudRate": 7416,
            "baudRate_est": 7416.0, "sample_rate": 949248.0, "protocol": "UHF",
            "data": np.asarray(bits, np.uint8), "trust": np.full(len(bits), 2, np.int8)})

    def packet_block(self, payload):
        return np.r_[self.noise(200), self.frame(payload), self.noise(2400)]

    def feed(self):
        return self.msgs + [{"_end": True}]


def restart_script(seed=11):
    """st-UHF0 sends B0-B9 (t = 0-9 s), each block a packet; st-UHF0~r1
    registers with B5 at 5.3 s and sends B5 onward (the overlap: B5-B9
    decoded twice), then B10-B14 and a packet at 20.3 s repeated at 23.3 s
    (the dedup window of overlap + 3 s drops it); at 70.3 s st-UHF0 has
    been silent 60 s and is evicted; a packet at 71.3 s repeated at 73.3 s
    is then forwarded twice (one worker left: nothing to dedup). Returns
    (script, the forwarded payloads in order)."""
    s = Script(seed)
    payloads = [s.payload() for _ in range(15)]
    blocks = [s.packet_block(p) for p in payloads]
    for i in range(10):
        s.send(i, BASE, blocks[i])
        if i >= 5:
            s.send(i + 0.3, NEW, blocks[i])
    for i in range(10, 15):
        s.send(i + 0.3, NEW, blocks[i])
    x, y = s.payload(), s.payload()
    s.send(20.3, NEW, s.packet_block(x))
    s.send(23.3, NEW, s.packet_block(x))
    s.send(70.3, NEW, s.noise(3000))
    s.send(71.3, NEW, s.packet_block(y))
    s.send(73.3, NEW, s.packet_block(y))
    return s, payloads + [x, y, y]


def straggler_script(seed=12):
    """After st-UHF0's eviction (70.3 s), one straggler block of st-UHF0 at
    71 s; st-UHF0~r1 sends at 72.3 s a block that ends inside a frame and
    goes quiet; at 140 s st-UHF0 talks again, and at 141 s st-UHF0~r1
    sends the frame's tail. Returns (script, the straddling payload)."""
    s = Script(seed)
    for i in range(3):
        s.send(i, BASE, s.packet_block(s.payload()))
    s.send(2.3, NEW, s.noise(2000))
    s.send(70.3, NEW, s.noise(2000))
    s.send(71.0, BASE, s.noise(2000))
    p = s.payload()
    f = s.frame(p)
    s.send(72.3, NEW, np.r_[s.noise(500), f[:len(f) // 2]])
    s.send(140.0, BASE, s.noise(2000))
    s.send(141.0, NEW, np.r_[f[len(f) // 2:], s.noise(2400)])
    return s, p


def window_script(seed=13, n=45):
    """Both generations registered (the overlap); st-UHF0 sends n distinct
    packets within 4.5 s, then st-UHF0~r1 repeats the first at 6 s, inside
    the widened window (8 s). Returns (script, the first payload)."""
    s = Script(seed)
    s.send(0.0, NEW, s.noise(2000))
    payloads = [s.payload() for _ in range(n)]
    for i, p in enumerate(payloads):
        s.send(0.5 + i / 10, BASE, s.packet_block(p))
    s.send(6.0, NEW, s.packet_block(payloads[0]))
    return s, payloads[0]


def _run(script, port0, tmp_path, telegraf=True, stub=False):
    """Both decoders on ``script`` at once (port on port0.., JAX on
    port0 + 10..): {pkg: (output dict, telegraf records)}."""
    feed = tmp_path / "feed.pkl"
    with open(feed, "wb") as f:
        pickle.dump((_conf(telegraf), script.feed()), f)
    runner = tmp_path / "runner.py"
    runner.write_text(RUNNER)
    path = [str(REPO)]
    if stub:
        (tmp_path / "stub" / "telegraf").mkdir(parents=True, exist_ok=True)
        (tmp_path / "stub" / "telegraf" / "__init__.py").write_text("")
        (tmp_path / "stub" / "telegraf" / "client.py").write_text(STUB)
        path.insert(0, str(tmp_path / "stub"))
    procs = {}
    for k, (pkg, port) in enumerate((("port", port0), ("jax", port0 + 10))):
        out, tel = tmp_path / f"{pkg}.json", tmp_path / f"{pkg}_telegraf.jsonl"
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(path), TELEGRAF_STUB_OUT=str(tel),
                   CUDA_VISIBLE_DEVICES="", PYCUSDR_JAX_PLATFORM="cpu")
        procs[pkg] = (subprocess.Popen(
            [sys.executable, str(runner), pkg, str(feed), str(port), str(out)], cwd=REPO,
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True), out, tel)
    res = {}
    for pkg, (p, out, tel) in procs.items():
        _, err = p.communicate(timeout=RUN_S)
        assert p.returncode == 0, f"{pkg} decoder run failed:\n{err[-3000:]}"
        recs = [json.loads(line) for line in tel.read_text().splitlines()] if tel.exists() else []
        res[pkg] = (json.loads(out.read_text()), recs)
    return res


@pytest.mark.parametrize("stub", [True, False])
def test_restart_stream_equal_to_jax(tmp_path, stub):
    """A planned restart's streams: the same bytes forwarded (the overlap's
    duplicates dropped once, the evicted base's absence letting a repeat
    through), the same registrations, eviction and duplicates, the same
    stats of both generations; with the telegraf stub the same metric calls
    (one ``mon.modem`` per dict), without it none, as in JAX."""
    script, want = restart_script()
    res = _run(script, 19100 + (20 if stub else 0), tmp_path, stub=stub)
    (port, tel_port), (jax, tel_jax) = res["port"], res["jax"]
    assert port["forwarded"] == jax["forwarded"]
    assert port["forwarded"] == [bytes(p).hex() for p in want]
    assert port["events"] == jax["events"]
    assert [e for e in port["events"] if e.startswith("Evicting")] == \
        [f"Evicting superseded worker stream {BASE}"]
    assert sum("duplicate packet" in e for e in port["events"]) == 6  # B5-B9 and x
    assert port["stats"] == jax["stats"]
    assert sorted(w["workerId"] for w in port["stats"]) == [BASE, NEW]
    assert tel_port == tel_jax
    if stub:
        assert tel_port[0] == {"init": ["127.0.0.1", 8094]}
        calls = tel_port[1:]
        assert len(calls) == len(script.msgs)
        assert {c["name"] for c in calls} == {"mon.modem"}
        assert sum(c["values"]["packets_decoded"] for c in calls) == 15 + 5 + 2 + 2
    else:
        assert tel_port == []


def test_straggler_of_an_evicted_generation_keeps_the_live_one(tmp_path):
    """Departure from JAX: a straggler of the evicted st-UHF0 re-registers
    it; the JAX decoder marks the live st-UHF0~r1 stale and evicts it in
    its quiet window, losing the frame it held half; the port marks only
    the older generation, and delivers the frame."""
    script, p = straggler_script()
    res = _run(script, 19140, tmp_path)
    port, jax = res["port"][0], res["jax"][0]
    hexp = bytes(p).hex()
    assert hexp in port["forwarded"] and hexp not in jax["forwarded"]
    assert f"Evicting superseded worker stream {NEW}" in jax["events"]
    assert not any(e.startswith(f"Evicting superseded worker stream {NEW}")
                   for e in port["events"])


def test_widened_window_keeps_every_hash(tmp_path):
    """Departure from JAX: 45 packets inside the widened window, then a
    repeat of the first from the other generation: the JAX history has
    dropped its hash (40 kept) and forwards it again; the port drops it."""
    script, first = window_script()
    res = _run(script, 19160, tmp_path)
    port, jax = res["port"][0], res["jax"][0]
    h = bytes(first).hex()
    assert port["forwarded"].count(h) == 1
    assert jax["forwarded"].count(h) == 2
    assert len(port["forwarded"]) == 45


@pytest.mark.parametrize("case", [
    ([BASE], BASE, []),
    ([BASE, NEW], NEW, [BASE]),
    ([BASE, NEW], BASE, [BASE]),
    ([BASE, NEW, "st-UHF0~r2", "st-UHF1"], "st-UHF0~r2", [BASE, NEW]),
    ([NEW, "st-UHF0~rx"], NEW, []),
])
def test_superseded_compares_generations(case):
    """Only generations below the newest of the registered worker's base
    are marked; an unparseable suffix is a base of its own (as in the
    combiner)."""
    ids, wid, want = case
    assert superseded(ids, wid) == want
    assert generation("st-UHF0~r12") == ("st-UHF0", 12)


class FakeSocket:
    def __init__(self):
        self.queue, self.sent = [], []

    def recv_pyobj(self, flags=0):
        return self.queue.pop(0)

    def send_pyobj(self, data, flags=0):
        self.sent.append(data)


def test_combiner_purge_equal_to_jax(monkeypatch):
    """``_purge_superseded`` of both combiners on one registration
    sequence (st-UHF0, its restarts ~r1 and ~r2, an unparseable ~rx, a
    second channel, a straggler of ~r1) under one frozen clock: the same
    workers kept and submitted after every step."""
    clock = [1.7e9]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    base = load_modular_json(str(CC11XX_JSON))
    combs = {}
    for k, pkg in (("port", port_combine), ("jax", jax_combine)):
        comb = pkg.SoftCombiner(dict(base, Main=dict(base["Main"])))
        comb.decodeOut, comb.workers, comb.workersSubmitted = FakeSocket(), [], []
        combs[k] = comb
    steps = [(0, BASE), (0, "st-UHF1"), (5, NEW), (1, BASE), (20, NEW), (0, "st-UHF0~r2"),
             (3, "st-UHF0~rx"), (40, "st-UHF0~r2"), (1, NEW), (30, "st-UHF1"), (2, "st-UHF0~r2")]
    rng = np.random.RandomState(3)
    kept = []
    for dt, wid in steps:
        clock[0] += dt
        bits = rng.randint(0, 2, 256).astype(np.int8)
        for comb in combs.values():
            sock = FakeSocket()
            sock.queue.append({"workerId": wid, "count": 0, "timestamp": clock[0],
                               "voteGroup": 0, "doppler": 0.0, "protocol": "UHF",
                               "data": bits.copy(), "trust": np.full(256, 2, np.int8)})
            comb.receiveData(sock)
            comb._purge_superseded()
        ids = {k: ([w.workerId for w in c.workers], [w.workerId for w in c.workersSubmitted])
               for k, c in combs.items()}
        assert ids["port"] == ids["jax"], (dt, wid)
        kept.append(ids["port"][0])
    assert BASE not in kept[-1] and NEW not in kept[-1]
