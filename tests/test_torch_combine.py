"""The port's softCombiner (``pycusdr_tpu_torch/combine/``) against the JAX
package's (``pycusdr_tpu/combine/``) on the same seeded numpy inputs, and
the three-station Rx through it.

Everything compared here is host numpy in both packages, so every
comparison is exact: bits, trust (float64 codes), lags, verdicts, buffers,
cursors and every dict the combiner sends, in the same order. The
combiner and ``Worker`` read ``time.time()`` (arrival stamps, pruning,
the frontier hold), so the in-process comparisons freeze it with one
clock that both packages read, and advance it by hand.

The process tests bind ports 18500-18699 (below the kernel's ephemeral
range and apart from every other test file's ports), and bound every
wait: the combiner's ``ready``, the sinks' ``RCVTIMEO``, the warm-up and
the decode."""

import copy
import os
import time
import xmlrpc.client

import numpy as np
import pytest
import zmq

import pycusdr_tpu.combine as jax_combine
import pycusdr_tpu_torch.combine as port_combine
from pycusdr_tpu.combine import aligner as jax_aligner
from pycusdr_tpu.combine import votes as jax_votes
from pycusdr_tpu_torch.combine import aligner as port_aligner
from pycusdr_tpu_torch.combine import votes as port_votes
from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.dsp.signal_gen import awgn, get_padded_packet, packet_data
from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

REPO = os.path.join(os.path.dirname(__file__), "..")
CONF_DIR = os.path.join(REPO, "pycusdr_tpu_torch", "config", "configs")
PKGS = {"jax": jax_combine, "port": port_combine}
#: trust values a demodulator ships (normal 2 * weight, symbol error -1,
#: clipped -2) and 0 and 1, so every vote branch is reached
TRUSTS = np.array([-2, -1, 0, 1, 2, 4], np.int8)
WAIT_S = 60.0  # bound on the warm-up, and on the feed until bytes arrive
HOP = 2**13 - 2**10


class Clock:
    """``time.time`` frozen at ``t`` until a test moves it."""

    def __init__(self, t=1.7e9):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "time", c)
    return c


def wdict(workerId, bits, trust=None, count=0, voteGroup=0):
    return {
        "workerId": workerId, "count": count, "timestamp": time.time(),
        "voteGroup": voteGroup, "doppler": 0.0, "doppler_std": 0.0, "spSymEst": 16.0,
        "SNR": 10.0, "baudRate": 9600, "protocol": "bench_FSK",
        "data": np.asarray(bits, np.int8),
        "trust": np.full(len(bits), 2, np.int8) if trust is None else np.asarray(trust, np.int8),
    }


def assert_same(a, b, where=""):
    """Exact equality of nested dicts / lists / arrays / scalars, dtypes too."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), f"{where}: keys differ"
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, f"{where}: dtype"
        assert np.array_equal(a, b), f"{where}: arrays differ"
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), f"{where}: lengths differ"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} != {b!r}"


# ------------------------------------------------------------------ votes

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_chan", [2, 3, 4, 5, 6])
def test_vote_n_equal(n_chan, seed):
    rng = np.random.RandomState(100 * n_chan + seed)
    n = 4096
    bitsM = rng.randint(0, 2, n).astype(np.int8)
    trustM = rng.choice(TRUSTS, n)
    bitsS = [rng.randint(0, 2, n).astype(np.int8) for _ in range(n_chan - 1)]
    trustS = [rng.choice(TRUSTS, n) for _ in range(n_chan - 1)]
    # every voter disqualified somewhere: the BOTH_DISTRUST branch
    dead = rng.rand(n) < 0.05
    trustM[dead] = -1
    for t in trustS:
        t[dead] = -2
    for w in (1.0, 1.2, 2.0):
        got = port_votes.do_voteN(bitsM, trustM, bitsS, trustS, w)
        want = jax_votes.do_voteN(bitsM, trustM, bitsS, trustS, w)
        assert_same(got, want)
    assert (got[1] == port_votes.BOTH_DISTRUST).any()


VOTE2_TABLE = (  # (bitM, bitS, trustM, trustS): each branch of the 2-way vote
    (1, 1, 2, 2), (0, 0, -1, -1),  # agree
    (1, 0, 2, -1), (0, 1, 0, -2),  # slave disqualified -> master
    (1, 0, -1, -1),  # both disqualified
    (0, 1, -1, 2),  # master disqualified, slave > 0 -> slave
    (1, 0, -1, 0), (0, 1, -2, 0),  # master disqualified, slave == 0: the halved sum
    (1, 0, 2, 2), (0, 1, 0, 0),  # both qualified, disagree -> master
)


def test_vote2_every_branch_equal():
    bitsM, bitsS, trustM, trustS = (np.array(c, np.int8) for c in zip(*VOTE2_TABLE))
    got = port_votes.do_vote2(bitsM, trustM, bitsS, trustS)
    assert_same(got, jax_votes.do_vote2(bitsM, trustM, bitsS, trustS))
    np.testing.assert_array_equal(got[0], [1, 0, 1, 0, 1, 1, 0, 0, 1, 0])
    np.testing.assert_array_equal(got[1], [1, 1, 0.7, 0.7, -1, 0.3, 1, 1, 0.1, 0.1])


@pytest.mark.parametrize("seed", range(4))
def test_vote2_random_equal(seed):
    rng = np.random.RandomState(seed)
    n = 8192
    bitsM, bitsS = (rng.randint(0, 2, n).astype(np.int8) for _ in range(2))
    trustM, trustS = (rng.choice(TRUSTS, n) for _ in range(2))
    got = port_votes.do_vote2(bitsM, trustM, bitsS, trustS)
    assert_same(got, jax_votes.do_vote2(bitsM, trustM, bitsS, trustS))
    codes = set(np.round(got[1], 3).tolist())
    assert codes == {1.0, 0.1, 0.7, 0.3, -1.0}, codes
    assert ((trustM < 0) & (trustS == 0) & (bitsM != bitsS)).any()


# ---------------------------------------------------------------- aligner

def _aligner_case(name, rng):
    truth = rng.randint(0, 2, 4000).astype(np.int8)
    if name == "delay":
        return np.r_[rng.randint(0, 2, 1234), truth], truth, 15.0
    if name == "corrupted":
        b = np.r_[rng.randint(0, 2, 777), truth]
        b[rng.rand(len(b)) < 0.05] ^= 1
        return b, truth, 10.0
    if name == "random":
        return rng.randint(0, 2, 4000), rng.randint(0, 2, 2000), 15.0
    if name == "longer_segment":
        return truth[:1500], np.r_[truth, truth], 10.0
    if name == "few_peaks":
        return truth[:3], truth[:2], 1.0
    if name == "empty_buffer":
        return np.zeros(0, np.int8), truth, 15.0
    if name == "empty_segment":
        return truth, np.zeros(0, np.int8), 15.0
    raise KeyError(name)


@pytest.mark.parametrize("name", ["delay", "corrupted", "random", "longer_segment",
                                  "few_peaks", "empty_buffer", "empty_segment"])
def test_xcorr_peak_equal(name):
    buf, seg, var = _aligner_case(name, np.random.RandomState(7))
    got = port_aligner.xcorr_peak(buf, seg, var)
    assert_same(got, jax_aligner.xcorr_peak(buf, seg, var))
    if name == "delay":
        assert got == (1234, True)


def test_buffer_aligner_segments_equal():
    """Segments of a window with a slip each match at their own lag."""
    rng = np.random.RandomState(8)
    truth = rng.randint(0, 2, 6000).astype(np.int8)
    buf = np.r_[rng.randint(0, 2, 300), np.delete(truth, 3000)]
    port = port_aligner.BufferAligner(buf, 10.0)
    jax = jax_aligner.BufferAligner(buf, 10.0)
    lags = []
    for a in range(0, 6000, 500):
        for n in (256, 500, 1000):
            seg = truth[a:a + n]
            got = port.match(seg)
            assert_same(got, jax.match(seg), f"segment {a}+{n}")
            lags.append((got[0] - a, got[1]))
    # each segment starts 300 bits into the buffer, 299 past the slip
    assert (300, True) in lags and (299, True) in lags


# ----------------------------------------------------------------- worker

def _worker_state(w):
    return {
        "data": dict(w.data), "head": w.head, "tail": w.tail, "getCount": w.getCount,
        "totalRequestCount": w.totalRequestCount, "requests": w.getDataRequestCounter(),
        "latestCount": w.latestCount, "lastArrival": w.lastArrival,
        "arrivalTimes": [dict(a) for a in w.arrivalTimes], "voteGroup": w.voteGroup,
        "slaves": [(s.workerId, s.head, s.tail, s.count, s.timestamp) for s in w.slaves],
    }


def _worker_ops(rng):
    """One insert / serve / roll back / prune sequence: (op, argument)."""
    ops = []
    for i in range(1, 9):
        n = int(rng.randint(50, 400))
        ops.append(("insert", (rng.randint(0, 2, n), rng.choice(TRUSTS, n), i)))
        ops.append(("tick", float(rng.choice([0.1, 0.4, 1.0]))))
        ops.append(rng.choice(["serve", "serve_peer", "serve_peer2", "rollback", "prune",
                               "remove_some", "get_some"]))
        ops.append("prune")
    ops += [("tick", 10.0), "prune", "serve_peer", "remove_all", ("insert", (
        rng.randint(0, 2, 64), rng.choice(TRUSTS, 64), 12)), "remove_beyond"]
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_worker_sequence_equal(clock, seed):
    rng = np.random.RandomState(seed)
    first = rng.randint(0, 2, 300)
    workers = {k: pkg.Worker(wdict("W", first), timestampTimeOut=0.5) for k, pkg in PKGS.items()}
    for step, op in enumerate(_worker_ops(rng)):
        outs = {}
        if isinstance(op, tuple) and op[0] == "tick":
            clock.t += op[1]
            continue
        for k, w in workers.items():
            if isinstance(op, tuple):
                bits, trust, count = op[1]
                w.insertData(wdict("W", bits, trust, count=count))
            elif op == "serve":
                outs[k] = w.getSelf()
            elif op in ("serve_peer", "serve_peer2"):
                outs[k] = w.getSelf(op[6:])
            elif op == "rollback":
                out = w.getSelf()
                w.updateIdx(len(out["data"]) // 2, dataUsed=False)
                outs[k] = out
            elif op == "prune":
                w.removeOldData()
            elif op == "remove_some":
                w.removeData(len(w.data["data"]) // 3)
            elif op == "get_some":
                outs[k] = w.getData(len(w.data["data"]) // 2)
            elif op == "remove_all":
                w.removeData()
            elif op == "remove_beyond":
                with pytest.raises(IndexError):
                    w.removeData(len(w.data["data"]) + 5)
        assert_same(outs.get("port"), outs.get("jax"), f"step {step} {op}")
        assert_same(_worker_state(workers["port"]), _worker_state(workers["jax"]),
                    f"state after step {step} {op}")
    with pytest.raises(port_combine.WorkerIdError):
        workers["port"].insertData(wdict("X", [1, 0]))


# --------------------------------------------------------------- combiner

class FakeSocket:
    """``recv_pyobj`` hands out queued dicts; ``send_pyobj`` records."""

    def __init__(self):
        self.queue, self.sent = [], []

    def recv_pyobj(self, flags=0):
        return self.queue.pop(0)

    def send_pyobj(self, data, flags=0):
        self.sent.append(copy.deepcopy(data))


def _combiner_conf(which):
    if which == "shipped":
        conf = load_modular_json(os.path.join(CONF_DIR, "benchmark", "bench_3_chan_rx.json"))
    else:
        conf = load_modular_json(os.path.join(CONF_DIR, "base.json"))
        conf["SoftCombiner"]["workerDataTimeout"] = 1.5
    return conf


def _streams(name, rng):
    """(per-channel bit streams, per-channel trust, blocks a channel lags)."""
    truth = rng.randint(0, 2, 9000).astype(np.int8)

    def chan(delay, p=0.01, slip=None):
        b = np.r_[rng.randint(0, 2, delay), truth].astype(np.int8)
        if slip is not None:
            b = np.delete(b, slip) if slip > 0 else np.insert(b, -slip, 1)
        flip = rng.rand(len(b)) < p
        b[flip] ^= 1
        t = np.full(len(b), 2, np.int8)
        t[flip & (rng.rand(len(b)) < 0.5)] = -1
        return b, t

    n = {"two": 2, "six": 6}.get(name, 3)
    chans = [chan(int(rng.randint(100, 2000))) for _ in range(n)]
    lag = [0] * n
    if name == "slipped":
        chans[1] = chan(300, slip=4500)
        chans[2] = chan(150, slip=-4600)
    elif name == "lagging":
        lag[2] = 2
    elif name == "noise":
        chans[2] = (rng.randint(0, 2, 9500).astype(np.int8), np.full(9500, 2, np.int8))
    elif name == "stale":
        lag[1] = 99  # this channel stops after two blocks
    return chans, lag


@pytest.mark.parametrize("conf_name", ["shipped", "base"])
@pytest.mark.parametrize("name", ["delayed", "two", "six", "slipped", "lagging", "noise",
                                  "stale", "restart"])
def test_soft_combiner_rounds_equal(clock, name, conf_name):
    """The same containers through ``receiveData``, ``_purge_superseded``
    and ``compareWorkers`` of a combiner of each package (not started):
    the same dicts are sent in the same order, and the workers end equal."""
    rng = np.random.RandomState(sum(map(ord, name + conf_name)))
    chans, lag = _streams(name, rng)
    n_blocks = 8
    blocks = [(np.array_split(b, n_blocks), np.array_split(t, n_blocks)) for b, t in chans]
    ids = [f"st-UHF{i}" for i in range(len(chans))]
    combs = {}
    for k, pkg in PKGS.items():
        comb = pkg.SoftCombiner(_combiner_conf(conf_name))
        comb.decodeOut, comb.workers, comb.workersSubmitted = FakeSocket(), [], []
        combs[k] = comb
    demodIn = {k: FakeSocket() for k in PKGS}
    for rnd in range(n_blocks + 4):
        for c, (bb, tt) in enumerate(blocks):
            i = rnd - lag[c]
            if lag[c] == 99:
                i = rnd if rnd < 2 else -1
            if not 0 <= i < n_blocks:
                continue
            wid = ids[c]
            if name == "restart" and c == 0 and i >= 4:
                wid = ids[0] + "~r1"  # a planned restart's new generation
            for k in PKGS:
                demodIn[k].queue.append(wdict(wid, bb[i], tt[i], count=i))
        for k, comb in combs.items():
            while demodIn[k].queue:
                comb.receiveData(demodIn[k])
        clock.t += 0.35 if name != "restart" else 4.0
        for comb in combs.values():
            comb._purge_superseded()
            comb.compareWorkers()
        assert [w.workerId for w in combs["port"].workers] == \
            [w.workerId for w in combs["jax"].workers], f"round {rnd}: workers differ"
        assert [w.workerId for w in combs["port"].workersSubmitted] == \
            [w.workerId for w in combs["jax"].workersSubmitted]
    sent = {k: c.decodeOut.sent for k, c in combs.items()}
    assert len(sent["port"]) == len(sent["jax"]) > 0
    for i, (a, b) in enumerate(zip(sent["port"], sent["jax"])):
        assert_same(a, b, f"sent[{i}]")
    for a, b in zip(combs["port"].workers, combs["jax"].workers):
        assert_same(_worker_state(a), _worker_state(b), a.workerId)
    voted = [d["numSlaves"] for d in sent["port"]]
    if name != "stale":
        assert max(voted) >= 1, f"{name}: nothing was voted"
    if name == "restart":
        assert ids[0] not in [w.workerId for w in combs["port"].workers], "not purged"


def test_correlate_holds_tail_for_lagging_slave_equal(clock):
    """A slave without the window's tail yet: both packages hold the same
    tail back and vote it on the next round."""
    rng = np.random.RandomState(12)
    n = 6000
    truth = rng.randint(0, 2, n).astype(np.int8)
    outs = {}
    for k, pkg in PKGS.items():
        comb = pkg.SoftCombiner(_combiner_conf("base"))
        master = pkg.Worker(wdict("M", truth))
        slave = pkg.Worker(wdict("A", truth[: 2 * n // 3]))
        first = comb.correlate(master, [slave])
        slave.insertData(wdict("A", truth[2 * n // 3:], count=1))
        outs[k] = (first, comb.correlate(master, [slave]))
    assert_same(outs["port"], outs["jax"])
    first, second = outs["port"]
    assert len(first["data"]) < n and first["numSlaves"] == second["numSlaves"] == 1


# ------------------------------------------------- the combiner process

def longest_match_run(a, b):
    eq = np.asarray(a) == np.asarray(b)
    best = cur = 0
    for v in eq:
        cur = cur + 1 if v else 0
        best = max(best, cur)
    return best


def _process_conf(port0):
    conf = _combiner_conf("base")
    conf["SoftCombiner"].update(processingInterval=0.15, workerDataTimeout=3.5)
    conf["Interfaces"]["Internal"] = {
        "demodIn": f"tcp://*:{port0}", "demodOut": f"tcp://localhost:{port0}",
        "decodeOut": f"tcp://localhost:{port0 + 1}", "decodeIn": f"tcp://*:{port0 + 1}"}
    return conf


def _run_streams(conf, streams, n_blocks=6):
    """The port's SoftCombiner child between a PUSH feed and a PULL sink
    (cf. ``tests/test_combine.py``'s ``_run_streams``)."""
    ctx = zmq.Context()
    out = ctx.socket(zmq.PUSH)
    out.setsockopt(zmq.LINGER, 0)
    out.connect(conf["Interfaces"]["Internal"]["demodOut"])
    sink = ctx.socket(zmq.PULL)
    sink.setsockopt(zmq.LINGER, 0)
    sink.bind(conf["Interfaces"]["Internal"]["decodeIn"])
    sink.setsockopt(zmq.RCVTIMEO, 3000)
    comb = port_combine.SoftCombiner(conf)
    comb.start()
    try:
        assert comb.ready.wait(WAIT_S), f"combiner not ready within {WAIT_S} s"
        time.sleep(0.3)
        blocks = {k: np.array_split(v, n_blocks) for k, v in streams.items()}
        for i in range(n_blocks):
            for wid, chunks in blocks.items():
                out.send_pyobj(wdict(wid, chunks[i], count=i))
            time.sleep(0.2)
        results = {}
        deadline = time.time() + 6
        while time.time() < deadline:
            try:
                d = sink.recv_pyobj()
            except zmq.error.Again:
                break
            results.setdefault(d["workerId"], []).append(d)
            got = {k: sum(len(x["data"]) for x in v) for k, v in results.items()}
            if len(results) == len(streams) and all(
                    n > len(streams[k]) * 0.5 for k, n in got.items()):
                break
        return results
    finally:
        comb.stop()
        comb.join(timeout=10)
        if comb.is_alive():
            comb.terminate()
            comb.join(timeout=10)
        out.close()
        sink.close()
        ctx.term()


@pytest.mark.parametrize("n_chan", [2, 4, 6])
def test_combiner_process_n_channel_vote(n_chan):
    """2/4/6 delayed, corrupted channels over ZMQ into the port's
    combiner child: voted containers reach the sink, aligned to the truth
    with long clean runs (the JAX test's bars)."""
    rng = np.random.RandomState(40 + n_chan)
    truth = rng.randint(0, 2, 8000).astype(np.int8)
    p_flip = 0.002 if n_chan == 2 else 0.01
    streams = {}
    for i in range(n_chan):
        b = np.r_[rng.randint(0, 2, rng.randint(1000, 2000)), truth].astype(np.int8)
        b[rng.rand(len(b)) < p_flip] ^= 1
        streams[f"chan{i}"] = b
    res = _run_streams(_process_conf(18500 + 10 * n_chan), streams)
    voted = [d for v in res.values() for d in v if d.get("numSlaves", 0) > 0]
    assert voted, f"no voting happened with {n_chan} channels"
    best = 0
    for d in voted:
        bits = np.asarray(d["data"], np.int8)
        lag, ok = port_combine.xcorr_peak(np.r_[truth, np.zeros(4000, np.int8)], bits, 10.0)
        if ok:
            seg = truth[lag:lag + len(bits)]
            best = max(best, longest_match_run(bits[:len(seg)], seg))
    assert best > (600 if n_chan == 2 else 1200), f"{n_chan}-way: best clean run {best}"


# ---------------------------------------- PyCuSDR with the softCombiner

def _three_station_conf(port0):
    """``bench_3_chan_rx.json`` as shipped (softCombiner on, channel group
    off, three Rx radios) at blockSize 13, its sockets from ``port0`` on."""
    conf = load_modular_json(os.path.join(CONF_DIR, "benchmark", "bench_3_chan_rx.json"))
    conf["Main"].update(workerId="cmb", PacketLen=1000,
                        statsFolder=os.path.join("build", "test_stats"))
    conf["GPU"]["UHF"].update(blockSize=13, overlap=10)
    for i, r in enumerate(conf["Radios"]["Rx"].values()):
        r["doppCarrierSteps"] = 16
        r["Interfaces"] = {"RxInPort": f"tcp://127.0.0.1:{port0 + i}",
                           "demodOut": f"tcp://localhost:{port0 + 10}"}
    conf["Demodulator"] = {"timeoutSeconds": 60}
    conf["Interfaces"]["Internal"].update({
        "demodIn": f"tcp://*:{port0 + 10}", "demodOut": f"tcp://localhost:{port0 + 10}",
        "decodeOut": f"tcp://localhost:{port0 + 11}", "decodeIn": f"tcp://*:{port0 + 11}"})
    conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"] = {"UHF": f"tcp://*:{port0 + 12}"}
    conf["Interfaces"]["External"]["XMLRpcIn"] = f"127.0.0.1:{port0 + 13}"
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=port0 + 14)
    return conf


def test_three_station_rx_through_the_combiner(monkeypatch):
    """Three ``Demodulator_process`` children on the CPU, each fed the
    packet at its own delay with its own noise, into the combiner child
    and the decoder: the payload arrives, ``get_active_workers`` names the
    three channels, and a container reached the decoder voted by three."""
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    port0 = 18600
    conf = _three_station_conf(port0)
    delays = (0, 1117, 2403)
    bits = packet_data(1000, 123)
    sig, _ = get_padded_packet("FSK", 16, 9600 * 16, offset_freq=38400, raw_bits=bits,
                               pad=6000)
    stream = np.r_[sig, np.zeros(6 * HOP, np.complex64)]
    ctx = zmq.Context()
    pubs = []
    for i in range(3):
        s = ctx.socket(zmq.PUB)
        s.setsockopt(zmq.LINGER, 0)
        s.bind(f"tcp://127.0.0.1:{port0 + i}")
        pubs.append(s)
    sink = ctx.socket(zmq.PULL)
    sink.setsockopt(zmq.LINGER, 0)
    sink.setsockopt(zmq.RCVTIMEO, 1500)
    sdr = PyCuSDR(conf, args=None)
    assert type(sdr.combiner).__name__ == "SoftCombiner"
    assert sdr.rpcInt.softCombiner is sdr.combiner and sdr.combiner in sdr.tasks
    assert conf["Interfaces"]["Internal"]["decodeIn"] != conf["Interfaces"]["Internal"]["demodIn"]
    sdr.start()
    try:
        t0 = time.time()
        flags = {f"demod[{i}].warmedFlag": d.warmedFlag for i, d in enumerate(sdr.demodulators)}
        flags.update({"Decoder.boundFlag": sdr.dec.boundFlag, "SoftCombiner.ready":
                      sdr.combiner.ready})
        while time.time() < t0 + WAIT_S and not all(f.is_set() for f in flags.values()):
            dead = [t.name for t in sdr.tasks if not t.is_alive()]
            assert not dead, f"children {dead} died while warming"
            time.sleep(0.2)
        unset = [k for k, f in flags.items() if not f.is_set()]
        assert not unset, f"{unset} not set within {WAIT_S} s"
        assert [d.device for d in sdr.demodulators] == ["cpu"] * 3
        sink.connect(f"tcp://localhost:{port0 + 12}")
        time.sleep(0.5)
        rng = np.random.RandomState(5)
        payload, t1 = None, time.time()
        while payload is None and time.time() < t1 + WAIT_S:
            chans = [awgn(np.r_[np.zeros(d, np.complex64), stream], 14.0,
                          rng=rng).astype(np.complex64) for d in delays]
            for pos in range(0, len(stream) - HOP, HOP):
                for s, c in zip(pubs, chans):
                    s.send(c[pos:pos + HOP].tobytes())
                time.sleep(0.02)
            try:
                payload = sink.recv()
            except zmq.error.Again:
                continue
        assert payload is not None, f"no decoded bytes within {WAIT_S} s"
        expected = bytes(bytearray(sdr.protocols["UHF"].Packet(bits).getBinaryData()[0]))
        assert payload == expected
        proxy = xmlrpc.client.ServerProxy(f"http://127.0.0.1:{port0 + 13}/RPC2")
        assert sorted(proxy.get_active_workers(2.0)) == [f"cmb-UHF{i}" for i in range(3)]
        # each child counts the launches of its feed: none on the CPU
        assert all(d.blocks > 0 for d in sdr.demodulators)
        assert [sum(d.launches.values()) for d in sdr.demodulators] == [0, 0, 0]
    finally:
        sdr.terminate()
        assert not any(t.is_alive() for t in sdr.tasks), "a child outlived terminate()"
        for s in pubs + [sink]:
            s.close()
        ctx.term()
    slaves = [n for w in sdr.passStats for n in w["numSlaves"]]
    assert 2 in slaves, f"no container voted by three channels: {sorted(set(slaves))}"


def test_child_launch_counts_cover_every_kernel():
    """``Demodulator_process.launches`` names every wrapper of
    ``ops.kernel_wrappers`` and holds what the child last published."""
    from pycusdr_tpu_torch import ops
    from pycusdr_tpu_torch.runtime.demodulator_process import Demodulator_process

    conf = _three_station_conf(18690)
    d = Demodulator_process(conf, None, "UHF-H")
    counts = {name: i for i, name in enumerate(ops.kernel_wrappers())}
    d._publish_launches(counts)
    d._publish_launches(counts)
    assert d.launches == counts and d.blocks == 2



def test_child_card_memory_is_published_with_its_launches(monkeypatch):
    """``Demodulator_process.card_memory`` holds what the child last
    published beside its launches: 0 on the CPU, the allocator's figures on
    the card (``torch.cuda`` stubbed here)."""
    import torch

    from pycusdr_tpu_torch import ops
    from pycusdr_tpu_torch.runtime.demodulator_process import Demodulator_process

    d = Demodulator_process(_three_station_conf(18695), None, "UHF-H")
    counts = {name: i for i, name in enumerate(ops.kernel_wrappers())}
    assert d.card_memory == {"reserved": 0, "max_allocated": 0}
    d._device.value = b"cpu"
    d._publish_launches(counts)
    assert d.card_memory == {"reserved": 0, "max_allocated": 0}
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 3 << 30)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 5 << 20)
    d._device.value = b"cuda"
    d._publish_launches(counts)
    assert d.card_memory == {"reserved": 3 << 30, "max_allocated": 5 << 20}
    assert d.launches == counts and d.blocks == 2
