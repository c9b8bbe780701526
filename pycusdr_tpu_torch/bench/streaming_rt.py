"""Real-time streaming measurement of the FULL process pipeline on the card.

The port of ``pycusdr_tpu/bench/streaming_rt.py``. Every other number is a
compute-graph number; this harness measures what a ground-station operator
actually gets: the software front end (``frontend/sim_frontend.py``) pacing
CC11xx bursts over a noise floor at the operational envelope (7416 baud x
128 sp/sym ~= 0.95 Msps, reference ``config/CC11xx.json:48-49``) into the
SPAWNED demodulator child (its CUDA context and kernels live in the child),
through the real SigFIFO -> overlap-save -> pipelined device dispatch ->
decoder -> ZMQ bytes-out fabric (reference headline log
``demodulator_process.py:330-333``).

The front-end's packet schedule runs on the SAMPLE clock, so a
``--speed S`` sweep delivers the identical signal at S times real time:
the largest S where every scheduled packet still decodes bit-exact IS
the pipeline's sustained real-time margin (the ingest ring holds only
4 hops — reference ``sigFIFO.py`` semantics — so falling behind drops
samples and packets, there is nothing to hide behind). ``pipelineDepth``
keeps that many blocks in flight on the card.

With ``--rss-trend`` the harness samples each process's RSS as the
orchestrator's cap reads it (``orchestrator.rss_mb``: the anonymous
resident set, ``RssAnon + RssShmem``; statm's resident would count every
file page of torch's CUDA libraries).

Run (on the card):  python -m pycusdr_tpu_torch.bench.streaming_rt --duration 60
CPU smoke:          python -m pycusdr_tpu_torch.bench.streaming_rt --cpu \
                        --duration 20 --speeds 1
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from pycusdr_tpu_torch.bench.ber import child_launches, on_device
from pycusdr_tpu_torch.config.loader import load_modular_json

CONF_DIR = os.path.join(os.path.dirname(__file__), "..", "config", "configs")
#: what the RSS sampler reads: the orchestrator cap's figure
RSS_FIGURE = "RssAnon + RssShmem (orchestrator.rss_mb)"
#: seconds the child is given, once warm, to drain the warm-up noise it
#: took in before the paced run (it subscribes only once warm)
BACKLOG_S = 4.0


def _build_conf(basePort, pipelineDepth, max_batch=None, max_rss_mb=0):
    conf = load_modular_json(os.path.join(CONF_DIR, "CC11xx.json"))
    p = basePort
    rx = conf["Radios"]["Rx"]["UHF-H"]
    rx["Interfaces"] = {"RxInPort": f"tcp://127.0.0.1:{p}",
                        "demodOut": f"tcp://localhost:{p + 100}"}
    # Tx unused here; point its sockets at unique ports so nothing collides
    tx = conf["Radios"]["Tx"]["UHF"]
    tx["Interfaces"] = {"TxModToUSRPPort": f"tcp://127.0.0.1:{p + 1}",
                        "TxDataIn": f"tcp://127.0.0.1:{p + 2}",
                        "TxManualIn": f"tcp://localhost:{p + 3}"}
    conf["Interfaces"]["Internal"].update({
        "demodIn": f"tcp://*:{p + 100}",
        "demodOut": f"tcp://localhost:{p + 100}",
        "decodeOut": f"tcp://localhost:{p + 101}",
        "decodeIn": f"tcp://*:{p + 101}",
    })
    conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"] = {"UHF": f"tcp://*:{p + 102}"}
    conf["Interfaces"]["External"]["XMLRpcIn"] = f"127.0.0.1:{p + 103}"
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=p + 104)
    conf["GPU"]["UHF"].setdefault("TPU", {})["pipelineDepth"] = pipelineDepth
    if max_batch is not None:
        conf["GPU"]["UHF"]["TPU"]["maxBatchBlocks"] = max_batch
    if max_rss_mb:
        conf["Main"]["maxWorkerRssMb"] = max_rss_mb
        conf["Main"]["restartDeadProcesses"] = True
        # (no dedup override needed: whenever maxWorkerRssMb is set the
        # decoder self-arms its cross-stream MD5 dedup window to
        # restartOverlapSeconds + 3 — see runtime/decoder_process.py)
    return conf


class _RssSampler(threading.Thread):
    """Per-process RSS trend for long soaks: samples every ``period``
    seconds the figure the orchestrator's cap reads (``RSS_FIGURE``);
    ``buckets(width)`` aggregates mean/max MB per process per time bucket.
    The demod child's anonymous set is where a leak of host buffers (pinned
    staging, plan caches) would show.
    """

    def __init__(self, procs, period=10.0):
        """``procs``: {name: pid} dict OR a zero-arg callable returning
        one (so planned restarts — new pids — keep being tracked)."""
        super().__init__(daemon=True)
        self._procs = procs if callable(procs) else (lambda: procs)
        self.period = period
        self.samples = []  # (t, {name: rss_mb})
        self._halt = threading.Event()

    def run(self):
        from pycusdr_tpu_torch.runtime.orchestrator import rss_mb

        t0 = time.time()
        while not self._halt.is_set():
            row = {}
            for name, pid in self._procs().items():
                try:
                    row[name] = round(rss_mb(pid), 1)
                except OSError:
                    row[name] = None
            self.samples.append((round(time.time() - t0, 1), row))
            self._halt.wait(self.period)

    def stop(self):
        self._halt.set()

    def buckets(self, width_s=300.0):
        out = {}
        for t, row in self.samples:
            b = int(t // width_s)
            for name, mb in row.items():
                if mb is None:
                    continue
                cell = out.setdefault(b, {}).setdefault(
                    name, {"n": 0, "sum": 0.0, "max": 0.0})
                cell["n"] += 1
                cell["sum"] += mb
                cell["max"] = max(cell["max"], mb)
        return [
            {"bucket_s": int(b * width_s),
             **{name: {"mean_mb": round(c["sum"] / c["n"], 1),
                       "max_mb": round(c["max"], 1)}
                for name, c in cells.items()}}
            for b, cells in sorted(out.items())
        ]


@on_device
def run_point(speed, duration_signal_s, *, basePort, pipelineDepth=2,
              snr_db=18.0, interval=3.0, payload_len=48, seed=1234,
              ready_timeout=1800.0, verbose=True, log_v=0, drain_s=20.0,
              max_batch=None, rss_trend=False, max_rss_mb=0):
    """One speed point. ``duration_signal_s`` is SIGNAL seconds (the
    wall-clock run is duration/speed + warm-up + ``BACKLOG_S`` + drain).
    ``device``: None runs the demodulator child on the card (raises without
    one), "cpu" on the CPU. Beside JAX's row: the Rx child's kernel
    launches, blocks and device from its warm point on."""
    import zmq

    from pycusdr_tpu_torch.frontend import sim_frontend
    from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

    conf = _build_conf(basePort, pipelineDepth, max_batch, max_rss_mb)
    rxc = conf["Radios"]["Rx"]["UHF-H"]
    fs = rxc["baud"] * rxc["samplesPerSym"]

    # the front-end's payload bytes are deterministic: burst k carries
    # RandomState(seed + k) bytes (--vary-payload — distinct payloads,
    # or the decoder's cross-channel MD5 dedup eats identical packets
    # that arrive inside its 1 s window during catch-up)
    # cover every burst a long soak can schedule: a 256-seed window
    # silently under-counted "bit-exact" for runs past ~13 minutes
    # (packets 256+ decoded fine but matched nothing — found when the
    # capped soak reported 252/500 exact with zero corruption)
    n_bursts = int(duration_signal_s // interval) + 8
    expected = {
        np.random.RandomState(seed + k).randint(0, 256, payload_len)
        .astype(np.uint8).tobytes()
        for k in range(max(256, n_bursts))
    }

    import tempfile
    import types

    # the device is resolved here: without a card this raises before any
    # file is written or child started
    sdr = PyCuSDR(dict(conf),
                  args=types.SimpleNamespace(v=log_v) if log_v else None)
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(conf, f)
        conf_path = f.name
    sdr.start()
    sampler = None
    if rss_trend:
        def procs():
            d = {"harness": os.getpid()}
            for t in sdr.tasks:
                pid = getattr(t, "pid", None)
                if pid:
                    d[getattr(t, "name", None) or f"pid{pid}"] = pid
            return d

        sampler = _RssSampler(procs)
        sampler.start()
    ctx = zmq.Context()
    sink = ctx.socket(zmq.PULL)
    sink.connect(f"tcp://localhost:{basePort + 102}")
    sink.setsockopt(zmq.RCVTIMEO, 250)

    got, exact = [], 0
    dup_seen, duplicates = set(), 0
    t_wall0 = None
    try:
        # readiness handshake (same discipline as bench/ber.py): stream
        # noise from a temporary PUB until the demod child has processed
        # its first real block (baudRateEst flips non-zero) — spawn +
        # device init + kernel warm-up all complete before the paced run,
        # else the 4-hop ingest ring drops the head of the measurement.
        # The child warms BEFORE subscribing, so the PUB simply drops this
        # noise until the SUB appears — no backlog — but the deadline
        # must cover the whole first build of the kernels
        warm_pub = ctx.socket(zmq.PUB)
        warm_pub.bind(f"tcp://127.0.0.1:{basePort}")
        rng = np.random.RandomState(99)
        chunk = 4095
        deadline = time.time() + ready_timeout
        noise = (np.sqrt(0.05) * (rng.randn(chunk) + 1j * rng.randn(chunk))
                 ).astype(np.complex64)
        ready = False
        while time.time() < deadline:
            warm_pub.send(noise.tobytes())
            time.sleep(chunk / fs)
            if all(d.baudRateEst != 0 for d in sdr.demodulators):
                ready = True
                break
        warm_pub.close(linger=0)
        if not ready:
            # do NOT run the paced measurement against a child that is
            # still warming — a 0/N row would read as a pipeline failure
            # when it only measures the warm-up. Report the condition instead.
            print("demod child not ready before deadline; skipping point",
                  file=sys.stderr)
            row = {"speed": speed, "input_msps": round(fs * speed / 1e6, 3),
                   "not_ready": True, "ready_timeout_s": ready_timeout}
            if verbose:
                print(json.dumps(row), flush=True)
            return row
        # backlog drain: the warm-up noise the SUB took in before the
        # handshake saw the first block; let the child consume it so the
        # paced run starts near lag zero. Some seam remains (it shows up
        # as missed packets in the first seconds), which is why the JSON
        # also reports the STEADY-STATE second half — a real front-end has
        # no pre-start backlog at all (GNU Radio only produces once the
        # SDR streams).
        time.sleep(BACKLOG_S)

        t_wall0 = time.time()
        fe = threading.Thread(
            target=sim_frontend.main,
            args=([ "-c", conf_path, "--snr", str(snr_db),
                    "--interval", str(interval),
                    "--payload-len", str(payload_len), "--vary-payload",
                    "--duration", str(duration_signal_s / speed),
                    "--speed", str(speed), "--seed", str(seed)],),
            daemon=True)
        fe.start()
        arrive = []
        t_end = t_wall0 + duration_signal_s / speed + drain_s
        while time.time() < t_end:
            try:
                raw = sink.recv()
            except zmq.error.Again:
                if not fe.is_alive() and time.time() > t_end - 15.0:
                    break
                continue
            if raw in dup_seen:
                # a make-before-break restart overlap decodes the same
                # burst in BOTH children (distinct workerId streams);
                # count each burst once, duplicates separately
                duplicates += 1
                continue
            dup_seen.add(raw)
            got.append(raw)
            arrive.append(round(time.time() - t_wall0, 1))
            if bytes(raw[:payload_len]) in expected:
                exact += 1
        fe.join(timeout=30)
    finally:
        wall = time.time() - (t_wall0 or time.time())
        if sampler is not None:
            sampler.stop()
        children = child_launches(sdr.demodulators)
        sdr.terminate()
        sink.close()
        ctx.term()
        os.unlink(conf_path)

    # sample-clock schedule: first burst at t=1s, then every `interval`;
    # a burst scheduled in the last half second straddles the stream end
    # and is not counted against the pipeline
    n_expected = int(max(0.0, (duration_signal_s - 1.5)) // interval) + 1
    row = {
        "speed": speed,
        "input_msps": round(fs * speed / 1e6, 3),
        "signal_seconds": duration_signal_s,
        "wall_seconds": round(wall, 1),
        "pipelineDepth": pipelineDepth,
        "packets_scheduled": n_expected,
        "packets_decoded": len(got),
        "packets_bit_exact": exact,
        "packets_duplicate": duplicates,
        "arrival_s": arrive,
        # steady state = bursts scheduled in the second half of the
        # stream (warm-up seam excluded; see the drain note above). The
        # schedule runs on the SAMPLE clock, so burst h0's wall time is
        # (1 + h0*interval)/speed — divide the whole expression, not
        # just the interval term
        "steady_scheduled": n_expected - (n_expected + 1) // 2,
        "steady_decoded": sum(
            1 for a in arrive
            if a >= (1.0 + ((n_expected + 1) // 2) * interval) / speed),
        **children,
    }
    if sampler is not None:
        row["rss_figure"] = RSS_FIGURE
        row["rss_trend_5min"] = sampler.buckets(300.0)
        # packet ledger per 5-min bucket (soak health at a glance)
        row["decoded_per_5min"] = [
            sum(1 for a in arrive if b * 300 <= a < (b + 1) * 300)
            for b in range(int(wall // 300) + 1)
        ]
    if verbose:
        print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description="the CC11xx station fed in real time by the "
                                             "software front end, its Rx child on the card")
    ap.add_argument("--duration", type=float, default=60.0,
                    help="SIGNAL seconds per point (wall time /= speed)")
    ap.add_argument("--speeds", type=float, nargs="+", default=[1.0, 2.0, 4.0])
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--snr", type=float, default=18.0)
    ap.add_argument("--base-port", type=int, default=26700)
    ap.add_argument("--cpu", action="store_true",
                    help="run the demodulator child on the CPU (plain PyTorch path)")
    ap.add_argument("--max-rss-mb", type=int, default=0,
                    help="enable the orchestrator's Main.maxWorkerRssMb "
                         "planned-restart cap for this run")
    ap.add_argument("--rss-trend", action="store_true",
                    help="sample per-process RSS (the cap's figure, RssAnon + "
                         "RssShmem) every 10 s and report 5-min buckets + a "
                         "per-bucket decode ledger (long-soak health)")
    ap.add_argument("--out", default=None)
    ap.add_argument("-v", action="count", default=0,
                    help="modem process verbosity (shows the demod "
                         "child's per-block rate log)")
    args = ap.parse_args(argv)

    rows = []
    for i, s in enumerate(args.speeds):
        rows.append(run_point(s, args.duration,
                              basePort=args.base_port + 200 * i,
                              pipelineDepth=args.pipeline_depth,
                              snr_db=args.snr, log_v=args.v,
                              rss_trend=args.rss_trend,
                              max_rss_mb=args.max_rss_mb,
                              device="cpu" if args.cpu else None))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"points": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
