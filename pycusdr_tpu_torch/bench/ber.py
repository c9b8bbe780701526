"""End-to-end BER-vs-Eb/N0 benchmark engine.

The port of ``pycusdr_tpu/bench/ber.py`` (capability parity with the
reference harness, ``examples/benchmark/bench_modem.py`` +
``create_signals.py``): a seeded packet is modulated (FSK/GFSK/GMSK/BPSK),
passed through an AWGN channel at each SNR, PUBbed into a running modem in
paced chunks that mimic GNU Radio block sizes, and the decoded packets
PULLed back out are compared bit-for-bit against the ground truth. Eb/N0
follows the reference's per-modulation bandwidth accounting
(``bench_modem.py:198-249``).

The modem under test is a full in-process ``PyCuSDR``: the same
orchestrator, processes and ZMQ fabric as production, its demodulator
children on the card (``device=None``) unless the caller asks for the CPU
(``device="cpu"``). Beside JAX's results the sweep returns the payloads it
received, the children's devices and their kernel launches and blocks
from their warm points on.
"""

import contextlib
import functools
import logging
import os
import threading
import time

import numpy as np

from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.dsp.signal_gen import awgn, get_padded_packet, packet_data
from pycusdr_tpu_torch.globals import DEVICE_ENV

log = logging.getLogger("pycusdr_tpu_torch." + __name__)

CONF_DIR = os.path.join(os.path.dirname(__file__), "..", "config", "configs")


@contextlib.contextmanager
def device_env(device):
    """The runtime's device (``PYCUSDR_TORCH_DEVICE``, which spawned
    children inherit) set to ``device`` while the block runs; None leaves it
    as it is (unset: the card)."""
    if device is None:
        yield
        return
    old = os.environ.get(DEVICE_ENV)
    os.environ[DEVICE_ENV] = str(device)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(DEVICE_ENV, None)
        else:
            os.environ[DEVICE_ENV] = old


def on_device(fn):
    """``fn`` with a keyword ``device`` (default None) that ``device_env``
    sets for the whole call, so every child ``fn`` starts, a restarted one
    too, runs there."""
    @functools.wraps(fn)
    def run(*args, device=None, **kwargs):
        with device_env(device):
            return fn(*args, **kwargs)
    return run


def child_launches(children) -> dict:
    """The kernel launches and blocks the demodulator children published
    from their warm points on, summed, and their devices."""
    launches = {}
    for d in children:
        for k, v in d.launches.items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "blocks": sum(d.blocks for d in children),
            "devices": [d.device for d in children]}


# per-modulation occupied bandwidth for Eb/N0 conversion
# (reference bench_modem.py:198-206)
def modulation_bandwidth(modulation: str, baud: float) -> float:
    fsk_delta_f = baud / 2
    return {
        "GMSK": baud / 0.7,
        "FSK": 2 * baud + 2 * fsk_delta_f,
        "GFSK": 2 * baud + 2 * fsk_delta_f,
        "BPSK": baud * 1.5,  # RRC beta=0.5
    }[modulation]


def popcount_bit_errors(got: bytes, expected: bytes) -> int:
    n = min(len(got), len(expected))
    x = np.frombuffer(got[:n], np.uint8) ^ np.frombuffer(expected[:n], np.uint8)
    errs = int(np.unpackbits(x).sum())
    errs += 8 * abs(len(got) - len(expected))
    return errs


class _Receiver(threading.Thread):
    def __init__(self, ctx, addr, expected, n_payload_bits):
        import zmq

        threading.Thread.__init__(self, daemon=True)
        self.sock = ctx.socket(zmq.PULL)
        self.sock.connect(addr)
        self.sock.setsockopt(zmq.RCVTIMEO, 500)
        self.expected = expected
        self.n_bits = n_payload_bits
        self.bitErrors = []
        self.payloads = []
        self.running = True

    def run(self):
        import zmq

        while self.running:
            try:
                payload = self.sock.recv()
            except zmq.error.Again:
                continue
            errs = popcount_bit_errors(payload, self.expected)
            self.payloads.append(payload)
            self.bitErrors.append(errs)
            log.info("packet %d: %d bit errors (BER %.4g)",
                     len(self.bitErrors), errs, errs / self.n_bits)
        self.sock.close()


def _send_run(pub_socks, sig, snr_raw, rate, chunk, rng):
    """One noisy copy of the signal, paced at the simulated sample rate."""
    delay = chunk / rate
    if np.any(sig):
        sigs = [awgn(sig, snr_raw, rng=rng).astype(np.complex64) for _ in pub_socks]
    else:  # all-zero flush blocks: nothing to scale noise against
        sigs = [sig.astype(np.complex64) for _ in pub_socks]
    for pos in range(0, len(sig), chunk):
        for s, noisy in zip(pub_socks, sigs):
            s.send(noisy[pos : pos + chunk].tobytes())
        time.sleep(delay)


@on_device
def run_ber_sweep(modulation="FSK", nRuns=3, snrs=(15.0,), *, nDemodulators=1,
                  packetLen=10000, seed=123, spSym=16, baud=9600,
                  fsSimFactor=10.0, basePort=25560, conf=None, out_path=None,
                  blockSize=None, settle=6.0, ready_timeout=90.0, args=None,
                  drain_s=3.0, drain_cap=60.0):
    """Run the BER sweep; returns a result dict (and saves npz if asked).

    ``conf`` may override the shipped bench config (a dict); ports are
    rebased onto ``basePort`` so parallel sweeps don't collide.
    ``device``: None runs the demodulator children on the card (and raises
    without one, unless ``PYCUSDR_TORCH_DEVICE`` says "cpu"); "cpu" asks
    for the plain PyTorch path on the CPU.
    """
    import zmq

    from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

    fs = spSym * baud
    bw = modulation_bandwidth(modulation, baud)

    if conf is None:
        cfg = ("bench_3_chan_rx.json" if nDemodulators > 1
               else f"bench_{modulation}.json")
        conf = load_modular_json(os.path.join(CONF_DIR, "benchmark", cfg))
        conf["Main"]["PacketLen"] = packetLen
        conf["Main"]["RandSeed"] = seed
        conf["Main"]["protocols"] = {"UHF": f"bench_{modulation}"}
        if nDemodulators > 1:
            # diversity vote through the real softCombiner (BASELINE #4)
            conf["Main"]["softCombiner_enabled"] = True
        if blockSize is not None:
            conf["GPU"]["UHF"]["blockSize"] = blockSize
        # unique ports per sweep
        p = basePort
        rx = conf["Radios"]["Rx"]
        names = list(rx.keys())[:nDemodulators]
        conf["Radios"]["Rx"] = {n: rx[n] for n in names}
        for i, n in enumerate(names):
            rx[n]["Interfaces"] = {
                "RxInPort": f"tcp://127.0.0.1:{p + i}",
                "demodOut": f"tcp://localhost:{p + 100}",
            }
        conf["Interfaces"]["Internal"].update({
            "demodIn": f"tcp://*:{p + 100}",
            "demodOut": f"tcp://localhost:{p + 100}",
            "decodeOut": f"tcp://localhost:{p + 101}",
            "decodeIn": f"tcp://*:{p + 101}",
        })
        conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"] = {"UHF": f"tcp://*:{p + 102}"}
        conf["Interfaces"]["External"]["XMLRpcIn"] = f"127.0.0.1:{p + 103}"
        conf["decoder"] = dict(conf.get("decoder", {}), statsPort=p + 104)

    bits = packet_data(packetLen, seed)
    sig, _ = get_padded_packet(modulation, spSym, fs, offset_freq=38400,
                               raw_bits=bits, pad=10000)
    sig = sig.astype(np.complex64)

    sdr = PyCuSDR(dict(conf), args=args)
    sdr.start()

    ctx = zmq.Context()
    pubs = []
    for i in range(nDemodulators):
        s = ctx.socket(zmq.PUB)
        s.bind(f"tcp://127.0.0.1:{basePort + i}")
        pubs.append(s)

    expected = bytes(bytearray(
        sdr.protocols["UHF"].Packet(bits).getBinaryData()[0]
    ))
    n_bits = len(bits)
    # chunks must be smaller than the modem hop to mimic GNU Radio
    # behaviour (reference bench_modem.py:31)
    gpu = conf["GPU"]["UHF"]
    hop = 2 ** gpu["blockSize"] - 2 ** gpu["overlap"]
    chunk = min(2**14, hop // 2)
    rate = fs * fsSimFactor / max(nDemodulators, 1)
    rng = np.random.RandomState(seed + 1)

    results = {"SNR": [], "EBN0": [], "BER": [], "numPackets": [], "bitErrors": [],
               "payloads": []}
    try:
        # readiness handshake: stream noise until every demod child has
        # processed its first block (baudRateEst flips non-zero), so the
        # sweep never races the spawn + kernel warm-up; ``settle`` is a
        # minimum soak after readiness, ``ready_timeout`` the cap
        t_start = time.time()
        deadline = t_start + ready_timeout
        noise = (np.sqrt(0.05) * rng.randn(chunk)).astype(np.complex64)
        while time.time() < deadline:
            for s in pubs:
                s.send(noise.tobytes())
            time.sleep(chunk / rate)
            if (all(d.baudRateEst != 0 for d in sdr.demodulators)
                    and time.time() - t_start >= min(settle, ready_timeout)):
                break
        else:
            log.warning("demodulators not confirmed ready before deadline")

        for snr in snrs:
            snr_raw = snr + 10 * np.log10(bw / fs)
            out_port = int(
                conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"]["UHF"].rsplit(":", 1)[1]
            )
            rx = _Receiver(ctx, f"tcp://localhost:{out_port}", expected, n_bits)
            rx.start()
            # noise lead-in/out flushes the overlap-save pipeline
            # (sent in paced chunks like GNU Radio would)
            lead = (np.sqrt(0.05) * rng.randn(4 * chunk)).astype(np.complex64)
            _send_run(pubs, lead, 100.0, rate, chunk, rng)
            for _ in range(nRuns):
                _send_run(pubs, sig, snr_raw, rate, chunk, rng)
            _send_run(pubs, lead, 100.0, rate, chunk, rng)
            _send_run(pubs, np.zeros(6 * chunk, np.complex64), 100.0, rate, chunk, rng)
            # adaptive drain: the demod children may lag the paced send
            # (especially multi-channel on a shared host); wait until no
            # packet has arrived for ``drain_s`` seconds so results from
            # this SNR point never bleed into the next
            t_drain = time.time()
            n_seen = len(rx.bitErrors)
            while time.time() - t_drain < drain_cap:
                time.sleep(0.5)
                if len(rx.bitErrors) != n_seen:
                    n_seen = len(rx.bitErrors)
                    t_drain = time.time()
                elif time.time() - t_drain >= drain_s:
                    break
            rx.running = False
            rx.join(timeout=3)

            errs = rx.bitErrors
            ber = float(np.mean(np.asarray(errs) / n_bits)) if errs else 1.0
            results["SNR"].append(float(snr))
            results["EBN0"].append(float(snr + 10 * np.log10(bw / baud)))
            results["BER"].append(ber)
            results["numPackets"].append(len(errs))
            results["bitErrors"].append(list(errs))
            results["payloads"].append(list(rx.payloads))
            log.info("SNR %5.1f dB | Eb/N0 %5.2f dB | packets %d/%d | BER %.5g",
                     snr, results["EBN0"][-1], len(errs), nRuns, ber)
    finally:
        results.update(child_launches(sdr.demodulators))
        sdr.terminate()
        for s in pubs:
            s.close()
        ctx.term()

    if out_path:
        np.savez(out_path, modulation=modulation, nRuns=nRuns, fs=fs, baud=baud,
                 lenBitData=n_bits, **{k: np.asarray(v, dtype=object)
                                       if k in ("bitErrors", "payloads") else np.asarray(v)
                                       for k, v in results.items()
                                       if k not in ("launches", "devices")})
        log.info("saved results to %s", out_path)
    return results


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description="BER sweep through the full modem "
                                             "(PyCuSDR, demodulator children on the card)")
    ap.add_argument("--modulation", default="FSK", choices=["FSK", "GFSK", "GMSK", "BPSK"])
    ap.add_argument("--snrs", type=float, nargs="+", default=[15.0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--packetLen", type=int, default=10000)
    ap.add_argument("--blockSize", type=int, default=None)
    ap.add_argument("--basePort", type=int, default=25560)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run the demodulator children on the CPU (plain PyTorch path)")
    args = ap.parse_args(argv)
    res = run_ber_sweep(args.modulation, args.runs, args.snrs, packetLen=args.packetLen,
                        blockSize=args.blockSize, basePort=args.basePort, out_path=args.out,
                        device="cpu" if args.cpu else None)
    print(json.dumps({k: v for k, v in res.items() if k != "payloads"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
