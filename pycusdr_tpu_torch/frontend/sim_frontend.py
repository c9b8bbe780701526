"""Software stand-in for the GNU Radio / SDR front-end.

The port's copy of ``examples/gnuradio/sim_frontend.py``. It plays the role
of the reference's loopback flowgraphs
(``/root/reference/examples/loopback_uhd_example/uhd_graph.py:1-307``)
with zero GNU Radio install: it PUBs complex64 IQ into every configured
Rx radio at the documented wire format (chunks below the modem hop,
paced at the sample rate) and PULLs Tx burst waveforms where a USRP
would. An operator can smoke-test the full modem against a live-like
signal — including a synthesized LEO pass with an S-curve Doppler
ramp — before ever touching hardware; the reference's flowgraphs remain
the hardware path (see ``examples/gnuradio/README.md``). It runs on the
host alone (numpy, ZMQ), and imports no torch.

Sources:
  --iq FILE         stream a raw complex64 capture on a loop
  (default)         synthesize protocol-correct packets every
                    --interval seconds over a noise floor, optionally
                    with a LEO Doppler S-curve (--pass-duration)

Examples:
  # terminal 1: the modem, on the card
  python -m pycusdr_tpu_torch -c pycusdr_tpu_torch/config/configs/benchmark/bench_FSK.json -v
  # terminal 2: a simulated pass at 10 dB SNR with +/-2 kHz Doppler
  python -m pycusdr_tpu_torch.frontend.sim_frontend \
      -c pycusdr_tpu_torch/config/configs/benchmark/bench_FSK.json \
      --snr 10 --doppler-max 2000 --pass-duration 120
"""

import argparse
import logging
import sys
import threading
import time

import numpy as np
import zmq

from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.protocol import loadProtocol

log = logging.getLogger("sim_frontend")

CHUNK = 4095  # GNU Radio-style block size (examples/gnuradio/README.md)


def synth_packet(conf, radioName, payload_len, seed):
    """One protocol-correct burst at the radio's IF offset.

    Benchmark protocols get the seeded bench packet (so the modem's
    per-packet BER check engages); framed protocols (CC11xx, AX.25,
    CCSDS) go through the package's own Tx framer + LUT modulator.
    """
    confRadio = conf["Radios"]["Rx"][radioName]
    protoName = conf["Main"]["protocols"][confRadio["Protocol"]]
    protocol = loadProtocol(protoName)(conf=conf)

    if protoName.startswith("bench_"):
        from pycusdr_tpu_torch.dsp.signal_gen import get_padded_packet, packet_data

        fs = confRadio["baud"] * confRadio["samplesPerSym"]
        bits = packet_data(conf["Main"].get("PacketLen", 10000),
                           conf["Main"].get("RandSeed", 123))
        mod = protoName.split("_", 1)[1]
        sig, _ = get_padded_packet(mod, confRadio["samplesPerSym"], fs,
                                   offset_freq=confRadio["frequencyOffset_Hz"],
                                   raw_bits=bits, pad=0)
        return sig.astype(np.complex64)

    from pycusdr_tpu_torch.tx.modulator import Modulator

    rng = np.random.RandomState(seed)
    payload = rng.randint(0, 256, payload_len).astype(np.uint8).tobytes()
    modul = Modulator(conf, confRadio, protocol)
    return np.asarray(modul.encodeAndModulate(payload), np.complex64)


class TxSink(threading.Thread):
    """PULLs Tx bursts where the USRP DAC would sit; optionally saves
    or loops them back into the Rx stream."""

    def __init__(self, ctx, addr, save=None, loop_q=None):
        threading.Thread.__init__(self, daemon=True)
        self.sock = ctx.socket(zmq.PULL)
        # modem binds its TxModToUSRPPort: connect to it
        self.sock.connect(addr.replace("*", "localhost"))
        self.sock.setsockopt(zmq.RCVTIMEO, 500)
        self.save = save
        self.loop_q = loop_q
        self.running = True
        self.n = 0

    def run(self):
        while self.running:
            try:
                raw = self.sock.recv()
            except zmq.error.Again:
                continue
            except zmq.error.ContextTerminated:
                # harness tore the context down mid-recv: normal exit, once
                # the socket is closed (the example returns with it open,
                # and its context's term() then waits forever)
                break
            burst = np.frombuffer(raw, np.complex64)
            self.n += 1
            log.info("Tx burst %d: %d samples, peak %.3f", self.n,
                     len(burst), float(np.abs(burst).max(initial=0.0)))
            if self.save:
                with open(self.save, "ab") as f:
                    f.write(raw)
            if self.loop_q is not None:
                self.loop_q.append(burst)
        self.sock.close(linger=0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-c", "--configFile", required=True)
    ap.add_argument("--radio", action="append", default=None,
                    help="Rx radio name(s) to feed (default: all)")
    ap.add_argument("--iq", default=None, help="raw complex64 file to loop")
    ap.add_argument("--snr", type=float, default=15.0, help="burst SNR dB")
    ap.add_argument("--interval", type=float, default=4.0,
                    help="seconds between synthesized packets")
    ap.add_argument("--payload-len", type=int, default=100)
    ap.add_argument("--vary-payload", action="store_true",
                    help="new payload per burst (seed+k) — identical "
                         "payloads repeated faster than the decoder's "
                         "MD5-dedup window (decoder.packetCheckHist"
                         "Timeout) are dropped as cross-channel dupes")
    ap.add_argument("--doppler-max", type=float, default=0.0,
                    help="S-curve Doppler amplitude in Hz")
    ap.add_argument("--pass-duration", type=float, default=120.0,
                    help="LEO pass length for the S-curve (s)")
    ap.add_argument("--duration", type=float, default=None,
                    help="stop after this many seconds (default: forever)")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="pacing multiplier (1.0 = real time)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--tx-save", default=None,
                    help="append received Tx bursts to this .c64 file")
    ap.add_argument("--tx-loopback", action="store_true",
                    help="mix received Tx bursts back into the Rx stream")
    ap.add_argument("-v", action="count", default=0)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO if args.v else logging.WARNING,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    conf = load_modular_json(args.configFile)

    rxConf = conf["Radios"]["Rx"]
    radios = args.radio or list(rxConf)
    ctx = zmq.Context()

    pubs = {}
    for r in radios:
        addr = rxConf[r]["Interfaces"]["RxInPort"]
        s = ctx.socket(zmq.PUB)
        # the modem SUB-connects to RxInPort, so the front-end binds
        s.bind(addr.replace("localhost", "127.0.0.1"))
        pubs[r] = s
        print(f"PUB IQ -> {r} on {addr}")

    loop_q = [] if args.tx_loopback else None
    sinks = []
    for name, t in conf["Radios"].get("Tx", {}).items():
        addr = t["Interfaces"].get("TxModToUSRPPort")
        if addr:
            sink = TxSink(ctx, addr, save=args.tx_save, loop_q=loop_q)
            sink.start()
            sinks.append(sink)
            print(f"PULL Tx <- {name} on {addr}")

    r0 = rxConf[radios[0]]
    fs = r0["baud"] * r0["samplesPerSym"]
    rng = np.random.RandomState(args.seed)

    if args.iq:
        capture = np.fromfile(args.iq, np.complex64)
        print(f"looping {len(capture)} samples from {args.iq}")
        burst = None
    else:
        burst = synth_packet(conf, radios[0], args.payload_len, args.seed)
        print(f"synthesized burst: {len(burst)} samples "
              f"({len(burst) / fs:.2f} s) at fs {fs:.0f}")
        capture = None

    noise_amp = float(np.sqrt(0.05))
    t0 = time.time()
    phase = 0.0
    pos = 0  # position in capture / burst schedule
    burst_at = 1.0  # first packet after 1 s of noise floor
    burst_idx = 0
    active = None  # (burst array, offset)
    sent = 0
    print("streaming (ctrl-c to stop)...")
    try:
        while args.duration is None or time.time() - t0 < args.duration:
            t = sent / fs
            if capture is not None:
                # contiguous circular read: the tail plays out and the
                # stream wraps to the head without skipping samples
                idx = (pos + np.arange(CHUNK)) % len(capture)
                chunk = capture[idx]
                pos = (pos + CHUNK) % len(capture)
            else:
                chunk = noise_amp * (rng.randn(CHUNK) + 1j * rng.randn(CHUNK)
                                     ).astype(np.complex64) * np.float32(0.7071)
                if active is None and t >= burst_at:
                    if args.vary_payload and burst_idx > 0:
                        burst = synth_packet(conf, radios[0],
                                             args.payload_len,
                                             args.seed + burst_idx)
                    burst_idx += 1
                    # scale the burst to the requested SNR over the floor
                    bp = np.mean(np.abs(burst) ** 2) or 1.0
                    scale = np.sqrt(0.05 * 10 ** (args.snr / 10) / bp)
                    active = (burst * np.complex64(scale), 0)
                    burst_at = t + args.interval
                if active is not None:
                    b, off = active
                    n = min(CHUNK, len(b) - off)
                    chunk[:n] += b[off : off + n]
                    active = (b, off + n) if off + n < len(b) else None
                if loop_q:
                    chunk[: len(loop_q[0][:CHUNK])] += loop_q[0][:CHUNK]
                    rest = loop_q.pop(0)[CHUNK:]
                    if len(rest):
                        loop_q.insert(0, rest)

            if args.doppler_max:
                # classic LEO S-curve (tests/test_tracking.py:92)
                fd = -args.doppler_max * np.tanh(
                    (t - args.pass_duration / 2) / (args.pass_duration / 6)
                )
                ph = phase + 2 * np.pi * fd / fs * np.arange(1, CHUNK + 1)
                chunk = chunk * np.exp(1j * ph).astype(np.complex64)
                phase = float(ph[-1] % (2 * np.pi))

            for s in pubs.values():
                s.send(chunk.astype(np.complex64).tobytes())
            sent += CHUNK
            lead = sent / fs - (time.time() - t0) * args.speed
            if lead > CHUNK / fs:
                time.sleep(lead / args.speed / 2)
    except KeyboardInterrupt:
        pass
    finally:
        for sink in sinks:
            sink.running = False
        for s in pubs.values():
            # don't block shutdown on a slow subscriber's backlog
            # (default LINGER is infinite)
            s.close(linger=500)
        ctx.term()
        print(f"\nstreamed {sent} samples ({sent / fs:.1f} s of signal), "
              f"{sum(s.n for s in sinks)} Tx bursts received")


if __name__ == "__main__":
    main()
