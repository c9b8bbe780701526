"""BER waterfall with a reference arm: the port's block graph against the
numpy golden on IDENTICAL noisy signals.

The port of ``pycusdr_tpu/bench/ber_delta.py``. BASELINE.json's north-star
metric is "BER delta vs reference at fixed SNR", and ``dsp.reference`` is a
declared numpy transliteration of the reference's hot path, golden-tested
block by block, so it serves as the reference arm: every (modulation, SNR,
run) generates ONE deterministic noisy 10,000-bit packet (reference packet
length, ``create_signals.py:10-26``) and streams the SAME samples through

* the device arm: the port's block graph (``dsp.block``; the kernels on the
  card, ``device=None``, or their plain versions with ``device="cpu"``), and
* the golden arm: ``dsp.reference.demod_block_numpy``, its result packed
  into a row of the port's layout (``golden_row``),

both handed to the SAME streaming frontend (``models.uhf.Demodulator``:
the row's unpacking, overlap-save and block healing) and the same frame
finder, so any BER difference is attributable to the device math alone.

Run:  python -m pycusdr_tpu_torch.bench.ber_delta --out results/ber_delta.npz
"""

import argparse
import json
import os
import zlib

import numpy as np

from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.ops.layout import PACK_ARRAYS, PACK_SCALARS, row_len

CONF_DIR = os.path.join(os.path.dirname(__file__), "..", "config", "configs")

DEFAULT_SNRS = {
    "FSK": (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0),
    "GFSK": (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0),
    "GMSK": (2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0),
    "BPSK": (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0),
}


def golden_row(spec, out: dict) -> np.ndarray:
    """``demod_block_numpy``'s result dict as ONE f32 row of the port's
    packed layout (``ops/layout.py``), the row the block graph returns: the
    per-slot arrays in their first nSym (bits and trust: nBits) slots, the
    scalars, E ((D, M), zeros without a Doppler search)."""
    S = spec.numSymMax
    nSym, nBits = len(out["symbols"]), len(out["bits"])
    if nSym > S:
        raise ValueError(f"the golden found {nSym} symbols, the layout holds {S}")
    row = np.zeros(row_len(S, spec.D, spec.num_masks), np.float32)
    arrays = {"bits": out["bits"], "trust": out["trust"][:nBits], "symbols": out["symbols"],
              "centres": out["centres"], "mags": out["mags"]}
    for i, k in enumerate(PACK_ARRAYS):
        v = np.asarray(arrays[k])
        row[i * S:i * S + len(v)] = v
    scalars = {k: out[k] for k in ("spSym", "codeOffset", "code_val", "dopp_idx", "quality_db",
                                   "doppler_hz", "freq_offset_hz", "snr_db", "shift")}
    scalars.update(nSym=nSym, nBits=nBits, clipped_any=len(out["clipped_idx"]) > 0)
    at = len(PACK_ARRAYS) * S
    row[at:at + len(PACK_SCALARS)] = [float(scalars[k]) for k in PACK_SCALARS]
    if out["E"] is not None:
        row[at + len(PACK_SCALARS):] = np.asarray(out["E"], np.float32).reshape(-1)
    return row


def _make_arm(conf, protocol_name, device):
    from pycusdr_tpu_torch.models import UHF
    from pycusdr_tpu_torch.protocol import loadProtocol

    protocol = loadProtocol(protocol_name)(conf=conf)
    return UHF.Demodulator(conf, protocol, "UHF-H", device=device), protocol


def _stream_one(demod, protocol, conf, sig, expected_bytes, golden: bool):
    """Stream one noisy packet through ``demod`` (its block graph, or the
    golden's row with ``golden``); return the fewest bit errors of a packet
    found, or None."""
    from pycusdr_tpu_torch.bench.ber import popcount_bit_errors
    from pycusdr_tpu_torch.decode import Decoder
    from pycusdr_tpu_torch.dsp.reference import demod_block_numpy

    decoder = Decoder(conf, protocol)
    ov = demod.sigOverlap
    step = demod.Nfft - ov
    n_blocks = int(np.ceil(len(sig) / step)) + 2
    sig = np.r_[sig, np.zeros(n_blocks * step - len(sig) + step, np.complex64)]

    buf = demod.get_signalBufferHostPointer()
    best = None
    pos = 0
    while pos + step <= len(sig):
        buf[ov:] = sig[pos : pos + step]
        if golden:
            res = demod._emit_packed_row(golden_row(demod.spec, demod_block_numpy(demod.spec, buf)))
        else:
            res = demod.process(buf)
        pkts, _, _ = decoder.findFrames(res["bits"], 0, trust=res["trust"])
        for p in pkts:
            data, _err, _raw = p.getBinaryData()
            errs = popcount_bit_errors(
                bytes(bytearray(np.asarray(data, np.uint8))), expected_bytes)
            best = errs if best is None else min(best, errs)
        buf[:ov] = buf[-ov:]
        pos += step
    return best


def run_delta(modulations=("FSK", "GFSK", "GMSK", "BPSK"), snrs=None, runs=10,
              packetLen=10000, seed=123, spSym=16, baud=9600, blockSize=None,
              overlap=None, out_path=None, verbose=True, device=None):
    """One row per (modulation, SNR): each arm's packets found, bit errors
    and BER over ``runs`` seeded noisy copies, and ``errors_by_run`` (the
    fewest bit errors of a packet found in that run, or None) for each.
    ``device``: None runs the device arm on the card (raises without one);
    "cpu" runs its plain versions on the CPU."""
    from pycusdr_tpu_torch.bench.ber import modulation_bandwidth
    from pycusdr_tpu_torch.dsp.signal_gen import awgn, get_padded_packet, packet_data

    fs = spSym * baud
    rows = []
    for mod in modulations:
        conf = load_modular_json(
            os.path.join(CONF_DIR, "benchmark", f"bench_{mod}.json"))
        conf["Main"].update(PacketLen=packetLen, RandSeed=seed,
                            protocols={"UHF": f"bench_{mod}"})
        # blockSize None keeps each config's operational envelope (2^15
        # for the bench configs); 2^13 is ~4x faster in the numpy golden
        # arm but costs GMSK/BPSK real sensitivity (only 512 symbols of
        # Doppler/timing integration per block)
        if blockSize is not None:
            conf["GPU"]["UHF"]["blockSize"] = blockSize
        if overlap is not None:
            conf["GPU"]["UHF"]["overlap"] = overlap

        arm_a, proto_a = _make_arm(conf, f"bench_{mod}", device)
        arm_b, proto_b = _make_arm(conf, f"bench_{mod}", device)

        bits = packet_data(packetLen, seed)
        clean, _ = get_padded_packet(mod, spSym, fs, offset_freq=38400,
                                     raw_bits=bits, pad=8000)
        clean = clean.astype(np.complex64)
        expected = bytes(bytearray(proto_a.Packet(bits).getBinaryData()[0]))
        n_bits = len(bits)
        bw = modulation_bandwidth(mod, baud)

        for snr in snrs.get(mod, DEFAULT_SNRS[mod]) if isinstance(snrs, dict) \
                else (snrs or DEFAULT_SNRS[mod]):
            snr_raw = snr + 10 * np.log10(bw / fs)
            by_run_a, by_run_b = [], []
            for r in range(runs):
                # stable cross-process seed (Python's str hash is salted)
                key = zlib.crc32(f"{mod}:{snr:.1f}:{r}".encode())
                rng = np.random.RandomState(key % 2**31)
                noisy = awgn(clean, snr_raw, rng=rng).astype(np.complex64)
                by_run_a.append(_stream_one(arm_a, proto_a, conf, noisy, expected, False))
                by_run_b.append(_stream_one(arm_b, proto_b, conf, noisy, expected, True))
            errs_a = [e for e in by_run_a if e is not None]
            errs_b = [e for e in by_run_b if e is not None]
            found_a, found_b = len(errs_a), len(errs_b)
            ber_a = float(np.sum(errs_a) / (max(found_a, 1) * n_bits))
            ber_b = float(np.sum(errs_b) / (max(found_b, 1) * n_bits))
            row = {
                "modulation": mod, "snr_db": float(snr),
                "ebn0_db": float(snr + 10 * np.log10(bw / baud)),
                "runs": runs,
                "found_device": found_a, "found_golden": found_b,
                "ber_device": ber_a, "ber_golden": ber_b,
                "ber_delta": ber_a - ber_b,
                "bit_errors_device": errs_a, "bit_errors_golden": errs_b,
                "errors_by_run_device": by_run_a, "errors_by_run_golden": by_run_b,
            }
            rows.append(row)
            if verbose:
                print(json.dumps(row), flush=True)

    if out_path:
        np.savez(out_path, rows=json.dumps(rows),
                 meta=json.dumps({"packetLen": packetLen, "seed": seed,
                                  "spSym": spSym, "baud": baud,
                                  "blockSize": blockSize, "runs": runs}))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="the block graph against the numpy golden on "
                                             "identical noisy packets")
    ap.add_argument("--modulations", nargs="+",
                    default=["FSK", "GFSK", "GMSK", "BPSK"])
    ap.add_argument("--snrs", type=float, nargs="+", default=None)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--packetLen", type=int, default=10000)
    ap.add_argument("--blockSize", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run the device arm's plain versions on the CPU")
    args = ap.parse_args(argv)
    run_delta(tuple(args.modulations), args.snrs, args.runs,
              packetLen=args.packetLen, blockSize=args.blockSize,
              out_path=args.out, device="cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
