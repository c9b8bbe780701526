"""Diversity (softCombiner vote) gain measurement.

The port of ``pycusdr_tpu/bench/diversity.py``. The reference system's core
selling point is that N antenna channels with independent noise, voted bit
by bit in the softCombiner, decode packets a single channel cannot
(``softCombiner.py:10``). This harness measures it on the REAL process
pipeline (spawned demodulator children on the card -> combiner -> decoder
over ZMQ, the ``bench/ber.py`` engine): at each SNR it runs the same seeded
packet through a 1-channel arm and a 3-channel voted arm (per-channel
independent AWGN, reference ``config/benchmark/bench_3_chan_rx_base.json``
analog) and reports packet count, BER and each packet's bit errors for
both, and each arm's kernel launches and blocks.

Run: python -m pycusdr_tpu_torch.bench.diversity [--snrs -2 -1 0 1] [--runs 10]
"""

import argparse
import json

import numpy as np

#: the 3-channel arm's ports start this far above ``basePort`` (each arm
#: takes ``basePort`` .. + 104)
ARM_PORTS = 200


def run_diversity(modulation="FSK", snrs=(-2.0, -1.0, 0.0, 1.0), runs=10,
                  packetLen=10000, basePort=27200, fsSimFactor=6.0,
                  fsSimFactor3=0.5, out_path=None, verbose=True, device=None, **sweep):
    """One row per SNR. ``device``: None runs the demodulator children on the
    card (raises without one), "cpu" on the CPU. ``sweep`` goes to both arms'
    ``run_ber_sweep`` (``blockSize``, ``settle``, ...)."""
    from pycusdr_tpu_torch.bench.ber import run_ber_sweep

    # the 3-channel arm is paced much slower: three demod children on a
    # shared host must each hold real-time margin, or they stall and
    # skew apart and the measurement becomes one of host contention,
    # not diversity (the single-channel arm has no such constraint)
    arms = {}
    for nd, port, fac in ((1, basePort, fsSimFactor),
                          (3, basePort + ARM_PORTS, fsSimFactor3)):
        arms[nd] = run_ber_sweep(
            modulation, nRuns=runs, snrs=list(snrs), nDemodulators=nd,
            packetLen=packetLen, basePort=port, fsSimFactor=fac, device=device, **sweep,
        )

    rows = []
    for i, snr in enumerate(snrs):
        row = {
            "modulation": modulation, "snr_db": float(snr), "runs": runs,
            "packets_1ch": arms[1]["numPackets"][i],
            "ber_1ch": arms[1]["BER"][i],
            "packets_3ch_voted": arms[3]["numPackets"][i],
            "ber_3ch_voted": arms[3]["BER"][i],
            "bit_errors_1ch": arms[1]["bitErrors"][i],
            "bit_errors_3ch": arms[3]["bitErrors"][i],
            # each arm's whole sweep (every SNR), summed over its children
            "launches_1ch": arms[1]["launches"], "blocks_1ch": arms[1]["blocks"],
            "launches_3ch": arms[3]["launches"], "blocks_3ch": arms[3]["blocks"],
            "devices": arms[1]["devices"] + arms[3]["devices"],
        }
        rows.append(row)
        if verbose:
            print(json.dumps(row), flush=True)

    if out_path:
        np.savez(out_path, rows=json.dumps(rows),
                 meta=json.dumps({"packetLen": packetLen, "runs": runs,
                                  "modulation": modulation,
                                  "noise": "independent per channel"}))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="one channel against three voted by the "
                                             "softCombiner, demodulator children on the card")
    ap.add_argument("--modulation", default="FSK")
    ap.add_argument("--snrs", type=float, nargs="+", default=[-2.0, -1.0, 0.0, 1.0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--packetLen", type=int, default=10000)
    ap.add_argument("--basePort", type=int, default=27200)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run the demodulator children on the CPU (plain PyTorch path)")
    args = ap.parse_args(argv)
    run_diversity(args.modulation, tuple(args.snrs), args.runs,
                  packetLen=args.packetLen, basePort=args.basePort,
                  out_path=args.out, device="cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
