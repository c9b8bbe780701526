"""Offline whole-capture reprocessing rate on the card: the port of
``pycusdr_tpu/bench/capture_probe.py``.

Two routes demodulate K overlap-save hops a call with the carry on the
device (``dsp/block.py``): ``capture`` frames the K blocks on the device and
runs them as one batch (``build_process_capture``); ``scan`` walks them one
block at a time (``build_process_stream``). Both run on the same seeded
input, a GFSK capture at the IF offset with light AWGN; their decisions and
carries must be equal, and each is timed by ``profile_stages.cuda_ms`` (CUDA
events on the card) as Msamples/s of new samples.

Run: python -m pycusdr_tpu_torch.bench.capture_probe [--K 32] [--T 5]
(on the card; ``--cpu`` runs the plain versions on the CPU, ``--spec tiny``
the CPU tests' size).
"""

import argparse
import json

import numpy as np
import torch

from pycusdr_tpu_torch.bench.profile_stages import cuda_ms
from pycusdr_tpu_torch.dsp.block import build_process_capture, build_process_stream
from pycusdr_tpu_torch.dsp.signal_gen import modulate_gfsk2
from pycusdr_tpu_torch.ops._lib import resolve_device
from pycusdr_tpu_torch.utils.device_info import card_line

ROUTES = {"capture": build_process_capture, "scan": build_process_stream}
#: the decisions of a block, which both routes must give alike
DECISIONS = ("bits", "trust", "symbols", "centres", "nSym", "nBits", "shift")


def capture_input(spec, K, seed=3):
    """(hops (K, hop), carry (sigOverlap,)) of a seeded GFSK capture at the
    IF offset with AWGN 26 dB under the signal, complex64 on the host."""
    ov, N = spec.sigOverlap, spec.Nfft
    hop, sps = N - ov, int(spec.spsym)
    n = ov + K * hop
    rng = np.random.RandomState(seed)
    sig = modulate_gfsk2(rng.randint(0, 2, n // sps + 8), sps)[:n]
    sig = sig * np.exp(2j * np.pi * spec.centreFreqOffset / spec.sampleRate * np.arange(n))
    sig = (sig + 0.05 / np.sqrt(2) * (rng.randn(n) + 1j * rng.randn(n))).astype(np.complex64)
    return sig[ov:].reshape(K, hop), sig[:ov]


def _msps(fn, hops, carry, T, repeats, dev):
    return hops.numel() / (cuda_ms(lambda: fn(hops, carry), T, repeats, dev) * 1e-3) / 1e6


def capture_msps(route, K=32, T=5, repeats=7, spec=None, device=None):
    """Msamples/s of new samples of ``route`` ("capture" or "scan") over K
    hops a call (``T`` calls a timing, the median of ``repeats``)."""
    from pycusdr_tpu_torch.configs import flagship_spec

    dev = resolve_device(device)
    spec = flagship_spec() if spec is None else spec
    hops, carry = (torch.from_numpy(a).to(dev) for a in capture_input(spec, K))
    return _msps(ROUTES[route](spec, device=dev), hops, carry, T, repeats, dev)


def run_probe(K=32, T=5, routes=("capture", "scan"), spec=None, device=None, repeats=7):
    """Both routes on one input: their decisions and carries equal (else
    AssertionError), then each route's Msamples/s. Returns the JSON line's
    dict."""
    from pycusdr_tpu_torch.configs import flagship_spec

    dev = resolve_device(device)
    spec = flagship_spec() if spec is None else spec
    hops, carry = (torch.from_numpy(a).to(dev) for a in capture_input(spec, K))
    fns = {r: ROUTES[r](spec, device=dev) for r in routes}
    outs = {r: fn(hops, carry) for r, fn in fns.items()}
    (r0, (res0, c0)), *rest = outs.items()
    for r, (res, c) in rest:
        for k in DECISIONS:
            assert torch.equal(res[k], res0[k]), f"{r} and {r0} differ in {k}"
        assert torch.equal(c, c0), f"{r} and {r0} leave other carries"
    out = {"metric": "whole_capture_reprocessing", "K": K}
    for r, fn in fns.items():
        out[f"{r}_msps"] = _msps(fn, hops, carry, T, repeats, dev)
    out.update(decisions_equal=True, device=str(dev), card=card_line(dev))
    return out


def main(argv=None):
    from pycusdr_tpu_torch.configs import flagship_spec, tiny_spec

    ap = argparse.ArgumentParser(description="whole-capture reprocessing: batch against scan")
    ap.add_argument("--K", type=int, default=32, help="hops a call")
    ap.add_argument("--T", type=int, default=5, help="calls a timing")
    ap.add_argument("--routes", nargs="+", choices=list(ROUTES), default=list(ROUTES))
    ap.add_argument("--spec", choices=["flagship", "tiny"], default="flagship",
                    help="flagship, or tiny (Nfft 2^9, the CPU tests' size)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    spec = flagship_spec() if args.spec == "flagship" else tiny_spec()
    res = run_probe(args.K, args.T, tuple(args.routes), spec=spec,
                    device="cpu" if args.cpu else None)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
