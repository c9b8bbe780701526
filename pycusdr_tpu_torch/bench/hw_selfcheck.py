"""On-card numerical selfcheck: run it on the card the modem runs on.

The port of ``pycusdr_tpu/bench/hw_selfcheck.py``. The CPU tests run the
plain PyTorch versions of the kernels, in full f32; they cannot catch a
hazard of the card's own arithmetic. The JAX package shipped one: a
"bit-exact" one-hot slot select quantized its packed integer payloads at
the TPU's default matmul precision, and every streaming block carried
garbage bits on the hardware while every CPU test passed. Integer-valued
results (bins, shifts, indices) ride in f32 on the card too, so TF32 would
round them the same way. This script pins the guarantees on a real CC11xx
burst block (a 16-byte payload whose whole burst lies inside one block):

1. the block alone (B=1) equals its row in a batch (B=4): bits, trust,
   symbols, centres and mags, bit for bit (on the CPU, whose FFT rounds a
   batch differently from one transform, mags within 1e-5 of max|mags|);
2. the plain path's packed row unpacks to the plain path's outputs, every
   one of them;
3. the bits of both forms (the block alone, a batch of the burst block and
   its noise followers) decode the packet CRC-clean through the followers;
4. TF32 is off (matmul and cuDNN) while the graphs run, and the kernel
   path's decisions (bits, trust, symbols, centres, nSym, nBits, shift)
   equal the plain path's.

Run: python -m pycusdr_tpu_torch.bench.hw_selfcheck   (on the card; --cpu
runs the plain versions on the CPU). Prints one PASS/FAIL line per check
and exits nonzero on any FAIL.
"""

import argparse
import os
import sys

import numpy as np

DECISIONS = ("bits", "trust", "symbols", "centres", "nSym", "nBits", "shift")
#: the decisions that are per-slot arrays
PACK_SLOTS = ("bits", "trust", "symbols", "centres")
#: the burst block's row in the batch of check 1
BATCH, ROW = 4, 1
#: check 1's bar on mags on the CPU, relative to max|mags|
CPU_MAGS_REL = 1e-5


def _slots(r, k):
    """Output ``k`` of an unpacked row, cut to its valid slots."""
    n = int(r["nBits"] if k in ("bits", "trust") else r["nSym"])
    return np.asarray(r[k])[:n]


def run_selfcheck(device=None, out=print) -> int:
    """The four checks on ``device`` (None: the card, raising without one;
    "cpu": the plain versions); prints a line per check with ``out`` and
    returns the number that failed."""
    import torch

    from pycusdr_tpu_torch.config.loader import load_modular_json
    from pycusdr_tpu_torch.decode import Decoder
    from pycusdr_tpu_torch.dsp.block import (build_process_batch, build_process_block,
                                             unpack_block_outputs)
    from pycusdr_tpu_torch.dsp.spec import build_spec
    from pycusdr_tpu_torch.ops._lib import resolve_device
    from pycusdr_tpu_torch.protocol import loadProtocol
    from pycusdr_tpu_torch.tx.modulator import Modulator

    dev = resolve_device(device)
    out(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    conf = load_modular_json(os.path.join(
        os.path.dirname(__file__), "..", "config", "configs", "CC11xx.json"))
    protocol = loadProtocol("CC11xx")(conf=conf)
    spec = build_spec(conf, protocol, "UHF-H")
    mod = Modulator(conf, conf["Radios"]["Tx"]["UHF"], protocol)
    # 16-byte payload: the whole burst (preamble+sync+len+16+CRC at
    # 128 sp/sym = ~34k samples) must fit INSIDE one block for the
    # single-block decode check (a 48-byte burst would span two blocks
    # and need the streaming healer, which this check deliberately
    # bypasses)
    payload = np.random.RandomState(1234).randint(0, 256, 16).astype(np.uint8)
    wave = np.asarray(mod.encodeAndModulate(payload.tobytes()), np.complex64)
    rng = np.random.RandomState(7)

    def noise():
        return (0.05 * (rng.randn(spec.Nfft) + 1j * rng.randn(spec.Nfft))).astype(np.complex64)

    block = noise()
    start = 2048
    block[start:start + len(wave)] += wave[: spec.Nfft - start]
    # CC11xx end-detection is FIXED length (267 bytes of air frame), so
    # the frame finder must be fed several blocks past the burst before
    # it emits: the burst block, then noise-floor followers
    stream = np.stack([block] + [noise() for _ in range(5)])

    alone = build_process_block(spec, device=dev, packed=True)
    batch = build_process_batch(spec, device=dev, packed=True)
    plain = build_process_block(spec, device=dev, plain=True)
    plain_packed = build_process_block(spec, device=dev, packed=True, plain=True)

    def host(v):
        return v.cpu().numpy()

    rows_alone = [host(alone(x)) for x in stream]
    quad = np.stack([stream[1], block, stream[2], stream[3]])
    assert quad.shape[0] == BATCH
    row_in_batch = host(batch(quad))[ROW]
    rows_batch = host(batch(stream))
    pd = {k: host(v) for k, v in plain(block).items()}
    pp = host(plain_packed(block))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    failed = 0

    def check(name, ok):
        nonlocal failed
        out(f"{'PASS' if ok else 'FAIL'}  {name}")
        failed += 0 if ok else 1

    ra, rb = unpack_block_outputs(rows_alone[0], spec), unpack_block_outputs(row_in_batch, spec)
    same = int(ra["nBits"]) == int(rb["nBits"]) and int(ra["nSym"]) == int(rb["nSym"])
    if dev.type == "cuda":
        mags = "mags bit-exact"
        same = same and np.array_equal(_slots(ra, "mags"), _slots(rb, "mags"))
    else:
        # the CPU's FFT rounds a batch differently from one transform, and
        # only the mags carry that rounding
        mags = f"mags within {CPU_MAGS_REL:g} of max|mags| (the CPU FFT's batch rounding)"
        ma, mb = _slots(ra, "mags"), _slots(rb, "mags")
        same = same and np.abs(ma - mb).max(initial=0.0) <= CPU_MAGS_REL * np.abs(ma).max()
    check(f"block alone (B=1) == its row in a batch (B={BATCH}): bits/trust/symbols/centres "
          f"bit-exact, {mags}",
          same and all(np.array_equal(_slots(ra, k), _slots(rb, k))
                       for k in ("bits", "trust", "symbols", "centres")))
    ru = unpack_block_outputs(pp, spec)
    check("plain path's packed row unpacks to the plain path's outputs (every output)",
          all(np.array_equal(np.asarray(ru[k]).astype(np.float32).reshape(-1),
                             np.asarray(pd[k]).astype(np.float32).reshape(-1)) for k in pd))
    for name, rows in (("block-alone", rows_alone), ("batch", rows_batch)):
        dec = Decoder(conf.get("decoder", {}), protocol)
        ok = False
        for row in rows:
            r = unpack_block_outputs(row, spec)
            pkts, _, _ = dec.findFrames(_slots(r, "bits"), 0)
            for p in pkts:
                data, crcErr, _ = p.getBinaryData()
                if not crcErr and np.array_equal(np.asarray(data), payload):
                    ok = True
        check(f"{name} bits decode the CC11xx packet CRC-clean", ok)
    tf32_ok = dev.type == "cpu" or tf32 == (False, False)
    check(f"TF32 off while the graphs ran (matmul, cuDNN: {tf32}"
          f"{'; no TF32 on the CPU' if dev.type == 'cpu' else ''}); kernel path's decisions == "
          f"plain path's ({'/'.join(DECISIONS)})",
          tf32_ok and all(np.array_equal(_slots(ra, k) if k in PACK_SLOTS else np.asarray(ra[k]),
                                         _slots(pd, k) if k in PACK_SLOTS else np.asarray(pd[k]))
                          for k in DECISIONS))
    if failed:
        out(f"{failed} selfcheck(s) FAILED")
    else:
        out("all selfchecks passed")
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(description="on-card exactness gate of the block graph")
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    return 1 if run_selfcheck("cpu" if args.cpu else None) else 0


if __name__ == "__main__":
    sys.exit(main())
