"""Where K9's wide form spends its time, on the card.

Builds copies of ``pycusdr_tpu_torch/csrc/channelizer_wide.cu`` in which
one phase of the kernel is left out (its loop bound set to zero by a macro):
the staging of the chunks, the FIR, the DFT passes, the store, and all four
at once (the skeleton: the launch, the carry, the twiddles and the
barriers). Each copy is compiled by ``nvcc`` into ``build/k9_phases/`` and
called through its plain C entry point on the same inputs; the device ms of
one launch (torch.profiler, the ``channelize_wide`` kernel) of every copy
at each shape says what a phase costs when the others stay. Only the full
copy's output is right, and it is checked against the plain version.

    python3 chip_k9_phases.py            # the three shapes of the wide form's rows
    python3 chip_k9_phases.py --shapes 4096,2,1024

Prints the card's name and power limit, a line a shape, and one JSON line.
Needs a card and ``nvcc``; imports nothing of JAX.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from pycusdr_tpu_torch.ops import _lib
from pycusdr_tpu_torch.ops.demod_kernels import twiddle_table
from pycusdr_tpu_torch.parallel import channelizer as pch
from pycusdr_tpu_torch.utils.device_info import card_line

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "pycusdr_tpu_torch" / "csrc" / "channelizer_wide.cu"
OUT = ROOT / "build" / "k9_phases"
#: (M, K, T), T M = 2^22: the shapes chip_smoke times the wide form at
SHAPES = ((2048, 8, 2048), (64, 40, 65536), (4096, 2, 1024))
#: a phase: the source text of its loop head and the same with the bound a
#: macro can set to zero
PHASES = {
    "stage": ("const int n = SPAN ? (TT + K - 1) * C : TT * C;",
              "const int n = SKIP_STAGE ? 0 : (SPAN ? (TT + K - 1) * C : TT * C);"),
    "fir": ("for (int u = threadIdx.x; u < FJOBS; u += NT) {",
            "for (int u = threadIdx.x; u < (SKIP_FIR ? 0 : FJOBS); u += NT) {"),
    "dft": ("wide_passes<M, NT, TT>(W, tws);",
            "if (!SKIP_DFT) wide_passes<M, NT, TT>(W, tws);"),
    "store": ("for (int u = threadIdx.x; u < TT * C; u += NT) {",
              "for (int u = threadIdx.x; u < (SKIP_STORE ? 0 : TT * C); u += NT) {"),
}
VARIANTS = {"full": (), "no stage": ("stage",), "no fir": ("fir",), "no dft": ("dft",),
            "no store": ("store",), "skeleton": tuple(PHASES)}


def build():
    """Compile every variant, all at once; returns {name: the C entry point}."""
    src = SOURCE.read_text()
    for name, (old, new) in PHASES.items():
        assert src.count(old) == 1, f"{SOURCE.name}: the {name} loop head is not found once"
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "channelizer_wide.cu").write_text(src)
    procs = {}
    for var, skips in VARIANTS.items():
        lib = OUT / f"{var.replace(' ', '_')}.so"
        flags = [f"-DSKIP_{p.upper()}={int(p in skips)}" for p in PHASES]
        procs[var] = (lib, subprocess.Popen(
            [_lib._nvcc(), *_lib.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-I", str(_lib.CSRC), *flags, str(OUT / "channelizer_wide.cu"), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for var, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {var} variant:\n{log}")
        fn = ctypes.CDLL(str(lib)).pycusdr_channelize_wide
        fn.argtypes = _lib.SIGNATURES["pycusdr_channelize_wide"]
        fn.restype = ctypes.c_int
        entries[var] = fn
    return entries


def device_ms(call, calls=20):
    """Device ms of one launch of the wide kernel (torch.profiler), the mean
    over ``calls`` after a warm one."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "channelize_wide<" in e.key]
    n = sum(e.count for e in ev)
    assert n == calls, f"the trace holds {n} launches of {calls}"
    return sum(e.self_device_time_total for e in ev) / 1e3 / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="*", help="M,K,T (default: the three wide shapes)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k9_phases: no CUDA device is available", file=sys.stderr)
        return 2
    shapes = [tuple(map(int, s.split(","))) for s in args.shapes] if args.shapes else SHAPES
    card = card_line()
    print(card, flush=True)
    entries = build()
    out = {}
    for M, K, T in shapes:
        rng = np.random.RandomState(M + K + T)
        x = torch.from_numpy(((rng.randn(T * M) + 1j * rng.randn(T * M)) / np.sqrt(2))
                             .astype(np.complex64)).cuda()
        st = torch.from_numpy(((rng.randn(K - 1, M) + 1j * rng.randn(K - 1, M)) / np.sqrt(2))
                              .astype(np.complex64)).cuda()
        h2 = pch.Channelizer(M, K, device="cuda").h2
        tw = twiddle_table(M, "cuda")
        y = torch.empty((M, T), dtype=torch.complex64, device="cuda")
        carry = torch.empty((K - 1, M), dtype=torch.complex64, device="cuda")
        row = {}
        for var, fn in entries.items():
            def call(fn=fn):
                err = fn(x.data_ptr(), st.data_ptr(), h2.data_ptr(), tw.data_ptr(), y.data_ptr(),
                         carry.data_ptr(), T, M, K, torch.cuda.current_stream().cuda_stream)
                assert err == 0, f"{var}: CUDA error {err}"
            row[var] = device_ms(call)
            if var == "full":
                yp, sp = pch.channelize_plain(x, h2, st)
                torch.cuda.synchronize()
                rel = float((y - yp).abs().max()) / float(yp.abs().max())
                assert rel <= 1e-5 and torch.equal(carry, sp), f"({M}, {K}): err {rel}"
        full = row["full"]
        out[f"M={M} K={K} T={T}"] = row
        print(f"{card} | K9 wide M={M} K={K} T={T} ({pch.k9_plan(M, K)['stage']} stage): "
              f"device ms full {full:.5f}; "
              + "; ".join(f"{v} {ms:.5f} ({full - ms:+.5f})" for v, ms in row.items()
                          if v != "full"), flush=True)
    print(json.dumps({"card": card, "device_ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
