#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``pycusdr_tpu_torch``) on one
NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one status line each (any failure raises and exits non-zero,
and then no result line is printed):

1. device: ``nvidia-smi`` name and power limit, torch's device name;
2. build: compiles ``pycusdr_tpu_torch/csrc/*.cu`` (nvcc, sm_90a);
3. kernels: each hand-written kernel against its plain PyTorch version,
   B=1 and B=16, from seeded inputs: K1-K5 at the flagship shape
   (Nfft 2^16, D=64, M=8), and K6 with K2-K4 (K4 with the clip window)
   at the STX shape (Nfft 2^17, M=8, W=3); K7 (the Viterbi trellis) on
   hard, soft ±1/0 and soft random-float symbols, terminated and
   streaming, metric-only and decode, at the node-sync shape (S=2,
   T=2016/2015), the decode shape (S=1, T=2144) and T=2^15;
4. main paths, each with the launch counts set to 0 just before it and
   read just after it:
   a. flagship: the UHF demodulator (``models.uhf.Demodulator``) on a
      known GFSK signal over 16 hops through ``process``, ``processMany``
      and ``processCapture``; the bits must agree with each other and
      with the plain path on the card, recover the transmitted bits (BER < 1e-3)
      and the Doppler offset; K1-K5 must launch, K6 not;
   b. STX: the STX demodulator (``models.stx.Demodulator``) on a GFSK
      signal at the fixed IF offset with an interference burst in one
      hop, the same four ways; BER < 1e-3 on the bits not tagged trust
      -2, trust -2 near the burst and nowhere far from it, clipped_any
      set in that block alone; K2, K3, K4, K6 must launch, K1 and K5 not;
   c. ccsds: the concatenated CCSDS downlink at the flagship width: the
      port's ``Modulator`` makes 16 frames (RS(255,223) + ASM + conv
      K=7 r=1/2, FSK) at a +3000 Hz Doppler, AWGN at 10 dB and at
      LOW_SNR_DB (raw demodulated BER >= 1e-3, printed), then
      ``models.uhf.Demodulator`` (``process`` per hop and
      ``processMany(16)``) and ``decode.Decoder.findFrames`` with trust
      (the streaming Viterbi, frame sync, RS): all 16 payloads bit-exact
      both ways at both SNRs; at the low SNR the plain path (plain block
      graph, plain Viterbi stream) gives the same packets; K1-K5 and K7
      must launch, K6 not;
5. times: CUDA-event medians per kernel, its plain version and a
   PyTorch library yardstick (where one call computes the same
   function) at B=1/16/64, and the whole block graph against the plain
   path, for both configurations; K7 at S=1/2/64 with ns per trellis
   step; the decoder's host ms per block beside the graph's; every time
   must clear its bound;
6. profile: device busy time by kernel and the device's idle share over
   calls of the block graph (torch.profiler): flagship at B=1 and 16,
   STX at B=1.

It then prints the card line, one JSON line with every kernel's numbers,
and as its last line ``{"ok": true, "device": {...}}``. It imports
nothing of JAX.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from pycusdr_tpu_torch import ops
from pycusdr_tpu_torch.configs import RADIO, ccsds_conf, ccsds_spec, flagship_conf, stx_conf
from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.decode import Decoder
from pycusdr_tpu_torch.dsp.block import build_process_batch
from pycusdr_tpu_torch.dsp.signal_gen import awgn, modulate_gfsk2
from pycusdr_tpu_torch.dsp.spec import build_spec
from pycusdr_tpu_torch.models import STX, UHF
from pycusdr_tpu_torch.ops import _lib
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops import doppler_search as ds
from pycusdr_tpu_torch.ops import viterbi as vit
from pycusdr_tpu_torch.protocol import loadProtocol
from pycusdr_tpu_torch.protocol.ccsds import RS_K
from pycusdr_tpu_torch.tx.modulator import Modulator

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SEED = 1234
DOPPLER_HZ = 3000.0  # inside the flagship grid (about +-10.9 kHz)
NOISE_STD = 0.05  # per complex sample, unit-amplitude signal (~26 dB)
N_HOPS = 16
BURST_HOP = 5  # the STX stream's interference burst lies in this hop
BURST_LEN, BURST_AMP = 8, 300.0
BATCHES = (1, 16, 64)
LINE_BATCH = 16  # the batch of processMany(16), reported in the kernels line
CCSDS_FRAMES = 16
#: the ccsds path's SNRs, per sample against the unit-power FSK signal over
#: the 153.6 kHz sample rate (Es/N0 is 12.04 dB higher); the low one gives a
#: raw demodulated BER of a few 1e-3 (about 5e-3 at Nfft 2^13 on the CPU)
SNRS_DB = (10.0, -3.0)
#: K7's shapes on the ccsds path: the two node-sync sweeps of a feed (4032
#: symbols per flagship block), the decode sweep (256 carried + 4032), and
#: the batch a multi-channel decoder would run
VIT_SYNC, VIT_DECODE, VIT_BATCH = [2016, 2015], [2144], [2144] * 64
VIT_KINDS = ("hard", "soft_pm1", "soft_float")

KERNELS = {
    "doppler_energy": ("pycusdr_tpu_torch/csrc/doppler_energy.cu",
                       "pycusdr_tpu/ops/doppler_search.py:106"),
    "mf_bank_colreduce": ("pycusdr_tpu_torch/csrc/mf_bank.cu",
                          "pycusdr_tpu/ops/demod_kernels.py:86"),
    "timing_band": ("pycusdr_tpu_torch/csrc/timing_band.cu",
                    "pycusdr_tpu/ops/cfft.py:440"),
    "symbol_detect": ("pycusdr_tpu_torch/csrc/symbol_detect.cu",
                      "pycusdr_tpu/ops/demod_kernels.py:425"),
    "doppler_estimate": ("pycusdr_tpu_torch/csrc/doppler_estimate.cu",
                         "pycusdr_tpu/ops/doppler_search.py:159"),
    "threshold_input": ("pycusdr_tpu_torch/csrc/threshold.cu",
                        "pycusdr_tpu/ops/demod_kernels.py:27"),
    "viterbi": ("pycusdr_tpu_torch/csrc/viterbi.cu", "pycusdr_tpu/ops/viterbi.py:59"),
}
#: the kernels each configuration's path runs
PATH_KERNELS = {
    "flagship": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
                 "symbol_detect"),
    "stx": ("threshold_input", "mf_bank_colreduce", "timing_band", "symbol_detect"),
    "ccsds": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
              "symbol_detect", "viterbi"),
}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def configuration(name):
    """(conf, protocol, spec, Demodulator class) of the flagship or STX."""
    conf = flagship_conf() if name == "flagship" else stx_conf()
    protocol = loadProtocol("bench_GFSK")(conf=conf)
    return conf, protocol, build_spec(conf, protocol, RADIO), (
        UHF.Demodulator if name == "flagship" else STX.Demodulator)


def signal_stream(spec, n_samples, seed=SEED, doppler_hz=DOPPLER_HZ, burst_at=None):
    """A continuous GFSK stream at the IF offset plus ``doppler_hz``, with
    AWGN and, at ``burst_at``, an interference burst; returns (samples
    complex64, transmitted bits)."""
    rng = np.random.RandomState(seed)
    sps = int(spec.spsym)
    bits = rng.randint(0, 2, n_samples // sps + 8)
    sig = modulate_gfsk2(bits, sps)[:n_samples]
    n = np.arange(n_samples)
    f = (spec.centreFreqOffset + doppler_hz) / spec.sampleRate
    sig = sig * np.exp(2j * np.pi * f * n)
    noise = NOISE_STD / np.sqrt(2) * (rng.randn(n_samples) + 1j * rng.randn(n_samples))
    sig = sig + noise
    if burst_at is not None:
        sig[burst_at:burst_at + BURST_LEN] += BURST_AMP * np.exp(2j * np.pi * rng.rand(BURST_LEN))
    return sig.astype(np.complex64), bits


def signal_blocks(spec, B, seed=SEED):
    """B blocks of signal: with distinct Doppler offsets where the spec
    searches, else at the fixed offset with a burst in every other block."""
    rows = []
    for b in range(B):
        if spec.doppler_search:
            s, _ = signal_stream(spec, spec.Nfft, seed=seed + b,
                                 doppler_hz=DOPPLER_HZ * (2.0 * b / max(B - 1, 1) - 1.0))
        else:
            s, _ = signal_stream(spec, spec.Nfft, seed=seed + b, doppler_hz=0.0,
                                 burst_at=None if b % 2 else (977 * b + 50) % spec.Nfft)
        rows.append(s)
    return torch.from_numpy(np.stack(rows)).cuda()


def kernel_inputs(spec, consts, B):
    """Every kernel's inputs at batch B, from the plain path on the card."""
    x = signal_blocks(spec, B)
    inp = dict(x=x)
    xs = x
    if not spec.disable_peak_thresholding:
        xs, hit2 = dk.threshold_input_plain(x, consts.threshold_scale)
        inp.update(hit2=hit2, hits=dk.pack_bits(hit2))
    S = torch.fft.fft(xs)
    P = S.real * S.real + S.imag * S.imag
    ref = build_process_batch(spec, device="cuda", plain=True)(x)
    shift = ref["shift"].to(torch.int32).contiguous()
    M = spec.num_masks
    off = spec.code_search_mask_offset
    colsum, colmax, colarg = dk.mf_bank_colreduce_plain(S, consts.masks_f, shift, off, M - off)
    spSym, codeOffset, code_val = dk.timing_band_plain(colsum, spec.code_idx_lo,
                                                       spec.code_idx_hi)
    inp.update(S=S, P=P, shift=shift, colsum=colsum, colmax=colmax, colarg=colarg,
               spSym=spSym, codeOffset=codeOffset, code_val=code_val)
    if spec.doppler_search:
        inp["E"] = ds.doppler_energy_plain(P, consts.Q, consts.shifts)
        inp["dopp_idx"] = ref["dopp_idx"]
    return inp


def k4_kwargs(spec, consts):
    return dict(Nfft=spec.Nfft, windowWidth=spec.windowWidth, spsymMin=spec.spsymMin,
                numSymMax=spec.numSymMax, trust_normal=consts.trust_normal)


def k5_args(spec, consts, E, P):
    return ((E, P, consts.shifts, consts.shifts_signed, consts.hz_lut),
            dict(num_dopplers=spec.num_dopplers, array_offset=spec.dopp_array_offset,
                 sum_all_masks=spec.sum_all_masks, snr_window=spec.snr_window,
                 centre_freq_offset=spec.centreFreqOffset))


def k4_plain_clip(spec, inp):
    """The plain version of K4's clip window: JAX's dilation of the hit mask."""
    if "hit2" not in inp:
        return None
    return dk.dilate_mask_plain(inp["hit2"], dk.clip_halfwidth(inp["spSym"], spec.spsymMin))


def check_doppler_estimate(spec, consts, inp):
    """K5 against its plain version, with an all-zero block appended:
    shift exact, dopp_idx within 1e-5 relative, Hz within 1e-2, quality
    and SNR within 1e-3 dB (equal where not finite). Returns the max abs
    error over dopp_idx, quality_db and snr_db."""
    E = torch.cat([inp["E"], torch.zeros_like(inp["E"][:1])])
    P = torch.cat([inp["P"], torch.zeros_like(inp["P"][:1])])
    args, kw = k5_args(spec, consts, E, P)
    got = ds.doppler_estimate(*args, **kw)
    want = ds.doppler_estimate_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[5], want[5]), f"K5 shift {got[5].tolist()} != {want[5].tolist()}"
    e_idx = float((got[0] - want[0]).abs().max())
    assert e_idx <= 1e-5 * max(1.0, float(want[0].abs().max())), f"K5 dopp_idx err {e_idx}"
    e_hz = max(float((got[i] - want[i]).abs().max()) for i in (2, 3))
    assert e_hz < 1e-2, f"K5 Hz err {e_hz}"
    err = e_idx
    for i in (1, 4):
        fin = torch.isfinite(want[i])
        assert torch.equal(fin, torch.isfinite(got[i])), f"K5 output {i} finiteness differs"
        assert torch.equal(got[i][~fin].nan_to_num(), want[i][~fin].nan_to_num())
        if bool(fin.any()):
            e = float((got[i] - want[i])[fin].abs().max())
            assert e < 1e-3, f"K5 output {i} err {e} dB"
            err = max(err, e)
    assert float(got[0][-1]) == 0.0 and float(got[4][-1]) == float("-inf"), "K5 idle block"
    return err


def check_threshold(spec, consts, inp):
    """K6 against its plain version: pass-2 masks equal except where |a -
    thr| <= 1e-5 thr (the two sum in different orders), signals within
    rtol 1e-5 where the masks agree, and a block alone gives the bits it
    gives in the batch. Returns the max abs signal error."""
    x, scale = inp["x"], consts.threshold_scale
    y, hits, anyk = dk.threshold_input(x, scale)
    yp, hp = dk.threshold_input_plain(x, scale)
    hk = dk.unpack_bits(hits, spec.Nfft)
    xd = x.to(torch.complex128)
    a = xd.abs()
    thr1 = scale * a.mean(dim=-1, keepdim=True)
    a1 = torch.minimum(a, thr1)
    thr2 = scale * a1.mean(dim=-1, keepdim=True)
    clear = ((a - thr1).abs() > 1e-5 * thr1) & ((a1 - thr2).abs() > 1e-5 * thr2)
    bad = int(((hk != hp) & clear).sum())
    assert bad == 0, f"K6 hit mask differs at {bad} clear samples"
    assert bool(hp.any()), "K6 check: no sample was clipped"
    agree = (hk == hp)[..., None].expand(-1, -1, 2)
    yr, ypr = torch.view_as_real(y)[agree], torch.view_as_real(yp)[agree]
    err = float((yr - ypr).abs().max())
    assert bool(((yr - ypr).abs() <= 1e-6 + 1e-5 * ypr.abs()).all()), f"K6 signal err {err}"
    assert torch.equal(anyk, hp.any(dim=-1).to(torch.int32)), "K6 clipped_any"
    y0, h0, _ = dk.threshold_input(x[:1].contiguous(), scale)
    torch.cuda.synchronize()
    assert torch.equal(y0[0], y[0]) and torch.equal(h0[0], hits[0]), "K6 batch != alone"
    return err


def check_kernels(spec, consts, B):
    """Each kernel of the spec's path against its plain version; returns
    name -> max abs err."""
    inp = kernel_inputs(spec, consts, B)
    M = spec.num_masks
    off = spec.code_search_mask_offset
    errs = {}

    if spec.doppler_search:
        Ep = ds.doppler_energy_plain(inp["P"], consts.Q, consts.shifts)
        Ek = ds.doppler_energy(inp["P"], consts.Q, consts.shifts)
        centre = torch.arange(B, dtype=torch.int32, device="cuda") * 37 - 100
        Epc = ds.doppler_energy_plain(inp["P"], consts.Q, consts.shifts, centre)
        Ekc = ds.doppler_energy(inp["P"], consts.Q, consts.shifts, centre)
        torch.cuda.synchronize()
        e1 = max(float((Ek - Ep).abs().max()), float((Ekc - Epc).abs().max()))
        scale1 = max(float(Ep.abs().max()), float(Epc.abs().max()))
        assert e1 <= 1e-4 * scale1, f"K1 err {e1} > 1e-4 * {scale1}"
        errs["doppler_energy"] = e1
        errs["doppler_estimate"] = check_doppler_estimate(spec, consts, inp)
    else:
        errs["threshold_input"] = check_threshold(spec, consts, inp)

    ks, km, ka = dk.mf_bank_colreduce(inp["S"], consts.masks_f, inp["shift"], off, M - off,
                                      tw=consts.tw)
    torch.cuda.synchronize()
    es = float((ks - inp["colsum"]).abs().max())
    em = float((km - inp["colmax"]).abs().max())
    assert es <= 1e-4 * float(inp["colsum"].abs().max()), f"K2 colsum err {es}"
    assert em <= 1e-4 * float(inp["colmax"].abs().max()), f"K2 colmax err {em}"
    top2 = torch.topk(dk.mf_bank_power_plain(inp["S"], consts.masks_f, inp["shift"]),
                      2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0]
    bad = int(((ka != inp["colarg"]) & clear).sum())
    assert bad == 0, f"K2 colargmax differs at {bad} clear-margin samples"
    errs["mf_bank_colreduce"] = max(es, em)

    sp, co, _ = dk.timing_band(inp["colsum"], spec.code_idx_lo, spec.code_idx_hi, tw=consts.tw)
    torch.cuda.synchronize()
    assert torch.equal(sp, inp["spSym"]), f"K3 spSym {sp.tolist()} != {inp['spSym'].tolist()}"
    e3 = float((co - inp["codeOffset"]).abs().max())
    assert e3 <= 1e-3, f"K3 codeOffset err {e3}"
    errs["timing_band"] = e3

    kw = k4_kwargs(spec, consts)
    args4 = (inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"], consts.bitLUT)
    a = dk.symbol_detect(*args4, hits=inp.get("hits"), **kw)
    b = dk.symbol_detect_plain(*args4, clip_mask=k4_plain_clip(spec, inp), **kw)
    torch.cuda.synchronize()
    names = ("symbols", "centres", "mags", "bits", "trust", "nSym", "at_win")
    assert len(a) == len(b)
    for name, u, v in zip(names, a, b):
        assert torch.equal(u, v), f"K4 {name} differs"
    if "hits" in inp:
        assert bool(b[6].any()), "K4 check: no slot met the clip window"
    errs["symbol_detect"] = 0.0
    return errs


def viterbi_inputs(kind, lengths, seed=SEED):
    """(S, Tmax, 2) f32 received symbols on the card, sequence s in the
    first lengths[s] steps: random coded bits, hard with 4% flips, soft ±1
    with 3% flips and 10% erasures (0, as trust < 0 gives), or soft ±1
    plus Gaussian noise (sigma 0.8)."""
    rng = np.random.RandomState(seed)
    S, Tmax = len(lengths), max(lengths)
    sym = vit.conv_encode(rng.randint(0, 2, S * Tmax - 6)).reshape(S, Tmax, 2)
    if kind == "hard":
        x = (sym ^ (rng.rand(S, Tmax, 2) < 0.04)).astype(np.float32)
    else:
        x = sym.astype(np.float32) * 2 - 1
        if kind == "soft_pm1":
            x[rng.rand(S, Tmax, 2) < 0.03] *= -1
            x[rng.rand(S, Tmax, 2) < 0.1] = 0.0
        else:
            x = (x + 0.8 * rng.randn(S, Tmax, 2)).astype(np.float32)
    return torch.from_numpy(x).cuda()


def check_viterbi():
    """K7 against its plain version on the card: every kind x terminated /
    streaming x metric-only / decode at the node-sync (S=2) and decode
    (S=1) shapes, and two cases at T=2^15. Bits equal; metrics equal
    (random-float soft: within 1e-6 relative). Returns (max abs metric
    error, number of cases)."""
    cases = [(lengths, kind, term, dec) for lengths in (VIT_SYNC, VIT_DECODE)
             for kind in VIT_KINDS for term in (True, False) for dec in (False, True)]
    cases += [([2 ** 15], "soft_pm1", False, True), ([2 ** 15], "hard", True, True)]
    err = 0.0
    for lengths, kind, term, dec in cases:
        x = viterbi_inputs(kind, lengths)
        kw = dict(soft=kind != "hard", terminated=term, decode=dec)
        bk, mk = vit.viterbi_sweep(x, lengths, **kw)
        bp, mp = vit.viterbi_sweep_plain(x, lengths, **kw)
        torch.cuda.synchronize()
        label = f"K7 {kind} T={lengths} terminated={term} decode={dec}"
        e = float((mk - mp).abs().max())
        if kind == "soft_float":
            assert torch.allclose(mk, mp, rtol=1e-6, atol=0), f"{label}: metric err {e}"
        else:
            assert torch.equal(mk, mp), f"{label}: metrics {mk.tolist()} != {mp.tolist()}"
        assert (bk is None) == (bp is None) == (not dec), label
        if dec:
            bad = int((bk != bp).sum())
            assert bad == 0, f"{label}: {bad} bits differ"
        err = max(err, e)
    return err, len(cases)


def best_aligned_ber(rx, tx, max_lag=400):
    """(BER, lag) of rx against tx at the best lag in [-max_lag, max_lag]."""
    best = (1.0, 0)
    for lag in range(-max_lag, max_lag + 1):
        a = rx[max(lag, 0):]
        b = tx[max(-lag, 0):]
        n = min(len(a), len(b))
        if n < len(rx) // 2:
            continue
        ber = float(np.mean(a[:n] != b[:n]))
        best = min(best, (ber, lag))
    return best


def ber_at(rx, tx, lag, keep):
    """BER of rx against tx at ``lag`` over the rx bits where ``keep``."""
    a, k = rx[max(lag, 0):], keep[max(lag, 0):]
    b = tx[max(-lag, 0):]
    n = min(len(a), len(b))
    return float(np.mean(a[:n][k[:n]] != b[:n][k[:n]])), int(np.sum(k[:n]))


def plain_demodulator(make, conf, protocol):
    """A Demodulator whose graph runs every kernel's plain PyTorch version
    on the card: the path the kernels are held against."""
    d = make(conf, protocol, RADIO)
    d._process_batch = build_process_batch(d.spec, device="cuda", packed=True, plain=True)
    return d


def drive(make, conf, protocol, stream, ov):
    """The main path: reset the counts, run ``process`` x N_HOPS,
    ``processMany(N_HOPS)`` and ``processCapture`` on fresh demodulators,
    read the counts; then the plain path. Bits and trust must be equal on
    all four. Returns (``process``'s results, the counts)."""
    hop = len(stream[ov:]) // N_HOPS
    hops = stream[ov:].reshape(N_HOPS, hop)
    dA, dB, dD = (make(conf, protocol, RADIO) for _ in range(3))
    dC = plain_demodulator(make, conf, protocol)
    for d in (dA, dB, dC, dD):
        d.get_signalBufferHostPointer()[:ov] = stream[:ov]

    ops.reset_launches()
    raw = dA.get_signalBufferHostPointer()
    seqA = []
    for i in range(N_HOPS):
        raw[ov:] = hops[i]
        seqA.append(dA.process(raw))
        raw[:ov] = raw[-ov:]
    seqB = dB.processMany(hops)
    seqD = dD.processCapture(stream[ov:])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    seqC = dC.processMany(hops)
    assert len(seqD) == N_HOPS
    for i, (a, b, c, d) in enumerate(zip(seqA, seqB, seqC, seqD)):
        for k in ("bits", "trust"):
            assert np.array_equal(a[k], b[k]), f"process != processMany at block {i} ({k})"
            assert np.array_equal(a[k], c[k]), f"kernels != plain path at block {i} ({k})"
            assert np.array_equal(a[k], d[k]), f"process != processCapture at block {i} ({k})"
    return seqA, launches


def check_launches(path, launches):
    want = PATH_KERNELS[path]
    missing = [k for k in want if launches[k] == 0]
    assert not missing, f"{path}: kernels never launched on the main path: {missing}"
    stray = [k for k, v in launches.items() if k not in want and v]
    assert not stray, f"{path}: kernels of another path launched: {stray}"


def main_path_flagship(conf, protocol, spec, make):
    N, ov = spec.Nfft, spec.sigOverlap
    stream, tx_bits = signal_stream(spec, ov + N_HOPS * (N - ov))
    seqA, launches = drive(make, conf, protocol, stream, ov)
    for i, a in enumerate(seqA):
        assert abs(a["doppler"] - DOPPLER_HZ) < spec.baudRate / 2, \
            f"block {i}: Doppler {a['doppler']} Hz, injected {DOPPLER_HZ}"
        assert math.isfinite(a["SNR"]) and a["SNR"] > 10, f"block {i}: SNR {a['SNR']}"
    rx = np.concatenate([a["bits"] for a in seqA]).astype(np.int64)
    ber, lag = best_aligned_ber(rx, tx_bits)
    assert ber < 1e-3, f"BER {ber} at lag {lag}"
    check_launches("flagship", launches)
    return dict(ber=ber, lag=lag, bits=len(rx), launches=launches,
                doppler=[round(a["doppler"], 3) for a in seqA[:3]],
                snr=[round(a["SNR"], 2) for a in seqA[:3]])


def main_path_stx(conf, protocol, spec, make):
    N, ov = spec.Nfft, spec.sigOverlap
    hop = N - ov
    burst = ov + BURST_HOP * hop + hop // 2  # block BURST_HOP alone holds it
    stream, tx_bits = signal_stream(spec, ov + N_HOPS * hop, doppler_hz=0.0, burst_at=burst)
    seqA, launches = drive(make, conf, protocol, stream, ov)
    check_launches("stx", launches)
    rx = np.concatenate([a["bits"] for a in seqA]).astype(np.int64)
    keep = np.concatenate([a["trust"] for a in seqA]) != -2
    _, lag = best_aligned_ber(rx, tx_bits)
    ber, kept = ber_at(rx, tx_bits, lag, keep)
    assert ber < 1e-3, f"STX BER {ber} at lag {lag} over {kept} untagged bits"
    near = far = 0
    for i, a in enumerate(seqA):
        tagged = a["trust"] == -2
        assert a["doppler"] == a["SNR"] == 0.0, f"block {i}: fixed-offset stats not 0"
        if i != BURST_HOP:
            assert not tagged.any(), f"block {i}: trust -2 away from the burst"
            continue
        dist = np.abs(np.asarray(a["centres"], np.int64) - (burst - BURST_HOP * hop))
        near = int(np.sum(tagged & (dist < 4 * 16)))
        far = int(np.sum(tagged & (dist > 8 * 16)))
    assert near > 0, "no bit near the burst was tagged trust -2"
    assert far == 0, f"{far} bits far from the burst were tagged trust -2"
    blocks = np.lib.stride_tricks.sliding_window_view(stream, N)[::hop][:N_HOPS]
    out = build_process_batch(spec, device="cuda")(np.ascontiguousarray(blocks))
    clipped = out["clipped_any"].tolist()
    assert clipped == [i == BURST_HOP for i in range(N_HOPS)], f"clipped_any {clipped}"
    return dict(ber=ber, lag=lag, bits=len(rx), untagged=kept, tagged_near_burst=near,
                launches=launches, spSym=[round(a["spSymEst"], 4) for a in seqA[:3]])


def packet_summary(pkts):
    """(start index, nerr, decoded bytes) of each packet; RS decodes here."""
    out = []
    for p in pkts:
        data, nerr, _ = p.getBinaryData()
        out.append((int(p.frameStartIdx), int(nerr), bytes(np.asarray(data, np.uint8))))
    return out


def decode_blocks(decoder, results, host_ms=None):
    """Each block's bits and trust through ``Decoder.findFrames`` (the
    streaming Viterbi, frame sync), then RS per packet; appends each
    block's host ms (findFrames, RS) to ``host_ms``."""
    pkts = []
    for r in results:
        t0 = time.perf_counter()
        found = decoder.findFrames(r["bits"], 0, trust=r["trust"])[0]
        t1 = time.perf_counter()
        pkts += packet_summary(found)
        if host_ms is not None:
            host_ms.append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1)))
    return pkts


def exact_frames(pkts, payloads):
    """Indices of the sent payloads that some packet carries bit-exact, and
    the count of packets RS accepted with a payload that was never sent."""
    sent = {bytes(p): i for i, p in enumerate(payloads)}
    got = {sent[d[:RS_K]] for _, n, d in pkts if n >= 0 and d[:RS_K] in sent}
    return got, sum(1 for _, n, d in pkts if n >= 0 and d[:RS_K] not in sent)


def raw_ber(rx_bits, onair):
    """BER of the demodulated bits against each frame's on-air symbols at
    the frame's best-correlating offset (frames are separated by noise)."""
    rx = rx_bits.astype(np.float64) * 2 - 1
    errs = n = 0
    for c in onair:
        c = c.astype(np.float64) * 2 - 1
        L = 1 << int(np.ceil(np.log2(len(rx) + len(c))))
        corr = np.fft.irfft(np.fft.rfft(rx, L) * np.conj(np.fft.rfft(c, L)), L)
        lag = int(np.argmax(corr[: len(rx) - len(c) + 1]))
        errs += int(np.sum((rx[lag:lag + len(c)] > 0) != (c > 0)))
        n += len(c)
    return errs / n


def main_path_ccsds():
    """The concatenated CCSDS downlink at the flagship width, through the
    port's entry points: ``Modulator.encodeAndModulate`` (16 seeded
    payloads, +DOPPLER_HZ by range rate), AWGN at each of SNRS_DB, then per
    SNR a ``process``-per-hop demodulator and a ``processMany(16)`` one,
    each feeding its own ``Decoder``. The noise covers the whole received
    stream, the overlap-save history and the flush blocks too: a receiver
    never sees exact zeros, on which the kernel and plain paths may decide
    differently (ROADMAP Queue 3). The counts are read after both SNRs;
    then the plain path (plain graph, plain Viterbi stream) at the low SNR."""
    conf = ccsds_conf()
    protocol = loadProtocol("ccsds_conv")(conf=conf)
    spec = build_spec(conf, protocol, RADIO)
    mod = Modulator(conf, conf["Radios"]["Tx"]["UHF"], protocol)
    mod.set_rangerate(DOPPLER_HZ * 3e8 / mod.Fc)
    payloads = np.random.RandomState(SEED).randint(0, 256, (CCSDS_FRAMES, RS_K)).astype(np.uint8)
    wave = np.concatenate([mod.encodeAndModulate(p) for p in payloads])
    onair = [mod.encodeAndFrame(p) for p in payloads]
    ov, hop = spec.sigOverlap, spec.Nfft - spec.sigOverlap
    K = -(-len(wave) // hop) + 2  # two blocks flush the overlap-save and the decoder
    clean = np.zeros(ov + K * hop, np.complex64)
    clean[ov:ov + len(wave)] = wave

    def run(snr, plain=False, host_ms=None):
        stream = awgn(clean, snr, measured=False,
                      rng=np.random.RandomState(SEED + 1)).astype(np.complex64)
        hops = stream[ov:].reshape(K, hop)
        if plain:
            dB = plain_demodulator(UHF.Demodulator, conf, protocol)
            dB.get_signalBufferHostPointer()[:ov] = stream[:ov]
            decB = Decoder(conf, protocol)
            decB._preprocState["viterbi"] = vit.ViterbiStream(soft=True, device="cuda",
                                                              plain=True)
            seqB = [r for i in range(0, K, N_HOPS) for r in dB.processMany(hops[i:i + N_HOPS])]
            return None, decode_blocks(decB, seqB), None, seqB
        dA, dB = UHF.Demodulator(conf, protocol, RADIO), UHF.Demodulator(conf, protocol, RADIO)
        decA, decB = Decoder(conf, protocol), Decoder(conf, protocol)
        for d in (dA, dB):
            d.get_signalBufferHostPointer()[:ov] = stream[:ov]
        raw = dA.get_signalBufferHostPointer()
        seqA = []
        for i in range(K):
            raw[ov:] = hops[i]
            seqA.append(dA.process(raw))
            raw[:ov] = raw[-ov:]
        pktsA = decode_blocks(decA, seqA, host_ms)
        seqB = [r for i in range(0, K, N_HOPS) for r in dB.processMany(hops[i:i + N_HOPS])]
        return pktsA, decode_blocks(decB, seqB), seqA, seqB

    ops.reset_launches()
    host_ms, out = [], {}
    for snr in SNRS_DB:
        out[snr] = run(snr, host_ms=host_ms if snr == SNRS_DB[-1] else None)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("ccsds", launches)
    low = SNRS_DB[-1]
    _, pkts_plain, _, seq_plain = run(low, plain=True)

    res = dict(frames=CCSDS_FRAMES, blocks=K, launches=launches)
    for snr, (pktsA, pktsB, seqA, seqB) in out.items():
        for how, pkts in (("process", pktsA), ("processMany", pktsB)):
            got, wrong = exact_frames(pkts, payloads)
            assert got == set(range(CCSDS_FRAMES)), \
                f"{snr} dB {how}: frames {sorted(set(range(CCSDS_FRAMES)) - got)} not decoded"
            res[f"{snr:g}dB_{how}"] = dict(packets=len(pkts), exact=len(got), miscorrected=wrong,
                                           max_nerr=max(n for _, n, _ in pkts))
        bits = [np.concatenate([r["bits"] for r in seq]) for seq in (seqA, seqB)]
        res[f"{snr:g}dB_process_vs_processMany"] = dict(
            packets_equal=pktsA == pktsB, bits_equal=all(
                np.array_equal(a["bits"], b["bits"]) for a, b in zip(seqA, seqB)),
            bits=[len(b) for b in bits])
        res[f"{snr:g}dB_raw_ber"] = raw_ber(bits[0].astype(np.int64), onair)
    pktsB_low, seqB_low = out[low][1], out[low][3]
    assert pkts_plain == pktsB_low, "ccsds: plain path's packets differ from the kernel path's"
    res["plain_vs_kernel"] = dict(packets_equal=True, bits_equal=all(
        np.array_equal(a["bits"], b["bits"]) for a, b in zip(seq_plain, seqB_low)))
    assert res[f"{low:g}dB_raw_ber"] >= 1e-3, f"raw BER {res[f'{low:g}dB_raw_ber']} at {low} dB"
    res["decoder_host_ms"] = dict(blocks=len(host_ms),
                                  find_frames=statistics.mean(a for a, _ in host_ms),
                                  rs=statistics.mean(b for _, b in host_ms),
                                  total_max=max(a + b for a, b in host_ms))
    return res


def cuda_ms(fn, iters=20, reps=7):
    """Median over ``reps`` of the mean CUDA-event time of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def snr_band_bins(spec, consts, dopp_idx):
    """Bins of P that K5's two SNR bands read for this run's estimates."""
    N, D, w = spec.Nfft, spec.D, spec.snr_window
    lo = torch.clamp(torch.floor(dopp_idx).long(), 0, D - 1)
    hi = torch.clamp(torch.ceil(dopp_idx).long(), 0, D - 1)
    a = torch.remainder(consts.shifts[lo].long() - w, N)
    return 2 * int(torch.remainder(consts.shifts[hi].long() + w - a, N).sum())


def bounds(spec, B, band_bins=0):
    """Least time on the card for the work each kernel's function needs at
    batch B, whatever algorithm computes it: the larger of compulsory bytes
    (inputs read once, outputs written once) over the HBM rate and the f32
    operations of the cheapest known algorithm over the f32 rate (an FFT
    of length n counted as 5 n log2 n complex, 2.5 n log2 n real).
    ``band_bins``: the P bins K5's SNR bands read in this run.
    Returns name -> (ms, by) for the kernels of the spec's path."""
    N, D, M, W, S = spec.Nfft, spec.D, spec.num_masks, spec.windowWidth, spec.numSymMax
    nb = spec.code_idx_hi - spec.code_idx_lo
    rfft = 2.5 * N * math.log2(N)
    clip = not spec.disable_peak_thresholding
    work = {
        # P, Q, shifts in; E out | the cheaper of the direct shifted dot
        # (one FMA per (b, d, m, k)) and the FFT correlation (an rfft of
        # every P and Q row, a complex product and an inverse rfft per (b, m))
        "doppler_energy": (4 * (B * N + M * N + D + B * D * M),
                           min(2 * B * D * M * N, rfft * (B + M + B * M) + 3 * B * M * N)),
        # E, the grid tables and the SNR bands' bins of P in; six scalars,
        # the shift and E (into the packed row) out | the mask sums, the
        # two top-2 scans, a sqrt and an add per band bin, the scalar tail
        "doppler_estimate": (4 * (2 * B * D * M + 3 * D + band_bins + 7 * B),
                             B * (D * M + 2 * D) + 2 * band_bins + 40 * B),
        # x in; the clipped signal, the hit bitmask and clipped_any out |
        # |x| (3 flops and a sqrt), two compares, two sums, four multiplies
        "threshold_input": (16 * B * N + B * N // 8 + 4 * B, 12 * B * N),
        # S, masks, shift in; 3 N-vectors out | M complex inverse FFTs,
        # the mask product and the power
        "mf_bank_colreduce": (8 * B * N + 8 * M * N + 4 * B + 12 * B * N,
                              B * M * (2 * rfft + 9 * N)),
        # colsum in; 3 scalars out | one real FFT (a band-pruned one needs
        # less), then |.|^2 and the argmax over the band
        "timing_band": (4 * B * N + 12 * B, B * (rfft + 4 * nb)),
        # the W-sample windows of every slot (at most N samples), one
        # colargmax read per slot and (clip) the hit bitmask in; 14 bytes
        # per slot + nSym out
        "symbol_detect": (B * (4 * min(S * W, N) + 4 * S + 14 * S + 4 + (N // 8 if clip else 0)),
                          B * S * (W + 8)),
    }
    out = {}
    for name in PATH_KERNELS["flagship" if spec.doppler_search else "stx"]:
        nbytes, flops = work[name]
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        out[name] = (1e3 * max(tb, tf), "bytes" if tb >= tf else "operations")
    return out


def check_bounds(t, bnd, B, label):
    """A lower bound that a measured time beats counts the wrong work."""
    for k, (ms, pms, lms) in t.items():
        for what, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms)):
            assert v is None or v >= bnd[k][0], \
                f"{label} B={B} {k}: {what} {v} is below bound_ms {bnd[k][0]}"


def time_kernels(spec, consts, B):
    """name -> (ms, plain_ms, library_ms or None) at batch B for the
    kernels of the spec's path; the whole graph and the plain path; the
    bins K5's SNR bands read."""
    inp = kernel_inputs(spec, consts, B)
    M, N = spec.num_masks, spec.Nfft
    off = spec.code_search_mask_offset
    lo, hi = spec.code_idx_lo, spec.code_idx_hi
    Y = dk._rolled(inp["S"], inp["shift"])[:, None, :] * consts.masks_f[None]
    kw = k4_kwargs(spec, consts)
    args4 = (inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"], consts.bitLUT)
    hits = inp.get("hits")
    t = {}
    if spec.doppler_search:
        idx = (torch.arange(N, device="cuda")[None, :] + consts.shifts.long()[:, None]) % N
        Pg = inp["P"][:, idx]
        QT = consts.Q.T.contiguous()
        t["doppler_energy"] = (
            cuda_ms(lambda: ds.doppler_energy(inp["P"], consts.Q, consts.shifts)),
            cuda_ms(lambda: ds.doppler_energy_plain(inp["P"], consts.Q, consts.shifts)),
            cuda_ms(lambda: torch.matmul(Pg, QT)))
        a5, kw5 = k5_args(spec, consts, inp["E"], inp["P"])
        t["doppler_estimate"] = (cuda_ms(lambda: ds.doppler_estimate(*a5, **kw5)),
                                 cuda_ms(lambda: ds.doppler_estimate_plain(*a5, **kw5)), None)
        band_bins = snr_band_bins(spec, consts, inp["dopp_idx"])
    else:
        scale = consts.threshold_scale
        t["threshold_input"] = (cuda_ms(lambda: dk.threshold_input(inp["x"], scale)),
                                cuda_ms(lambda: dk.threshold_input_plain(inp["x"], scale)), None)
        band_bins = 0
    t["mf_bank_colreduce"] = (
        cuda_ms(lambda: dk.mf_bank_colreduce(inp["S"], consts.masks_f, inp["shift"], off,
                                             M - off, tw=consts.tw)),
        cuda_ms(lambda: dk.mf_bank_colreduce_plain(inp["S"], consts.masks_f, inp["shift"],
                                                   off, M - off)),
        cuda_ms(lambda: torch.fft.ifft(Y, norm="forward")))
    t["timing_band"] = (
        cuda_ms(lambda: dk.timing_band(inp["colsum"], lo, hi, tw=consts.tw)),
        cuda_ms(lambda: dk.timing_band_plain(inp["colsum"], lo, hi)),
        cuda_ms(lambda: torch.fft.rfft(inp["colsum"])))
    t["symbol_detect"] = (
        cuda_ms(lambda: dk.symbol_detect(*args4, hits=hits, **kw)),
        cuda_ms(lambda: dk.symbol_detect_plain(*args4, clip_mask=k4_plain_clip(spec, inp), **kw)),
        None)
    graph = build_process_batch(spec, device="cuda", packed=True)
    plain = build_process_batch(spec, device="cuda", packed=True, plain=True)
    whole = (cuda_ms(lambda: graph(inp["x"]), iters=10),
             cuda_ms(lambda: plain(inp["x"]), iters=5, reps=5))
    return t, whole, band_bins


def viterbi_bound(lengths, decode):
    """(ms, by) of K7's least time: the symbols read (8 B a step) and the
    bits and metrics written, against the f32 operations of the sweep (per
    step: 4 branch metrics of 3 ops, 128 candidate adds, 64 compares, 63
    for the minimum, 64 subtractions, 1 add to the total)."""
    steps, S = sum(lengths), len(lengths)
    nbytes = 8 * steps + 4 * S + 8 * S + (steps if decode else 0)
    flops = steps * (4 * 3 + 128 + 64 + 63 + 64 + 1)
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def time_viterbi():
    """K7 at the ccsds path's shapes (soft ±1/0 symbols, streaming):
    S -> (ms, plain_ms, (bound ms, by), lengths)."""
    out = {}
    for lengths, decode in ((VIT_DECODE, True), (VIT_SYNC, False), (VIT_BATCH, True)):
        x = viterbi_inputs("soft_pm1", lengths)
        kw = dict(soft=True, terminated=False, decode=decode)
        out[len(lengths)] = (cuda_ms(lambda: vit.viterbi_sweep(x, lengths, **kw)),
                             cuda_ms(lambda: vit.viterbi_sweep_plain(x, lengths, **kw),
                                     iters=1, reps=3),
                             viterbi_bound(lengths, decode), lengths)
    return out


def time_feed(blocks=12, plain_blocks=3):
    """Host ms per ``ViterbiStream.feed`` of one flagship block (4032 soft
    symbols), through K7 and through its plain version on the card."""
    x = viterbi_inputs("soft_pm1", [4032 // 2] * blocks).reshape(blocks, -1).cpu().numpy()
    out = []
    for plain, n in ((False, blocks), (True, plain_blocks)):
        vs = vit.ViterbiStream(soft=True, device="cuda", plain=plain)
        vs.feed(x[0])
        t0 = time.perf_counter()
        for i in range(1, n):
            vs.feed(x[i])
        out.append(1e3 * (time.perf_counter() - t0) / (n - 1))
    return out


def profile_graph(spec, B, calls=10, top=8):
    """Device busy time by kernel name and the device's idle share over
    ``calls`` back-to-back calls of the packed block graph (torch.profiler)."""
    graph = build_process_batch(spec, device="cuda", packed=True)
    x = signal_blocks(spec, B)
    graph(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            graph(x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / calls
    dev.sort(key=lambda e: -e.self_device_time_total)
    tops = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / calls:.4f}"
                     for e in dev[:top])
    return wall_ms, busy_ms, len(dev), tops


def kernel_entry(name, t, bnd):
    ms, pms, lms = t[name]
    return {"ms": ms, "plain_ms": pms, "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
            "library_ms": lms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say("device", card)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
                  f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _lib.lib()
    info = _lib.build_info
    say("build", f"kernels built in {time.perf_counter() - t0:.2f} s "
                 f"(nvcc {info.get('seconds', 0.0):.2f} s, cached={info.get('cached')})")
    if info.get("log"):
        with open(info["log"]) as f:
            for line in f:
                spills = "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
                if line.startswith("==") or "registers" in line or spills:
                    say("build", line.strip())

    cfg = {p: configuration(p) for p in ("flagship", "stx")}
    consts = {p: DeviceConsts.from_spec(cfg[p][2], torch.device("cuda")) for p in cfg}
    errs = {k: 0.0 for k in KERNELS}
    for p in cfg:
        for B in (1, 16):
            e = check_kernels(cfg[p][2], consts[p], B)
            errs.update({k: max(errs[k], v) for k, v in e.items()})
            say("kernels", f"{p} B={B} vs plain OK, max abs err " + json.dumps(e))
    errs["viterbi"], n_cases = check_viterbi()
    say("kernels", f"K7 viterbi vs plain OK on {n_cases} cases (bits equal), max abs metric "
                   f"err {errs['viterbi']}")

    res = {"flagship": main_path_flagship(*cfg["flagship"]),
           "stx": main_path_stx(*cfg["stx"])}
    for p in res:
        say("main", f"{p} process x16 == processMany(16) == processCapture == plain path; "
                    + json.dumps(res[p]))
    res["ccsds"] = main_path_ccsds()
    say("main", f"ccsds {CCSDS_FRAMES} frames bit-exact at {list(SNRS_DB)} dB via process and "
                f"processMany(16); plain path's packets equal at {SNRS_DB[-1]} dB; "
                + json.dumps(res["ccsds"]))

    times = {}
    for p in cfg:
        spec = cfg[p][2]
        hop = spec.Nfft - spec.sigOverlap
        for B in BATCHES:
            t, whole, band_bins = time_kernels(spec, consts[p], B)
            bnd = bounds(spec, B, band_bins)
            check_bounds(t, bnd, B, p)
            times[p, B] = (t, bnd)
            for k, (ms, pms, lms) in t.items():
                say("times", f"{card} | {p} B={B} {k}: ms={ms:.5f} plain_ms={pms:.5f} "
                             f"library_ms={'null' if lms is None else f'{lms:.5f}'} "
                             f"bound_ms={bnd[k][0]:.4g} ({bnd[k][1]}) "
                             f"launches_per_block={1 / B:.4f}")
            say("times", f"{card} | {p} B={B} whole block graph: {whole[0]:.4f} ms/call "
                         f"({1e3 * whole[0] / B:.2f} us/block, "
                         f"{B * hop / whole[0] / 1e3:.1f} Msamples/s of new samples); "
                         f"plain path {whole[1]:.4f} ms/call")

    vt = time_viterbi()
    for S, (ms, pms, (bms, by), lengths) in vt.items():
        assert ms >= bms and pms >= bms, f"K7 S={S}: a time is below bound_ms {bms}"
        say("times", f"{card} | viterbi S={S} T={max(lengths)}: ms={ms:.5f} plain_ms={pms:.5f} "
                     f"library_ms=null bound_ms={bms:.4g} ({by}) "
                     f"ns_per_step={1e6 * ms / max(lengths):.1f}")
    feed_ms, feed_plain_ms = time_feed()
    cspec = ccsds_spec()
    graph1 = build_process_batch(cspec, device="cuda", packed=True)
    x1 = signal_blocks(cspec, 1)
    graph_ms = cuda_ms(lambda: graph1(x1), iters=10)
    dh = res["ccsds"]["decoder_host_ms"]
    block_s = (cspec.Nfft - cspec.sigOverlap) / cspec.sampleRate
    dec_ms = dh["find_frames"] + dh["rs"]
    say("times", f"{card} | ccsds decoder host ms/block {dec_ms:.3f} (findFrames "
                 f"{dh['find_frames']:.3f}, RS {dh['rs']:.3f}, max {dh['total_max']:.3f}; "
                 f"ViterbiStream.feed {feed_ms:.3f}, plain {feed_plain_ms:.1f}) beside the block "
                 f"graph {graph_ms:.4f} ms/block at B=1; a block is {1e3 * block_s:.1f} ms of "
                 f"signal at {cspec.sampleRate / 1e3:.1f} ksps, so the decoder takes "
                 f"{100 * dec_ms / (1e3 * block_s):.2f}% of real time")

    for p, B in (("flagship", 1), ("flagship", LINE_BATCH), ("stx", 1)):
        wall, busy, n, tops = profile_graph(cfg[p][2], B)
        idle = "not measured" if n == 0 else f"{100 * (1 - busy / wall):.1f}%"
        say("profile", f"{card} | {p} B={B} graph: wall {wall:.4f} ms/call, device busy "
                       f"{busy:.4f} ms/call, idle {idle}; {n} kernel names, top (ms/call): "
                       f"{tops}")

    kernels = []
    for k, (src, replaces) in KERNELS.items():
        by_path = {p: res[p]["launches"][k] for p in res}
        if k == "viterbi":
            ms, pms, (bms, by), lengths = vt[1]
            kernels.append({
                "name": k, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": errs[k], "ms": ms, "plain_ms": pms, "bound_ms": bms,
                "bound_by": by, "library_ms": None, "batch": 1, "shape": "ccsds decode T=2144",
                "by_S": {S: {"T": max(v[3]), "ms": v[0], "plain_ms": v[1], "bound_ms": v[2][0],
                             "bound_by": v[2][1], "ns_per_step": 1e6 * v[0] / max(v[3])}
                         for S, v in vt.items()}})
            continue
        home = "flagship" if k in PATH_KERNELS["flagship"] else "stx"
        t, bnd = times[home, LINE_BATCH]
        entry = {"name": k, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "max_abs_err": errs[k], **kernel_entry(k, t, bnd), "batch": LINE_BATCH,
                 "shape": home}
        if home == "flagship" and k in PATH_KERNELS["stx"]:
            entry["stx"] = kernel_entry(k, *times["stx", LINE_BATCH])
        kernels.append(entry)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
