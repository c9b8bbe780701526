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
   d. bpsk: ``bench_BPSK.json`` at blockSize 16 (16 masks, the (8, 2, 2)
      NRZ-S LUT) through ``models.uhf.Demodulator``, the same four ways,
      on seeded 10000-bit packets back to back at +3000 Hz; BER < 1e-3,
      every whole packet the port's ``Decoder`` finds equal to the
      payload; K1-K5 and K4n must launch;
   e. group: ``build_group_graph`` at the flagship spec on three antennas
      with independent AWGN: K8 launched once, every channel's decisions
      and the voted pair equal to the plain path's, the voted BER no worse
      than the best channel's;
   f. runtime: ``PyCuSDR`` from ``bench_3_chan_rx.json`` (channel group,
      softCombiner off) and from ``bench_FSK.json`` (one
      ``Demodulator_process``) at blockSize 16, fed over ZMQ PUB in hops:
      the decoded bytes equal the payload, the Rx children run on the card;
   g. wideband: one hop of 64 x 2^16 samples (unit AWGN, seeded GFSK
      packets in channels 0, 5, 31 and 47 at their own Doppler and SNR)
      through ``parallel.Channelizer`` (K9), then
      ``build_sharded_demod_step`` at C=64 on the one-card mesh: BER < 1e-3
      in every planted channel (a +-2-bit slip allowed), its decisions
      equal to the plain step's, a tone at channel 5's centre kept to
      channel 5; then one packet in all channels of an M=4 channelizer into
      the step with the vote (K8): voted BER <= the best channel's;
   h. tracking: ``models.DopplerTracker`` with ``configs.tracking_conf()`` at
      the flagship spec over a 48-block S-curve pass at 10 dB: the kernel
      and plain trackers equal in modes and bits on every block; the first
      lock, the lock fraction after it and the median error in bins;
   i. generic: ``build_sharded_demod_step(force_generic=True)`` on the
      one-card mesh at C=16 flagship channels of seeded GFSK (the vote on):
      K1, K2, K3, K4l, K4s, K5 and K8 launch, K4 does not; bits, symbols
      and centres equal the channel-parallel step's per channel; decisions
      and the voted pair equal the plain generic step's; BER < 1e-3 per
      channel;
   j. ranks: the generic step on {"channel": 2, "dopp": 2} in four
      processes of one gloo world, all on cuda:0 (NCCL refuses two ranks on
      one card), C=4 with the vote: each rank within the golden table of
      the one-process step, the voted pair equal on every rank;
   (phase 3 also holds K4n at the bench_BPSK shape at B=1/16/64, K8 at
   C=3/16/64, S=4608, with pinned ties and master_idx 0, 1 and C-1, with
   and without its pad mask, K9 at M=64, K=8, T=2^16 with a random carry
   (1e-5 of max|y|; two half hops equal one hop), K1 and K5 with
   centre_shift at B=1/16 against their plain versions, and K4l and K4s
   at B=1/16 at the flagship, STX (clip window) and bench_BPSK (K4n after
   K4s) shapes, on one shard and on the two halves of the mask bank;)
5. times: CUDA-event medians per kernel, its plain version and a
   PyTorch library yardstick (where one call computes the same
   function) at B=1/16/64, and the whole block graph against the plain
   path, for both configurations; K7 at S=1/2/64 with ns per trellis
   step; K4n at B=1/16/64 and K8 at C=3/16/64; the group graph at C=3
   against the block graph at B=3; the decoder's host ms per block
   beside the graph's and the runtime's demod child host ms per block;
   K9 with its two-call yardstick (grouped conv1d + torch.fft.fft); the
   wideband chain per hop against the signal a hop holds; the tracker's
   acquire and track graphs per block at B=1; K4l and K4s at B=1/16/64
   and the generic step at C=16 against the channel-parallel step on the
   same blocks; every time must clear its bound;
6. profile: device busy time by kernel and the device's idle share over
   calls of the block graph (torch.profiler): flagship at B=1 and 16,
   STX at B=1; of the wideband chain (K9 + the step at C=64); and of the
   generic step at C=16.

It then prints the card line, one JSON line with every kernel's numbers,
and as its last line ``{"ok": true, "device": {...}}``. It imports
nothing of JAX.
"""

import json
import math
import multiprocessing
import queue
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pycusdr_tpu_torch import ops
from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.configs import (
    RADIO,
    ccsds_conf,
    ccsds_spec,
    flagship_conf,
    stx_conf,
    tracking_conf,
    wideband_conf,
)
from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.decode import Decoder
from pycusdr_tpu_torch.dsp.block import build_process_batch, packed_len
from pycusdr_tpu_torch.dsp.signal_gen import (
    awgn,
    get_padded_packet,
    modulate_bpsk,
    modulate_fsk,
    modulate_gfsk2,
    packet_data,
)
from pycusdr_tpu_torch.dsp.spec import build_spec
from pycusdr_tpu_torch.models import STX, TRACKING, UHF, DopplerTracker
from pycusdr_tpu_torch.ops import _lib
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops import doppler_search as ds
from pycusdr_tpu_torch.ops import viterbi as vit
from pycusdr_tpu_torch.ops.layout import PACK_ARRAYS, SCALAR
from pycusdr_tpu_torch.parallel import (
    build_sharded_demod_step,
    init_distributed,
    local_channel_slice,
    make_mesh,
)
from pycusdr_tpu_torch.parallel import channelizer as pch
from pycusdr_tpu_torch.parallel import vote as pv
from pycusdr_tpu_torch.protocol import loadProtocol
from pycusdr_tpu_torch.protocol.ccsds import RS_K
from pycusdr_tpu_torch.runtime.channel_group_process import build_group_graph
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
CONFIGS = "pycusdr_tpu_torch/config/configs"
#: K8's channel counts: the three-antenna station (bench_3_chan_rx), and wider groups
VOTE_CS = (3, 16, 64)
GROUP_C = 3
#: the runtime phase's ports (all above 38000) and its bound on every wait, s
RUNTIME_PORT = 38400
RUNTIME_WAIT_S = 90.0
#: per-antenna noise std of the group phase (unit-power GFSK): a raw BER
#: of 1-2.3e-2 per channel at the flagship spec, so the vote has errors to correct
GROUP_NOISE = (1.6, 1.7, 1.8)
#: the wideband path: GFSK packets planted in these channels of the M=64
#: channelizer, each at its own Doppler offset and SNR (dB at the 153.6 kHz
#: channel rate), under unit-power wideband AWGN everywhere. At least 5
#: channels apart: the reference channelizer images an off-centre signal
#: into its neighbours (-5.8 dB in the next channel at 0.17 of a channel
#: off centre; ROADMAP Queue 3), and the port keeps its semantics
WB_CHANNELS = (0, 5, 31, 47)
WB_DOPPLER_HZ = (-6000.0, 2500.0, -1500.0, 7000.0)
WB_SNR_DB = (12.0, 14.0, 16.0, 20.0)
WB_TONE = 5  # the channel whose centre carries the purity check's tone
#: the vote run behind an M=4 channelizer: one packet in every channel, at an
#: SNR that leaves each channel a raw BER of 5-9e-3 for the vote to correct;
#: its packet starts half a symbol in (timing mid-symbol, see group_blocks),
#: which moves the slip to +2, so the run allows +-3
WB_VOTE_C, WB_VOTE_SNR_DB, WB_VOTE_DOPPLER_HZ, WB_VOTE_SLIP = 4, -3.0, 1200.0, 3
#: K9's bar against its plain version (tests/test_channelizer.py:19), relative to max|y|
K9_REL = 1e-5
#: the tracking path: the bench/subsystems.py LEO pass at the flagship spec
TRACK_BLOCKS, TRACK_SNR_DB = 48, 10.0
#: K8's master channels in the phase-3 check (the last one is C - 1)
VOTE_MASTERS = (0, 1, -1)
#: the generic channel x dopp step: C channels in one process (phase 4i), and
#: the four ranks of {"channel": 2, "dopp": 2} on the one card over gloo with
#: C channels in all (phase 4j), each rank given this long to report
GENERIC_C, RANKS_C, RANKS, RANKS_WAIT_S = 16, 4, 4, 300.0

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
    "nrzs_bits": ("pycusdr_tpu_torch/csrc/symbol_detect.cu",
                  "pycusdr_tpu/ops/demod_kernels.py:597"),
    "vote": ("pycusdr_tpu_torch/csrc/vote.cu", "pycusdr_tpu/parallel/vote.py:18"),
    "channelize": ("pycusdr_tpu_torch/csrc/channelizer.cu",
                   "pycusdr_tpu/parallel/channelizer.py:43"),
    "symbol_detect_local": ("pycusdr_tpu_torch/csrc/shard_select.cu",
                            "pycusdr_tpu/parallel/sharded_demod.py:46"),
    "shard_select": ("pycusdr_tpu_torch/csrc/shard_select.cu",
                     "pycusdr_tpu/parallel/sharded_demod.py:361"),
}
#: the kernels each configuration's path runs
PATH_KERNELS = {
    "flagship": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
                 "symbol_detect"),
    "stx": ("threshold_input", "mf_bank_colreduce", "timing_band", "symbol_detect"),
    "ccsds": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
              "symbol_detect", "viterbi"),
    "bpsk": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
             "symbol_detect", "nrzs_bits"),
    "group": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
              "symbol_detect", "vote"),
    "wideband": ("channelize", "doppler_energy", "doppler_estimate", "mf_bank_colreduce",
                 "timing_band", "symbol_detect", "vote"),
    "tracking": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
                 "symbol_detect"),
    "generic": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
                "symbol_detect_local", "shard_select", "vote"),
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


def check_doppler_estimate(spec, consts, inp, centre=None):
    """K5 against its plain version, with an all-zero block appended:
    shift exact, dopp_idx within 1e-5 relative, Hz within 1e-2, quality
    and SNR within 1e-3 dB (equal where not finite). ``centre``: the (B,)
    int32 runtime recentre (the appended block gets 0). Returns the max
    abs error over dopp_idx, quality_db and snr_db."""
    E = torch.cat([inp["E"], torch.zeros_like(inp["E"][:1])])
    P = torch.cat([inp["P"], torch.zeros_like(inp["P"][:1])])
    args, kw = k5_args(spec, consts, E, P)
    if centre is not None:
        kw.update(centre_shift=torch.cat([centre, centre.new_zeros(1)]),
                  bin_hz=spec.sampleRate / spec.Nfft)
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


# ------------------------------------------------- slice 4: NRZ-S, group, runtime


def config_path(*parts) -> str:
    return str(Path(__file__).resolve().parent.joinpath(CONFIGS, *parts))


def bpsk_configuration():
    """bench_BPSK.json at the flagship width (blockSize 16, overlap 2^10,
    D=64; 16 masks of 4 bits and the (8, 2, 2) NRZ-S LUT): (conf,
    protocol, spec, Demodulator class)."""
    conf = load_modular_json(config_path("benchmark", "bench_BPSK.json"))
    conf["GPU"]["UHF"]["blockSize"] = 16
    protocol = loadProtocol("bench_BPSK")(conf=conf)
    return conf, protocol, build_spec(conf, protocol, RADIO), UHF.Demodulator


def bpsk_stream(spec, bits, n_samples, seed=SEED, doppler_hz=DOPPLER_HZ):
    """BPSK (NRZ-S, RRC) of ``bits`` at the IF offset plus ``doppler_hz``,
    ``n_samples`` long, with AWGN of NOISE_STD over all of it."""
    rng = np.random.RandomState(seed)
    sig = np.zeros(n_samples, np.complex128)
    m = modulate_bpsk(bits, int(spec.spsym))[:n_samples]
    sig[:len(m)] = m
    n = np.arange(n_samples)
    sig *= np.exp(2j * np.pi * (spec.centreFreqOffset + doppler_hz) / spec.sampleRate * n)
    sig += NOISE_STD / np.sqrt(2) * (rng.randn(n_samples) + 1j * rng.randn(n_samples))
    return sig.astype(np.complex64)


def nrzs_rows(spec, consts, B):
    """K4n's input: the block graph's rows of B BPSK blocks with bits,
    trust and nBits overwritten (bits 7, trust normal and -2 on every 7th
    slot, whose mark must stay, nBits -5) and, at B > 1, the last block's
    symbols random in [-1, 16] (every transition error and symbols outside
    the LUT's 8 rows)."""
    rng = np.random.RandomState(SEED + B)
    S, sps = spec.numSymMax, int(spec.spsym)
    x = np.stack([bpsk_stream(spec, rng.randint(0, 2, spec.Nfft // sps + 8), spec.Nfft,
                              seed=SEED + b) for b in range(B)])
    rows = build_process_batch(spec, device="cuda", packed=True)(x)
    if B > 1:
        rows[-1, 2 * S:3 * S] = torch.from_numpy(rng.randint(-1, 17, S).astype(np.float32))
    rows[:, :S] = 7.0
    rows[:, S:2 * S] = float(consts.trust_normal)
    rows[:, S:2 * S:7] = -2.0
    rows[:, len(PACK_ARRAYS) * S + SCALAR["nBits"]] = -5.0
    return rows


def check_nrzs(spec, consts, B):
    """K4n against its plain version on ``nrzs_rows``: the rows must be
    equal. Returns the number of slots that took trust -1."""
    rows = nrzs_rows(spec, consts, B)
    S = spec.numSymMax
    got = dk.nrzs_bits(rows.clone(), consts.symbolLUT, S)
    want = dk.nrzs_rows_plain(rows.clone(), consts.symbolLUT, S)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"K4n B={B}: rows differ from the plain version's"
    assert bool((got[:, S:2 * S:7] == -2).all()), "K4n overwrote a trust of -2"
    errs = int((got[:, S:2 * S] == -1).sum())
    assert B == 1 or errs > 0, "K4n check: no transition error"
    return errs


def vote_input(C, S, L):
    """(C, L) packed rows for K8: random bits, trust in {-2, -1, 0, 1, 2,
    3, 5, 127} and nBits in [S - 300, S] (the last channel S/2); at slots
    s % 10 == 0 a pinned tie (master bit 1 at trust 5, weight 5 * 1.2f =
    6.0, against trust 2 + 2 + 2 at bit 0, or one trust 6 at C = 3; the
    rest trust -1); at s % 10 == 5 every voter disqualified (trust -1)."""
    rng = np.random.RandomState(SEED + C)
    bits = rng.randint(0, 2, (C, S))
    trust = rng.choice([-2, -1, 0, 1, 2, 3, 5, 127], (C, S))
    tie, gone = slice(0, S, 10), slice(5, S, 10)
    bits[0, tie], trust[0, tie] = 1, 5
    k = 4 if C >= 4 else 2
    bits[1:k, tie], trust[1:k, tie] = 0, (2 if C >= 4 else 6)
    trust[k:, tie] = -1
    trust[:, gone] = -1
    nbits = rng.randint(S - 300, S + 1, C)
    nbits[-1] = S // 2
    rows = np.zeros((C, L), np.float32)
    rows[:, :S], rows[:, S:2 * S] = bits, trust
    tail = len(PACK_ARRAYS) * S
    rows[:, tail + SCALAR["nSym"]] = rows[:, tail + SCALAR["nBits"]] = nbits
    return torch.from_numpy(rows).cuda(), int(nbits[:k].min())


def check_vote(C, S, L, master=0):
    """K8 against the plain vote (``vote_rows_plain``, i.e. the pad mask
    then ``vote_n_device_plain``) on ``vote_input`` with channel ``master``
    the master (its row and row 0 swapped, so the pinned ties stay ties):
    the masked rows and the voted pair equal; the pinned ties vote 0, the
    disqualified slots get trust -1."""
    rows, n_tie = vote_input(C, S, L)
    m = master % C
    rows[[0, m]] = rows[[m, 0]]
    rk, rp = rows.clone(), rows.clone()
    ok = pv.vote_rows(rk, S, 1.2, master_idx=master)
    op = pv.vote_rows_plain(rp, S, 1.2, torch.empty((2, S), device="cuda"), master)
    torch.cuda.synchronize()
    assert torch.equal(rk, rp), f"K8 C={C}: masked rows differ"
    assert torch.equal(ok, op), f"K8 C={C}: voted pair differs from the plain vote"
    assert not bool(ok[0, 0:n_tie:10].any()), f"K8 C={C}: a pinned tie voted 1"
    assert bool((ok[1, 5:S:10] == -1).all()), f"K8 C={C}: a disqualified slot has trust"
    # the generic step's vote: the trust as the rows hold it, no pad mask
    rk, rp = rows.clone(), rows.clone()
    ok = pv.vote_rows(rk, S, 1.2, master_idx=master, mask_pad=False)
    op = pv.vote_rows_plain(rp, S, 1.2, torch.empty((2, S), device="cuda"), master, False)
    torch.cuda.synchronize()
    assert torch.equal(rk, rows) and torch.equal(rp, rows), f"K8 C={C}: pad mask off wrote rows"
    assert torch.equal(ok, op), f"K8 C={C}: voted pair without the pad mask differs"
    return 0.0


def main_path_bpsk(conf, protocol, spec, make):
    """bench_BPSK through ``models.uhf.Demodulator`` (``drive``): 256
    random bits (the overlap-save history holds the first 64), then seeded
    10000-bit packets back to back, at +DOPPLER_HZ; BER < 1e-3 against the
    sent bits, and every whole packet the port's ``Decoder`` finds equal
    to the payload; K1-K5 and K4n must launch."""
    N, ov = spec.Nfft, spec.sigOverlap
    n = ov + N_HOPS * (N - ov)
    payload = packet_data(protocol.packetLen, protocol.randSeed)
    lead = np.random.RandomState(SEED).randint(0, 2, 256)
    reps = (n // int(spec.spsym) - len(lead)) // len(payload) + 1
    tx = np.r_[lead, np.tile(payload, reps)]
    stream = bpsk_stream(spec, tx, n)
    seqA, launches = drive(make, conf, protocol, stream, ov)
    check_launches("bpsk", launches)
    rx = np.concatenate([a["bits"] for a in seqA]).astype(np.int64)
    ber, lag = best_aligned_ber(rx, tx)
    assert ber < 1e-3, f"bpsk BER {ber} at lag {lag}"
    dec = Decoder(conf, protocol)
    pkts = [p for a in seqA for p in dec.findFrames(a["bits"], 0)[0]]
    whole = [p for p in pkts if len(p.bits) >= protocol.packetLen]
    bad = [p.checkPacketData() for p in whole if p.checkPacketData() != 0]
    assert len(whole) >= reps - 2 and not bad, \
        f"bpsk: {len(whole)} whole packets of {reps}, bit errors {bad}"
    assert all(np.array_equal(p.getBinaryData()[0][:len(payload)], payload) for p in whole)
    return dict(ber=ber, lag=lag, bits=len(rx), packets=len(whole), launches=launches,
                trust_minus1=int(sum(np.sum(a["trust"] == -1) for a in seqA)))


def group_blocks(spec, C, noise=GROUP_NOISE, seed=SEED):
    """One GFSK block at the IF offset plus DOPPLER_HZ received on C
    antennas, each with its own AWGN (std ``noise[c]``); returns (blocks
    (C, Nfft) complex64, sent bits). The block starts half a symbol into
    the signal, so every channel's timing estimate lies mid-symbol: the
    lockstep vote pairs slot s of every channel, and near the wrap of the
    timing phase noise can move one channel's slots by a symbol (in the
    JAX package's graph alike)."""
    rng = np.random.RandomState(seed)
    N, sps = spec.Nfft, int(spec.spsym)
    bits = rng.randint(0, 2, N // sps + 8)
    f = (spec.centreFreqOffset + DOPPLER_HZ) / spec.sampleRate
    base = (modulate_gfsk2(bits, sps)[sps // 2:sps // 2 + N]
            * np.exp(2j * np.pi * f * np.arange(N)))
    blocks = [base + noise[c] / np.sqrt(2) * (rng.randn(N) + 1j * rng.randn(N))
              for c in range(C)]
    return np.stack(blocks).astype(np.complex64), bits


def main_path_group(spec, C=GROUP_C):
    """``build_group_graph`` at ``spec`` on C antennas with independent
    AWGN: K1-K5 and K8 (once) launch; each channel's bits, trust, symbols,
    centres and nBits equal the plain path's, and the voted pair the plain
    vote's; the voted bits' BER is no worse than the best channel's."""
    blocks, tx = group_blocks(spec, C)
    L, S = packed_len(spec), spec.numSymMax
    graph = build_group_graph(spec, C, 1.2, device="cuda")
    ops.reset_launches()
    vec = graph(blocks)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    ref = build_group_graph(spec, C, 1.2, device="cuda", plain=True)(blocks)
    torch.cuda.synchronize()
    check_launches("group", launches)
    assert launches["vote"] == 1, f"K8 launched {launches['vote']} times in one call"
    rows, rrows = vec[:C * L].view(C, L), ref[:C * L].view(C, L)
    tail = len(PACK_ARRAYS) * S
    for i, k in enumerate(PACK_ARRAYS[:4]):
        assert torch.equal(rows[:, i * S:(i + 1) * S], rrows[:, i * S:(i + 1) * S]), \
            f"group: {k} differ from the plain path's"
    assert torch.equal(rows[:, tail + SCALAR["nBits"]], rrows[:, tail + SCALAR["nBits"]])
    assert torch.equal(vec[C * L:], ref[C * L:]), "group: voted pair differs from the plain vote"
    v = vec.cpu().numpy()
    bers = []
    for c in range(C):
        nb = int(v[c * L + tail + SCALAR["nBits"]])
        bers.append(best_aligned_ber(v[c * L:c * L + nb].astype(np.int64), tx)[0])
    nb0 = int(v[tail + SCALAR["nBits"]])
    voted_ber = best_aligned_ber(v[C * L:C * L + nb0].astype(np.int64), tx)[0]
    assert voted_ber <= min(bers), f"group: voted BER {voted_ber} above the best channel's {bers}"
    return dict(C=C, channel_ber=bers, voted_ber=voted_ber, launches=launches)


def runtime_conf(name, port0, group):
    """A shipped config with blockSize 16, no softCombiner, its Rx radios
    on ports port0.. and the internal and external sockets above them."""
    conf = load_modular_json(config_path("benchmark", name))
    conf["Main"].update(workerId="smoke", softCombiner_enabled=False,
                        channelGroup_enabled=group, statsFolder="build/runtime_stats")
    conf["GPU"]["UHF"]["blockSize"] = 16
    for i, r in enumerate(conf["Radios"]["Rx"].values()):
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


def run_runtime(name, port0, group):
    """``PyCuSDR`` from a shipped config: waits (bounded) for every Rx
    child to be warm, then PUBlishes one seeded bench_FSK packet with AWGN
    at 14 dB, independent per antenna, in hops, until the decoded bytes
    arrive on the external PULL socket. Returns (payload == expected, the
    Rx children's devices, their host ms per block where they keep it,
    seconds to the first packet)."""
    import zmq

    from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

    conf = runtime_conf(name, port0, group)
    n_rx = len(conf["Radios"]["Rx"])
    bits = packet_data(conf["Main"]["PacketLen"], conf["Main"]["RandSeed"])
    sig, _ = get_padded_packet("FSK", 16, 9600 * 16, offset_freq=38400, raw_bits=bits, pad=6000)
    hop = 2 ** 16 - 2 ** 10
    stream = np.r_[sig, np.zeros(4 * hop, np.complex64)]
    ctx = zmq.Context()
    pubs = []
    for i in range(n_rx):
        sock = ctx.socket(zmq.PUB)
        sock.setsockopt(zmq.LINGER, 0)
        sock.bind(f"tcp://127.0.0.1:{port0 + i}")
        pubs.append(sock)
    sink = ctx.socket(zmq.PULL)
    sink.setsockopt(zmq.LINGER, 0)
    sink.setsockopt(zmq.RCVTIMEO, 2000)
    sdr = PyCuSDR(conf, args=None)
    assert len(sdr.demodulators) == (1 if group else n_rx)
    sdr.start()
    try:
        deadline = time.time() + RUNTIME_WAIT_S
        flags = [d.warmedFlag for d in sdr.demodulators] + [sdr.dec.boundFlag]
        while time.time() < deadline and not all(f.is_set() for f in flags):
            assert all(t.is_alive() for t in sdr.tasks), "a runtime child died while warming"
            time.sleep(0.2)
        assert all(f.is_set() for f in flags), "runtime children not warm"
        # connect once the decoder listens: a connect retried against a
        # port in the ephemeral range can connect the socket to itself
        sink.connect(f"tcp://localhost:{port0 + 12}")
        time.sleep(1.0)  # let the SUB sockets connect
        t0 = time.time()
        rng = np.random.RandomState(SEED)
        payload = None
        while payload is None and time.time() < deadline:
            chans = [awgn(stream, 14.0, rng=rng).astype(np.complex64) for _ in pubs]
            for pos in range(0, len(stream) - hop + 1, hop):
                for sock, c in zip(pubs, chans):
                    sock.send(c[pos:pos + hop].tobytes())
                time.sleep(0.05)
            try:
                payload = sink.recv()
            except zmq.error.Again:
                continue
        assert payload is not None, f"{name}: no packet decoded within {RUNTIME_WAIT_S} s"
        expected = bytes(bytearray(sdr.protocols["UHF"].Packet(bits).getBinaryData()[0]))
        return (payload == expected, [d.device for d in sdr.demodulators],
                [1e3 * d.timeMA for d in sdr.demodulators if hasattr(d, "timeMA")],
                time.time() - t0)
    finally:
        sdr.terminate()
        for sock in pubs + [sink]:
            sock.close()
        ctx.term()


def main_path_runtime():
    """The process pipeline from the shipped configs: bench_3_chan_rx.json
    as one lockstep channel group (three antennas, K8 in the child), then
    bench_FSK.json through one ``Demodulator_process``; both must decode
    the payload, with their Rx children on the card."""
    out = {}
    for key, name, port0, group in (("group", "bench_3_chan_rx.json", RUNTIME_PORT, True),
                                    ("single", "bench_FSK.json", RUNTIME_PORT + 20, False)):
        t0 = time.time()
        equal, devices, host_ms, first_s = run_runtime(name, port0, group)
        assert equal, f"runtime {key}: decoded bytes differ from the payload"
        assert devices and all(d == "cuda" for d in devices), f"runtime {key}: devices {devices}"
        out[key] = dict(config=name, devices=devices, host_ms_per_block=host_ms,
                        first_packet_s=first_s, seconds=time.time() - t0)
    return out


# ------------------------------------------- slice 5: wideband front end, tracking

def recentres(N, B):
    """B runtime recentres (bins): 0, positive, negative and values that
    wrap past N either way; at B=1 one wrapping value."""
    vals = [0, 3, -5, 37, -100, N - 2, -(N + 7), 2 * N + 1, 12, -12, 500, -500, N // 2,
            -(N // 2), 1, -1]
    return torch.tensor((vals * B)[:B] if B > 1 else [N - 2], dtype=torch.int32, device="cuda")


def check_recentre(spec, consts, B):
    """K1 and K5 with a runtime ``centre_shift`` against their plain
    versions on the flagship blocks (K1 within 1e-4 of max E; K5 as in
    ``check_doppler_estimate``). Returns (K1 err, K5 err)."""
    inp = kernel_inputs(spec, consts, B)
    centre = recentres(spec.Nfft, B)
    Ek = ds.doppler_energy(inp["P"], consts.Q, consts.shifts, centre)
    Ep = ds.doppler_energy_plain(inp["P"], consts.Q, consts.shifts, centre)
    torch.cuda.synchronize()
    e1 = float((Ek - Ep).abs().max())
    assert e1 <= 1e-4 * float(Ep.abs().max()), f"K1 B={B} recentred err {e1}"
    return e1, check_doppler_estimate(spec, consts, dict(inp, E=Ep), centre=centre)


def k9_inputs(wb, T, seed=SEED + 9):
    """Seeded wideband samples (T M,) and a random carry (K-1, M), complex64."""
    M, K = wb["M"], wb["taps_per_branch"]
    rng = np.random.RandomState(seed)
    x = ((rng.randn(T * M) + 1j * rng.randn(T * M)) / np.sqrt(2)).astype(np.complex64)
    st = ((rng.randn(K - 1, M) + 1j * rng.randn(K - 1, M)) / np.sqrt(2)).astype(np.complex64)
    return torch.from_numpy(x).cuda(), torch.from_numpy(st).cuda()


def check_channelize(wb, T):
    """K9 against its plain version at M x T with a random carry: y within
    K9_REL of max|y|, the new carry equal; then two half hops through the
    Channelizer with the carry against one whole hop (rtol 1e-4, atol
    1e-5, JAX's bar). Returns (max abs err, relative err, halves equal)."""
    x, st = k9_inputs(wb, T)
    ch = pch.Channelizer(wb["M"], wb["taps_per_branch"], wb["beta"], device="cuda")
    yk, sk = pch.channelize(x, ch.h2, st, tw=ch.tw)
    yp, sp = pch.channelize_plain(x, ch.h2, st)
    torch.cuda.synchronize()
    err, scale = float((yk - yp).abs().max()), float(yp.abs().max())
    assert err <= K9_REL * scale, f"K9 err {err} > {K9_REL} * {scale}"
    assert torch.equal(sk, sp), "K9 carry differs from the plain version's"
    ch.state = st.clone()
    half = x.numel() // 2
    halves = torch.cat([ch.process(x[:half]), ch.process(x[half:])], dim=1)
    torch.cuda.synchronize()
    assert torch.allclose(halves, yk, rtol=1e-4, atol=1e-5), "K9 halves != one hop"
    assert torch.equal(ch.state, sk), "K9 carry after the halves differs"
    return err, err / scale, bool(torch.equal(halves, yk))


def wideband_signal(M, wb, spec, channels, dopplers, snrs, seed, bits=None, skip=0):
    """M Nfft wideband samples at M x the channel rate: unit-power complex
    AWGN, plus in each of ``channels`` a GFSK packet (``bits``, or its own
    seeded bits) at the IF offset plus its Doppler, at its SNR over the
    channel's noise (the wideband noise times sum h^2 of the prototype).
    The GFSK phase, made at the channel rate, is interpolated to the
    wideband rate; the packet starts ``skip`` samples (channel rate) into
    its first symbol. Returns (samples complex64, the bits of each channel)."""
    N, sps = spec.Nfft, int(spec.spsym)
    K, beta = wb["taps_per_branch"], wb["beta"]
    hsq = float(np.sum(pch.design_prototype(M, K, beta) ** 2))
    rng = np.random.RandomState(seed)
    n = np.arange(M * N)
    x = (rng.randn(M * N) + 1j * rng.randn(M * N)) / np.sqrt(2)
    sent = []
    for m, dopp, snr in zip(channels, dopplers, snrs):
        b = rng.randint(0, 2, N // sps + 8) if bits is None else bits
        at = 2 * sps + skip  # the Gaussian filter delays the pulses by 2 symbols
        g = modulate_gfsk2(b, sps)[at:at + N + 1]
        phase = np.interp(n / M, np.arange(N + 1), np.unwrap(np.angle(g)))
        f = m / M + (spec.centreFreqOffset + dopp) / (M * spec.sampleRate)
        x += np.sqrt(10 ** (snr / 10) * hsq) * np.exp(1j * (phase + 2 * np.pi * f * n))
        sent.append(b)
    return x.astype(np.complex64), sent


def slip_ber(rx, tx, trim=4, slip=2):
    """(BER, slip) of rx[trim:-trim] against tx at the best slip in
    [-slip, slip] bits: the prototype filter's delay
    (tests/test_channelizer.py:104-112)."""
    got = rx[trim:len(rx) - trim]
    best = (1.0, 0)
    for d in range(-slip, slip + 1):
        want = tx[max(trim + d, 0):trim + d + len(got)]
        L = min(len(want), len(got))
        best = min(best, (float(np.mean(got[:L] != want[:L])), d))
    return best


def tone_purity(ch, m0, delta=0.0):
    """(share of the output energy in channel m0, channel m0 + 1's energy
    against it in dB) for a carrier ``delta`` channel widths above channel
    m0's centre."""
    M, n = ch.M, torch.arange(ch.M * 2 ** 16, device="cuda")
    ang = (2 * math.pi / M) * (((n * m0) % M).double() + delta * n.double())
    y = ch(torch.polar(torch.ones_like(ang), ang).to(torch.complex64))[0]
    energy = (y.abs() ** 2).sum(dim=1)
    return float(energy[m0] / energy.sum()), 10 * math.log10(float(energy[(m0 + 1) % M]
                                                                   / energy[m0]))


DECISIONS = ("bits", "trust", "symbols", "nSym", "nBits", "shift")


def main_path_wideband(wb, spec):
    """The wideband front end (BASELINE #5) at full width: one hop of 64 x
    2^16 samples with GFSK packets in WB_CHANNELS through the card's
    Channelizer (K9), then ``build_sharded_demod_step(vote=False)`` at C=64
    on the one-card mesh; then a vote run: one packet in all 4 channels of
    an M=4 channelizer into the step with the vote (K8). BER < 1e-3 in each
    planted channel, the kernel step's decisions equal the plain step's
    there, the voted BER no worse than the best channel's; K9 twice, K8
    once, K1-K5 launch."""
    M, N, sps = wb["M"], spec.Nfft, int(spec.spsym)
    K, beta = wb["taps_per_branch"], wb["beta"]
    x, sent = wideband_signal(M, wb, spec, WB_CHANNELS, WB_DOPPLER_HZ, WB_SNR_DB, SEED + 5)
    C = WB_VOTE_C
    common = np.random.RandomState(SEED + 7).randint(0, 2, N // sps + 8)
    xv, _ = wideband_signal(C, wb, spec, range(C), [WB_VOTE_DOPPLER_HZ] * C,
                            [WB_VOTE_SNR_DB] * C, SEED + 6, bits=common, skip=sps // 2)
    xt, xvt = torch.from_numpy(x).cuda(), torch.from_numpy(xv).cuda()
    ch = pch.Channelizer(M, K, beta, device="cuda")
    chv = pch.Channelizer(C, K, beta, device="cuda")
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=["cuda"])
    step = build_sharded_demod_step(spec, mesh, vote=False)
    stepv = build_sharded_demod_step(spec, mesh, vote=True)
    purity, _ = tone_purity(ch, WB_TONE)
    assert purity > 0.99, f"tone at channel {WB_TONE}'s centre: purity {purity}"
    # the image of a carrier at the IF offset + 7 kHz (0.17 of a channel)
    delta = (spec.centreFreqOffset + 7000.0) / spec.sampleRate
    off_purity, image_db = tone_purity(ch, WB_TONE, delta)

    ops.reset_launches()
    y = ch.process(xt)
    res = step(y)
    yv = chv.process(xvt)
    resv = stepv(yv)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("wideband", launches)
    assert launches["channelize"] == 2 and launches["vote"] == 1, launches
    assert y.shape == (M, N) and bool(torch.isfinite(torch.view_as_real(y)).all())

    ref = build_sharded_demod_step(spec, mesh, vote=False, plain=True)(y)
    refv = build_sharded_demod_step(spec, mesh, vote=True, plain=True)(yv)
    torch.cuda.synchronize()
    planted = list(WB_CHANNELS)
    quiet = [m for m in range(M) if m not in planted]
    for k in DECISIONS:
        assert torch.equal(res[k][planted], ref[k][planted]), f"wideband: {k} != plain step's"
    for k in DECISIONS + ("bits_voted", "trust_voted"):
        assert torch.equal(resv[k], refv[k]), f"wideband vote run: {k} != plain step's"
    quiet_equal = float((res["bits"][quiet] == ref["bits"][quiet]).float().mean())
    out = {k: v.cpu().numpy() for k, v in res.items()}
    chans = {}
    for m, tx, dopp in zip(WB_CHANNELS, sent, WB_DOPPLER_HZ):
        ber, slip = slip_ber(out["bits"][m, :out["nBits"][m]].astype(np.int64), tx)
        off = float(out["freq_offset_hz"][m])
        assert ber < 1e-3, f"wideband channel {m}: BER {ber} (slip {slip})"
        assert abs(off - dopp) < spec.baudRate / 2, f"channel {m}: {off} Hz, injected {dopp}"
        chans[m] = dict(ber=ber, slip=slip, bits=int(out["nBits"][m]), offset_hz=round(off, 2),
                        snr_db=round(float(out["snr_db"][m]), 2))
    v = {k: t.cpu().numpy() for k, t in resv.items()}
    vbers = [slip_ber(v["bits"][c, :v["nBits"][c]].astype(np.int64), common,
                      slip=WB_VOTE_SLIP)[0] for c in range(C)]
    voted_ber = slip_ber(v["bits_voted"][:v["nBits"][0]].astype(np.int64), common,
                         slip=WB_VOTE_SLIP)[0]
    assert voted_ber <= min(vbers), f"wideband vote: voted BER {voted_ber} above {vbers}"
    return dict(M=M, hop_samples=M * N, tone_purity=purity,
                off_centre_tone=dict(delta=delta, purity=off_purity, next_channel_db=image_db),
                channels=chans,
                quiet_bits_equal_plain=quiet_equal, vote=dict(C=C, channel_ber=vbers,
                                                            voted_ber=voted_ber),
                launches=launches)


def s_curve_blocks(spec, n_blocks, f_max, t_mid, tau, snr_db, seed=3):
    """FSK blocks under an S-curve Doppler pass with AWGN at ``snr_db``
    (bench/subsystems.py:73-89); returns (blocks complex64, truth Hz)."""
    N, fs, sps = spec.Nfft, spec.sampleRate, int(spec.spsym)
    rng = np.random.RandomState(seed)
    base = modulate_fsk(rng.randint(0, 2, (N * n_blocks) // sps + 8), sps)[:N * n_blocks]
    t_blk = np.arange(N * n_blocks) / N
    f_inst = spec.centreFreqOffset - f_max * np.tanh((t_blk - t_mid) / tau)
    sig = base * np.exp(1j * 2 * np.pi * np.cumsum(f_inst) / fs)
    sig = awgn(sig.astype(np.complex64), snr_db, rng=rng)
    truth = spec.centreFreqOffset - f_max * np.tanh((np.arange(n_blocks) + 0.5 - t_mid) / tau)
    return sig.astype(np.complex64).reshape(n_blocks, N), truth


def main_path_tracking(spec):
    """The LEO search-and-track loop (BASELINE #3) at the flagship spec with
    ``tracking_conf()`` over a TRACK_BLOCKS-block S-curve pass at
    TRACK_SNR_DB, sized as bench/subsystems.py:92-148 sizes it: the kernel
    tracker and the plain tracker give equal modes and equal bits block by
    block; it locks; K1-K5 launch. Returns the first lock block, the lock
    fraction after it, the median error in bins, and the two trackers."""
    tc = tracking_conf()
    bin_hz = spec.sampleRate / spec.Nfft
    grid_span = float(spec.dopp_hz_lut.max() - spec.dopp_hz_lut.min())
    tau = TRACK_BLOCKS / 6
    f_max = min(0.35 * grid_span, 0.4 * (tc["track_span_bins"] / 2) * bin_hz * tau)
    blocks, truth = s_curve_blocks(spec, TRACK_BLOCKS, f_max, TRACK_BLOCKS / 2, tau,
                                   TRACK_SNR_DB)
    xb = torch.from_numpy(blocks).cuda()
    tracker = DopplerTracker(spec=spec, device="cuda", **tc)
    plain = DopplerTracker(spec=spec, device="cuda", plain=True, **tc)
    ops.reset_launches()
    seq = [tracker.process(b) for b in xb]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("tracking", launches)
    pseq = [plain.process(b) for b in xb]
    for i, (a, p) in enumerate(zip(seq, pseq)):
        assert a["mode"] == p["mode"], f"tracking block {i}: mode {a['mode']} != {p['mode']}"
        n = int(a["nBits"])
        assert n == int(p["nBits"]) and np.array_equal(a["bits"][:n], p["bits"][:n]), \
            f"tracking block {i}: bits differ from the plain tracker's"
    modes = [a["mode"] for a in seq]
    locked = [m == TRACKING for m in modes]
    assert any(locked), "tracker never locked during the pass"
    first = locked.index(True)
    est = np.array([float(a["doppler_hz"]) for a in seq])
    err_bins = np.abs(est[first:] - truth[first:]) / bin_hz
    return dict(blocks=TRACK_BLOCKS, snr_db=TRACK_SNR_DB, doppler_swing_hz=2 * f_max,
                first_lock_block=first, lock_fraction_after_first=float(np.mean(locked[first:])),
                median_err_bins=float(np.median(err_bins)),
                acquire_bins=int(spec.num_dopplers),
                track_bins=int(tracker.track_spec.num_dopplers),
                launches=launches), tracker, xb


# ------------------------------------ slice 6: the generic channel x dopp step


def k4l_kwargs(spec):
    return dict(M=spec.num_masks, Nfft=spec.Nfft, windowWidth=spec.windowWidth,
                spsymMin=spec.spsymMin, numSymMax=spec.numSymMax)


def shard_columns(spec, consts, inp, nd):
    """Each of nd shards' (colmax, colargmax) over its Ml = M / nd masks
    (the plain K2 on the card; the whole bank's for nd = 1)."""
    if nd == 1:
        return [(inp["colmax"], inp["colarg"])]
    Ml = spec.num_masks // nd
    cols = [dk.mf_bank_colreduce_plain(inp["S"], consts.masks_f[d * Ml:(d + 1) * Ml],
                                       inp["shift"], 0, Ml) for d in range(nd)]
    return [(c[1], c[2]) for c in cols]


def check_split_detector(spec, consts, B):
    """K4l on one shard and on the two halves of the bank, and K4s on the
    stacked pairs, against their plain versions on the card: the pairs and
    the rows equal (values, keys, symbols, centres, trust with the clip
    window). At nd = 1 the rows' bits, symbols, centres and mags equal
    K4's; without a centre-bit LUT K4n runs after K4s on both rows.
    Returns (nd -> slots set to trust -2, slots the upper half won)."""
    inp = kernel_inputs(spec, consts, B)
    kw = k4l_kwargs(spec)
    kw4 = k4_kwargs(spec, consts)
    S, L = spec.numSymMax, packed_len(spec)
    sp, co, hits = inp["spSym"], inp["codeOffset"], inp.get("hits")
    clipped, split = {}, 0
    for nd in (1, 2):
        cols = shard_columns(spec, consts, inp, nd)
        Ml = spec.num_masks // nd
        pk = [dk.symbol_detect_local(cm, ca, sp, co, m0=d * Ml, **kw)
              for d, (cm, ca) in enumerate(cols)]
        pp = [dk.symbol_detect_local_plain(cm, ca, sp, co, m0=d * Ml, **kw)
              for d, (cm, ca) in enumerate(cols)]
        torch.cuda.synchronize()
        for d, ((vk, kk), (vp, kp)) in enumerate(zip(pk, pp)):
            assert torch.equal(vk, vp) and torch.equal(kk, kp), \
                f"K4l B={B} nd={nd} shard {d}: pairs differ from the plain version's"
        vals, keys = torch.stack([p[0] for p in pp]), torch.stack([p[1] for p in pp])
        args = (vals, keys, sp, co, consts.bitLUT)
        rk = dk.shard_select(*args, **kw4, M=spec.num_masks, code_val=inp["code_val"], hits=hits,
                             row=torch.zeros((B, L), device="cuda"))
        rp = dk.shard_select_rows_plain(*args, **kw4, M=spec.num_masks, code_val=inp["code_val"],
                                        hits=hits, row=torch.zeros((B, L), device="cuda"))
        if consts.bitLUT is None:
            dk.nrzs_bits(rk, consts.symbolLUT, S)
            dk.nrzs_rows_plain(rp, consts.symbolLUT, S)
        torch.cuda.synchronize()
        assert torch.equal(rk, rp), f"K4s B={B} nd={nd}: rows differ from the plain version's"
        clipped[nd] = int((rk[:, S:2 * S] == dk.TRUST_CLIPPED).sum())
        if nd == 2:
            split = int((rk[:, 2 * S:3 * S] >= Ml).sum())
        if hits is not None:
            assert clipped[nd] > 0, f"K4s B={B}: no slot met the clip window"
        if nd == 1 and consts.bitLUT is not None:
            k4 = dk.symbol_detect(inp["colmax"], inp["colarg"], sp, co, consts.bitLUT, **kw4,
                                  hits=hits)
            for j, name in enumerate(("symbols", "centres", "mags", "bits")):
                i = PACK_ARRAYS.index(name)
                assert torch.equal(rk[:, i * S:(i + 1) * S], k4[j].float()), \
                    f"K4l + K4s at nd = 1: {name} differ from K4's"
    return clipped, split


def generic_blocks(spec, C, seed=SEED + 60):
    """C flagship blocks of seeded GFSK, each with its own bits, Doppler
    offset (-DOPPLER_HZ .. +DOPPLER_HZ) and noise; returns (blocks complex64,
    sent bits per channel, the offsets)."""
    dopp = [DOPPLER_HZ * (2.0 * c / max(C - 1, 1) - 1.0) for c in range(C)]
    out = [signal_stream(spec, spec.Nfft, seed=seed + c, doppler_hz=dopp[c]) for c in range(C)]
    return np.stack([o[0] for o in out]), [o[1] for o in out], dopp


def main_path_generic(spec):
    """Phase 4i: ``build_sharded_demod_step(force_generic=True)`` on the
    one-card mesh at C=GENERIC_C (with the vote): K1, K2, K3, K4l, K4s, K5
    and K8 launch, K4 does not; bits, symbols and centres equal the
    channel-parallel step's on every channel; decisions and the voted pair
    equal the plain generic step's; BER < 1e-3 and the Doppler offset
    within baud/2 on every channel."""
    blocks, sent, dopp = generic_blocks(spec, GENERIC_C)
    x = torch.from_numpy(blocks).cuda()
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=["cuda"])
    gen = build_sharded_demod_step(spec, mesh, force_generic=True)
    ops.reset_launches()
    res = gen(x)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("generic", launches)
    fast = build_sharded_demod_step(spec, mesh)(x)
    plain = build_sharded_demod_step(spec, mesh, force_generic=True, plain=True)(x)
    torch.cuda.synchronize()
    for k in ("bits", "symbols", "centres"):
        assert torch.equal(res[k], fast[k]), f"generic: {k} differ from the channel-parallel step's"
    for k in DECISIONS + ("bits_voted", "trust_voted"):
        assert torch.equal(res[k], plain[k]), f"generic: {k} differ from the plain step's"
    out = {k: v.cpu().numpy() for k, v in res.items()}
    bers = []
    for c in range(GENERIC_C):
        ber, lag = best_aligned_ber(out["bits"][c, :out["nBits"][c]].astype(np.int64), sent[c])
        off = float(out["freq_offset_hz"][c])
        assert ber < 1e-3, f"generic channel {c}: BER {ber} at lag {lag}"
        assert abs(off - dopp[c]) < spec.baudRate / 2, f"generic channel {c}: {off} Hz vs {dopp[c]}"
        bers.append(ber)
    return dict(C=GENERIC_C, max_ber=max(bers), launches=launches,
                trust_minus1_beyond_nsym=int((out["trust"] == -1).sum()))


def _generic_rank(rank, port, blocks, results):
    """One rank of phase 4j: the generic step on its channel shard of
    ``blocks`` in the {"channel": 2, "dopp": 2} mesh over gloo on cuda:0;
    puts (rank, outputs, launches, backend, median ms per call of five
    timed calls) on ``results``."""
    import torch.distributed as dist

    init_distributed(f"127.0.0.1:{port}", RANKS, rank, backend="gloo")
    mesh = make_mesh({"channel": 2, "dopp": 2}, devices=["cuda:0"] * RANKS)
    step = build_sharded_demod_step(configuration("flagship")[2], mesh)
    x = torch.from_numpy(blocks[local_channel_slice(mesh, len(blocks))]).cuda()
    step(x)  # builds the library's handle and the allocator caches
    torch.cuda.synchronize()
    ops.reset_launches()
    res = step(x)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    times = []
    for _ in range(5):  # host clock per call: the collectives cross the host on gloo
        dist.barrier()
        t0 = time.perf_counter()
        step(x)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    results.put((rank, {k: v.cpu().numpy() for k, v in res.items()}, launches,
                 dist.get_backend(), statistics.median(times)))
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def main_path_ranks(spec):
    """Phase 4j: four ranks of one ``torch.distributed`` world (gloo; NCCL
    refuses two ranks on one card), all on cuda:0, run the generic step on
    {"channel": 2, "dopp": 2} over RANKS_C channels with the vote; each
    rank's outputs held against the one-process generic step on the same
    blocks by the golden table (bits equal, symbols >= 99.9% equal, centres
    within W, spSym within 1e-3, Doppler within 1 Hz), the voted pair equal
    on all ranks. Every wait is bounded; every rank is ended."""
    blocks, _, _ = generic_blocks(spec, RANKS_C, seed=SEED + 80)
    mesh1 = make_mesh({"channel": 1, "dopp": 1}, devices=["cuda"])
    ref = {k: v.cpu().numpy() for k, v in build_sharded_demod_step(
        spec, mesh1, force_generic=True)(torch.from_numpy(blocks).cuda()).items()}
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_generic_rank, args=(r, port, blocks, results))
             for r in range(RANKS)]
    got = {}
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        while len(got) < RANKS:
            assert time.perf_counter() - t0 < RANKS_WAIT_S, \
                f"phase 4j: {RANKS - len(got)} ranks did not report in {RANKS_WAIT_S} s"
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            assert not failed, f"phase 4j: ranks exited with {failed}"
            try:
                rank, out, launches, backend, ms = results.get(timeout=1.0)
            except queue.Empty:
                continue
            got[rank] = (out, launches, backend, ms)
        for p in procs:
            p.join(timeout=60)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    W = spec.windowWidth
    stats = {}
    for r, (out, launches, backend, ms) in sorted(got.items()):
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        want = {k: v[rows] for k, v in ref.items() if k not in ("bits_voted", "trust_voted")}
        for k in ("bits", "nBits"):
            assert np.array_equal(out[k], want[k]), f"rank {r}: {k} differ from one process's"
        sym = float(np.mean(out["symbols"] == want["symbols"]))
        assert sym >= 0.999, f"rank {r}: symbols {sym} equal"
        assert np.abs(out["centres"] - want["centres"]).max() <= W, f"rank {r}: centres"
        assert np.abs(out["spSym"] - want["spSym"]).max() <= 1e-3, f"rank {r}: spSym"
        assert np.abs(out["doppler_hz"] - want["doppler_hz"]).max() <= 1.0, f"rank {r}: Doppler"
        for k in ("bits_voted", "trust_voted"):
            assert np.array_equal(out[k], got[0][0][k]), f"rank {r}: {k} differ from rank 0's"
        assert all(launches[k] > 0 for k in PATH_KERNELS["generic"]), f"rank {r}: {launches}"
        stats[r] = dict(symbols_equal=sym, spsym_err=float(np.abs(out["spSym"] - want["spSym"])
                                                           .max()), backend=backend,
                        ms_per_call=ms,
                        launches={k: launches[k] for k in PATH_KERNELS["generic"]})
    voted_as_one = bool(np.array_equal(got[0][0]["bits_voted"], ref["bits_voted"]))
    return dict(C=RANKS_C, ranks=RANKS, backend=got[0][2], per_rank=stats,
                voted_equal_one_process=voted_as_one,
                seconds=round(time.perf_counter() - t0, 2))


def k4l_bound(spec, B):
    """K4l's least time: per block the W-sample windows (at most N samples)
    and one colargmax word a slot read, spSym and codeOffset; the value and
    key written (8 bytes a slot) | W compares and ~8 slot operations a slot."""
    N, S, W = spec.Nfft, spec.numSymMax, spec.windowWidth
    return bound_of(B * (4 * min(S * W, N) + 4 * S + 8 + 8 * S), B * S * (W + 8))


def k4s_bound(spec, B, nd, clip=False):
    """K4s's least time: nd values and keys read and the five arrays written
    a slot (8 nd + 20 bytes), the scalars, (clip) the hit bitmask | 2 nd
    compares and ~12 operations a slot."""
    N, S = spec.Nfft, spec.numSymMax
    return bound_of(B * (S * (8 * nd + 20) + 36 + (N // 8 if clip else 0)),
                    B * S * (2 * nd + 12))


def time_slice6(spec, consts):
    """K4l (the whole bank, the one-card generic path's shape) and K4s
    (nd = 1) at B=1/16/64: name -> {B: (ms, plain_ms, (bound ms, by))}; the
    generic step against the channel-parallel step at C=GENERIC_C on the
    same blocks (ms per call)."""
    out = {"symbol_detect_local": {}, "shard_select": {}}
    kw, kw4 = k4l_kwargs(spec), k4_kwargs(spec, consts)
    L = packed_len(spec)
    for B in BATCHES:
        inp = kernel_inputs(spec, consts, B)
        a = (inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"])
        out["symbol_detect_local"][B] = (
            cuda_ms(lambda: dk.symbol_detect_local(*a, m0=0, **kw)),
            cuda_ms(lambda: dk.symbol_detect_local_plain(*a, m0=0, **kw)), k4l_bound(spec, B))
        v, k = dk.symbol_detect_local(*a, m0=0, **kw)
        s4 = (v[None], k[None], inp["spSym"], inp["codeOffset"], consts.bitLUT)
        row = torch.empty((B, L), device="cuda")
        k4s = dict(kw4, M=spec.num_masks, code_val=inp["code_val"], row=row)
        out["shard_select"][B] = (cuda_ms(lambda: dk.shard_select(*s4, **k4s)),
                                  cuda_ms(lambda: dk.shard_select_rows_plain(*s4, **k4s)),
                                  k4s_bound(spec, B, 1))
    x = torch.from_numpy(generic_blocks(spec, GENERIC_C)[0]).cuda()
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=["cuda"])
    gen = build_sharded_demod_step(spec, mesh, force_generic=True)
    fast = build_sharded_demod_step(spec, mesh)
    out["generic_ms"] = cuda_ms(lambda: gen(x), iters=5, reps=5)
    out["channel_parallel_ms"] = cuda_ms(lambda: fast(x), iters=5, reps=5)
    out["generic_ms_again"] = cuda_ms(lambda: gen(x), iters=5, reps=5)
    out["channel_parallel_ms_again"] = cuda_ms(lambda: fast(x), iters=5, reps=5)
    return out


def k9_bound(wb, T):
    """K9's least time: the input, the carry and the taps read, y and the
    new carry written | (4 K + 5 log2 M) T M f32 operations (the K-tap sum,
    then an FFT across the branches)."""
    M, K = wb["M"], wb["taps_per_branch"]
    nbytes = 2 * T * M * 8 + 2 * (K - 1) * M * 8 + K * M * 4
    return bound_of(nbytes, (4 * K + 5 * math.log2(M)) * T * M)


def time_slice5(wb, spec, tracker, xb):
    """K9 at the wideband shape (kernel, plain version, the two-call
    yardstick: a grouped ``conv1d`` over the branches and ``torch.fft.fft``
    across them, TF32 off); the wideband chain (K9 plus the step at C=64,
    vote off) per hop; the tracker's acquire and track graphs per block at
    B=1 (CUDA events)."""
    M, K, N = wb["M"], wb["taps_per_branch"], spec.Nfft
    x, st = k9_inputs(wb, N)
    ch = pch.Channelizer(M, K, wb["beta"], device="cuda")
    k9 = (cuda_ms(lambda: pch.channelize(x, ch.h2, st, tw=ch.tw)),
          cuda_ms(lambda: pch.channelize_plain(x, ch.h2, st), iters=5, reps=5))
    torch.backends.cudnn.allow_tf32 = False
    xin = torch.view_as_real(torch.cat([st, x.view(N, M)]).T.contiguous()).permute(2, 0, 1)
    xin = xin.contiguous()  # (2, M, N + K - 1) f32: re and im as two batches
    w = ch.h2.flip(0).T.contiguous()[:, None, :]  # (M, 1, K): w[p, 0, j] = h2[K-1-j, p]

    def yardstick():
        v = torch.nn.functional.conv1d(xin, w, groups=M)  # (2, M, N)
        return torch.fft.fft(torch.complex(v[0], v[1]), dim=0)

    yk = pch.channelize(x, ch.h2, st, tw=ch.tw)[0]
    torch.cuda.synchronize()
    e = float((yardstick() - yk).abs().max()) / float(yk.abs().max())
    assert e <= 1e-5, f"K9 yardstick disagrees with K9: {e}"
    yard_ms = cuda_ms(yardstick)
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=["cuda"])
    step = build_sharded_demod_step(spec, mesh, vote=False)
    y = ch(x)[0]
    chain_ms = cuda_ms(lambda: step(ch(x)[0]), iters=5, reps=5)
    step_ms = cuda_ms(lambda: step(y), iters=5, reps=5)
    centre = 3
    acq_ms = cuda_ms(lambda: tracker._acquire(xb[0]), iters=10)
    trk_ms = cuda_ms(lambda: tracker._track(xb[0], centre), iters=10)
    return dict(k9=k9, k9_bound=k9_bound(wb, N), yardstick_ms=yard_ms, yardstick_err=e,
                chain_ms=chain_ms, step_ms=step_ms, acquire_ms=acq_ms, track_ms=trk_ms)


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


def bound_of(nbytes, flops):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the f32 operations over the f32 rate."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


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
    return {name: bound_of(*work[name])
            for name in PATH_KERNELS["flagship" if spec.doppler_search else "stx"]}


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
    return bound_of(nbytes, steps * (4 * 3 + 128 + 64 + 63 + 64 + 1))


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


def nrzs_bound(spec, B):
    """K4n's least time: per block the symbols and trust read and the bits
    and trust written (16 bytes a slot), nSym and nBits; the LUT once |
    2K compares a slot."""
    S = spec.numSymMax
    M, _, K = spec.symbolLUT.shape
    return bound_of(B * (16 * S + 8) + 8 * M * K, B * S * 2 * K)


def vote_bound(C, S):
    """K8's least time: each row's bits and trust read, the pair written
    (C S 8 + S 8 bytes) | about 6 operations a (channel, slot)."""
    return bound_of(C * S * 8 + S * 8, 6 * C * S)


def time_slice4(bspec, bconsts, fspec):
    """K4n at B=1/16/64 on the bench_BPSK rows and K8 at C=3/16/64 on the
    flagship rows: name -> {B or C: (ms, plain_ms, (bound ms, by))}; and the
    group graph at C=3 against the block graph at B=3 on the same blocks
    (ms per call), which gives the vote's share."""
    out = {"nrzs_bits": {}, "vote": {}}
    S, lut = bspec.numSymMax, bconsts.symbolLUT
    for B in BATCHES:
        rows = nrzs_rows(bspec, bconsts, B)
        out["nrzs_bits"][B] = (cuda_ms(lambda: dk.nrzs_bits(rows, lut, S)),
                               cuda_ms(lambda: dk.nrzs_rows_plain(rows, lut, S)),
                               nrzs_bound(bspec, B))
    L, S = packed_len(fspec), fspec.numSymMax
    for C in VOTE_CS:
        rows, _ = vote_input(C, S, L)
        o = torch.empty((2, S), device="cuda")
        out["vote"][C] = (cuda_ms(lambda: pv.vote_rows(rows, S, 1.2, o)),
                          cuda_ms(lambda: pv.vote_rows_plain(rows, S, 1.2, o)),
                          vote_bound(C, S))
    x = torch.from_numpy(group_blocks(fspec, GROUP_C)[0]).cuda()
    group = build_group_graph(fspec, GROUP_C, 1.2, device="cuda")
    batch = build_process_batch(fspec, device="cuda", packed=True)
    out["group_ms"] = cuda_ms(lambda: group(x), iters=10)
    out["batch_ms"] = cuda_ms(lambda: batch(x), iters=10)
    return out


def profile_graph(spec, B, calls=10, top=8):
    """Device busy time by kernel name and the device's idle share over
    ``calls`` back-to-back calls of the packed block graph (torch.profiler)."""
    graph = build_process_batch(spec, device="cuda", packed=True)
    x = signal_blocks(spec, B)
    return profile_calls(lambda: graph(x), calls, top)


def profile_calls(fn, calls=10, top=8):
    """(wall ms/call, device busy ms/call, kernel names, the top ones) over
    ``calls`` back-to-back calls of ``fn`` under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
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
    bcfg = bpsk_configuration()
    bspec = bcfg[2]
    bconsts = DeviceConsts.from_spec(bspec, torch.device("cuda"))
    minus1 = {B: check_nrzs(bspec, bconsts, B) for B in BATCHES}
    errs["nrzs_bits"] = 0.0
    say("kernels", f"K4n nrzs_bits vs plain OK at the bench_BPSK shape (Nfft 2^16, S "
                   f"{bspec.numSymMax}, LUT {tuple(bspec.symbolLUT.shape)}), B={list(BATCHES)}: "
                   f"rows equal, trust -2 kept; slots set to trust -1: {minus1}")
    fspec = cfg["flagship"][2]
    for C in VOTE_CS:
        for master in VOTE_MASTERS:
            errs["vote"] = check_vote(C, fspec.numSymMax, packed_len(fspec), master)
    say("kernels", f"K8 vote vs plain OK at C={list(VOTE_CS)}, S={fspec.numSymMax}, master_idx "
                   f"{list(VOTE_MASTERS)}: masked rows and voted pair equal, pinned ties vote 0, "
                   f"disqualified slots trust -1; with the pad mask off (the generic step's "
                   f"vote) rows untouched and voted pair equal")
    wb = wideband_conf()
    k9_abs, k9_rel, halves_equal = check_channelize(wb, fspec.Nfft)
    errs["channelize"] = k9_abs
    say("kernels", f"K9 channelize vs plain OK at M={wb['M']}, K={wb['taps_per_branch']}, "
                   f"T={fspec.Nfft} with a random carry: max abs err {k9_abs:.3e}, "
                   f"{k9_rel:.3e} of max|y| (bar {K9_REL}); carry equal; two half hops == one "
                   f"hop (bit-equal: {halves_equal})")
    for B in (1, 16):
        e1, e5 = check_recentre(fspec, consts["flagship"], B)
        errs["doppler_energy"] = max(errs["doppler_energy"], e1)
        errs["doppler_estimate"] = max(errs["doppler_estimate"], e5)
        say("kernels", f"K1, K5 with centre_shift {recentres(fspec.Nfft, B).tolist()} vs plain "
                       f"OK at B={B}: K1 max abs err {e1:.4g}, K5 {e5:.4g}")
    for label, spec_, consts_ in (("flagship", fspec, consts["flagship"]),
                                  ("stx", cfg["stx"][2], consts["stx"]),
                                  ("bench_BPSK", bspec, bconsts)):
        for B in (1, 16):
            clipped, split = check_split_detector(spec_, consts_, B)
            half = spec_.num_masks // 2
            say("kernels", f"K4l, K4s vs plain OK at the {label} shape B={B} (M="
                           f"{spec_.num_masks}: one shard and the halves [0, {half}) and "
                           f"[{half}, {spec_.num_masks})): pairs and rows "
                           f"equal{' with K4n after K4s' if consts_.bitLUT is None else ''}; slots "
                           f"the upper half won {split}; trust -2 slots {clipped}")
    errs["symbol_detect_local"] = errs["shard_select"] = 0.0

    res = {"flagship": main_path_flagship(*cfg["flagship"]),
           "stx": main_path_stx(*cfg["stx"])}
    for p in res:
        say("main", f"{p} process x16 == processMany(16) == processCapture == plain path; "
                    + json.dumps(res[p]))
    res["ccsds"] = main_path_ccsds()
    say("main", f"ccsds {CCSDS_FRAMES} frames bit-exact at {list(SNRS_DB)} dB via process and "
                f"processMany(16); plain path's packets equal at {SNRS_DB[-1]} dB; "
                + json.dumps(res["ccsds"]))
    res["bpsk"] = main_path_bpsk(*bcfg)
    say("main", "bpsk process x16 == processMany(16) == processCapture == plain path; packets "
                "equal to the payload; " + json.dumps(res["bpsk"]))
    res["group"] = main_path_group(fspec)
    say("main", f"group C={GROUP_C}: rows and voted pair equal to the plain path's, voted BER "
                f"<= the best channel's; " + json.dumps(res["group"]))
    t_s5 = time.perf_counter()
    res["wideband"] = main_path_wideband(wb, fspec)
    say("main", f"wideband M={wb['M']} one hop of {wb['M']} x {fspec.Nfft} samples -> K9 -> "
                f"step C={wb['M']}: BER < 1e-3 in channels {list(WB_CHANNELS)}, decisions equal "
                f"to the plain step's there; vote run C={WB_VOTE_C}: voted BER <= the best "
                f"channel's; " + json.dumps(res["wideband"]))
    res["tracking"], tracker, track_blocks = main_path_tracking(fspec)
    say("main", f"tracking {TRACK_BLOCKS}-block S-curve pass at {TRACK_SNR_DB} dB: kernel and "
                f"plain trackers equal in modes and bits on every block; "
                + json.dumps(res["tracking"]))
    say("main", f"slice-5 paths took {time.perf_counter() - t_s5:.1f} s")
    t_s6 = time.perf_counter()
    res["generic"] = main_path_generic(fspec)
    say("main", f"generic step (force_generic, one card) C={GENERIC_C}: bits, symbols, centres "
                f"equal to the channel-parallel step's; decisions and voted pair equal to the "
                f"plain step's; BER < 1e-3 and Doppler within baud/2 per channel; "
                + json.dumps(res["generic"]))
    ranks = main_path_ranks(fspec)
    say("main", f"generic step on {{\"channel\": 2, \"dopp\": 2}}: {RANKS} ranks on cuda:0 over "
                f"{ranks['backend']}, C={RANKS_C}: every rank within the golden table of the "
                f"one-process step, the voted pair equal on all ranks; " + json.dumps(ranks))
    say("main", f"slice-6 paths took {time.perf_counter() - t_s6:.1f} s")
    t_rt = time.perf_counter()
    runtime = main_path_runtime()
    say("main", f"runtime: PyCuSDR decoded the payload from bench_3_chan_rx.json (channel group) "
                f"and bench_FSK.json (one demodulator child), children on the card, in "
                f"{time.perf_counter() - t_rt:.1f} s; " + json.dumps(runtime))

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

    t4 = time_slice4(bspec, bconsts, fspec)
    for k, unit in (("nrzs_bits", "B"), ("vote", "C")):
        for n, (ms, pms, (bms, by)) in t4[k].items():
            assert ms >= bms and pms >= bms, f"{k} {unit}={n}: a time is below bound_ms {bms}"
            say("times", f"{card} | {k} {unit}={n}: ms={ms:.5f} plain_ms={pms:.5f} "
                         f"library_ms=null bound_ms={bms:.4g} ({by})")
    say("times", f"{card} | group graph C={GROUP_C} {t4['group_ms']:.4f} ms/call against the "
                 f"block graph at B={GROUP_C} {t4['batch_ms']:.4f} ms/call on the same blocks: "
                 f"the vote adds {t4['group_ms'] - t4['batch_ms']:.4f} ms "
                 f"({100 * (t4['group_ms'] - t4['batch_ms']) / t4['group_ms']:.1f}%)")
    t5 = time_slice5(wb, fspec, tracker, track_blocks)
    (k9_ms, k9_pms), (k9_bms, k9_by) = t5["k9"], t5["k9_bound"]
    for v in (k9_ms, k9_pms, t5["yardstick_ms"]):
        assert v >= k9_bms, f"K9: a time {v} is below bound_ms {k9_bms}"
    say("times", f"{card} | channelize M={wb['M']} K={wb['taps_per_branch']} T={fspec.Nfft}: "
                 f"ms={k9_ms:.5f} plain_ms={k9_pms:.5f} library_ms=null "
                 f"bound_ms={k9_bms:.4g} ({k9_by}); yardstick (grouped conv1d + torch.fft.fft, "
                 f"TF32 off) {t5['yardstick_ms']:.5f} ms, rel err vs K9 {t5['yardstick_err']:.2e}")
    hop_ms = 1e3 * fspec.Nfft / fspec.sampleRate
    say("times", f"{card} | wideband chain (K9 + step C={wb['M']}, vote off) "
                 f"{t5['chain_ms']:.4f} ms per hop of {wb['M']} x {fspec.Nfft} samples "
                 f"({wb['M'] * fspec.Nfft / t5['chain_ms'] / 1e3:.1f} Msamples/s wideband; the "
                 f"step alone {t5['step_ms']:.4f} ms) against the {hop_ms:.1f} ms of signal a hop "
                 f"holds: {hop_ms / t5['chain_ms']:.1f}x real time")
    say("times", f"{card} | tracking graphs at B=1: acquire (D={fspec.D}) "
                 f"{t5['acquire_ms']:.4f} ms/block, track (D={tracker.track_spec.D}, "
                 f"centre_shift) {t5['track_ms']:.4f} ms/block, ratio "
                 f"{t5['acquire_ms'] / t5['track_ms']:.3f}")
    t6 = time_slice6(fspec, consts["flagship"])
    for k, unit in (("symbol_detect_local", "B"), ("shard_select", "B")):
        for n, (ms, pms, (bms, by)) in t6[k].items():
            assert ms >= bms and pms >= bms, f"{k} {unit}={n}: a time is below bound_ms {bms}"
            say("times", f"{card} | {k} {unit}={n}: ms={ms:.5f} plain_ms={pms:.5f} "
                         f"library_ms=null bound_ms={bms:.4g} ({by}) "
                         f"launches_per_block={1 / n:.4f}")
    say("times", f"{card} | generic step C={GENERIC_C} {t6['generic_ms']:.4f} / "
                 f"{t6['generic_ms_again']:.4f} ms/call against the channel-parallel step "
                 f"{t6['channel_parallel_ms']:.4f} / {t6['channel_parallel_ms_again']:.4f} ms/call "
                 f"on the same blocks (in turns: generic, parallel, generic, parallel)")
    for key, r in runtime.items():
        host = (f"Rx child host ms per block (timeMA) {r['host_ms_per_block']}, "
                if r["host_ms_per_block"] else "")
        say("times", f"{card} | runtime {key} ({r['config']}): {host}first packet after "
                     f"{r['first_packet_s']:.2f} s of feed")

    for p, B in (("flagship", 1), ("flagship", LINE_BATCH), ("stx", 1), ("wideband", 64),
                 ("generic", GENERIC_C)):
        if p == "generic":
            x = torch.from_numpy(generic_blocks(fspec, GENERIC_C)[0]).cuda()
            step = build_sharded_demod_step(fspec, make_mesh({"channel": 1, "dopp": 1},
                                                             devices=["cuda"]), force_generic=True)
            wall, busy, n, tops = profile_calls(lambda: step(x))
        elif p == "wideband":
            x, _ = k9_inputs(wb, fspec.Nfft)
            ch = pch.Channelizer(wb["M"], wb["taps_per_branch"], wb["beta"], device="cuda")
            step = build_sharded_demod_step(fspec, make_mesh({"channel": 1, "dopp": 1},
                                                             devices=["cuda"]), vote=False)
            wall, busy, n, tops = profile_calls(lambda: step(ch(x)[0]))
        else:
            wall, busy, n, tops = profile_graph(cfg[p][2], B)
        idle = "not measured" if n == 0 else f"{100 * (1 - busy / wall):.1f}%"
        what = {"wideband": "chain", "generic": "step"}.get(p, "graph")
        say("profile", f"{card} | {p} B={B} {what}: wall "
                       f"{wall:.4f} ms/call, device busy {busy:.4f} ms/call, idle {idle}; {n} "
                       f"kernel names, top (ms/call): {tops}")

    kernels = []
    for k, (src, replaces) in KERNELS.items():
        by_path = {p: res[p]["launches"][k] for p in res}
        if k in t6:
            ms, pms, (bms, by) = t6[k][LINE_BATCH]
            kernels.append({
                "name": k, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": errs[k], "ms": ms, "plain_ms": pms, "bound_ms": bms,
                "bound_by": by, "library_ms": None, "batch": LINE_BATCH,
                "shape": "flagship" + (", nd=1" if k == "shard_select" else ""),
                "by_B": {n: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2][0],
                             "bound_by": v[2][1]} for n, v in t6[k].items()}})
            continue
        if k in t4:
            unit = "B" if k == "nrzs_bits" else "C"
            at = LINE_BATCH if k == "nrzs_bits" else GROUP_C
            ms, pms, (bms, by) = t4[k][at]
            kernels.append({
                "name": k, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": errs[k], "ms": ms, "plain_ms": pms, "bound_ms": bms,
                "bound_by": by, "library_ms": None, unit.lower(): at,
                f"by_{unit}": {n: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2][0],
                                   "bound_by": v[2][1]} for n, v in t4[k].items()}})
            continue
        if k == "channelize":
            kernels.append({
                "name": k, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": errs[k], "ms": k9_ms, "plain_ms": k9_pms, "bound_ms": k9_bms,
                "bound_by": k9_by, "library_ms": None, "yardstick_ms": t5["yardstick_ms"],
                "shape": f"wideband M={wb['M']} K={wb['taps_per_branch']} T={fspec.Nfft}"})
            continue
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
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
