#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``pycusdr_tpu_torch``) on one
NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one status line each (any failure raises and exits non-zero,
and then no result line is printed):

1. device: ``nvidia-smi`` name and power limit, torch's device name;
2. build: compiles ``pycusdr_tpu_torch/csrc/*.cu`` (nvcc, sm_90a);
3. kernels: K2's and K3's launch geometry; each hand-written kernel
   against its plain PyTorch version, B=1 and B=16, from seeded inputs:
   K1-K5 at the flagship shape (Nfft 2^16, D=64, M=8), and K6 with K2-K4
   (K4 with the clip window) at the STX shape (Nfft 2^17, M=8, W=3), K2
   and K3 also at B=64 (and each block alone equal to its row of the
   batch); K1-K5 at the station shapes of ``CC11xx.json`` (Nfft 2^16, 128
   samples a symbol) and ``bench_3_chan_rx.json`` (Nfft 2^15, the shape of
   n's three children) at B=1, 16 and 64, each block alone equal to its
   row; K1 (3xTF32 on the tensor cores): ptxas's registers, stack and
   spills of its eight instantiations (none may spill) and the TF32 HMMA instructions cuobjdump finds in its SASS,
   then the kernel within 1e-4 of max|E| on the main paths' grids
   (flagship, ccsds, bpsk M=16, the tracker's 16 bins recentred, a generic
   shard's M=4, tiny, cc11xx, combiner) and on random, compact and mixed
   grids (M = 1, 5, 8, 16, 32; D = 1, 3, 100, 129; N from 512 to 2^18),
   each printed with the window and global-read groups it ran, every
   block alone equal to its row of the batch, two runs equal, and at the
   flagship grid at B=64;
   K9: ptxas's registers, stack and spills of the fused kernel's 22
   instantiations (none may spill; each at its row of ``k9_layouts``), the
   path shapes, then every form of ``k9_plan`` (M = 1 to 1024 at K = 1, 8 and
   32: every row split and the span and direct forms) on a ragged T and on
   T < K - 1 with a random carry, within 1e-5 of max|y|, the carry equal,
   two halves through the carry within 1e-5 of one call; K9's
   wide form (``csrc/channelizer_wide.cu``, one launch: ptxas's registers
   and spills of its instantiations, each at its row of
   ``k9_wide_layouts``) at (M, K, T) = (2048, 8, 2048), (64, 40, 65536),
   (4096, 2, 1024), the largest M (16384, 8, 256) and T < K - 1 (64, 40,
   16) with a random carry, within 1e-5 of max|y|, the carry equal, through
   two half hops, one launch a call; its split form (the FIR kernel, then
   cuFFT) above that M at (32768, 8, 128); K7 (the Viterbi
   trellis): ptxas's registers, stack and spills
   of its four instantiations (none may spill), then the kernel on
   hard, soft ±1/0 and soft random-float symbols, terminated and
   streaming, metric-only and decode, at the node-sync shape (S=2,
   T=2016/2015), the decode shape (S=1, T=2144), a feed's one launch
   (S=3), ragged lengths about the 32-step chunk edges (0 to 2144), S=64
   and S=129, and T=2^15; ``ViterbiStream`` through K7 equal to
   ``plain=True`` after every feed, one K7 launch a feed; K1 at the
   flagship grid with 64 and 128 masks (one launch per group of at most
   32); K5 on K5_GRIDS in both mask forms (ties within a thread, a lane,
   across lanes and warps; nd 1, 31, 33, 64 of D=2048 at offset 0 and 1;
   D=3000; M=1, 64, 128 with and without a recentre) to the contract of
   ``k5_contract``, and again with noise alone in the SNR bands, its band
   ratio within f32 rounding of float64's; K4 at B=64 on K4_CASES (the
   flagship and STX shapes, W=1, W above the symbol, sparse windows, hw at
   its clamp, N = 4097: tied magnitudes, A clamped at both ends, clip hits
   on word edges and in a partial last word), every output equal and each
   block alone equal to its row; K6 at K6_SIZES (every form of
   ``k6_plan``: one cluster launch at N not a multiple of 32, 33 chunks
   and 2^18; the long form's three passes above 2^18) against its plain
   version, each block alone equal to its row, its launch and the
   clusters the card holds printed; K6's bitmask at N = 4097 into K4 and
   K4s against their plain versions; K4's and K4s's NRZ-S forms with 64
   and 256 KB LUTs (read through L1) at B=1 and 16; K2 (its middle
   passes) and K3 at 2^19 and 2^20, B=4, each block alone equal to its
   row;
4. main paths, each with the launch counts set to 0 just before it and
   read just after it:
   a. flagship: the UHF demodulator (``models.uhf.Demodulator``) on a
      known GFSK signal over 16 hops through ``process``, ``processMany``
      and ``processCapture``; the bits must agree with each other and
      with the plain path on the card, recover the transmitted bits (BER < 1e-3)
      and the Doppler offset; K1-K5 must launch, K6 not;
   a'. deep: the flagship demodulator at xcorrMaskSize 6 (64 masks: K1
      in two launches a call) through ``processMany(16)``: bits and trust
      equal to the plain path's, BER < 1e-3, the Doppler offset; K1-K5
      must launch, K1 twice for each K5 launch;
   a''. big: the flagship demodulator at blockSize 19 (Nfft 2^19: K2's
      middle pass, K3's band partials in device memory) through
      ``processMany(4)``: bits and trust equal to the plain path's, BER
      < 1e-3, the Doppler offset; K1-K5 must launch;
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
      must launch, K6 not, K7 at most once per ``ViterbiStream.feed``;
   d. bpsk: ``bench_BPSK.json`` at blockSize 16 (16 masks, the (8, 2, 2)
      NRZ-S LUT) through ``models.uhf.Demodulator``, the same four ways,
      on seeded 10000-bit packets back to back at +3000 Hz; BER < 1e-3,
      every whole packet the port's ``Decoder`` finds equal to the
      payload; K1-K5 must launch, K4 always in its NRZ-S form (K4n in
      K4's launch, one a call);
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
      channel; and the same at C=16 bench_BPSK channels of seeded NRZ-S BPSK,
      where K4s runs its NRZ-S form (K4n in K4s's launch, one a call);
   j. ranks: the generic step on {"channel": 2, "dopp": 2} in four
      processes of one gloo world, all on cuda:0 (NCCL refuses two ranks on
      one card), C=4 with the vote: each rank within the golden table of
      the one-process step, the voted pair equal on every rank;
   n. three-station Rx: ``PyCuSDR`` from ``bench_3_chan_rx.json`` as
      shipped (softCombiner on, channel group off, bench_FSK at blockSize
      15; only its ports moved): three ``Demodulator_process`` children on
      the card and the ``SoftCombiner`` child; one seeded packet fed to the
      three RxInPorts at delays of 0, 1117 and 2403 samples with AWGN of
      its own each: the payload comes out of decodeBytesOut, XML-RPC
      ``get_active_workers`` names the three channels, a container reached
      the decoder voted by three (``numSlaves`` 2), every child launched
      K1-K5 (the counts each child publishes from its warm point on); then
      the diversity check: 40 blocks of seeded FSK received three times at
      -4.5 dB a sample, demodulated by the port's ``Demodulator`` on the
      card, voted in this process by ``SoftCombiner.compareWorkers`` (each
      round timed), the first channel's blocks also through the plain
      path (decisions and trust equal on every block): every channel's raw
      BER in [1e-3, 3e-2], every master's voted BER at or below the best
      channel's;
   o. hamlib: ``hamlib_daemon.serve_all`` as its ``main`` runs it, on a
      copy of ``hamlib_sockets.json`` (listener moved) and of
      ``CC11xx.json`` (sockets moved as in f) written under build/: a TCP
      client connects and the daemon's own modem factory boots the modem
      (Tx and Rx) from that file;
      ``\\chk_vfo``, ``\\dump_state``, ``I``/``i`` on the wire; the
      ``Modulator_process``'s rangerate within 1e-6 of
      ``rangerate_from_freq``; a 200-byte payload into TxDataIn after the
      steer comes out of the Rx equal to itself, the Rx's Doppler within
      half a baud of the shift the steer implies; K1-K5 in the Rx child;
      the client leaves and every child exits within ``JOIN_TIMEOUT``; a
      second client boots a second modem that answers;
   p. planned restart, in an interpreter of its own (``-c``, as the CLI
      starts a station: its children re-import no main module, where a
      child of this script would re-import it and torch with it):
      ``PyCuSDR`` from ``CC11xx.json`` (sockets moved as
      in f) with ``Main.maxWorkerRssMb``; CC11xx packets of 2-253 bytes
      from the port's ``Modulator`` paced into the Rx at -3 dB a sample for
      32 s or more; each child's memory printed warm and after its last
      block (statm ``resident`` and ``shared``; ``RssAnon``, ``RssFile``,
      ``RssShmem`` where the kernel's status has them; smaps' anonymous
      sum; the cap's figure, ``orchestrator.rss_mb``; whether it maps
      torch), the cap set between the Rx child's anonymous RSS and the
      largest other's (no gap fails), so
      the orchestrator restarts the Rx child make-before-break: the
      replacement ``...~r1`` warms (a second CUDA context on the card),
      both decode through the overlap, the old child goes; K1-K5 in both
      children while both lived and once a block in the replacement,
      every payload out of decodeBytesOut exactly once, the old child gone
      within the teardown's limits, ``native.AVAILABLE`` and the native
      ring and correlator in both Rx children and the decoder, no numpy
      form; printed: the replacement's warm-up, the overlap, the decode
      gap, the old child's exit, each child's card memory in the overlap
      and the Rx children's RSS warm and after their last blocks;
   q. station harnesses, in an interpreter of its own as in p, each step
      printing ``[harnesses] start <name>`` and then its seconds, ports
      12000-12704, at most 150 s of steps: ``bench.hw_selfcheck`` (five
      PASS lines, TF32 off); ``bench.ber_delta`` on FSK and GMSK at 4 and
      10 dB, 2 runs (the device arm and the numpy golden's packed rows
      through the same healer and frame finder: the same packets found,
      equal bit errors at 10 dB, |BER delta| <= 1e-3 at 4 dB); ``bench.ber``
      FSK at 18 dB, 2 runs (every packet bit-exact); ``bench.diversity``
      FSK at 8 dB, 2 runs (both arms to their end, the voted arm
      delivers); ``bench.streaming_rt`` at real time, 24 s of CC11xx
      signal at 18 dB and range rate 0 fed by ``frontend.sim_frontend``
      (every steady-state packet, all bit-exact, none twice); every child
      on the card, K1-K5 launched;
   r. timing harnesses, in an interpreter of its own as in p, each step
      printing ``[timers] start <name>`` and then its seconds, at most 90 s
      of steps: ``bench.profile_stages`` (the flagship at B=1 and 16 in both
      modes, STX at B=1 by stage: every stage row finite and clear of its
      bound, the prefix rows within 2% of the graph's busy time, the
      measured HBM and matmul roofs under 1.05 x the datasheet rates the
      bounds use); ``bench.subsystems`` (the channelizer at M=64, K=8 and,
      through K9's wide form, at M=2048, K=8 on a 2^22-sample hop: tone
      purity > 0.9; the tracker over 48 blocks at 10 dB locks);
      ``bench.capture_probe`` at K=32 (both routes' decisions and carries
      equal); ``bench.scaling`` (``--per-chip`` at C=16, auto and generic;
      ``run_scaling((1, 2))``, two spawned ranks on the card over gloo, port
      12801); ``bench.hw_leak_probe``, 200 iterations (np_input under 128 KB
      an iteration; the control at least half the row it keeps); the
      phase's kernels launched, scaling's ranks' counted;
   (phase 3 also holds K4's NRZ-S form (K4n in K4's launch) at the
   bench_BPSK shape at B=1/16/64 (with a clip bitmask) against its plain
   version, K8 at C=3/16/64/256, S=4608, with pinned
   ties and master_idx 0, 1 and C-1, with
   and without its pad mask, K9 at M=64, K=8, T=2^16 and at the vote's
   M=4 with a random carry (1e-5 of max|y|; two half hops equal one hop),
   K1 and K5 with
   centre_shift at B=1/16 against their plain versions, and K4l and K4s
   in every plan (B=1/16/64) at the flagship, STX (clip window) and
   bench_BPSK (K4s's NRZ-S form, K4n in its launch) shapes, on the whole
   bank, its halves and its quarters;
   no path may launch a standalone K4n;)
5. times: CUDA-event medians per kernel, its plain version and a
   PyTorch library yardstick (where one call computes the same
   function) at B=1/16/64, each kernel's device ms a call (torch.profiler,
   its own __global__ functions), and the whole block graph against the plain
   path, for both configurations; K7 at S=1/2/64 and at the feed's S=3
   and S=1 metric-only, with ns per trellis step beside an estimate of
   its dependency chain at ``clocks.max.sm``, and ``clocks.sm`` after;
   K4's NRZ-S form (beside K4 alone into the row) and the bench_BPSK
   block graph (wall and device busy ms) at B=1/16/64, and K8 at
   C=3/16/64; the group graph at C=3 against
   the block graph at B=3; the decoder's host ms per block
   beside the graph's and the runtime's demod child host ms per block;
   phase 4n's seconds to the first packet through the combiner and the
   combiner's host ms a ``compareWorkers`` round, phase 4o's boot, warm-up
   and teardown seconds; phase 4p's replacement warm-up, overlap, decode
   gap, the old child's exit, the Rx children's RSS and card memory;
   phase 4q's seconds a step and streaming_rt's packets and arrivals;
   K9 at the wideband shape (M=64) and the vote's (M=4) with its two-call
   yardstick (grouped conv1d + torch.fft.fft), its wide form at the
   five wide shapes and its split form, each with that yardstick, and its
   direct form at (1024, 8) and (512, 16) beside the wide form at the same
   shapes; the
   wideband chain per hop against the signal a hop holds; the tracker's
   acquire and track graphs per block at B=1; K4l, K4s at nd = 1 and 2,
   and K4s's NRZ-S form on bench_BPSK, at B=1/16/64, and the generic step
   at C=16 against the channel-parallel step on the
   same blocks; K2 and K3 at the big path's Nfft 2^19 (B=1 and 4), K6's
   long form at 2^19 (B=1 and 16) and the big graph at B=4; every time
   must clear its bound;
6. profile: device busy time by kernel and the device's idle share over
   calls of the block graph (torch.profiler): flagship at B=1, 16 and 64,
   STX at B=1 and 64, bench_BPSK at B=1, 16 and 64; of the wideband chain (K9 + the step at C=64); and of the
   generic step at C=16 on the flagship's GFSK and on bench_BPSK.

It then prints the card line, one JSON line with every kernel's numbers,
and as its last line ``{"ok": true, "device": {...}}``. It imports
nothing of JAX.
"""

import collections
import json
import math
import multiprocessing
import queue
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from pycusdr_tpu_torch import ops
from pycusdr_tpu_torch.bench.profile_stages import (
    PREFIX_HELD,
    bound_of,
    bounds,
    cuda_ms,
    device_ms,
    k6_work,
    profile_calls,
    snr_band_bins,
)
from pycusdr_tpu_torch.bench.subsystems import s_curve_blocks, s_curve_swing
from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.configs import (
    RADIO,
    ccsds_conf,
    ccsds_spec,
    flagship_conf,
    stx_conf,
    tiny_spec,
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
    modulate_gmsk,
    packet_data,
)
from pycusdr_tpu_torch.dsp.spec import build_spec, narrow_spec
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
from pycusdr_tpu_torch.utils.device_info import card_line

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
#: K7's shapes on the ccsds path: the two node-sync pairings of a feed (4032
#: symbols per flagship block), the decode buffer (256 carried + 4032), the
#: one launch a feed makes (all three), and the batch a multi-channel
#: decoder would run; ragged lengths about the 32-step chunk edges, and
#: those over 129 sequences (33 blocks of four warps)
VIT_SYNC, VIT_DECODE, VIT_BATCH = [2016, 2015], [2144], [2144] * 64
VIT_FEED = VIT_SYNC + VIT_DECODE
VIT_EDGES = [0, 1, 31, 32, 33, 63, 65, 2144]
VIT_WIDE = (VIT_EDGES * 17)[:129]
#: the ccsds feed sizes of the ViterbiStream check (one slip after 2500 symbols)
VIT_CHUNKS = (3, 30, 700, 1, 1300, 901, 2100, 64, 900, 4032, 4032)
#: K7's dependency chain per trellis step as csrc/viterbi.cu builds it: the
#: ALU operations from one step's minimum to the next (the subtraction, the
#: candidate add, two fminf, the two-op key map, the three-op inverse map),
#: at about this many cycles each, around one redux.sync whose latency is
#: not published and is left out: an estimate, not a bound
VIT_CHAIN_OPS, VIT_CYCLES_PER_OP = 9, 4
VIT_KINDS = ("hard", "soft_pm1", "soft_float")
CONFIGS = "pycusdr_tpu_torch/config/configs"
#: K8's channel counts: the three-antenna station (bench_3_chan_rx), and wider groups
VOTE_CS = (3, 16, 64)
#: K8's phase-3 channel counts (C=256: a chunk of 256 channels, 32 a warp)
VOTE_CHECK_CS = VOTE_CS + (256,)
GROUP_C = 3
#: the runtime phase's first port (it uses 35 from there, below the kernel's
#: ephemeral range and apart from the tests' ports) and its bound on every wait, s
RUNTIME_PORT = 17400
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
#: the flagship at this xcorrMaskSize (64 masks, phase 4) takes K1 in groups
DEEP_MASK_SIZE = 6
#: K6 beyond the STX shape: N not a multiple of 32 (one and two chunks, a
#: partial last clip word), 33 chunks (three a CTA), 2^18 (four a CTA: 1024
#: threads, 128 KB), and the long form above 2^18; three blocks each, two
#: with spikes
K6_SIZES = (1000, 4097, 33 * 4096 + 7, 2 ** 18, 2 ** 19, 2 ** 19 + 3)
#: NRZ-S LUTs above 48 KB (M, K), 64 and 256 KB, read through L1 by K4's and
#: K4s's NRZ-S forms, on S = 4608 slots at B=1 and 16
K4N_BIG_LUTS = ((2048, 4), (8192, 4))
#: K2 and K3 above 2^18 (K2's middle passes), alone and in a batch of BIG_B
BIG_NS, BIG_B = (2 ** 19, 2 ** 20), 4
#: the "big" path (phase 4k): the flagship spec at blockSize 19 (Nfft 2^19)
#: through processMany(BIG_HOPS)
BIG_BLOCK_SIZE, BIG_HOPS = 19, 4
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
    "symbol_detect_nrzs": ("pycusdr_tpu_torch/csrc/symbol_detect.cu",
                           "pycusdr_tpu/ops/demod_kernels.py:597"),
    "vote": ("pycusdr_tpu_torch/csrc/vote.cu", "pycusdr_tpu/parallel/vote.py:18"),
    "channelize": ("pycusdr_tpu_torch/csrc/channelizer.cu",
                   "pycusdr_tpu/parallel/channelizer.py:43"),
    "channelize_wide": ("pycusdr_tpu_torch/csrc/channelizer_wide.cu",
                        "pycusdr_tpu/parallel/channelizer.py:43"),
    "symbol_detect_local": ("pycusdr_tpu_torch/csrc/shard_select.cu",
                            "pycusdr_tpu/parallel/sharded_demod.py:46"),
    "shard_select": ("pycusdr_tpu_torch/csrc/shard_select.cu",
                     "pycusdr_tpu/parallel/sharded_demod.py:361"),
    "shard_select_nrzs": ("pycusdr_tpu_torch/csrc/shard_select.cu",
                          "pycusdr_tpu/parallel/sharded_demod.py:384"),
}
#: the kernels each configuration's path runs
PATH_KERNELS = {
    "flagship": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
                 "symbol_detect"),
    "stx": ("threshold_input", "mf_bank_colreduce", "timing_band", "symbol_detect"),
    "ccsds": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
              "symbol_detect", "viterbi"),
    "bpsk": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
             "symbol_detect", "symbol_detect_nrzs"),
    "group": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
              "symbol_detect", "vote"),
    "wideband": ("channelize", "doppler_energy", "doppler_estimate", "mf_bank_colreduce",
                 "timing_band", "symbol_detect", "vote"),
    "tracking": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
                 "symbol_detect"),
    "deep": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
             "symbol_detect"),
    "generic": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
                "symbol_detect_local", "shard_select", "vote"),
    "generic_bpsk": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
                     "symbol_detect_local", "shard_select", "shard_select_nrzs", "vote"),
    "big": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
            "symbol_detect"),
    "cc11xx": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
               "symbol_detect"),
    "gmsk": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
             "symbol_detect"),
    # the three Rx children of bench_3_chan_rx.json behind the softCombiner
    # (phase 4n), and the Rx child of the modem the hamlib daemon boots (4o)
    "combiner": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
                 "symbol_detect"),
    "hamlib": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
               "symbol_detect"),
    # CC11xx.json's Rx child and its planned-restart replacement (phase 4p)
    "restart": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
                "symbol_detect"),
    # the station harnesses (phase 4q): hw_selfcheck's and ber_delta's block
    # graphs in the phase's interpreter, the demodulator children of ber,
    # diversity and streaming_rt
    "harnesses": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
                  "symbol_detect"),
    # the timing harnesses (phase 4r): profile_stages (flagship and STX),
    # subsystems (K9, its wide form at M=2048, the tracker), capture_probe,
    # scaling (the vote; the generic step's K4l and K4s; the ranks of its
    # world of two) and hw_leak_probe
    "timers": ("doppler_energy", "doppler_estimate", "mf_bank_colreduce", "timing_band",
               "symbol_detect", "threshold_input", "vote", "channelize", "channelize_wide",
               "symbol_detect_local", "shard_select"),
}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def sm_clocks():
    """(maximum, current) SM clock of card 0 in MHz, as nvidia-smi reads them."""
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm,clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    top, now = out.stdout.strip().split(",")
    return float(top), float(now)


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


def kernel_inputs(spec, consts, B, x=None):
    """Every kernel's inputs at batch B, from the plain path on the card, on
    the blocks ``x`` (``signal_blocks`` when None)."""
    x = signal_blocks(spec, B) if x is None else x
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


def k5_contract(got, want, label="K5"):
    """K5 against its plain version: shift exact, dopp_idx within 1e-5
    relative, Hz within 1e-2 or one f32 step of the largest doppler_hz,
    whichever is larger (doppler_hz is the IF frequency, and
    freq_offset_hz = doppler_hz - the IF offset exactly: about the cc11xx
    shape's 148320 Hz a step is 2^-6 Hz), quality and SNR within 1e-3 dB
    (equal where not finite). Returns the max abs error over dopp_idx,
    quality_db and snr_db."""
    assert torch.equal(got[5], want[5]), f"{label} shift {got[5].tolist()} != {want[5].tolist()}"
    e_idx = float((got[0] - want[0]).abs().max())
    assert e_idx <= 1e-5 * max(1.0, float(want[0].abs().max())), f"{label} dopp_idx err {e_idx}"
    e_hz = max(float((got[i] - want[i]).abs().max()) for i in (2, 3))
    step = float(np.spacing(np.float32(want[2].abs().max().item())))
    assert e_hz < 1e-2 or e_hz <= step, f"{label} Hz err {e_hz} (f32 step {step})"
    err = e_idx
    for i in (1, 4):
        fin = torch.isfinite(want[i])
        assert torch.equal(fin, torch.isfinite(got[i])), f"{label} output {i} finiteness differs"
        assert torch.equal(got[i][~fin].nan_to_num(), want[i][~fin].nan_to_num())
        if bool(fin.any()):
            e = float((got[i] - want[i])[fin].abs().max())
            assert e < 1e-3, f"{label} output {i} err {e} dB"
            err = max(err, e)
    return err


def check_doppler_estimate(spec, consts, inp, centre=None):
    """K5 against its plain version (``k5_contract``), with an all-zero block
    appended. ``centre``: the (B,) int32 runtime recentre (the appended
    block gets 0). Returns the max abs error over dopp_idx, quality_db and
    snr_db."""
    E = torch.cat([inp["E"], torch.zeros_like(inp["E"][:1])])
    P = torch.cat([inp["P"], torch.zeros_like(inp["P"][:1])])
    args, kw = k5_args(spec, consts, E, P)
    if centre is not None:
        kw.update(centre_shift=torch.cat([centre, centre.new_zeros(1)]),
                  bin_hz=spec.sampleRate / spec.Nfft)
    got = ds.doppler_estimate(*args, **kw)
    want = ds.doppler_estimate_plain(*args, **kw)
    torch.cuda.synchronize()
    err = k5_contract(got, want)
    assert float(got[0][-1]) == 0.0 and float(got[4][-1]) == float("-inf"), "K5 idle block"
    return err


def check_threshold(x, scale, tag):
    """K6 against its plain version: pass-2 masks equal except where |a -
    thr| <= 1e-5 thr (the two sum in different orders), signals within
    rtol 1e-5 where the masks agree, the bits past N zero, and a block
    alone gives the bits it gives in the batch. Returns the max abs signal
    error."""
    N = x.shape[1]
    y, hits, anyk = dk.threshold_input(x, scale)
    yp, hp = dk.threshold_input_plain(x, scale)
    hk = dk.unpack_bits(hits, N)
    xd = x.to(torch.complex128)
    a = xd.abs()
    thr1 = scale * a.mean(dim=-1, keepdim=True)
    a1 = torch.minimum(a, thr1)
    thr2 = scale * a1.mean(dim=-1, keepdim=True)
    clear = ((a - thr1).abs() > 1e-5 * thr1) & ((a1 - thr2).abs() > 1e-5 * thr2)
    bad = int(((hk != hp) & clear).sum())
    assert bad == 0, f"{tag}: hit mask differs at {bad} clear samples"
    assert bool(hp.any()), f"{tag} check: no sample was clipped"
    assert torch.equal(dk.pack_bits(hk), hits), f"{tag}: bits past N set"
    agree = (hk == hp)[..., None].expand(-1, -1, 2)
    yr, ypr = torch.view_as_real(y)[agree], torch.view_as_real(yp)[agree]
    err = float((yr - ypr).abs().max())
    assert bool(((yr - ypr).abs() <= 1e-6 + 1e-5 * ypr.abs()).all()), f"{tag}: signal err {err}"
    assert torch.equal(anyk, hp.any(dim=-1).to(torch.int32)), f"{tag}: clipped_any"
    y0, h0, _ = dk.threshold_input(x[:1].contiguous(), scale)
    torch.cuda.synchronize()
    assert torch.equal(y0[0], y[0]) and torch.equal(h0[0], hits[0]), f"{tag}: batch != alone"
    return err


def spiky_blocks(B, N, seed):
    """B blocks of unit complex noise on the card, a spike of 60 in all but
    the last (one sample below N = 64, else three bursts of 8, 1 and 16)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N) + 1j * rng.randn(B, N)) / np.sqrt(2)
    spikes = ((8, N // 3), (1, 5), (16, N - 16)) if N >= 64 else ((1, N // 2),)
    for b in range(B - 1):
        for w, at in spikes:
            x[b, at:at + w] += 60.0 * np.exp(2j * np.pi * rng.rand(w))
    return torch.from_numpy(x.astype(np.complex64)).cuda()


def check_threshold_sizes():
    """K6 (``check_threshold``) at K6_SIZES, B=3: every form of ``k6_plan``.
    Returns [(N, plan, max abs err)]."""
    out = []
    for N in K6_SIZES:
        err = check_threshold(spiky_blocks(3, N, SEED + N % 1009), 4.5, f"K6 N={N}")
        out.append((N, dk.k6_plan(N), err))
    return out


def check_odd_clip(N=4097, B=16, S=2100):
    """K6's bitmask at N not a multiple of 32 (a partial last word) into K4
    and into K4s (nd = 1, after K4l), against their plain versions on the
    dilated mask of the same words: every output equal, some slot near the
    last word tagged. Returns the slots set to trust -2."""
    rng = np.random.RandomState(SEED + N)
    x = spiky_blocks(B, N, SEED + 3)
    x[:, N - 2] += 60.0  # a hit in the last word
    _, hits, _ = dk.threshold_input(x, 4.5)
    hit = dk.unpack_bits(hits, N)
    colmax = torch.from_numpy(rng.rand(B, N).astype(np.float32)).cuda()
    colarg = torch.from_numpy(rng.randint(0, 8, (B, N)).astype(np.int32)).cuda()
    sp = torch.from_numpy((2.0 + 0.01 * rng.rand(B)).astype(np.float32)).cuda()
    co = torch.from_numpy(rng.uniform(0, 2, B).astype(np.float32)).cuda()
    lut = torch.tensor([0, 1, 1, 0, 1, 0, 0, 1], dtype=torch.int8, device="cuda")
    kw = dict(Nfft=N, windowWidth=3, spsymMin=2, numSymMax=S, trust_normal=2)
    got = dk.symbol_detect(colmax, colarg, sp, co, lut, hits=hits, **kw)
    clip = dk.dilate_mask_plain(hit, dk.clip_halfwidth(sp, 2))
    want = dk.symbol_detect_plain(colmax, colarg, sp, co, lut, clip_mask=clip, **kw)
    kl = {k: v for k, v in kw.items() if k != "trust_normal"}
    val, key = dk.symbol_detect_local(colmax, colarg, sp, co, m0=0, M=8, **kl)
    rows = [torch.zeros((B, 5 * S + 12), device="cuda") for _ in range(2)]
    k4s = dict(kw, M=8, code_val=torch.zeros(B, device="cuda"), hits=hits)
    dk.shard_select(dk.pack_pairs(val, key)[None], sp, co, lut, row=rows[0], **k4s)
    dk.shard_select_rows_plain(val[None], key[None], sp, co, lut, row=rows[1], **k4s)
    torch.cuda.synchronize()
    for name, u, v in zip(("symbols", "centres", "mags", "bits", "trust", "nSym", "at_win"),
                          got, want):
        assert torch.equal(u, v), f"K4 N={N} with K6's bitmask: {name} differs"
    assert torch.equal(rows[0], rows[1]), f"K4s N={N} with K6's bitmask: rows differ"
    ns = int(want[5].min())
    assert bool(want[6][:, ns - 3:ns].any()), f"K4 N={N}: no slot near the last word tagged"
    return int(want[6].sum())


def check_nrzs_big(bspec, bconsts):
    """K4's and K4s's NRZ-S forms with LUTs above 48 KB (K4N_BIG_LUTS, read
    through L1) at the bench_BPSK shape (S = 4608) and B=1 and 16, against
    their plain versions: rows equal. K4 on ``nrzs_form_inputs`` with its
    colargmax random in [0, M + 2), K4s on the two halves of a bank of M + 2
    masks (K4l's pairs of the same columns); a third of each row's
    transitions planted in a table. Returns [(M, K, slots trust -1 by K4,
    by K4s)]."""
    out = []
    S, N = bspec.numSymMax, bspec.Nfft
    kw4 = k4_kwargs(bspec, bconsts)
    for M, K in K4N_BIG_LUTS:
        rng = np.random.RandomState(SEED + M)
        inp = nrzs_form_inputs(bspec, bconsts, 16)
        inp["colarg"] = torch.from_numpy(rng.randint(0, M + 2, (16, N)).astype(np.int32)).cuda()
        Ml = (M + 2) // 2
        loc = torch.from_numpy(rng.randint(0, Ml, (2, 16, N)).astype(np.int32)).cuda()
        cols = ((inp["colmax"], loc[0]), (inp["colmax"].roll(7, dims=1).contiguous(), loc[1]))
        pairs = torch.stack([dk.symbol_detect_local(cm, ca, inp["spSym"], inp["codeOffset"],
                                                    m0=d * Ml, packed=True,
                                                    **dict(k4l_kwargs(bspec), M=M + 2))
                             for d, (cm, ca) in enumerate(cols)])
        sym = {"K4": dk.symbol_detect(inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"],
                                      None, **kw4)[0],
               "K4s": dk.shard_select_plain(*dk.pair_views(pairs), inp["spSym"], inp["codeOffset"],
                                            None, M=M + 2, **kw4)[0]}
        lut = rng.randint(0, M, (M, 2, K)).astype(np.int32)
        for name, sy in sym.items():
            sy = sy.cpu().numpy()
            for b in range(16):
                for i in range(0, S, 3):  # a third of the transitions hit a table
                    if 0 <= sy[b, i] < M:
                        lut[sy[b, i], i % 2, i % K] = sy[b, (i + 1) % S]
        lt = torch.from_numpy(lut).cuda()
        minus1 = {}
        for B in (1, 16):
            L = packed_len(bspec)
            got = dk.symbol_detect_nrzs(inp["colmax"][:B], inp["colarg"][:B], inp["spSym"][:B],
                                        inp["codeOffset"][:B], lt, **kw4, hits=inp["hits"][:B],
                                        row=torch.zeros((B, L), device="cuda"),
                                        code_val=inp["code_val"][:B])
            want = dk.symbol_detect_plain(inp["colmax"][:B], inp["colarg"][:B], inp["spSym"][:B],
                                          inp["codeOffset"][:B], None, **kw4,
                                          clip_mask=dk.dilate_mask_plain(
                                              dk.unpack_bits(inp["hits"][:B], N),
                                              dk.clip_halfwidth(inp["spSym"][:B], bspec.spsymMin)))
            row = torch.zeros((B, L), device="cuda")
            dk._write_row_k4(row, want, S, inp["spSym"][:B], inp["codeOffset"][:B],
                             inp["code_val"][:B], None)
            want = dk.nrzs_rows_plain(row, lt, S)
            k4s = dict(kw4, M=M + 2, code_val=inp["code_val"][:B], hits=inp["hits"][:B])
            got_s = dk.shard_select_nrzs(pairs[:, :B].contiguous(), inp["spSym"][:B],
                                         inp["codeOffset"][:B], lt,
                                         row=torch.zeros((B, L), device="cuda"), **k4s)
            want_s = dk.nrzs_rows_plain(dk.shard_select_rows_plain(
                *dk.pair_views(pairs[:, :B]), inp["spSym"][:B], inp["codeOffset"][:B], None,
                row=torch.zeros((B, L), device="cuda"), **k4s), lt, S)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"K4 NRZ-S form, LUT ({M}, 2, {K}) B={B}: rows differ"
            assert torch.equal(got_s, want_s), \
                f"K4s NRZ-S form, LUT ({M}, 2, {K}) B={B}: rows differ"
            minus1 = (int((got[:, S:2 * S] == -1).sum()), int((got_s[:, S:2 * S] == -1).sum()))
            assert min(minus1) > 0 and bool((got[:, :S] == 1).any()) and \
                bool((got_s[:, :S] == 1).any()), f"LUT ({M}, 2, {K}) B={B}: {minus1}"
        out.append((M, K, *minus1))
    return out


def big_bank_inputs(N, B, M=8, seed=SEED):
    """K2's inputs above 2^18 (random spectra and masks, shifts) and K3's
    (a tone at a band bin under noise, per block), with K3's band."""
    rng = np.random.RandomState(seed + N % 997)
    S = torch.from_numpy((rng.randn(B, N) + 1j * rng.randn(B, N)).astype(np.complex64)).cuda()
    masks = torch.from_numpy((rng.randn(M, N) + 1j * rng.randn(M, N))
                             .astype(np.complex64)).cuda()
    shift = torch.from_numpy(rng.randint(0, N, B).astype(np.int32)).cuda()
    lo, hi = N // 16, N // 16 + N // 80  # the flagship band's place and width, scaled
    kt = lo + 1 + rng.randint(0, hi - lo - 2, B)
    n = np.arange(N)
    x = np.stack([0.3 * rng.randn(N) + np.cos(2 * np.pi * k * n / N + 0.7) for k in kt])
    return S, masks, shift, torch.from_numpy(x.astype(np.float32)).cuda(), lo, hi


def check_bank_band_big():
    """K2 (its middle passes) and K3 above 2^18 (BIG_NS) against their
    plain versions at B=BIG_B: K2 within 1e-4 of its maxima with colargmax
    equal at clear margins, K3's spSym exact and codeOffset within 1e-3;
    each block alone (the first and the last) equal to its row. Returns
    [(N, factors, K2 err, K3 err)]."""
    out = []
    for N in BIG_NS:
        S, masks, shift, x, lo, hi = big_bank_inputs(N, BIG_B)
        M = masks.shape[0]
        ks, km, ka = dk.mf_bank_colreduce(S, masks, shift, 1, M - 1)
        ps, pm, pa = dk.mf_bank_colreduce_plain(S, masks, shift, 1, M - 1)
        torch.cuda.synchronize()
        es = float((ks - ps).abs().max())
        em = float((km - pm).abs().max())
        assert es <= 1e-4 * float(ps.abs().max()), f"K2 N={N} colsum err {es}"
        assert em <= 1e-4 * float(pm.abs().max()), f"K2 N={N} colmax err {em}"
        top2 = torch.topk(dk.mf_bank_power_plain(S, masks, shift), 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0]
        bad = int(((ka != pa) & clear).sum())
        assert bad == 0, f"K2 N={N}: colargmax differs at {bad} clear-margin samples"
        del top2
        sp, co, cv = dk.timing_band(x, lo, hi)
        psp, pco, _ = dk.timing_band_plain(x, lo, hi)
        torch.cuda.synchronize()
        assert torch.equal(sp, psp), f"K3 N={N} spSym {sp.tolist()} != {psp.tolist()}"
        e3 = float((co - pco).abs().max())
        assert e3 <= 1e-3, f"K3 N={N} codeOffset err {e3}"
        for b in (0, BIG_B - 1):
            one = dk.mf_bank_colreduce(S[b:b + 1].contiguous(), masks, shift[b:b + 1].contiguous(),
                                       1, M - 1)
            alone = dk.timing_band(x[b:b + 1].contiguous(), lo, hi)
            torch.cuda.synchronize()
            assert all(torch.equal(u[0], v[b]) for u, v in zip(one, (ks, km, ka))), \
                f"K2 N={N}: block {b} alone != its row"
            assert all(torch.equal(u[0], v[b]) for u, v in zip(alone, (sp, co, cv))), \
                f"K3 N={N}: block {b} alone != its row"
        out.append((N, dk.fft_factors(N), max(es, em), e3))
    return out


def k3_margin(colsum, lo, hi, b):
    """The two strongest band bins of block b in the plain rfft and their
    relative power margin: printed when K3's spSym differs."""
    R = torch.fft.rfft(colsum[b:b + 1].double())[0, lo:hi]
    p = R.real * R.real + R.imag * R.imag
    top = torch.topk(p, 2)
    return (f"block {b}: bins {[lo + int(i) for i in top.indices]}, margin "
            f"{float((top.values[0] - top.values[1]) / top.values[0]):.3e}")


def check_bank_band(spec, consts, inp):
    """K2 and K3 against their plain versions on ``kernel_inputs``: K2's
    colsum and colmax within 1e-4 of their maximum and colargmax equal where
    the top two masks differ by more than 1e-4 relative; K3's spSym exact
    (the two bins' margin printed if not) and codeOffset within 1e-3. Both
    give the last block alone the bits it gets in the batch. Returns name ->
    max abs err."""
    M, off = spec.num_masks, spec.code_search_mask_offset
    lo, hi = spec.code_idx_lo, spec.code_idx_hi
    S, shift = inp["S"], inp["shift"]
    ks, km, ka = dk.mf_bank_colreduce(S, consts.masks_f, shift, off, M - off, tw=consts.tw)
    torch.cuda.synchronize()
    es = float((ks - inp["colsum"]).abs().max())
    em = float((km - inp["colmax"]).abs().max())
    assert es <= 1e-4 * float(inp["colsum"].abs().max()), f"K2 colsum err {es}"
    assert em <= 1e-4 * float(inp["colmax"].abs().max()), f"K2 colmax err {em}"
    top2 = torch.topk(dk.mf_bank_power_plain(S, consts.masks_f, shift), 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0]
    bad = int(((ka != inp["colarg"]) & clear).sum())
    assert bad == 0, f"K2 colargmax differs at {bad} clear-margin samples"

    sp, co, _ = dk.timing_band(inp["colsum"], lo, hi, tw=consts.tw)
    torch.cuda.synchronize()
    if not torch.equal(sp, inp["spSym"]):
        b = int(torch.nonzero(sp != inp["spSym"])[0])
        raise AssertionError(f"K3 spSym {sp.tolist()} != {inp['spSym'].tolist()}; "
                             + k3_margin(inp["colsum"], lo, hi, b))
    e3 = float((co - inp["codeOffset"]).abs().max())
    assert e3 <= 1e-3, f"K3 codeOffset err {e3}"

    last = S.shape[0] - 1
    one = dk.mf_bank_colreduce(S[last:].contiguous(), consts.masks_f,
                               shift[last:] if shift.shape[0] > 1 else shift, off, M - off,
                               tw=consts.tw)
    alone = dk.timing_band(inp["colsum"][last:].contiguous(), lo, hi, tw=consts.tw)
    torch.cuda.synchronize()
    assert all(torch.equal(u[0], v[last]) for u, v in zip(one, (ks, km, ka))), \
        "K2: a block alone != the same block in the batch"
    assert all(torch.equal(u[0], v[last]) for u, v in zip(alone, (sp, co))), \
        "K3: a block alone != the same block in the batch"
    return {"mf_bank_colreduce": max(es, em), "timing_band": e3}


def plan_lines(spec):
    """K2's and K3's launch geometry at the spec's shape, B=1/16/64."""
    N, M = spec.Nfft, spec.num_masks
    p3 = dk.timing_band_plan(N)
    lines = [f"K3 timing_band N={N}: band_partial grid ({p3['groups']}, B) x "
             f"{dk.FFT_THREADS} threads, {p3['chunks']} tiles of {p3['cw']} columns x "
             f"{p3['n1']} rows each, then band_argmax grid (B,); cluster {p3['cluster']}, "
             f"dynamic shared {p3['smem']} B"]
    for B in BATCHES:
        p2 = dk.mf_bank_plan(N, M, B)
        mid = (f", mf_mid factors {p2['mid']} grids {p2['grid_mid']} ({p2['Cm']} columns)"
               if "mid" in p2 else "")
        lines.append(f"K2 mf_bank_colreduce N={N} M={M} B={B}: factors {dk.fft_factors(N)}, "
                     f"mf_pass1 grid {p2['grid1']} ({p2['C']} columns){mid}, mf_pass2 "
                     f"grid {p2['grid2']} ({p2['R']} rows, {p2['Mg']} masks a group) x "
                     f"{dk.FFT_THREADS} threads; cluster {p2['cluster']}, dynamic shared "
                     f"{p2['smem']} B; Y {8 * B * M * N} B")
    if not spec.disable_peak_thresholding:
        lines.append(k6_plan_line(N))
    return lines


def k6_plan_line(N):
    """K6's launch at N (``k6_plan``) and, for the cluster form, how many of
    its clusters the card holds at once."""
    p = dk.k6_plan(N)
    if p["form"] == "long":
        return (f"K6 threshold_input N={N}: long form, thr_pass1-3 grid ({p['nch']}, B) x 256 "
                f"threads, chunk sums through a (2, B, {p['nch']}) scratch")
    return (f"K6 threshold_input N={N}: cluster form, thr_cluster grid ({p['cluster']}, B) in "
            f"clusters of {p['cluster']}, {p['threads']} threads ({p['chunks']} chunks of "
            f"{dk.K6_CHUNK}) and {p['smem']} B of dynamic shared memory a CTA; the card holds "
            f"{dk.k6_clusters(N)} such clusters at once")


def check_kernels(spec, consts, B, inp=None):
    """Each kernel of the spec's path against its plain version on
    ``inp`` (``kernel_inputs`` when None); returns name -> max abs err."""
    inp = kernel_inputs(spec, consts, B) if inp is None else inp
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
        errs["threshold_input"] = check_threshold(inp["x"], consts.threshold_scale,
                                                 f"K6 N={spec.Nfft}")

    errs.update(check_bank_band(spec, consts, inp))

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
    streaming x metric-only / decode at the node-sync (S=2), decode (S=1)
    and feed (S=3) shapes and at ragged lengths about the 32-step chunk
    edges (S=8, lengths 0 to 2144); every kind x metric-only / decode,
    streaming, at S=64 and at S=129 ragged (33 blocks); two cases at
    T=2^15. Bits equal; metrics equal (random-float soft: within 1e-6
    relative). Returns (max abs metric error, number of cases)."""
    cases = [(lengths, kind, term, dec) for lengths in (VIT_SYNC, VIT_DECODE, VIT_FEED, VIT_EDGES)
             for kind in VIT_KINDS for term in (True, False) for dec in (False, True)]
    cases += [(lengths, kind, False, dec) for lengths in (VIT_BATCH, VIT_WIDE)
              for kind in VIT_KINDS for dec in (False, True)]
    cases += [([2 ** 15], "soft_pm1", False, True), ([2 ** 15], "hard", True, True)]
    err = 0.0
    for lengths, kind, term, dec in cases:
        x = viterbi_inputs(kind, lengths)
        kw = dict(soft=kind != "hard", terminated=term, decode=dec)
        bk, mk = vit.viterbi_sweep(x, lengths, **kw)
        bp, mp = vit.viterbi_sweep_plain(x, lengths, **kw)
        torch.cuda.synchronize()
        label = f"K7 {kind} S={len(lengths)} T={max(lengths)} terminated={term} decode={dec}"
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


def check_viterbi_stream():
    """``ViterbiStream`` on the card through K7 against ``plain=True``, hard
    and soft ±1/0, over VIT_CHUNKS with a one-symbol slip: the same bits
    and state after every feed, and at most one K7 launch a feed (exactly
    one where it holds 64 symbols or more). Returns the launches per feed."""
    per_feed = []
    for kind in ("hard", "soft_pm1"):
        x = viterbi_inputs(kind, [sum(VIT_CHUNKS) // 2 + 1]).reshape(-1).cpu().numpy()
        x = np.r_[x[:2501], x[2502:]]
        a = vit.ViterbiStream(soft=kind != "hard", device="cuda")
        b = vit.ViterbiStream(soft=kind != "hard", device="cuda", plain=True)
        pos, parities = 0, set()
        for n in VIT_CHUNKS:
            before = vit.viterbi_sweep.launches
            ya = a.feed(x[pos:pos + n])
            per_feed.append(vit.viterbi_sweep.launches - before)
            yb = b.feed(x[pos:pos + n])
            pos += n
            label = f"ViterbiStream {kind} after {pos} symbols"
            assert np.array_equal(ya, yb), f"{label}: bits differ"
            assert a.parity == b.parity, label
            assert np.array_equal(a.carry, b.carry) and np.array_equal(a.pending, b.pending), label
            assert per_feed[-1] == 1 if n >= 64 else per_feed[-1] <= 1, \
                f"{label}: {per_feed[-1]} K7 launches in a feed of {n} symbols"
            parities.add(a.parity)
        assert len(parities) == 2, f"ViterbiStream {kind}: the slip forced no resync"
    assert max(per_feed) == 1, f"K7 launches per feed {per_feed}"
    return per_feed


def ptxas_report(source, pattern, count):
    """ptxas's report (``-Xptxas -v``, in the build log) of the ``count``
    entry functions of ``source`` whose mangled names match ``pattern``:
    [(pattern's groups..., registers, stack bytes, spill stores, spill loads)]."""
    log = Path(_lib.build_info["log"]).read_text()
    section = log.split(f"== {source}", 1)[1].split("\n== ", 1)[0]
    out = []
    for part in section.split("Compiling entry function")[1:]:
        name = re.search(pattern, part.split("\n", 1)[0])
        if name is None:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", part)
        out.append((*map(int, name.groups()), int(regs[1]), *map(int, frame.groups())))
    assert len(out) == count, f"ptxas reported {len(out)} entries of {source}: {section}"
    return out


def viterbi_ptxas():
    """K7's four instantiations: [(soft, decode, registers, stack bytes,
    spill stores, spill loads)]."""
    return ptxas_report("viterbi.cu", r"viterbiILb([01])ELb([01])EE", 4)


def symbol_detect_ptxas():
    """K4's eight instantiations, the centre-bit forms and the NRZ-S forms:
    [(SPT, argwin, vec, nrzs, registers, stack bytes, spill stores, spill
    loads)]."""
    return ptxas_report("symbol_detect.cu",
                        r"symbol_detectILi(\d)ELb([01])ELb([01])ELb([01])EE", 8)


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
    """Every kernel of the path launched, none of another path's, and no
    standalone K4n: K4n runs only in K4's or K4s's launch."""
    assert "nrzs_bits" not in launches, f"{path}: a standalone K4n wrapper exists"
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


def main_path_deep():
    """The flagship demodulator at xcorrMaskSize 6 (64 masks: K1 in two
    launches of 32 a call, K5 over 64 masks) on the flagship signal through
    ``processMany(N_HOPS)``, with the counts set to 0 just before it and
    read just after; bits and trust equal to the plain path's, BER below
    1e-3 and the Doppler within half a baud of the injected one, as on the
    flagship path; K1-K5 must launch, K1 once per mask group a call."""
    conf = flagship_conf(mask_size=DEEP_MASK_SIZE)
    protocol = loadProtocol("bench_GFSK")(conf=conf)
    spec = build_spec(conf, protocol, RADIO)
    N, ov = spec.Nfft, spec.sigOverlap
    stream, tx_bits = signal_stream(spec, ov + N_HOPS * (N - ov))
    hops = stream[ov:].reshape(N_HOPS, N - ov)
    d = UHF.Demodulator(conf, protocol, RADIO)
    dp = plain_demodulator(UHF.Demodulator, conf, protocol)
    for x in (d, dp):
        x.get_signalBufferHostPointer()[:ov] = stream[:ov]
    ops.reset_launches()
    seq = d.processMany(hops)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("deep", launches)
    groups = len(ds.k1_mask_groups(spec.num_masks))
    assert launches["doppler_energy"] == groups * launches["doppler_estimate"], \
        f"M={spec.num_masks}: K1 launched {launches['doppler_energy']} times, " \
        f"{groups} groups x {launches['doppler_estimate']} K5 launches expected"
    ref = dp.processMany(hops)
    for i, (a, b) in enumerate(zip(seq, ref)):
        for k in ("bits", "trust"):
            assert np.array_equal(a[k], b[k]), \
                f"M={spec.num_masks}: kernels != plain at block {i} ({k})"
        assert abs(a["doppler"] - DOPPLER_HZ) < spec.baudRate / 2, \
            f"M={spec.num_masks} block {i}: Doppler {a['doppler']} Hz, injected {DOPPLER_HZ}"
        assert math.isfinite(a["SNR"]) and a["SNR"] > 10, f"block {i}: SNR {a['SNR']}"
    rx = np.concatenate([a["bits"] for a in seq]).astype(np.int64)
    ber, lag = best_aligned_ber(rx, tx_bits)
    assert ber < 1e-3, f"M={spec.num_masks}: BER {ber} at lag {lag}"
    return dict(masks=spec.num_masks, ber=ber, lag=lag, bits=len(rx), launches=launches,
                doppler=[round(a["doppler"], 3) for a in seq[:3]])


def big_configuration():
    """(conf, protocol, spec) of the flagship spec at blockSize BIG_BLOCK_SIZE."""
    conf = flagship_conf()
    conf["GPU"]["UHF"]["blockSize"] = BIG_BLOCK_SIZE
    protocol = loadProtocol("bench_GFSK")(conf=conf)
    return conf, protocol, build_spec(conf, protocol, RADIO)


def main_path_big():
    """The flagship spec at Nfft 2^BIG_BLOCK_SIZE (K2's middle passes, K3's
    band partials in device memory) on the flagship signal through
    ``processMany(BIG_HOPS)``, with the counts set to 0 just before it and
    read just after; bits and trust equal to the plain path's, BER below
    1e-3 and the Doppler within half a baud of the injected one; K1-K5
    must launch."""
    conf, protocol, spec = big_configuration()
    N, ov = spec.Nfft, spec.sigOverlap
    stream, tx_bits = signal_stream(spec, ov + BIG_HOPS * (N - ov))
    hops = stream[ov:].reshape(BIG_HOPS, N - ov)
    d = UHF.Demodulator(conf, protocol, RADIO)
    dp = plain_demodulator(UHF.Demodulator, conf, protocol)
    for x in (d, dp):
        x.get_signalBufferHostPointer()[:ov] = stream[:ov]
    ops.reset_launches()
    seq = d.processMany(hops)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("big", launches)
    ref = dp.processMany(hops)
    for i, (a, b) in enumerate(zip(seq, ref)):
        for k in ("bits", "trust"):
            assert np.array_equal(a[k], b[k]), f"Nfft {N}: kernels != plain at block {i} ({k})"
        assert abs(a["doppler"] - DOPPLER_HZ) < spec.baudRate / 2, \
            f"Nfft {N} block {i}: Doppler {a['doppler']} Hz, injected {DOPPLER_HZ}"
        assert math.isfinite(a["SNR"]) and a["SNR"] > 10, f"Nfft {N} block {i}: SNR {a['SNR']}"
    rx = np.concatenate([a["bits"] for a in seq]).astype(np.int64)
    ber, lag = best_aligned_ber(rx, tx_bits)
    assert ber < 1e-3, f"Nfft {N}: BER {ber} at lag {lag}"
    return dict(Nfft=N, factors=list(dk.fft_factors(N)), ber=ber, lag=lag, bits=len(rx),
                launches=launches, doppler=[round(a["doppler"], 3) for a in seq],
                snr=[round(a["SNR"], 2) for a in seq])


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
    feeds = len(SNRS_DB) * 2 * K  # one ViterbiStream.feed a block, two decoders an SNR
    check_launches("ccsds", launches)
    assert launches["viterbi"] <= feeds, f"ccsds: {launches['viterbi']} K7 launches in {feeds} feeds"
    low = SNRS_DB[-1]
    _, pkts_plain, _, seq_plain = run(low, plain=True)

    res = dict(frames=CCSDS_FRAMES, blocks=K, launches=launches, viterbi_feeds=feeds)
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


def bpsk_blocks(spec, B, rng):
    """B blocks of seeded BPSK (``bpsk_stream``, random bits) on the card."""
    sps = int(spec.spsym)
    x = np.stack([bpsk_stream(spec, rng.randint(0, 2, spec.Nfft // sps + 8), spec.Nfft,
                              seed=SEED + b) for b in range(B)])
    return torch.from_numpy(x).cuda()


def nrzs_form_inputs(spec, consts, B):
    """K4's inputs on B BPSK blocks (``kernel_inputs``); at B > 1 the last
    block's colargmax random in [-1, 16] (transition errors and symbols
    outside the LUT's 8 rows), and a sparse clip bitmask (K4's trust -2,
    which the NRZ-S trust must keep)."""
    rng = np.random.RandomState(SEED + 15 + B)
    inp = kernel_inputs(spec, consts, B, x=bpsk_blocks(spec, B, rng))
    N = spec.Nfft
    if B > 1:
        inp["colarg"][-1] = torch.from_numpy(rng.randint(-1, 17, N).astype(np.int32)).cuda()
    inp["hits"] = dk.pack_bits(torch.from_numpy(rng.rand(B, N) < 0.001)).cuda()
    return inp


def nrzs_form_call(spec, consts, inp, row):
    """K4 and K4n in one launch (``symbol_detect_nrzs``) into ``row``."""
    return dk.symbol_detect_nrzs(inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"],
                                 consts.symbolLUT, **k4_kwargs(spec, consts), hits=inp["hits"],
                                 row=row, code_val=inp["code_val"])


def nrzs_form_plain(spec, consts, inp, row):
    """The NRZ-S form's plain version on the card: ``symbol_detect_plain``
    (with the dilated clip window) into ``row``, then ``nrzs_rows_plain``."""
    S = spec.numSymMax
    clip = dk.dilate_mask_plain(dk.unpack_bits(inp["hits"], spec.Nfft),
                                dk.clip_halfwidth(inp["spSym"], spec.spsymMin))
    out = dk.symbol_detect_plain(inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"],
                                 None, **k4_kwargs(spec, consts), clip_mask=clip)
    dk._write_row_k4(row, out, S, inp["spSym"], inp["codeOffset"], inp["code_val"], None)
    return dk.nrzs_rows_plain(row, consts.symbolLUT, S)


def check_nrzs_form(spec, consts, B):
    """K4's NRZ-S form (K4n in K4's launch) at the bench_BPSK shape against
    its plain version, on ``nrzs_form_inputs``: the rows equal; one K4
    launch and one of the NRZ-S form a call, nothing else. Returns (the
    plan, slots trust -1, slots trust -2)."""
    inp = nrzs_form_inputs(spec, consts, B)
    S, L = spec.numSymMax, packed_len(spec)
    before = ops.launch_counts()
    got = nrzs_form_call(spec, consts, inp, torch.zeros((B, L), device="cuda"))
    moved = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
    assert moved == {"symbol_detect": 1, "symbol_detect_nrzs": 1}, moved
    want = nrzs_form_plain(spec, consts, inp, torch.zeros((B, L), device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"K4 NRZ-S form B={B}: rows differ from the plain version"
    trust = got[:, S:2 * S]
    n1, n2 = int((trust == -1).sum()), int((trust == -2).sum())
    assert n2 > 0 and (B == 1 or n1 > 0), f"K4 NRZ-S form B={B}: trust -1 {n1}, -2 {n2}"
    return dk.k4_plan(B, S), n1, n2


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
    to the payload; K1-K5 must launch, K4 always in its NRZ-S form (K4n
    in the same launch, one a call)."""
    N, ov = spec.Nfft, spec.sigOverlap
    n = ov + N_HOPS * (N - ov)
    payload = packet_data(protocol.packetLen, protocol.randSeed)
    lead = np.random.RandomState(SEED).randint(0, 2, 256)
    reps = (n // int(spec.spsym) - len(lead)) // len(payload) + 1
    tx = np.r_[lead, np.tile(payload, reps)]
    stream = bpsk_stream(spec, tx, n)
    seqA, launches = drive(make, conf, protocol, stream, ov)
    check_launches("bpsk", launches)
    k4 = launches["symbol_detect"]
    assert launches["symbol_detect_nrzs"] == k4 == launches["timing_band"], \
        f"bpsk: K4 and K4n not one launch a call: {launches}"
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


def move_sockets(conf, port0):
    """``conf`` with its Rx radios on ports port0.. and its internal and
    external sockets on port0 + 10 to port0 + 14; nothing else changed."""
    for i, r in enumerate(conf["Radios"]["Rx"].values()):
        r["Interfaces"] = {"RxInPort": f"tcp://127.0.0.1:{port0 + i}",
                           "demodOut": f"tcp://localhost:{port0 + 10}"}
    conf["Interfaces"]["Internal"].update({
        "demodIn": f"tcp://*:{port0 + 10}", "demodOut": f"tcp://localhost:{port0 + 10}",
        "decodeOut": f"tcp://localhost:{port0 + 11}", "decodeIn": f"tcp://*:{port0 + 11}"})
    conf["Interfaces"]["External"].update({
        "decodeBytesOut_ZMQ": {"UHF": f"tcp://*:{port0 + 12}"},
        "XMLRpcIn": f"127.0.0.1:{port0 + 13}"})
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=port0 + 14)
    return conf


def runtime_conf(name, port0, group):
    """A shipped config with blockSize 16, no softCombiner, a 60 s feed
    timeout and its sockets moved (``move_sockets``)."""
    conf = load_modular_json(config_path("benchmark", name))
    conf["Main"].update(workerId="smoke", softCombiner_enabled=False,
                        channelGroup_enabled=group, statsFolder="build/runtime_stats")
    conf["GPU"]["UHF"]["blockSize"] = 16
    conf["Demodulator"] = {"timeoutSeconds": 60}
    return move_sockets(conf, port0)


def run_runtime(conf, port0, delays=None, seed=SEED, check=None):
    """``PyCuSDR`` from ``conf`` (sockets from ``port0`` on, as
    ``move_sockets`` puts them): waits (bounded) for every Rx child to be
    warm, the decoder to bind and the combiner, where there is one, to be
    ready; then PUBlishes one seeded bench_FSK packet with AWGN at 14 dB,
    independent per antenna and fed to antenna c after ``delays[c]``
    samples, in hops, until the decoded bytes arrive on the external PULL
    socket (bounded again). ``check(sdr)``, where given, runs once the
    payload is in, before the teardown. Returns a dict: payload ==
    expected, the Rx children's devices, their host ms per block where they
    keep it, seconds to warm and to the first packet, feeds, what ``check``
    returned, and the terminated ``PyCuSDR``."""
    import zmq

    from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

    n_rx = len(conf["Radios"]["Rx"])
    delays = delays or (0,) * n_rx
    bits = packet_data(conf["Main"]["PacketLen"], conf["Main"]["RandSeed"])
    sig, _ = get_padded_packet("FSK", 16, 9600 * 16, offset_freq=38400, raw_bits=bits, pad=6000)
    hop = 2 ** conf["GPU"]["UHF"]["blockSize"] - 2 ** conf["GPU"]["UHF"]["overlap"]
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
    t_boot = time.time()
    sdr = PyCuSDR(conf, args=None)
    group = conf["Main"].get("channelGroup_enabled", False)
    assert len(sdr.demodulators) == (1 if group else n_rx)
    sdr.start()
    try:
        deadline = time.time() + RUNTIME_WAIT_S
        flags = [d.warmedFlag for d in sdr.demodulators] + [sdr.dec.boundFlag] + (
            [] if sdr.combiner is None else [sdr.combiner.ready])
        while time.time() < deadline and not all(f.is_set() for f in flags):
            assert all(t.is_alive() for t in sdr.tasks), "a runtime child died while warming"
            time.sleep(0.2)
        assert all(f.is_set() for f in flags), "runtime children not warm"
        warm_s = time.time() - t_boot
        # connect once the decoder listens: a connect retried against a
        # port in the ephemeral range can connect the socket to itself
        sink.connect(f"tcp://localhost:{port0 + 12}")
        time.sleep(1.0)  # let the SUB sockets connect
        t0 = time.time()
        deadline = t0 + RUNTIME_WAIT_S
        rng = np.random.RandomState(seed)
        payload, feeds = None, 0
        while payload is None and time.time() < deadline:
            feeds += 1
            chans = [awgn(np.r_[np.zeros(d, np.complex64), stream], 14.0,
                          rng=rng).astype(np.complex64) for d in delays]
            for pos in range(0, len(stream) - hop + 1, hop):
                for sock, c in zip(pubs, chans):
                    sock.send(c[pos:pos + hop].tobytes())
                time.sleep(0.05)
            try:
                payload = sink.recv()
            except zmq.error.Again:
                continue
        first_s = time.time() - t0
        name = conf["Main"]["workerId"]
        assert payload is not None, f"{name}: no packet decoded within {RUNTIME_WAIT_S} s"
        expected = bytes(bytearray(sdr.protocols["UHF"].Packet(bits).getBinaryData()[0]))
        return dict(equal=payload == expected, devices=[d.device for d in sdr.demodulators],
                    host_ms=[1e3 * d.timeMA for d in sdr.demodulators if hasattr(d, "timeMA")],
                    warm_s=warm_s, first_s=first_s, feeds=feeds,
                    checked=None if check is None else check(sdr), sdr=sdr)
    finally:
        sdr.terminate()
        for sock in pubs + [sink]:
            sock.close()
        ctx.term()


def main_path_runtime():
    """The process pipeline from the shipped configs: bench_3_chan_rx.json
    as one lockstep channel group (three antennas, K8 in the child), then
    bench_FSK.json through one ``Demodulator_process``, then the station's
    CC11xx.json with its Tx radio (``run_cc11xx_runtime``); each must decode
    the payload, with its Rx children on the card."""
    out = {}
    for key, name, port0, group in (("group", "bench_3_chan_rx.json", RUNTIME_PORT, True),
                                    ("single", "bench_FSK.json", RUNTIME_PORT + 20, False),
                                    ("cc11xx", "CC11xx.json", CC11XX_RUNTIME_PORT, False)):
        t0 = time.time()
        if key == "cc11xx":
            equal, devices, host_ms, first_s = run_cc11xx_runtime(port0)
        else:
            r = run_runtime(runtime_conf(name, port0, group), port0)
            equal, devices, host_ms, first_s = r["equal"], r["devices"], r["host_ms"], r["first_s"]
        assert equal, f"runtime {key}: decoded bytes differ from the payload"
        assert devices and all(d == "cuda" for d in devices), f"runtime {key}: devices {devices}"
        out[key] = dict(config=name, devices=devices, host_ms_per_block=host_ms,
                        first_packet_s=first_s, seconds=time.time() - t0)
    return out


# -------------------------- slice 17: the CC11xx link, bench_GMSK, the Tx process

#: the CC11xx link (phase 4l): CC11XX_PACKETS seeded payloads of mixed lengths
#: up to the length byte's limit (253 bytes and the 2-byte CRC), each sent at
#: its own range rate by ``Modulator.set_rangerate``, on a slow ramp from
#: CC11XX_RR0 (a LEO pass moves tens of m/s between packets: 40 m/s is 54 Hz
#: at 402.538 MHz), with AWGN at CC11XX_SNR_DB per sample over the whole
#: received stream (unit-power FSK; Es/N0 is 21.07 dB higher at 128 samples a
#: symbol)
CC11XX_PACKETS, CC11XX_RR0, CC11XX_RR_STEP, CC11XX_SNR_DB = 10, -18000.0, 40.0, -3.0
#: hops of noise after the last packet: its FIXED window (267 bytes from the
#: preamble) reaches the decoder before the decoder emits it
CC11XX_TAIL_HOPS = 5
#: phase 4f's CC11xx station: its 23 sockets from this port on
CC11XX_RUNTIME_PORT = 17500
#: the stations whose K1-K5 shape phase 3 holds against the plain versions
STATION_CONFIGS = {"cc11xx": "CC11xx.json", "combiner": "bench_3_chan_rx.json"}
#: bench_GMSK (phase 4m) at the flagship's blockSize
GMSK_BLOCK_SIZE = 16


def cc11xx_configuration():
    """CC11xx.json as the station runs it: Nfft 2^16, overlap 2^10, 128
    samples a symbol (numSymMax 640), D=64 shifts about the IF bin 10240,
    8 masks and the centre-bit LUT, clipping off on the UHF section:
    (conf, protocol, spec, Demodulator class)."""
    conf = load_modular_json(config_path("CC11xx.json"))
    protocol = loadProtocol("CC11xx")(conf=conf)
    return conf, protocol, build_spec(conf, protocol, RADIO), UHF.Demodulator


def check_station_kernels(spec, consts, B, label):
    """K1-K5 at a station's shape (``label``: cc11xx, combiner) against their plain versions on B seeded
    blocks: ``check_kernels`` (K1 within 1e-4 of max|E| with and without a
    recentre, K5 to ``k5_contract``, K2 and K3 as ``check_bank_band``, K4
    every output equal), and each block alone equal to its row of the
    batch: K1 (``check_k1``, with and without a recentre), K2 and K3 (the
    last block), K4 and K5 (every block). Returns (name -> max abs err, K1's
    window and global-read groups, K1's max err / max|E|)."""
    inp = kernel_inputs(spec, consts, B)
    errs = check_kernels(spec, consts, B, inp)
    rel = max(check_k1(inp["P"], consts.Q, consts.shifts, cs, f"{label} B={B} centre={cs is not None}")
              for cs in (None, recentres(spec.Nfft, B)))
    kw = k4_kwargs(spec, consts)
    a4 = (inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"])
    got4 = dk.symbol_detect(*a4, consts.bitLUT, **kw)
    args5, kw5 = k5_args(spec, consts, inp["E"], inp["P"])
    got5 = ds.doppler_estimate(*args5, **kw5)
    for b in range(B):
        one4 = dk.symbol_detect(*(t[b:b + 1].contiguous() for t in a4), consts.bitLUT, **kw)
        a5, k5 = k5_args(spec, consts, inp["E"][b:b + 1].contiguous(),
                         inp["P"][b:b + 1].contiguous())
        one5 = ds.doppler_estimate(*a5, **k5)
        torch.cuda.synchronize()
        assert all(torch.equal(u[0], v[b]) for u, v in zip(one4, got4)), \
            f"K4 {label}: block {b} alone != its row of the batch"
        assert all(torch.equal(u[0].nan_to_num(), v[b].nan_to_num()) for u, v in zip(one5, got5)), \
            f"K5 {label}: block {b} alone != its row of the batch"
    sh = consts.shifts.cpu().numpy()
    plan = ds.doppler_energy_plan(sh, spec.Nfft, spec.num_masks)
    nwin = plan.window_groups(sh)
    return errs, (nwin, -(-plan.T // ds.K1_GROUP_TILES) - nwin), rel


def cc11xx_stream(conf, protocol, spec):
    """Phase 4l's received stream: CC11XX_PACKETS seeded payloads (one of
    253 bytes, one of 1, the rest between) through the port's ``Modulator``
    for the Tx radio of CC11xx.json, packet k at range rate CC11XX_RR0 + k
    CC11XX_RR_STEP (the Tx pre-compensates the IF offset itself), back to
    back, CC11XX_TAIL_HOPS hops of silence after them, AWGN at
    CC11XX_SNR_DB over all of it. Returns (stream with the overlap-save
    history first, hops K, payloads, on-air bits, each packet's Doppler Hz
    and its samples (start, end) in the stream)."""
    radio = conf["Radios"]["Tx"]["UHF"]
    mod = Modulator(conf, radio, protocol)
    rng = np.random.RandomState(SEED + 17)
    lengths = rng.permutation([253, 1] + list(rng.randint(2, 253, CC11XX_PACKETS - 2)))
    payloads = [rng.randint(0, 256, n).astype(np.uint8) for n in lengths]
    ov, hop = spec.sigOverlap, spec.Nfft - spec.sigOverlap
    waves, onair, dopplers, spans, pos = [], [], [], [], ov
    for k, p in enumerate(payloads):
        mod.set_rangerate(CC11XX_RR0 + k * CC11XX_RR_STEP)
        w, bits = mod.encodeAndModulate(p), mod.encodeAndFrame(p)
        core = len(bits) * int(radio["samplesPerSym"])  # the modulated frame, between pads
        spans.append((pos + len(w) - 4096 - core, pos + len(w) - 4096))
        waves.append(w)
        onair.append(bits)
        dopplers.append(mod.getDoppler() / (2 * np.pi))
        pos += len(w)
    wave = np.concatenate(waves)
    K = -(-len(wave) // hop) + CC11XX_TAIL_HOPS
    clean = np.zeros(ov + K * hop, np.complex64)
    clean[ov:ov + len(wave)] = wave
    stream = awgn(clean, CC11XX_SNR_DB, measured=False,
                  rng=np.random.RandomState(SEED + 18)).astype(np.complex64)
    return stream, K, payloads, onair, dopplers, spans


def main_path_cc11xx():
    """The station's CC11xx link at the operational shape (``cc11xx_stream``)
    through ``models.uhf.Demodulator`` four ways: ``process`` per hop,
    ``processMany(16)``, ``processCapture`` and the plain path on the card;
    decisions and trust equal on every block; the raw BER below 1e-3; the
    Doppler within half a baud of the one sent in every block that lies
    wholly inside a packet; ``decode.Decoder`` returns every payload byte
    for byte with its CRC passing, from the ``process`` and the
    ``processMany`` bits alike. The counts are set to 0 before ``process``,
    read after it (K1-K5 once a block, K6 never) and after
    ``processCapture``."""
    conf, protocol, spec, make = cc11xx_configuration()
    stream, K, payloads, onair, dopplers, spans = cc11xx_stream(conf, protocol, spec)
    N, ov = spec.Nfft, spec.sigOverlap
    hop = N - ov
    hops = stream[ov:].reshape(K, hop)
    dA, dB, dD = (make(conf, protocol, RADIO) for _ in range(3))
    dC = plain_demodulator(make, conf, protocol)
    for d in (dA, dB, dC, dD):
        d.get_signalBufferHostPointer()[:ov] = stream[:ov]

    ops.reset_launches()
    raw = dA.get_signalBufferHostPointer()
    seqA = []
    for i in range(K):
        raw[ov:] = hops[i]
        seqA.append(dA.process(raw))
        raw[:ov] = raw[-ov:]
    torch.cuda.synchronize()
    per_hop = ops.launch_counts()
    seqB = [r for i in range(0, K, LINE_BATCH) for r in dB.processMany(hops[i:i + LINE_BATCH])]
    seqD = dD.processCapture(stream[ov:])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    seqC = [r for i in range(0, K, LINE_BATCH) for r in dC.processMany(hops[i:i + LINE_BATCH])]
    check_launches("cc11xx", launches)
    once = {k: per_hop[k] for k in PATH_KERNELS["cc11xx"]}
    assert once == dict.fromkeys(once, K), f"cc11xx: {K} process calls launched {once}"
    assert len(seqB) == len(seqC) == len(seqD) == K
    for i, (a, b, c, d) in enumerate(zip(seqA, seqB, seqC, seqD)):
        for k in ("bits", "trust"):
            assert np.array_equal(a[k], b[k]), f"cc11xx: process != processMany at block {i} ({k})"
            assert np.array_equal(a[k], c[k]), f"cc11xx: kernels != plain path at block {i} ({k})"
            assert np.array_equal(a[k], d[k]), \
                f"cc11xx: process != processCapture at block {i} ({k})"

    inside = {}  # block -> the Doppler of the packet that holds all its samples
    for dop, (s0, s1) in zip(dopplers, spans):
        for i in range(K):
            if s0 <= i * hop and i * hop + N <= s1:
                inside[i] = dop
    assert inside, "cc11xx: no block lies wholly inside a packet"
    dop_err = max(abs(seqA[i]["doppler"] - dop) for i, dop in inside.items())
    assert dop_err < spec.baudRate / 2, f"cc11xx: Doppler off by {dop_err} Hz"
    rx = np.concatenate([a["bits"] for a in seqA]).astype(np.int64)
    ber = raw_ber(rx, onair)
    assert ber < 1e-3, f"cc11xx: raw BER {ber} at {CC11XX_SNR_DB} dB"
    sent = {bytes(p) for p in payloads}
    found = {}
    for how, seq in (("process", seqA), ("processMany", seqB)):
        dec = Decoder(conf, protocol)
        pkts = [p.getBinaryData() for a in seq for p in dec.findFrames(a["bits"], 0)[0]]
        good = [bytes(np.asarray(d, np.uint8)) for d, crc_error, _ in pkts if not crc_error]
        missing = [len(p) for p in payloads if bytes(p) not in good]
        assert not missing, f"cc11xx {how}: payloads of {missing} bytes not recovered CRC-clean"
        assert all(g in sent for g in good), f"cc11xx {how}: a CRC-clean packet never sent"
        found[how] = dict(packets=len(pkts), crc_clean=len(good))
    return dict(packets=CC11XX_PACKETS, lengths=[len(p) for p in payloads], blocks=K,
                snr_db_per_sample=CC11XX_SNR_DB, raw_ber=ber, bits=len(rx),
                range_rates=[CC11XX_RR0, CC11XX_RR0 + (CC11XX_PACKETS - 1) * CC11XX_RR_STEP],
                blocks_inside_packets=len(inside), max_doppler_err_hz=dop_err, decoded=found,
                launches=launches, launches_by_process=once,
                snr=[round(seqA[i]["SNR"], 2) for i in sorted(inside)[:3]])


def gmsk_configuration():
    """bench_GMSK.json at blockSize GMSK_BLOCK_SIZE (the flagship's Nfft
    2^16, D=64, 8 GMSK masks): (conf, protocol, spec, Demodulator class)."""
    conf = load_modular_json(config_path("benchmark", "bench_GMSK.json"))
    conf["GPU"]["UHF"]["blockSize"] = GMSK_BLOCK_SIZE
    protocol = loadProtocol("bench_GMSK")(conf=conf)
    return conf, protocol, build_spec(conf, protocol, RADIO), UHF.Demodulator


def main_path_gmsk():
    """bench_GMSK through ``processMany(16)``: 256 random bits, then seeded
    10000-bit packets back to back, GMSK at the IF offset plus DOPPLER_HZ
    with AWGN of NOISE_STD; bits and trust equal to the plain path's, BER
    < 1e-3, every whole packet the port's ``Decoder`` finds equal to the
    payload; K1-K5 must launch, K6 not."""
    conf, protocol, spec, make = gmsk_configuration()
    N, ov = spec.Nfft, spec.sigOverlap
    n, sps = ov + N_HOPS * (N - ov), int(spec.spsym)
    payload = packet_data(protocol.packetLen, protocol.randSeed)
    rng = np.random.RandomState(SEED + 19)
    lead = rng.randint(0, 2, 256)
    reps = (n // sps - len(lead)) // len(payload) + 1
    tx = np.r_[lead, np.tile(payload, reps)]
    sig = modulate_gmsk(tx, sps)[:n] * np.exp(
        2j * np.pi * (spec.centreFreqOffset + DOPPLER_HZ) / spec.sampleRate * np.arange(n))
    stream = (sig + NOISE_STD / np.sqrt(2) * (rng.randn(n) + 1j * rng.randn(n))).astype(
        np.complex64)
    hops = stream[ov:].reshape(N_HOPS, N - ov)
    d = make(conf, protocol, RADIO)
    dp = plain_demodulator(make, conf, protocol)
    for x in (d, dp):
        x.get_signalBufferHostPointer()[:ov] = stream[:ov]
    ops.reset_launches()
    seq = d.processMany(hops)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("gmsk", launches)
    ref = dp.processMany(hops)
    for i, (a, b) in enumerate(zip(seq, ref)):
        for k in ("bits", "trust"):
            assert np.array_equal(a[k], b[k]), f"gmsk: kernels != plain at block {i} ({k})"
        assert abs(a["doppler"] - DOPPLER_HZ) < spec.baudRate / 2, \
            f"gmsk block {i}: Doppler {a['doppler']} Hz, injected {DOPPLER_HZ}"
    rx = np.concatenate([a["bits"] for a in seq]).astype(np.int64)
    ber, lag = best_aligned_ber(rx, tx)
    assert ber < 1e-3, f"gmsk BER {ber} at lag {lag}"
    dec = Decoder(conf, protocol)
    pkts = [p for a in seq for p in dec.findFrames(a["bits"], 0)[0]]
    whole = [p for p in pkts if len(p.bits) >= protocol.packetLen]
    bad = [p.checkPacketData() for p in whole if p.checkPacketData() != 0]
    assert len(whole) >= reps - 2 and not bad, \
        f"gmsk: {len(whole)} whole packets of {reps}, bit errors {bad}"
    assert all(np.array_equal(p.getBinaryData()[0][:len(payload)], payload) for p in whole)
    return dict(ber=ber, lag=lag, bits=len(rx), packets=len(whole), launches=launches,
                doppler=[round(a["doppler"], 3) for a in seq[:3]])


def cc11xx_runtime_conf(port0):
    """CC11xx.json as shipped but for its sockets, all from ``port0`` on
    (``move_sockets``, the RPC among them, off 8051; the Tx radio's from
    port0 + 20), the stats folder and a 60 s feed timeout."""
    conf = move_sockets(load_modular_json(config_path("CC11xx.json")), port0)
    conf["Main"].update(workerId="smoke", statsFolder="build/runtime_stats")
    conf["Radios"]["Tx"]["UHF"]["Interfaces"] = {
        "TxModToUSRPPort": f"tcp://127.0.0.1:{port0 + 20}",
        "TxDataIn": f"tcp://127.0.0.1:{port0 + 21}",
        "TxManualIn": f"tcp://127.0.0.1:{port0 + 22}"}
    conf["Demodulator"] = {"timeoutSeconds": 60}
    conf["Interfaces"]["External"]["TxManualIn"] = f"tcp://127.0.0.1:{port0 + 22}"
    return conf


def wait_station(sdr, what):
    """Waits (bounded) until the CC11xx station's Rx child is warm and its
    decoder and ``Modulator_process`` are bound; a child that dies first
    fails."""
    deadline = time.time() + RUNTIME_WAIT_S
    flags = [sdr.demodulators[0].warmedFlag, sdr.dec.boundFlag, sdr.modulators[0].boundFlag]
    while time.time() < deadline and not all(f.is_set() for f in flags):
        assert all(t.is_alive() for t in sdr.tasks), f"{what}: a child died while warming"
        time.sleep(0.2)
    assert all(f.is_set() for f in flags), f"{what}: the children are not warm"


def tx_to_rx(tx_in, wave_out, rx_in, sink, payload, rng):
    """The CC11xx station's loop back: pushes ``payload`` into TxDataIn,
    PULLs the waveform from TxModToUSRPPort, adds CC11XX_TAIL_HOPS hops of
    silence and AWGN at CC11XX_SNR_DB, PUBlishes it in half hops to
    RxInPort, and again, until bytes arrive on decodeBytesOut_ZMQ or
    RUNTIME_WAIT_S pass. Returns (the bytes or None, seconds)."""
    import zmq

    hop = 2 ** 16 - 2 ** 10
    t0 = time.time()
    while time.time() < t0 + RUNTIME_WAIT_S:
        tx_in.send(payload.tobytes())
        try:
            wave = np.frombuffer(wave_out.recv(), np.complex64)
        except zmq.error.Again:
            continue
        chan = awgn(np.r_[wave, np.zeros(CC11XX_TAIL_HOPS * hop, np.complex64)],
                    CC11XX_SNR_DB, measured=False, rng=rng).astype(np.complex64)
        for pos in range(0, len(chan), hop // 2):
            rx_in.send(chan[pos:pos + hop // 2].tobytes())
            time.sleep(0.02)
        try:
            return sink.recv(), time.time() - t0
        except zmq.error.Again:
            continue
    return None, time.time() - t0


def run_cc11xx_runtime(port0):
    """``PyCuSDR`` from CC11xx.json (``cc11xx_runtime_conf``): once the
    station is up (``wait_station``), a seeded 200-byte payload goes
    through the Tx and back into the Rx (``tx_to_rx``). The modulator
    child is host numpy and touches no device. Returns (bytes ==
    payload, the Rx child's device, its host ms per block, seconds to the
    first packet)."""
    import zmq

    from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

    conf = cc11xx_runtime_conf(port0)
    payload = np.random.RandomState(SEED + 20).randint(0, 256, 200).astype(np.uint8)
    ctx = zmq.Context()
    socks = []

    def sock(kind, addr, bind=False, timeout_ms=None):
        s = ctx.socket(kind)
        s.setsockopt(zmq.LINGER, 0)
        if timeout_ms is not None:
            s.setsockopt(zmq.RCVTIMEO, timeout_ms)
        (s.bind if bind else s.connect)(addr)
        socks.append(s)
        return s

    rx_in = sock(zmq.PUB, f"tcp://127.0.0.1:{port0}", bind=True)
    sdr = PyCuSDR(conf, args=None)
    assert len(sdr.modulators) == 1 and len(sdr.demodulators) == 1
    sdr.start()
    try:
        wait_station(sdr, "CC11xx.json")
        tx_in = sock(zmq.PUSH, f"tcp://127.0.0.1:{port0 + 21}")
        wave_out = sock(zmq.PULL, f"tcp://127.0.0.1:{port0 + 20}", timeout_ms=5000)
        sink = sock(zmq.PULL, f"tcp://localhost:{port0 + 12}", timeout_ms=2000)
        time.sleep(1.0)  # let the SUB and PULL sockets connect
        got, first_s = tx_to_rx(tx_in, wave_out, rx_in, sink, payload,
                                np.random.RandomState(SEED + 21))
        assert got is not None, f"CC11xx.json: no packet decoded within {RUNTIME_WAIT_S} s"
        assert sdr.modulators[0].is_alive(), "the modulator child died"
        d = sdr.demodulators[0]
        return got == payload.tobytes(), [d.device], [1e3 * d.timeMA], first_s
    finally:
        sdr.terminate()
        for s in socks:
            s.close()
        ctx.term()


# --------------- slice 18: the three-station Rx through the softCombiner, hamlib

#: phase 4n: bench_3_chan_rx.json's sockets from this port on (15 of them),
#: and each channel's delay (samples) of the one packet fed to it
COMBINER_PORT = 17540
COMBINER_DELAYS = (0, 1117, 2403)
#: phase 4n's diversity check: DIVERSITY_HOPS hops of seeded FSK at the IF
#: offset plus DOPPLER_HZ, received three times with independent AWGN at
#: DIVERSITY_SNR_DB a sample (unit-power FSK; Es/N0 is 12.04 dB higher at 16
#: samples a symbol), where each channel alone has a raw BER of 1e-3 to 3e-2
DIVERSITY_HOPS, DIVERSITY_SNR_DB = 40, -4.5
#: the BER of a stream is counted in segments of this many bits, each at its
#: own best lag, so one bit slip costs at most one segment
BER_SEGMENT = 2048
#: phase 4o: the hamlib daemon's listener (hamlib_sockets.json's 4532 moved
#: here), the booted CC11xx modem's sockets from the next port on (as in phase
#: 4f), and the range rate (m/s) the client's ``I`` steers the Tx to
HAMLIB_PORT = 17560
HAMLIB_RANGERATE = 12000.0


def three_station_configuration():
    """bench_3_chan_rx.json as shipped: bench_FSK at blockSize 15 (Nfft
    2^15, overlap 2^10, 16 samples a symbol), D=64, 8 masks, three Rx
    radios: (conf, protocol, spec of its first radio, Demodulator class)."""
    conf = load_modular_json(config_path("benchmark", "bench_3_chan_rx.json"))
    protocol = loadProtocol("bench_FSK")(conf=conf)
    return conf, protocol, build_spec(conf, protocol, RADIO), UHF.Demodulator


def child_launches(children, path):
    """The Rx children's kernel launches since they were warm, summed, after
    each child launched every kernel of ``path`` and no other."""
    per_child = [d.launches for d in children]
    for i, launches in enumerate(per_child):
        check_launches(path, launches)
        assert launches["threshold_input"] == 0, f"{path}: child {i} launched K6"
    total = {k: sum(c[k] for c in per_child) for k in per_child[0]}
    return total, [d.blocks for d in children], per_child


def run_three_station(port0):
    """Phase 4n's process run: ``run_runtime`` on bench_3_chan_rx.json as
    shipped with its sockets moved to port0..port0 + 14 (three
    ``Demodulator_process`` children on the card, the ``SoftCombiner``
    child, the decoder), channel c fed after COMBINER_DELAYS[c] samples.
    XML-RPC ``get_active_workers`` must name the three channels, each child
    must launch K1-K5, every child must be gone after the teardown, and a
    container must reach the decoder voted by three (``numSlaves`` 2, read
    from the decoder's stats). Returns a dict."""
    import xmlrpc.client

    conf = move_sockets(three_station_configuration()[0], port0)

    def check(sdr):
        assert type(sdr.combiner).__name__ == "SoftCombiner" and sdr.combiner in sdr.tasks
        assert sdr.rpcInt.softCombiner is sdr.combiner
        proxy = xmlrpc.client.ServerProxy(f"http://127.0.0.1:{port0 + 13}/RPC2")
        names = sorted(proxy.get_active_workers(2.0))
        want = sorted(d.workerId for d in sdr.demodulators)
        assert names == want, f"three-station: get_active_workers {names}, want {want}"
        launches, blocks, per_child = child_launches(sdr.demodulators, "combiner")
        return dict(workers=names, launches=launches, blocks=blocks, launches_by_child=per_child)

    r = run_runtime(conf, port0, COMBINER_DELAYS, SEED + 40, check)
    sdr = r["sdr"]
    assert r["equal"], "three-station: decoded bytes differ from the payload"
    assert r["devices"] == ["cuda"] * 3, f"three-station: children on {r['devices']}"
    assert not any(t.is_alive() for t in sdr.tasks), "three-station: a child outlived terminate()"
    slaves = [int(n) for w in sdr.passStats for n in w["numSlaves"]]
    assert 2 in slaves, f"three-station: no container voted by three: {sorted(set(slaves))}"
    return dict(config="bench_3_chan_rx.json", devices=r["devices"], warm_s=r["warm_s"],
                first_packet_s=r["first_s"], feeds=r["feeds"], host_ms_per_block=r["host_ms"],
                containers=len(slaves), voted_by_three=slaves.count(2),
                voted_by_two=slaves.count(1), **r["checked"])


class _Feed:
    """The combiner's ``demodIn`` and ``decodeOut`` in one process: queued
    dicts out of ``recv_pyobj``, every sent dict kept."""

    def __init__(self):
        self.queue, self.sent = [], []

    def recv_pyobj(self, flags=0):
        return self.queue.pop(0)

    def send_pyobj(self, data, flags=0):
        self.sent.append(data)


def segment_ber(rx, tx, seg=BER_SEGMENT):
    """BER of ``rx`` against ``tx``, each segment of ``seg`` bits at its own
    best lag (FFT cross-correlation of +-1 bits)."""
    rx, tx = np.asarray(rx, np.int64), np.asarray(tx, np.int64)
    L = 1 << int(np.ceil(np.log2(len(tx) + seg)))
    TX = np.fft.rfft(tx * 2.0 - 1.0, L)
    errs = n = 0
    for a in range(0, len(rx) - seg // 4, seg):
        s = rx[a:a + seg]
        corr = np.fft.irfft(TX * np.conj(np.fft.rfft(s * 2.0 - 1.0, L)), L)
        lag = int(np.argmax(corr[:len(tx) - len(s) + 1]))
        errs += int(np.sum(tx[lag:lag + len(s)] != s))
        n += len(s)
    return errs / n


def diversity_check():
    """Phase 4n's diversity check: DIVERSITY_HOPS hops of seeded FSK,
    received three times with independent AWGN at DIVERSITY_SNR_DB, each
    demodulated by the port's ``Demodulator`` on the card (``processMany``,
    bench_3_chan_rx.json's spec), then voted block by block by the port's
    ``SoftCombiner.compareWorkers`` in this process (not started; its
    ``decodeOut`` records), each round timed on the host. The first
    channel's hops also go through the plain path on the card: decisions
    and trust equal on every block. Every channel's raw BER must lie in
    [1e-3, 3e-2] and every master's voted BER at or below the best
    channel's."""
    from pycusdr_tpu_torch.combine import SoftCombiner

    conf, protocol, spec, make = three_station_configuration()
    radios = list(conf["Radios"]["Rx"])
    assert radios[0] == RADIO
    ov, hop, sps = spec.sigOverlap, spec.Nfft - spec.sigOverlap, int(spec.spsym)
    n = ov + DIVERSITY_HOPS * hop
    rng = np.random.RandomState(SEED + 30)
    tx = rng.randint(0, 2, n // sps + 8)
    f = (spec.centreFreqOffset + DOPPLER_HZ) / spec.sampleRate
    clean = modulate_fsk(tx, sps)[:n] * np.exp(2j * np.pi * f * np.arange(n))
    seqs = []
    for c, radio in enumerate(radios):
        x = awgn(clean, DIVERSITY_SNR_DB, measured=False,
                 rng=np.random.RandomState(SEED + 31 + c)).astype(np.complex64)
        hops = x[ov:].reshape(DIVERSITY_HOPS, hop)

        def demodulate(d):
            d.get_signalBufferHostPointer()[:ov] = x[:ov]
            return [r for i in range(0, DIVERSITY_HOPS, LINE_BATCH)
                    for r in d.processMany(hops[i:i + LINE_BATCH])]

        seqs.append(demodulate(make(conf, protocol, radio)))
        if c == 0:
            ref = demodulate(plain_demodulator(make, conf, protocol))
            assert len(ref) == len(seqs[0]) == DIVERSITY_HOPS
            for i, (a, b) in enumerate(zip(seqs[0], ref)):
                for k in ("bits", "trust"):
                    assert np.array_equal(a[k], b[k]), \
                        f"diversity: kernels != plain path at block {i} ({k})"
    channel_ber = [segment_ber(np.concatenate([r["bits"] for r in s]), tx) for s in seqs]
    assert all(1e-3 <= b <= 3e-2 for b in channel_ber), \
        f"diversity: channel BERs {channel_ber} outside [1e-3, 3e-2] at {DIVERSITY_SNR_DB} dB"

    comb = SoftCombiner(conf)
    feed = _Feed()
    comb.decodeOut, comb.workers, comb.workersSubmitted = feed, [], []
    ids = [f"div-{conf['Radios']['Rx'][r]['name']}" for r in radios]
    round_ms, buffered = [], []
    for i in range(DIVERSITY_HOPS):
        for c, s in enumerate(seqs):
            r = s[i]
            feed.queue.append({
                "workerId": ids[c], "count": i, "timestamp": time.time(), "voteGroup": 0,
                "doppler": r["doppler"], "doppler_std": r["doppler_std"],
                "spSymEst": r["spSymEst"], "SNR": r["SNR"], "baudRate": spec.baudRate,
                "protocol": "UHF", "data": r["bits"], "trust": r["trust"]})
            comb.receiveData(feed)
        t0 = time.perf_counter()
        comb.compareWorkers()
        round_ms.append(1e3 * (time.perf_counter() - t0))
        buffered.append(max(len(w.data["data"]) for w in comb.workers))
    voted = {w: np.concatenate([np.asarray(d["data"]) for d in feed.sent if d["workerId"] == w])
             for w in ids}
    voted_ber = [segment_ber(voted[w], tx) for w in ids]
    slaves = [d["numSlaves"] for d in feed.sent]
    assert max(voted_ber) <= min(channel_ber), \
        f"diversity: voted BERs {voted_ber} above the best channel's {min(channel_ber)}"
    bits_in = [sum(len(r["bits"]) for r in s) for s in seqs]
    return dict(snr_db_per_sample=DIVERSITY_SNR_DB, blocks=DIVERSITY_HOPS,
                plain_channel=radios[0], channel_ber=channel_ber, voted_ber=voted_ber, bits_in=bits_in,
                bits_voted=[len(voted[w]) for w in ids], containers=len(slaves),
                voted_by_three=slaves.count(2), round_ms=round_ms, buffered_bits=buffered,
                round_ms_median=statistics.median(round_ms), round_ms_max=max(round_ms),
                block_ms=1e3 * hop / spec.sampleRate)


def _rig_cmd(f, cmd: bytes, n_bytes=None) -> bytes:
    f.write(cmd + b"\n")
    f.flush()
    return f.read(n_bytes) if n_bytes else f.readline().rstrip(b"\n")


def run_hamlib(port0):
    """Phase 4o: the daemon as ``hamlib_daemon.main`` runs it, from
    hamlib_sockets.json as shipped with its listener moved to ``port0`` and
    its entry pointed at CC11xx.json with the sockets moved from port0 + 1
    on (``cc11xx_runtime_conf``), both written under build/; the daemon's
    own modem factory boots the modem (Tx and Rx) from that file when a TCP
    client connects. The client checks the wire and steers the Tx with
    ``I``; a 200-byte payload pushed into TxDataIn after the steer comes
    out of the Rx equal to itself, its Doppler estimate (the decoder's
    stats, the block of highest SNR) within half a baud of the shift the
    steer implies; then the client leaves, every child of that modem must
    exit within ``JOIN_TIMEOUT``, and a second connection must boot a
    second modem that answers. Returns a dict."""
    import argparse
    import os
    import threading

    import zmq

    from pycusdr_tpu_torch.control import hamlib_daemon
    from pycusdr_tpu_torch.control.rig_server import DUMP_STATE
    from pycusdr_tpu_torch.runtime.orchestrator import JOIN_TIMEOUT, STOP_TIMEOUT
    from pycusdr_tpu_torch.utils.doppler import freq_from_rangerate, rangerate_from_freq

    home = Path(__file__).resolve().parent / "build" / "smoke_hamlib"
    home.mkdir(parents=True, exist_ok=True)
    sockets = load_modular_json(config_path("hamlib_sockets.json"))
    sockets["CC11xx"]["port"] = port0
    (home / sockets["CC11xx"]["config"]).write_text(json.dumps(cc11xx_runtime_conf(port0 + 1)))
    sockets_file = home / "hamlib_sockets.json"
    sockets_file.write_text(json.dumps(sockets))
    booted = []

    def rig_factory(sock, client, sdr):
        """The daemon's own rig factory; keeps the modem it steers."""
        booted.append(sdr)
        return hamlib_daemon._default_rig_factory(sock, client, sdr)

    def wait_gone(sdr, t_left):
        """Seconds from the client's leaving until every child exited, and
        until the daemon finished the teardown."""
        limit = STOP_TIMEOUT + 2 * JOIN_TIMEOUT + 10
        while time.time() < t_left + limit and any(t.is_alive() for t in sdr.tasks):
            time.sleep(0.05)
        children_s = time.time() - t_left
        assert children_s <= JOIN_TIMEOUT, \
            f"hamlib: the modem's children exited {children_s:.1f} s after the client left"
        while time.time() < t_left + limit and sdr.rpcInt.is_alive():
            time.sleep(0.05)
        assert not sdr.rpcInt.is_alive(), "hamlib: the teardown did not finish"
        return children_s

    # as main() reads its -c file and the arguments
    args = argparse.Namespace(configFile=str(sockets_file), radio=None, v=0)
    stop, ready = threading.Event(), {}
    threads = hamlib_daemon.serve_all(
        load_modular_json(args.configFile), os.path.dirname(os.path.abspath(args.configFile)),
        args, rig_factory=rig_factory, stop=stop, ready_events=ready)
    ctx = zmq.Context()
    socks = []

    def zsock(kind, addr, bind=False, timeout_ms=None):
        s = ctx.socket(kind)
        s.setsockopt(zmq.LINGER, 0)
        if timeout_ms is not None:
            s.setsockopt(zmq.RCVTIMEO, timeout_ms)
        (s.bind if bind else s.connect)(addr)
        socks.append(s)
        return s

    try:
        assert ready["CC11xx"].wait(10), "hamlib: the listener did not come up"
        rx_in = zsock(zmq.PUB, f"tcp://127.0.0.1:{port0 + 1}", bind=True)
        t_boot = time.time()
        client = socket.create_connection(("localhost", port0), timeout=RUNTIME_WAIT_S)
        f = client.makefile("rwb")
        assert _rig_cmd(f, b"\\chk_vfo") == b"CHKVFO 0"
        boot_s = time.time() - t_boot
        dump = (DUMP_STATE + "\n").encode()
        assert _rig_cmd(f, b"\\dump_state", len(dump)) == dump, "hamlib: dump_state differs"
        assert len(booted) == 1
        sdr = booted[0]
        assert sdr.configFile["Interfaces"]["External"]["XMLRpcIn"] == f"127.0.0.1:{port0 + 14}", \
            "hamlib: the modem did not boot from the written config"
        wait_station(sdr, "hamlib")
        assert sdr.demodulators[0].device == "cuda", "hamlib: the Rx child is not on the card"
        warm_s = time.time() - t_boot
        mod = sdr.modulators[0]
        fc_hl = sdr.configFile["Radios"]["Tx"]["UHF"].get(
            "frequency_hamlib_Hz", sdr.configFile["Radios"]["Tx"]["UHF"]["frequency_Hz"])
        freq = round(freq_from_rangerate(HAMLIB_RANGERATE, fc_hl), 1)
        assert _rig_cmd(f, b"I %.1f" % freq) == b"RPRT 0"
        read_back = float(_rig_cmd(f, b"i"))
        assert abs(read_back - freq) < 1.0, f"hamlib: i read {read_back} after I {freq}"
        rr_want = rangerate_from_freq(freq, fc_hl)
        rr_err = abs(mod.rangerate - rr_want) / abs(rr_want)
        assert rr_err <= 1e-6, f"hamlib: the modulator's rangerate {mod.rangerate}, want {rr_want}"
        # the shift the steer implies on the waveform: the port's Modulator
        # for the same Tx radio at the steered rangerate
        conf = sdr.configFile
        tx_mod = Modulator(conf, conf["Radios"]["Tx"]["UHF"], sdr.protocols["UHF"])
        tx_mod.set_rangerate(mod.rangerate)
        shift_hz = tx_mod.getDoppler() / (2 * np.pi)
        time.sleep(0.5)  # the child applies the rangerate at its next poll (100 ms)

        payload = np.random.RandomState(SEED + 41).randint(0, 256, 200).astype(np.uint8)
        tx_in = zsock(zmq.PUSH, f"tcp://127.0.0.1:{port0 + 22}")
        wave_out = zsock(zmq.PULL, f"tcp://127.0.0.1:{port0 + 21}", timeout_ms=5000)
        sink = zsock(zmq.PULL, f"tcp://localhost:{port0 + 13}", timeout_ms=2000)
        time.sleep(1.0)  # let the SUB and PULL sockets connect
        got, first_s = tx_to_rx(tx_in, wave_out, rx_in, sink, payload,
                                np.random.RandomState(SEED + 42))
        assert got == payload.tobytes(), "hamlib: the Rx did not return the payload"
        d = sdr.demodulators[0]
        launches, blocks, _ = child_launches([d], "hamlib")
        host_ms = 1e3 * d.timeMA

        f.close()
        client.close()
        t_left = time.time()
        children_s = wait_gone(sdr, t_left)
        stats = [w for w in sdr.passStats if len(w["SNR"])]
        assert stats, "hamlib: the decoder kept no stats"
        snr = np.asarray(stats[0]["SNR"], float)
        best = int(np.argmax(np.where(np.isfinite(snr), snr, -np.inf)))
        doppler = float(stats[0]["doppler"][best])
        dop_err = abs(doppler - shift_hz)
        half_baud = conf["Radios"]["Rx"]["UHF-H"]["baud"] / 2
        assert dop_err < half_baud, \
            f"hamlib: Doppler {doppler} Hz, {dop_err} Hz from the steer's {shift_hz} Hz"

        # a second client: a second modem boots on the same listener
        t_boot2 = time.time()
        client = socket.create_connection(("localhost", port0), timeout=RUNTIME_WAIT_S)
        f = client.makefile("rwb")
        assert _rig_cmd(f, b"\\chk_vfo") == b"CHKVFO 0"
        assert len(booted) == 2 and booted[1] is not sdr
        wait_station(booted[1], "hamlib, second modem")
        warm2_s = time.time() - t_boot2
        f.close()
        client.close()
        children2_s = wait_gone(booted[1], time.time())
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=STOP_TIMEOUT + 2 * JOIN_TIMEOUT + 10)
        for s in socks:
            s.close()
        ctx.term()
        for b in booted:
            if any(t.is_alive() for t in b.tasks):
                b.terminate()
    assert not any(t.is_alive() for t in threads), "hamlib: the daemon's listener did not stop"
    return dict(config=f"{sockets_file.name} -> {sockets['CC11xx']['config']} (default modem "
                       f"factory)", boot_s=boot_s, warm_s=warm_s,
                steer_hz=freq, read_back_hz=read_back, rangerate=mod.rangerate,
                rangerate_rel_err=rr_err, shift_hz=shift_hz, doppler_hz=doppler,
                doppler_err_hz=dop_err, snr_db=float(snr[best]), first_packet_s=first_s,
                launches=launches, blocks=blocks, host_ms_per_block=host_ms,
                children_exit_s=children_s, second_warm_s=warm2_s,
                second_children_exit_s=children2_s)


def main_path_slice18():
    """Phases 4n (``run_three_station``, then ``diversity_check``) and 4o
    (``run_hamlib``), each timed."""
    out = {}
    t0 = time.time()
    out["combiner"] = run_three_station(COMBINER_PORT)
    out["combiner"]["seconds"] = time.time() - t0
    t0 = time.time()
    out["diversity"] = diversity_check()
    out["diversity"]["seconds"] = time.time() - t0
    t0 = time.time()
    out["hamlib"] = run_hamlib(HAMLIB_PORT)
    out["hamlib"]["seconds"] = time.time() - t0
    return out


# ------------------------- slice 19: a planned restart of the Rx child on the card

#: phase 4p: the CC11xx station's sockets from this port on (as 4f moves
#: them); a feed of paced CC11xx packets, one at the start of each slot of
#: RESTART_SLOT_S seconds (the first slot silent), for RESTART_FEED_S seconds
#: and at least RESTART_AFTER_S after the swap (RESTART_MAX_FEED_S at most);
#: the children's RSS read RESTART_CAP_AT_S into the feed; the cap while no
#: restart is wanted (MB: the maintenance thread runs and restarts nothing)
RESTART_PORT = 17600
RESTART_SLOT_S, RESTART_FEED_S, RESTART_AFTER_S, RESTART_MAX_FEED_S = 0.8, 32.0, 8.0, 120.0
RESTART_CAP_AT_S = 3.0
RESTART_CAP_OFF = 10 ** 6
#: the range rate (m/s) of every packet of 4p: at 4l's -18 km/s the link
#: loses a packet at some offsets to the hop grid (the JAX demodulator too)
RESTART_RANGERATE = 0.0
#: the bound on 4p's interpreter of its own (``run_restart_fresh``), seconds
RESTART_TIMEOUT_S = 300.0


def maps_torch(pid) -> bool:
    """Whether process ``pid`` maps a torch library (``/proc/<pid>/maps``)."""
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in line for line in f)


def memory_line(pid) -> dict:
    """``orchestrator.memory_split`` of ``pid`` and whether it maps torch."""
    from pycusdr_tpu_torch.runtime import orchestrator

    return dict(orchestrator.memory_split(pid), torch=maps_torch(pid))


def memory_text(m) -> str:
    """One child's memory split for a ``say`` line, MB."""
    st = " ".join(f"{k} {'absent' if m[k] is None else f'{m[k]:.1f}'}"
                  for k in ("RssAnon", "RssFile", "RssShmem"))
    return (f"statm resident {m['resident']:.1f} shared {m['shared']:.1f}; status {st}; smaps "
            f"anonymous + shmem {m['smaps_anon']:.1f}; the cap's figure {m['rss_mb']:.1f}; "
            f"maps torch: {m['torch']}")


def compute_apps():
    """``nvidia-smi --query-compute-apps=pid,used_memory`` lines, or what
    it said instead."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return [line.strip() for line in (out.stdout or out.stderr).splitlines() if line.strip()]
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi failed: {e}"]


class RestartFeed:
    """Phase 4p's feed, in a thread of its own: slot k of RESTART_SLOT_S
    seconds holds packet k (none in slot 0): a seeded payload of 2 to 253
    bytes through the port's ``Modulator`` for CC11xx.json's Tx radio at
    range rate RESTART_RANGERATE, then silence; AWGN at
    CC11XX_SNR_DB a sample (``measured=False``) over all of it. Each slot
    is PUBlished to the Rx in half hops, paced at the sample rate, while
    ``more()`` says so; then CC11XX_TAIL_HOPS hops of noise, so the last
    packet's FIXED window reaches the decoder. ``sent`` holds the payloads
    of the slots sent whole, ``sent_at`` the seconds into the feed at which
    each slot began."""

    def __init__(self, conf, pub, more):
        radio = conf["Radios"]["Tx"]["UHF"]
        self.mod = Modulator(conf, radio, loadProtocol("CC11xx")(conf=conf))
        self.mod.set_rangerate(RESTART_RANGERATE)
        self.fs = radio["baud"] * radio["samplesPerSym"]
        self.slot = int(RESTART_SLOT_S * self.fs)
        self.hop = 2 ** conf["GPU"]["UHF"]["blockSize"] - 2 ** conf["GPU"]["UHF"]["overlap"]
        self.pub, self.more = pub, more
        self.rng = np.random.RandomState(SEED + 50)
        self.noise_rng = np.random.RandomState(SEED + 51)
        self.sent, self.sent_at, self.error = [], [], None
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _send(self, x):
        chunk = self.hop // 2
        for pos in range(0, len(x), chunk):
            delay = self.t0 + (self.n + pos) / self.fs - time.time()
            if delay > 0:
                time.sleep(delay)
            self.pub.send(x[pos:pos + chunk].tobytes())
        self.n += len(x)

    def _run(self):
        try:
            self.t0, self.n, k = time.time(), 0, 0
            while self.more() or k == 0:
                clean = np.zeros(self.slot, np.complex64)
                payload = None
                if k:
                    payload = self.rng.randint(0, 256, int(self.rng.randint(2, 254))).astype(
                        np.uint8)
                    w = self.mod.encodeAndModulate(payload)
                    clean[:len(w)] = w
                t_slot = self.n / self.fs
                self._send(awgn(clean, CC11XX_SNR_DB, measured=False,
                                rng=self.noise_rng).astype(np.complex64))
                if payload is not None:
                    self.sent.append(payload.tobytes())
                    self.sent_at.append(t_slot)
                k += 1
            self._send(awgn(np.zeros(CC11XX_TAIL_HOPS * self.hop, np.complex64), CC11XX_SNR_DB,
                            measured=False, rng=self.noise_rng).astype(np.complex64))
        except Exception as e:  # reported by run_restart
            self.error = e


def run_restart(port0, card):
    """Phase 4p: ``PyCuSDR`` from CC11xx.json (``cc11xx_runtime_conf``) with
    ``Main.maxWorkerRssMb`` at RESTART_CAP_OFF, so that the maintenance
    thread runs. Once the station is up, ``RestartFeed`` paces packets into
    the Rx; RESTART_CAP_AT_S into the feed every child's RSS is read and
    printed, and the cap set half-way between the demodulator child's and
    the largest of the others' (no such gap fails); once the planned
    restart has begun the cap goes back to RESTART_CAP_OFF. The replacement
    must be ``...~r1``; K1-K5 must launch in both children, the old one's
    blocks going on after the replacement shipped its first; the
    replacement must launch each of K1-K5 once for every block it shipped;
    every payload sent must come out of decodeBytesOut exactly once, and
    nothing else; the old child must be gone within the teardown's stop,
    join and kill limits; ``native.AVAILABLE`` in both Rx children and the
    decoder, the SigFIFO rings native, the decoder's correlations native,
    no numpy form taken. Returns a dict."""
    import zmq

    from pycusdr_tpu_torch.runtime import orchestrator
    from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

    conf = cc11xx_runtime_conf(port0)
    conf["Main"]["maxWorkerRssMb"] = RESTART_CAP_OFF
    overlap = float(conf["Main"].get("restartOverlapSeconds", 5.0))
    ctx = zmq.Context()
    rx_in = ctx.socket(zmq.PUB)
    rx_in.setsockopt(zmq.LINGER, 0)
    rx_in.bind(f"tcp://127.0.0.1:{port0}")
    sink = ctx.socket(zmq.PULL)
    sink.setsockopt(zmq.LINGER, 0)
    sink.setsockopt(zmq.RCVTIMEO, 200)
    sdr = PyCuSDR(conf, args=None)
    old = sdr.demodulators[0]
    i = sdr.tasks.index(old)
    made, factory = [], sdr._task_factories[i]

    def recording_factory():
        child = factory()
        made.append((child, time.time()))
        return child

    sdr._task_factories[i] = recording_factory
    st = dict(t_swap=None)
    received, done = [], threading.Event()

    def collect():
        while not done.is_set():
            try:
                received.append(sink.recv())
            except zmq.error.Again:
                pass

    def more():
        now = time.time()
        return now < st["t_feed"] + RESTART_MAX_FEED_S and (
            now < st["t_feed"] + RESTART_FEED_S or st["t_swap"] is None
            or now < st["t_swap"] + RESTART_AFTER_S)

    t_boot = time.time()
    sdr.start()
    collector = threading.Thread(target=collect, daemon=True)
    mem = {}  # "<child> warm" / "<child> last": memory_line
    try:
        wait_station(sdr, "4p")
        warm_s = time.time() - t_boot
        for who, t in (("decoder", sdr.dec), ("Tx", sdr.modulators[0]), ("old Rx", old)):
            mem[f"{who} warm"] = memory_line(t.pid)
        rss_warm = mem["old Rx warm"]["rss_mb"]
        sink.connect(f"tcp://localhost:{port0 + 12}")
        time.sleep(1.0)  # let the SUB and PULL sockets connect
        feed = RestartFeed(conf, rx_in, more)
        collector.start()
        st["t_feed"] = t0 = time.time()
        feed.thread.start()
        rss_at_cap, cap, t_begin, t_new_warm, t_old_gone = None, None, None, None, None
        samples, rss_old, smi, rss_new_warm, next_rss = [], [], None, None, 0.0
        while feed.thread.is_alive():
            now = time.time() - t0
            new = made[0][0] if made else None
            if cap is None and now > RESTART_CAP_AT_S:
                rss_at_cap = {t.name: orchestrator.rss_mb(t.pid) for t in sdr.tasks}
                for name, mb in rss_at_cap.items():
                    say("main", f"{card} | 4p RSS (the cap's figure) {name} {mb:.1f} MB "
                                f"({now:.1f} s into the feed)")
                others = max(mb for name, mb in rss_at_cap.items() if name != old.name)
                assert rss_at_cap[old.name] > others, (
                    f"4p: no RSS gap: the demodulator child {rss_at_cap[old.name]:.1f} MB, "
                    f"another child {others:.1f} MB: {rss_at_cap}")
                cap = (rss_at_cap[old.name] + others) / 2
                sdr._max_rss_mb = cap
            if t_begin is None and sdr._maint_restarting:
                t_begin = now
                sdr._max_rss_mb = RESTART_CAP_OFF  # one planned restart
            alive = old.is_alive()
            samples.append((now, alive, old.blocks, new.blocks if new else 0))
            if alive and now >= next_rss:
                try:
                    blocks = old.blocks
                    mem["old Rx last"] = memory_line(old.pid)
                    rss_old.append((now, mem["old Rx last"]["rss_mb"], blocks))
                except OSError:
                    pass
                next_rss = now + 1.0
            if new is not None and t_new_warm is None and new.warmedFlag.is_set():
                t_new_warm = now
                mem["new Rx warm"] = memory_line(new.pid)
                rss_new_warm = mem["new Rx warm"]["rss_mb"]
            if smi is None and t_new_warm is not None and now > t_new_warm + 2.0 and alive:
                smi = dict(t=now, pids={"old": old.pid, "new": new.pid,
                                        "decoder": sdr.dec.pid}, apps=compute_apps())
            if st["t_swap"] is None and sdr.demodulators[0] is not old:
                st["t_swap"] = time.time()
            if t_old_gone is None and t_begin is not None and not alive:
                t_old_gone = now
            time.sleep(0.1)
        feed_s = time.time() - t0
        assert feed.error is None, f"4p: the feed failed: {feed.error!r}"
        time.sleep(3.0)  # the last packet's decode
        assert len(made) == 1, f"4p: {len(made)} replacements made"
        new, t_made = made[0]
        assert st["t_swap"] is not None and sdr.demodulators[0] is new, "4p: no swap"
        assert new.workerId == old.workerId + "~r1", f"4p: replacement workerId {new.workerId}"
        assert not old.is_alive() and new.is_alive(), "4p: the old child lives on"
        for who, t in (("decoder", sdr.dec), ("Tx", sdr.modulators[0]), ("new Rx", new)):
            mem[f"{who} last"] = memory_line(t.pid)
        rss_new_end = mem["new Rx last"]["rss_mb"]
        launches_old, blocks_old = old.launches, old.blocks
        launches_new, blocks_new = new.launches, new.blocks
        native_counts = {"old": old.native_counts, "new": new.native_counts,
                         "decoder": sdr.dec.native_counts}
        devices = [old.device, new.device]
    finally:
        done.set()
        sdr.terminate()
        collector.join(timeout=5)
        rx_in.close()
        sink.close()
        ctx.term()
    assert not any(t.is_alive() for t in sdr.tasks), "4p: a child outlived terminate()"
    assert devices == ["cuda", "cuda"], f"4p: children on {devices}"

    check_launches("restart", launches_old)
    check_launches("restart", launches_new)
    five = PATH_KERNELS["restart"]
    assert all(launches_new[k] == blocks_new for k in five) and blocks_new > 0, \
        f"4p: the replacement shipped {blocks_new} blocks, launched {launches_new}"
    both = [s for s in samples if s[1] and s[3] > 0]
    assert both and both[-1][2] > both[0][2], \
        "4p: the old child shipped no block once the replacement had shipped one"
    assert t_old_gone is not None and t_new_warm is not None, "4p: no overlap seen"
    gone_s = t_old_gone - (t_new_warm + overlap)
    limit = orchestrator.RESTART_STOP_S + orchestrator.RESTART_JOIN_S + orchestrator.RESTART_KILL_S
    assert gone_s <= limit + 1.0, f"4p: the old child went {gone_s:.1f} s after the overlap"

    sent = dict(zip(feed.sent, feed.sent_at))
    got = collections.Counter(received)
    assert len(sent) == len(feed.sent), "4p: a payload was sent twice"
    lost = [(len(p), round(t, 2)) for p, t in sent.items() if got[p] == 0]
    twice = [(len(p), round(t, 2), got[p]) for p, t in sent.items() if got[p] > 1]
    foreign = sum(n for p, n in got.items() if p not in sent)
    assert not lost and not twice and not foreign, (
        f"4p: {len(sent)} payloads sent: lost (bytes, s into the feed) {lost}, more than once "
        f"{twice}, {foreign} never sent; restart began {t_begin:.2f} s, replacement warm "
        f"{t_new_warm:.2f} s, swap {st['t_swap'] - t0:.2f} s, old gone {t_old_gone:.2f} s")
    for who in ("old", "new"):
        nc = native_counts[who]
        assert nc["available"] and nc["ring"]["native"] > 0 and nc["ring"]["numpy"] == 0, \
            f"4p: the {who} Rx child's native counts {nc}"
    nc = native_counts["decoder"]
    assert nc["available"] and nc["bit_correlate"]["native"] > 0, f"4p: decoder native {nc}"
    assert not any(nc[k]["numpy"] for k in nc if k != "available"), f"4p: decoder numpy {nc}"

    stats = {w["workerId"]: w for w in sdr.passStats}
    def packet_times(wid):
        w = stats[wid]
        return [float(t) for t, n in zip(w["timestamp"], w["packetSuc"]) if n > 0]
    old_t, new_t = packet_times(old.workerId), packet_times(new.workerId)
    assert old_t and new_t, "4p: a stream decoded no packet"
    return dict(
        config="CC11xx.json", packets_sent=len(sent), delivered_once=len(sent),
        worker_ids=[old.workerId, new.workerId], warm_s=warm_s, cap_mb=cap,
        rss_at_cap_mb=rss_at_cap, restart_began_s=t_begin,
        replacement_warm_s=t_new_warm + t0 - t_made, overlap_s=overlap,
        old_gone_after_overlap_s=gone_s, old_exitcode=old.exitcode,
        decode_gap_s=new_t[0] - old_t[-1],
        packets_old_stream=len(old_t), packets_new_stream=len(new_t),
        blocks_old=blocks_old, blocks_new=blocks_new,
        launches_old=launches_old, launches_new=launches_new,
        launches={k: launches_old[k] + launches_new[k] for k in launches_old},
        rss_old_warm_mb=rss_warm, rss_old_last_mb=rss_old[-1][1], rss_old_blocks=rss_old[-1][2],
        rss_old_growth_kb_per_block=1e3 * (rss_old[-1][1] - rss_warm) / max(rss_old[-1][2], 1),
        rss_new_warm_mb=rss_new_warm, rss_new_end_mb=rss_new_end, card_memory=smi,
        native=native_counts, feed_s=feed_s, memory=mem)


def run_fresh(call, phase, timeout):
    """``chip_smoke.<call>`` (a call's text, e.g. ``run_restart(17600, '...')``)
    in an interpreter of its own, started with ``-c`` as ``python -m
    pycusdr_tpu_torch`` and ``python -m pycusdr_tpu_torch.bench.<name>``
    start: its spawned children then re-import no main module, where a child
    of this script re-imports chip_smoke.py, and with it torch, whatever it
    runs. Relays the interpreter's lines, kills it after ``timeout`` seconds,
    and returns the call's dict; a failure fails ``phase``."""
    code = ("import json, sys; sys.path.insert(0, %r); import chip_smoke; "
            "r = chip_smoke.%s; print('fresh-result ' + json.dumps("
            "r, default=lambda o: o.item() if hasattr(o, 'item') else str(o)), flush=True)"
            % (str(Path(__file__).resolve().parent), call))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    result = None
    try:
        for line in proc.stdout:
            if line.startswith("fresh-result "):
                result = json.loads(line[len("fresh-result "):])
            else:
                print(line, end="", flush=True)
        code = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert code == 0 and result is not None, f"{phase}: its interpreter exited with {code}"
    return result


# ------------------------------------- slice 21: the station harnesses on the card

#: phase 4q's ports: ber from HARNESS_PORT (12000, 12100-12104), diversity's
#: arms from +200 (12200, 12300-12304; 12400-12402, 12500-12504),
#: streaming_rt from +600 (12600-12603, 12700-12704); no other phase binds
#: 11400-14999 but 4r (12801)
HARNESS_PORT = 12000
#: the bound on phase 4q's interpreter, and the phase's budget on the card
HARNESS_TIMEOUT_S, HARNESS_BUDGET_S = 400.0, 150.0
#: ber_delta: modulations, SNRs (dB in the signal's bandwidth) and runs;
#: at the high SNR the arms' bit errors must be equal, at the low one
#: |BER delta| <= DELTA_BAR
DELTA_MODS, DELTA_SNRS, DELTA_RUNS, DELTA_BAR = ("FSK", "GMSK"), (4.0, 10.0), 2, 1e-3
#: ber: FSK at BER_SNR_DB, BER_RUNS runs; diversity: FSK at DIV_SNR_DB,
#: DIV_RUNS runs, the 3-channel arm paced at DIV_PACE x the sample rate
BER_SNR_DB, BER_RUNS = 18.0, 2
DIV_SNR_DB, DIV_RUNS, DIV_PACE = 8.0, 2, 6.0
#: streaming_rt: signal seconds, SNR and the drain after the front end
#: stops (s), at real time and range rate 0
RT_SIGNAL_S, RT_SNR_DB, RT_DRAIN_S = 24.0, 18.0, 16.0


def harness_step(name, fn, steps, phase="harnesses"):
    """Run step ``name``: print its start and its seconds; record them."""
    say(phase, f"start {name}")
    t0 = time.time()
    out = fn()
    steps[name] = time.time() - t0
    say(phase, f"{name} {steps[name]:.1f} s")
    return out


def run_harnesses(port0, card):
    """Phase 4q: the station harnesses through their entry points, the
    children on the card. hw_selfcheck: every check PASSes; ber_delta:
    DELTA_MODS at DELTA_SNRS, DELTA_RUNS runs each: in every run both arms
    find a packet or neither does, at the high SNR their bit errors are
    equal, at the low one |BER delta| <= DELTA_BAR; ber: FSK at BER_SNR_DB,
    every run's packet bit-exact; diversity: FSK at DIV_SNR_DB, both arms to
    their end, the voted arm delivers packets; streaming_rt at real time,
    RT_SIGNAL_S s at RT_SNR_DB (range rate 0): every steady-state packet
    decoded, every packet bit-exact, none twice. Every child on the card;
    K1-K5 launched (the phase's own block graphs and every child's, from its
    warm point on). Returns a dict."""
    from pycusdr_tpu_torch.bench import ber, ber_delta, diversity, hw_selfcheck, streaming_rt

    ops.reset_launches()
    steps, lines = {}, []

    def selfcheck():
        failed = hw_selfcheck.run_selfcheck(out=lambda line: (lines.append(line),
                                                              say("harnesses", line)))
        assert failed == 0 and sum(x.startswith("PASS") for x in lines) == 5, \
            f"4q: hw_selfcheck failed {failed}: {lines}"

    harness_step("hw_selfcheck", selfcheck, steps)
    rows = harness_step("ber_delta", lambda: ber_delta.run_delta(
        DELTA_MODS, list(DELTA_SNRS), DELTA_RUNS, verbose=False), steps)
    for r in rows:
        a, b = r["errors_by_run_device"], r["errors_by_run_golden"]
        say("harnesses", f"ber_delta {r['modulation']} {r['snr_db']:g} dB (Eb/N0 "
                         f"{r['ebn0_db']:.2f} dB): found {r['found_device']}/{r['found_golden']} "
                         f"of {r['runs']}, bit errors by run device {a} golden {b}, BER device "
                         f"{r['ber_device']:.6g} golden {r['ber_golden']:.6g}, delta "
                         f"{r['ber_delta']:.3g}")
        assert [e is None for e in a] == [e is None for e in b], \
            f"4q: ber_delta {r['modulation']} {r['snr_db']} dB: the arms found other packets: {r}"
        if r["snr_db"] == max(DELTA_SNRS):
            assert a == b, f"4q: ber_delta {r['modulation']} {r['snr_db']} dB: bit errors {a} {b}"
        else:
            assert abs(r["ber_delta"]) <= DELTA_BAR, f"4q: ber_delta {r}"
    sweep = harness_step("ber", lambda: ber.run_ber_sweep(
        "FSK", nRuns=BER_RUNS, snrs=[BER_SNR_DB], basePort=port0), steps)
    say("harnesses", f"ber FSK {BER_SNR_DB:g} dB: packets {sweep['numPackets']}, bit errors "
                     f"{sweep['bitErrors']}, BER {sweep['BER']}, Eb/N0 {sweep['EBN0']}, blocks "
                     f"{sweep['blocks']}, devices {sweep['devices']}")
    assert sweep["numPackets"] == [BER_RUNS] and sweep["bitErrors"] == [[0] * BER_RUNS], \
        f"4q: ber: {sweep['numPackets']} packets, bit errors {sweep['bitErrors']}"
    (div,) = harness_step("diversity", lambda: diversity.run_diversity(
        "FSK", (DIV_SNR_DB,), DIV_RUNS, basePort=port0 + 200, fsSimFactor3=DIV_PACE,
        verbose=False), steps)
    say("harnesses", f"diversity FSK {DIV_SNR_DB:g} dB, {DIV_RUNS} runs: one channel "
                     f"{div['packets_1ch']} packets BER {div['ber_1ch']:.6g} (bit errors "
                     f"{div['bit_errors_1ch']}), three voted {div['packets_3ch_voted']} packets "
                     f"BER {div['ber_3ch_voted']:.6g} (bit errors {div['bit_errors_3ch']}); blocks "
                     f"{div['blocks_1ch']} / {div['blocks_3ch']}")
    assert div["packets_3ch_voted"] >= 1, f"4q: diversity: no voted packet: {div}"
    assert div["blocks_1ch"] > 0 and div["blocks_3ch"] > 0, f"4q: diversity: {div}"
    rt = harness_step("streaming_rt", lambda: streaming_rt.run_point(
        1.0, RT_SIGNAL_S, basePort=port0 + 600, snr_db=RT_SNR_DB, drain_s=RT_DRAIN_S,
        ready_timeout=120.0, verbose=False), steps)
    say("harnesses", "streaming_rt " + json.dumps(rt))
    assert rt["steady_decoded"] == rt["steady_scheduled"] > 0, f"4q: streaming_rt: {rt}"
    assert rt["packets_bit_exact"] == rt["packets_decoded"] and rt["packets_duplicate"] == 0, \
        f"4q: streaming_rt: {rt}"

    torch.cuda.synchronize()
    launches = ops.launch_counts()
    devices = sweep["devices"] + div["devices"] + rt["devices"]
    assert devices and all(d == "cuda" for d in devices), f"4q: children on {devices}"
    in_process = dict(launches)
    for child in (sweep["launches"], div["launches_1ch"], div["launches_3ch"], rt["launches"]):
        for k, v in child.items():
            launches[k] += v
    check_launches("harnesses", launches)
    total = sum(steps.values())
    assert total <= HARNESS_BUDGET_S, f"4q: {total:.1f} s, over its {HARNESS_BUDGET_S} s budget"
    return dict(steps_s=steps, seconds=total, selfcheck=lines, ber_delta=rows,
                ber={k: v for k, v in sweep.items() if k != "payloads"}, diversity=div,
                streaming_rt=rt, launches=launches, launches_in_process=in_process,
                blocks_children=sweep["blocks"] + div["blocks_1ch"] + div["blocks_3ch"]
                + rt["blocks"])


# ------------------------------------------ slice 22: the timing harnesses on the card

#: phase 4r: the rendezvous of scaling's world of two ranks (TIMERS_PORT + 1;
#: a world of one runs in the phase's interpreter); no other phase binds 12800-12899
TIMERS_PORT = 12800
#: the bound on phase 4r's interpreter, and the phase's budget on the card
TIMERS_TIMEOUT_S, TIMERS_BUDGET_S = 300.0, 90.0
#: profile_stages: the flagship's batches (both modes), calls a timing
PROFILE_BATCHES, PROFILE_T = (1, 16), 10
#: subsystems: the channelizer's (M, taps a branch, samples a hop), at the
#: wideband path's shape and through K9's wide form; the tracking pass
#: (blocks, SNR dB) at tracking_conf's grid
SUB_CHANNELIZER, SUB_TRACK = ((64, 8, 2 ** 16), (2048, 8, 2 ** 22)), (48, 10.0)
#: capture_probe's hops a call; scaling's channels a call (--per-chip) and
#: its world sizes
CAPTURE_K, SCALING_C, SCALING_WORLDS = 32, 16, (1, 2)
#: hw_leak_probe: iterations, and the bar on np_input: a quarter of the
#: flagship block's 512 KB (a transfer kept on every call reads about 512);
#: the control, which keeps a 94 KB row an iteration, must read at least half
#: of it (each probe trims the heap first, so memory earlier steps freed
#: cannot serve what it keeps)
LEAK_ITERS, LEAK_BAR_KB = 200, 128.0


def stage_line(label, name, r):
    """One row of ``profile_stages.run_profile`` as a line."""
    dev = r["device_us_per_block"]
    return (f"{label} {name}: us/block {r['us_per_block']:.3f} device "
            f"{'null' if dev is None else f'{dev:.3f}'} bound {r['bound_us']:.4g} "
            f"({r['bound_by']}) MB {r['mbytes_min']:.4g} GFLOP {r['gflops_per_block']:.4g}; "
            f"{r['pct_memory_roof']:.2f}% of the memory roof, {r['pct_f32_roof']:.2f}% of f32"
            + (f"; idle {r['idle_pct']:.1f}%" if r.get("idle_pct") is not None else ""))


def run_timers(port0, card):
    """Phase 4r: the five timing harnesses through their entry points on the
    card. profile_stages: the flagship at PROFILE_BATCHES in both modes and
    STX at B=1 (stages): every row finite and clear of its bound, the prefix
    rows within 2% of the graph's busy time, the roofs under their datasheet
    rates (``run_profile`` asserts them); subsystems: the channelizer's tone
    purity > 0.9, the tracker locks over SUB_TRACK; capture_probe at
    CAPTURE_K: both routes' decisions equal; scaling: --per-chip at SCALING_C
    (auto and generic) and ``run_scaling(SCALING_WORLDS)`` (two ranks on the
    card over gloo); hw_leak_probe: np_input under LEAK_BAR_KB an iteration,
    the control at least half the row it keeps.
    The phase's kernels launched (in this interpreter and in scaling's
    ranks); its steps within TIMERS_BUDGET_S. Returns a dict."""
    from pycusdr_tpu_torch.bench import (
        capture_probe,
        hw_leak_probe,
        profile_stages,
        scaling,
        subsystems,
    )
    from pycusdr_tpu_torch.configs import flagship_spec, stx_spec

    ops.reset_launches()
    steps, rank_launches = {}, {}
    fspec = flagship_spec()

    def profile():
        out = {}
        for label, spec, batches, mode in (("flagship", fspec, PROFILE_BATCHES, "stages"),
                                           ("flagship", fspec, PROFILE_BATCHES, "prefix"),
                                           ("stx", stx_spec(), (1,), "stages")):
            r = profile_stages.run_profile(batches, PROFILE_T, spec=spec, mode=mode,
                                           device="cuda")
            out[f"{label} {mode}"] = r
            for B, rows in r["batches"].items():
                for name, row in rows.items():
                    say("timers", f"{card} | " + stage_line(f"{label} {mode} {B}", name, row))
        r = out["flagship stages"]
        say("timers", f"{card} | roofs: memory {r['memory_roof_gbps']:.1f} GB/s, f32 "
                      f"{r['matmul_roof_tflops']['f32']:.2f} TFLOP/s, bf16 "
                      f"{r['matmul_roof_tflops']['bf16']:.1f} TFLOP/s (datasheet "
                      f"{json.dumps(r['datasheet'])}); launch floor {r['launch_floor_ms']:.5f} "
                      f"ms, dispatch round trip {r['dispatch_rtt_ms']:.4f} ms")
        return out

    prof = harness_step("profile_stages", profile, steps, "timers")

    def subsys():
        chs = [subsystems.channelizer_bench(M, K, n, batches=(1, 4) if i == 0 else (1,), T=10,
                                            device="cuda")
               for i, (M, K, n) in enumerate(SUB_CHANNELIZER)]
        tr = subsystems.tracking_bench(fspec, SUB_TRACK[0], snr_db=SUB_TRACK[1], T=20,
                                       device="cuda", **{k: tracking_conf()[k] for k in (
                                           "track_bins", "track_span_bins")})
        return chs, tr

    chs, tr = harness_step("subsystems", subsys, steps, "timers")
    for ch in chs:
        say("timers", f"{card} | channelizer M={ch['M']} K={ch['taps_per_branch']} "
                      f"({ch['form']} form), {ch['n_samples']} samples a hop: tone purity "
                      f"{ch['tone_purity']:.6f}; " + json.dumps(ch["throughput"]))
    assert chs[1]["form"] == "wide", f"4r: the wide channelizer ran the {chs[1]['form']} form"
    say("timers", f"{card} | tracking {tr['n_blocks']} blocks at {tr['snr_db']:g} dB: first lock "
                  f"{tr['first_lock_block']}, lock fraction {tr['lock_fraction_after_first']:.3f}, "
                  f"median error {tr['median_err_bins']:.3f} bins; acquire "
                  f"{tr['acquire_us_per_block']:.1f} us, track {tr['track_us_per_block']:.1f} us "
                  f"a block (x{tr['track_speedup']:.3f})")
    assert tr["lock_fraction_after_first"] > 0.5, f"4r: tracking {tr}"
    cap = harness_step("capture_probe", lambda: capture_probe.run_probe(CAPTURE_K, device="cuda"),
                       steps, "timers")
    say("timers", f"{card} | " + json.dumps(cap))

    def scale():
        per = {prog: scaling.sharded_per_chip_msps(fspec, SCALING_C,
                                                   force_generic=prog == "generic",
                                                   device="cuda")
               for prog in ("auto", "generic")}
        rows = scaling.run_scaling(SCALING_WORLDS, fspec, device="cuda", port=port0,
                                   launches=rank_launches)
        return per, rows

    per, worlds = harness_step("scaling", scale, steps, "timers")
    say("timers", f"{card} | sharded step per chip C={SCALING_C}: auto {per['auto']:.1f}, generic "
                  f"{per['generic']:.1f} Msamples/s; worlds " + json.dumps(worlds))
    leak = harness_step("hw_leak_probe", lambda: hw_leak_probe.run_probes(
        LEAK_ITERS, "cuda", fspec, out=lambda line: say("timers", line)), steps, "timers")
    assert leak["np_input"] < LEAK_BAR_KB, f"4r: np_input keeps {leak['np_input']} KB a transfer"
    assert leak["kept_rows"] >= 0.5 * leak["row_kb"], \
        f"4r: the control kept {leak['row_kb']} KB an iteration, the reader saw {leak['kept_rows']}"

    torch.cuda.synchronize()
    launches = ops.launch_counts()
    in_process = dict(launches)
    for k, v in rank_launches.items():
        launches[k] += v
    check_launches("timers", launches)
    total = sum(steps.values())
    assert total <= TIMERS_BUDGET_S, f"4r: {total:.1f} s, over its {TIMERS_BUDGET_S} s budget"
    return dict(steps_s=steps, seconds=total, profile=prof, channelizer=chs, tracking=tr,
                capture=cap, per_chip_msps=per, worlds=worlds, leak=leak, launches=launches,
                launches_in_process=in_process)


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


# ------------------------------ K5 and K4 redesigned, K1 and K5 at any M and D

#: planted equal grid entries of K5's tie cases: within one thread's entries
#: of the sum-all form (256 apart), one lane's of the per-mask form (32
#: apart), across lanes, across warps; then the second pair
K5_TIES = {"thread": (5, 261, 7, 263), "lane": (5, 37, 1000, 1032), "lanes": (5, 6, 40, 41),
           "warps": (300, 5, 900, 1200)}
#: K5's grid cases: (label, D, M, nd, array_offset, ties or None, recentred)
K5_GRIDS = ([(f"ties in {w}", 2048, 8, 2048, 0, t, False) for w, t in K5_TIES.items()]
            + [(f"nd={nd}", 2048, 8, nd, off, None, False) for nd in (1, 31, 33, 64)
               for off in (0, 1)]
            + [("D=3000", 3000, 8, 2999, 1, None, False)]
            + [(f"M={M}", 64, M, 64, 0, None, c) for M in (1, 64, 128) for c in (False, True)])
#: K4's cases at B=64: (label, N, S, W, spsymMin, spsym): the flagship, STX,
#: one-sample windows, windows wider than the symbol (W > 9: read sample by
#: sample, not in 16-byte chunks), sparse windows, and spSym far above spsym
#: (hw at its clamp: the clip words read in global memory after j)
K4_CASES = (("flagship", 2 ** 16, 4608, 7, 8, 16.0), ("stx", 2 ** 17, 9216, 3, 8, 16.0),
            ("W=1", 2 ** 13, 600, 1, 8, 16.0), ("W > spc", 2 ** 13, 1100, 24, 4, 8.0),
            ("sparse", 2 ** 16, 1024, 7, 8, 64.0), ("hw clamp", 2 ** 13, 128, 7, 8, 1500.0),
            ("partial word", 4097, 2100, 3, 2, 2.0))
#: K1's banks deeper than one launch takes (xcorrMaskSize 6 and 7)
K1_DEEP_M = (64, 128)


def k5_grid_inputs(rng, B, D, M, N=4096, ties=None, signal=True):
    """Seeded E (B, D, M) and P (B, N) on the card, a random grid in [N/8,
    3N/8) with its tables, the last block all zero. ``signal``: P four times
    stronger over [0, N/2) than over the mirrored half, so the SNR's band
    ratio is near 4 and its dB well conditioned; without it both bands hold
    noise alone, the ratio is near 1 and the dB of ratio - 1 magnifies the
    f32 rounding of the band sums (``check_doppler_estimate_noise``).
    ``ties``: the first two entries set equal above the rest, the next two
    equal below them."""
    E = rng.exponential(1.0, (B, D, M)).astype(np.float32)
    if ties:
        top = E.max() + 2.0
        E[:, list(ties[:2])] = top
        E[:, list(ties[2:])] = top - 1.0
    E[-1] = 0.0
    P = rng.exponential(1.0, (B, N)).astype(np.float32)
    if signal:
        P[:, :N // 2] *= 4.0  # the signal band: its mirror (the noise band) has a quarter the power
    P[-1] = 0.0
    shifts = np.sort(rng.randint(N // 8, 3 * N // 8, D)).astype(np.int32)
    signed = (np.mod(shifts + N // 2, N) - N // 2).astype(np.int32)
    hz = np.sort(rng.uniform(-1e4, 1e4, D)).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (E, P, shifts, signed, hz))


def k5_grid_kwargs(nd, off, sum_all, centred, N=4096):
    kw = dict(num_dopplers=nd, array_offset=off, sum_all_masks=sum_all, snr_window=5,
              centre_freq_offset=1.5e3)
    if centred:
        kw.update(centre_shift=torch.tensor([7, -300, N + 5, 0], dtype=torch.int32,
                                            device="cuda"), bin_hz=9.375)
    return kw


def check_doppler_estimate_grids():
    """K5 against its plain version (``k5_contract``) on K5_GRIDS, in both
    mask forms, with an all-zero block; a tie's lower index wins. Returns
    (max abs err, number of cases)."""
    rng = np.random.RandomState(SEED + 12)
    err, n = 0.0, 0
    for label, D, M, nd, off, ties, centred in K5_GRIDS:
        args = k5_grid_inputs(rng, 4, D, M, 4096, ties)
        for sum_all in (True, False):
            kw = k5_grid_kwargs(nd, off, sum_all, centred)
            got = ds.doppler_estimate(*args, **kw)
            want = ds.doppler_estimate_plain(*args, **kw)
            torch.cuda.synchronize()
            tag = f"K5 {label} D={D} M={M} nd={nd} offset={off} sum_all={sum_all}"
            err = max(err, k5_contract(got, want, tag))
            if ties:
                a, b = sorted(ties[:2])
                assert abs(float(got[0][0]) - (a + b) / 2) <= 1e-6 * (a + b), tag
            n += 1
    return err, n


#: f32's unit roundoff
F32_U = 2.0 ** -24


def band_ratio(snr_db):
    """K5's band ratio sig / noise from its SNR, 1 + 10^(dB / 20), in
    float64 (1 where the dB is -inf: ratio - 1 <= 0)."""
    return 1.0 + torch.pow(10.0, snr_db.double() / 20.0)


def snr_f64(P, shifts, dopp_idx, w, centre=None):
    """K5's SNR in float64 on the bands that ``dopp_idx`` fixes, and the bins
    a band holds: (B,) each."""
    D, N = shifts.shape[0], P.shape[1]
    lo = shifts[torch.clamp(torch.floor(dopp_idx).long(), 0, D - 1)].long()
    hi = shifts[torch.clamp(torch.ceil(dopp_idx).long(), 0, D - 1)].long()
    if centre is not None:
        lo, hi = lo + centre.long(), hi + centre.long()
    n = torch.remainder(hi - lo + 2 * w, N).double()
    return ds.compute_snr(torch.sqrt(P.double()), lo, hi, w, N), n


def check_doppler_estimate_noise():
    """K5 on K5_GRIDS with noise alone in both SNR bands, in both mask
    forms: every output but the SNR under ``k5_contract``; the SNR through
    its band ratio q = sig / noise, the kernel's and the plain version's
    each within f32 rounding of q in float64 on the bands its own dopp_idx
    fixes (at a planted tie the two dopp_idx may fall either side of an
    integer, one f32 rounding apart, and then take bands a bin apart). The
    bound, for n bins a band: a band mean of n square roots is within
    (n + 1) u of its value, the quotient within (2n + 3) u, and ratio - 1,
    its log10 and the f32 dB that q is rebuilt from add u (1 + |dB| / 2) of
    ratio - 1, u = 2^-24. Returns the max over cases of |dB kernel - dB
    f64|, |dB plain - dB f64| (finite f64 SNR), |dB kernel - dB plain| (both
    finite, the same bands), |q kernel - q f64| / bound, |q plain - q f64| /
    bound, and the count of blocks whose two bands differ."""
    rng = np.random.RandomState(SEED + 14)
    worst, moved = [0.0] * 5, 0
    for label, D, M, nd, off, ties, centred in K5_GRIDS:
        args = k5_grid_inputs(rng, 4, D, M, 4096, ties, signal=False)
        P, shifts = args[1:3]
        for sum_all in (True, False):
            kw = k5_grid_kwargs(nd, off, sum_all, centred)
            got = ds.doppler_estimate(*args, **kw)
            want = ds.doppler_estimate_plain(*args, **kw)
            torch.cuda.synchronize()
            tag = f"K5 noise only {label} D={D} M={M} nd={nd} offset={off} sum_all={sum_all}"
            k5_contract(tuple(got[:4]) + (want[4],) + tuple(got[5:]), want, tag)
            for i, x in enumerate((got, want)):
                db64, n = snr_f64(P, shifts, x[0], kw["snr_window"], kw.get("centre_shift"))
                q64 = band_ratio(db64)
                r64 = q64 - 1.0
                tail = torch.where(r64 > 0, r64 * (1.0 + db64.abs() / 2), torch.zeros_like(r64))
                gap = (band_ratio(x[4]) - q64).abs() / (F32_U * (q64 * (2 * n + 3) + tail))
                assert float(gap.max()) <= 1.0, \
                    f"{tag}: {('kernel', 'plain')[i]} band ratio {gap.max():.3g} x its f32 " \
                    f"bound from float64"
                worst[3 + i] = max(worst[3 + i], float(gap.max()))
                fin = torch.isfinite(db64)
                if bool(fin.any()):
                    worst[i] = max(worst[i], float((x[4].double() - db64)[fin].abs().max()))
            same = ((torch.floor(got[0]) == torch.floor(want[0]))
                    & (torch.ceil(got[0]) == torch.ceil(want[0])))
            moved += int((~same).sum())
            both = same & torch.isfinite(got[4]) & torch.isfinite(want[4])
            if bool(both.any()):
                worst[2] = max(worst[2], float((got[4] - want[4])[both].abs().max()))
    return (*worst, moved)


def check_k4_case(case, B=64):
    """K4 against its plain version on one K4_CASES case at batch B, every
    output equal: tied magnitudes (the earliest sample wins), A clamped at 0
    and at N - W, clip hits on the bitmask's word edges and at samples 0 and
    N - 1; the form without the clip mask; the row form equal, and each
    block alone equal to its row of the batch. Returns (label, threads a
    CTA, slots a thread, colargmax read with the windows, slots set to
    trust -2)."""
    label, N, S, W, spsymMin, spsym = case
    rng = np.random.RandomState(N + S + W)
    lut = torch.tensor([0, 1, 1, 0, 1, 0, 0, 1], dtype=torch.int8, device="cuda")
    colmax = torch.from_numpy(rng.randint(0, 6, (B, N)).astype(np.float32)).cuda()
    colarg = torch.from_numpy(rng.randint(0, 8, (B, N)).astype(np.int32)).cuda()
    sp = spsym * (1 + 0.003 * rng.randn(B))
    co = rng.uniform(-spsym, spsym, B)
    co[1::8] = -3 * spsym  # A clamps at 0
    co[2::8] = N - 2 * spsym  # A clamps at N - W
    sp = torch.from_numpy(sp.astype(np.float32)).cuda()
    co = torch.from_numpy(co.astype(np.float32)).cuda()
    hit = np.zeros((B, N), bool)
    for b in range(B):
        edges = 32 * rng.randint(1, N // 32, 4)
        hit[b, np.r_[edges - 1, edges, rng.randint(0, N, 2)] % N] = True
    hit[0, 0] = hit[min(1, B - 1), N - 1] = True
    hit = torch.from_numpy(hit).cuda()
    hits = dk.pack_bits(hit)
    kw = dict(Nfft=N, windowWidth=W, spsymMin=spsymMin, numSymMax=S, trust_normal=2)
    clip = dk.dilate_mask_plain(hit, dk.clip_halfwidth(sp, spsymMin))
    want = dk.symbol_detect_plain(colmax, colarg, sp, co, lut, clip_mask=clip, **kw)
    got = dk.symbol_detect(colmax, colarg, sp, co, lut, hits=hits, **kw)
    unclipped = (dk.symbol_detect(colmax, colarg, sp, co, lut, **kw),
                 dk.symbol_detect_plain(colmax, colarg, sp, co, lut, **kw))
    L = 5 * S + 12
    row = torch.full((B, L), float("nan"), device="cuda")
    cv = torch.arange(B, dtype=torch.float32, device="cuda")
    anyc = hit.any(dim=-1).to(torch.int32)
    dk.symbol_detect(colmax, colarg, sp, co, lut, hits=hits, row=row, code_val=cv,
                     clipped_any=anyc, **kw)
    alone = torch.full((B, L), float("nan"), device="cuda")
    for b in range(B):
        dk.symbol_detect(colmax[b:b + 1], colarg[b:b + 1], sp[b:b + 1], co[b:b + 1], lut,
                         hits=hits[b:b + 1], row=alone[b:b + 1], code_val=cv[b:b + 1],
                         clipped_any=anyc[b:b + 1], **kw)
    torch.cuda.synchronize()
    tag = f"K4 {label} N={N} S={S} W={W} spsym={spsym}"
    for name, u, v in zip(("symbols", "centres", "mags", "bits", "trust", "nSym", "at_win"),
                          got, want):
        assert torch.equal(u, v), f"{tag}: {name} differs"
    assert all(torch.equal(u, v) for u, v in zip(*unclipped)), f"{tag}: without the clip mask"
    for i, t in enumerate((want[3], want[4], want[0], want[1], want[2])):
        assert torch.equal(row[:, i * S:(i + 1) * S], t.float()), f"{tag}: row array {i}"
    assert torch.equal(alone[:, :5 * S + 5], row[:, :5 * S + 5]), \
        f"{tag}: a block alone != its row of the batch"
    assert bool(want[6].any()), f"{tag}: no slot met the clip window"
    assert bool((want[5] < S).any()), f"{tag}: every block filled all {S} slots"
    return (label, *dk.k4_plan(B, S), int(want[6].sum()))


def check_doppler_energy_deep(consts):
    """K1 at the flagship grid with K1_DEEP_M random masks (one launch per
    group of at most 32, ``check_k1``), without and with a recentre; a
    wrapper call counts one launch per group. Returns [(M, groups, max err / max|E|)]."""
    rng = np.random.RandomState(SEED + 13)
    N = consts.Q.shape[1]
    P = torch.from_numpy(rng.exponential(1.0, (K1_BATCH, N)).astype(np.float32)).cuda()
    out = []
    for M in K1_DEEP_M:
        Q = torch.from_numpy(rng.exponential(1.0, (M, N)).astype(np.float32)).cuda()
        before = ds.doppler_energy.launches
        E = ds.doppler_energy(P, Q, consts.shifts)
        groups = len(ds.k1_mask_groups(M))
        assert ds.doppler_energy.launches == before + groups and E.shape[2] == M
        rel = max(check_k1(P, Q, consts.shifts, cs, f"M={M} recentred={cs is not None}")
                  for cs in (None, recentres(N, K1_BATCH)))
        out.append((M, groups, rel))
    return out


# ------------------------------------------------------------ K1 on the tensor cores

#: K1's shapes beyond the specs' own grids: (label, N, D, M, grid), grid
#: "random" (shifts anywhere on the circle: long arcs take the global-read
#: path), "compact" (a run of shifts 3 bins apart) or "mixed" (64 shifts 7
#: bins apart, then the rest spread over half the circle: a window group and
#: global-read groups in one launch)
K1_SHAPES = (
    ("random", 512, 1, 16, "random"),
    ("random", 999, 3, 1, "random"),
    ("random", 4096, 129, 32, "random"),
    ("compact", 2 ** 16, 129, 5, "compact"),
    ("compact", 2 ** 17, 3, 32, "compact"),
    ("mixed", 2 ** 17, 129, 8, "mixed"),
    ("mixed", 2 ** 16, 100, 16, "mixed"),
    ("random", 2 ** 18, 3, 5, "random"),
    ("random", 2 ** 18, 129, 1, "random"),
)
K1_BATCH = 4  # blocks of each K1 grid check
#: K1's bar against its plain version, relative to max|E|
K1_REL = 1e-4


def k1_grid(N, D, kind, rng):
    """D shifts of a K1_SHAPES grid kind on the circle of N bins."""
    if kind == "random":
        return rng.randint(0, N, D)
    if kind == "compact":
        return (rng.randint(0, N) + 3 * np.arange(D)) % N
    h = min(64, D // 2)  # a window group, then global-read groups
    return np.r_[7 * np.arange(h), N // 8 + (N // 2 // (D - h)) * np.arange(D - h)]


def k1_specs(fspec, fconsts, bconsts, ccconsts, cmbconsts):
    """The grids the main paths give K1: label -> (DeviceConsts, recentre
    of K1_BATCH blocks or None): flagship, ccsds, bpsk (M=16), the tracker's
    16-bin grid recentred, a generic shard's masks (M=4), tiny (wraps at N),
    cc11xx (64 shifts about 80.7 bins apart about the IF bin 10240),
    combiner (bench_3_chan_rx.json's 64 shifts at Nfft 2^15)."""
    dev = torch.device("cuda")
    tc = tracking_conf()
    track = narrow_spec(fspec, tc["track_bins"], tc["track_span_bins"])
    return {"flagship": (fconsts, recentres(fspec.Nfft, K1_BATCH)),
            "ccsds": (DeviceConsts.from_spec(ccsds_spec(), dev), None),
            "bpsk": (bconsts, None),
            "tracking": (DeviceConsts.from_spec(track, dev), recentres(fspec.Nfft, K1_BATCH)),
            "generic shard": (DeviceConsts.from_spec(fspec, dev, mask_range=(0, 4)), None),
            "tiny": (DeviceConsts.from_spec(tiny_spec(), dev), recentres(512, K1_BATCH)),
            "cc11xx": (ccconsts, recentres(fspec.Nfft, K1_BATCH)),
            "combiner": (cmbconsts, recentres(cmbconsts.Q.shape[1], K1_BATCH))}


def check_k1(P, Q, sh, cs, tag):
    """K1 against the plain version on P: within K1_REL * max|E|, two runs
    equal, each block alone equal to its row of the batch. Returns max err
    / max|E|."""
    fn = ds.doppler_energy
    Ep = ds.doppler_energy_plain(P, Q, sh, cs)
    Ek = fn(P, Q, sh, cs)
    again = fn(P, Q, sh, cs)
    alone = [fn(P[b:b + 1], Q, sh, None if cs is None else cs[b:b + 1]) for b in range(len(P))]
    torch.cuda.synchronize()
    rel = float((Ek - Ep).abs().max()) / float(Ep.abs().max())
    tag = f"K1 {tag}"
    assert rel <= K1_REL, f"{tag}: err {rel} of max|E|"
    assert torch.equal(Ek, again), f"{tag}: two runs differ"
    bad = [b for b, a in enumerate(alone) if not torch.equal(a[0], Ek[b])]
    assert not bad, f"{tag}: blocks {bad} alone != their rows of the batch"
    return rel


def check_doppler_energy_grids(specs):
    """K1 against its plain version on the main paths' grids (``specs`` of
    ``k1_specs``) and on K1_SHAPES, K1_BATCH seeded blocks of exponential
    P (the |.|^2 of noise) each, without and with a recentre per block
    (``check_k1``). Returns [(label, N, D, M, window groups, global-read
    groups, max err / max|E|)]."""
    rng = np.random.RandomState(SEED + 10)
    cases = [(label, c.Q, c.shifts, centre) for label, (c, centre) in specs.items()]
    for label, N, D, M, kind in K1_SHAPES:
        Q = torch.from_numpy(rng.exponential(1.0, (M, N)).astype(np.float32)).cuda()
        sh = torch.from_numpy(k1_grid(N, D, kind, rng).astype(np.int32)).cuda()
        cases.append((label, Q, sh, recentres(N, K1_BATCH)))
    out = []
    for label, Q, sh, centre in cases:
        M, N = Q.shape
        P = torch.from_numpy(rng.exponential(1.0, (K1_BATCH, N)).astype(np.float32)).cuda()
        worst = max(check_k1(P, Q, sh, cs, f"{label} N={N} D={sh.shape[0]} M={M} "
                                           f"centre={cs is not None}")
                    for cs in ((None,) if centre is None else (None, centre)))
        plan = ds.doppler_energy_plan(sh.cpu().numpy(), N, M)
        nwin = plan.window_groups(sh.cpu().numpy())
        out.append((label, N, sh.shape[0], M, nwin, -(-plan.T // ds.K1_GROUP_TILES) - nwin,
                    worst))
    return out


def check_doppler_energy_batch(consts, B=64):
    """K1 at the flagship grid on B seeded blocks with a recentre each
    (``check_k1``). Returns max err / max|E|."""
    rng = np.random.RandomState(SEED + 11)
    N = consts.Q.shape[1]
    P = torch.from_numpy(rng.exponential(1.0, (B, N)).astype(np.float32)).cuda()
    return check_k1(P, consts.Q, consts.shifts, recentres(N, B), f"B={B}")


def doppler_energy_ptxas():
    """K1's eight instantiations (mask tiles NT, shift tiles a CTA TG):
    [(NT, TG, registers, stack bytes, spill stores, spill loads)]."""
    return ptxas_report("doppler_energy.cu", r"doppler_energy_kILi(\d)ELi(\d)EE", 8)


def k1_sass():
    """{SASS mnemonic: count} of the tensor-core products (HMMA) in K1's
    built object (``cuobjdump -sass``), or None where the toolkit has no
    cuobjdump."""
    lib = Path(_lib.build_info["path"])
    obj = lib.parent / f"doppler_energy_{lib.stem.rsplit('_', 1)[1]}.o"
    tool = Path(_lib._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(obj)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = {}
    for op in re.findall(r"\b(HMMA\.[\w.]+)", sass):
        counts[op] = counts.get(op, 0) + 1
    return counts


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


def k9_ptxas():
    """ptxas's report of the fused K9 kernel's instantiations: [(G, V, P,
    MS, MSV, TTP, staged, registers, stack bytes, spill stores, spill
    loads)]."""
    return ptxas_report("channelizer.cu", r"channelizeILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                        r"ELi(\d+)ELb([01])EE", 22)


def check_channelize_plan():
    """Every form of ``k9_plan``: M = 1 to 1024 (every row split G x V) at K
    = 1, 8 and 32 (the span and the direct form), on a ragged T (three
    tiles and 7 rows) and on T < K - 1 (old state rows in the carry), with
    a random carry and random taps: y within K9_REL of max|y| of the plain
    version, the carry equal; two halves through the carry within K9_REL of
    max|y| of one call, the carry after them equal. Returns {form: [(M, K,
    T, relative err)]}."""
    out = {}
    for M in (1 << e for e in range(11)):
        for K in (1, 8, 32):
            plan = pch.k9_plan(M, K)
            for T in (3 * plan["TT"] + 7, max(1, K - 3)):
                rng = np.random.RandomState(M + K + T)
                x = torch.from_numpy(((rng.randn(T * M) + 1j * rng.randn(T * M)) / np.sqrt(2))
                                     .astype(np.complex64)).cuda()
                st = torch.from_numpy(((rng.randn(K - 1, M) + 1j * rng.randn(K - 1, M))
                                       / np.sqrt(2)).astype(np.complex64)).cuda()
                h2 = torch.from_numpy(rng.randn(K, M).astype(np.float32)).cuda()
                yk, sk = pch.channelize(x, h2, st)
                yp, sp = pch.channelize_plain(x, h2, st)
                torch.cuda.synchronize()
                scale = float(yp.abs().max())
                rel = float((yk - yp).abs().max()) / scale
                tag = f"K9 {plan['form']} M={M} K={K} T={T}"
                assert rel <= K9_REL, f"{tag}: err {rel} of max|y|"
                assert torch.equal(sk, sp), f"{tag}: the carry differs"
                if T >= 2:
                    h = T // 2 * M
                    y1, s1 = pch.channelize(x[:h], h2, st)
                    y2, s2 = pch.channelize(x[h:], h2, s1)
                    torch.cuda.synchronize()
                    rel_h = float((torch.cat([y1, y2], 1) - yp).abs().max()) / scale
                    assert rel_h <= K9_REL, f"{tag}: halves err {rel_h}"
                    assert torch.equal(s2, sp), f"{tag}: the carry after the halves differs"
                out.setdefault(plan["form"], []).append((M, K, T, rel))
    return out


#: K9's wide form (M > 1024 or K > 32, one launch of csrc/channelizer_wide.cu):
#: (M, K, T), each T M = 2^22 samples, the wideband hop's count, at the three
#: shapes the old FIR-plus-cuFFT form was timed at, the largest M the form
#: takes, and T < K - 1 (the carry holds old state rows)
K9_WIDE = ((2048, 8, 2048), (64, 40, 65536), (4096, 2, 1024), (16384, 8, 256), (64, 40, 16))
#: K9's split form above the wide form's largest M (the FIR kernel, then cuFFT)
K9_SPLIT = ((32768, 8, 128),)
#: K9's direct form (the fused kernel reading x through L1/L2 where two spans
#: do not fit in shared memory), timed beside the wide form at the same
#: (M, K, T), T M = 2^22
K9_DIRECT = ((1024, 8, 4096), (512, 16, 8192))


def k9_wide_inputs(M, K, T, seed=SEED + 19):
    """(K9 conf, x, carry, Channelizer) of a K9_WIDE shape: Kaiser taps, seeded
    samples and a random carry."""
    wb = {"M": M, "taps_per_branch": K, "beta": 9.0}
    x, st = k9_inputs(wb, T, seed)
    return wb, x, st, pch.Channelizer(M, K, 9.0, device="cuda")


def k9w_ptxas():
    """ptxas's report of the wide form's instantiations: [(M, NT, MB, TT, C,
    TR, span, registers, stack bytes, spill stores, spill loads)]."""
    count = sum(1 + (row[-1] > 0) for row in pch.k9_wide_layouts().values())
    return ptxas_report("channelizer_wide.cu", r"channelize_wideILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                        r"ELi(\d+)ELi(\d+)ELb([01])EE", count)


def check_channelize_wide():
    """K9's wide form at K9_WIDE and its split form at K9_SPLIT against the
    plain version with a random carry: y within K9_REL of max|y|, the carry
    equal; two half hops through the carry within K9_REL of max|y| of one
    hop, the carry after them equal; a call one launch (``channelize``
    counts one, ``channelize_wide`` one for the wide form). Returns [(M, K,
    T, form, max abs err, relative err, halves' relative err)]."""
    out = []
    for M, K, T in K9_WIDE + K9_SPLIT:
        form = pch.k9_plan(M, K)["form"]
        assert form == ("split" if (M, K, T) in K9_SPLIT else "wide"), \
            f"K9 ({M}, {K}) takes the {form} form"
        _, x, st, ch = k9_wide_inputs(M, K, T)
        before = pch.channelize.launches, pch.channelize_wide.launches
        yk, sk = pch.channelize(x, ch.h2, st)
        counted = pch.channelize.launches - before[0], pch.channelize_wide.launches - before[1]
        assert counted == (1, int(form == "wide")), f"K9 ({M}, {K}): launches counted {counted}"
        yp, sp = pch.channelize_plain(x, ch.h2, st)
        half = T // 2 * M
        y1, s1 = pch.channelize(x[:half], ch.h2, st)
        y2, s2 = pch.channelize(x[half:], ch.h2, s1)
        torch.cuda.synchronize()
        err, scale = float((yk - yp).abs().max()), float(yp.abs().max())
        rel_h = float((torch.cat([y1, y2], 1) - yp).abs().max()) / scale
        tag = f"K9 {form} M={M} K={K} T={T}"
        assert err <= K9_REL * scale and rel_h <= K9_REL, f"{tag}: err {err / scale}, halves {rel_h}"
        assert torch.equal(sk, sp) and torch.equal(s2, sp), f"{tag}: the carry differs"
        out.append((M, K, T, form, err, err / scale, rel_h))
    return out


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


def main_path_tracking(spec):
    """The LEO search-and-track loop (BASELINE #3) at the flagship spec with
    ``tracking_conf()`` over a TRACK_BLOCKS-block S-curve pass at
    TRACK_SNR_DB, sized as bench/subsystems.py:92-148 sizes it: the kernel
    tracker and the plain tracker give equal modes and equal bits block by
    block; it locks; K1-K5 launch. Returns the first lock block, the lock
    fraction after it, the median error in bins, and the two trackers."""
    tc = tracking_conf()
    bin_hz = spec.sampleRate / spec.Nfft
    f_max, tau = s_curve_swing(spec, TRACK_BLOCKS, tc["track_span_bins"])
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


#: K4s's nd in phase 3: the whole bank and its halves and quarters
SPLIT_NDS = (1, 2, 4)


def check_split_detector(spec, consts, B):
    """K4l on the whole bank, its halves and its quarters, and K4s on the
    gathered pairs, against their plain versions on the card: the packed
    pairs and the rows equal (values, keys, symbols, centres, trust with
    the clip window), one launch a call. Without a centre-bit LUT K4s runs
    its NRZ-S form (K4n in its launch), against K4s's plain version then
    ``nrzs_rows_plain``. At nd = 1
    the rows' bits, symbols, centres and mags equal K4's (centre-bit LUT).
    Returns (nd -> slots set to trust -2, slots the upper half won, the K4l
    plan, nd -> the K4s plan)."""
    inp = kernel_inputs(spec, consts, B)
    kw = k4l_kwargs(spec)
    kw4 = k4_kwargs(spec, consts)
    S, L = spec.numSymMax, packed_len(spec)
    sp, co, hits = inp["spSym"], inp["codeOffset"], inp.get("hits")
    clipped, split = {}, 0
    for nd in SPLIT_NDS:
        cols = shard_columns(spec, consts, inp, nd)
        Ml = spec.num_masks // nd
        before = dk.symbol_detect_local.launches
        pk = torch.stack([dk.symbol_detect_local(cm, ca, sp, co, m0=d * Ml, packed=True, **kw)
                          for d, (cm, ca) in enumerate(cols)])
        assert dk.symbol_detect_local.launches == before + nd
        pp = torch.stack([dk.pack_pairs(*dk.symbol_detect_local_plain(cm, ca, sp, co, m0=d * Ml,
                                                                     **kw))
                          for d, (cm, ca) in enumerate(cols)])
        torch.cuda.synchronize()
        assert torch.equal(pk, pp), f"K4l B={B} nd={nd}: pairs differ from the plain version's"
        sel = dict(kw4, M=spec.num_masks, code_val=inp["code_val"], hits=hits)
        rp = dk.shard_select_rows_plain(*dk.pair_views(pp), sp, co, consts.bitLUT, **sel,
                                        row=torch.zeros((B, L), device="cuda"))
        if consts.bitLUT is None:
            rp = dk.nrzs_rows_plain(rp, consts.symbolLUT, S)
            rk = dk.shard_select_nrzs(pk, sp, co, consts.symbolLUT, **sel,
                                      row=torch.zeros((B, L), device="cuda"))
        else:
            rk = dk.shard_select(pk, sp, co, consts.bitLUT, **sel,
                                 row=torch.zeros((B, L), device="cuda"))
        torch.cuda.synchronize()
        assert torch.equal(rk, rp), f"K4s B={B} nd={nd}: rows differ from the plain version's"
        clipped[nd] = int((rk[:, S:2 * S] == dk.TRUST_CLIPPED).sum())
        if nd == 2:
            split = int((rk[:, 2 * S:3 * S] >= Ml).sum())
        if hits is not None:
            assert clipped[nd] > 0, f"K4s B={B}: no slot met the clip window"
        if consts.bitLUT is None:
            assert bool((rk[:, S:2 * S] == -1).any()), f"K4s NRZ-S form B={B}: no trust -1"
        if nd == 1 and consts.bitLUT is not None:
            k4 = dk.symbol_detect(inp["colmax"], inp["colarg"], sp, co, consts.bitLUT, **kw4,
                                  hits=hits)
            for j, name in enumerate(("symbols", "centres", "mags", "bits")):
                i = PACK_ARRAYS.index(name)
                assert torch.equal(rk[:, i * S:(i + 1) * S], k4[j].float()), \
                    f"K4l + K4s at nd = 1: {name} differ from K4's"
    return clipped, split, dk.k4_plan(B, S), {nd: dk.k4s_plan(B, S, nd) for nd in SPLIT_NDS}


def generic_blocks(spec, C, seed=SEED + 60):
    """C flagship blocks of seeded GFSK, each with its own bits, Doppler
    offset (-DOPPLER_HZ .. +DOPPLER_HZ) and noise; returns (blocks complex64,
    sent bits per channel, the offsets)."""
    dopp = [DOPPLER_HZ * (2.0 * c / max(C - 1, 1) - 1.0) for c in range(C)]
    out = [signal_stream(spec, spec.Nfft, seed=seed + c, doppler_hz=dopp[c]) for c in range(C)]
    return np.stack([o[0] for o in out]), [o[1] for o in out], dopp


def generic_bpsk_blocks(spec, C, seed=SEED + 70):
    """C bench_BPSK blocks of seeded NRZ-S BPSK (``bpsk_stream``), each with
    its own bits, Doppler offset (-DOPPLER_HZ .. +DOPPLER_HZ) and noise;
    returns (blocks complex64, sent bits per channel, the offsets)."""
    rng = np.random.RandomState(seed)
    dopp = [DOPPLER_HZ * (2.0 * c / max(C - 1, 1) - 1.0) for c in range(C)]
    sent = [rng.randint(0, 2, spec.Nfft // int(spec.spsym) + 8) for _ in range(C)]
    return np.stack([bpsk_stream(spec, sent[c], spec.Nfft, seed=seed + c, doppler_hz=dopp[c])
                     for c in range(C)]), sent, dopp


def main_path_generic(spec, path="generic"):
    """Phase 4i: ``build_sharded_demod_step(force_generic=True)`` on the
    one-card mesh at C=GENERIC_C (with the vote), on the flagship's GFSK
    (``path`` "generic") or on bench_BPSK's NRZ-S ("generic_bpsk", the
    NRZ-S bits after the cross-shard select): the path's kernels launch, K4
    does not; bits, symbols and centres equal the channel-parallel step's
    on every channel; decisions and the voted pair equal the plain generic
    step's; BER < 1e-3 and the Doppler offset within baud/2 on every
    channel."""
    make = generic_bpsk_blocks if path == "generic_bpsk" else generic_blocks
    blocks, sent, dopp = make(spec, GENERIC_C)
    x = torch.from_numpy(blocks).cuda()
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=["cuda"])
    gen = build_sharded_demod_step(spec, mesh, force_generic=True)
    ops.reset_launches()
    res = gen(x)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches(path, launches)
    if path == "generic_bpsk":
        assert launches["shard_select_nrzs"] == launches["shard_select"] == \
            launches["symbol_detect_local"] == 1, f"{path}: K4s's NRZ-S form: {launches}"
    fast = build_sharded_demod_step(spec, mesh)(x)
    plain = build_sharded_demod_step(spec, mesh, force_generic=True, plain=True)(x)
    torch.cuda.synchronize()
    for k in ("bits", "symbols", "centres"):
        assert torch.equal(res[k], fast[k]), f"{path}: {k} differ from the channel-parallel step's"
    for k in DECISIONS + ("bits_voted", "trust_voted"):
        assert torch.equal(res[k], plain[k]), f"{path}: {k} differ from the plain step's"
    out = {k: v.cpu().numpy() for k, v in res.items()}
    bers = []
    for c in range(GENERIC_C):
        ber, lag = best_aligned_ber(out["bits"][c, :out["nBits"][c]].astype(np.int64), sent[c])
        off = float(out["freq_offset_hz"][c])
        assert ber < 1e-3, f"{path} channel {c}: BER {ber} at lag {lag}"
        assert abs(off - dopp[c]) < spec.baudRate / 2, f"{path} channel {c}: {off} Hz vs {dopp[c]}"
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
    and one colargmax word a slot read, spSym and codeOffset; the (value,
    key) pair written (8 bytes a slot) | W compares and ~8 slot operations
    a slot."""
    N, S, W = spec.Nfft, spec.numSymMax, spec.windowWidth
    return bound_of(B * (4 * min(S * W, N) + 4 * S + 8 + 8 * S), B * S * (W + 8))


def k4s_bound(spec, B, nd, clip=False):
    """K4s's least time: nd (value, key) pairs read and the five arrays
    written a slot (8 nd + 20 bytes), the scalars, (clip) the hit bitmask |
    2 nd compares and ~12 operations a slot."""
    N, S = spec.Nfft, spec.numSymMax
    return bound_of(B * (S * (8 * nd + 20) + 36 + (N // 8 if clip else 0)),
                    B * S * (2 * nd + 12))


def k4s_nrzs_bound(spec, B, nd):
    """K4s's NRZ-S form's least time: K4s's bytes (``k4s_bound``) and the
    LUT once | K4s's operations and 2K compares a slot."""
    S = spec.numSymMax
    M, _, K = spec.symbolLUT.shape
    return bound_of(B * (S * (8 * nd + 20) + 36) + 8 * M * K, B * S * (2 * nd + 12 + 2 * K))


def split_pairs(spec, consts, inp, nd):
    """The (nd, B, S, 2) pairs of the bank split nd ways (``shard_columns``),
    by K4l's plain version."""
    Ml = spec.num_masks // nd
    return torch.stack([dk.pack_pairs(*dk.symbol_detect_local_plain(
        cm, ca, inp["spSym"], inp["codeOffset"], m0=d * Ml, **k4l_kwargs(spec)))
        for d, (cm, ca) in enumerate(shard_columns(spec, consts, inp, nd))])


#: K4s's nd in phase 5
TIMED_NDS = (1, 2)


def time_slice6(spec, consts, bspec, bconsts):
    """K4l (the whole bank, the one-card generic path's shape), K4s at nd =
    1 and 2 (the whole bank and its halves) on the flagship, and K4s's NRZ-S
    form at nd = 1 on bench_BPSK, at B=1/16/64: name -> {B: (ms, plain_ms,
    (bound ms, by), device ms)} ("shard_select" by nd first); the generic
    step against the channel-parallel step at C=GENERIC_C on the same blocks
    (ms per call)."""
    out = {"symbol_detect_local": {}, "shard_select": {nd: {} for nd in TIMED_NDS},
           "shard_select_nrzs": {}}
    kw = k4l_kwargs(spec)
    for B in BATCHES:
        inp = kernel_inputs(spec, consts, B)
        a = (inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"])
        out["symbol_detect_local"][B] = (
            cuda_ms(lambda: dk.symbol_detect_local(*a, m0=0, **kw)),
            cuda_ms(lambda: dk.symbol_detect_local_plain(*a, m0=0, **kw)), k4l_bound(spec, B),
            device_ms(lambda: dk.symbol_detect_local(*a, m0=0, **kw), "symbol_detect_local"))
        for nd in TIMED_NDS:
            pairs = split_pairs(spec, consts, inp, nd)
            k4s = dict(k4_kwargs(spec, consts), M=spec.num_masks, code_val=inp["code_val"],
                       row=torch.empty((B, packed_len(spec)), device="cuda"))
            s4 = (inp["spSym"], inp["codeOffset"], consts.bitLUT)
            fn = lambda: dk.shard_select(pairs, *s4, **k4s)
            out["shard_select"][nd][B] = (
                cuda_ms(fn), cuda_ms(lambda: dk.shard_select_rows_plain(
                    *dk.pair_views(pairs), *s4, **k4s)),
                k4s_bound(spec, B, nd), device_ms(fn, "shard_select"))
        inp = kernel_inputs(bspec, bconsts, B, x=bpsk_blocks(bspec, B, np.random.RandomState(
            SEED + B)))
        pairs = split_pairs(bspec, bconsts, inp, 1)
        k4s = dict(k4_kwargs(bspec, bconsts), M=bspec.num_masks, code_val=inp["code_val"],
                   row=torch.empty((B, packed_len(bspec)), device="cuda"))
        s4 = (inp["spSym"], inp["codeOffset"])
        fn = lambda: dk.shard_select_nrzs(pairs, *s4, bconsts.symbolLUT, **k4s)
        out["shard_select_nrzs"][B] = (
            cuda_ms(fn), cuda_ms(lambda: dk.nrzs_rows_plain(dk.shard_select_rows_plain(
                *dk.pair_views(pairs), *s4, None, **k4s), bconsts.symbolLUT, bspec.numSymMax)),
            k4s_nrzs_bound(bspec, B, 1), device_ms(fn, "shard_select_nrzs"))
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


def time_k9(wb, N, seed=SEED + 9):
    """K9 at M x N in the form ``k9_plan`` picks (kernel, plain version,
    device ms: every __global__ of the form, the split form's FIR kernel
    alone) beside its bound and its two-call yardstick: a grouped ``conv1d``
    over the branches and ``torch.fft.fft`` across them, TF32 off (ms,
    relative err against K9)."""
    M, K = wb["M"], wb["taps_per_branch"]
    x, st = k9_inputs(wb, N, seed)
    ch = pch.Channelizer(M, K, wb["beta"], device="cuda")
    plan = pch.k9_plan(M, K)
    kernel = {"wide": "channelize_wide", "split": "channelize_split"}.get(plan["form"],
                                                                          "channelize")
    k9 = (cuda_ms(lambda: pch.channelize(x, ch.h2, st, tw=ch.tw)),
          cuda_ms(lambda: pch.channelize_plain(x, ch.h2, st), iters=5, reps=5),
          device_ms(lambda: pch.channelize(x, ch.h2, st, tw=ch.tw), kernel))
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
    assert e <= 1e-5, f"K9 yardstick disagrees with K9 at M={M}, K={K}: {e}"
    return dict(k9=k9, k9_bound=k9_bound(wb, N), yardstick_ms=cuda_ms(yardstick),
                yardstick_err=e, plan=plan)


def time_slice5(wb, spec, tracker, xb):
    """K9 at the wideband shape and at the vote's M=4 (``time_k9``); the
    wideband chain (K9 plus the step at C=64, vote off) per hop; the
    tracker's acquire and track graphs per block at B=1 (CUDA events)."""
    M, K, N = wb["M"], wb["taps_per_branch"], spec.Nfft
    out = time_k9(wb, N)
    out["vote"] = time_k9(dict(wb, M=WB_VOTE_C), N)
    x, _ = k9_inputs(wb, N)
    ch = pch.Channelizer(M, K, wb["beta"], device="cuda")
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=["cuda"])
    step = build_sharded_demod_step(spec, mesh, vote=False)
    y = ch(x)[0]
    chain_ms = cuda_ms(lambda: step(ch(x)[0]), iters=5, reps=5)
    step_ms = cuda_ms(lambda: step(y), iters=5, reps=5)
    centre = 3
    acq_ms = cuda_ms(lambda: tracker._acquire(xb[0]), iters=10)
    trk_ms = cuda_ms(lambda: tracker._track(xb[0], centre), iters=10)
    wide = {(Mw, Kw, Tw): time_k9({"M": Mw, "taps_per_branch": Kw, "beta": 9.0}, Tw, SEED + 19)
            for Mw, Kw, Tw in K9_WIDE + K9_SPLIT}
    direct = {}
    for Md, Kd, Td in K9_DIRECT:
        assert pch.k9_plan(Md, Kd)["form"] == "direct", f"K9 ({Md}, {Kd}) is no direct shape"
        wbd, xd, std, chd = k9_wide_inputs(Md, Kd, Td)
        direct[Md, Kd, Td] = (cuda_ms(lambda: pch.channelize(xd, chd.h2, std, tw=chd.tw)),
                              device_ms(lambda: pch.channelize(xd, chd.h2, std, tw=chd.tw),
                                        "channelize"),
                              cuda_ms(lambda: pch.channelize_wide(xd, chd.h2, std, tw=chd.tw)),
                              device_ms(lambda: pch.channelize_wide(xd, chd.h2, std, tw=chd.tw),
                                        "channelize_wide"),
                              k9_bound(wbd, Td),
                              cuda_ms(lambda: pch.channelize_plain(xd, chd.h2, std), iters=5,
                                      reps=5))
    return dict(out, k9_wide=wide, k9_direct=direct, chain_ms=chain_ms, step_ms=step_ms,
                acquire_ms=acq_ms, track_ms=trk_ms)


def check_bounds(t, bnd, B, label):
    """A lower bound that a measured time beats counts the wrong work."""
    for k, (ms, pms, lms) in t.items():
        for what, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms)):
            assert v is None or v >= bnd[k][0], \
                f"{label} B={B} {k}: {what} {v} is below bound_ms {bnd[k][0]}"


def time_kernels(spec, consts, B):
    """name -> (ms, plain_ms, library_ms or None) at batch B for the
    kernels of the spec's path; the whole graph and the plain path; the
    bins K5's SNR bands read; name -> the kernel's device ms a call."""
    inp = kernel_inputs(spec, consts, B)
    M, N = spec.num_masks, spec.Nfft
    off = spec.code_search_mask_offset
    lo, hi = spec.code_idx_lo, spec.code_idx_hi
    Y = dk._rolled(inp["S"], inp["shift"])[:, None, :] * consts.masks_f[None]
    kw = k4_kwargs(spec, consts)
    args4 = (inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"], consts.bitLUT)
    hits = inp.get("hits")
    t, calls = {}, {}
    if spec.doppler_search:
        idx = (torch.arange(N, device="cuda")[None, :] + consts.shifts.long()[:, None]) % N
        Pg = inp["P"][:, idx]
        QT = consts.Q.T.contiguous()
        calls["doppler_energy"] = lambda: ds.doppler_energy(inp["P"], consts.Q, consts.shifts)
        t["doppler_energy"] = (
            cuda_ms(calls["doppler_energy"]),
            cuda_ms(lambda: ds.doppler_energy_plain(inp["P"], consts.Q, consts.shifts)),
            cuda_ms(lambda: torch.matmul(Pg, QT)))
        a5, kw5 = k5_args(spec, consts, inp["E"], inp["P"])
        calls["doppler_estimate"] = lambda: ds.doppler_estimate(*a5, **kw5)
        t["doppler_estimate"] = (cuda_ms(calls["doppler_estimate"]),
                                 cuda_ms(lambda: ds.doppler_estimate_plain(*a5, **kw5)), None)
        band_bins = snr_band_bins(spec, consts, inp["dopp_idx"])
    else:
        scale = consts.threshold_scale
        calls["threshold_input"] = lambda: dk.threshold_input(inp["x"], scale)
        t["threshold_input"] = (cuda_ms(calls["threshold_input"]),
                                cuda_ms(lambda: dk.threshold_input_plain(inp["x"], scale)), None)
        band_bins = 0
    calls["mf_bank_colreduce"] = lambda: dk.mf_bank_colreduce(
        inp["S"], consts.masks_f, inp["shift"], off, M - off, tw=consts.tw)
    t["mf_bank_colreduce"] = (
        cuda_ms(calls["mf_bank_colreduce"]),
        cuda_ms(lambda: dk.mf_bank_colreduce_plain(inp["S"], consts.masks_f, inp["shift"],
                                                   off, M - off)),
        cuda_ms(lambda: torch.fft.ifft(Y, norm="forward")))
    calls["timing_band"] = lambda: dk.timing_band(inp["colsum"], lo, hi, tw=consts.tw)
    t["timing_band"] = (
        cuda_ms(calls["timing_band"]),
        cuda_ms(lambda: dk.timing_band_plain(inp["colsum"], lo, hi)),
        cuda_ms(lambda: torch.fft.rfft(inp["colsum"])))
    calls["symbol_detect"] = lambda: dk.symbol_detect(*args4, hits=hits, **kw)
    t["symbol_detect"] = (
        cuda_ms(calls["symbol_detect"]),
        cuda_ms(lambda: dk.symbol_detect_plain(*args4, clip_mask=k4_plain_clip(spec, inp), **kw)),
        None)
    graph = build_process_batch(spec, device="cuda", packed=True)
    plain = build_process_batch(spec, device="cuda", packed=True, plain=True)
    whole = (cuda_ms(lambda: graph(inp["x"]), iters=10),
             cuda_ms(lambda: plain(inp["x"]), iters=5, reps=5))
    return t, whole, band_bins, {k: device_ms(fn, k) for k, fn in calls.items()}


def time_big(spec, consts):
    """K2 (with its middle pass) and K3 at the big path's shape (Nfft
    2^BIG_BLOCK_SIZE), B=1 and BIG_B, on ``kernel_inputs``; K6's long form
    at N = 2^19, B=1 and 16, on ``spiky_blocks``: name -> {B: (ms, plain_ms,
    library_ms, (bound ms, by), device ms)}; and the big block graph's ms a
    call at BIG_B (CUDA events)."""
    out = {"mf_bank_colreduce": {}, "timing_band": {}, "threshold_input": {}}
    M, off = spec.num_masks, spec.code_search_mask_offset
    lo, hi = spec.code_idx_lo, spec.code_idx_hi
    for B in (1, BIG_B):
        inp = kernel_inputs(spec, consts, B)
        bnd = bounds(spec, B)
        Y = dk._rolled(inp["S"], inp["shift"])[:, None, :] * consts.masks_f[None]
        k2 = lambda: dk.mf_bank_colreduce(inp["S"], consts.masks_f, inp["shift"], off, M - off,
                                          tw=consts.tw)
        out["mf_bank_colreduce"][B] = (
            cuda_ms(k2, iters=5),
            cuda_ms(lambda: dk.mf_bank_colreduce_plain(inp["S"], consts.masks_f, inp["shift"],
                                                       off, M - off), iters=5, reps=5),
            cuda_ms(lambda: torch.fft.ifft(Y, norm="forward"), iters=5),
            bnd["mf_bank_colreduce"], device_ms(k2, "mf_bank_multipass", calls=5))
        del Y
        k3 = lambda: dk.timing_band(inp["colsum"], lo, hi, tw=consts.tw)
        out["timing_band"][B] = (
            cuda_ms(k3, iters=5),
            cuda_ms(lambda: dk.timing_band_plain(inp["colsum"], lo, hi), iters=5, reps=5),
            cuda_ms(lambda: torch.fft.rfft(inp["colsum"]), iters=5),
            bnd["timing_band"], device_ms(k3, "timing_band", calls=5))
    N6 = 2 ** 19
    for B in (1, 16):
        x = spiky_blocks(B, N6, SEED + B)
        k6 = lambda: dk.threshold_input(x, 4.5)
        out["threshold_input"][B] = (
            cuda_ms(k6), cuda_ms(lambda: dk.threshold_input_plain(x, 4.5), iters=5, reps=5), None,
            bound_of(*k6_work(N6, B)), device_ms(k6, "threshold_long"))
    graph = build_process_batch(spec, device="cuda", packed=True)
    xb = signal_blocks(spec, BIG_B)
    out["graph_ms"] = cuda_ms(lambda: graph(xb), iters=3, reps=5)
    return out


def viterbi_bound(lengths, decode):
    """(ms, by) of K7's least time: the symbols read (8 B a step) and the
    bits and metrics written, against the f32 operations of the sweep (per
    step: 4 branch metrics of 3 ops, 128 candidate adds, 64 compares, 63
    for the minimum, 64 subtractions, 1 add to the total)."""
    steps, S = sum(lengths), len(lengths)
    nbytes = 8 * steps + 4 * S + 8 * S + (steps if decode else 0)
    return bound_of(nbytes, steps * (4 * 3 + 128 + 64 + 63 + 64 + 1))


def viterbi_chain_ms(lengths, max_mhz):
    """An estimate, not a bound, of K7's serial time: the longest sequence's
    steps, each VIT_CHAIN_OPS dependent ALU operations of VIT_CYCLES_PER_OP
    cycles (redux.sync left out), at the card's maximum SM clock ``max_mhz``."""
    return max(lengths) * VIT_CHAIN_OPS * VIT_CYCLES_PER_OP / (max_mhz * 1e3)


#: K7's timed shapes (soft ±1/0 symbols, streaming), key -> (lengths,
#: decode): by S, as the kernels line's ``by_S`` has them (S=2 is the
#: node-sync pair, metric-only); and beside them the feed's one launch and
#: S=1 metric-only, which against S=1 decode parts the sweep from the
#: traceback
VIT_BY_S = {1: (VIT_DECODE, True), 2: (VIT_SYNC, False), 64: (VIT_BATCH, True)}
VIT_MORE = {"3 decode": (VIT_FEED, True), "1 metric": (VIT_DECODE, False)}


def time_viterbi(shapes):
    """K7 at ``shapes`` (key -> (lengths, decode)): key -> (ms, plain_ms,
    (bound ms, by), lengths, device ms)."""
    out = {}
    for key, (lengths, decode) in shapes.items():
        x = viterbi_inputs("soft_pm1", lengths)
        kw = dict(soft=True, terminated=False, decode=decode)
        out[key] = (cuda_ms(lambda: vit.viterbi_sweep(x, lengths, **kw)),
                    cuda_ms(lambda: vit.viterbi_sweep_plain(x, lengths, **kw),
                            iters=1, reps=3),
                    viterbi_bound(lengths, decode), lengths,
                    device_ms(lambda: vit.viterbi_sweep(x, lengths, **kw), "viterbi"))
    return out


def viterbi_rows(times):
    """time_viterbi's times as the kernels line gives them: key -> T, ms,
    plain_ms, bound_ms, bound_by, ns a step and device_ms."""
    return {key: {"T": max(v[3]), "ms": v[0], "plain_ms": v[1], "bound_ms": v[2][0],
                  "bound_by": v[2][1], "ns_per_step": 1e6 * v[0] / max(v[3]),
                  "device_ms": v[4]}
            for key, v in times.items()}


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


def vote_bound(C, S):
    """K8's least time: each row's bits and trust read, the pair written
    (C S 8 + S 8 bytes) | about 6 operations a (channel, slot)."""
    return bound_of(C * S * 8 + S * 8, 6 * C * S)


def nrzs_form_bound(spec, B):
    """K4's NRZ-S form's least time: K4's windows (at most N samples), one
    colargmax read a slot and the clip bitmask in, the row's five f32 arrays
    (20 bytes a slot) and scalars out, the LUT once | K4's operations and
    2K compares a slot."""
    N, W, S = spec.Nfft, spec.windowWidth, spec.numSymMax
    M, _, K = spec.symbolLUT.shape
    return bound_of(B * (4 * min(S * W, N) + 4 * S + 20 * S + 24 + N // 8) + 8 * M * K,
                    B * S * (W + 8 + 2 * K))


def time_slice4(bspec, bconsts, fspec):
    """K4's NRZ-S form at B=1/16/64 on ``nrzs_form_inputs`` (with K4 alone
    into the row beside it, device ms) and the bench_BPSK block graph (wall
    ms and device busy ms a call), and K8 at C=3/16/64 on the flagship rows:
    name -> {B or C: (ms, plain_ms, (bound ms, by), device ms)}; and the
    group graph at C=3 against the block graph at B=3 on the same blocks (ms
    per call), which gives the vote's share."""
    out = {"symbol_detect_nrzs": {}, "vote": {}, "bpsk_graph": {}, "k4_alone": {}}
    L = packed_len(bspec)
    graph = build_process_batch(bspec, device="cuda", packed=True)
    for B in BATCHES:
        inp = nrzs_form_inputs(bspec, bconsts, B)
        row = torch.zeros((B, L), device="cuda")
        fused = lambda: nrzs_form_call(bspec, bconsts, inp, row)
        out["symbol_detect_nrzs"][B] = (
            cuda_ms(fused), cuda_ms(lambda: nrzs_form_plain(bspec, bconsts, inp, row)),
            nrzs_form_bound(bspec, B), device_ms(fused, "symbol_detect_nrzs"))
        out["k4_alone"][B] = device_ms(lambda: dk.symbol_detect(
            inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"], None,
            **k4_kwargs(bspec, bconsts), hits=inp["hits"], row=row, code_val=inp["code_val"]),
            "symbol_detect")
        x = bpsk_blocks(bspec, B, np.random.RandomState(SEED + B))
        wall, busy, _, _ = profile_calls(lambda: graph(x))
        out["bpsk_graph"][B] = (cuda_ms(lambda: graph(x), iters=10), busy, wall)
    L, S = packed_len(fspec), fspec.numSymMax
    for C in VOTE_CS:
        rows, _ = vote_input(C, S, L)
        o = torch.empty((2, S), device="cuda")
        out["vote"][C] = (cuda_ms(lambda: pv.vote_rows(rows, S, 1.2, o)),
                          cuda_ms(lambda: pv.vote_rows_plain(rows, S, 1.2, o)),
                          vote_bound(C, S), device_ms(lambda: pv.vote_rows(rows, S, 1.2, o), "vote"))
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


def kernel_entry(name, t, bnd, dev):
    ms, pms, lms = t[name]
    return {"ms": ms, "plain_ms": pms, "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
            "library_ms": lms, "device_ms": dev[name]}


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
        for line in plan_lines(cfg[p][2]):
            say("kernels", f"{p} geometry: {line}")
        for B in (1, 16):
            e = check_kernels(cfg[p][2], consts[p], B)
            errs.update({k: max(errs[k], v) for k, v in e.items()})
            say("kernels", f"{p} B={B} vs plain OK, max abs err " + json.dumps(e))
        e = check_bank_band(cfg[p][2], consts[p], kernel_inputs(cfg[p][2], consts[p], 64))
        errs.update({k: max(errs[k], v) for k, v in e.items()})
        say("kernels", f"{p} B=64 K2, K3 vs plain OK (the last block alone equal to its row "
                       f"in the batch), max abs err " + json.dumps(e))
    cfg["cc11xx"] = cc11xx_configuration()
    # the three Rx children of phase 4n run bench_3_chan_rx.json's shape
    station = {"cc11xx": cfg["cc11xx"], "combiner": three_station_configuration()}
    for p, (_, _, sspec, _) in station.items():
        consts[p] = DeviceConsts.from_spec(sspec, torch.device("cuda"))
        for line in plan_lines(sspec):
            say("kernels", f"{p} geometry: {line}")
        sh = sspec.dopp_shifts
        for B in BATCHES:
            e, (nwin, nglob), rel = check_station_kernels(sspec, consts[p], B, p)
            errs.update({k: max(errs[k], v) for k, v in e.items()})
            say("kernels", f"{p} B={B} ({STATION_CONFIGS[p]}: Nfft {sspec.Nfft}, spsym "
                           f"{sspec.spsym:g}, S {sspec.numSymMax}, K3's band [{sspec.code_idx_lo}, "
                           f"{sspec.code_idx_hi}), D={sspec.D} shifts {int(sh.min())}-"
                           f"{int(sh.max())} about bin {sspec.dopp_offset_idx}, M={sspec.num_masks}) "
                           f"K1-K5 vs plain OK: K1 {nwin} window group(s), {nglob} global-read "
                           f"group(s), max err {rel:.3e} of max|E| (bar {K1_REL}); K4 plan "
                           f"{dk.k4_plan(B, sspec.numSymMax)}; every block alone == its row (K1, "
                           f"K4, K5; K2, K3 the last); max abs err " + json.dumps(e))
    for soft, decode, regs, stack, st, ld in viterbi_ptxas():
        say("kernels", f"K7 viterbi<soft={soft}, decode={decode}> ptxas: {regs} registers, "
                       f"{stack} bytes stack frame, {st} bytes spill stores, {ld} bytes spill loads")
        assert st == ld == 0, f"K7 viterbi<soft={soft}, decode={decode}> spills"
    for nt, tg, regs, stack, st, ld in doppler_energy_ptxas():
        name = f"doppler_energy_k<NT={nt}, TG={tg}>"
        say("kernels", f"K1 {name} ptxas: {regs} registers, {stack} bytes stack frame, {st} "
                       f"bytes spill stores, {ld} bytes spill loads")
        assert st == ld == 0, f"K1 {name} spills"
    for spt, argwin, vec, nrzs, regs, stack, st, ld in symbol_detect_ptxas():
        name = f"symbol_detect<SPT={spt}, argwin={argwin}, vec={vec}, nrzs={nrzs}>"
        say("kernels", f"K4 {name} ptxas: {regs} registers, {stack} bytes stack frame, {st} "
                       f"bytes spill stores, {ld} bytes spill loads")
        assert st == ld == 0, f"K4 {name} spills"
    hmma = k1_sass()
    if hmma is None:
        say("kernels", "K1 SASS: no cuobjdump in the toolkit, not read")
    else:
        say("kernels", f"K1 SASS (cuobjdump -sass): tensor-core products {json.dumps(hmma)}")
        assert any(".TF32" in op for op in hmma), "K1: no TF32 HMMA in the SASS"
    errs["viterbi"], n_cases = check_viterbi()
    say("kernels", f"K7 viterbi vs plain OK on {n_cases} cases (bits equal), max abs metric "
                   f"err {errs['viterbi']}")
    per_feed = check_viterbi_stream()
    say("kernels", f"K7 ViterbiStream on the card == plain=True (bits, carry, pending, parity "
                   f"after every feed, hard and soft, a slip resynced); K7 launches per feed "
                   f"{per_feed}")
    bcfg = bpsk_configuration()
    bspec = bcfg[2]
    bconsts = DeviceConsts.from_spec(bspec, torch.device("cuda"))
    for B in BATCHES:
        plan, n1, n2 = check_nrzs_form(bspec, bconsts, B)
        say("kernels", f"K4 NRZ-S form (K4n in K4's launch) B={B} at the bench_BPSK shape (Nfft "
                       f"2^16, S {bspec.numSymMax}, LUT {tuple(bspec.symbolLUT.shape)}), plan "
                       f"{plan}, with a clip bitmask: rows equal to the plain version; one "
                       f"launch; slots trust -1 {n1}, trust -2 {n2}")
    errs["symbol_detect_nrzs"] = 0.0
    fspec = cfg["flagship"][2]
    for C in VOTE_CHECK_CS:
        for master in VOTE_MASTERS:
            errs["vote"] = check_vote(C, fspec.numSymMax, packed_len(fspec), master)
    say("kernels", f"K8 vote vs plain OK at C={list(VOTE_CHECK_CS)}, S={fspec.numSymMax}, master_idx "
                   f"{list(VOTE_MASTERS)}: masked rows and voted pair equal, pinned ties vote 0, "
                   f"disqualified slots trust -1; with the pad mask off (the generic step's "
                   f"vote) rows untouched and voted pair equal")
    wb = wideband_conf()
    for G, V, P, MS, MSV, TTP, staged, regs, stack, st, ld in k9_ptxas():
        assert (G, V, P, MS, MSV, TTP) == pch.k9_layouts()[G * V][:6], \
            f"K9 channelize<{G}, {V}, {P}, {MS}, {MSV}, {TTP}> is not k9_layouts' row"
        say("kernels", f"K9 channelize<G={G}, V={V}, P={P}, MS={MS}, MSV={MSV}, TTP={TTP}, "
                       f"staged={staged}> ptxas: {regs} registers, {stack} bytes stack frame, {st} "
                       f"bytes spill stores, {ld} bytes spill loads")
        assert st == ld == 0, f"K9 channelize<{G}, {V}, {P}, {staged}> spills"
    wbv = dict(wb, M=WB_VOTE_C)
    for w in (wb, wbv):
        M, K = w["M"], w["taps_per_branch"]
        k9_abs, k9_rel, halves_equal = check_channelize(w, fspec.Nfft)
        errs["channelize"] = max(errs["channelize"], k9_abs)
        say("kernels", f"K9 channelize vs plain OK at M={M}, K={K}, T={fspec.Nfft} with a random "
                       f"carry, plan {pch.k9_plan(M, K)}: max abs "
                       f"err {k9_abs:.3e}, {k9_rel:.3e} of max|y| (bar {K9_REL}); carry equal; two "
                       f"half hops == one hop (bit-equal: {halves_equal})")
    for form, cases in check_channelize_plan().items():
        worst = max(cases, key=lambda c: c[3])
        say("kernels", f"K9 {form} form vs plain OK at {len(cases)} shapes (M, K, T) "
                       f"{[c[:3] for c in cases]} with a random carry: at most {worst[3]:.3e} of "
                       f"max|y| (bar {K9_REL}, at {worst[:3]}); carry equal; halves through the "
                       f"carry within the bar")
    for M, NT, MB, TT, C, TR, span, regs, stack, st, ld in k9w_ptxas():
        assert (NT, MB, TT, C, TR) == pch.k9_wide_layouts()[M][:5], \
            f"K9 channelize_wide<{M}, {NT}, {MB}, {TT}, {C}, {TR}> is not k9_wide_layouts' row"
        say("kernels", f"K9 channelize_wide<M={M}, NT={NT}, MB={MB}, TT={TT}, C={C}, TR={TR}, "
                       f"span={span}> ptxas: {regs} registers, {stack} bytes stack frame, {st} "
                       f"bytes spill stores, {ld} bytes spill loads")
    for M, K, T, form, err, rel, rel_h in check_channelize_wide():
        if form == "wide":
            errs["channelize_wide"] = max(errs["channelize_wide"], err)
        else:
            errs["channelize"] = max(errs["channelize"], err)
        say("kernels", f"K9 {form} form vs plain OK at M={M}, K={K}, T={T} with a random carry, "
                       f"plan {pch.k9_plan(M, K)}: max abs err {err:.3e}, {rel:.3e} of max|y| (bar "
                       f"{K9_REL}); carry equal; two half hops through the carry {rel_h:.3e} of "
                       f"max|y| of one hop; one launch a call")
    for B in (1, 16):
        e1, e5 = check_recentre(fspec, consts["flagship"], B)
        errs["doppler_energy"] = max(errs["doppler_energy"], e1)
        errs["doppler_estimate"] = max(errs["doppler_estimate"], e5)
        say("kernels", f"K1, K5 with centre_shift {recentres(fspec.Nfft, B).tolist()} vs plain "
                       f"OK at B={B}: K1 max abs err {e1:.4g}, K5 {e5:.4g}")
    for label, N, D, M, nw, ng, rel in check_doppler_energy_grids(
            k1_specs(fspec, consts["flagship"], bconsts, consts["cc11xx"], consts["combiner"])):
        say("kernels", f"K1 {label} grid N={N} D={D} M={M}: {nw} window group(s), {ng} "
                       f"global-read group(s); vs plain OK at B={K1_BATCH} (with and without a "
                       f"recentre where the path has one), max err {rel:.3e} of max|E| (bar "
                       f"{K1_REL}); each block alone == its row, two runs bit-equal")
    rel = check_doppler_energy_batch(consts["flagship"])
    say("kernels", f"K1 flagship B=64 recentred: each block alone == its row of the batch, two "
                   f"runs bit-equal; max err {rel:.3e} of max|E|")
    for M, groups, rel in check_doppler_energy_deep(consts["flagship"]):
        say("kernels", f"K1 M={M} (xcorrMaskSize {M.bit_length() - 1}) at the flagship grid: "
                       f"{groups} launches of at most {ds.K1_MAX_MASKS} masks a call; vs plain "
                       f"OK at B={K1_BATCH} with and without a recentre, max err {rel:.3e} of "
                       f"max|E| (bar {K1_REL}); each block alone == its row, two runs bit-equal")
    e5, n5 = check_doppler_estimate_grids()
    errs["doppler_estimate"] = max(errs["doppler_estimate"], e5)
    say("kernels", f"K5 vs plain OK on {n5} cases (both mask forms of {len(K5_GRIDS)} grids: "
                   f"ties within a thread, a lane, across lanes and warps; nd 1, 31, 33, 64 of "
                   f"D=2048 at offset 0 and 1; D=3000; M=1, 64, 128 with and without a "
                   f"recentre), max abs err {e5:.4g}")
    dk64, dp64, dkp, qk, qp, moved = check_doppler_estimate_noise()
    say("kernels", f"K5 with noise alone in both SNR bands ({2 * len(K5_GRIDS)} cases, the band "
                   f"ratio near 1): every output but the SNR vs plain OK; the band ratio within "
                   f"f32 rounding of float64's, kernel {qk:.3g} and plain {qp:.3g} of the bound; "
                   f"SNR from float64: kernel {dk64:.4g} dB, plain {dp64:.4g} dB; kernel from "
                   f"plain {dkp:.4g} dB on the same bands; blocks on bands a bin apart: {moved}")
    for label, threads, spt, argwin, clipped in map(check_k4_case, K4_CASES):
        say("kernels", f"K4 {label} B=64 vs plain OK (every output equal, the row form, each "
                       f"block alone == its row, which runs the B=1 plan; {threads} threads x "
                       f"{spt} slots a CTA, colargmax with the windows: {argwin}; {clipped} "
                       f"slots trust -2)")
    for label, spec_, consts_ in (("flagship", fspec, consts["flagship"]),
                                  ("stx", cfg["stx"][2], consts["stx"]),
                                  ("bench_BPSK", bspec, bconsts)):
        for B in BATCHES:
            clipped, split, p4l, p4s = check_split_detector(spec_, consts_, B)
            half = spec_.num_masks // 2
            nrzs = " in its NRZ-S form (K4n in K4s's launch)" if consts_.bitLUT is None else ""
            say("kernels", f"K4l (plan {p4l}), K4s{nrzs} (plan {p4s}) vs plain OK at the {label} "
                           f"shape B={B} (M={spec_.num_masks}: the bank split {list(SPLIT_NDS)} "
                           f"ways): packed pairs and rows equal; slots the upper half "
                           f"[{half}, {spec_.num_masks}) won {split}; trust -2 slots {clipped}")
    errs["symbol_detect_local"] = errs["shard_select"] = errs["shard_select_nrzs"] = 0.0
    for N, plan, err in check_threshold_sizes():
        errs["threshold_input"] = max(errs["threshold_input"], err)
        say("kernels", f"K6 N={N} vs plain OK at B=3 (masks equal at clear samples, signal "
                       f"within rtol 1e-5, bits past N zero, a block alone == its row), max "
                       f"abs err {err:.4g}; " + k6_plan_line(N))
    say("kernels", f"K6's bitmask at N=4097 (a partial last word) into K4 and K4s (nd=1): "
                   f"every output and row equal to the plain versions'; "
                   f"{check_odd_clip()} slots trust -2")
    for M, K, n4, n4s in check_nrzs_big(bspec, bconsts):
        say("kernels", f"K4's and K4s's NRZ-S forms with a ({M}, 2, {K}) LUT "
                       f"({8 * M * K // 1024} KB, read through L1) vs plain OK at the bench_BPSK "
                       f"shape, B=1 and 16 (K4s on two shards of {M + 2} masks): rows equal; "
                       f"slots trust -1 {n4} (K4), {n4s} (K4s)")
    for N, f, e2, e3 in check_bank_band_big():
        errs["mf_bank_colreduce"] = max(errs["mf_bank_colreduce"], e2)
        errs["timing_band"] = max(errs["timing_band"], e3)
        say("kernels", f"K2 N={N} (factors {f}) and K3 vs plain OK at B={BIG_B}, the first and "
                       f"last block alone == their rows: K2 max abs err {e2:.4g}, K3 codeOffset "
                       f"{e3:.4g}")

    res = {"flagship": main_path_flagship(*cfg["flagship"]),
           "stx": main_path_stx(*cfg["stx"])}
    for p in res:
        say("main", f"{p} process x16 == processMany(16) == processCapture == plain path; "
                    + json.dumps(res[p]))
    res["deep"] = main_path_deep()
    say("main", f"deep flagship xcorrMaskSize {DEEP_MASK_SIZE} ({res['deep']['masks']} masks) "
                f"processMany({N_HOPS}) == plain path; " + json.dumps(res["deep"]))
    res["big"] = main_path_big()
    say("main", f"big flagship at Nfft 2^{BIG_BLOCK_SIZE} processMany({BIG_HOPS}) == plain path; "
                + json.dumps(res["big"]))
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
    res["generic_bpsk"] = main_path_generic(bspec, "generic_bpsk")
    say("main", f"generic step (force_generic, one card) on bench_BPSK C={GENERIC_C}: bits, "
                f"symbols, centres equal to the channel-parallel step's; decisions and voted pair "
                f"equal to the plain step's; BER < 1e-3 and Doppler within baud/2 per channel; "
                + json.dumps(res["generic_bpsk"]))
    ranks = main_path_ranks(fspec)
    say("main", f"generic step on {{\"channel\": 2, \"dopp\": 2}}: {RANKS} ranks on cuda:0 over "
                f"{ranks['backend']}, C={RANKS_C}: every rank within the golden table of the "
                f"one-process step, the voted pair equal on all ranks; " + json.dumps(ranks))
    say("main", f"slice-6 paths took {time.perf_counter() - t_s6:.1f} s")
    t_s17 = time.perf_counter()
    res["cc11xx"] = main_path_cc11xx()
    say("main", f"cc11xx (CC11xx.json) {CC11XX_PACKETS} packets through the port's Modulator at "
                f"{CC11XX_SNR_DB} dB a sample (Es/N0 {CC11XX_SNR_DB + 10 * math.log10(128):.2f} "
                f"dB): process x{res['cc11xx']['blocks']} == processMany(16) == processCapture "
                f"== plain path; raw BER < 1e-3; every payload CRC-clean byte for byte; K1-K5 "
                f"once a block, K6 never; " + json.dumps(res["cc11xx"]))
    res["gmsk"] = main_path_gmsk()
    say("main", f"bench_GMSK (blockSize {GMSK_BLOCK_SIZE}) processMany({N_HOPS}) == plain path; "
                f"packets equal to the payload; " + json.dumps(res["gmsk"]))
    say("main", f"slice-17 paths took {time.perf_counter() - t_s17:.1f} s")
    t_rt = time.perf_counter()
    runtime = main_path_runtime()
    say("main", f"runtime: PyCuSDR decoded the payload from bench_3_chan_rx.json (channel group), "
                f"bench_FSK.json (one demodulator child) and CC11xx.json (TxDataIn -> "
                f"Modulator_process -> AWGN -> RxInPort: Tx through Rx), Rx children on the card, in "
                f"{time.perf_counter() - t_rt:.1f} s; " + json.dumps(runtime))
    t_s18 = time.perf_counter()
    s18 = main_path_slice18()
    for key in ("combiner", "hamlib"):
        res[key] = {"launches": s18[key]["launches"]}
    c18, d18, h18 = s18["combiner"], s18["diversity"], s18["hamlib"]
    say("main", f"4n three-station Rx: PyCuSDR from bench_3_chan_rx.json as shipped (softCombiner "
                f"on, blockSize 15, three Demodulator_process children on the card) decoded the "
                f"payload fed at delays {list(COMBINER_DELAYS)} samples; get_active_workers "
                f"{c18['workers']}; {c18['voted_by_three']} of {c18['containers']} containers "
                f"voted by three; K1-K5 in every child; {c18['seconds']:.1f} s; " + json.dumps(c18))
    say("main", f"4n diversity: {DIVERSITY_HOPS} blocks at {DIVERSITY_SNR_DB} dB a sample "
                f"(Es/N0 {DIVERSITY_SNR_DB + 10 * math.log10(16):.2f} dB), channel BERs "
                f"{d18['channel_ber']}, voted BERs (each master) {d18['voted_ber']}: voted <= the "
                f"best channel's; {d18['seconds']:.1f} s; "
                + json.dumps({k: v for k, v in d18.items() if k not in ("round_ms", "buffered_bits")}))
    say("main", f"4o hamlib: serve_all booted CC11xx.json's modem on connect; chk_vfo, dump_state, "
                f"I/i; the modulator's rangerate within {h18['rangerate_rel_err']:.2e} of "
                f"rangerate_from_freq; the payload returned, Doppler {h18['doppler_hz']:.1f} Hz, "
                f"{h18['doppler_err_hz']:.1f} Hz from the steer's {h18['shift_hz']:.1f} Hz; children "
                f"gone {h18['children_exit_s']:.2f} s after the client left; a second modem "
                f"booted; {h18['seconds']:.1f} s; " + json.dumps(h18))
    say("main", f"slice-18 paths took {time.perf_counter() - t_s18:.1f} s")
    t_s19 = time.perf_counter()
    r19 = run_fresh(f"run_restart({RESTART_PORT}, {card!r})", "4p", RESTART_TIMEOUT_S)
    for who, m in r19["memory"].items():
        say("main", f"{card} | 4p memory {who}: {memory_text(m)}")
    res["restart"] = {"launches": r19["launches"]}
    say("main", f"4p planned restart: PyCuSDR from CC11xx.json with maxWorkerRssMb, "
                f"{r19['packets_sent']} packets paced over {r19['feed_s']:.1f} s at "
                f"{CC11XX_SNR_DB} dB a sample; the cap set to {r19['cap_mb']:.1f} MB between the "
                f"Rx child's anonymous RSS and the others'; one planned restart to "
                f"{r19['worker_ids'][1]}, "
                f"K1-K5 in both children while both lived and once a block in the replacement "
                f"({r19['blocks_new']} blocks); every packet delivered exactly once; the old "
                f"child gone (exit code {r19['old_exitcode']}); native forms in both Rx children "
                f"and the decoder, no numpy form; {time.perf_counter() - t_s19:.1f} s; "
                + json.dumps(r19))
    t_s21 = time.perf_counter()
    r21 = run_fresh(f"run_harnesses({HARNESS_PORT}, {card!r})", "4q", HARNESS_TIMEOUT_S)
    res["harnesses"] = {"launches": r21["launches"]}
    say("main", f"4q station harnesses (hw_selfcheck, ber_delta, ber, diversity, streaming_rt) "
                f"through their entry points, every child on the card: selfcheck PASS x5; "
                f"ber_delta arms equal; ber packets bit-exact; the voted arm delivered; "
                f"streaming_rt {r21['streaming_rt']['steady_decoded']} of "
                f"{r21['streaming_rt']['steady_scheduled']} steady packets bit-exact; K1-K5 "
                f"launched; steps {json.dumps(r21['steps_s'])}, {r21['seconds']:.1f} s of "
                f"steps, {time.perf_counter() - t_s21:.1f} s with the interpreter; "
                + json.dumps(r21))
    t_s22 = time.perf_counter()
    r22 = run_fresh(f"run_timers({TIMERS_PORT}, {card!r})", "4r", TIMERS_TIMEOUT_S)
    res["timers"] = {"launches": r22["launches"]}
    say("main", f"4r timing harnesses (profile_stages, subsystems, capture_probe, scaling, "
                f"hw_leak_probe) through their entry points on the card: every stage row clear "
                f"of its bound, the prefix rows within {100 * PREFIX_HELD:g}% of the graph's busy "
                f"time, the roofs under the datasheet's; tone purity "
                + ", ".join(f"{c['tone_purity']:.6f} (M={c['M']}, {c['form']} form)"
                            for c in r22["channelizer"])
                + f"; the tracker locked at block {r22['tracking']['first_lock_block']}; capture "
                f"and scan decisions equal; "
                f"np_input {r22['leak']['np_input']:.2f} KB a transfer (the control "
                f"{r22['leak']['kept_rows']:.2f} of its {r22['leak']['row_kb']:.1f} KB row); steps "
                f"{json.dumps(r22['steps_s'])}, {r22['seconds']:.1f} s of steps, "
                f"{time.perf_counter() - t_s22:.1f} s with the interpreter; "
                + json.dumps({k: v for k, v in r22.items() if k != "profile"}))

    times = {}
    for p in cfg:
        spec = cfg[p][2]
        hop = spec.Nfft - spec.sigOverlap
        for B in BATCHES:
            t, whole, band_bins, dev = time_kernels(spec, consts[p], B)
            bnd = bounds(spec, B, band_bins)
            check_bounds(t, bnd, B, p)
            for k, dms in dev.items():
                assert dms >= bnd[k][0], f"{p} B={B} {k}: device_ms {dms} is below bound_ms"
            times[p, B] = (t, bnd, dev)
            for k, (ms, pms, lms) in t.items():
                say("times", f"{card} | {p} B={B} {k}: ms={ms:.5f} plain_ms={pms:.5f} "
                             f"library_ms={'null' if lms is None else f'{lms:.5f}'} "
                             f"bound_ms={bnd[k][0]:.4g} ({bnd[k][1]}) device_ms={dev[k]:.5f} "
                             f"launches_per_block={1 / B:.4f}")
            say("times", f"{card} | {p} B={B} whole block graph: {whole[0]:.4f} ms/call "
                         f"({1e3 * whole[0] / B:.2f} us/block, "
                         f"{B * hop / whole[0] / 1e3:.1f} Msamples/s of new samples); "
                         f"plain path {whole[1]:.4f} ms/call")

    bcfg_big = big_configuration()
    big_spec = bcfg_big[2]
    t_big = time_big(big_spec, DeviceConsts.from_spec(big_spec, torch.device("cuda")))
    for k in ("mf_bank_colreduce", "timing_band", "threshold_input"):
        for B, (ms, pms, lms, (bms, by), dms) in t_big[k].items():
            assert min(v for v in (ms, pms, lms, dms) if v is not None) >= bms, \
                f"big {k} B={B}: a time is below bound_ms {bms}"
            shape = "N=2^19, long form" if k == "threshold_input" else f"Nfft {big_spec.Nfft}"
            say("times", f"{card} | {k} {shape} B={B}: ms={ms:.5f} plain_ms={pms:.5f} "
                         f"library_ms={'null' if lms is None else f'{lms:.5f}'} "
                         f"bound_ms={bms:.4g} ({by}) device_ms={dms:.5f}")
    say("times", f"{card} | big block graph Nfft {big_spec.Nfft} B={BIG_B}: "
                 f"{t_big['graph_ms']:.4f} ms/call")

    max_mhz, _ = sm_clocks()
    vt, vt_more = time_viterbi(VIT_BY_S), time_viterbi(VIT_MORE)
    _, now_mhz = sm_clocks()
    for key, (ms, pms, (bms, by), lengths, dms) in {**vt, **vt_more}.items():
        assert min(ms, pms, dms) >= bms, f"K7 S={key}: a time is below bound_ms {bms}"
        say("times", f"{card} | viterbi S={key} T={max(lengths)}: ms={ms:.5f} plain_ms={pms:.5f} "
                     f"library_ms=null bound_ms={bms:.4g} ({by}) device_ms={dms:.5f} "
                     f"ns_per_step={1e6 * ms / max(lengths):.1f} chain_estimate_ms="
                     f"{viterbi_chain_ms(lengths, max_mhz):.5f} (by chain: {VIT_CHAIN_OPS} "
                     f"dependent ALU ops x {VIT_CYCLES_PER_OP} cycles a step at clocks.max.sm "
                     f"{max_mhz:g} MHz, redux.sync not counted; an estimate, not a bound)")
    say("times", f"{card} | clocks.sm {now_mhz:g} MHz after the K7 timings (clocks.max.sm "
                 f"{max_mhz:g} MHz): a latency-bound kernel follows the clock")
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
    for k, unit in (("symbol_detect_nrzs", "B"), ("vote", "C")):
        for n, (ms, pms, (bms, by), dms) in t4[k].items():
            assert min(ms, pms, dms) >= bms, f"{k} {unit}={n}: a time is below bound_ms {bms}"
            say("times", f"{card} | {k} {unit}={n}: ms={ms:.5f} plain_ms={pms:.5f} "
                         f"library_ms=null bound_ms={bms:.4g} ({by}) device_ms={dms:.5f}")
    for B in BATCHES:
        say("times", f"{card} | bench_BPSK B={B}: K4's NRZ-S form "
                     f"{t4['symbol_detect_nrzs'][B][3]:.5f} device ms against K4 alone into the "
                     f"row {t4['k4_alone'][B]:.5f}; block graph {t4['bpsk_graph'][B][0]:.4f} "
                     f"ms/call (CUDA events), device busy {t4['bpsk_graph'][B][1]:.4f} ms/call "
                     f"(profiled wall {t4['bpsk_graph'][B][2]:.4f})")
    say("times", f"{card} | group graph C={GROUP_C} {t4['group_ms']:.4f} ms/call against the "
                 f"block graph at B={GROUP_C} {t4['batch_ms']:.4f} ms/call on the same blocks: "
                 f"the vote adds {t4['group_ms'] - t4['batch_ms']:.4f} ms "
                 f"({100 * (t4['group_ms'] - t4['batch_ms']) / t4['group_ms']:.1f}%)")
    t5 = time_slice5(wb, fspec, tracker, track_blocks)
    (k9_ms, k9_pms, k9_dms), (k9_bms, k9_by) = t5["k9"], t5["k9_bound"]
    for Mk, tk in ((wb["M"], t5), (WB_VOTE_C, t5["vote"])):
        (ms, pms, dms), (bms, by) = tk["k9"], tk["k9_bound"]
        for v in (ms, pms, dms, tk["yardstick_ms"]):
            assert v >= bms, f"K9 M={Mk}: a time {v} is below bound_ms {bms}"
        say("times", f"{card} | channelize M={Mk} K={wb['taps_per_branch']} T={fspec.Nfft} "
                     f"({tk['plan']['form']} form): ms={ms:.5f} plain_ms={pms:.5f} "
                     f"library_ms=null bound_ms={bms:.4g} ({by}) device_ms={dms:.5f}; yardstick "
                     f"(grouped conv1d + torch.fft.fft, TF32 off) {tk['yardstick_ms']:.5f} ms, "
                     f"rel err vs K9 {tk['yardstick_err']:.2e}")
    for (Mw, Kw, Tw), tk in t5["k9_wide"].items():
        (ms, pms, dms), (bms, by), form = tk["k9"], tk["k9_bound"], tk["plan"]["form"]
        for v in (ms, pms, dms, tk["yardstick_ms"]):
            assert v >= bms, f"K9 {form} ({Mw}, {Kw}): a time {v} is below bound_ms {bms}"
        say("times", f"{card} | channelize {form} form M={Mw} K={Kw} T={Tw} "
                     f"({tk['plan'].get('stage', 'FIR kernel + cuFFT')}): ms={ms:.5f} "
                     f"plain_ms={pms:.5f} library_ms=null bound_ms={bms:.4g} ({by}) "
                     f"device_ms={dms:.5f} ("
                     + ("one launch" if form == "wide" else "the FIR kernel alone; ms includes "
                        "cuFFT and the transpose")
                     + f"); {100 * bms / dms:.1f}% of the bound; yardstick (grouped conv1d + "
                     f"torch.fft.fft, TF32 off) {tk['yardstick_ms']:.5f} ms, rel err vs K9 "
                     f"{tk['yardstick_err']:.2e}")
    for (Md, Kd, Td), (ms, dms, wms, wdms, (bms, by), pms) in t5["k9_direct"].items():
        assert min(ms, dms, wms, wdms, pms) >= bms, \
            f"K9 direct ({Md}, {Kd}): a time is below {bms}"
        say("times", f"{card} | channelize direct form M={Md} K={Kd} T={Td}: ms={ms:.5f} "
                     f"plain_ms={pms:.5f} "
                     f"device_ms={dms:.5f}; the wide form at the same shape ms={wms:.5f}, "
                     f"device_ms={wdms:.5f}; bound_ms={bms:.4g} ({by})")
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
    t6 = time_slice6(fspec, consts["flagship"], bspec, bconsts)
    for k, shape, t in [("symbol_detect_local", "flagship", t6["symbol_detect_local"])] + [
            ("shard_select", f"flagship nd={nd}", t6["shard_select"][nd]) for nd in TIMED_NDS] + [
            ("shard_select_nrzs", "bench_BPSK nd=1", t6["shard_select_nrzs"])]:
        for n, (ms, pms, (bms, by), dms) in t.items():
            assert min(ms, pms, dms) >= bms, f"{k} {shape} B={n}: a time is below bound_ms {bms}"
            say("times", f"{card} | {k} {shape} B={n}: ms={ms:.5f} plain_ms={pms:.5f} "
                         f"library_ms=null bound_ms={bms:.4g} ({by}) device_ms={dms:.5f} "
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
    say("times", f"{card} | 4n three-station Rx: first packet through the combiner after "
                 f"{c18['first_packet_s']:.2f} s of feed ({c18['warm_s']:.1f} s to warm); Rx "
                 f"children host ms per block (timeMA) {c18['host_ms_per_block']}; blocks "
                 f"{c18['blocks']}")
    say("times", f"{card} | 4n combiner host ms a compareWorkers round (three channels, one block "
                 f"of {d18['block_ms']:.2f} ms of signal each): median "
                 f"{d18['round_ms_median']:.3f}, max {d18['round_ms_max']:.3f} over "
                 f"{d18['blocks']} rounds, buffers up to {max(d18['buffered_bits'])} bits; "
                 f"rounds {[round(x, 3) for x in d18['round_ms']]}")
    say("times", f"{card} | 4o hamlib: modem up {h18['boot_s']:.2f} s after connect, warm "
                 f"{h18['warm_s']:.1f} s, second modem warm {h18['second_warm_s']:.1f} s; first "
                 f"packet {h18['first_packet_s']:.2f} s into the feed; Rx child host ms per block "
                 f"{h18['host_ms_per_block']:.3f}; children gone {h18['children_exit_s']:.2f} / "
                 f"{h18['second_children_exit_s']:.2f} s after the client left")

    say("times", f"{card} | 4p planned restart: the replacement warm {r19['replacement_warm_s']:.2f}"
                 f" s after it was made; overlap {r19['overlap_s']:.1f} s; decode gap "
                 f"{r19['decode_gap_s']:.3f} s (the replacement's first packet after the old "
                 f"stream's last; negative: the streams overlapped); the old child gone "
                 f"{r19['old_gone_after_overlap_s']:.2f} s after the overlap; Rx child RSS "
                 f"{r19['rss_old_warm_mb']:.1f} MB warm, {r19['rss_old_last_mb']:.1f} MB after "
                 f"{r19['rss_old_blocks']} blocks ({r19['rss_old_growth_kb_per_block']:.2f} KB a "
                 f"block); the replacement {r19['rss_new_warm_mb']:.1f} MB warm, "
                 f"{r19['rss_new_end_mb']:.1f} MB after {r19['blocks_new']} blocks; card memory "
                 f"in the overlap {r19['card_memory']}")
    say("times", f"{card} | 4q station harnesses: steps (s) {json.dumps(r21['steps_s'])}; "
                 f"streaming_rt at real time: {r21['streaming_rt']['packets_decoded']} of "
                 f"{r21['streaming_rt']['packets_scheduled']} packets, wall "
                 f"{r21['streaming_rt']['wall_seconds']} s for {RT_SIGNAL_S:g} s of signal, "
                 f"arrivals {r21['streaming_rt']['arrival_s']}")
    for p, B in (("flagship", 1), ("flagship", LINE_BATCH), ("flagship", 64), ("stx", 1),
                 ("stx", 64), ("cc11xx", 1), ("cc11xx", LINE_BATCH), ("cc11xx", 64),
                 ("bpsk", 1), ("bpsk", LINE_BATCH), ("bpsk", 64), ("wideband", 64),
                 ("generic", GENERIC_C), ("generic_bpsk", GENERIC_C)):
        if p == "bpsk":
            graph = build_process_batch(bspec, device="cuda", packed=True)
            x = bpsk_blocks(bspec, B, np.random.RandomState(SEED + B))
            wall, busy, n, tops = profile_calls(lambda: graph(x))
        elif p in ("generic", "generic_bpsk"):
            gspec, make = (bspec, generic_bpsk_blocks) if p == "generic_bpsk" else (fspec,
                                                                                    generic_blocks)
            x = torch.from_numpy(make(gspec, GENERIC_C)[0]).cuda()
            step = build_sharded_demod_step(gspec, make_mesh({"channel": 1, "dopp": 1},
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
        what = {"wideband": "chain", "generic": "step", "generic_bpsk": "step"}.get(p, "graph")
        say("profile", f"{card} | {p} B={B} {what}: wall "
                       f"{wall:.4f} ms/call, device busy {busy:.4f} ms/call, idle {idle}; {n} "
                       f"kernel names, top (ms/call): {tops}")

    def k9_row(tk):
        (ms, pms, dms), (bms, by) = tk["k9"], tk["k9_bound"]
        return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by, "library_ms": None,
                "device_ms": dms, "yardstick_ms": tk["yardstick_ms"], "plan": tk["plan"]}

    kernels = []
    for k, (src, replaces) in KERNELS.items():
        by_path = {p: res[p]["launches"].get(k, 0) for p in res}
        if k in t6:
            t = t6[k][1] if k == "shard_select" else t6[k]
            ms, pms, (bms, by), dms = t[LINE_BATCH]
            kernels.append({
                "name": k, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": errs[k], "ms": ms, "plain_ms": pms, "bound_ms": bms,
                "bound_by": by, "library_ms": None, "batch": LINE_BATCH,
                "shape": {"shard_select": "flagship, nd=1",
                          "shard_select_nrzs": "bench_BPSK, nd=1"}.get(k, "flagship"),
                "by_B": {n: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2][0],
                             "bound_by": v[2][1], "device_ms": v[3]} for n, v in t.items()},
                "device_ms": dms})
            if k == "shard_select":
                kernels[-1]["by_nd"] = {nd: {n: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2][0],
                                                 "bound_by": v[2][1], "device_ms": v[3]}
                                             for n, v in t6[k][nd].items()} for nd in TIMED_NDS}
            continue
        if k in t4:
            unit = "C" if k == "vote" else "B"
            at = GROUP_C if k == "vote" else LINE_BATCH
            ms, pms, (bms, by), _ = t4[k][at]
            kernels.append({
                "name": k, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": errs[k], "ms": ms, "plain_ms": pms, "bound_ms": bms,
                "bound_by": by, "library_ms": None, unit.lower(): at,
                f"by_{unit}": {n: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2][0],
                                   "bound_by": v[2][1], "device_ms": v[3]}
                               for n, v in t4[k].items()},
                "device_ms": t4[k][at][3]})
            if k == "symbol_detect_nrzs":
                kernels[-1]["k4_alone_device_ms"] = dict(t4["k4_alone"])
                kernels[-1]["bpsk_graph"] = {B: {"ms": v[0], "device_busy_ms": v[1]}
                                             for B, v in t4["bpsk_graph"].items()}
            continue
        if k == "channelize":
            kernels.append({
                "name": k, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": errs[k], "ms": k9_ms, "plain_ms": k9_pms, "bound_ms": k9_bms,
                "bound_by": k9_by, "library_ms": None, "yardstick_ms": t5["yardstick_ms"],
                "device_ms": k9_dms, "form": t5["plan"]["form"],
                "shape": f"wideband M={wb['M']} K={wb['taps_per_branch']} T={fspec.Nfft}",
                "vote_shape": {
                    "shape": f"M={WB_VOTE_C} K={wb['taps_per_branch']} T={fspec.Nfft}",
                    "form": t5["vote"]["plan"]["form"], "ms": t5["vote"]["k9"][0],
                    "plain_ms": t5["vote"]["k9"][1], "device_ms": t5["vote"]["k9"][2],
                    "bound_ms": t5["vote"]["k9_bound"][0], "bound_by": t5["vote"]["k9_bound"][1],
                    "yardstick_ms": t5["vote"]["yardstick_ms"]},
                "split_form": {f"M={Mw} K={Kw} T={Tw}": k9_row(tk)
                               for (Mw, Kw, Tw), tk in t5["k9_wide"].items()
                               if tk["plan"]["form"] == "split"},
                "direct_form": {f"M={Md} K={Kd} T={Td}": {
                    "ms": v[0], "device_ms": v[1], "wide_form_ms": v[2],
                    "wide_form_device_ms": v[3], "bound_ms": v[4][0], "bound_by": v[4][1],
                    "plain_ms": v[5]}
                    for (Md, Kd, Td), v in t5["k9_direct"].items()}})
            continue
        if k == "channelize_wide":
            line = t5["k9_wide"][K9_WIDE[0]]
            kernels.append({
                "name": k, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": errs[k], **k9_row(line),
                "shape": "M={} K={} T={}".format(*K9_WIDE[0]),
                "shapes": {f"M={Mw} K={Kw} T={Tw}": k9_row(tk)
                           for (Mw, Kw, Tw), tk in t5["k9_wide"].items()
                           if tk["plan"]["form"] == "wide"}})
            continue
        if k == "viterbi":
            ms, pms, (bms, by), _, _ = vt[1]
            kernels.append({
                "name": k, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": errs[k], "ms": ms, "plain_ms": pms, "bound_ms": bms,
                "bound_by": by, "library_ms": None, "batch": 1, "shape": "ccsds decode T=2144",
                "by_S": viterbi_rows(vt), "device_ms": vt[1][4],
                "more_shapes": {f"S={key}": v for key, v in viterbi_rows(vt_more).items()}})
            continue
        home = "flagship" if k in PATH_KERNELS["flagship"] else "stx"
        entry = {"name": k, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "max_abs_err": errs[k], **kernel_entry(k, *times[home, LINE_BATCH]),
                 "batch": LINE_BATCH, "shape": home,
                 "by_B": {B: kernel_entry(k, *times[home, B]) for B in BATCHES}}
        if k in PATH_KERNELS["cc11xx"]:
            entry["cc11xx"] = {**kernel_entry(k, *times["cc11xx", LINE_BATCH]),
                               "by_B": {B: kernel_entry(k, *times["cc11xx", B]) for B in BATCHES}}
        if home == "flagship" and k in PATH_KERNELS["stx"]:
            entry["stx"] = {**kernel_entry(k, *times["stx", LINE_BATCH]),
                            "by_B": {B: kernel_entry(k, *times["stx", B]) for B in BATCHES}}
        if k in t_big:
            entry["long_form" if k == "threshold_input" else "big"] = {
                "shape": ("N=2^19" if k == "threshold_input" else f"Nfft {big_spec.Nfft}"),
                "by_B": {B: {"ms": v[0], "plain_ms": v[1], "library_ms": v[2],
                             "bound_ms": v[3][0], "bound_by": v[3][1], "device_ms": v[4]}
                         for B, v in t_big[k].items()}}
        kernels.append(entry)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
