"""K7 and ``ViterbiStream.feed``, K1, K5 and K4, K6, K9, K4 with K4n, K8,
or K4l and K4s, and the graphs around them, of two checkouts, timed in
turns on one card.

    python3 chip_ab_viterbi.py PARENT_DIR
        [--turn viterbi|doppler|detect|threshold|channelize|nrzs|vote|shard] [--rounds R]
    python3 chip_ab_viterbi.py PARENT_DIR --summary-of OUTPUT_FILE

PARENT_DIR is another checkout of the repo (for example ``git archive`` of
the parent commit unpacked under ``build/``); the other tree is the one
that holds this script. Each turn is a fresh process run from one tree's
root, which builds that tree's kernels and times, on card 0:

- ``--turn viterbi`` (the default): K7 (``viterbi_sweep``, soft ±1/0
  symbols, streaming) at chip_smoke's shapes: S=1, T=2144, decode; S=2,
  T=2016/2015, metric-only; S=64, T=2144, decode (CUDA events,
  chip_smoke's ``cuda_ms``); and the host ms per ``ViterbiStream.feed`` of
  one flagship block (4032 soft symbols) over BLOCKS blocks, through K7
  and through the plain version (chip_smoke's ``time_feed``);
- ``--turn doppler``: K1 (``doppler_energy``) on the flagship blocks of
  chip_smoke's ``kernel_inputs`` at B=1/16/64, CUDA events around the
  wrapper and the device ms a call of its kernels (torch.profiler); the
  flagship block graph at B=1, 16 and 64 (wall ms by CUDA events, the
  least of 15 means of 20 calls, and the device busy ms a call); the
  wideband chain (K9 and the channel-parallel step at C=64, vote off) per
  hop; and the sha256 of K9's output at that shape (64 x 2^16, the fused
  form), which the summary holds equal across the turns of both trees;
- ``--turn detect``: K5 (``doppler_estimate``) at the flagship shape and K4
  (``symbol_detect``, typed outputs; with K6's clip bitmask at STX) at the
  flagship and STX shapes, on chip_smoke's ``kernel_inputs`` at B=1/16/64:
  the device ms a call of the kernel (torch.profiler; a trace that lost
  any of the launches is taken again), the wrapper's ms by CUDA events
  (``cuda_ms``), and the
  wrapper's host us a call (the enqueue: ``perf_counter`` over HOST_CALLS
  calls before one synchronize); then the flagship and STX block graphs at
  B=1/16/64, wall ms by CUDA events and device busy ms a call;
- ``--turn threshold``: K6 (``threshold_input``) on chip_smoke's STX blocks
  (``signal_blocks``: a burst in every other block) at B=1/16/64: the
  device ms a call of its kernels (torch.profiler, a trace that lost any
  launch taken again), the wrapper's ms (``cuda_ms``) and host us a call;
  the sha256 of y, the hit words and clipped_any, and of the STX block
  graph's packed rows, which the summary holds equal across the turns of
  both trees; the STX graph's wall ms and device busy ms a call;
- ``--turn channelize``: K9 (``channelize``) on chip_smoke's ``k9_inputs``
  (seeded samples and a random carry) at the wideband shape (M=64, K=8,
  T=2^16) and at the vote's (M=4): the device ms a call of its kernel
  (torch.profiler, a trace that lost a launch taken again) and of all the
  call's device work (the parent also copies the carry), the wrapper's ms
  (``cuda_ms``) and host us a call; max|y - y_parent| / max|y|, y_parent
  saved by the first turn of the parent; the sha256 of the carry, which the
  summary holds equal across the turns of both trees; the wideband chain
  (K9 and the channel-parallel step at C=64, vote off): K9's device ms
  inside it (after the step, K9 runs slower than alone), wall ms by CUDA
  events and device busy ms a hop;
- ``--turn nrzs``: K4 with the NRZ-S bits (K4n) on bench_BPSK blocks
  (chip_smoke's ``bpsk_configuration`` and ``bpsk_stream``) at B=1/16/64,
  into the packed rows: one launch of K4's NRZ-S form where the tree has
  ``symbol_detect_nrzs``, else K4 and then the standalone K4n; the device
  ms a call of the kernels (torch.profiler, a trace that lost a launch
  taken again), the ms by CUDA events, the host us a call and the sha256
  of the rows; the bench_BPSK block graph at B=1/16/64: wall ms by CUDA
  events, device busy ms, host us a call (the enqueue of GRAPH_CALLS
  calls) and the sha256 of its rows; and, as the guard, K4's device ms at
  the flagship and STX shapes (typed outputs, ``kernel_inputs``); the
  graph's host us is also read as the least of 10 readings of a quarter
  as many calls (the host's noise between readings is larger than a
  wrapper). The
  summary holds every sha256 equal across the turns of both trees;
- ``--turn vote``: K8 (``vote_rows``) on chip_smoke's ``vote_input`` rows
  at S=4608 (the flagship's numSymMax) for C=3/16/64/256, and at C=3 for
  the big path's S=36480 (blockSize 19): device ms a call, ms by CUDA
  events, host us a call; and the sha256 of the voted pair and the rows
  of a fresh vote with the pad mask (master 0) and one without it (master
  C - 1), held equal across the turns of both trees;
- ``--turn shard``: K4l (``symbol_detect_local``) at the flagship and
  bench_BPSK shapes and K4s (``shard_select``) on the pairs of the bank
  split 1, 2 and 4 ways (chip_smoke's ``shard_columns``; the pairs by K4l's
  plain version) at the flagship shape and at STX's with its clip bitmask,
  at B=1/16/64: device ms (torch.profiler), ms by CUDA events, host us a
  call and the sha256 of the pairs and the rows; K4s with the NRZ-S bits
  on bench_BPSK at nd = 1 and 2 (one launch of ``shard_select_nrzs`` where
  the tree has it, else K4s and then the standalone K4n); the bench_BPSK
  generic step at C=16
  (``force_generic``): ms by CUDA events, device busy ms, the sha256 of
  its outputs; K4's device ms at the flagship and STX shapes (the guard);
  and ptxas's registers and stack of every K4, K4l and K4s instantiation.
  Where the tree has ``k4s_plan``, K4s's device ms at B=16 and 64 also at
  each launch plan (threads, slots a thread) in place of its pick, at the
  flagship (nd = 1, 2, 4) and in the NRZ-S form (nd = 1). The turn finds out
  which API the tree has.

The turns run parent, change, change, parent, R times (default 1), so a
drift of the card or the host shows as a difference between the runs of
one tree, and each tree runs first as often as the other. Each
turn prints one JSON line; the card's name and power limit come first,
and a summary last: each quantity's readings in both trees, min-max and
median, and the ratios parent / change. ``--summary-of FILE`` prints that
summary again from a run's saved output, on any machine.
Both trees' ``chip_smoke.py`` must have what the turn calls
(``viterbi_inputs``, ``cuda_ms``, ``time_feed``; ``configuration``,
``kernel_inputs``, ``signal_blocks``, ``k9_inputs``; ``k4_kwargs``,
``k5_args``; ``bpsk_configuration``, ``bpsk_stream``, ``vote_input``,
``big_configuration``; ``k4l_kwargs``, ``shard_columns``, ``GENERIC_C``). The turns' scratch files (y_parent) go under
``build/ab_scratch``. Needs a card: a turn fails without one.
"""

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: flagship blocks fed per feed timing (the first is not timed)
BLOCKS = 200
#: wrapper calls a host-time reading of the detect turn enqueues
HOST_CALLS = 2000
#: graph calls a host-time reading of the nrzs turn enqueues
GRAPH_CALLS = 200

#: run with ``python -c`` from a tree's root, so that it imports that tree
TURNS = {}
TURNS["viterbi"] = """
import json, sys
import torch
assert torch.cuda.is_available(), "no card"
import chip_smoke as c
from pycusdr_tpu_torch.ops import viterbi as vit
out = {}
for S, lengths, decode in ((1, [2144], True), (2, [2016, 2015], False), (64, [2144] * 64, True)):
    x = c.viterbi_inputs("soft_pm1", lengths)
    out[f"K7 S={S} ms"] = c.cuda_ms(lambda: vit.viterbi_sweep(
        x, lengths, soft=True, terminated=False, decode=decode))
out["feed host ms"], out["feed plain host ms"] = c.time_feed(blocks=int(sys.argv[1]))
print(json.dumps(out))
"""
#: K1's kernels in either tree: the two CUDA-core passes, or the one tensor-core kernel
TURNS["doppler"] = """
import hashlib
import json
import re
import sys
import time
import torch
assert torch.cuda.is_available(), "no card"
import chip_smoke as c
from pycusdr_tpu_torch.configs import wideband_conf
from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.dsp.block import build_process_batch
from pycusdr_tpu_torch.ops import doppler_search as ds
from pycusdr_tpu_torch.parallel import build_sharded_demod_step, make_mesh
from pycusdr_tpu_torch.parallel import channelizer as pch
K1_NAMES = ("doppler_partial", "doppler_reduce", "doppler_energy_k")
""" + "{PROFILING}" + """


# device ms a call in the kernels whose names hold one of names (None: all, the busy time)
def device_ms(fn, calls=20, names=K1_NAMES):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (names is None or any(n in e.key for n in names))) / 1e3 / calls


spec = c.configuration("flagship")[2]
consts = DeviceConsts.from_spec(spec, torch.device("cuda"))
out = {}
for B in (1, 16, 64):
    P = c.kernel_inputs(spec, consts, B)["P"]
    k1 = lambda: ds.doppler_energy(P, consts.Q, consts.shifts)
    out[f"K1 B={B} ms"] = c.cuda_ms(k1)
    out[f"K1 B={B} device ms"] = device_ms(k1)
graph = build_process_batch(spec, device="cuda", packed=True)
for B in (1, 16, 64):
    x = c.signal_blocks(spec, B)
    out[f"flagship graph B={B} ms"] = c.cuda_ms(lambda: graph(x), iters=10)
    out[f"flagship graph B={B} least ms"] = min(
        c.cuda_ms(lambda: graph(x), iters=20, reps=1) for _ in range(15))
    out[f"flagship graph B={B} device busy ms"] = device_ms(lambda: graph(x), names=None)
wb = wideband_conf()
x, _ = c.k9_inputs(wb, spec.Nfft)
ch = pch.Channelizer(wb["M"], wb["taps_per_branch"], wb["beta"], device="cuda")
step = build_sharded_demod_step(spec, make_mesh({"channel": 1, "dopp": 1}, devices=["cuda"]),
                                vote=False)
out["K9 M=64 device ms in the chain"] = kernel_ms(lambda: step(ch(x)[0]), "channelize")
out["wideband chain ms"] = c.cuda_ms(lambda: step(ch(x)[0]), iters=5, reps=5)
out["K9 fused y sha256"] = hashlib.sha256(ch(x)[0].cpu().numpy().tobytes()).hexdigest()
print(json.dumps(out))
"""

#: the detect and threshold turns' timing helpers
PROFILING = """

# host us a call: the enqueue of n calls, before one synchronize
def host_us(fn, n=int(sys.argv[2])):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


# the device events of a trace of calls calls: [(key, count, device us)]
def trace(fn, calls):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


# device ms a call in the __global__ function name, launched once a call; a
# trace that lost any of the launches is taken again, ten times at most
def kernel_ms(fn, name, calls=20):
    pat = re.compile(r"(^|[\\s:])%s[<(]" % name)
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(10):
        ev = [e for e in trace(fn, calls) if pat.search(e[0])]
        seen.append(sum(e[1] for e in ev))
        if seen[-1] == calls:
            return sum(e[2] for e in ev) / 1e3 / calls
    raise AssertionError(f"{name}: ten traces held {seen} launches, not {calls}")


# device busy ms a call: every device event of the trace, once two traces
# in a row hold the same number of events, and some (a trace may lose some,
# or all)
def busy_ms(fn, calls=20):
    fn()
    torch.cuda.synchronize()
    seen = [trace(fn, calls)]
    for _ in range(5):
        seen.append(trace(fn, calls))
        n = [sum(e[1] for e in t) for t in seen[-2:]]
        if n[0] == n[1] > 0:
            return sum(e[2] for e in seen[-1]) / 1e3 / calls
    raise AssertionError(f"busy: traces held {[sum(e[1] for e in t) for t in seen]} events")


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()
"""
TURNS["doppler"] = TURNS["doppler"].replace("{PROFILING}", PROFILING)

TURNS["detect"] = """
import json, re, sys, time
import torch
assert torch.cuda.is_available(), "no card"
import chip_smoke as c
from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.dsp.block import build_process_batch
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops import doppler_search as ds

""" + PROFILING + """

out = {}
for p in ("flagship", "stx"):
    spec = c.configuration(p)[2]
    consts = DeviceConsts.from_spec(spec, torch.device("cuda"))
    for B in (1, 16, 64):
        inp = c.kernel_inputs(spec, consts, B)
        a4 = (inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"], consts.bitLUT)
        kw4 = c.k4_kwargs(spec, consts)
        hits = inp.get("hits")
        calls = {"K4": (lambda: dk.symbol_detect(*a4, hits=hits, **kw4), "symbol_detect")}
        if spec.doppler_search:
            a5, kw5 = c.k5_args(spec, consts, inp["E"], inp["P"])
            calls["K5"] = (lambda: ds.doppler_estimate(*a5, **kw5), "doppler_estimate")
        for k, (fn, name) in calls.items():
            out[f"{k} {p} B={B} device ms"] = kernel_ms(fn, name)
            out[f"{k} {p} B={B} ms"] = c.cuda_ms(fn)
            out[f"{k} {p} B={B} host us"] = host_us(fn)
    graph = build_process_batch(spec, device="cuda", packed=True)
    for B in (1, 16, 64):
        x = c.signal_blocks(spec, B)
        out[f"{p} graph B={B} ms"] = c.cuda_ms(lambda: graph(x), iters=10)
        out[f"{p} graph B={B} device busy ms"] = busy_ms(lambda: graph(x))
print(json.dumps(out))
"""

#: K6 at the STX shape in either tree: the three passes (thr_pass1-3) or one
#: cluster launch (thr_cluster, where the tree has ``k6_plan``)
TURNS["threshold"] = """
import hashlib, json, re, sys, time
import torch
assert torch.cuda.is_available(), "no card"
import chip_smoke as c
from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.dsp.block import build_process_batch
from pycusdr_tpu_torch.ops import demod_kernels as dk
""" + PROFILING + """

PER_CALL = 1 if hasattr(dk, "k6_plan") else 3  # K6's __global__ launches a call at STX


# device ms a call in K6's __global__ functions; a trace that lost any of
# the launches is taken again, five times at most
def k6_ms(fn, calls=20):
    pat = re.compile(r"(^|[\\s:])(thr_cluster|thr_pass[123])[<(]")
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(5):
        ev = [e for e in trace(fn, calls) if pat.search(e[0])]
        seen.append(sum(e[1] for e in ev))
        if seen[-1] == calls * PER_CALL:
            return sum(e[2] for e in ev) / 1e3 / calls
    raise AssertionError(f"K6: five traces held {seen} launches, not {calls * PER_CALL}")


out = {}
spec = c.configuration("stx")[2]
consts = DeviceConsts.from_spec(spec, torch.device("cuda"))
graph = build_process_batch(spec, device="cuda", packed=True)
for B in (1, 16, 64):
    x = c.signal_blocks(spec, B)
    fn = lambda: dk.threshold_input(x, consts.threshold_scale)
    out[f"K6 B={B} device ms"] = k6_ms(fn)
    out[f"K6 B={B} ms"] = c.cuda_ms(fn)
    out[f"K6 B={B} host us"] = host_us(fn)
    y, hits, anyk = fn()
    out[f"K6 B={B} y, hits, clipped_any sha256"] = digest(y, hits, anyk)
    out[f"STX graph B={B} ms"] = c.cuda_ms(lambda: graph(x), iters=10)
    out[f"STX graph B={B} device busy ms"] = busy_ms(lambda: graph(x))
    out[f"STX graph B={B} rows sha256"] = digest(graph(x))
print(json.dumps(out))
"""

#: K9 in either tree: one ``channelize`` launch a call (the parent adds a copy
#: of the carry); argv[3]: the scratch directory y_parent is saved in, argv[4]:
#: the root of the change tree
TURNS["channelize"] = """
import hashlib, json, re, sys, time
from pathlib import Path
import torch
assert torch.cuda.is_available(), "no card"
import chip_smoke as c
from pycusdr_tpu_torch.configs import wideband_conf
from pycusdr_tpu_torch.parallel import build_sharded_demod_step, make_mesh
from pycusdr_tpu_torch.parallel import channelizer as pch
""" + PROFILING + """

out = {}
scratch = Path(sys.argv[3])
wb = wideband_conf()
spec = c.configuration("flagship")[2]
N = spec.Nfft
for M in (wb["M"], 4):
    w = dict(wb, M=M)
    x, st = c.k9_inputs(w, N)
    ch = pch.Channelizer(M, w["taps_per_branch"], w["beta"], device="cuda")
    fn = lambda: pch.channelize(x, ch.h2, st, tw=ch.tw)
    out[f"K9 M={M} device ms"] = kernel_ms(fn, "channelize")
    out[f"K9 M={M} call device busy ms"] = busy_ms(fn)
    out[f"K9 M={M} ms"] = c.cuda_ms(fn)
    out[f"K9 M={M} host us"] = host_us(fn)
    y, carry = fn()
    ref = scratch / f"y_parent_M{M}.pt"
    if not ref.exists():
        assert Path.cwd() != Path(sys.argv[4]), "the first turn is the parent's"
        scratch.mkdir(parents=True, exist_ok=True)
        torch.save(y.cpu(), ref)
    yp = torch.load(ref).cuda()
    out[f"K9 M={M} rel err vs y_parent"] = float((y - yp).abs().max() / y.abs().max())
    out[f"K9 M={M} carry sha256"] = hashlib.sha256(carry.cpu().numpy().tobytes()).hexdigest()
x, _ = c.k9_inputs(wb, N)
ch = pch.Channelizer(wb["M"], wb["taps_per_branch"], wb["beta"], device="cuda")
step = build_sharded_demod_step(spec, make_mesh({"channel": 1, "dopp": 1}, devices=["cuda"]),
                                vote=False)
out["K9 M=64 device ms in the chain"] = kernel_ms(lambda: step(ch(x)[0]), "channelize")
out["wideband chain ms"] = c.cuda_ms(lambda: step(ch(x)[0]), iters=5, reps=5)
out["wideband chain device busy ms"] = busy_ms(lambda: step(ch(x)[0]))
print(json.dumps(out))
"""


#: K4 with K4n in either tree: one launch of K4's NRZ-S form (symbol_detect
#: with the symbol LUT), or K4 into the row and then nrzs_bits
TURNS["nrzs"] = r"""
import hashlib, json, re, sys, time
from pathlib import Path
import numpy as np
import torch
assert torch.cuda.is_available(), "no card"
import chip_smoke as c
from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.dsp.block import build_process_batch, packed_len
from pycusdr_tpu_torch.ops import _lib
from pycusdr_tpu_torch.ops import demod_kernels as dk
""" + PROFILING + r"""

FUSED = hasattr(dk, "symbol_detect_nrzs")
out = {}
_lib.lib()  # ptxas's registers and stack of each K4 instantiation, from the build log
log = Path(_lib.build_info["log"]).read_text()
for part in log.split("== symbol_detect.cu", 1)[1].split("\n== ", 1)[0].split(
        "Compiling entry function")[1:]:
    m = re.search(r"symbol_detectILi(\d)ELb([01])ELb([01])E(?:Lb([01])E)?E", part.split("\n")[0])
    if m:
        out[f"K4 ptxas SPT={m[1]} argwin={m[2]} vec={m[3]} nrzs={m[4] or 0}"] = (
            re.search(r"Used (\d+) registers", part)[1] + " registers, "
            + re.search(r"(\d+) bytes stack frame", part)[1] + " bytes stack")
spec = c.configuration("flagship")[2]
bspec = c.bpsk_configuration()[2]
consts = DeviceConsts.from_spec(bspec, torch.device("cuda"))
S, L, M, off = bspec.numSymMax, packed_len(bspec), bspec.num_masks, bspec.code_search_mask_offset
graph = build_process_batch(bspec, device="cuda", packed=True)
plain = build_process_batch(bspec, device="cuda", plain=True)
kw = c.k4_kwargs(bspec, consts)
for B in (1, 16, 64):
    rng = np.random.RandomState(c.SEED + B)
    x = torch.from_numpy(np.stack([
        c.bpsk_stream(bspec, rng.randint(0, 2, bspec.Nfft // int(bspec.spsym) + 8), bspec.Nfft,
                      seed=c.SEED + b) for b in range(B)])).cuda()
    X = torch.fft.fft(x)
    shift = plain(x)["shift"].to(torch.int32).contiguous()
    colsum, colmax, colarg = dk.mf_bank_colreduce_plain(X, consts.masks_f, shift, off, M - off)
    spSym, codeOffset, code_val = dk.timing_band_plain(colsum, bspec.code_idx_lo,
                                                       bspec.code_idx_hi)
    k4 = (colmax, colarg, spSym, codeOffset)
    row = torch.zeros((B, L), device="cuda")
    if FUSED:
        def fn():
            dk.symbol_detect_nrzs(*k4, consts.symbolLUT, **kw, row=row, code_val=code_val)
        out[f"K4+K4n B={B} device ms"] = kernel_ms(fn, "symbol_detect")
    else:
        def fn():
            dk.symbol_detect(*k4, None, **kw, row=row, code_val=code_val)
            dk.nrzs_bits(row, consts.symbolLUT, S)
        out[f"K4+K4n B={B} device ms"] = kernel_ms(fn, "symbol_detect") + kernel_ms(fn, "nrzs_bits")
    out[f"K4+K4n B={B} ms"] = c.cuda_ms(fn)
    out[f"K4+K4n B={B} host us"] = host_us(fn)
    row.zero_()
    fn()
    out[f"K4+K4n B={B} rows sha256"] = digest(row)
    out[f"bpsk graph B={B} ms"] = c.cuda_ms(lambda: graph(x), iters=10)
    out[f"bpsk graph B={B} device busy ms"] = busy_ms(lambda: graph(x))
    out[f"bpsk graph B={B} host us"] = host_us(lambda: graph(x), n=int(sys.argv[5]))
    out[f"bpsk graph B={B} least host us"] = min(
        host_us(lambda: graph(x), n=int(sys.argv[5]) // 4) for _ in range(10))
    out[f"bpsk graph B={B} rows sha256"] = digest(graph(x))
for p in ("flagship", "stx"):
    pspec = c.configuration(p)[2]
    pconsts = DeviceConsts.from_spec(pspec, torch.device("cuda"))
    for B in (1, 16, 64):
        inp = c.kernel_inputs(pspec, pconsts, B)
        a4 = (inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"], pconsts.bitLUT)
        kw4 = c.k4_kwargs(pspec, pconsts)
        hits = inp.get("hits")
        out[f"K4 {p} B={B} device ms"] = kernel_ms(
            lambda: dk.symbol_detect(*a4, hits=hits, **kw4), "symbol_detect")
print(json.dumps(out))
"""

#: K4l and K4s in either tree: K4l's (value, key) pairs as two arrays or as
#: one (B, S, 2) buffer, K4s on two arrays or on the buffer, and the NRZ-S bits
#: in K4s's launch (``shard_select_nrzs``) or by the standalone K4n after it
TURNS["shard"] = r"""
import hashlib, json, re, sys, time
from pathlib import Path
import numpy as np
import torch
assert torch.cuda.is_available(), "no card"
import chip_smoke as c
from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.dsp.block import packed_len
from pycusdr_tpu_torch.ops import _lib
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.parallel import build_sharded_demod_step, make_mesh
""" + PROFILING + r"""

PACKED = hasattr(dk, "shard_select_nrzs")
#: K4s's launch plans (threads, slots a thread) timed at B=16 and 64, where the tree
#: has ``k4s_plan`` (the wrapper reads it at each call)
PLANS = ((64, 1), (128, 1), (128, 2)) if hasattr(dk, "k4s_plan") else ()
out = {}
_lib.lib()  # ptxas's registers and stack of K4's, K4l's and K4s's instantiations
log = Path(_lib.build_info["log"]).read_text()
for src in ("symbol_detect.cu", "shard_select.cu"):
    for part in log.split(f"== {src}", 1)[1].split("\n== ", 1)[0].split(
            "Compiling entry function")[1:]:
        m = re.search(r"\d(symbol_detect_local|symbol_detect|shard_select|nrzs_bits)(I\w+?EE)?",
                      part.split("\n")[0])  # the name and its template arguments, mangled
        if m is None:
            continue
        out[f"ptxas {m[1]}{m[2] or ''}"] = (
            re.search(r"Used (\d+) registers", part)[1] + " registers, "
            + re.search(r"(\d+) bytes stack frame", part)[1] + " bytes stack")


def pairs_of(spec, consts, inp, nd):
    # every shard's (values, keys) of the bank split nd ways, by K4l's plain version
    kw = c.k4l_kwargs(spec)
    Ml = spec.num_masks // nd
    pp = [dk.symbol_detect_local_plain(cm, ca, inp["spSym"], inp["codeOffset"], m0=d * Ml, **kw)
          for d, (cm, ca) in enumerate(c.shard_columns(spec, consts, inp, nd))]
    return torch.stack([p[0] for p in pp]), torch.stack([p[1] for p in pp])


def k4s(spec, consts, inp, vals, keys, hits, row, lut=None):
    # one call of K4s (with the NRZ-S bits where lut is given) into row
    a = (inp["spSym"], inp["codeOffset"])
    kw = dict(c.k4_kwargs(spec, consts), M=spec.num_masks, code_val=inp["code_val"], hits=hits,
              row=row)
    if PACKED:
        pairs = dk.pack_pairs(vals, keys)
        if lut is None:
            return lambda: dk.shard_select(pairs, *a, consts.bitLUT, **kw)
        return lambda: dk.shard_select_nrzs(pairs, *a, lut, **kw)
    if lut is None:
        return lambda: dk.shard_select(vals, keys, *a, consts.bitLUT, **kw)

    def two():
        dk.shard_select(vals, keys, *a, None, **kw)
        dk.nrzs_bits(row, lut, spec.numSymMax)
    return two


def timed(tag, fn, kernel, also=None):
    out[f"{tag} device ms"] = kernel_ms(fn, kernel) + (kernel_ms(fn, also) if also else 0.0)
    out[f"{tag} ms"] = c.cuda_ms(fn)
    out[f"{tag} host us"] = host_us(fn)


def plans(tag, fn, B):
    # K4s's device ms at each of PLANS in place of k4s_plan's pick
    if B == 1 or not PLANS:
        return
    pick = dk.k4s_plan
    for t, spt in PLANS:
        dk.k4s_plan = lambda B_, S_, nd_: (t, spt)
        try:
            out[f"{tag} plan {t}x{spt} device ms"] = kernel_ms(fn, "shard_select")
        finally:
            dk.k4s_plan = pick


dev = torch.device("cuda")
cfg = {p: c.configuration(p)[2] for p in ("flagship", "stx")}
cfg["bpsk"] = c.bpsk_configuration()[2]
consts = {p: DeviceConsts.from_spec(s, dev) for p, s in cfg.items()}
for p, spec in cfg.items():
    L = packed_len(spec)
    for B in (1, 16, 64):
        x = c.bpsk_blocks(spec, B, np.random.RandomState(c.SEED + B)) if p == "bpsk" else None
        inp = c.kernel_inputs(spec, consts[p], B, x=x)
        hits = inp.get("hits")
        a = (inp["colmax"], inp["colarg"], inp["spSym"], inp["codeOffset"])
        if p != "stx":  # K4l at the flagship and bench_BPSK shapes
            fn = lambda: dk.symbol_detect_local(*a, m0=0, **c.k4l_kwargs(spec))
            timed(f"K4l {p} B={B}", fn, "symbol_detect_local")
            out[f"K4l {p} B={B} pairs sha256"] = digest(*fn())
        if p != "bpsk":  # K4 at the flagship and STX shapes: the guard
            out[f"K4 {p} B={B} device ms"] = kernel_ms(
                lambda: dk.symbol_detect(*a, consts[p].bitLUT, hits=hits,
                                         **c.k4_kwargs(spec, consts[p])), "symbol_detect")
        row = torch.zeros((B, L), device=dev)
        for nd in (1, 2, 4):
            vals, keys = pairs_of(spec, consts[p], inp, nd)
            if p == "bpsk":  # K4s with the NRZ-S bits
                if nd == 4:
                    continue
                fn = k4s(spec, consts[p], inp, vals, keys, None, row, consts[p].symbolLUT)
                tag = f"K4s+K4n bpsk nd={nd} B={B}"
                timed(tag, fn, "shard_select", None if PACKED else "nrzs_bits")
                if nd == 1:
                    plans(tag, fn, B)
                row.zero_()
                fn()
                out[f"{tag} rows sha256"] = digest(row)
            else:  # K4s with STX's clip bitmask, and without it at the flagship
                fn = k4s(spec, consts[p], inp, vals, keys, hits, row)
                timed(f"K4s {p} nd={nd} B={B}", fn, "shard_select")
                if p == "flagship":
                    plans(f"K4s {p} nd={nd} B={B}", fn, B)
                row.zero_()
                fn()
                out[f"K4s {p} nd={nd} B={B} rows sha256"] = digest(row)
        del inp
bspec = cfg["bpsk"]
x = c.bpsk_blocks(bspec, c.GENERIC_C, np.random.RandomState(c.SEED + 70))
step = build_sharded_demod_step(bspec, make_mesh({"channel": 1, "dopp": 1}, devices=["cuda"]),
                                force_generic=True)
out["bpsk generic step C=16 ms"] = c.cuda_ms(lambda: step(x), iters=5, reps=5)
out["bpsk generic step C=16 device busy ms"] = busy_ms(lambda: step(x))
res = step(x)
out["bpsk generic step C=16 sha256"] = digest(*(res[k] for k in (
    "bits", "trust", "symbols", "centres", "mags", "nBits", "bits_voted", "trust_voted")))
print(json.dumps(out))
"""

#: K8 in either tree at the group sizes, C=256 and the big path's S
TURNS["vote"] = """
import hashlib, json, re, sys, time
import torch
assert torch.cuda.is_available(), "no card"
import chip_smoke as c
from pycusdr_tpu_torch.dsp.block import packed_len
from pycusdr_tpu_torch.parallel import vote as pv
""" + PROFILING + """

out = {}
fspec = c.configuration("flagship")[2]
big = c.big_configuration()[2]
cases = [(C, fspec.numSymMax, packed_len(fspec)) for C in (3, 16, 64, 256)]
cases.append((c.GROUP_C, big.numSymMax, packed_len(big)))
for C, S, L in cases:
    tag = f"C={C} S={S}"
    rows, _ = c.vote_input(C, S, L)
    o = torch.empty((2, S), device="cuda")
    fn = lambda: pv.vote_rows(rows, S, 1.2, o)
    out[f"K8 {tag} device ms"] = kernel_ms(fn, "vote")
    out[f"K8 {tag} ms"] = c.cuda_ms(fn)
    out[f"K8 {tag} host us"] = host_us(fn)
    r1, r2 = c.vote_input(C, S, L)[0], c.vote_input(C, S, L)[0]
    p1 = pv.vote_rows(r1, S, 1.2)
    p2 = pv.vote_rows(r2, S, 1.2, master_idx=-1, mask_pad=False)
    out[f"K8 {tag} pairs and rows sha256"] = digest(p1, r1, p2, r2)
print(json.dumps(out))
"""


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def summarize(runs) -> None:
    """One line a quantity: each tree's readings, min-max and median, the
    ratios parent / change; digests held equal across both trees."""
    for key in runs["change"][0]:
        new = [r[key] for r in runs["change"]]
        if key.endswith("vs y_parent"):  # an error against the parent's first turn
            old = [r[key] for r in runs["parent"]]
            print(f"{key}: parent {old} change {new}, at most {max(old + new):.3e}", flush=True)
        elif isinstance(new[0], str):  # a digest: the same in every turn of both trees?
            both = new + [r[key] for r in runs["parent"] if key in r]
            print(f"{key}: {'equal' if len(set(both)) == 1 else 'DIFFERENT'} in all "
                  f"{len(both)} turns: {sorted(set(both))}", flush=True)
        elif key in runs["parent"][0]:
            old = [r[key] for r in runs["parent"]]
            mo, mn = statistics.median(old), statistics.median(new)
            print(f"{key}: parent {min(old):.6g}-{max(old):.6g} (med {mo:.6g}) change "
                  f"{min(new):.6g}-{max(new):.6g} (med {mn:.6g}) parent/change "
                  f"{min(old) / max(new):.3f}-{max(old) / min(new):.3f}, of the medians "
                  f"{mo / mn:.3f}; parent {old} change {new}", flush=True)
        else:
            print(f"{key}: change {min(new):.6g}-{max(new):.6g} (med "
                  f"{statistics.median(new):.6g}); {new}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path, help="root of the other checkout")
    ap.add_argument("--turn", choices=sorted(TURNS), default="viterbi",
                    help="what each turn times (default: viterbi)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times to run parent, change, change, parent (default: 1)")
    ap.add_argument("--summary-of", type=Path, default=None,
                    help="print the summary of the turn lines a run wrote to this file, and "
                         "run nothing")
    args = ap.parse_args()
    runs = {"parent": [], "change": []}
    if args.summary_of is not None:
        for line in args.summary_of.read_text().splitlines():
            if line.startswith('{"tree": '):
                turn = json.loads(line)
                runs[turn.pop("tree")].append(turn)
        summarize(runs)
        return 0
    trees = {"parent": args.parent.resolve(), "change": HERE}
    for name, root in trees.items():
        if not (root / "chip_smoke.py").is_file():
            raise SystemExit(f"{name}: no chip_smoke.py under {root}")
    print(card_line(), flush=True)
    scratch = HERE / "build" / "ab_scratch"
    shutil.rmtree(scratch, ignore_errors=True)
    for name in ("parent", "change", "change", "parent") * args.rounds:
        p = subprocess.run([sys.executable, "-c", TURNS[args.turn], str(BLOCKS), str(HOST_CALLS),
                            str(scratch), str(HERE), str(GRAPH_CALLS)],
                           cwd=trees[name],
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            sys.stderr.write(p.stdout + p.stderr)
            raise SystemExit(f"{name}: the turn failed with code {p.returncode}")
        runs[name].append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps({"tree": name, **runs[name][-1]}), flush=True)
    summarize(runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
