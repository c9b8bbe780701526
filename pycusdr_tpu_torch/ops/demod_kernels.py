"""Demodulation-stage ops: interference spike clipping (kernel K6), the
matched-filter bank reduced over masks (K2), the symbol-timing band
search (K3), symbol detection with bits, trust and the clip window
(K4; with the NRZ-S bits of K4n in the same launch), and K4 split in two
for the generic channel x dopp step: the shard-local window maximum (K4l)
and the cross-shard select that fills the packed row (K4s; with K4n's
NRZ-S bits in the same launch).

Each kernel wrapper takes its plain PyTorch version for a CPU tensor
and launches its hand-written CUDA kernel (``csrc/``) for a CUDA tensor,
or raises; there is no fallback between the two. Semantics follow the
JAX ops exactly: the roll is S[(k + shift) mod N], the lowest mask wins
ties in the column argmax, the earliest sample wins in the symbol
window, and slots are clamped to [0, N - W].
"""

import ctypes
import functools
import math

import numpy as np
import torch

from pycusdr_tpu_torch.ops import _lib
from pycusdr_tpu_torch.ops.layout import PACK_ARRAYS, PACK_SCALARS, SCALAR

#: trust of a bit whose winning sample lies near clipped interference
TRUST_CLIPPED = -2
#: trust of an NRZ-S transition that matches neither table of the LUT
TRUST_SYMBOL_ERROR = -1
#: the clip dilation's half width is clamped here (JAX dilate_mask_dynamic)
CLIP_HW_MAX = 2048
#: samples of a K6 chunk: 256 threads sum a chunk, thread t every 256th
#: sample from t, and the chunks' sums are added in order
K6_CHUNK = 4096
#: K6's cluster form: at most this many CTAs in a row's cluster (above 8 a
#: non-portable size), each taking at most K6_MAX_CHUNKS chunks
K6_MAX_CLUSTER, K6_MAX_CHUNKS = 16, 4


def twiddle_table(N: int, device) -> torch.Tensor:
    """(N, 2) f32 table of exp(+2πi j / N), built in float64 with the
    angle j / N exact, shared by K2 (inverse sign) and K3 (conjugated)."""
    ang = 2.0 * np.pi * (np.arange(N, dtype=np.float64) / N)
    tab = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(tab).to(device)


@functools.lru_cache(maxsize=None)
def fft_factors(N: int) -> tuple:
    """K2's split of N into transform factors, each at most 512, in pass
    order: (N1, N2) with N1 >= N2 up to 2^18 (the two-pass four-step); above
    it N1 = 512 and N / 512 in more factors, as even as can be, the larger
    first, each beyond the second a middle pass."""
    if N < 4 or N & (N - 1):
        raise ValueError(f"K2 needs a power-of-two Nfft >= 4, got {N}")
    log2n = N.bit_length() - 1
    if log2n <= 18:
        n1 = 1 << ((log2n + 1) // 2)
        return n1, N // n1
    rest = log2n - 9
    q = -(-rest // 9)
    return (512, *(1 << (rest // q + (i < rest % q)) for i in range(q)))


def fft_split(N: int) -> int:
    """N1 of K2's four-step split (``fft_factors``)."""
    return fft_factors(N)[0]


# The shared-memory tiles of K2 and K3 (``csrc/fft_smem.cuh``): complex
# elements of a tile, rows of a tile, row length, threads of a block.
FFT_TILE, FFT_MAX_ROWS, FFT_MAX_L, FFT_THREADS = 2048, 32, 512, 256
#: outputs of one K2 pass-2 thread (R * n2 <= K2_OUT * FFT_THREADS)
K2_OUT = 8
#: the card's SMs: K2's pass 2 takes rows per block so that B=1 fills them
SM_COUNT = 132
#: K3's column tile width and its blocks per batch row
K3_CW, K3_GROUPS = 4, 16


def fft_pitch(L: int) -> int:
    """Row pitch (complex elements) of a tile of rows of length L: the
    padded length ``L + L // 16``, rounded up to 2 mod 16."""
    p = L + L // 16
    return p + ((2 - p) & 15)


def fft_radices(L: int):
    """The radices of the Stockham passes over a row of length L: one
    radix-2 or radix-4 pass when log2 L is not a multiple of 3, then
    radix 8."""
    log2l = L.bit_length() - 1
    head = {0: [], 1: [2], 2: [4]}[log2l % 3]
    return head + [8] * (log2l // 3)


#: dynamic shared memory of one K2/K3 block: the padded tile, the row
#: transforms' twiddles and the two 512-entry four-step twiddle tables
FFT_SMEM_BYTES = 8 * (FFT_TILE + FFT_TILE // 16 + 16 * FFT_MAX_ROWS + FFT_MAX_L + 2 * 512)


@functools.lru_cache(maxsize=None)
def timing_band_plan(N: int) -> dict:
    """K3's launch plan, a function of N alone (so a block's bits do not
    depend on the batch): N = n1 * n2, tiles of ``cw`` adjacent columns,
    ``groups`` blocks per batch row each taking ``chunks`` tiles in order."""
    if N < 4 or N & (N - 1):
        raise ValueError(f"K3 needs a power-of-two N >= 4, got {N}")
    n1 = min(N, FFT_MAX_L)
    n2 = N // n1
    cw = min(n2, K3_CW)
    tiles = n2 // cw
    groups = min(tiles, K3_GROUPS)
    return dict(n1=n1, n2=n2, cw=cw, groups=groups, chunks=tiles // groups,
                smem=FFT_SMEM_BYTES, cluster=1)


@functools.lru_cache(maxsize=None)
def mf_bank_plan(N: int, M: int, B: int) -> dict:
    """K2's launch plan: the split N = n1 * n2 (``fft_factors``), ``C``
    columns per pass-1 block, ``R`` rows per pass-2 block (at most 8 and
    2048 / n2 outputs, halved while B * n1 / R blocks would not fill the
    SMs twice, down to 2) and ``Mg`` masks per pass-2 group. Above 2^18,
    ``mid``: the middle factors between n1 and n2, ``Cm`` the columns a
    block of each middle pass, ``grid_mid`` their grids; pass 2 then has a
    block per (tile of R rows, middle digits, b). None of it changes a
    result bit: each output is the same transform and sums its masks in
    increasing order."""
    n1, *mid, n2 = fft_factors(N)
    nmid = math.prod(mid)
    C = min(N // n1, FFT_TILE // n1, FFT_MAX_ROWS)
    R = min(8, n1, K2_OUT * FFT_THREADS // n2)
    while R > 2 and B * nmid * (n1 // R) < 2 * SM_COUNT:
        R //= 2
    Mg = max(1, min(M, FFT_MAX_ROWS // R, FFT_TILE // (R * n2)))
    plan = dict(n1=n1, n2=n2, C=C, R=R, Mg=Mg, grid1=(N // n1 // C, M, B),
                grid2=(n1 // R * nmid, B), smem=FFT_SMEM_BYTES, cluster=1)
    if mid:
        inner = [N // n1 // math.prod(mid[:i + 1]) for i in range(len(mid))]
        Cm = tuple(min(w, FFT_TILE // f, FFT_MAX_ROWS) for f, w in zip(mid, inner))
        plan.update(mid=tuple(mid), Cm=Cm,
                    grid_mid=tuple(B * M * N // (f * w) * (w // c)
                                   for f, w, c in zip(mid, inner, Cm)))
    return plan


def mid_code(plan: dict) -> int:
    """The middle factors' log2 for the kernel: 4 bits each, the first lowest."""
    return sum((f.bit_length() - 1) << (4 * i) for i, f in enumerate(plan.get("mid", ())))


# ---------------------------------------------------------------- K6


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> (B, ceil(N/32)) int32 words; bit i of word w is sample
    32 w + i, the bits past N zero."""
    B, N = mask.shape
    nw = -(-N // 32)
    m = torch.zeros((B, 32 * nw), dtype=torch.int64, device=mask.device)
    m[:, :N] = mask
    w = m.reshape(B, nw, 32) << torch.arange(32, device=mask.device)
    return w.sum(dim=-1).to(torch.int32)


def unpack_bits(words: torch.Tensor, N: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: (B, ceil(N/32)) int32 -> (B, N) bool."""
    bits = (words[:, :, None] >> torch.arange(32, device=words.device, dtype=torch.int32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :N].bool()


@functools.lru_cache(maxsize=None)
def k6_plan(N: int) -> dict:
    """K6's launch plan, a function of N alone (so a block gives the same
    bits alone and in any batch): the row in ``nch`` chunks of K6_CHUNK
    samples. Form "cluster" (nch <= K6_MAX_CLUSTER * K6_MAX_CHUNKS, N <=
    2^18): one launch, a cluster of ``cluster`` CTAs a row, each staging
    ``chunks`` chunks of x in ``smem`` bytes of shared memory with
    ``threads`` (256 a chunk). Form "long": three launches of a CTA a chunk,
    the chunk sums through a (2, B, nch) scratch in device memory. Both add
    every chunk's sum in the order of ``thr_pass1`` (``csrc/threshold.cu``)."""
    if N < 1:
        raise ValueError(f"K6 needs N >= 1, got {N}")
    nch = -(-N // K6_CHUNK)
    if nch > K6_MAX_CLUSTER * K6_MAX_CHUNKS:
        return dict(form="long", nch=nch, chunks=1, cluster=1, threads=256, smem=0)
    k = -(-nch // K6_MAX_CLUSTER)
    return dict(form="cluster", nch=nch, chunks=k, cluster=-(-nch // k), threads=256 * k,
                smem=8 * min(N, k * K6_CHUNK))


def threshold_input_plain(x: torch.Tensor, scale: float):
    """Plain PyTorch K6: the two-pass spike clipping of
    ``ops/demod_kernels.py:27-46`` (JAX), batched. x: (B, N) complex64.
    Returns (clipped signal (B, N) complex64, pass-2 hit mask (B, N) bool).
    |x| is spelled sqrt(re² + im²) and the gains thr / |x|, applied as
    (x · g1) · g2, in JAX's order (``torch.abs`` of a complex tensor is
    hypot, which rounds differently)."""
    re, im = x.real, x.imag
    a = torch.sqrt(re * re + im * im)
    thr = scale * a.mean(dim=-1, keepdim=True)
    hit1 = a > thr
    g1 = torch.where(hit1, thr / torch.where(hit1, a, 1.0), 1.0)
    a1 = torch.where(hit1, thr, a)
    thr2 = scale * a1.mean(dim=-1, keepdim=True)
    hit2 = a1 > thr2
    g2 = torch.where(hit2, thr2 / torch.where(hit2, a1, 1.0), 1.0)
    return torch.complex(re * g1 * g2, im * g1 * g2), hit2


def k6_clusters(N: int) -> int:
    """How many clusters of K6's cluster-form launch at N (``k6_plan``) the
    current card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    plan = k6_plan(N)
    if plan["form"] != "cluster":
        raise ValueError(f"K6 at N={N} runs the long form")
    count = ctypes.c_int(0)
    err = _lib.lib().pycusdr_threshold_clusters(N, plan["chunks"], plan["cluster"],
                                                ctypes.addressof(count))
    if err != 0:
        raise RuntimeError(f"pycusdr_threshold_clusters: CUDA error {err}")
    return count.value


def threshold_input(x: torch.Tensor, scale: float):
    """K6: two-pass spike clipping (see ``threshold_input_plain``).
    Returns (clipped signal (B, N) complex64, pass-2 hits as a (B,
    ceil(N/32)) int32 bitmask (``pack_bits``), clipped_any (B,) int32). The
    signal is written to a new tensor; ``x`` is left as it is. The launch
    is ``k6_plan``'s."""
    if x.device.type == "cpu":
        y, hit2 = threshold_input_plain(x, scale)
        return y, pack_bits(hit2), hit2.any(dim=-1).to(torch.int32)
    if x.device.type != "cuda":
        raise ValueError(f"threshold_input: unsupported device {x.device}")
    B, N = x.shape
    _lib.check(x, "x", torch.complex64, (B, N))
    plan = k6_plan(N)
    long_form = plan["form"] == "long"
    y = torch.empty_like(x)
    part = (torch.empty((2, B, plan["nch"]), dtype=torch.float32, device=x.device)
            if long_form else None)
    hits = torch.empty((B, -(-N // 32)), dtype=torch.int32, device=x.device)
    clipped_any = torch.empty((B,), dtype=torch.int32, device=x.device)
    _lib.launch("pycusdr_threshold", _lib.ptr(x), _lib.ptr(y), _lib.ptr(part), _lib.ptr(hits),
                _lib.ptr(clipped_any), B, N, K6_CHUNK, float(scale), int(long_form),
                plan["chunks"], plan["cluster"])
    threshold_input.launches += 1
    return y, hits, clipped_any


threshold_input.launches = 0


def clip_halfwidth(spSym: torch.Tensor, spsymMin: int) -> torch.Tensor:
    """Half width of the clip dilation, 2·ceil(max(spSym, spsymMin)) as
    int32 (``pycusdr_tpu/dsp/block.py:299-301``)."""
    return 2 * torch.ceil(torch.clamp(spSym, min=float(spsymMin))).to(torch.int32)


def dilate_mask_plain(mask: torch.Tensor, halfwidth: torch.Tensor,
                      hw_max: int = CLIP_HW_MAX) -> torch.Tensor:
    """Binary dilation of (B, N) bool by a per-block half width (B,), as
    ``ops/demod_kernels.py:622-648`` (JAX) counts it: sample i is set when
    any sample of [max(i - hw, 0), min(i + hw, N - 1)] is, with hw clamped
    to [0, hw_max]."""
    B, N = mask.shape
    c = torch.cumsum(mask.to(torch.int32), dim=-1)
    hw = torch.clamp(halfwidth.long(), 0, hw_max)[:, None]
    i = torch.arange(N, device=mask.device)[None, :]
    hi = torch.gather(c, 1, torch.clamp(i + hw, max=N - 1))
    lo_i = i - hw - 1
    lo = torch.where(lo_i >= 0, torch.gather(c, 1, torch.clamp(lo_i, min=0)), 0)
    return (hi - lo) > 0


# ---------------------------------------------------------------- K2


def _rolled(S: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    N = S.shape[-1]
    idx = (torch.arange(N, device=S.device)[None, :] + shift.long()[:, None]) % N
    return torch.gather(S, 1, idx.expand(S.shape[0], -1))


def mf_bank_power_plain(S: torch.Tensor, masks: torch.Tensor, shift: torch.Tensor):
    """|N * ifft(S[(k + shift) mod N] * masks_f[m])|^2, (B, M, N) f32."""
    X = torch.fft.ifft(_rolled(S, shift)[:, None, :] * masks[None], norm="forward")
    return X.real * X.real + X.imag * X.imag


def mf_bank_colreduce_plain(S, masks, shift, sum_lo: int, sum_hi: int):
    """Plain PyTorch K2. S: (B, N) c64; masks: (M, N) c64; shift: (B,)
    int32, or (1,) for one shift of every block. Returns (colsum, colmax,
    colargmax), each (B, N)."""
    Pw = mf_bank_power_plain(S, masks, shift)
    return (Pw[:, sum_lo:sum_hi].sum(dim=1), Pw.amax(dim=1),
            torch.argmax(Pw, dim=1).to(torch.int32))


def mf_bank_colreduce(S: torch.Tensor, masks: torch.Tensor, shift: torch.Tensor,
                      sum_lo: int, sum_hi: int, tw: torch.Tensor = None):
    """K2: the best-Doppler matched-filter bank, reduced over the mask
    axis (see ``mf_bank_colreduce_plain``). ``tw``: the ``twiddle_table``
    of N on the device (built here when None)."""
    dev = S.device
    if dev.type == "cpu":
        return mf_bank_colreduce_plain(S, masks, shift, sum_lo, sum_hi)
    if dev.type != "cuda":
        raise ValueError(f"mf_bank_colreduce: unsupported device {dev}")
    B, N = S.shape
    M = masks.shape[0]
    if not 0 <= sum_lo <= sum_hi <= M:
        raise ValueError(f"mask sum range [{sum_lo}, {sum_hi}) outside [0, {M})")
    if tuple(shift.shape) not in ((B,), (1,)):
        raise ValueError(f"shift: expected shape ({B},) or (1,), got {tuple(shift.shape)}")
    if tw is None:
        tw = twiddle_table(N, dev)
    _lib.check(S, "S", torch.complex64, (B, N))
    _lib.check(masks, "masks", torch.complex64, (M, N), dev)
    _lib.check(shift, "shift", torch.int32, None, dev)
    _lib.check(tw, "tw", torch.float32, (N, 2), dev)
    plan = mf_bank_plan(N, M, B)
    Y = torch.empty((B, M, N), dtype=torch.complex64, device=dev)
    colsum = torch.empty((B, N), dtype=torch.float32, device=dev)
    colmax = torch.empty((B, N), dtype=torch.float32, device=dev)
    colarg = torch.empty((B, N), dtype=torch.int32, device=dev)
    _lib.launch("pycusdr_mf_bank_colreduce", _lib.ptr(S), _lib.ptr(masks), _lib.ptr(shift),
                int(shift.shape[0] == B), _lib.ptr(tw), _lib.ptr(Y), _lib.ptr(colsum),
                _lib.ptr(colmax), _lib.ptr(colarg), B, N, M, plan["n1"], plan["C"], plan["R"],
                plan["Mg"], sum_lo, sum_hi, mid_code(plan))
    mf_bank_colreduce.launches += 1
    return colsum, colmax, colarg


mf_bank_colreduce.launches = 0


# ---------------------------------------------------------------- K3


def timing_band_plain(x: torch.Tensor, lo: int, hi: int):
    """Plain PyTorch K3 (rfft, then the band argmax). x: (B, N) f32.
    Returns (spSym, codeOffset, code_val), each (B,) f32."""
    N = x.shape[-1]
    R = torch.fft.rfft(x)[:, lo:hi]
    br, bi = R.real, R.imag
    band_pow = br * br + bi * bi
    k_rel = torch.argmax(band_pow, dim=-1, keepdim=True)  # first index wins
    val = torch.gather(band_pow, -1, k_rel)[:, 0]
    phase = torch.atan2(torch.gather(bi, -1, k_rel), torch.gather(br, -1, k_rel))[:, 0]
    k = (k_rel[:, 0] + lo).float()
    spSym = N / k
    codeOffset = -phase / math.pi * spSym / 2
    codeOffset = torch.where(codeOffset < 0, codeOffset + spSym - 1, codeOffset)
    return spSym, codeOffset, val


def timing_band(x: torch.Tensor, lo: int, hi: int, tw: torch.Tensor = None):
    """K3: symbol rate and timing from the forward DFT of the mask-summed
    power at bins [lo, hi) (see ``timing_band_plain``)."""
    dev = x.device
    if dev.type == "cpu":
        return timing_band_plain(x, lo, hi)
    if dev.type != "cuda":
        raise ValueError(f"timing_band: unsupported device {dev}")
    B, N = x.shape
    if not 0 <= lo < hi <= N // 2 + 1:
        raise ValueError(f"band [{lo}, {hi}) outside the rfft bins of N={N}")
    plan = timing_band_plan(N)
    if tw is None:
        tw = twiddle_table(N, dev)
    _lib.check(x, "x", torch.float32, (B, N))
    _lib.check(tw, "tw", torch.float32, (N, 2), dev)
    part = torch.empty((B, plan["groups"], hi - lo, 2), dtype=torch.float32, device=dev)
    out = torch.empty((3, B), dtype=torch.float32, device=dev)
    o = out.data_ptr()
    _lib.launch("pycusdr_timing_band", _lib.ptr(x), _lib.ptr(tw), _lib.ptr(part), o, o + 4 * B,
                o + 8 * B, B, N, lo, hi, plan["n1"], plan["cw"], plan["groups"])
    timing_band.launches += 1
    return out.unbind(0)


timing_band.launches = 0


# ---------------------------------------------------------------- K4

#: up to this many slots a launch (B x numSymMax), K4 reads colargmax with
#: colmax's windows and gives each of 64 threads a CTA one slot: B=1 is
#: latency-bound
K4_LATENCY_SLOTS = 16384
#: from this many slots a launch, a K4 thread takes two slots: fewer CTAs
K4_TWO_SLOTS = 2 ** 18
#: the 16-byte chunks of a K4 window: at most 3 for windows up to 9 samples
#: (``csrc/symbol_detect.cu:kMaxChunkW``); clip words held in registers
K4_MAX_CHUNK_W, K4_REG_WORDS = 9, 4


@functools.lru_cache(maxsize=256)
def k4_plan(B: int, S: int):
    """K4's launch for B blocks of S slots: (threads a CTA, slots a thread,
    whether colargmax is read with colmax's windows). It changes no bit,
    only the order and the grouping of the reads."""
    if B * S <= K4_LATENCY_SLOTS:
        return 64, 1, True
    return 128, 2 if B * S >= K4_TWO_SLOTS else 1, False


def _slot_geometry(spSym, codeOffset, W: int, N: int, S: int, spsymMin: int):
    """K4's slot arithmetic, one rounded f32 op at a time: (spc, x*spc -
    W/2, A0, A clamped to [0, N - W]), each (B, S) but spc (B,)."""
    spc = torch.clamp(spSym, min=float(spsymMin))
    x = torch.arange(S, dtype=torch.float32, device=spSym.device)
    xs = x[None, :] * spc[:, None] - W // 2
    A0 = torch.trunc(xs + codeOffset[:, None]).to(torch.int32)
    return spc, xs, A0, torch.clamp(A0, 0, max(N - W, 0)).long()


def symbol_detect_plain(colmax, colarg, spSym, codeOffset, bitLUT, *, Nfft: int,
                        windowWidth: int, spsymMin: int, numSymMax: int,
                        trust_normal: int, clip_mask: torch.Tensor = None):
    """Plain PyTorch K4. colmax: (B, N) f32; colarg: (B, N) i32; spSym,
    codeOffset: (B,) f32; bitLUT: (M,) int8. Returns (symbols, centres,
    mags, bits, trust, nSym). The f32 slot arithmetic is one rounded op
    at a time, as in the JAX op.

    ``bitLUT`` None (NRZ-S protocols): bits 0, for ``nrzs_bits_plain``.
    ``clip_mask``: the dilated (B, N) bool clip mask (``dilate_mask_plain``).
    It is sampled at each slot's winning sample, as ``find_centres``
    samples it (``ops/demod_kernels.py:476-480,572-583``, JAX); those
    slots get trust -2, and the sampled mask is a 7th output, at_win."""
    B, N = colmax.shape
    W = windowWidth
    spc, xs, A0, A = _slot_geometry(spSym, codeOffset, W, N, numSymMax, spsymMin)
    comp = torch.trunc(codeOffset).to(torch.int32)[:, None] - torch.clamp(A0, max=0)
    idx = A[:, :, None] + torch.arange(W, device=colmax.device)  # (B, S, W)
    win = torch.gather(colmax, 1, idx.reshape(B, -1)).reshape(B, numSymMax, W)
    k = torch.argmax(win, dim=-1, keepdim=True)  # first index: earliest wins
    mags = torch.gather(win, -1, k)[..., 0]
    j = A + k[..., 0]
    symbols = torch.gather(colarg, 1, j)
    k = k[..., 0].to(torch.int32)
    centres = torch.trunc(xs + k.float()).to(torch.int32) + comp
    nSym = (Nfft / spc).to(torch.int32)
    bits = (torch.zeros_like(symbols, dtype=torch.int8) if bitLUT is None
             else bitLUT[symbols.long()])
    trust = torch.full_like(bits, trust_normal)
    if clip_mask is None:
        return symbols, centres, mags, bits, trust, nSym
    at_win = torch.gather(clip_mask, 1, j)
    trust = torch.where(at_win, torch.tensor(TRUST_CLIPPED, dtype=torch.int8), trust)
    return symbols, centres, mags, bits, trust, nSym, at_win


def _write_row_k4(row, out, S, spSym, codeOffset, code_val, clipped_any):
    """Write K4's outputs into the packed rows (the CPU side of ``row``)."""
    symbols, centres, mags, bits, trust, nSym = out[:6]
    arrays = {"bits": bits, "trust": trust, "symbols": symbols, "centres": centres,
              "mags": mags}
    for i, k in enumerate(PACK_ARRAYS):
        row[:, i * S:(i + 1) * S] = arrays[k].float()
    tail = row[:, len(PACK_ARRAYS) * S:]
    for k, v in (("nSym", nSym), ("nBits", nSym), ("spSym", spSym),
                 ("codeOffset", codeOffset), ("code_val", code_val)):
        tail[:, SCALAR[k]] = v.float()
    tail[:, SCALAR["clipped_any"]] = 0.0 if clipped_any is None else (clipped_any != 0).float()


def symbol_detect(colmax, colarg, spSym, codeOffset, bitLUT, *, Nfft: int,
                  windowWidth: int, spsymMin: int, numSymMax: int, trust_normal: int,
                  hits: torch.Tensor = None, row: torch.Tensor = None,
                  code_val: torch.Tensor = None, clipped_any: torch.Tensor = None,
                  symbolLUT: torch.Tensor = None):
    """K4: windowed symbol detection with the LUT bits and trust fill
    (see ``symbol_detect_plain``). spSym and codeOffset stay on the
    device: the kernel reads them by pointer.

    ``hits``: K6's pass-2 hits as a (B, ceil(Nfft/32)) int32 bitmask. A slot
    whose winning sample j has a hit within [j - hw, j + hw], hw =
    ``clip_halfwidth`` clamped to [0, 2048], gets trust -2; the result
    then has at_win as a 7th output.

    ``row``: the (B, L) f32 packed rows (``ops/layout.py``). The arrays
    and the scalars nSym, nBits, spSym, codeOffset, ``code_val`` (B,) and
    ``clipped_any`` (B,) int32 (0 when None) are written there instead,
    and ``row`` is returned.

    ``symbolLUT``: the (M, 2, K) int32 NRZ-S LUT of a protocol without a
    centre-bit LUT (``bitLUT`` None), with ``row`` only: the same launch
    then writes what ``nrzs_rows_plain`` writes over K4's row (the NRZ-S
    bits, trust -1 on a transition error, nBits = nSym - 1), and counts in
    ``symbol_detect_nrzs.launches`` too. Its plain version is
    ``symbol_detect_plain`` and then ``nrzs_rows_plain``."""
    if symbolLUT is not None:
        if row is None or bitLUT is not None:
            raise ValueError("symbol_detect: the NRZ-S form writes the packed row and takes "
                             "no centre-bit LUT")
        if symbolLUT.dim() != 3 or symbolLUT.shape[1] != 2:
            raise ValueError(f"symbol_detect: symbolLUT must be (M, 2, K), got "
                             f"{tuple(symbolLUT.shape)}")
    if colmax.device.type == "cpu":
        clip = None
        if hits is not None:
            clip = dilate_mask_plain(unpack_bits(hits, colmax.shape[1]),
                                     clip_halfwidth(spSym, spsymMin))
        out = symbol_detect_plain(colmax, colarg, spSym, codeOffset, bitLUT, Nfft=Nfft,
                                  windowWidth=windowWidth, spsymMin=spsymMin,
                                  numSymMax=numSymMax, trust_normal=trust_normal,
                                  clip_mask=clip)
        if row is None:
            return out
        _write_row_k4(row, out, numSymMax, spSym, codeOffset, code_val, clipped_any)
        return row if symbolLUT is None else nrzs_rows_plain(row, symbolLUT, numSymMax)
    if colmax.device.type != "cuda":
        raise ValueError(f"symbol_detect: unsupported device {colmax.device}")
    B, N = colmax.shape
    dev = colmax.device
    S = numSymMax
    if N != Nfft or not 0 < windowWidth <= N:
        raise ValueError(f"symbol_detect: bad shape N={N} Nfft={Nfft} W={windowWidth}")
    _lib.check(colmax, "colmax", torch.float32, (B, N))
    _lib.check(colarg, "colargmax", torch.int32, (B, N), dev)
    _lib.check(spSym, "spSym", torch.float32, (B,), dev)
    _lib.check(codeOffset, "codeOffset", torch.float32, (B,), dev)
    if bitLUT is not None:
        _lib.check(bitLUT, "bitLUT", torch.int8, None, dev)
    if hits is not None:
        _lib.check(hits, "hits", torch.int32, (B, -(-N // 32)), dev)
    if clipped_any is not None:
        _lib.check(clipped_any, "clipped_any", torch.int32, (B,), dev)
    lut_mk = (0, 0)
    if symbolLUT is not None:
        _lib.check(symbolLUT, "symbolLUT", torch.int32, None, dev)
        lut_mk = (symbolLUT.shape[0], symbolLUT.shape[2])
    if row is not None:
        _lib.check(row, "row", torch.float32, None, dev)
        if row.shape[0] != B or row.shape[1] < len(PACK_ARRAYS) * S + len(PACK_SCALARS):
            raise ValueError(f"symbol_detect: row shape {tuple(row.shape)} too small")
        if code_val is None:
            raise ValueError("symbol_detect: writing the row needs code_val")
        _lib.check(code_val, "code_val", torch.float32, (B,), dev)
        typed = (None,) * 6
    else:
        typed = (torch.empty((B, S), dtype=torch.int32, device=dev),
                 torch.empty((B, S), dtype=torch.int32, device=dev),
                 torch.empty((B, S), dtype=torch.float32, device=dev),
                 torch.empty((B, S), dtype=torch.int8, device=dev),
                 torch.empty((B, S), dtype=torch.int8, device=dev),
                 torch.empty((B,), dtype=torch.int32, device=dev))
    _lib.launch("pycusdr_symbol_detect", _lib.ptr(colmax), _lib.ptr(colarg), _lib.ptr(spSym),
                _lib.ptr(codeOffset), _lib.ptr(bitLUT), _lib.ptr(symbolLUT), _lib.ptr(hits),
                _lib.ptr(code_val), _lib.ptr(clipped_any), *map(_lib.ptr, typed),
                _lib.ptr(row), 0 if row is None else row.shape[1], B, N, windowWidth,
                spsymMin, S, trust_normal, CLIP_HW_MAX, *lut_mk, *k4_plan(B, S))
    symbol_detect.launches += 1
    if symbolLUT is not None:
        symbol_detect_nrzs.launches += 1
    if row is not None:
        return row
    if hits is None:
        return typed
    return typed + (typed[4] == TRUST_CLIPPED,)


symbol_detect.launches = 0


def symbol_detect_nrzs(colmax, colarg, spSym, codeOffset, symbolLUT, *, row: torch.Tensor,
                       code_val: torch.Tensor, **kw) -> torch.Tensor:
    """K4 and K4n in one launch (the NRZ-S block graph's step):
    ``symbol_detect`` with no centre-bit LUT and the (M, 2, K) int32
    ``symbolLUT``, into the packed rows ``row``, which are returned. Its
    launches count here and in ``symbol_detect.launches``."""
    return symbol_detect(colmax, colarg, spSym, codeOffset, None, row=row, code_val=code_val,
                         symbolLUT=symbolLUT, **kw)


symbol_detect_nrzs.launches = 0


# ------------------------------------------ K4n (in K4's and in K4s's launch)


def nrzs_bits_plain(symbols: torch.Tensor, symbolLUT: torch.Tensor):
    """Plain PyTorch K4n: ``extract_bits_nrzs`` (``ops/demod_kernels.py:
    597-619``, JAX) along the last axis. symbols: (..., S) int; symbolLUT:
    (M, 2, K) int. bits[i] is 1 when symbols[i+1 mod S] is one of
    symbolLUT[symbols[i], 0], 0 when it is one of symbolLUT[symbols[i],
    1]; matching neither is an error (bit 0). A symbol outside [0, M)
    selects all-zero tables, as JAX's one-hot select does. Returns (bits
    int8, err bool)."""
    s_next = torch.roll(symbols, -1, dims=-1)
    M = symbolLUT.shape[0]
    inside = ((symbols >= 0) & (symbols < M))[..., None]
    rows = symbolLUT[symbols.clamp(0, M - 1).long()]  # (..., S, 2, K)
    ones = torch.where(inside, rows[..., 0, :], 0)
    zeros = torch.where(inside, rows[..., 1, :], 0)
    res1 = (s_next[..., None] == ones).any(dim=-1)
    res0 = (s_next[..., None] == zeros).any(dim=-1)
    err = ~(res1 | res0)
    return torch.where(err, 0, res1.to(torch.int8)).to(torch.int8), err


def nrzs_trust_plain(trust: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """Trust -1 on an NRZ-S error, where the clip window has not set -2
    (JAX sets -1 first, then -2: ``dsp/block.py:318-331``)."""
    return torch.where(err & (trust != TRUST_CLIPPED),
                       torch.tensor(TRUST_SYMBOL_ERROR, dtype=trust.dtype), trust)


def nrzs_rows_plain(row: torch.Tensor, symbolLUT: torch.Tensor, numSymMax: int) -> torch.Tensor:
    """K4n on the packed rows that K4 or K4s wrote, in place: bits from the
    symbols (``nrzs_bits_plain``), trust -1 on an error
    (``nrzs_trust_plain``), nBits = nSym - 1. The plain version of the NRZ-S
    forms of K4 (``symbol_detect_nrzs``) and K4s (``shard_select_nrzs``)
    after their centre-bit forms with bits 0."""
    S = numSymMax
    tail = len(PACK_ARRAYS) * S
    bits, err = nrzs_bits_plain(row[:, 2 * S:3 * S].to(torch.int32), symbolLUT)
    row[:, :S] = bits.float()
    row[:, S:2 * S] = nrzs_trust_plain(row[:, S:2 * S], err)
    row[:, tail + SCALAR["nBits"]] = row[:, tail + SCALAR["nSym"]] - 1
    return row


# ---------------------------------------------------------------- K4l, K4s


def symbol_detect_local_plain(colmax, colarg, spSym, codeOffset, *, m0: int, M: int,
                              Nfft: int, windowWidth: int, spsymMin: int, numSymMax: int):
    """Plain PyTorch K4l: ``_local_find_centres`` of
    ``pycusdr_tpu/parallel/sharded_demod.py:46-104`` (JAX). colmax,
    colarg: (B, N) f32 / i32 over the shard's masks (K2's, local indices);
    m0: the shard's first global mask; M: all masks. Returns (val (B, S)
    f32, the window maximum with the earliest sample winning; key (B, S)
    i32, k_win * M + (m0 + m_local))."""
    B, N = colmax.shape
    W = windowWidth
    _, _, _, A = _slot_geometry(spSym, codeOffset, W, N, numSymMax, spsymMin)
    idx = A[:, :, None] + torch.arange(W, device=colmax.device)  # (B, S, W)
    win = torch.gather(colmax, 1, idx.reshape(B, -1)).reshape(B, numSymMax, W)
    k = torch.argmax(win, dim=-1, keepdim=True)  # first index: earliest wins
    val = torch.gather(win, -1, k)[..., 0]
    m_l = torch.gather(colarg, 1, A + k[..., 0])
    return val, (k[..., 0] * M + m0 + m_l).to(torch.int32)


def pack_pairs(vals: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(..., S) f32 values and int32 keys -> one (..., S, 2) int32 buffer of
    (value bits, key) pairs, K4l's output layout."""
    return torch.stack([vals.view(torch.int32), keys.to(torch.int32)], dim=-1)


def pair_views(pairs: torch.Tensor):
    """(values f32, keys int32) of a (..., S, 2) int32 pair buffer, as views."""
    return pairs[..., 0].view(torch.float32), pairs[..., 1]


def symbol_detect_local(colmax, colarg, spSym, codeOffset, *, m0: int, M: int, Nfft: int,
                        windowWidth: int, spsymMin: int, numSymMax: int, packed: bool = False):
    """K4l: the shard-local half of the symbol detector (see
    ``symbol_detect_local_plain``), on K4's window reader and ``k4_plan``.
    spSym and codeOffset stay on the device. It writes each slot's (value,
    key) as one 8-byte word of a (B, S, 2) int32 buffer (``pack_pairs``),
    which ``packed`` returns, for one all-gather and ``shard_select``;
    otherwise (val, key) as views of it (``pair_views``)."""
    kw = dict(m0=m0, M=M, Nfft=Nfft, windowWidth=windowWidth, spsymMin=spsymMin,
              numSymMax=numSymMax)
    if colmax.device.type == "cpu":
        val, key = symbol_detect_local_plain(colmax, colarg, spSym, codeOffset, **kw)
        return pack_pairs(val, key) if packed else (val, key)
    if colmax.device.type != "cuda":
        raise ValueError(f"symbol_detect_local: unsupported device {colmax.device}")
    B, N = colmax.shape
    dev = colmax.device
    if N != Nfft or not 0 < windowWidth <= N or not 0 <= m0 < M:
        raise ValueError(f"symbol_detect_local: bad shape N={N} Nfft={Nfft} W={windowWidth} "
                         f"m0={m0} M={M}")
    _lib.check(colmax, "colmax", torch.float32, (B, N))
    _lib.check(colarg, "colargmax", torch.int32, (B, N), dev)
    _lib.check(spSym, "spSym", torch.float32, (B,), dev)
    _lib.check(codeOffset, "codeOffset", torch.float32, (B,), dev)
    pair = torch.empty((B, numSymMax, 2), dtype=torch.int32, device=dev)
    _lib.launch("pycusdr_symbol_detect_local", _lib.ptr(colmax), _lib.ptr(colarg),
                _lib.ptr(spSym), _lib.ptr(codeOffset), _lib.ptr(pair), B, N, windowWidth,
                spsymMin, numSymMax, M, m0, *k4_plan(B, numSymMax))
    symbol_detect_local.launches += 1
    return pair if packed else pair_views(pair)


symbol_detect_local.launches = 0


@functools.lru_cache(maxsize=256)
def k4s_plan(B: int, S: int, nd: int):
    """K4s's launch for B blocks of S slots over nd shards: (threads a CTA,
    slots a thread), at ``k4_plan``'s edges; two slots a thread only for nd
    <= 2 (at nd = 4 a thread holds twice the pairs, and two slots' worth of
    registers halve the threads an SM holds). It changes no bit."""
    if B * S <= K4_LATENCY_SLOTS:
        return 64, 1
    return 128, 2 if B * S >= K4_TWO_SLOTS and nd <= 2 else 1


def shard_select_plain(vals, keys, spSym, codeOffset, bitLUT, *, M: int, Nfft: int,
                       windowWidth: int, spsymMin: int, numSymMax: int, trust_normal: int,
                       clip_mask: torch.Tensor = None):
    """Plain PyTorch K4s: the cross-shard lexicographic select and the
    tail of ``pycusdr_tpu/parallel/sharded_demod.py:361-411`` (JAX).
    vals, keys: (nd, B, S) from ``symbol_detect_local`` on every shard.
    The largest value wins, among equal values the smallest key. Returns
    (symbols, centres, mags, bits, trust, nSym) as ``symbol_detect_plain``,
    but with trust -1 at slots >= nSym. ``bitLUT`` None: bits 0 (NRZ-S).
    ``clip_mask``: the dilated (B, N) bool clip mask, sampled at each slot's
    winning sample (trust -2)."""
    N, W, S = Nfft, windowWidth, numSymMax
    best = vals.amax(dim=0)
    big = torch.iinfo(torch.int32).max
    g = torch.where(vals == best[None], keys, big).amin(dim=0)
    symbols, k = g % M, g // M
    spc, xs, A0, A = _slot_geometry(spSym, codeOffset, W, N, S, spsymMin)
    comp = torch.trunc(codeOffset).to(torch.int32)[:, None] - torch.clamp(A0, max=0)
    centres = torch.trunc(xs + k.float()).to(torch.int32) + comp
    nSym = (Nfft / spc).to(torch.int32)
    slot = torch.arange(S, device=vals.device)
    trust = torch.where(slot[None, :] < nSym[:, None], trust_normal, -1).to(torch.int8)
    bits = (torch.zeros_like(symbols, dtype=torch.int8) if bitLUT is None
            else bitLUT[symbols.long()])
    if clip_mask is not None:
        at_win = torch.gather(clip_mask, 1, torch.clamp(A + k, 0, N - 1))
        trust = torch.where(at_win, torch.tensor(TRUST_CLIPPED, dtype=torch.int8), trust)
    return symbols.to(torch.int32), centres, best, bits, trust, nSym


def shard_select_rows_plain(vals, keys, spSym, codeOffset, bitLUT, *, M: int, Nfft: int,
                           windowWidth: int, spsymMin: int, numSymMax: int, trust_normal: int,
                           row: torch.Tensor, code_val: torch.Tensor, hits: torch.Tensor = None,
                           clipped_any: torch.Tensor = None) -> torch.Tensor:
    """The plain version of ``shard_select``: ``shard_select_plain`` with the
    clip mask dilated from ``hits``, written into the packed rows."""
    clip = None
    if hits is not None:
        clip = dilate_mask_plain(unpack_bits(hits, Nfft), clip_halfwidth(spSym, spsymMin))
    out = shard_select_plain(vals, keys, spSym, codeOffset, bitLUT, M=M, Nfft=Nfft,
                             windowWidth=windowWidth, spsymMin=spsymMin, numSymMax=numSymMax,
                             trust_normal=trust_normal, clip_mask=clip)
    _write_row_k4(row, out, numSymMax, spSym, codeOffset, code_val, clipped_any)
    return row


def shard_select(pairs, spSym, codeOffset, bitLUT, *, M: int, Nfft: int, windowWidth: int,
                 spsymMin: int, numSymMax: int, trust_normal: int, row: torch.Tensor,
                 code_val: torch.Tensor, hits: torch.Tensor = None,
                 clipped_any: torch.Tensor = None,
                 symbolLUT: torch.Tensor = None) -> torch.Tensor:
    """K4s: the cross-shard select (see ``shard_select_plain``) of the (nd,
    B, S, 2) int32 pairs that ``symbol_detect_local(packed=True)`` wrote on
    every shard (``pack_pairs``; keys >= 0), written into the (B, L) f32
    packed rows: the five arrays and the scalars nSym, nBits = nSym, spSym,
    codeOffset, ``code_val`` (B,) and ``clipped_any`` (B,) int32 (0 when
    None). ``hits``: K6's (B, ceil(Nfft/32)) int32 bitmask; a slot whose
    winning sample has a hit within ``clip_halfwidth`` (clamped to 2048)
    gets trust -2. The launch is ``k4s_plan``'s. Returns ``row``.

    ``symbolLUT``: the (M, 2, K) int32 NRZ-S LUT of a protocol without a
    centre-bit LUT (``bitLUT`` None): the same launch then writes K4n's
    NRZ-S bits, trust -1 on a transition error and nBits = nSym - 1, and
    counts in ``shard_select_nrzs.launches`` too. Its plain version is
    ``shard_select_rows_plain`` and then ``nrzs_rows_plain``."""
    kw = dict(M=M, Nfft=Nfft, windowWidth=windowWidth, spsymMin=spsymMin, numSymMax=numSymMax,
              trust_normal=trust_normal)
    S = numSymMax
    if pairs.dim() != 4 or pairs.shape[2:] != (S, 2):
        raise ValueError(f"shard_select: pairs {tuple(pairs.shape)} must be (nd, B, {S}, 2)")
    nd, B = pairs.shape[:2]
    if row.shape[0] != B or row.shape[1] < len(PACK_ARRAYS) * S + len(PACK_SCALARS):
        raise ValueError(f"shard_select: row shape {tuple(row.shape)} too small")
    if symbolLUT is not None:
        if bitLUT is not None:
            raise ValueError("shard_select: the NRZ-S form takes no centre-bit LUT")
        if symbolLUT.dim() != 3 or symbolLUT.shape[1] != 2:
            raise ValueError(f"shard_select: symbolLUT must be (M, 2, K), got "
                             f"{tuple(symbolLUT.shape)}")
    if pairs.device.type == "cpu":
        vals, keys = pair_views(pairs)
        shard_select_rows_plain(vals, keys, spSym, codeOffset, bitLUT, **kw, row=row,
                                code_val=code_val, hits=hits, clipped_any=clipped_any)
        return row if symbolLUT is None else nrzs_rows_plain(row, symbolLUT, S)
    if pairs.device.type != "cuda":
        raise ValueError(f"shard_select: unsupported device {pairs.device}")
    dev = pairs.device
    if not 0 < windowWidth <= Nfft:
        raise ValueError(f"shard_select: bad window W={windowWidth} for Nfft={Nfft}")
    _lib.check(pairs, "pairs", torch.int32, (nd, B, S, 2))
    _lib.check(spSym, "spSym", torch.float32, (B,), dev)
    _lib.check(codeOffset, "codeOffset", torch.float32, (B,), dev)
    _lib.check(code_val, "code_val", torch.float32, (B,), dev)
    _lib.check(row, "row", torch.float32, None, dev)
    if bitLUT is not None:
        _lib.check(bitLUT, "bitLUT", torch.int8, (M,), dev)
    if hits is not None:
        _lib.check(hits, "hits", torch.int32, (B, -(-Nfft // 32)), dev)
    if clipped_any is not None:
        _lib.check(clipped_any, "clipped_any", torch.int32, (B,), dev)
    lut_mk = (0, 0)
    if symbolLUT is not None:
        _lib.check(symbolLUT, "symbolLUT", torch.int32, None, dev)
        lut_mk = (symbolLUT.shape[0], symbolLUT.shape[2])
    _lib.launch("pycusdr_shard_select", _lib.ptr(pairs), nd, _lib.ptr(spSym),
                _lib.ptr(codeOffset), _lib.ptr(bitLUT), _lib.ptr(symbolLUT), _lib.ptr(hits),
                _lib.ptr(code_val), _lib.ptr(clipped_any), _lib.ptr(row), row.shape[1], B, Nfft,
                windowWidth, spsymMin, S, M, trust_normal, CLIP_HW_MAX, *lut_mk,
                *k4s_plan(B, S, nd))
    shard_select.launches += 1
    if symbolLUT is not None:
        shard_select_nrzs.launches += 1
    return row


shard_select.launches = 0


def shard_select_nrzs(pairs, spSym, codeOffset, symbolLUT, *, row: torch.Tensor,
                      code_val: torch.Tensor, **kw) -> torch.Tensor:
    """K4s and K4n in one launch (the generic step's NRZ-S select):
    ``shard_select`` with no centre-bit LUT and the (M, 2, K) int32
    ``symbolLUT``, into the packed rows ``row``, which are returned. Its
    launches count here and in ``shard_select.launches``."""
    return shard_select(pairs, spSym, codeOffset, None, row=row, code_val=code_val,
                        symbolLUT=symbolLUT, **kw)


shard_select_nrzs.launches = 0
