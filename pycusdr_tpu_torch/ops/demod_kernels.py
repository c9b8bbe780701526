"""Demodulation-stage ops: interference spike clipping (kernel K6), the
matched-filter bank reduced over masks (K2), the symbol-timing band
search (K3), symbol detection with bits, trust and the clip window
(K4), NRZ-S bit extraction over K4's symbols (K4n), and K4 split in two
for the generic channel x dopp step: the shard-local window maximum (K4l)
and the cross-shard select that fills the packed row (K4s).

Each kernel wrapper takes its plain PyTorch version for a CPU tensor
and launches its hand-written CUDA kernel (``csrc/``) for a CUDA tensor,
or raises; there is no fallback between the two. Semantics follow the
JAX ops exactly: the roll is S[(k + shift) mod N], the lowest mask wins
ties in the column argmax, the earliest sample wins in the symbol
window, and slots are clamped to [0, N - W].
"""

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
#: samples per K6 block; the partial sums of the chunks are added in order
K6_CHUNK = 4096


def twiddle_table(N: int, device) -> torch.Tensor:
    """(N, 2) f32 table of exp(+2πi j / N), built in float64 with the
    angle j / N exact, shared by K2 (inverse sign) and K3 (conjugated)."""
    ang = 2.0 * np.pi * (np.arange(N, dtype=np.float64) / N)
    tab = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(tab).to(device)


def fft_split(N: int) -> int:
    """N1 of K2's four-step split N = N1 * N2 (N1 >= N2, both <= 512)."""
    if N < 4 or N & (N - 1) or N > 1 << 18:
        raise ValueError(f"K2 needs a power-of-two Nfft in [4, 2^18], got {N}")
    log2n = N.bit_length() - 1
    return 1 << ((log2n + 1) // 2)


# ---------------------------------------------------------------- K6


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> (B, N/32) int32 words; bit i of word w is sample 32 w + i."""
    B, N = mask.shape
    w = mask.reshape(B, N // 32, 32).to(torch.int64) << torch.arange(32, device=mask.device)
    return w.sum(dim=-1).to(torch.int32)


def unpack_bits(words: torch.Tensor, N: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: (B, N/32) int32 -> (B, N) bool."""
    bits = (words[:, :, None] >> torch.arange(32, device=words.device, dtype=torch.int32)) & 1
    return bits.reshape(words.shape[0], N).bool()


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


def threshold_input(x: torch.Tensor, scale: float):
    """K6: two-pass spike clipping (see ``threshold_input_plain``).
    Returns (clipped signal (B, N) complex64, pass-2 hits as a (B, N/32)
    int32 bitmask (``pack_bits``), clipped_any (B,) int32). The signal is
    written to a new tensor; ``x`` is left as it is."""
    if x.device.type == "cpu":
        y, hit2 = threshold_input_plain(x, scale)
        return y, pack_bits(hit2), hit2.any(dim=-1).to(torch.int32)
    if x.device.type != "cuda":
        raise ValueError(f"threshold_input: unsupported device {x.device}")
    B, N = x.shape
    if N % 32:
        raise ValueError(f"threshold_input: N must be a multiple of 32, got {N}")
    _lib.check(x, "x", torch.complex64, (B, N))
    nch = -(-N // K6_CHUNK)
    y = torch.empty_like(x)
    part = torch.empty((2, B, nch), dtype=torch.float32, device=x.device)
    hits = torch.empty((B, N // 32), dtype=torch.int32, device=x.device)
    clipped_any = torch.empty((B,), dtype=torch.int32, device=x.device)
    _lib.launch("pycusdr_threshold", _lib.ptr(x), _lib.ptr(y), _lib.ptr(part), _lib.ptr(hits),
                _lib.ptr(clipped_any), B, N, K6_CHUNK, float(scale))
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
    if S.device.type == "cpu":
        return mf_bank_colreduce_plain(S, masks, shift, sum_lo, sum_hi)
    if S.device.type != "cuda":
        raise ValueError(f"mf_bank_colreduce: unsupported device {S.device}")
    B, N = S.shape
    M = masks.shape[0]
    n1 = fft_split(N)
    if not 0 <= sum_lo <= sum_hi <= M:
        raise ValueError(f"mask sum range [{sum_lo}, {sum_hi}) outside [0, {M})")
    if tuple(shift.shape) not in ((B,), (1,)):
        raise ValueError(f"shift: expected shape ({B},) or (1,), got {tuple(shift.shape)}")
    if tw is None:
        tw = twiddle_table(N, S.device)
    _lib.check(S, "S", torch.complex64, (B, N))
    _lib.check(masks, "masks", torch.complex64, (M, N), S.device)
    _lib.check(shift, "shift", torch.int32, None, S.device)
    _lib.check(tw, "tw", torch.float32, (N, 2), S.device)
    Y = torch.empty((B, M, N), dtype=torch.complex64, device=S.device)
    colsum = torch.empty((B, N), dtype=torch.float32, device=S.device)
    colmax = torch.empty((B, N), dtype=torch.float32, device=S.device)
    colarg = torch.empty((B, N), dtype=torch.int32, device=S.device)
    _lib.launch("pycusdr_mf_bank_colreduce", _lib.ptr(S), _lib.ptr(masks), _lib.ptr(shift),
                int(shift.shape[0] == B), _lib.ptr(tw), _lib.ptr(Y), _lib.ptr(colsum),
                _lib.ptr(colmax), _lib.ptr(colarg), B, N, M, n1, sum_lo, sum_hi)
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
    if x.device.type == "cpu":
        return timing_band_plain(x, lo, hi)
    if x.device.type != "cuda":
        raise ValueError(f"timing_band: unsupported device {x.device}")
    B, N = x.shape
    if not 0 <= lo < hi <= N // 2 + 1:
        raise ValueError(f"band [{lo}, {hi}) outside the rfft bins of N={N}")
    if tw is None:
        tw = twiddle_table(N, x.device)
    _lib.check(x, "x", torch.float32, (B, N))
    _lib.check(tw, "tw", torch.float32, (N, 2), x.device)
    band = torch.empty((B, hi - lo, 2), dtype=torch.float32, device=x.device)
    out = torch.empty((3, B), dtype=torch.float32, device=x.device)
    _lib.launch("pycusdr_timing_band", _lib.ptr(x), _lib.ptr(tw), _lib.ptr(band),
                _lib.ptr(out[0]), _lib.ptr(out[1]), _lib.ptr(out[2]), B, N, lo, hi)
    timing_band.launches += 1
    return out[0], out[1], out[2]


timing_band.launches = 0


# ---------------------------------------------------------------- K4


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
                  code_val: torch.Tensor = None, clipped_any: torch.Tensor = None):
    """K4: windowed symbol detection with the LUT bits and trust fill
    (see ``symbol_detect_plain``). spSym and codeOffset stay on the
    device: the kernel reads them by pointer.

    ``hits``: K6's pass-2 hits as a (B, Nfft/32) int32 bitmask. A slot
    whose winning sample j has a hit within [j - hw, j + hw], hw =
    ``clip_halfwidth`` clamped to [0, 2048], gets trust -2; the result
    then has at_win as a 7th output.

    ``row``: the (B, L) f32 packed rows (``ops/layout.py``). The arrays
    and the scalars nSym, nBits, spSym, codeOffset, ``code_val`` (B,) and
    ``clipped_any`` (B,) int32 (0 when None) are written there instead,
    and ``row`` is returned."""
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
        return row
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
        if N % 32:
            raise ValueError(f"symbol_detect: a clip bitmask needs N % 32 == 0, got {N}")
        _lib.check(hits, "hits", torch.int32, (B, N // 32), dev)
    if clipped_any is not None:
        _lib.check(clipped_any, "clipped_any", torch.int32, (B,), dev)
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
                _lib.ptr(codeOffset), _lib.ptr(bitLUT), _lib.ptr(hits), _lib.ptr(code_val),
                _lib.ptr(clipped_any), *map(_lib.ptr, typed), _lib.ptr(row),
                0 if row is None else row.shape[1], B, N, windowWidth, spsymMin, S,
                trust_normal, CLIP_HW_MAX)
    symbol_detect.launches += 1
    if row is not None:
        return row
    if hits is None:
        return typed
    return typed + (typed[4] == TRUST_CLIPPED,)


symbol_detect.launches = 0


# ---------------------------------------------------------------- K4n


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
    """The plain version of ``nrzs_bits`` on the packed rows, in place."""
    S = numSymMax
    tail = len(PACK_ARRAYS) * S
    bits, err = nrzs_bits_plain(row[:, 2 * S:3 * S].to(torch.int32), symbolLUT)
    row[:, :S] = bits.float()
    row[:, S:2 * S] = nrzs_trust_plain(row[:, S:2 * S], err)
    row[:, tail + SCALAR["nBits"]] = row[:, tail + SCALAR["nSym"]] - 1
    return row


def nrzs_bits(row: torch.Tensor, symbolLUT: torch.Tensor, numSymMax: int) -> torch.Tensor:
    """K4n: NRZ-S bits over the packed (B, L) f32 rows that K4 wrote, in
    place: bits from the symbols (``nrzs_bits_plain``), trust -1 on an
    error (``nrzs_trust_plain``), nBits = nSym - 1. symbolLUT: (M, 2, K)
    int32 on the rows' device. Returns ``row``."""
    S = numSymMax
    if row.dim() != 2 or row.shape[1] < len(PACK_ARRAYS) * S + len(PACK_SCALARS):
        raise ValueError(f"nrzs_bits: row shape {tuple(row.shape)} too small for S={S}")
    if symbolLUT.dim() != 3 or symbolLUT.shape[1] != 2:
        raise ValueError(f"nrzs_bits: symbolLUT must be (M, 2, K), got {tuple(symbolLUT.shape)}")
    if row.device.type == "cpu":
        return nrzs_rows_plain(row, symbolLUT, S)
    if row.device.type != "cuda":
        raise ValueError(f"nrzs_bits: unsupported device {row.device}")
    _lib.check(row, "row", torch.float32)
    _lib.check(symbolLUT, "symbolLUT", torch.int32, None, row.device)
    M, _, K = symbolLUT.shape
    _lib.launch("pycusdr_nrzs_bits", _lib.ptr(row), _lib.ptr(symbolLUT), row.shape[1],
                row.shape[0], S, M, K)
    nrzs_bits.launches += 1
    return row


nrzs_bits.launches = 0


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


def symbol_detect_local(colmax, colarg, spSym, codeOffset, *, m0: int, M: int, Nfft: int,
                        windowWidth: int, spsymMin: int, numSymMax: int):
    """K4l: the shard-local half of the symbol detector (see
    ``symbol_detect_local_plain``), one thread per slot as K4. spSym and
    codeOffset stay on the device."""
    kw = dict(m0=m0, M=M, Nfft=Nfft, windowWidth=windowWidth, spsymMin=spsymMin,
              numSymMax=numSymMax)
    if colmax.device.type == "cpu":
        return symbol_detect_local_plain(colmax, colarg, spSym, codeOffset, **kw)
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
    val = torch.empty((B, numSymMax), dtype=torch.float32, device=dev)
    key = torch.empty((B, numSymMax), dtype=torch.int32, device=dev)
    _lib.launch("pycusdr_symbol_detect_local", _lib.ptr(colmax), _lib.ptr(colarg),
                _lib.ptr(spSym), _lib.ptr(codeOffset), _lib.ptr(val), _lib.ptr(key), B, N,
                windowWidth, spsymMin, numSymMax, M, m0)
    symbol_detect_local.launches += 1
    return val, key


symbol_detect_local.launches = 0


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


def shard_select(vals, keys, spSym, codeOffset, bitLUT, *, M: int, Nfft: int,
                 windowWidth: int, spsymMin: int, numSymMax: int, trust_normal: int,
                 row: torch.Tensor, code_val: torch.Tensor, hits: torch.Tensor = None,
                 clipped_any: torch.Tensor = None) -> torch.Tensor:
    """K4s: the cross-shard select (see ``shard_select_plain``) written into
    the (B, L) f32 packed rows: the five arrays and the scalars nSym, nBits
    = nSym, spSym, codeOffset, ``code_val`` (B,) and ``clipped_any`` (B,)
    int32 (0 when None). ``hits``: K6's (B, Nfft/32) int32 bitmask; a slot
    whose winning sample has a hit within ``clip_halfwidth`` (clamped to
    2048) gets trust -2. K4n runs after it for NRZ-S. Returns ``row``."""
    kw = dict(M=M, Nfft=Nfft, windowWidth=windowWidth, spsymMin=spsymMin, numSymMax=numSymMax,
              trust_normal=trust_normal)
    S = numSymMax
    if vals.dim() != 3 or tuple(keys.shape) != tuple(vals.shape):
        raise ValueError(f"shard_select: vals {tuple(vals.shape)} and keys "
                         f"{tuple(keys.shape)} must both be (nd, B, S)")
    nd, B, _ = vals.shape
    if row.shape[0] != B or row.shape[1] < len(PACK_ARRAYS) * S + len(PACK_SCALARS):
        raise ValueError(f"shard_select: row shape {tuple(row.shape)} too small")
    if vals.device.type == "cpu":
        return shard_select_rows_plain(vals, keys, spSym, codeOffset, bitLUT, **kw, row=row,
                                       code_val=code_val, hits=hits, clipped_any=clipped_any)
    if vals.device.type != "cuda":
        raise ValueError(f"shard_select: unsupported device {vals.device}")
    dev = vals.device
    if vals.shape[2] != S or not 0 < windowWidth <= Nfft:
        raise ValueError(f"shard_select: bad shape {tuple(vals.shape)} S={S} W={windowWidth}")
    _lib.check(vals, "vals", torch.float32, (nd, B, S))
    _lib.check(keys, "keys", torch.int32, (nd, B, S), dev)
    _lib.check(spSym, "spSym", torch.float32, (B,), dev)
    _lib.check(codeOffset, "codeOffset", torch.float32, (B,), dev)
    _lib.check(code_val, "code_val", torch.float32, (B,), dev)
    _lib.check(row, "row", torch.float32, None, dev)
    if bitLUT is not None:
        _lib.check(bitLUT, "bitLUT", torch.int8, (M,), dev)
    if hits is not None:
        if Nfft % 32:
            raise ValueError(f"shard_select: a clip bitmask needs N % 32 == 0, got {Nfft}")
        _lib.check(hits, "hits", torch.int32, (B, Nfft // 32), dev)
    if clipped_any is not None:
        _lib.check(clipped_any, "clipped_any", torch.int32, (B,), dev)
    _lib.launch("pycusdr_shard_select", _lib.ptr(vals), _lib.ptr(keys), nd, _lib.ptr(spSym),
                _lib.ptr(codeOffset), _lib.ptr(bitLUT), _lib.ptr(hits), _lib.ptr(code_val),
                _lib.ptr(clipped_any), _lib.ptr(row), row.shape[1], B, Nfft, windowWidth,
                spsymMin, S, M, trust_normal, CLIP_HW_MAX)
    shard_select.launches += 1
    return row


shard_select.launches = 0
