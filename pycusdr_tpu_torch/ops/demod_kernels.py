"""Demodulation-stage ops: interference spike clipping (kernel K6), the
matched-filter bank reduced over masks (K2), the symbol-timing band
search (K3), and symbol detection with bits, trust and the clip window
(K4).

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


def symbol_detect_plain(colmax, colarg, spSym, codeOffset, bitLUT, *, Nfft: int,
                        windowWidth: int, spsymMin: int, numSymMax: int,
                        trust_normal: int, clip_mask: torch.Tensor = None):
    """Plain PyTorch K4. colmax: (B, N) f32; colarg: (B, N) i32; spSym,
    codeOffset: (B,) f32; bitLUT: (M,) int8. Returns (symbols, centres,
    mags, bits, trust, nSym). The f32 slot arithmetic is one rounded op
    at a time, as in the JAX op.

    ``clip_mask``: the dilated (B, N) bool clip mask (``dilate_mask_plain``).
    It is sampled at each slot's winning sample, as ``find_centres``
    samples it (``ops/demod_kernels.py:476-480,572-583``, JAX); those
    slots get trust -2, and the sampled mask is a 7th output, at_win."""
    B, N = colmax.shape
    W, Wl = windowWidth, windowWidth // 2
    spc = torch.clamp(spSym, min=float(spsymMin))
    x = torch.arange(numSymMax, dtype=torch.float32, device=colmax.device)
    xs = x[None, :] * spc[:, None] - Wl
    A0 = torch.trunc(xs + codeOffset[:, None]).to(torch.int32)
    comp = torch.trunc(codeOffset).to(torch.int32)[:, None] - torch.clamp(A0, max=0)
    A = torch.clamp(A0, 0, max(N - W, 0)).long()
    idx = A[:, :, None] + torch.arange(W, device=colmax.device)  # (B, S, W)
    win = torch.gather(colmax, 1, idx.reshape(B, -1)).reshape(B, numSymMax, W)
    k = torch.argmax(win, dim=-1, keepdim=True)  # first index: earliest wins
    mags = torch.gather(win, -1, k)[..., 0]
    j = A + k[..., 0]
    symbols = torch.gather(colarg, 1, j)
    k = k[..., 0].to(torch.int32)
    centres = torch.trunc(xs + k.float()).to(torch.int32) + comp
    nSym = (Nfft / spc).to(torch.int32)
    bits = bitLUT[symbols.long()]
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
