"""Plain PyTorch reference of the per-block demodulation, and of the wideband
channelizer in front of it.

A frozen transliteration of the numpy golden of the per-block algorithm
(pyCuSDR's ``demodulator_base.py`` hot path and its CUDA kernels, in the
form of the measured program's ``dsp/reference.py``), batched over blocks
and written in torch so that it runs on the card after the measured window.
It imports nothing of the measured program and takes nothing it made: the
constants come from ``spec.build`` on the configuration file, the samples
from the benchmark's own generator.

``precision``:
- "f64": the reference: float64 and complex128 throughout, but for the
  slot grid (``_centres``), which is float32 arithmetic in the algorithm
  itself.
- "tf32": the control: float32 arithmetic with every operand of every
  product (the FFT inputs, the spectrum, the masks, the Doppler energy's
  matmul, the matched-filter products, their powers) rounded to TF32's
  10-bit mantissa, the precision a tensor-core rewrite of the graph would
  compute in. It must come out as not correct.
"""

import math

import numpy as np
import torch

from portbench.reference.spec import TRUST_CLIPPED, RefSpec

#: the Doppler energy's scale (pyCuSDR's blockAbsSumAtomic divides by 2^18)
ABS_SUM_SCALE = 262144.0
#: a slot whose window starts this close to a whole sample may start one
#: sample over in another rounding of codeOffset (``window_edge``)
WINDOW_EDGE = 1e-3
#: the Doppler energy's second and third best bins this close (relative to
#: the second) may swap in another rounding of E; the spectrum shift's
#: interpolation this close to a half may round the other way. Either
#: choice is the algorithm's answer: ``alternatives`` gives the other.
DOPP_TIE = 1e-4
SHIFT_EDGE = 5e-3


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (round to nearest even on the 10th mantissa bit)."""
    if x.is_complex():
        return torch.view_as_complex(_tf32(torch.view_as_real(x).contiguous()))
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class _Prec:
    def __init__(self, precision: str):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.real = torch.float32 if self.tf32 else torch.float64
        self.cplx = torch.complex64 if self.tf32 else torch.complex128

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, in this precision."""
        return _tf32(x) if self.tf32 else x


def _clip(x: torch.Tensor, scale: float, p: _Prec):
    """Two-pass spike clipping; returns (x clipped, pass-2 hits (B, N))."""
    a = x.abs()
    thr = scale * a.mean(dim=-1, keepdim=True)
    hit = a > thr
    x = torch.where(hit, thr * x / torch.where(hit, a, 1.0), x)
    a = torch.where(hit, x.abs(), a)
    thr = scale * a.mean(dim=-1, keepdim=True)
    hit2 = a > thr
    x = torch.where(hit2, thr * x / torch.where(hit2, a, 1.0), x)
    return x, hit2


def _first_argmax(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (torch.argmax returns the
    first on the CPU and on CUDA; the ties this guards are exact)."""
    return torch.argmax(v, dim=dim, keepdim=True)


def _doppler(S, P, spec: RefSpec, p: _Prec, dev, force_i1=None, force_shift=None):
    """E (B, D, M) and the Doppler estimate, its interpolation and SNR.
    ``force_i1``, ``force_shift``: (B,) overrides of the second best bin and
    of the shift (-1: none), the other side of a tie (``alternatives``)."""
    B, N = P.shape
    shifts = torch.as_tensor(spec.dopp_shifts, dtype=torch.long, device=dev)
    Q = p.q(torch.as_tensor(np.abs(spec.masks_f) ** 2, device=dev).to(p.real))
    idx = (torch.arange(N, device=dev)[None, :] + shifts[:, None]) % N
    E = torch.empty((B, spec.D, spec.M), dtype=p.real, device=dev)
    Pq = p.q(P)
    for b0 in range(0, B, 4):  # (4, D, N) gathered rows at a time
        E[b0:b0 + 4] = torch.matmul(Pq[b0:b0 + 4, idx], Q.T) * (N / ABS_SUM_SCALE)
    tot = E.sum(dim=-1)
    i0 = _first_argmax(tot)
    v0 = torch.gather(tot, 1, i0)
    rest = tot.scatter(1, i0, -math.inf)
    i1 = _first_argmax(rest)
    i2 = _first_argmax(rest.scatter(1, i1, -math.inf))
    tie = torch.where((torch.gather(tot, 1, i1) - torch.gather(tot, 1, i2)
                       <= DOPP_TIE * torch.gather(tot, 1, i1))[:, 0], i2[:, 0], -1)
    if force_i1 is not None:
        i1 = torch.where(force_i1[:, None] >= 0, force_i1[:, None], i1)
    v1 = torch.gather(tot, 1, i1)
    i0, i1, v0, v1 = i0[:, 0].to(p.real), i1[:, 0].to(p.real), v0[:, 0], v1[:, 0]
    wsum = i0 * v0 + i1 * v1
    denom = v0 + v1
    live = denom > 0
    dopp_idx = torch.where(live, wsum / torch.where(live, denom, 1.0), 0.0)
    quality_db = torch.where(live, 10.0 * torch.log10(wsum / (i0 + i1)), -math.inf)

    hz = torch.as_tensor(spec.dopp_hz_lut, device=dev).to(p.real)
    lo_i = torch.floor(dopp_idx).long()
    hi_i = torch.ceil(dopp_idx).long()
    frac = torch.remainder(dopp_idx, 1.0)
    doppler_hz = hz[lo_i] + (hz[hi_i] - hz[lo_i]) * frac
    dcn = ((shifts + N // 2) % N - N // 2).to(p.real)
    arg = dcn[lo_i] + (dcn[hi_i] - dcn[lo_i]) * frac
    shift = torch.remainder(torch.round(arg).long(), N)
    half = (arg - torch.floor(arg) - 0.5).abs() < SHIFT_EDGE
    other = torch.remainder(torch.where(torch.round(arg) > arg, torch.floor(arg),
                                        torch.ceil(arg)).long(), N)
    alt_shift = torch.where(half, other, -1)
    if force_shift is not None:
        shift = torch.where(force_shift >= 0, force_shift, shift)

    absS = S.abs()
    k = torch.arange(N, device=dev)
    w = spec.snr_window

    def circ_mean(a, b):
        a, b = torch.remainder(a, N), torch.remainder(b, N)
        sel = torch.remainder(k[None, :] - a[:, None], N) < torch.remainder(b - a, N)[:, None]
        return torch.where(sel, absS, 0.0).sum(dim=-1) / sel.sum(dim=-1)

    def snr(lo_i, hi_i):
        lo, hi = shifts[lo_i], shifts[hi_i]
        sig = circ_mean(lo - w, hi + w)
        noise = circ_mean(lo + N // 2 - w, hi + N // 2 + w)
        ratio = sig / noise - 1.0
        good = (noise > 0) & (ratio > 0)
        return torch.where(good, 20.0 * torch.log10(torch.where(good, ratio, 1.0)), -math.inf)

    # the SNR of the bin pairs just below, at and above the nearest grid
    # index: an estimate within rounding of a whole index reads its bands
    # from one of them (``compare.py``)
    n = torch.round(dopp_idx).long()
    D = spec.D
    alt = torch.stack([snr(torch.clamp(n + a, 0, D - 1), torch.clamp(n + b, 0, D - 1))
                       for a, b in ((-1, 0), (0, 0), (0, 1))], dim=-1)
    snr_db = snr(lo_i, hi_i)
    return dict(E=E, dopp_idx=dopp_idx, quality_db=quality_db, doppler_hz=doppler_hz,
                freq_offset_hz=doppler_hz - spec.centreFreqOffset, snr_db=snr_db,
                snr_alt_db=alt, shift=shift, alt_i1=tie, alt_shift=alt_shift)


def _bank(S, shift, spec: RefSpec, p: _Prec, dev, chunk: int):
    """The matched-filter bank at the chosen shift, reduced over the masks:
    (colsum over [mo, M - mo), colmax, first argmax mask), each (B, N)."""
    B, N = S.shape
    masks = p.q(torch.as_tensor(spec.masks_f, device=dev).to(p.cplx))
    k = torch.arange(N, device=dev)
    mo = spec.code_search_mask_offset
    out = [torch.empty((B, N), dtype=p.real, device=dev) for _ in range(2)]
    colarg = torch.empty((B, N), dtype=torch.long, device=dev)
    for b0 in range(0, B, chunk):
        s = S[b0:b0 + chunk]
        rolled = torch.gather(s, 1, (k[None, :] + shift[b0:b0 + chunk, None]) % N)
        X = p.q(torch.fft.ifft(p.q(rolled)[:, None, :] * masks[None], dim=-1) * N)
        P2 = p.q(X.real * X.real + X.imag * X.imag)
        out[0][b0:b0 + chunk] = P2[:, mo:spec.M - mo].sum(dim=1)
        out[1][b0:b0 + chunk] = P2.amax(dim=1)
        colarg[b0:b0 + chunk] = torch.argmax(P2, dim=1)
    return out[0], out[1], colarg


def _timing(colsum, spec: RefSpec, p: _Prec):
    """The symbol rate and timing from the spectrum of the summed power:
    (spSym, codeOffset) in float32 (the slot grid's arithmetic, ``_centres``)
    and code_val."""
    N = colsum.shape[-1]
    R = torch.fft.rfft(p.q(colsum))
    band = R[:, spec.code_idx_lo:spec.code_idx_hi]
    bp = band.real * band.real + band.imag * band.imag
    kr = _first_argmax(bp)
    code_val = torch.gather(bp, 1, kr)[:, 0]
    Rk = torch.gather(R, 1, kr + spec.code_idx_lo)[:, 0]
    phase = torch.atan2(Rk.imag, Rk.real).to(torch.float32)
    f32 = torch.float32
    spSym = torch.tensor(float(N), dtype=f32) / (kr[:, 0] + spec.code_idx_lo).to(f32)
    off = -phase / torch.tensor(math.pi, dtype=f32) * spSym / 2
    return spSym, torch.where(off < 0, off + spSym - 1, off), code_val


def _centres(colmax, colarg, spSym, codeOffset, hits, spec: RefSpec, dev):
    """Windowed symbol detection and the bits and trust of each slot. The slot
    grid (spc, each slot's x spc - W/2, the window's start, the centres,
    nSym) is float32 arithmetic, one rounded operation at a time, as
    pyCuSDR's findCentres kernel and the configuration's float32 state it;
    ``spSym`` and ``codeOffset`` come in as float32."""
    B, N = colmax.shape
    S, W, Wl = spec.numSymMax, spec.windowWidth, spec.windowWidth // 2
    spc = torch.clamp(spSym, min=float(spec.spsymMin))
    nSym = torch.trunc(torch.tensor(float(N), dtype=spc.dtype) / spc).long()
    x = torch.arange(S, device=dev, dtype=spc.dtype)
    xs = x[None, :] * spc[:, None] - Wl
    base = xs + codeOffset[:, None]
    A0 = torch.trunc(base).long()
    comp = torch.trunc(codeOffset).long()[:, None] - torch.clamp(A0, max=0)
    A = torch.clamp(A0, 0, max(N - W, 0))
    win = torch.gather(colmax, 1, (A[:, :, None] + torch.arange(W, device=dev)).reshape(B, -1))
    win = win.reshape(B, S, W)
    kk = _first_argmax(win)
    mags = torch.gather(win, -1, kk)[..., 0]
    kk = kk[..., 0]
    j = A + kk
    symbols = torch.gather(colarg, 1, j)
    centres = torch.trunc(xs + kk.to(xs.dtype)).long() + comp
    bits = torch.as_tensor(spec.bitLUT, device=dev).long()[symbols]
    trust = torch.full_like(bits, spec.trust_normal)
    if hits is not None:
        hw = 2 * torch.ceil(spc).long()[:, None]
        c = torch.cumsum(hits.long(), dim=-1)
        i = torch.arange(N, device=dev)[None, :]
        hi = torch.gather(c, 1, torch.clamp(i + hw, max=N - 1))
        lo = torch.where(i - hw - 1 >= 0, torch.gather(c, 1, torch.clamp(i - hw - 1, min=0)), 0)
        near = torch.gather((hi - lo) > 0, 1, torch.clamp(j, 0, N - 1))
        trust = torch.where(near, TRUST_CLIPPED, trust)
    return dict(symbols=symbols, centres=centres, mags=mags, bits=bits, trust=trust,
                nSym=nSym, nBits=nSym.clone(),
                window_edge=(base - torch.round(base)).abs() < WINDOW_EDGE)


def demod(x: torch.Tensor, spec: RefSpec, precision: str = "f64", chunk: int = 4,
          force_i1=None, force_shift=None) -> dict:
    """The reference's outputs for the (B, Nfft) complex blocks ``x`` on
    their device: per-slot arrays (B, numSymMax) valid in their first nSym
    slots, the scalars (B,) and E (B, D, M); ``alt_i1`` and ``alt_shift``
    (-1: none) name the other side of a tie, which ``force_i1`` and
    ``force_shift`` take (``alternatives``)."""
    p = _Prec(precision)
    dev = x.device
    x = x.to(p.cplx)
    B, N = x.shape
    if N != spec.Nfft:
        raise ValueError(f"expected (B, {spec.Nfft}) blocks, got {tuple(x.shape)}")
    hits = None
    if spec.clipping:
        x, hits = _clip(x, spec.peak_threshold_scale, p)
    S = p.q(torch.fft.fft(p.q(x), dim=-1))
    if spec.doppler_search:
        out = _doppler(S, S.real * S.real + S.imag * S.imag, spec, p, dev, force_i1,
                       force_shift)
    else:
        zero = torch.zeros(B, dtype=p.real, device=dev)
        out = dict(E=torch.zeros((B, spec.D, spec.M), dtype=p.real, device=dev),
                   dopp_idx=zero, quality_db=zero, doppler_hz=zero, freq_offset_hz=zero,
                   snr_db=zero,
                   shift=torch.full((B,), spec.dopp_offset_idx, dtype=torch.long, device=dev))
    colsum, colmax, colarg = _bank(S, out["shift"], spec, p, dev, chunk)
    spSym, codeOffset, code_val = _timing(colsum, spec, p)
    out.update(_centres(colmax, colarg, spSym, codeOffset, hits, spec, dev))
    out.update(spSym=spSym.to(p.real), codeOffset=codeOffset.to(p.real), code_val=code_val,
               clipped_any=(hits.any(dim=-1) if hits is not None
                            else torch.zeros(B, dtype=torch.bool, device=dev)))
    return out


def alternatives(x: torch.Tensor, spec: RefSpec, out: dict, precision: str = "f64") -> dict:
    """{block: outputs} of the blocks of ``out`` (``demod``'s of ``x``) that sit
    on a tie: the block again with the second best Doppler bin swapped for
    the near-tied third, or else with the shift rounded the other way."""
    if not spec.doppler_search:
        return {}
    i1, sh = out["alt_i1"], out["alt_shift"]
    blocks = torch.nonzero((i1 >= 0) | (sh >= 0))[:, 0]
    if not len(blocks):
        return {}
    f_i1 = i1[blocks]
    f_sh = torch.where(f_i1 >= 0, -1, sh[blocks])
    alt = demod(x[blocks], spec, precision, force_i1=f_i1, force_shift=f_sh)
    return {int(b): {k: v[j:j + 1] for k, v in alt.items()} for j, b in enumerate(blocks)}


# ------------------------------------------------------------ channelizer

def design_prototype(M: int, taps_per_branch: int, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, cutoff 1/(2M), M * taps long, unit sum."""
    L = M * taps_per_branch
    n = np.arange(L) - (L - 1) / 2
    h = np.sinc(n / M) * np.kaiser(L, beta)
    return h / h.sum()


def channelize(x: torch.Tensor, M: int, taps_per_branch: int, beta: float,
               state: torch.Tensor = None, precision: str = "f64"):
    """The critically sampled M-channel polyphase analysis filterbank:
    xp = [state; x as (T, M) rows], v[t, p] = sum_k h[k M + p] xp[t + K-1-k,
    p], y[m, t] = sum_p v[t, p] exp(-2 pi i p m / M). Returns (y (M, T),
    the carry: the last K - 1 rows of xp)."""
    p = _Prec(precision)
    K = taps_per_branch
    h2 = p.q(torch.as_tensor(design_prototype(M, K, beta).reshape(K, M), device=x.device)
             .to(p.real))
    T = x.numel() // M
    if state is None:
        state = torch.zeros((K - 1, M), dtype=p.cplx, device=x.device)
    xp = torch.cat([state.to(p.cplx), p.q(x.to(p.cplx)).reshape(T, M)])
    v = torch.zeros((T, M), dtype=p.cplx, device=x.device)
    for k in range(K):
        v += h2[k] * xp[K - 1 - k:K - 1 - k + T]
    return torch.fft.fft(p.q(v), dim=1).T.contiguous(), xp[T:].clone()
