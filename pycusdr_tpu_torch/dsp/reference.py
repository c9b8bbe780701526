"""Numpy golden reference of the per-block demodulation algorithm.

The port's own copy of ``pycusdr_tpu/dsp/reference.py`` (every stage
function and ``demod_block_numpy`` with their names and their math; the
``DemodSpec`` comes from the port's ``dsp/spec.py``). It transliterates
the *math* of the reference hot path
(``demodulator/demodulator_base.py:567-859`` + the kernels in
``demodulator/cuda_kernels.cu``) into plain numpy, and imports no torch.
It is the port's second oracle beside the JAX package: the block graph
in ``dsp/block.py`` (the kernels and their plain versions) must match
each stage to float tolerance, and every discrete decision (argmaxes,
symbols, bits) exactly on clean inputs. ``bench/ber_delta.py`` runs it
as the reference arm.

Key algebraic identity, also used by the block graph's Doppler energy
(K1): the reference computes, per (doppler d, mask m),

    E[d,m] = sum_n |IFFT_unnorm(S[(k+s_d) mod N] * M[m,k])[n]|^2 / 2^18

(``multInputVectorWithShiftedMasksDopp`` + batched IFFT +
``blockAbsSumAtomic``, cuda_kernels.cu:339-373,421-480). By Parseval,
sum_n |IFFT_unnorm(Y)[n]|^2 = N * sum_k |Y[k]|^2, so

    E[d,m] = N/2^18 * sum_k P[(k+s_d) mod N] * Q[m,k],

with P = |S|^2 and Q = |M|^2 — a (D,N)x(N,M) matmul; the 3-D lag tensor
never needs to exist. This reference computes E that way, and tests
separately verify the identity against a brute-force IFFT evaluation.
"""

import numpy as np

from pycusdr_tpu_torch.dsp.spec import DemodSpec

ABS_SUM_SCALE = 262144.0  # 2^18, reference cuda_kernels.cu:442


def threshold_input(samples: np.ndarray, scale: float):
    """Two-pass spike clipping (reference demodulator_base.py:670-708).

    Returns (clipped samples, indices clipped in the 2nd pass).
    """
    samples = samples.copy()
    absS = np.abs(samples)
    thresh = scale * np.mean(absS)
    i = np.where(absS > thresh)[0]
    with np.errstate(invalid="ignore", divide="ignore"):
        samples[i] = thresh * (samples[i] / absS[i])
    absS[i] = np.abs(samples[i])
    thresh = scale * np.mean(absS)
    i2 = np.where(absS > thresh)[0]
    with np.errstate(invalid="ignore", divide="ignore"):
        samples[i2] = thresh * (samples[i2] / absS[i2])
    return samples, i2


def fill_peak_gaps(clipped_idx: np.ndarray, Nfft: int, min_gap: int = 100) -> np.ndarray:
    """Mark peaks separated by < min_gap samples as one continuous burst
    (reference demodulator_base.py:686-705)."""
    if len(clipped_idx) == 0:
        return clipped_idx.copy()
    pp = np.zeros(Nfft, dtype=np.int8)
    pp[clipped_idx] = 1
    diffs = np.diff(clipped_idx)
    gaps_all = np.where(diffs > 1)[0]
    small = gaps_all[diffs[gaps_all] < min_gap]
    for g in small:
        pp[clipped_idx[g] : clipped_idx[g] + diffs[g]] = 1
    return np.where(pp == 1)[0]


def doppler_energy(S: np.ndarray, masks_f: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """E[d, m] via the Parseval matmul identity (see module docstring)."""
    N = len(S)
    P = (S.real**2 + S.imag**2).astype(np.float64)
    Q = (masks_f.real.astype(np.float64) ** 2 + masks_f.imag.astype(np.float64) ** 2)
    # NB: cast shifts up front — broadcasting int32 against int64 here
    # sends numpy's % down a pathological slow path (12 s vs 12 ms)
    idx = (np.arange(N)[None, :] + np.asarray(shifts, np.int64)[:, None]) % N
    Pshift = P[idx]  # (D, N)
    return Pshift @ Q.T * (N / ABS_SUM_SCALE)


def doppler_energy_bruteforce(S, masks_f, shifts):
    """Literal reference evaluation (unnormalized IFFT + lag-domain
    abs^2 sum) for validating the Parseval shortcut in tests."""
    N = len(S)
    D, M = len(shifts), masks_f.shape[0]
    E = np.empty((D, M))
    for d, s in enumerate(np.asarray(shifts)):
        Sshift = np.roll(S, -int(s))
        for m in range(M):
            x = np.fft.ifft(Sshift * masks_f[m]) * N
            E[d, m] = np.sum((np.abs(x) ** 2) / ABS_SUM_SCALE)
    return E


def _top2(vals: np.ndarray):
    """Top-2 (value, index) pairs with first-occurrence tie-breaking,
    like the register loop in findDopplerEst (cuda_kernels.cu:534-544)."""
    i0 = int(np.argmax(vals))
    v0 = vals[i0]
    tmp = vals.copy()
    tmp[i0] = -np.inf
    i1 = int(np.argmax(tmp))
    v1 = vals[i1]
    return v0, i0, v1, i1


def find_doppler_est(E: np.ndarray, spec: DemodSpec):
    """Weighted-average best Doppler (cuda_kernels.cu:502-597).

    Returns (doppIdx float incl. any noise-bin offset, quality_db).
    """
    off = spec.dopp_array_offset
    nd = spec.num_dopplers

    if spec.sum_all_masks:
        tot = E.sum(axis=1)
        v0, i0, v1, i1 = _top2(tot[off : off + nd])
        i0 += off
        i1 += off
        wsum = i0 * v0 + i1 * v1
        # all-zero energy (idle channel / zero padding) degrades to
        # index 0 and -inf quality, matching the block graph's guards
        # (K5 and its plain version, ops/doppler_search.py) and the reference's host-side
        # ValueError fallback (demodulator_base.py:625-630)
        denom = v0 + v1
        if denom <= 0:
            return 0.0, -np.inf
        dopp_idx = wsum / denom
        if off > 0:
            quality = max(v0, v1) / tot[0] if tot[0] > 0 else 0.0
        else:
            quality = wsum / (i0 + i1)
        with np.errstate(divide="ignore"):
            return dopp_idx, 10 * np.log10(quality)

    # per-mask weighted average, then mean over masks
    M = E.shape[1]
    idxs = np.empty(M)
    quals = np.empty(M)
    for m in range(M):
        v0, i0, v1, i1 = _top2(E[off : off + nd, m])
        i0 += off
        i1 += off
        wsum = i0 * v0 + i1 * v1
        denom = v0 + v1
        if denom <= 0:  # idle-channel guard, see sum_all_masks branch
            idxs[m] = 0.0
            quals[m] = 0.0
            continue
        idxs[m] = wsum / denom
        if off > 0:
            quals[m] = max(v0, v1) / E[0, m] if E[0, m] > 0 else 0.0
        else:
            quals[m] = wsum / (i0 + i1)
    with np.errstate(divide="ignore"):
        return idxs.mean(), 10 * np.log10(quals.mean())


def interpolate_doppler(dopp_idx: float, spec: DemodSpec):
    """Fractional-bin interpolation of the Doppler estimate
    (reference demodulator_base.py:609-618). Returns
    (doppler_Hz, fft_shift_bins, lowIdx, highIdx)."""
    lowIdx = int(dopp_idx)
    highIdx = int(np.ceil(dopp_idx))
    frac = dopp_idx % 1
    hz = spec.dopp_hz_lut[lowIdx] + (spec.dopp_hz_lut[highIdx] - spec.dopp_hz_lut[lowIdx]) * frac
    # unwrap the mod-N shifts before interpolating so a grid straddling
    # DC does not interpolate across the N-1 -> 0 seam
    N = spec.Nfft
    dcn = ((spec.dopp_shifts.astype(np.int64) + N // 2) % N) - N // 2
    shift = int(np.round(dcn[lowIdx] + (dcn[highIdx] - dcn[lowIdx]) * frac)) % N
    return hz, shift, lowIdx, highIdx


def compute_snr(S: np.ndarray, spec: DemodSpec, lowIdx: int, highIdx: int) -> float:
    """SNR from signal vs mirrored-spectrum noise bins
    (reference demodulator_base.py:635-667)."""
    N = len(S)
    absS = np.abs(S)
    w = spec.snr_window
    lo = int(spec.dopp_shifts[lowIdx])
    hi = int(spec.dopp_shifts[highIdx])
    nlo = (lo + N // 2) % N
    nhi = (hi + N // 2) % N

    def circ_mean(a, b):
        a = a % N
        b = b % N
        if a > b:
            return float(np.mean(np.concatenate((absS[a:], absS[:b]))))
        return float(np.mean(absS[a:b]))

    sig = circ_mean(lo - w, hi + w)
    noise = circ_mean(nlo - w, nhi + w)
    if noise <= 0:  # idle block: no noise floor either -> no signal
        return -np.inf
    ratio = sig / noise - 1
    if not ratio > 0:
        return -np.inf
    return float(20 * np.log10(ratio))


def demod_lag_tensor(S: np.ndarray, masks_f: np.ndarray, shift: int) -> np.ndarray:
    """Best-Doppler matched-filter bank in the lag domain, unnormalized
    IFFT scaling (reference multInputVectorWithShiftedMask + cufft
    inverse, demodulator_base.py:776-785)."""
    N = len(S)
    Sshift = np.roll(S, -int(shift))
    return np.fft.ifft(Sshift[None, :] * masks_f, axis=1) * N


def find_code_rate_and_phase(X: np.ndarray, spec: DemodSpec):
    """Symbol rate + timing from the spectrum of the summed matched-filter
    power (reference demodulator_base.py:711-752, cuda_kernels.cu:191-320).

    Returns (spSym, codeOffset, peak_value)."""
    mo = spec.code_search_mask_offset
    M = X.shape[0]
    power = np.sum(np.abs(X[mo : M - mo]) ** 2, axis=0)
    R = np.fft.rfft(power)
    band = R[spec.code_idx_lo : spec.code_idx_hi]
    k_rel = int(np.argmax(band.real**2 + band.imag**2))
    k = spec.code_idx_lo + k_rel
    val = float(band.real[k_rel] ** 2 + band.imag[k_rel] ** 2)
    phase = float(np.arctan2(R[k].imag, R[k].real))

    spSym = spec.Nfft / k
    codeOffset = -phase / np.pi * spSym / 2
    if codeOffset < 0:
        codeOffset += spSym - 1
    return spSym, codeOffset, val


def find_centres(X: np.ndarray, spec: DemodSpec, spSym: float, codeOffset: float):
    """Windowed symbol detection (reference findCentres,
    cuda_kernels.cu:78-146, metric abs^2).

    Returns (symbols, centres, magnitudes, win_abs) for
    int(Nfft/spSym) symbols; ``win_abs`` is the absolute sample index of
    each slot's winning magnitude (used for clip-trust tagging).
    """
    N = spec.Nfft
    W = spec.windowWidth
    Wl = spec.windowLeft
    spc = max(spSym, spec.spsymMin)
    nSym = int(N / spc)

    P2 = np.abs(X) ** 2  # (M, N)
    M = P2.shape[0]

    symbols = np.empty(nSym, dtype=np.int32)
    centres = np.empty(nSym, dtype=np.int32)
    mags = np.empty(nSym, dtype=np.float32)
    win_abs = np.empty(nSym, dtype=np.int32)

    for x in range(nSym):
        base = x * spc - Wl + codeOffset
        A0 = int(base)  # C-style trunc
        comp = int(codeOffset) - min(A0, 0)
        # clamped FULL window (matches K4 and symbol_detect_plain;
        # the CUDA kernel truncates edge windows instead — the affected
        # first/last slots fall inside the healing overlap margin)
        A = min(max(A0, 0), max(N - W, 0))
        win = P2[:, A : A + W]  # (M, W)
        # (offset, mask)-lexicographic first-win, matching the block
        # graph's column-max-first formulation (K4; the reference's CUDA loop is
        # (mask, offset)-major, cuda_kernels.cu:126-139 — the orders
        # differ only on exact float ties between different pairs)
        flat = int(np.argmax(win.T))
        k, m = flat // M, flat % M
        symbols[x] = m
        centres[x] = int(x * spc - Wl + k) + comp
        mags[x] = win[m, k]
        win_abs[x] = A + k
    return symbols, centres, mags, win_abs


def extract_bits(symbols: np.ndarray, spec: DemodSpec):
    """Symbol -> bit via centre-bit LUT, or NRZ-S 3-D LUT for BPSK
    (reference demodulator_base.py:1012-1051). Returns (bits, error_idx)."""
    if spec.bitLUT is not None:
        return spec.bitLUT[symbols].astype(np.int8), []

    lut = spec.symbolLUT  # (M, 2, K)
    s_prev = symbols[:-1]
    s_next = symbols[1:]
    res1 = np.any(s_next[:, None] == lut[s_prev, 0, :], axis=1)
    res0 = np.any(s_next[:, None] == lut[s_prev, 1, :], axis=1)
    errors = np.where(~(res1 | res0))[0].tolist()
    bits = res1.astype(np.int8)
    bits[errors] = 0  # SYMBOL_MISMATCHVAL = 0 (reference :26)
    return bits, errors


def demod_block_numpy(spec: DemodSpec, samples: np.ndarray) -> dict:
    """Full per-block chain. Returns every intermediate for golden tests."""
    out = {}
    sig = np.asarray(samples, dtype=np.complex64)

    if not spec.disable_peak_thresholding:
        sig, clipped = threshold_input(sig, spec.peak_threshold_scale)
    else:
        clipped = np.array([], dtype=np.int64)
    out["clipped_idx"] = clipped

    S = np.fft.fft(sig)
    out["S"] = S

    if spec.doppler_search:
        E = doppler_energy(S, spec.masks_f, spec.dopp_shifts)
        out["E"] = E
        dopp_idx, quality_db = find_doppler_est(E, spec)
        out["dopp_idx"] = dopp_idx
        out["quality_db"] = quality_db
        dopp_hz, shift, lowIdx, highIdx = interpolate_doppler(dopp_idx, spec)
        out["doppler_hz"] = dopp_hz
        out["freq_offset_hz"] = dopp_hz - spec.centreFreqOffset
        out["snr_db"] = compute_snr(S, spec, lowIdx, highIdx)
    else:
        shift = spec.dopp_offset_idx
        out["E"] = None
        out["dopp_idx"] = 0.0
        out["quality_db"] = 0.0
        out["doppler_hz"] = 0.0
        out["freq_offset_hz"] = 0.0
        out["snr_db"] = 0.0
    out["shift"] = shift

    X = demod_lag_tensor(S, spec.masks_f, shift)
    out["X"] = X

    spSym, codeOffset, code_val = find_code_rate_and_phase(X, spec)
    out["spSym"] = spSym
    out["codeOffset"] = codeOffset
    out["code_val"] = code_val

    symbols, centres, mags, win_abs = find_centres(X, spec, spSym, codeOffset)
    out["symbols"] = symbols
    out["centres"] = centres
    out["mags"] = mags

    bits, sym_errors = extract_bits(symbols, spec)
    out["bits"] = bits
    out["sym_errors"] = sym_errors

    # trust: +2*voteWeight, -1 symbol error, -2 near clipped peaks
    trust = np.full(len(bits), 2 * spec.voteWeight, dtype=np.int8)
    if sym_errors:
        trust[np.asarray(sym_errors)] = -1
    if len(clipped):
        spc = int(np.ceil(max(spSym, spec.spsymMin)))
        pp = np.zeros(spec.Nfft, dtype=bool)
        for cp in clipped:
            pp[max(cp - 2 * spc, 0) : cp + 2 * spc + 1] = True
        # tag at the winning SAMPLE (matches ops.demod_kernels: the
        # clip mask rides the selection tree; can differ from sampling
        # at ``centres`` by the one-sample float-trunc skew — both
        # implementations use the same convention)
        cw = win_abs[: len(bits)]
        trust[pp[np.clip(cw, 0, spec.Nfft - 1)]] = -2
    out["trust"] = trust
    return out
