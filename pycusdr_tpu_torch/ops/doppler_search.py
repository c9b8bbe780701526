"""Doppler search: the energy matrix (kernel K1), and the estimate from
it (K5): the top-2 Doppler bins, the fractional interpolation of
frequency and spectrum shift, and the SNR.

By Parseval, the lag-domain energy of the matched filter of mask m at
Doppler shift s_d is

    E[d, m] = N / 2^18 * sum_k P[(k + s_d) mod N] * Q[m, k]

with P = |S|^2 and Q = |masks_f|^2 (``dsp/reference.py:67-76`` is the
golden form). ``doppler_energy`` evaluates it directly: on a CUDA tensor
with the hand-written kernel ``csrc/doppler_energy.cu``, on a CPU tensor
with ``doppler_energy_plain``.
"""

import torch

from pycusdr_tpu_torch.ops import _lib
from pycusdr_tpu_torch.ops.layout import E_AT, PACK_SCALARS, SCALAR

ABS_SUM_SCALE = 262144.0  # 2^18, matches reference blockAbsSumAtomic scaling
#: k samples per K1 block; partial sums of the chunks are added in order
K1_CHUNK = 4096


def doppler_energy_plain(P: torch.Tensor, Q: torch.Tensor, shifts: torch.Tensor,
                         centre_shift: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch K1: shifted gather of P, then a matmul against Q.

    P: (B, N) f32; Q: (M, N) f32; shifts: (D,) int32; centre_shift:
    optional (B,) int32 recentre added to every shift. Returns (B, D, M).
    """
    B, N = P.shape
    k = torch.arange(N, device=P.device)
    if centre_shift is None:
        idx = (k[None, :] + shifts.long()[:, None]) % N  # (D, N)
        Pg = P[:, idx]
    else:
        s = shifts.long()[None, :] + centre_shift.long()[:, None]  # (B, D)
        idx = (k[None, None, :] + s[:, :, None]) % N
        Pg = torch.gather(P[:, None, :].expand(-1, idx.shape[1], -1), 2, idx)
    return torch.matmul(Pg, Q.T) * (N / ABS_SUM_SCALE)


def doppler_energy(P: torch.Tensor, Q: torch.Tensor, shifts: torch.Tensor,
                   centre_shift: torch.Tensor = None) -> torch.Tensor:
    """K1: E[b, d, m] of the block. See ``doppler_energy_plain`` for the
    arguments. A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/doppler_energy.cu`` or raises."""
    if P.device.type == "cpu":
        return doppler_energy_plain(P, Q, shifts, centre_shift)
    if P.device.type != "cuda":
        raise ValueError(f"doppler_energy: unsupported device {P.device}")
    B, N = P.shape
    M, D = Q.shape[0], shifts.shape[0]
    if M > 32:
        raise ValueError(f"doppler_energy: at most 32 masks, got {M}")
    _lib.check(P, "P", torch.float32, (B, N))
    _lib.check(Q, "Q", torch.float32, (M, N), P.device)
    _lib.check(shifts, "shifts", torch.int32, (D,), P.device)
    if centre_shift is not None:
        _lib.check(centre_shift, "centre_shift", torch.int32, (B,), P.device)
    nch = -(-N // K1_CHUNK)
    partial = torch.empty((B, D, nch, M), dtype=torch.float32, device=P.device)
    E = torch.empty((B, D, M), dtype=torch.float32, device=P.device)
    _lib.launch("pycusdr_doppler_energy", _lib.ptr(P), _lib.ptr(Q), _lib.ptr(shifts),
                _lib.ptr(centre_shift), _lib.ptr(partial), _lib.ptr(E),
                B, N, D, M, K1_CHUNK, N / ABS_SUM_SCALE)
    doppler_energy.launches += 1
    return E


doppler_energy.launches = 0


def _top2(vals: torch.Tensor):
    """Top-2 (value, index) over the last axis with first-occurrence
    tie-breaking, as ``dsp/reference.py:93-102`` does. ``torch.topk``
    promises no order among ties; ``torch.argmax`` returns the first
    maximal index on the CPU and on CUDA."""
    i0 = torch.argmax(vals, dim=-1, keepdim=True)
    v0 = torch.gather(vals, -1, i0)
    masked = vals.scatter(-1, i0, float("-inf"))
    i1 = torch.argmax(masked, dim=-1, keepdim=True)
    v1 = torch.gather(vals, -1, i1)
    return v0[..., 0], i0[..., 0], v1[..., 0], i1[..., 0]


def find_doppler_estimate(E: torch.Tensor, num_dopplers: int, array_offset: int,
                          sum_all_masks: bool):
    """Weighted top-2 Doppler estimate of ``ops/doppler_search.py:158-193``
    (JAX), batched: E (B, D, M) -> (dopp_idx (B,), quality_db (B,)).

    All-zero energy (an idle channel) gives index 0, not NaN."""
    off = array_offset
    if sum_all_masks:
        tot = E.sum(dim=-1)  # (B, D)
        v0, i0, v1, i1 = _top2(tot[:, off:off + num_dopplers])
        i0 = (i0 + off).float()
        i1 = (i1 + off).float()
        wsum = i0 * v0 + i1 * v1
        denom = v0 + v1
        dopp_idx = torch.where(denom > 0, wsum / torch.where(denom > 0, denom, 1.0), 0.0)
        if off > 0:
            quality = torch.maximum(v0, v1) / tot[:, 0]
        else:
            quality = torch.where(denom > 0, wsum / (i0 + i1), 0.0)
        return dopp_idx, 10.0 * torch.log10(quality)

    sub = E[:, off:off + num_dopplers, :].transpose(1, 2)  # (B, M, nd)
    v0, i0, v1, i1 = _top2(sub)
    i0 = (i0 + off).float()
    i1 = (i1 + off).float()
    wsum = i0 * v0 + i1 * v1
    denom = v0 + v1
    idxs = torch.where(denom > 0, wsum / torch.where(denom > 0, denom, 1.0), 0.0)
    if off > 0:
        quals = torch.maximum(v0, v1) / E[:, 0, :]
    else:
        quals = torch.where(denom > 0, wsum / (i0 + i1), 0.0)
    return idxs.mean(dim=-1), 10.0 * torch.log10(quals.mean(dim=-1))


def compute_snr(absS: torch.Tensor, fft_lo: torch.Tensor, fft_hi: torch.Tensor,
                window: int, Nfft: int) -> torch.Tensor:
    """SNR of ``ops/demod_kernels.py:651-668`` (JAX), batched: circular
    band means of |S| (B, N) around the winning bins against the mirrored
    noise band, in dB; -inf when the ratio is <= 0 (an idle block)."""
    k = torch.arange(Nfft, device=absS.device)

    def circ_mean(a, b):
        a = torch.remainder(a, Nfft)
        span = torch.remainder(b - a, Nfft)
        sel = torch.remainder(k[None, :] - a[:, None], Nfft) < span[:, None]
        return (torch.where(sel, absS, 0.0).sum(dim=-1)
                / torch.clamp(sel.sum(dim=-1), min=1))

    sig = circ_mean(fft_lo - window, fft_hi + window)
    noise = circ_mean(fft_lo - window + Nfft // 2, fft_hi + window + Nfft // 2)
    ratio = sig / noise - 1.0
    return torch.where(ratio > 0, 20.0 * torch.log10(torch.where(ratio > 0, ratio, 1.0)),
                       float("-inf"))


#: K5's outputs: consecutive scalars of the packed row, written in this order
K5_OUTPUTS = PACK_SCALARS[SCALAR["dopp_idx"]:SCALAR["shift"] + 1]
#: at most this many grid entries (K5 keeps the mask sums in shared memory)
K5_MAX_D = 1024


def doppler_estimate_plain(E, P, shifts, shifts_signed, hz_lut, *, num_dopplers: int,
                           array_offset: int, sum_all_masks: bool, snr_window: int,
                           centre_freq_offset: float):
    """Plain PyTorch K5: ``find_doppler_estimate``, the fractional
    interpolation of ``pycusdr_tpu/dsp/block.py:248-267`` and
    ``compute_snr``, batched. E: (B, D, M) f32; P: (B, N) f32 = |S|^2;
    shifts: (D,) int32 in [0, N); shifts_signed: the same unwrapped into
    [-N/2, N/2); hz_lut: (D,) f32. Returns (dopp_idx, quality_db,
    doppler_hz, freq_offset_hz, snr_db) f32 and shift int32, each (B,)."""
    N, D = P.shape[-1], E.shape[1]
    dopp_idx, quality_db = find_doppler_estimate(E, num_dopplers, array_offset, sum_all_masks)
    # interpolate on UNWRAPPED shifts: a grid straddling DC has
    # neighbours ~N-1 and 0
    lowIdx = torch.clamp(torch.floor(dopp_idx).long(), 0, D - 1)
    highIdx = torch.clamp(torch.ceil(dopp_idx).long(), 0, D - 1)
    frac = torch.remainder(dopp_idx, 1.0)
    doppler_hz = hz_lut[lowIdx] + (hz_lut[highIdx] - hz_lut[lowIdx]) * frac
    sl = shifts_signed[lowIdx].float()
    sh = shifts_signed[highIdx].float()
    shift = torch.remainder(torch.round(sl + (sh - sl) * frac).to(torch.int32), N)
    snr_db = compute_snr(torch.sqrt(P), shifts[lowIdx], shifts[highIdx], snr_window, N)
    return dopp_idx, quality_db, doppler_hz, doppler_hz - centre_freq_offset, snr_db, shift


def doppler_estimate(E, P, shifts, shifts_signed, hz_lut, *, num_dopplers: int,
                     array_offset: int, sum_all_masks: bool, snr_window: int,
                     centre_freq_offset: float, tail: torch.Tensor = None):
    """K5: the Doppler estimate, interpolation and SNR of a block in one
    launch (see ``doppler_estimate_plain`` for the arguments and outputs).
    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/doppler_estimate.cu`` or raises.

    ``tail``: the packed rows from their first scalar on (``row[:, 5 S:]``,
    a view with unit column stride). The five f32 outputs, the shift and E
    are then also written there, and the f32 outputs returned are views
    of it."""
    kw = dict(num_dopplers=num_dopplers, array_offset=array_offset,
              sum_all_masks=sum_all_masks, snr_window=snr_window,
              centre_freq_offset=centre_freq_offset)
    if E.device.type == "cpu":
        out = doppler_estimate_plain(E, P, shifts, shifts_signed, hz_lut, **kw)
        if tail is not None:
            for k, v in zip(K5_OUTPUTS, out):
                tail[:, SCALAR[k]] = v.float()
            tail[:, E_AT:E_AT + E.shape[1] * E.shape[2]] = E.reshape(E.shape[0], -1)
        return out
    if E.device.type != "cuda":
        raise ValueError(f"doppler_estimate: unsupported device {E.device}")
    B, D, M = E.shape
    N = P.shape[1]
    dev = E.device
    if D > K5_MAX_D or not 0 < num_dopplers <= D - array_offset or array_offset < 0:
        raise ValueError(f"doppler_estimate: grid D={D}, num_dopplers={num_dopplers}, "
                         f"offset={array_offset} not supported")
    _lib.check(E, "E", torch.float32, (B, D, M))
    _lib.check(P, "P", torch.float32, (B, N), dev)
    _lib.check(shifts, "shifts", torch.int32, (D,), dev)
    _lib.check(shifts_signed, "shifts_signed", torch.int32, (D,), dev)
    _lib.check(hz_lut, "hz_lut", torch.float32, (D,), dev)
    if tail is None:
        sc = torch.empty((B, len(K5_OUTPUTS)), dtype=torch.float32, device=dev)
        sc_at, e_at = 0, None
    else:
        if tail.dtype != torch.float32 or tail.device != dev or tail.shape[0] != B \
                or tail.stride(1) != 1 or tail.shape[1] < E_AT + D * M:
            raise ValueError("doppler_estimate: tail must be a (B, >= 12 + D*M) f32 view "
                             "with unit column stride")
        sc, sc_at, e_at = tail, SCALAR["dopp_idx"], E_AT
    shift = torch.empty((B,), dtype=torch.int32, device=dev)
    base = sc.data_ptr()
    _lib.launch("pycusdr_doppler_estimate", _lib.ptr(E), _lib.ptr(P), _lib.ptr(shifts),
                _lib.ptr(shifts_signed), _lib.ptr(hz_lut), base + 4 * sc_at, sc.stride(0),
                None if e_at is None else base + 4 * e_at, sc.stride(0), _lib.ptr(shift),
                B, N, D, M, num_dopplers, array_offset, int(sum_all_masks), snr_window,
                float(centre_freq_offset))
    doppler_estimate.launches += 1
    return tuple(sc[:, sc_at + i] for i in range(5)) + (shift,)


doppler_estimate.launches = 0
