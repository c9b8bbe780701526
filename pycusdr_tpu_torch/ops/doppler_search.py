"""Doppler search: the energy matrix (kernel K1), and the estimate from
it (K5): the top-2 Doppler bins, the fractional interpolation of
frequency and spectrum shift, and the SNR.

By Parseval, the lag-domain energy of the matched filter of mask m at
Doppler shift s_d is

    E[d, m] = N / 2^18 * sum_k P[(k + s_d) mod N] * Q[m, k]

with P = |S|^2 and Q = |masks_f|^2 (``dsp/reference.py:67-76`` is the
golden form). ``doppler_energy`` evaluates it directly: on a CUDA tensor
with the hand-written kernel ``csrc/doppler_energy.cu`` (3xTF32 products
on the tensor cores over staged P windows, laid out by
``doppler_energy_plan`` and launched on ``k1_grid``; a bank of more than
32 masks runs one launch per ``k1_mask_groups`` group), on a CPU tensor
with ``doppler_energy_plain``.
"""

import functools
from dataclasses import dataclass

import numpy as np
import torch

from pycusdr_tpu_torch.ops import _lib
from pycusdr_tpu_torch.ops.demod_kernels import SM_COUNT
from pycusdr_tpu_torch.ops.layout import E_AT, PACK_SCALARS, SCALAR

ABS_SUM_SCALE = 262144.0  # 2^18, matches reference blockAbsSumAtomic scaling
#: shifts per K1 tile: the 16 rows of mma.m16n8k8
K1_ROWS = 16
#: tiles per group of K1's deal (64 shifts)
K1_GROUP_TILES = 4
#: leaves of a K1 chunk: one a warp of a CTA, added pairwise
K1_LEAVES = 8
#: f32 of Q a K1 CTA stages: its chunk is K1_Q_FLOATS / MP samples (MP = 8
#: ceil(M / 8) mask columns: 2048 at M <= 8, 1024 at 16, 512 at 32), at most
#: N rounded up to 256
K1_Q_FLOATS = 16384
#: the dynamic shared memory of a K1 CTA (``csrc/doppler_energy.cu:kMaxDynSmem``,
#: two CTAs an SM): Q's chunk at row pitch L + 4, then the window of wwin f32
K1_SMEM = 112 * 1024
#: window samples beyond arc + chunk: the 16-byte copies start up to 3
#: samples early and end up to 3 late
K1_WINDOW_SLACK = 8
#: CTAs K1's launch aims at: two resident on each SM, less a tenth
K1_CTA_TARGET = 2 * SM_COUNT * 9 // 10
#: masks of one K1 launch: its mma tiles take at most 32 columns
K1_MAX_MASKS = 32


@dataclass(frozen=True)
class K1Plan:
    """K1's layout for one grid (``doppler_energy_plan``). ``rows``: the
    shift index of each tile row, -1 for padding, (T * 16,): the grid round
    the circle in groups of 64, dealt within a group by offset mod 8, the
    group's first shift in its row 0. ``L``: samples per chunk (8 leaves of
    L / 8); ``wwin``: the P window in f32 (a CTA whose arc plus L exceeds it
    reads P from global memory)."""

    N: int
    M: int
    MP: int  # mask columns, 8 per n-tile of the mma
    L: int
    nch: int
    wwin: int
    tg_max: int  # tiles a CTA may take: 4, or 2 where M > 16
    rows: np.ndarray

    @property
    def T(self) -> int:
        return len(self.rows) // K1_ROWS

    def table(self, shifts) -> np.ndarray:
        """The kernel's (T * 16, 2) int32 table: each row's shift index (-1
        for padding) and its shift mod N (the group's first shift for
        padding)."""
        s = np.mod(np.asarray(shifts, np.int64).reshape(-1), self.N)
        first = np.repeat(self.rows[::K1_GROUP_TILES * K1_ROWS], K1_GROUP_TILES * K1_ROWS)
        sd = np.where(self.rows >= 0, s[np.maximum(self.rows, 0)], s[first[:len(self.rows)]])
        return np.stack([self.rows, sd], axis=1).astype(np.int32)

    def group_arcs(self, shifts) -> np.ndarray:
        """The arc (largest offset from the first shift) of each 64-shift group."""
        s = np.mod(np.asarray(shifts, np.int64).reshape(-1), self.N)
        out = []
        for g0 in range(0, len(self.rows), K1_GROUP_TILES * K1_ROWS):
            r = self.rows[g0:g0 + K1_GROUP_TILES * K1_ROWS]
            r = r[r >= 0]
            out.append(int(np.mod(s[r] - s[r[0]], self.N).max()))
        return np.asarray(out)

    def window_groups(self, shifts) -> int:
        """How many 64-shift groups read P through the window (the others
        read it from global memory)."""
        return int((self.group_arcs(shifts) + self.L + K1_WINDOW_SLACK <= self.wwin).sum())


def doppler_energy_plan(shifts, N: int, M: int) -> K1Plan:
    """K1's plan for the grid ``shifts`` (D ints, any range: read mod N).
    It depends on the grid, N and M only, never on the batch, and it fixes
    the order of every sum: a block gives the same bits alone and in any
    batch.

    The shifts are sorted round the circle of N bins, cut after the widest
    gap, and taken 64 at a time as groups of up to four 16-row tiles. Within
    a group they are dealt to the 8-row halves of its tiles in order of
    their offset from the group's first shift mod 8 (which puts that shift
    in row 0), so that the 8 rows one fragment load reads fall in distinct
    banks where the grid allows it. The window holds the widest group's arc
    plus a chunk, where that fits beside Q's chunk; a group that does not
    fit reads P from global memory."""
    s = np.mod(np.asarray(shifts, np.int64).reshape(-1), N)
    D = len(s)
    if D == 0 or M <= 0 or M > K1_MAX_MASKS or N <= 0:
        raise ValueError(f"doppler_energy_plan: N={N}, D={D}, M={M} not supported")
    MP = 8 * (1 if M <= 8 else 2 if M <= 16 else 4)
    L = min(K1_Q_FLOATS // MP, -(-N // 256) * 256)
    cap = (K1_SMEM // 4 - MP * (L + 4)) // 32 * 32
    order = np.argsort(s, kind="stable")
    gaps = np.mod(np.roll(s[order], -1) - s[order], N)
    if D == 1:
        gaps[:] = N
    circ = np.roll(order, -(int(np.argmax(gaps)) + 1))  # shift indices round the circle
    T = -(-D // K1_ROWS)
    rows = np.full(T * K1_ROWS, -1, np.int32)
    need = 0
    for a in range(0, D, K1_GROUP_TILES * K1_ROWS):
        members = circ[a:a + K1_GROUP_TILES * K1_ROWS]
        off = np.mod(s[members] - s[members[0]], N)
        if off.max() + L + K1_WINDOW_SLACK <= cap:
            need = max(need, int(off.max()) + L + K1_WINDOW_SLACK)
        nsets = 2 * -(-len(members) // K1_ROWS)
        dealt = members[np.lexsort((np.arange(len(members)), off % 8))]
        for i, d in enumerate(dealt):
            k, slot = i % nsets, i // nsets
            rows[a + (k // 2) * K1_ROWS + (k % 2) * 8 + slot] = d
    tg_max = 4 if MP <= 16 else 2
    wwin = max(need, K1_LEAVES // 2 * tg_max * K1_ROWS * MP)  # also the reduction's room
    return K1Plan(N=N, M=M, MP=MP, L=L, nch=-(-N // L), wwin=-(-wwin // 32) * 32,
                  tg_max=tg_max, rows=rows)


@functools.lru_cache(maxsize=256)
def k1_grid(B: int, nch: int, T: int, tg_max: int):
    """(tg, bt): the tiles and the blocks a K1 CTA takes at batch B: the most
    tiles that still give ``K1_CTA_TARGET`` CTAs (nch x ceil(T / tg) x
    ceil(B / bt)), with the blocks in the fewest runs that do, evened out;
    where none does, one tile and one block a CTA. It changes no bit: the
    sums are the plan's whatever the CTAs take."""
    tg = tg_max
    while tg >= 1:
        q = -(-K1_CTA_TARGET // (nch * -(-T // tg)))  # block runs needed
        if q <= B:
            bt = B if q <= 1 else (B - 1) // (q - 1)  # the longest runs, at least q of them
            return tg, -(-B // -(-B // bt))  # the same number of runs, evened out
        tg //= 2
    return 1, 1


def k1_mask_groups(M: int):
    """K1's launches for a bank of M masks: [(m0, m1)], contiguous groups of
    at most ``K1_MAX_MASKS`` rows of Q in mask order, the last one holding
    the rest. Each group's rows of the (M, N) Q are a view, and each sums in
    the order its own plan (N and m1 - m0) fixes."""
    return [(m0, min(m0 + K1_MAX_MASKS, M)) for m0 in range(0, M, K1_MAX_MASKS)]


def _device_plan(shifts: torch.Tensor, N: int, M: int):
    """``doppler_energy_plan`` of the grid tensor with its rows on the grid's
    device, kept on the tensor per (N, M): the grid is a constant of the
    spec, so it is read back (one copy) only at the first call and after an
    in-place change (``_version``). An inference tensor keeps no version, so
    its plan is built anew at every call. Returns (plan, the kernel's
    table)."""
    version = None if shifts.is_inference() else shifts._version
    plans = getattr(shifts, "_k1_plans", None)
    cached = None if plans is None else plans.get((N, M))
    if version is None or cached is None or cached[0] != version:
        grid = shifts.cpu().numpy()
        plan = doppler_energy_plan(grid, N, M)
        cached = (version, plan, torch.from_numpy(plan.table(grid)).to(shifts.device))
        if version is not None:
            if plans is None:
                plans = shifts._k1_plans = {}
            plans[(N, M)] = cached
    return cached[1:]


#: K1's chunk partials and arrival counters, per (device, stream): one
#: launch at a time uses them on a stream, and every launch leaves the
#: counters at 0, so no call allocates or clears them after the first
_k1_scratch = {}


def _scratch(device, stream: int, n_part: int, n_count: int):
    key = (device.index, stream)
    part, count = _k1_scratch.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if count is None or count.numel() < n_count:
        count = torch.zeros(n_count, dtype=torch.int32, device=device)
    _k1_scratch[key] = (part, count)
    return part, count


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


def _launch_k1(P, Q, shifts, centre_shift) -> torch.Tensor:
    """Check the operands and launch ``csrc/doppler_energy.cu`` on CUDA ``P``,
    once per ``k1_mask_groups`` group; E's columns are put together in mask
    order."""
    if P.device.type != "cuda":
        raise ValueError(f"doppler_energy: unsupported device {P.device}")
    B, N = P.shape
    M, D = Q.shape[0], shifts.shape[0]
    _lib.check(P, "P", torch.float32, (B, N))
    _lib.check(Q, "Q", torch.float32, (M, N), P.device)
    _lib.check(shifts, "shifts", torch.int32, (D,), P.device)
    if centre_shift is not None:
        _lib.check(centre_shift, "centre_shift", torch.int32, (B,), P.device)
    if M <= K1_MAX_MASKS:
        return _launch_k1_group(P, Q, shifts, centre_shift)
    return torch.cat([_launch_k1_group(P, Q[m0:m1], shifts, centre_shift)
                      for m0, m1 in k1_mask_groups(M)], dim=2)


def _launch_k1_group(P, Q, shifts, centre_shift) -> torch.Tensor:
    """One K1 launch over the (Mg <= 32, N) rows ``Q`` (checked operands);
    each launch adds one to ``doppler_energy.launches``."""
    B, N = P.shape
    M, D = Q.shape[0], shifts.shape[0]
    plan, rows = _device_plan(shifts, N, M)
    tg, bt = k1_grid(B, plan.nch, plan.T, plan.tg_max)
    stream = torch.cuda.current_stream().cuda_stream
    part, count = _scratch(P.device, stream, B * plan.nch * plan.T * K1_ROWS * plan.MP,
                           B * -(-plan.T // tg))
    E = torch.empty((B, D, M), dtype=torch.float32, device=P.device)
    vec = N % 4 == 0 and P.data_ptr() % 16 == 0 and Q.data_ptr() % 16 == 0
    _lib.launch("pycusdr_doppler_energy", _lib.ptr(P), _lib.ptr(Q),
                _lib.ptr(centre_shift), _lib.ptr(rows), _lib.ptr(part), _lib.ptr(count),
                _lib.ptr(E), B, N, D, M, plan.L, plan.T, plan.wwin, tg, bt, int(vec),
                N / ABS_SUM_SCALE, stream=stream)
    doppler_energy.launches += 1
    return E


def doppler_energy(P: torch.Tensor, Q: torch.Tensor, shifts: torch.Tensor,
                   centre_shift: torch.Tensor = None) -> torch.Tensor:
    """K1: E[b, d, m] of the block. See ``doppler_energy_plain`` for the
    arguments. A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/doppler_energy.cu`` or raises."""
    if P.device.type == "cpu":
        return doppler_energy_plain(P, Q, shifts, centre_shift)
    return _launch_k1(P, Q, shifts, centre_shift)


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


def doppler_estimate_plain(E, P, shifts, shifts_signed, hz_lut, *, num_dopplers: int,
                           array_offset: int, sum_all_masks: bool, snr_window: int,
                           centre_freq_offset: float, centre_shift: torch.Tensor = None,
                           bin_hz: float = 0.0):
    """Plain PyTorch K5: ``find_doppler_estimate``, the fractional
    interpolation of ``pycusdr_tpu/dsp/block.py:248-267`` and
    ``compute_snr``, batched. E: (B, D, M) f32; P: (B, N) f32 = |S|^2;
    shifts: (D,) int32 in [0, N); shifts_signed: the same unwrapped into
    [-N/2, N/2); hz_lut: (D,) f32. Returns (dopp_idx, quality_db,
    doppler_hz, freq_offset_hz, snr_db) f32 and shift int32, each (B,).

    ``centre_shift``: optional (B,) int32 runtime recentre of the grid in
    FFT bins of width ``bin_hz`` (fs/N, taken as f32): JAX adds
    f32(c) * f32(bin_hz) to doppler_hz after the interpolation, c to the
    shift before the mod and to both SNR bands (``dsp/block.py:254-266``)."""
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
    shift = torch.round(sl + (sh - sl) * frac).to(torch.int32)
    lo, hi = shifts[lowIdx], shifts[highIdx]
    if centre_shift is not None:
        c = centre_shift.to(torch.int32)
        bin32 = torch.tensor(bin_hz, dtype=torch.float32, device=E.device)
        doppler_hz = doppler_hz + c.float() * bin32
        shift, lo, hi = shift + c, lo + c, hi + c
    shift = torch.remainder(shift, N)
    snr_db = compute_snr(torch.sqrt(P), lo, hi, snr_window, N)
    return dopp_idx, quality_db, doppler_hz, doppler_hz - centre_freq_offset, snr_db, shift


def doppler_estimate(E, P, shifts, shifts_signed, hz_lut, *, num_dopplers: int,
                     array_offset: int, sum_all_masks: bool, snr_window: int,
                     centre_freq_offset: float, tail: torch.Tensor = None,
                     centre_shift: torch.Tensor = None, bin_hz: float = 0.0):
    """K5: the Doppler estimate, interpolation and SNR of a block in one
    launch (see ``doppler_estimate_plain`` for the arguments and outputs,
    ``centre_shift`` and ``bin_hz`` among them). A CPU tensor takes the
    plain version; a CUDA tensor launches ``csrc/doppler_estimate.cu`` or
    raises.

    ``tail``: the packed rows from their first scalar on (``row[:, 5 S:]``,
    a view with unit column stride). The five f32 outputs, the shift and E
    are then also written there, and the f32 outputs returned are views
    of it."""
    kw = dict(num_dopplers=num_dopplers, array_offset=array_offset,
              sum_all_masks=sum_all_masks, snr_window=snr_window,
              centre_freq_offset=centre_freq_offset, centre_shift=centre_shift,
              bin_hz=bin_hz)
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
    if not 0 < num_dopplers <= D - array_offset or array_offset < 0:
        raise ValueError(f"doppler_estimate: grid D={D}, num_dopplers={num_dopplers}, "
                         f"offset={array_offset} not supported")
    _lib.check(E, "E", torch.float32, (B, D, M))
    _lib.check(P, "P", torch.float32, (B, N), dev)
    _lib.check(shifts, "shifts", torch.int32, (D,), dev)
    _lib.check(shifts_signed, "shifts_signed", torch.int32, (D,), dev)
    _lib.check(hz_lut, "hz_lut", torch.float32, (D,), dev)
    if centre_shift is not None:
        _lib.check(centre_shift, "centre_shift", torch.int32, (B,), dev)
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
                _lib.ptr(centre_shift), B, N, D, M, num_dopplers, array_offset,
                int(sum_all_masks), snr_window, float(centre_freq_offset), float(bin_hz))
    doppler_estimate.launches += 1
    return tuple(sc[:, sc_at + i] for i in range(5)) + (shift,)


doppler_estimate.launches = 0
