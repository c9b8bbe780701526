"""The per-block demodulation graph on the device.

[spike clipping (K6)] -> FFT -> [Doppler energy (K1) -> Doppler estimate,
interpolation and SNR (K5) | the fixed shift] -> best-shift
matched-filter bank reduced over masks (K2) -> symbol timing (K3) ->
symbol detection with bits, trust and the clip window (K4) [-> NRZ-S
bits from the symbol transitions (K4n)] -> one packed f32 row per block. A runtime
``centre_shift`` moves the Doppler grid of K1 and K5 (tracking).

The bracketed stages follow the spec: the UHF mode searches Doppler and
does not clip; the STX mode (``doppler_search=False``,
``disable_peak_thresholding=False``) clips interference spikes, tags the
bits near them with trust -2 and shifts the spectrum by the fixed IF
offset (``pycusdr_tpu/dsp/block.py:219-222,268-275,296-331``). K4n runs
for a protocol without a centre-bit LUT (bench_BPSK): its bits come from
the symbol LUT, with trust -1 on a transition error and nBits = nSym - 1
(``pycusdr_tpu/dsp/block.py:318-331``); on the kernel path it runs in
K4's launch (``symbol_detect_nrzs``).

The graph comes in two forms, complex64 throughout:

- the kernel path (``_process_rows``): each kernel wrapper launches its
  CUDA kernel on a CUDA tensor (and runs its plain version on a CPU
  tensor). K4 and K5 write their outputs straight into one (B, L) row
  buffer, so no concatenation runs per call. Device scalars (shift,
  spSym, codeOffset, the clip bitmask) stay on the device and reach the
  kernels by pointer, so a call queues work without any host sync.
- the plain path (``_process_plain``, ``plain=True``): every kernel's
  plain PyTorch version, giving a dict of typed tensors that
  ``pack_block_outputs`` packs. The kernels are held against it.

The packed layout is that of ``pycusdr_tpu/dsp/block.py:60-111``
(``ops/layout.py``).
"""

import numpy as np
import torch

from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.dsp.spec import DemodSpec
from pycusdr_tpu_torch.ops import _lib
from pycusdr_tpu_torch.ops.demod_kernels import (
    clip_halfwidth,
    dilate_mask_plain,
    mf_bank_colreduce,
    mf_bank_colreduce_plain,
    nrzs_bits_plain,
    nrzs_trust_plain,
    symbol_detect,
    symbol_detect_nrzs,
    symbol_detect_plain,
    threshold_input,
    threshold_input_plain,
    timing_band,
    timing_band_plain,
)
from pycusdr_tpu_torch.ops.doppler_search import (
    doppler_energy,
    doppler_energy_plain,
    doppler_estimate,
    doppler_estimate_plain,
)
from pycusdr_tpu_torch.ops.layout import E_AT, PACK_ARRAYS, PACK_SCALARS, SCALAR, row_len

#: dtypes of the result dict; every other output is f32
_DTYPES = {"bits": torch.int8, "trust": torch.int8, "symbols": torch.int32,
           "centres": torch.int32, "nSym": torch.int32, "nBits": torch.int32,
           "shift": torch.int32, "clipped_any": torch.bool}


def packed_len(spec: DemodSpec) -> int:
    return row_len(spec.numSymMax, spec.D, spec.num_masks)


def pack_block_outputs(out: dict) -> torch.Tensor:
    """Flatten a batched result dict into ONE (B, L) f32 tensor. Integer
    payloads are < 2^24, so the f32 round trip is exact."""
    parts = [out[k].float() for k in PACK_ARRAYS]
    parts.append(torch.stack([out[k].float() for k in PACK_SCALARS], dim=-1))
    E = out["E"].float()
    parts.append(E.reshape(E.shape[:-2] + (-1,)))
    return torch.cat(parts, dim=-1)


def unpack_rows(row: torch.Tensor, spec: DemodSpec) -> dict:
    """Device-side inverse of ``pack_block_outputs``: (B, L) rows -> the
    batched result dict with its dtypes."""
    S, B = spec.numSymMax, row.shape[0]
    out = {k: row[:, i * S:(i + 1) * S] for i, k in enumerate(PACK_ARRAYS)}
    tail = row[:, len(PACK_ARRAYS) * S:]
    out.update({k: tail[:, i] for k, i in SCALAR.items()})
    out["E"] = tail[:, E_AT:].reshape(B, spec.D, spec.num_masks)
    return {k: v.to(_DTYPES.get(k, torch.float32)) for k, v in out.items()}


def unpack_block_outputs(vec: np.ndarray, spec: DemodSpec) -> dict:
    """Host-side inverse of ``pack_block_outputs`` for one block (numpy)."""
    v = np.asarray(vec)
    S = spec.numSymMax
    out = {
        "bits": v[0:S].astype(np.int8),
        "trust": v[S:2 * S].astype(np.int8),
        "symbols": v[2 * S:3 * S].astype(np.int32),
        "centres": v[3 * S:4 * S].astype(np.int32),
        "mags": v[4 * S:5 * S],
    }
    sc = v[5 * S:5 * S + len(PACK_SCALARS)]
    for i, k in enumerate(PACK_SCALARS):
        out[k] = sc[i]
    for k in ("nSym", "nBits", "shift"):
        out[k] = np.int32(out[k])
    out["clipped_any"] = bool(out["clipped_any"])
    out["E"] = v[5 * S + len(PACK_SCALARS):].reshape(spec.D, spec.num_masks)
    return out


def _k4_kwargs(spec: DemodSpec, c: DeviceConsts) -> dict:
    return dict(Nfft=spec.Nfft, windowWidth=spec.windowWidth, spsymMin=spec.spsymMin,
                numSymMax=spec.numSymMax, trust_normal=c.trust_normal)


def _k5_kwargs(spec: DemodSpec, centre: torch.Tensor = None) -> dict:
    return dict(num_dopplers=spec.num_dopplers, array_offset=spec.dopp_array_offset,
                sum_all_masks=spec.sum_all_masks, snr_window=spec.snr_window,
                centre_freq_offset=spec.centreFreqOffset, centre_shift=centre,
                bin_hz=spec.sampleRate / spec.Nfft)


def _fixed_tail(spec: DemodSpec, dev) -> torch.Tensor:
    """The row from dopp_idx on in the no-search mode: the Doppler scalars
    0, the shift dopp_offset_idx, and E zeros of (D, M) (clipped_any,
    inside it, is written by K4 afterwards)."""
    v = np.zeros(len(PACK_SCALARS) - SCALAR["dopp_idx"] + spec.D * spec.num_masks, np.float32)
    v[SCALAR["shift"] - SCALAR["dopp_idx"]] = spec.dopp_offset_idx
    return torch.from_numpy(v).to(dev)


def _process_rows(x: torch.Tensor, spec: DemodSpec, c: DeviceConsts,
                  fixed_tail: torch.Tensor, row: torch.Tensor = None,
                  centre: torch.Tensor = None) -> torch.Tensor:
    """The kernel path on a (B, N) complex64 batch; returns the (B, L)
    rows, written into ``row`` when given. ``centre``: None or the (B,)
    int32 grid recentre that K1 and K5 take."""
    M = spec.num_masks
    if row is None:
        row = torch.empty((x.shape[0], packed_len(spec)), dtype=torch.float32, device=x.device)
    tail = row[:, len(PACK_ARRAYS) * spec.numSymMax:]
    hits = clipped_any = None
    if not spec.disable_peak_thresholding:
        x, hits, clipped_any = threshold_input(x, c.threshold_scale)

    S = torch.fft.fft(x)
    if spec.doppler_search:
        P = S.real * S.real + S.imag * S.imag
        E = doppler_energy(P, c.Q, c.shifts, centre)
        shift = doppler_estimate(E, P, c.shifts, c.shifts_signed, c.hz_lut,
                                 **_k5_kwargs(spec, centre), tail=tail)[-1]
    else:
        tail[:, SCALAR["dopp_idx"]:] = fixed_tail  # the one fill of the STX path
        shift = c.fixed_shift

    off = spec.code_search_mask_offset
    colsum, colmax, colarg = mf_bank_colreduce(S, c.masks_f, shift, off, M - off, tw=c.tw)
    spSym, codeOffset, code_val = timing_band(colsum, spec.code_idx_lo, spec.code_idx_hi,
                                              tw=c.tw)
    k4 = dict(_k4_kwargs(spec, c), hits=hits, row=row, code_val=code_val,
              clipped_any=clipped_any)
    if c.bitLUT is None:  # K4 and the NRZ-S bits (K4n) in one launch
        symbol_detect_nrzs(colmax, colarg, spSym, codeOffset, c.symbolLUT, **k4)
    else:
        symbol_detect(colmax, colarg, spSym, codeOffset, c.bitLUT, **k4)
    return row


def _process_plain(x: torch.Tensor, spec: DemodSpec, c: DeviceConsts,
                   centre: torch.Tensor = None) -> dict:
    """The plain path on a (B, N) complex64 batch; returns the batched dict."""
    D, M = spec.D, spec.num_masks
    B = x.shape[0]
    dev = x.device
    clip = not spec.disable_peak_thresholding
    if clip:
        x, hit2 = threshold_input_plain(x, c.threshold_scale)

    S = torch.fft.fft(x)
    if spec.doppler_search:
        P = S.real * S.real + S.imag * S.imag
        E = doppler_energy_plain(P, c.Q, c.shifts, centre)
        dopp_idx, quality_db, doppler_hz, freq_offset_hz, snr_db, shift = \
            doppler_estimate_plain(E, P, c.shifts, c.shifts_signed, c.hz_lut,
                                   **_k5_kwargs(spec, centre))
    else:
        E = torch.zeros((B, D, M), dtype=torch.float32, device=dev)
        dopp_idx = quality_db = doppler_hz = freq_offset_hz = snr_db = \
            torch.zeros(B, dtype=torch.float32, device=dev)
        shift = c.fixed_shift.expand(B)

    off = spec.code_search_mask_offset
    colsum, colmax, colarg = mf_bank_colreduce_plain(S, c.masks_f, shift, off, M - off)
    spSym, codeOffset, code_val = timing_band_plain(colsum, spec.code_idx_lo, spec.code_idx_hi)
    clip_mask = (dilate_mask_plain(hit2, clip_halfwidth(spSym, spec.spsymMin))
                 if clip else None)
    symbols, centres, mags, bits, trust, nSym = symbol_detect_plain(
        colmax, colarg, spSym, codeOffset, c.bitLUT, **_k4_kwargs(spec, c),
        clip_mask=clip_mask)[:6]
    nBits = nSym
    if c.bitLUT is None:
        bits, err = nrzs_bits_plain(symbols, c.symbolLUT)
        trust = nrzs_trust_plain(trust, err)
        nBits = nSym - 1

    return {
        "bits": bits, "trust": trust, "symbols": symbols, "centres": centres,
        "mags": mags, "nSym": nSym, "nBits": nBits, "spSym": spSym,
        "codeOffset": codeOffset, "code_val": code_val, "dopp_idx": dopp_idx,
        "quality_db": quality_db, "doppler_hz": doppler_hz,
        "freq_offset_hz": freq_offset_hz, "snr_db": snr_db, "shift": shift,
        "clipped_any": (hit2.any(dim=-1) if clip
                        else torch.zeros(B, dtype=torch.bool, device=dev)),
        "E": E,
    }


def _centre(centre_shift, B: int, dev) -> torch.Tensor:
    """None, or the recentre as a (B,) int32 tensor on ``dev`` from an int
    or a tensor of one or B values. An int is filled on the device: a copy
    from pageable host memory would synchronise the stream first."""
    if centre_shift is None:
        return None
    if isinstance(centre_shift, (int, np.integer)):
        return torch.full((B,), int(centre_shift), dtype=torch.int32, device=dev)
    c = torch.as_tensor(centre_shift, dtype=torch.int32).to(dev)
    if c.numel() not in (1, B):
        raise ValueError(f"centre_shift: expected 1 or {B} values, got {c.numel()}")
    return c.reshape(-1).expand(B).contiguous()


def build_process_batch(spec: DemodSpec, device=None, packed: bool = False,
                        plain: bool = False):
    """Return ``process(blocks, row=None, centre_shift=None) -> outputs``
    for (B, Nfft) complex64 blocks: a dict of (B, ...) tensors, or with
    ``packed`` one (B, L) f32 tensor in the layout of
    ``pack_block_outputs``, written into ``row`` (a (B, L) f32 tensor on
    the device) when given.

    ``centre_shift``: None, an int or a (B,) int32 tensor: recentres the
    Doppler grid by that many FFT bins at runtime (the search-and-track
    loop, ``models/tracking.py``), in K1 and K5 and in their plain
    versions, as ``pycusdr_tpu/dsp/block.py:205-266`` does. None leaves
    the graph as it is without a recentre; a spec without a Doppler search
    ignores it, as JAX's does.

    ``device``: None means the card (raises without one); pass "cpu" to
    run on the CPU, where every wrapper takes its kernel's plain version.
    ``plain``: run the plain path (``_process_plain``) instead of the
    kernels: the reference the kernels are held against on the card.
    """
    if spec.bitLUT is None and spec.symbolLUT is None:
        raise ValueError("the spec has neither a centre-bit LUT nor an NRZ-S symbol LUT")
    dev = _lib.resolve_device(device)
    consts = DeviceConsts.from_spec(spec, dev)
    fixed_tail = None if spec.doppler_search else _fixed_tail(spec, dev)

    def process(blocks, row=None, centre_shift=None):
        x = torch.as_tensor(blocks).to(dev, torch.complex64).contiguous()
        if x.dim() != 2 or x.shape[1] != spec.Nfft:
            raise ValueError(f"expected (B, {spec.Nfft}) blocks, got {tuple(x.shape)}")
        if row is not None and (not packed or tuple(row.shape) != (x.shape[0], packed_len(spec))):
            raise ValueError("row: needs packed=True and shape (B, L)")
        centre = _centre(centre_shift, x.shape[0], dev) if spec.doppler_search else None
        if plain:
            out = _process_plain(x, spec, consts, centre)
            if not packed:
                return out
            return pack_block_outputs(out) if row is None else row.copy_(pack_block_outputs(out))
        row = _process_rows(x, spec, consts, fixed_tail, row=row, centre=centre)
        return row if packed else unpack_rows(row, spec)

    process.device = dev
    return process


def build_process_block(spec: DemodSpec, device=None, packed: bool = False,
                        plain: bool = False):
    """Return ``process_block(samples, centre_shift=None)`` for one (Nfft,)
    block or a (B, Nfft) batch of complex64 samples; outputs drop the batch
    axis for a single block. Arguments as ``build_process_batch``."""
    batch = build_process_batch(spec, device=device, packed=packed, plain=plain)

    def process_block(samples, centre_shift=None):
        x = torch.as_tensor(samples)
        if x.dim() != 1:
            return batch(x, centre_shift=centre_shift)
        out = batch(x[None], centre_shift=centre_shift)
        return out[0] if packed else {k: v[0] for k, v in out.items()}

    process_block.device = batch.device
    return process_block


def frame_blocks(head: torch.Tensor, new: torch.Tensor, Nfft: int):
    """Overlap-save framing on the device: ``(blocks, tail)`` of the signal
    ``cat([head, new])``, where ``head`` is the (ov,) tail the previous call
    left and ``new`` holds K hops of Nfft - ov samples. ``blocks`` is the
    (K, Nfft) batch of block k at k * hop, made contiguous: cuFFT rounds an
    overlapping view otherwise, and a block's decisions must not depend on
    how it was framed. ``tail`` is the last ov samples, the next call's
    ``head``."""
    ov = head.shape[0]
    hop = Nfft - ov
    sig = torch.cat([head, new])
    return sig.unfold(0, Nfft, hop).contiguous(), sig[sig.shape[0] - ov:]


def _capture_args(hops, carry, spec: DemodSpec, dev):
    """``hops`` (K, hop) and ``carry`` (sigOverlap,) as complex64 on ``dev``."""
    ov = spec.sigOverlap
    hop = spec.Nfft - ov
    hops = torch.as_tensor(hops).to(dev, torch.complex64).contiguous()
    carry = torch.as_tensor(carry).to(dev, torch.complex64).contiguous()
    if hops.dim() != 2 or hops.shape[0] < 1 or hops.shape[1] != hop:
        raise ValueError(f"expected (K >= 1, {hop}) hops, got {tuple(hops.shape)}")
    if tuple(carry.shape) != (ov,):
        raise ValueError(f"expected a ({ov},) carry, got {tuple(carry.shape)}")
    return hops, carry


def build_process_stream(spec: DemodSpec, device=None, plain: bool = False):
    """Whole-capture processor, the port of ``pycusdr_tpu/dsp/block.py:427``:
    ``stream(hops, carry) -> (res, carry)``.

    ``hops``: (K, Nfft - sigOverlap) complex64 new samples; ``carry``: the
    (sigOverlap,) tail of the previous call. The overlap-save chain is
    walked one block at a time (one B=1 call of the block graph a hop) with
    the carry on the device. ``res`` is the batched result dict of
    ``build_process_batch`` with a leading K axis, without ``E``.
    ``device`` and ``plain`` as ``build_process_batch``'s."""
    batch = build_process_batch(spec, device=device, plain=plain)
    ov = spec.sigOverlap

    def stream(hops, carry):
        hops, carry = _capture_args(hops, carry, spec, batch.device)
        outs = []
        for h in hops:
            block = torch.cat([carry, h])
            outs.append(batch(block[None]))
            carry = block[spec.Nfft - ov:]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0] if k != "E"}, carry

    stream.device = batch.device
    return stream


def build_process_capture(spec: DemodSpec, device=None, plain: bool = False):
    """Whole-capture processor at batch throughput, the port of
    ``pycusdr_tpu/dsp/block.py:458``: ``capture(hops, carry) -> (res,
    carry)``, with the arguments and results of ``build_process_stream``.

    Overlap-save block k is a pure slice of the capture, so the K blocks are
    framed on the device (``frame_blocks``) and run as one batch through
    ``build_process_batch``. Its decisions and carry equal the stream's
    (``bench/capture_probe.py`` holds them so on the card); on the CPU the
    FFT rounds a batch differently from one transform, which the analog
    outputs (mags among them) carry in their last bits."""
    batch = build_process_batch(spec, device=device, plain=plain)

    def capture(hops, carry):
        hops, carry = _capture_args(hops, carry, spec, batch.device)
        blocks, tail = frame_blocks(carry, hops.reshape(-1), spec.Nfft)
        res = batch(blocks)
        res.pop("E")
        return res, tail

    capture.device = batch.device
    return capture
