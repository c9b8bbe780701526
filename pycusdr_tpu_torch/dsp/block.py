"""The per-block demodulation graph on the device.

[spike clipping (K6)] -> FFT -> [Doppler energy (K1) -> Doppler estimate,
interpolation and SNR (K5) | the fixed shift] -> best-shift
matched-filter bank reduced over masks (K2) -> symbol timing (K3) ->
symbol detection with bits, trust and the clip window (K4) -> one packed
f32 row per block.

The bracketed stages follow the spec: the UHF mode searches Doppler and
does not clip; the STX mode (``doppler_search=False``,
``disable_peak_thresholding=False``) clips interference spikes, tags the
bits near them with trust -2 and shifts the spectrum by the fixed IF
offset (``pycusdr_tpu/dsp/block.py:219-222,268-275,296-331``).

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
    symbol_detect,
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


def _check_supported(spec: DemodSpec) -> None:
    if spec.bitLUT is None:
        raise NotImplementedError(
            "NRZ-S bit extraction is not yet ported (ROADMAP.md Queue 2: extract_bits_nrzs)")


def _k4_kwargs(spec: DemodSpec, c: DeviceConsts) -> dict:
    return dict(Nfft=spec.Nfft, windowWidth=spec.windowWidth, spsymMin=spec.spsymMin,
                numSymMax=spec.numSymMax, trust_normal=c.trust_normal)


def _k5_kwargs(spec: DemodSpec) -> dict:
    return dict(num_dopplers=spec.num_dopplers, array_offset=spec.dopp_array_offset,
                sum_all_masks=spec.sum_all_masks, snr_window=spec.snr_window,
                centre_freq_offset=spec.centreFreqOffset)


def _fixed_tail(spec: DemodSpec, dev) -> torch.Tensor:
    """The row from dopp_idx on in the no-search mode: the Doppler scalars
    0, the shift dopp_offset_idx, and E zeros of (D, M) (clipped_any,
    inside it, is written by K4 afterwards)."""
    v = np.zeros(len(PACK_SCALARS) - SCALAR["dopp_idx"] + spec.D * spec.num_masks, np.float32)
    v[SCALAR["shift"] - SCALAR["dopp_idx"]] = spec.dopp_offset_idx
    return torch.from_numpy(v).to(dev)


def _process_rows(x: torch.Tensor, spec: DemodSpec, c: DeviceConsts,
                  fixed_tail: torch.Tensor) -> torch.Tensor:
    """The kernel path on a (B, N) complex64 batch; returns the (B, L) rows."""
    M, S_ = spec.num_masks, spec.numSymMax
    row = torch.empty((x.shape[0], packed_len(spec)), dtype=torch.float32, device=x.device)
    tail = row[:, len(PACK_ARRAYS) * S_:]
    hits = clipped_any = None
    if not spec.disable_peak_thresholding:
        x, hits, clipped_any = threshold_input(x, c.threshold_scale)

    S = torch.fft.fft(x)
    if spec.doppler_search:
        P = S.real * S.real + S.imag * S.imag
        E = doppler_energy(P, c.Q, c.shifts)
        shift = doppler_estimate(E, P, c.shifts, c.shifts_signed, c.hz_lut,
                                 **_k5_kwargs(spec), tail=tail)[-1]
    else:
        tail[:, SCALAR["dopp_idx"]:] = fixed_tail  # the one fill of the STX path
        shift = c.fixed_shift

    off = spec.code_search_mask_offset
    colsum, colmax, colarg = mf_bank_colreduce(S, c.masks_f, shift, off, M - off, tw=c.tw)
    spSym, codeOffset, code_val = timing_band(colsum, spec.code_idx_lo, spec.code_idx_hi,
                                              tw=c.tw)
    return symbol_detect(colmax, colarg, spSym, codeOffset, c.bitLUT, **_k4_kwargs(spec, c),
                         hits=hits, row=row, code_val=code_val, clipped_any=clipped_any)


def _process_plain(x: torch.Tensor, spec: DemodSpec, c: DeviceConsts) -> dict:
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
        E = doppler_energy_plain(P, c.Q, c.shifts)
        dopp_idx, quality_db, doppler_hz, freq_offset_hz, snr_db, shift = \
            doppler_estimate_plain(E, P, c.shifts, c.shifts_signed, c.hz_lut, **_k5_kwargs(spec))
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

    return {
        "bits": bits, "trust": trust, "symbols": symbols, "centres": centres,
        "mags": mags, "nSym": nSym, "nBits": nSym, "spSym": spSym,
        "codeOffset": codeOffset, "code_val": code_val, "dopp_idx": dopp_idx,
        "quality_db": quality_db, "doppler_hz": doppler_hz,
        "freq_offset_hz": freq_offset_hz, "snr_db": snr_db, "shift": shift,
        "clipped_any": (hit2.any(dim=-1) if clip
                        else torch.zeros(B, dtype=torch.bool, device=dev)),
        "E": E,
    }


def build_process_batch(spec: DemodSpec, device=None, packed: bool = False,
                        plain: bool = False):
    """Return ``process(blocks) -> outputs`` for (B, Nfft) complex64
    blocks: a dict of (B, ...) tensors, or with ``packed`` one (B, L) f32
    tensor in the layout of ``pack_block_outputs``.

    ``device``: None means the card (raises without one); pass "cpu" to
    run on the CPU, where every wrapper takes its kernel's plain version.
    ``plain``: run the plain path (``_process_plain``) instead of the
    kernels: the reference the kernels are held against on the card.
    """
    _check_supported(spec)
    dev = _lib.resolve_device(device)
    consts = DeviceConsts.from_spec(spec, dev)
    fixed_tail = None if spec.doppler_search else _fixed_tail(spec, dev)

    def process(blocks):
        x = torch.as_tensor(blocks).to(dev, torch.complex64).contiguous()
        if x.dim() != 2 or x.shape[1] != spec.Nfft:
            raise ValueError(f"expected (B, {spec.Nfft}) blocks, got {tuple(x.shape)}")
        if plain:
            out = _process_plain(x, spec, consts)
            return pack_block_outputs(out) if packed else out
        row = _process_rows(x, spec, consts, fixed_tail)
        return row if packed else unpack_rows(row, spec)

    process.device = dev
    return process


def build_process_block(spec: DemodSpec, device=None, packed: bool = False):
    """Return ``process_block(samples)`` for one (Nfft,) block or a (B,
    Nfft) batch of complex64 samples; outputs drop the batch axis for a
    single block. Arguments as ``build_process_batch``."""
    batch = build_process_batch(spec, device=device, packed=packed)

    def process_block(samples):
        x = torch.as_tensor(samples)
        if x.dim() != 1:
            return batch(x)
        out = batch(x[None])
        return out[0] if packed else {k: v[0] for k, v in out.items()}

    process_block.device = batch.device
    return process_block
