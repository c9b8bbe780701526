"""The multi-channel demodulation step: channels x dopp/mask sharding.

The port of ``pycusdr_tpu/parallel/sharded_demod.py``. A mesh
(``parallel/mesh.py``) of one device runs the whole step on it; a mesh
of n ranks runs one shard per process of a ``torch.distributed`` world.
``step(blocks)`` takes this rank's channel rows (``multihost.
local_channel_slice``): the ``channel`` axis shards the channels, and
every rank of one channel shard gets the same rows.

Two programs, as in JAX:

- the channel-parallel step (``dopp`` = 1, ``:107-163``): the block
  graph over the local channels; with ``vote`` the rows are all-gathered
  along ``channel`` and the diversity vote (K8) masks each channel's pad
  slots at its nBits and votes.
- the generic step (``force_generic``, or ``dopp`` > 1, ``:224-491``):
  the mask bank is sharded over ``dopp``, Ml = M / nd masks a shard from
  global mask m0. K6, the FFT, K1 on the shard's Q rows, an all-gather
  of E along ``dopp``, K5, K2 on the shard's masks (its part of the
  timing sum), a sum of the timing power along ``dopp``, K3, the
  shard-local detector K4l, one all-gather of its (value, key) pairs (one
  8-byte word a slot), the cross-shard select K4s (with K4n's NRZ-S bits in
  its launch for an NRZ-S protocol). With ``vote`` the rows are
  all-gathered along ``channel`` and K8 votes the trust as K4s wrote it
  (-1 beyond nSym; no pad mask at nBits, ``:378-379,429-434``).

The block graph's kernels and K4s write the packed rows (``ops/layout.py``)
of the local channels into one vector; K8 writes the voted pair into its
tail, as ``runtime/channel_group_process.build_group_graph`` does.
"""

import torch

from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.dsp.block import (
    _fixed_tail,
    _k4_kwargs,
    _k5_kwargs,
    build_process_batch,
    pack_block_outputs,
    packed_len,
    unpack_rows,
)
from pycusdr_tpu_torch.dsp.spec import DemodSpec
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops import doppler_search as ds
from pycusdr_tpu_torch.ops.layout import PACK_ARRAYS, SCALAR
from pycusdr_tpu_torch.parallel.collectives import all_gather, all_reduce
from pycusdr_tpu_torch.parallel.mesh import Mesh
from pycusdr_tpu_torch.parallel.vote import vote_rows, vote_rows_plain

#: the per-channel outputs of the step (``sharded_demod.py:118-120``)
KEYS = ("bits", "trust", "symbols", "centres", "mags", "nSym", "nBits", "spSym",
        "doppler_hz", "freq_offset_hz", "quality_db", "snr_db", "shift")


def build_sharded_demod_step(spec: DemodSpec, mesh: Mesh, vote: bool = True,
                             master_idx: int = 0, master_weight: float = 1.2,
                             force_generic: bool = False, plain: bool = False):
    """Return ``step(blocks) -> dict`` for this rank's (Cl, Nfft) complex64
    channel blocks on ``mesh.device`` (Cl = C / the ``channel`` axis): the
    ``KEYS`` outputs, each with a leading Cl axis, and with ``vote``
    ``bits_voted`` (int8) and ``trust_voted`` (f32), (S,) each, the same on
    every rank.

    ``force_generic`` or a ``dopp`` axis > 1: the generic channel x dopp
    program (module docstring); its trust is -1 beyond nSym, the
    channel-parallel step's is the block graph's. ``plain``: every
    kernel's plain version (the reference the kernels are held against)."""
    if "channel" not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no 'channel' axis")
    generic = force_generic or mesh.size("dopp") > 1
    L, S = packed_len(spec), spec.numSymMax
    dev = mesh.device
    rows_fn = (_build_generic_rows(spec, mesh, plain) if generic
               else build_process_batch(spec, device=dev, packed=True, plain=plain))
    vote_fn = vote_rows_plain if plain else vote_rows

    def step(blocks):
        x = torch.as_tensor(blocks).to(dev, torch.complex64).contiguous()
        if x.dim() != 2 or x.shape[1] != spec.Nfft:
            raise ValueError(f"expected (C, {spec.Nfft}) blocks, got {tuple(x.shape)}")
        Cl = x.shape[0]
        vec = torch.empty(Cl * L + (2 * S if vote else 0), dtype=torch.float32, device=dev)
        rows = vec[:Cl * L].view(Cl, L)
        rows_fn(x, row=rows)
        # the casts copy trust before K8 masks the pad slots in the rows
        res = unpack_rows(rows, spec)
        out = {k: res[k] for k in KEYS}
        if vote:
            pair = vote_fn(all_gather(rows, mesh, "channel"), S, master_weight,
                           vec[Cl * L:].view(2, S), master_idx, mask_pad=not generic)
            out["bits_voted"] = pair[0].to(torch.int8)
            out["trust_voted"] = pair[1]
        return out

    return step


def _build_generic_rows(spec: DemodSpec, mesh: Mesh, plain: bool):
    """``rows(x, row)``: the generic program's packed rows of the (Cl, N)
    blocks ``x``, written into ``row``."""
    if spec.bitLUT is None and spec.symbolLUT is None:
        raise ValueError("the spec has neither a centre-bit LUT nor an NRZ-S symbol LUT")
    nd, M = mesh.size("dopp"), spec.num_masks
    if M % nd:
        raise ValueError(f"num_masks={M} must divide by dopp axis size {nd}")
    Ml = M // nd
    m0 = mesh.coord("dopp") * Ml
    dev = mesh.device
    c = DeviceConsts.from_spec(spec, dev, mask_range=(m0, m0 + Ml))
    # the timing sum's masks [off, M - off), as local indices of this shard
    off = spec.code_search_mask_offset
    lo = min(max(off, m0), m0 + Ml)
    sum_range = (lo - m0, max(min(M - off, m0 + Ml), lo) - m0)
    fixed_tail = None if spec.doppler_search else _fixed_tail(spec, dev)
    k4 = _k4_kwargs(spec, c)
    k5 = _k5_kwargs(spec)
    k4l = dict(m0=m0, M=M, **{k: v for k, v in k4.items() if k != "trust_normal"})
    S_ = spec.numSymMax

    def rows_kernels(x, row):
        tail = row[:, len(PACK_ARRAYS) * S_:]
        hits = clipped_any = None
        if not spec.disable_peak_thresholding:
            x, hits, clipped_any = dk.threshold_input(x, c.threshold_scale)
        S = torch.fft.fft(x)
        if spec.doppler_search:
            P = S.real * S.real + S.imag * S.imag
            E = all_gather(ds.doppler_energy(P, c.Q, c.shifts), mesh, "dopp", dim=2)
            shift = ds.doppler_estimate(E.contiguous(), P, c.shifts, c.shifts_signed, c.hz_lut,
                                        **k5, tail=tail)[-1]
        else:
            tail[:, SCALAR["dopp_idx"]:] = fixed_tail
            shift = c.fixed_shift
        colsum, colmax, colarg = dk.mf_bank_colreduce(S, c.masks_f, shift, *sum_range, tw=c.tw)
        colsum = all_reduce(colsum, mesh, "dopp")
        spSym, codeOffset, code_val = dk.timing_band(colsum, spec.code_idx_lo,
                                                     spec.code_idx_hi, tw=c.tw)
        pair = dk.symbol_detect_local(colmax, colarg, spSym, codeOffset, **k4l, packed=True)
        pairs = all_gather(pair, mesh, "dopp", tiled=False)
        sel = dict(M=M, **k4, row=row, code_val=code_val, hits=hits, clipped_any=clipped_any)
        if c.bitLUT is None:
            dk.shard_select_nrzs(pairs, spSym, codeOffset, c.symbolLUT, **sel)
        else:
            dk.shard_select(pairs, spSym, codeOffset, c.bitLUT, **sel)
        return row

    def rows_plain(x, row):
        B = x.shape[0]
        clip = not spec.disable_peak_thresholding
        if clip:
            x, hit2 = dk.threshold_input_plain(x, c.threshold_scale)
        S = torch.fft.fft(x)
        if spec.doppler_search:
            P = S.real * S.real + S.imag * S.imag
            E = all_gather(ds.doppler_energy_plain(P, c.Q, c.shifts), mesh, "dopp", dim=2)
            dopp_idx, quality_db, doppler_hz, freq_offset_hz, snr_db, shift = \
                ds.doppler_estimate_plain(E, P, c.shifts, c.shifts_signed, c.hz_lut, **k5)
        else:
            E = torch.zeros((B, spec.D, M), dtype=torch.float32, device=dev)
            dopp_idx = quality_db = doppler_hz = freq_offset_hz = snr_db = \
                torch.zeros(B, dtype=torch.float32, device=dev)
            shift = c.fixed_shift.expand(B)
        colsum, colmax, colarg = dk.mf_bank_colreduce_plain(S, c.masks_f, shift, *sum_range)
        colsum = all_reduce(colsum, mesh, "dopp")
        spSym, codeOffset, code_val = dk.timing_band_plain(colsum, spec.code_idx_lo,
                                                           spec.code_idx_hi)
        val, key = dk.symbol_detect_local_plain(colmax, colarg, spSym, codeOffset, **k4l)
        clip_mask = (dk.dilate_mask_plain(hit2, dk.clip_halfwidth(spSym, spec.spsymMin))
                     if clip else None)
        symbols, centres, mags, bits, trust, nSym = dk.shard_select_plain(
            all_gather(val, mesh, "dopp", tiled=False), all_gather(key, mesh, "dopp", tiled=False),
            spSym, codeOffset, c.bitLUT, M=M, **k4, clip_mask=clip_mask)
        nBits = nSym
        if c.bitLUT is None:
            bits, err = dk.nrzs_bits_plain(symbols, c.symbolLUT)
            trust = dk.nrzs_trust_plain(trust, err)
            nBits = nSym - 1
        row.copy_(pack_block_outputs({
            "bits": bits, "trust": trust, "symbols": symbols, "centres": centres,
            "mags": mags, "nSym": nSym, "nBits": nBits, "spSym": spSym,
            "codeOffset": codeOffset, "code_val": code_val, "dopp_idx": dopp_idx,
            "quality_db": quality_db, "doppler_hz": doppler_hz,
            "freq_offset_hz": freq_offset_hz, "snr_db": snr_db, "shift": shift,
            "clipped_any": (hit2.any(dim=-1) if clip
                            else torch.zeros(B, dtype=torch.bool, device=dev)),
            "E": E}))
        return row

    return rows_plain if plain else rows_kernels

