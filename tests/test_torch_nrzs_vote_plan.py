"""The host side of K4's NRZ-S form and of K8 on the CPU.

- K4 with the NRZ-S bits in its launch (``csrc/symbol_detect.cu``,
  ``kNrzs``): a numpy model of which CTA computes which slots, the one slot
  more each CTA searches (the slot after its last, or slot 0 for the CTA
  that holds slot S - 1) and the pair each slot looks up, for every
  geometry of ``ops/demod_kernels.k4_plan``, gives the rows of
  ``symbol_detect_plain`` followed by ``nrzs_rows_plain`` (clip -2 slots,
  symbols outside the LUT); ``symbol_detect`` with the symbol LUT on the CPU
  is that plain version, and on bench_BPSK blocks it holds JAX's
  ``extract_bits_nrzs`` bits.
- K8 (``csrc/vote.cu``): a numpy model of its tiles of 32 slots, its warps'
  channels, its chunks of 256 channels and its counts is bit-equal to
  ``vote_rows_plain`` and to JAX's ``vote_n_device``, pinned ties included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as g
from pycusdr_tpu.dsp.block import build_process_block as jax_build_process_block
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.ops.demod_kernels import extract_bits_nrzs
from pycusdr_tpu.parallel.vote import vote_n_device
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch.convert import spec_from_numpy
from pycusdr_tpu_torch.dsp import block as port_block
from pycusdr_tpu_torch.dsp.block import build_process_batch
from pycusdr_tpu_torch.dsp.signal_gen import modulate_bpsk
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops.layout import PACK_ARRAYS, PACK_SCALARS, SCALAR
from pycusdr_tpu_torch.parallel.vote import vote_rows, vote_rows_plain
from pycusdr_tpu_torch.protocol.benchmark.bench_bpsk import _reference_lut

torch.set_num_threads(2)

# ---------------------------------------------------------------- K4, NRZ-S form

#: the launch geometries of ``k4_plan`` (threads a CTA, slots a thread); the
#: sample-by-sample form takes one slot a thread at the plan's threads
K4_GEOMETRIES = [(64, 1), (128, 1), (128, 2)]
NRZS_S = [1, 2, 63, 64, 65, 4607, 4608, 36480]
TRUST_NORMAL = 4


def _k4_case(S, B, lut, seed):
    """Seeded K4 inputs for S slots: N about 2 S samples (a slot every ~2),
    colargmax in [-1, M + 1] (symbols outside the LUT's rows), and a sparse
    clip bitmask. Returns (args, kwargs) of ``symbol_detect``."""
    rng = np.random.RandomState(seed)
    N = max(64, 1 << int(np.ceil(np.log2(2 * S))))
    M = lut.shape[0]
    colmax = torch.from_numpy(rng.rand(B, N).astype(np.float32))
    colarg = torch.from_numpy(rng.randint(-1, M + 2, (B, N)).astype(np.int32))
    spSym = torch.from_numpy((N / S * (1 + 0.01 * rng.randn(B))).astype(np.float32))
    codeOffset = torch.from_numpy(rng.uniform(-3, 3, B).astype(np.float32))
    hits = dk.pack_bits(torch.from_numpy(rng.rand(B, N) < 0.002))
    kw = dict(Nfft=N, windowWidth=3, spsymMin=1, numSymMax=S, trust_normal=TRUST_NORMAL,
              hits=hits)
    return (colmax, colarg, spSym, codeOffset), kw


def _k4_row(args, kw, B, S):
    """K4's row form on the CPU (no centre-bit LUT: bits 0) and its typed
    outputs (symbols, trust, nSym)."""
    row = torch.zeros((B, len(PACK_ARRAYS) * S + len(PACK_SCALARS) + 3))
    code_val = torch.ones(B)
    dk.symbol_detect(*args, None, **kw, row=row, code_val=code_val)
    typed = dk.symbol_detect(*args, None, **kw)
    return row, code_val, typed[0].numpy(), typed[4].numpy(), typed[5].numpy()


def fused_rows_model(k4_row, symbols, trust, nsym, lut, S, T, SPT):
    """The rows K4's NRZ-S form writes, CTA by CTA: CTA i owns the slots
    x0 + s T + t (x0 = i T SPT, s < SPT, t < T), searches those (a slot past
    S at S - 1) and the slot xe after its last (slot 0 for the CTA that
    holds slot S - 1), keeps the T SPT + 1 symbols in shared memory, and
    looks each owned slot's (symbol[x], symbol at x + 1 - x0, or at T SPT
    when x + 1 == S) pair up in the LUT."""
    B, per = symbols.shape[0], T * SPT
    n_cta = -(-S // per)
    x0 = np.arange(n_cta) * per
    own = (x0[:, None, None] + np.arange(SPT)[None, :, None] * T
           + np.arange(T)[None, None, :]).reshape(n_cta, per)  # local index s T + t
    live = own < S
    assert np.array_equal(np.sort(own[live]), np.arange(S)), "a slot owned twice or never"
    xe = np.where(x0 + per < S, x0 + per, 0)
    assert ((xe == 0) == (x0 + per >= S)).all() and (xe[:-1] == x0[1:]).all()
    ssym = np.concatenate([symbols[:, np.minimum(own, S - 1)], symbols[:, xe][:, :, None]], 2)
    nloc = np.where(own + 1 < S, own + 1 - x0[:, None], per)
    assert (nloc[live] <= per).all()
    nxt = np.take_along_axis(ssym, np.broadcast_to(nloc, (B,) + nloc.shape), axis=2)
    prev = ssym[:, :, :per]
    M = lut.shape[0]
    inside = (prev >= 0) & (prev < M)
    tab = lut[np.clip(prev, 0, M - 1)]  # (B, n_cta, per, 2, K)
    one = np.where(inside, (tab[..., 0, :] == nxt[..., None]).any(-1), nxt == 0)
    zero = np.where(inside, (tab[..., 1, :] == nxt[..., None]).any(-1), nxt == 0)
    err = ~(one | zero)
    x = own[live]
    row = k4_row.clone().numpy()
    row[:, x] = (~err & one)[:, live]
    tr = trust[:, x]
    row[:, S + x] = np.where(err[:, live] & (tr != dk.TRUST_CLIPPED), dk.TRUST_SYMBOL_ERROR, tr)
    tail = len(PACK_ARRAYS) * S
    row[:, tail + SCALAR["nBits"]] = nsym.astype(np.float32) - np.float32(1)
    return torch.from_numpy(row)


@pytest.mark.parametrize("B", [1, 16, 64])
@pytest.mark.parametrize("S", NRZS_S)
def test_nrzs_form_slot_ownership_model(S, B):
    """Every geometry of the fused form gives the rows of K4 followed by
    K4n (``nrzs_rows_plain``), which is what ``symbol_detect`` with the
    symbol LUT gives on the CPU; the case holds clip -2 slots, transition
    errors and symbols outside the LUT's rows."""
    lut = _reference_lut(4).astype(np.int32)
    args, kw = _k4_case(S, B, lut, seed=S + B)
    k4_row, code_val, symbols, trust, nsym = _k4_row(args, kw, B, S)
    want = dk.nrzs_rows_plain(k4_row.clone(), torch.from_numpy(lut), S)
    got = dk.symbol_detect(*args, None, **kw, row=torch.zeros_like(k4_row), code_val=code_val,
                           symbolLUT=torch.from_numpy(lut))
    assert torch.equal(got, want)
    assert dk.k4_plan(B, S)[:2] in K4_GEOMETRIES
    for T, SPT in K4_GEOMETRIES:
        model = fused_rows_model(k4_row, symbols, trust, nsym, lut, S, T, SPT)
        assert torch.equal(model, want), f"geometry {T} x {SPT}"
    if S >= 4607:
        out = (symbols < 0) | (symbols >= lut.shape[0])
        assert out.any() and (trust == dk.TRUST_CLIPPED).any()
        assert (want[:, S:2 * S] == dk.TRUST_SYMBOL_ERROR).any()
        assert (want[:, S:2 * S] == dk.TRUST_CLIPPED).any()


def test_nrzs_form_refuses_what_it_cannot_write():
    """The NRZ-S form writes the packed row and takes no centre-bit LUT."""
    lut = torch.from_numpy(_reference_lut(4).astype(np.int32))
    args, kw = _k4_case(64, 2, lut.numpy(), seed=1)
    with pytest.raises(ValueError):
        dk.symbol_detect(*args, None, **kw, symbolLUT=lut)
    row = torch.zeros((2, 5 * 64 + 20))
    with pytest.raises(ValueError):
        dk.symbol_detect(*args, torch.zeros(8, dtype=torch.int8), **kw, row=row,
                         code_val=torch.ones(2), symbolLUT=lut)
    with pytest.raises(ValueError):
        dk.symbol_detect(*args, None, **kw, row=row, code_val=torch.ones(2),
                         symbolLUT=lut.reshape(8, 4))


def _bpsk_specs():
    conf = g._conf(blockSize=9, overlap=7, spsym=8, doppSteps=16, windowWidth=5, maskSize=4)
    conf["Main"]["protocols"] = {"UHF": "bench_BPSK"}
    jspec = jax_build_spec(conf, jax_loadProtocol("bench_BPSK")(conf=conf), "UHF-H")
    jspec = dataclasses.replace(jspec, doppler_search=False, disable_peak_thresholding=False,
                                peak_threshold_scale=4.5)
    spec = spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})
    return jspec, spec


def test_nrzs_form_on_bench_bpsk_blocks_matches_jax(monkeypatch):
    """The block graph's NRZ-S step is one ``symbol_detect_nrzs`` call (no
    ``nrzs_bits``); on bench_BPSK blocks with a clip burst its rows hold
    JAX's ``extract_bits_nrzs`` bits over the symbols, trust -1 on its
    errors where the clip window left no -2, nBits = nSym - 1, and JAX's
    block outputs."""
    jspec, spec = _bpsk_specs()
    assert not hasattr(port_block, "nrzs_bits")
    calls = []
    fused = port_block.symbol_detect_nrzs
    monkeypatch.setattr(port_block, "symbol_detect_nrzs",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    rng = np.random.RandomState(31)
    N, sps = spec.Nfft, int(spec.spsym)
    f = spec.centreFreqOffset / spec.sampleRate
    x = np.stack([modulate_bpsk(rng.randint(0, 2, N // sps), sps)[:N] for _ in range(3)])
    x = x * np.exp(2j * np.pi * f * np.arange(N)) + 0.05 * (rng.randn(3, N) + 1j * rng.randn(3, N))
    x[:, 200:206] += 60.0
    x = x.astype(np.complex64)
    rows = build_process_batch(spec, device="cpu", packed=True)(x)
    assert len(calls) == 1
    S = spec.numSymMax
    lut = np.asarray(jspec.symbolLUT).astype(np.int32)
    jax_block = jax_build_process_block(jspec)
    tail = len(PACK_ARRAYS) * S
    for b in range(3):
        sym = rows[b, 2 * S:3 * S].numpy().astype(np.int32)
        jb, je = extract_bits_nrzs(sym, lut)
        np.testing.assert_array_equal(rows[b, :S].numpy(), np.asarray(jb))
        trust = rows[b, S:2 * S].numpy()
        np.testing.assert_array_equal(trust == -1, np.asarray(je) & (trust != -2))
        assert rows[b, tail + SCALAR["nBits"]] == rows[b, tail + SCALAR["nSym"]] - 1
        jx = {k: np.asarray(v) for k, v in jax_block(c2ri(x[b])).items()}
        for k, at in (("bits", 0), ("trust", 1), ("symbols", 2)):
            np.testing.assert_array_equal(rows[b, at * S:(at + 1) * S].numpy(), jx[k], err_msg=k)
        assert (jx["trust"] == -2).any() and (jx["trust"] == -1).any()


# ---------------------------------------------------------------- K8

K8_TILE, K8_MAX_WARPS, K8_CHUNK = 32, 8, 256
VOTE_C = [1, 2, 3, 4, 16, 64, 65, 256]
VOTE_S = [1, 31, 4608]


def vote_model(rows, S, master_weight, master, mask_pad):
    """K8's launch on (C, L) f32 rows, in numpy f32: tiles of 32 slots (dead
    lanes past S vote nothing), NW = min(C, 8) warps, warp w taking the
    channels w, w + NW, ... of each chunk of at most 256; each channel's
    term w (2 bit - 1) (+0 for an invalid voter) added in channel order by
    the tile's first warp, the score carried across chunks; each warp's
    counts of voters with bit 1, with bit 0 and valid ones added at the
    end. Returns (rows with the pad masked, the (2, S) pair)."""
    f32 = np.float32
    rows = rows.copy()
    C = rows.shape[0]
    NW = min(C, K8_MAX_WARPS)
    tiles = -(-S // K8_TILE)
    s = np.arange(tiles * K8_TILE).reshape(tiles, K8_TILE)
    live = s < S
    sl = np.minimum(s, S - 1)
    score = np.zeros(s.shape, f32)
    counts = np.zeros((3, NW) + s.shape, np.int64)
    for c0 in range(0, C, K8_CHUNK):
        cn = min(K8_CHUNK, C - c0)
        term = np.zeros((cn,) + s.shape, f32)
        for w in range(NW):
            for cc in range(w, cn, NW):
                c = c0 + cc
                bit = np.where(live, rows[c, sl], f32(0))
                t = np.where(live, rows[c, S + sl], f32(-1))
                if mask_pad:
                    pad = live & (s.astype(f32) >= rows[c, len(PACK_ARRAYS) * S + SCALAR["nBits"]])
                    write = pad & (t != -1)
                    rows[c, S + s[write]] = -1
                    t = np.where(pad, f32(-1), t)
                valid = t >= 0
                wc = t * f32(master_weight) if c == master else t
                term[cc] = np.where(valid, wc * (bit * f32(2) - f32(1)), f32(0))
                counts[:, w] += np.stack([valid & (bit == 1), valid & (bit == 0), valid])
        for cc in range(cn):
            score = score + term[cc]
    ones, zeros, quorum = counts.sum(axis=1)
    one = score > 0
    agree = np.where(one, ones, zeros)
    trust = np.where(quorum > 0, agree.astype(f32) + quorum.astype(f32) / f32(10), f32(-1))
    pair = np.stack([one.astype(f32)[live], trust[live]])
    return rows, pair


def _vote_rows(C, S, seed):
    """(C, L) rows: random bits, trust in {-2, -1, 0, 1, 2, 3, 5, 127} and
    nBits in [S - 300, S] (the last channel S // 2); pinned ties at s % 10
    == 0 (channel 0 bit 1 at trust 5, weight 5 * 1.2f = 6.0, against trust
    2 + 2 + 2 at bit 0, or one 6 when C < 4; the rest trust -1); every voter
    disqualified at s % 10 == 5."""
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (C, S))
    trust = rng.choice([-2, -1, 0, 1, 2, 3, 5, 127], (C, S))
    tie, gone = slice(0, S, 10), slice(5, S, 10)
    bits[0, tie], trust[0, tie] = 1, 5
    k = min(4, C) if C >= 4 else min(2, C)
    bits[1:k, tie], trust[1:k, tie] = 0, (2 if C >= 4 else 6)
    trust[k:, tie] = -1
    trust[:, gone] = -1
    nbits = rng.randint(max(S - 300, 0), S + 1, C)
    nbits[-1] = S // 2
    L = len(PACK_ARRAYS) * S + len(PACK_SCALARS) + 5
    rows = np.zeros((C, L), np.float32)
    rows[:, :S], rows[:, S:2 * S] = bits, trust
    tail = len(PACK_ARRAYS) * S
    rows[:, tail + SCALAR["nSym"]] = rows[:, tail + SCALAR["nBits"]] = nbits
    return rows


@pytest.mark.parametrize("mask_pad", [True, False])
@pytest.mark.parametrize("master", [0, "mid", -1])
@pytest.mark.parametrize("S", VOTE_S)
@pytest.mark.parametrize("C", VOTE_C)
def test_vote_tiles_and_chunks_model(C, S, master, mask_pad):
    """K8's model: masked rows and voted pair bit-equal to
    ``vote_rows_plain`` (and to ``vote_rows`` on CPU rows), the pair equal
    to JAX's ``vote_n_device`` on the masked trust; the master's row swapped
    with row 0 keeps the pinned ties at the master, which vote 0."""
    m = {"mid": C // 2, 0: 0, -1: -1}[master]
    rows = _vote_rows(C, S, seed=C * 7 + S)
    mi = m % C
    rows[[0, mi]] = rows[[mi, 0]]
    got_rows, got = vote_model(rows, S, 1.2, mi, mask_pad)
    tp = torch.from_numpy(rows.copy())
    want = vote_rows_plain(tp, S, 1.2, torch.empty((2, S)), m, mask_pad)
    np.testing.assert_array_equal(got_rows, tp.numpy())
    np.testing.assert_array_equal(got, want.numpy())
    tw = torch.from_numpy(rows.copy())
    assert torch.equal(vote_rows(tw, S, 1.2, master_idx=m, mask_pad=mask_pad), want)
    assert torch.equal(tw, tp)
    jv, jt = vote_n_device(got_rows[:, :S].astype(np.int8), got_rows[:, S:2 * S].astype(np.int8),
                           master_idx=m, master_weight=1.2)
    np.testing.assert_array_equal(got[0], np.asarray(jv).astype(np.float32))
    np.testing.assert_array_equal(got[1], np.asarray(jt))
    if mi == 0 and C >= 2:  # the pinned ties at the master vote 0
        n_tie = int(got_rows[:min(4, C), len(PACK_ARRAYS) * S + SCALAR["nBits"]].min())
        assert not got[0, 0:n_tie:10].any() if mask_pad else not got[0, 0:S:10].any()
    assert (got[1, 5:S:10] == -1).all()
    if not mask_pad:
        np.testing.assert_array_equal(got_rows, rows)
