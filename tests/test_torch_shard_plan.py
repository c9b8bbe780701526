"""The generic step's split detector after its redesign, on the CPU.

- K4s's NRZ-S form (``shard_select_nrzs``: K4n's epilogue in K4s's launch)
  on bench_BPSK blocks, the mask bank split 1, 2 and 4 ways, with and
  without the clip window, against the JAX package: ``_local_find_centres``
  on every shard, the cross-shard select of ``sharded_demod.py:361-376``,
  then ``extract_bits_nrzs`` and the trust of ``:378-411``. Exact.
- ``k4s_plan`` (and ``k4_plan``, which K4l takes) at the edges of
  ``K4_LATENCY_SLOTS`` and ``K4_TWO_SLOTS``.
- A torch model of the neighbour rule of K4s's NRZ-S form: which thread
  selects which slot, and each thread's own select of the next slot's
  pairs; equal to the owner's select of slot x + 1 mod S across warp and
  CTA edges and at the wrap of S - 1 onto 0 when S is not a multiple of a
  CTA's span. Exact.
- K4l's packed pairs: ``symbol_detect_local(packed=True)`` and its views
  equal ``symbol_detect_local_plain``'s (val, key). Exact.
- The standalone K4n is gone: ``ops.demod_kernels`` has no ``nrzs_bits``
  or ``k4n_form``, and the generic step on bench_BPSK makes one K4l and one
  ``shard_select_nrzs`` call a step and no other K4s call.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.ops.demod_kernels import dilate_mask_dynamic, extract_bits_nrzs
from pycusdr_tpu.parallel.sharded_demod import _local_find_centres
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch.convert import DeviceConsts, spec_from_numpy
from pycusdr_tpu_torch.dsp.block import build_process_batch
from pycusdr_tpu_torch.dsp.signal_gen import modulate_bpsk
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops.layout import PACK_ARRAYS, SCALAR
from pycusdr_tpu_torch.parallel import build_sharded_demod_step, make_mesh

torch.set_num_threads(2)


def _bpsk_specs(clip):
    """bench_BPSK at the tiny shape (Nfft 2^9, 16 masks of 4 bits, the (8,
    2, 2) LUT), in both packages; ``clip``: STX mode, spike clipping at 4.5."""
    conf = g._conf(blockSize=9, overlap=7, spsym=8, doppSteps=16, windowWidth=5, maskSize=4)
    conf["Main"]["protocols"] = {"UHF": "bench_BPSK"}
    jspec = jax_build_spec(conf, jax_loadProtocol("bench_BPSK")(conf=conf), "UHF-H")
    if clip:
        jspec = dataclasses.replace(jspec, doppler_search=False, disable_peak_thresholding=False,
                                    peak_threshold_scale=4.5)
    return jspec, spec_from_numpy({f.name: getattr(jspec, f.name)
                                   for f in dataclasses.fields(jspec)})


def _bpsk_blocks(spec, clip, B=3, seed=21):
    """B blocks of seeded BPSK at the IF offset, each its own bits and
    noise; with ``clip`` a burst in each."""
    rng = np.random.RandomState(seed)
    N, sps = spec.Nfft, int(spec.spsym)
    f = spec.centreFreqOffset / spec.sampleRate
    x = np.stack([modulate_bpsk(rng.randint(0, 2, N // sps), sps)[:N] for _ in range(B)])
    x = x * np.exp(2j * np.pi * f * np.arange(N)) + 0.05 * (rng.randn(B, N) + 1j * rng.randn(B, N))
    if clip:
        for b in range(B):
            x[b, 90 + 60 * b:96 + 60 * b] += 60.0
    return x.astype(np.complex64)


def _detector_inputs(spec, consts, x):
    """The matched-filter power (B, M, N) of the plain graph's shift, its
    timing, and (clip) K6's pass-2 hits, all by the port's plain versions."""
    ref = build_process_batch(spec, device="cpu", plain=True)(x)
    xs, hit = torch.from_numpy(x), None
    if not spec.disable_peak_thresholding:
        xs, hit = dk.threshold_input_plain(xs, consts.threshold_scale)
    S = torch.fft.fft(xs)
    P2 = dk.mf_bank_power_plain(S, consts.masks_f, ref["shift"].to(torch.int32))
    M, off = spec.num_masks, spec.code_search_mask_offset
    sp, co, cv = dk.timing_band_plain(P2[:, off:M - off].sum(dim=1), spec.code_idx_lo,
                                      spec.code_idx_hi)
    return P2, sp, co, cv, hit


def _jax_select_nrzs(vals, gidx, sp, co, lut, spec, trust_normal, clip=None):
    """One block of JAX's generic step after the all-gather
    (``sharded_demod.py:364-411`` with ``extract_bits_nrzs``), in jnp:
    (bits, trust, symbols, centres, mags, nSym, nBits)."""
    N, W, S, M = spec.Nfft, spec.windowWidth, spec.numSymMax, spec.num_masks
    spc = jnp.maximum(jnp.float32(sp), float(spec.spsymMin))
    x = jnp.arange(S, dtype=jnp.float32)
    A0 = jnp.trunc(x * spc - W // 2 + jnp.float32(co)).astype(jnp.int32)
    comp = jnp.trunc(jnp.float32(co)).astype(jnp.int32) - jnp.minimum(A0, 0)
    best = jnp.max(vals, axis=0)
    g_ = jnp.min(jnp.where(vals == best, gidx, jnp.int32(M * W + M + 1)), axis=0)
    symbols, maxK = (g_ % M).astype(jnp.int32), (g_ // M).astype(jnp.int32)
    centres = jnp.trunc(x * spc - W // 2 + maxK.astype(jnp.float32)).astype(jnp.int32) + comp
    nSym = (N / spc).astype(jnp.int32)
    trust = jnp.where(jnp.arange(S) < nSym, jnp.int8(trust_normal), jnp.int8(-1))
    bits, err = extract_bits_nrzs(symbols, lut)
    trust = jnp.where(err, jnp.int8(-1), trust)
    if clip is not None:
        at = jnp.take(clip, jnp.clip(jnp.clip(A0, 0, max(N - W, 0)) + maxK, 0, N - 1))
        trust = jnp.where(at, jnp.int8(-2), trust)
    return tuple(np.asarray(v) for v in (bits, trust, symbols, centres, best, nSym, nSym - 1))


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("nd", [1, 2, 4])
def test_shard_select_nrzs_matches_jax(nd, clip):
    """K4s's NRZ-S form on the pairs that K4l's plain version finds on each
    of nd shards of the bank, against JAX's shard-local detector, select,
    NRZ-S bits and trust on the same matched-filter power: the row's five
    arrays, nSym and nBits exact; with the clip window some slot -2 and
    some -1 (a transition error), and -2 wins where both apply."""
    jspec, spec = _bpsk_specs(clip)
    consts = DeviceConsts.from_spec(spec, "cpu")
    x = _bpsk_blocks(spec, clip)
    P2, sp, co, cv, hit = _detector_inputs(spec, consts, x)
    B, M, N = P2.shape
    Ml, S = M // nd, spec.numSymMax
    det = dict(Nfft=N, windowWidth=spec.windowWidth, spsymMin=spec.spsymMin, numSymMax=S)
    pairs = torch.stack([dk.symbol_detect_local(
        P2[:, d * Ml:(d + 1) * Ml].amax(dim=1),
        torch.argmax(P2[:, d * Ml:(d + 1) * Ml], dim=1).to(torch.int32), sp, co, m0=d * Ml, M=M,
        packed=True, **det) for d in range(nd)])
    row = torch.zeros((B, len(PACK_ARRAYS) * S + 12))
    hits = None if hit is None else dk.pack_bits(hit)
    dk.shard_select_nrzs(pairs, sp, co, consts.symbolLUT, M=M, trust_normal=consts.trust_normal,
                         row=row, code_val=cv, hits=hits, **det)
    lut = jnp.asarray(np.asarray(jspec.symbolLUT).astype(np.int32))
    tail = len(PACK_ARRAYS) * S
    for b in range(B):
        vals, gidx = [], []
        for d in range(nd):
            val, k_win, m_sel, *_ = _local_find_centres(
                jnp.asarray(P2[b, d * Ml:(d + 1) * Ml].numpy()), jnp.float32(sp[b]),
                jnp.float32(co[b]), **det)
            vals.append(val)
            gidx.append(k_win * M + d * Ml + m_sel)
        cm = None
        if clip:
            spc = jnp.maximum(jnp.float32(sp[b]), float(spec.spsymMin))
            cm = dilate_mask_dynamic(jnp.asarray(hit[b].numpy()),
                                     2 * jnp.ceil(spc).astype(jnp.int32))
        want = _jax_select_nrzs(jnp.stack(vals), jnp.stack(gidx), sp[b], co[b], lut, spec,
                                consts.trust_normal, cm)
        r = row[b].numpy()
        for i, name in enumerate(PACK_ARRAYS):
            j = ("bits", "trust", "symbols", "centres", "mags").index(name)
            np.testing.assert_array_equal(r[i * S:(i + 1) * S], want[j].astype(np.float32),
                                          err_msg=f"{name} block {b}")
        assert r[tail + SCALAR["nSym"]] == want[5] and r[tail + SCALAR["nBits"]] == want[6]
        assert (want[1] == -1).any()
        if clip:
            assert (want[1] == -2).any()
    if nd == 4:  # BPSK symbols lie in [0, 8): shards 0 and 1 must both win slots
        assert bool((row[:, 2 * S:3 * S] >= Ml).any()) and bool((row[:, 2 * S:3 * S] < Ml).any())


@pytest.mark.parametrize("nd", [1, 2, 4])
@pytest.mark.parametrize("B,S,want", [
    (1, 16384, (64, 1)), (1, 16385, (128, 1)), (4, 4096, (64, 1)), (4, 4097, (128, 1)),
    (1, 2 ** 18 - 1, (128, 1)), (1, 2 ** 18, (128, 2)), (64, 4096, (128, 2)),
    (16, 4608, (128, 1)), (64, 4608, (128, 2)), (1, 4608, (64, 1))])
def test_k4s_plan_edges(B, S, want, nd):
    """K4s's plan at the edges of K4_LATENCY_SLOTS (16384 slots a launch)
    and K4_TWO_SLOTS (2^18), and at the flagship's S at B=1/16/64, for nd
    = 1, 2, 4 (two slots a thread only up to nd = 2); K4l takes
    ``k4_plan``, which has the same edges."""
    assert dk.k4s_plan(B, S, nd) == (want if nd <= 2 else (want[0], 1))
    assert dk.k4_plan(B, S)[:2] == want
    assert dk.k4_plan(B, S)[2] == (want[0] == 64)


def _select(pairs):
    """The owner's select of every slot: pairs (nd, S, 2) -> keys (S,): the
    largest value, among equal values the smallest key."""
    v, g_ = dk.pair_views(pairs)
    best = v.amax(dim=0)
    return torch.where(v == best, g_, torch.iinfo(torch.int32).max).amin(dim=0)


def _next_keys_model(pairs, T, spt):
    """The key of slot x + 1 mod S that K4s's NRZ-S form gives slot x, as its
    threads find it: the CTA of T threads takes T * spt slots, thread t slot
    x0 + s T + t (a thread past S reads slot S - 1), and each thread
    selects slot x + 1 mod S from its own loads of that slot's pairs."""
    S = pairs.shape[1]
    out = torch.full((S,), -1, dtype=torch.int32)
    tid = torch.arange(T)
    for x0 in range(0, S, T * spt):
        for s in range(spt):
            xo = x0 + s * T + tid
            x = torch.clamp(xo, max=S - 1)
            xn = torch.where(x + 1 < S, x + 1, 0)
            nxt = _select(pairs[:, xn])
            keep = xo < S
            out[xo[keep]] = nxt[keep]
    return out


@pytest.mark.parametrize("T,spt", [(64, 1), (128, 1), (128, 2)])
@pytest.mark.parametrize("S", [1, 2, 31, 32, 33, 63, 64, 65, 127, 129, 255, 256, 257, 4607, 4608])
def test_nrzs_neighbour_rule(S, T, spt):
    """Every slot's next key, as the model of K4s's threads finds it, equals
    the owner's select of slot x + 1 mod S: across warp and CTA edges and at
    the wrap of S - 1 onto 0 (S not a multiple of the CTA's span included),
    with ties in value between the shards (the smaller key wins)."""
    rng = np.random.RandomState(S + T + spt)
    nd = 3
    vals = torch.from_numpy(rng.randint(0, 3, (nd, S)).astype(np.float32))
    keys = torch.from_numpy(rng.randint(0, 200, (nd, S)).astype(np.int32))
    pairs = dk.pack_pairs(vals, keys)
    owner = _select(pairs)
    assert torch.equal(_next_keys_model(pairs, T, spt), torch.roll(owner, -1))


@pytest.mark.parametrize("B,S", [(1, 40), (3, 40), (2, 1)])
def test_packed_pair_views_equal_plain(B, S):
    """K4l's (B, S, 2) int32 buffer (``packed=True``) holds each slot's
    value bits and key; its views (the default return) equal
    ``symbol_detect_local_plain``'s (val, key), and ``pack_pairs`` of those
    is the buffer."""
    rng = np.random.RandomState(B * 10 + S)
    N, M = 512, 8
    colmax = torch.from_numpy(rng.randint(0, 5, (B, N)).astype(np.float32))
    colarg = torch.from_numpy(rng.randint(0, 4, (B, N)).astype(np.int32))
    sp = torch.from_numpy((8 + rng.rand(B)).astype(np.float32))
    co = torch.from_numpy((8 * rng.rand(B)).astype(np.float32))
    kw = dict(m0=4, M=M, Nfft=N, windowWidth=5, spsymMin=8, numSymMax=S)
    val, key = dk.symbol_detect_local_plain(colmax, colarg, sp, co, **kw)
    pair = dk.symbol_detect_local(colmax, colarg, sp, co, packed=True, **kw)
    assert pair.dtype == torch.int32 and pair.shape == (B, S, 2) and pair.is_contiguous()
    assert torch.equal(pair, dk.pack_pairs(val, key))
    assert torch.equal(pair[..., 0], val.view(torch.int32))
    v, k = dk.symbol_detect_local(colmax, colarg, sp, co, **kw)
    assert v.dtype == torch.float32 and torch.equal(v, val) and torch.equal(k, key)
    pv, pk = dk.pair_views(pair)
    assert torch.equal(pv, val) and torch.equal(pk, key)


def test_no_standalone_k4n(monkeypatch):
    """The standalone K4n, its plan and its LUT limit are gone; the generic
    step on bench_BPSK calls K4l once and K4s's NRZ-S form once a step, and
    no other K4s form; its rows equal the plain step's."""
    for name in ("nrzs_bits", "k4n_form", "K4N_SMEM_MAX"):
        assert not hasattr(dk, name), name
    from pycusdr_tpu_torch import ops
    assert "nrzs_bits" not in ops.kernel_wrappers()
    assert ops.kernel_wrappers()["shard_select_nrzs"] is dk.shard_select_nrzs
    calls = {"symbol_detect_local": 0, "shard_select": 0, "shard_select_nrzs": 0}
    for name in calls:
        fn = getattr(dk, name)
        monkeypatch.setattr(dk, name, lambda *a, _n=name, _f=fn, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a, **k))[1])
    _, spec = _bpsk_specs(False)
    x = _bpsk_blocks(spec, False, B=2)
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=["cpu"])
    res = build_sharded_demod_step(spec, mesh, force_generic=True)(x)
    # shard_select counts the call that shard_select_nrzs makes inside
    assert calls == {"symbol_detect_local": 1, "shard_select": 1, "shard_select_nrzs": 1}, calls
    plain = build_sharded_demod_step(spec, mesh, force_generic=True, plain=True)(x)
    for k in ("bits", "trust", "symbols", "centres", "nBits", "bits_voted", "trust_voted"):
        assert torch.equal(res[k], plain[k]), k
