"""The port's generic channel x dopp step in one process on the CPU, and
its split detector, against the JAX package on its 8-device CPU mesh
(as ``tests/test_parallel.py`` runs it).

- K4l's plain version against ``_local_find_centres`` on every shard of
  a mask bank split 1, 2 and 4 ways; K4s's plain version on the gathered
  pairs against JAX's single-chip ``find_centres`` and against the
  cross-shard reduce of ``sharded_demod.py:361-411`` (clip window
  included); K8 with its pad mask off against ``vote_n_device``.
- ``force_generic`` on a one-device mesh against JAX's ``force_generic``
  step at ``{"channel": 4, "dopp": 1}`` for bench_GFSK, bench_BPSK and a
  clipping STX spec, with and without the vote; against the port's own
  channel-parallel step (bits, symbols and centres exact, as
  ``test_sharded_force_generic_matches_fast_path``); with
  ``code_search_mask_offset = 1`` against JAX's P2 fallback on
  ``{"channel": 2, "dopp": 2}``.

Tolerances are the golden table's (``tests/test_dsp_golden.py:89-132``):
bits and trust equal, symbols >= 99.9% equal, centres within W, spSym
within 1e-3, Doppler within 1 Hz, SNR within 0.5 dB.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.ops.demod_kernels import dilate_mask_dynamic, find_centres
from pycusdr_tpu.parallel import build_sharded_demod_step as jax_step
from pycusdr_tpu.parallel import make_mesh as jax_make_mesh
from pycusdr_tpu.parallel.sharded_demod import _local_find_centres
from pycusdr_tpu.parallel.vote import vote_n_device
from pycusdr_tpu_torch.convert import DeviceConsts, spec_from_numpy
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops.layout import PACK_ARRAYS, SCALAR
from pycusdr_tpu_torch.parallel import build_sharded_demod_step, make_mesh
from pycusdr_tpu_torch.parallel.vote import vote_rows, vote_rows_plain

from test_torch_parallel import _blocks, _specs

torch.set_num_threads(2)

#: the golden table's bounds on the step's float outputs
FLOAT_TOL = (("spSym", 1e-3), ("doppler_hz", 1.0), ("freq_offset_hz", 1.0), ("snr_db", 0.5))
N, M, W, S, B = 512, 8, 5, 40, 3
DET = dict(Nfft=N, windowWidth=W, spsymMin=8, numSymMax=S)


def _cpu(**axes):
    return make_mesh(axes, devices=["cpu"])


def _stx_specs():
    """The tiny spec with spike clipping at 4.5 and the fixed IF shift (STX
    mode), in both packages."""
    jspec, _ = _specs("bench_GFSK")
    jspec = dataclasses.replace(jspec, doppler_search=False, disable_peak_thresholding=False,
                                peak_threshold_scale=4.5)
    return jspec, spec_from_numpy({f.name: getattr(jspec, f.name)
                                   for f in dataclasses.fields(jspec)})


def _case(kind):
    if kind == "stx":
        jspec, spec = _stx_specs()
        blocks = _blocks(spec, "bench_GFSK")
        blocks[:, 100:104] += 60.0  # a spike in every channel
        blocks[1, 400:403] += 80.0
        return jspec, spec, blocks
    jspec, spec = _specs(kind)
    return jspec, spec, _blocks(spec, kind)


def _assert_golden(res, ref, W, keys_exact=("bits", "trust", "nSym", "nBits", "shift")):
    for k in keys_exact:
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)
    assert np.mean(res["symbols"] == ref["symbols"]) >= 0.999
    assert np.abs(res["centres"] - ref["centres"]).max() <= W
    for k, tol in FLOAT_TOL:
        d = np.abs(res[k] - ref[k])
        assert np.all((d <= tol) | (res[k] == ref[k])), k  # equal covers -inf SNR


def _detector_inputs(seed):
    """A (B, M, N) matched-filter power with many exact ties (quantised),
    and timing from plausible spSym / codeOffset."""
    rng = np.random.RandomState(seed)
    P2 = rng.randint(0, 5, (B, M, N)).astype(np.float32)
    sp = (8.0 + rng.rand(B) * 0.5).astype(np.float32)
    co = (rng.rand(B) * 8.0).astype(np.float32)
    return P2, sp, co


def _local(P2, sp, co, nd):
    """K4l's plain version on every shard: (vals, keys), each (nd, B, S)."""
    Ml = M // nd
    vals, keys = [], []
    for d in range(nd):
        p = torch.from_numpy(P2[:, d * Ml:(d + 1) * Ml])
        v, k = dk.symbol_detect_local(p.amax(dim=1), torch.argmax(p, dim=1).to(torch.int32),
                                      torch.from_numpy(sp), torch.from_numpy(co), m0=d * Ml, M=M,
                                      **DET)
        vals.append(v)
        keys.append(k)
    return torch.stack(vals), torch.stack(keys)


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_local_detector_matches_jax(nd):
    """K4l on each shard: the window maximum and the (offset, global mask)
    key equal ``_local_find_centres``'s (val, k_win * M + m0 + m_sel)."""
    P2, sp, co = _detector_inputs(nd)
    vals, keys = _local(P2, sp, co, nd)
    Ml = M // nd
    for d in range(nd):
        for b in range(B):
            val, k_win, m_sel, *_ = _local_find_centres(
                jnp.asarray(P2[b, d * Ml:(d + 1) * Ml]), jnp.float32(sp[b]), jnp.float32(co[b]),
                **DET)
            np.testing.assert_array_equal(vals[d, b].numpy(), np.asarray(val))
            np.testing.assert_array_equal(
                keys[d, b].numpy(), np.asarray(k_win) * M + d * Ml + np.asarray(m_sel))


def _jax_reduce(vals, keys, sp, co, bitLUT, clip=None):
    """The cross-shard reduce and tail of ``sharded_demod.py:364-411``, on
    one block (numpy copies of its jnp lines)."""
    spc = np.maximum(np.float32(sp), np.float32(8))
    best = vals.max(axis=0)
    g = np.where(vals == best, keys, M * W + M + 1).min(axis=0)
    sym, maxK = g % M, g // M
    x = np.arange(S, dtype=np.float32)
    xs = (x * spc).astype(np.float32) - np.float32(W // 2)
    A0 = np.trunc(xs + np.float32(co)).astype(np.int32)
    comp = np.int32(np.trunc(co)) - np.minimum(A0, 0)
    centres = np.trunc(xs + maxK.astype(np.float32)).astype(np.int32) + comp
    nSym = int(np.float32(N) / spc)
    trust = np.where(np.arange(S) < nSym, 2, -1).astype(np.int8)
    if clip is not None:
        at = np.asarray(clip)[np.clip(np.clip(A0, 0, N - W) + maxK, 0, N - 1)]
        trust = np.where(at, -2, trust).astype(np.int8)
    return sym, centres, best, bitLUT[sym], trust, nSym


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("nd", [1, 2, 4])
def test_shard_select_matches_jax(nd, clip):
    """K4s on the gathered pairs: symbols, centres and mags equal JAX's
    single-chip ``find_centres`` on the whole bank (the split loses
    nothing), and the row equals the generic step's reduce; with a clip
    bitmask, trust -2 where JAX's dilated mask is set at the winning
    sample. At nd = 1 it equals K4 but beyond nSym."""
    P2, sp, co = _detector_inputs(10 + nd)
    vals, keys = _local(P2, sp, co, nd)
    lut = (np.arange(M) % 2).astype(np.int8)
    hits = None
    if clip:
        hit = np.zeros((B, N), bool)
        hit[:, [3, 200, 511]] = True
        hits = dk.pack_bits(torch.from_numpy(hit))
    row = torch.zeros((B, len(PACK_ARRAYS) * S + 12))
    code_val = torch.arange(B, dtype=torch.float32)
    dk.shard_select(dk.pack_pairs(vals, keys), torch.from_numpy(sp), torch.from_numpy(co),
                    torch.from_numpy(lut), M=M, trust_normal=2, row=row, code_val=code_val,
                    hits=hits, **DET)
    tail = len(PACK_ARRAYS) * S
    for b in range(B):
        cm = None
        if clip:
            spc = jnp.maximum(jnp.float32(sp[b]), 8.0)
            cm = dilate_mask_dynamic(jnp.asarray(hit[b]), 2 * jnp.ceil(spc).astype(jnp.int32))
        jsym, jcen, jmag, jnsym = find_centres(jnp.asarray(P2[b]), jnp.float32(sp[b]),
                                               jnp.float32(co[b]), **DET)[:4]
        want = _jax_reduce(vals[:, b].numpy(), keys[:, b].numpy(), sp[b], co[b], lut, cm)
        r = row[b].numpy()
        named = dict(zip(("symbols", "centres", "mags", "bits", "trust"), want[:5]))
        for i, name in enumerate(PACK_ARRAYS):
            np.testing.assert_array_equal(r[i * S:(i + 1) * S], named[name].astype(np.float32),
                                          err_msg=name)
        np.testing.assert_array_equal(want[0], np.asarray(jsym))
        np.testing.assert_array_equal(want[1], np.asarray(jcen))
        np.testing.assert_array_equal(want[2], np.asarray(jmag))
        assert r[tail + SCALAR["nSym"]] == r[tail + SCALAR["nBits"]] == want[5] == int(jnsym)
        assert r[tail + SCALAR["spSym"]] == sp[b] and r[tail + SCALAR["code_val"]] == b
        if clip:
            assert (want[4] == -2).any()
    if nd == 1:  # K4 on the same columns: equal in all but the trust beyond nSym
        p = torch.from_numpy(P2)
        k4 = dk.symbol_detect(p.amax(dim=1), torch.argmax(p, dim=1).to(torch.int32),
                              torch.from_numpy(sp), torch.from_numpy(co), torch.from_numpy(lut),
                              trust_normal=2, **DET)
        for j, name in enumerate(("symbols", "centres", "mags", "bits")):
            i = PACK_ARRAYS.index(name)
            np.testing.assert_array_equal(row[:, i * S:(i + 1) * S].numpy(),
                                          k4[j].float().numpy(), err_msg=name)


@pytest.mark.parametrize("mask_pad", [True, False])
def test_vote_pad_mask_operand(mask_pad):
    """K8's plain version with the pad mask off votes the trust as the rows
    hold it (JAX's generic vote); with it on, as ``vote_n_device`` on the
    trust masked at nBits. The rows' trust is left as it was without it."""
    C = 4
    rng = np.random.RandomState(5)
    bits = rng.randint(0, 2, (C, S)).astype(np.int8)
    trust = rng.choice(np.array([-2, -1, 0, 1, 2, 3], np.int8), (C, S))
    nbits = np.array([S, S - 1, 30, 12])
    rows = torch.zeros((C, len(PACK_ARRAYS) * S + 12))
    rows[:, :S] = torch.from_numpy(bits).float()
    rows[:, S:2 * S] = torch.from_numpy(trust).float()
    rows[:, len(PACK_ARRAYS) * S + SCALAR["nBits"]] = torch.from_numpy(nbits).float()
    before = rows.clone()
    out = vote_rows(rows, S, 1.2, master_idx=1, mask_pad=mask_pad)
    used = (np.where(np.arange(S)[None] < nbits[:, None], trust, -1).astype(np.int8)
            if mask_pad else trust)
    jv, jt = vote_n_device(bits, used, 1)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jt))
    np.testing.assert_array_equal(rows[:, S:2 * S].numpy(), used.astype(np.float32))
    if not mask_pad:
        assert torch.equal(rows, before)
    again = vote_rows_plain(before.clone(), S, 1.2, torch.empty((2, S)), 1, mask_pad)
    assert torch.equal(again, out)


@pytest.mark.parametrize("vote", [True, False])
@pytest.mark.parametrize("kind", ["bench_GFSK", "bench_BPSK", "stx"])
def test_force_generic_matches_jax(kind, vote):
    """The generic step on a one-device mesh against JAX's generic step on
    its 4-device channel mesh: the golden table, the voted pair equal, and
    the plain path equal to the kernel path."""
    jspec, spec, blocks = _case(kind)
    ref = {k: np.asarray(v) for k, v in
           jax_step(jspec, jax_make_mesh({"channel": 4, "dopp": 1}), vote=vote,
                    force_generic=True)(c2ri(blocks)).items()}
    res = {k: v.numpy() for k, v in build_sharded_demod_step(
        spec, _cpu(channel=1, dopp=1), vote=vote, force_generic=True)(blocks).items()}
    assert set(res) == set(ref)
    _assert_golden(res, ref, spec.windowWidth)
    if kind == "stx":
        assert (res["trust"] == -2).any()
    if vote:
        np.testing.assert_array_equal(res["bits_voted"], ref["bits_voted"])
        np.testing.assert_array_equal(res["trust_voted"], ref["trust_voted"])
    plain = build_sharded_demod_step(spec, _cpu(channel=1, dopp=1), vote=vote,
                                     force_generic=True, plain=True)(blocks)
    for k, v in plain.items():
        np.testing.assert_array_equal(v.numpy(), res[k], err_msg=f"plain {k}")


@pytest.mark.parametrize("kind", ["bench_GFSK", "bench_BPSK", "stx"])
def test_force_generic_matches_channel_parallel(kind):
    """Bits, symbols and centres of the generic step equal the channel-
    parallel step's on every channel (JAX's
    ``test_sharded_force_generic_matches_fast_path``); trust too below nSym."""
    _, spec, blocks = _case(kind)
    mesh = _cpu(channel=1, dopp=1)
    fast = build_sharded_demod_step(spec, mesh)(blocks)
    gen = build_sharded_demod_step(spec, mesh, force_generic=True)(blocks)
    for k in ("bits", "symbols", "centres", "mags", "nSym", "nBits", "spSym", "shift"):
        assert torch.equal(fast[k], gen[k]), k
    slot = torch.arange(spec.numSymMax)[None, :]
    inside = slot < fast["nSym"][:, None]
    assert torch.equal(fast["trust"][inside], gen["trust"][inside])
    assert torch.all(gen["trust"][~inside] == -1)


def test_mask_offset_matches_jax_p2_fallback():
    """``code_search_mask_offset = 1``: the timing sum runs over masks
    [1, M - 1), intersected with each shard's; JAX's generic step takes its
    P2 fallback on ``{"channel": 2, "dopp": 2}``."""
    jspec, _ = _specs("bench_GFSK")
    jspec = dataclasses.replace(jspec, code_search_mask_offset=1)
    spec = spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})
    blocks = _blocks(spec, "bench_GFSK", n_chan=2, seed=6)
    ref = {k: np.asarray(v) for k, v in
           jax_step(jspec, jax_make_mesh({"channel": 2, "dopp": 2}))(c2ri(blocks)).items()}
    res = {k: v.numpy() for k, v in build_sharded_demod_step(
        spec, _cpu(channel=1, dopp=1), force_generic=True)(blocks).items()}
    _assert_golden(res, ref, spec.windowWidth)
    np.testing.assert_array_equal(res["bits_voted"], ref["bits_voted"])


def test_device_consts_mask_range():
    """``DeviceConsts.from_spec`` with a shard's ``mask_range`` holds its
    rows of the bank and Q; the LUTs stay whole."""
    _, spec = _specs("bench_GFSK")
    whole = DeviceConsts.from_spec(spec, "cpu")
    half = DeviceConsts.from_spec(spec, "cpu", mask_range=(4, 8))
    assert torch.equal(half.masks_f, whole.masks_f[4:8])
    assert torch.equal(half.Q, whole.Q[4:8])
    assert torch.equal(half.bitLUT, whole.bitLUT)
    with pytest.raises(ValueError, match="mask_range"):
        DeviceConsts.from_spec(spec, "cpu", mask_range=(4, 9))


@pytest.mark.parametrize("n", [64, 100, 40])
def test_custom_xcorr_torch_matches_jax(n):
    """``custom_xcorr_torch`` against ``custom_xcorr_jax`` at N equal to,
    above (JAX zero-pads) and below (JAX cuts) len(a) = 64, and against
    the numpy copy, which equals JAX's numpy function."""
    from pycusdr_tpu.utils.xcorr import custom_xcorr as jax_np_xcorr
    from pycusdr_tpu.utils.xcorr import custom_xcorr_jax
    from pycusdr_tpu_torch.utils.xcorr import custom_xcorr, custom_xcorr_fast, custom_xcorr_torch

    rng = np.random.RandomState(n)
    a = (rng.randn(64) + 1j * rng.randn(64)).astype(np.complex64)
    b = np.roll(a, 11)[:48]
    got = custom_xcorr_torch(torch.from_numpy(a), torch.from_numpy(b), n).numpy()
    want = np.asarray(custom_xcorr_jax(jnp.asarray(a), jnp.asarray(b), n))
    assert got.shape == want.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(custom_xcorr(a, b, n), jax_np_xcorr(a, b, n))
    assert len(custom_xcorr_fast(a, b[:33])) == 64


def test_stage_timer_and_trace(tmp_path):
    """The named-stage timing ``StageTimer`` gave, now from the tracer's
    spans: three spans of one name counted with a median, inside
    ``device_trace``, which writes ``trace.json`` and ``spans.json``."""
    from pycusdr_tpu_torch.obs import profiling
    from pycusdr_tpu_torch.utils.device_info import device_inventory

    profiling.reset()
    with profiling.device_trace(str(tmp_path)):
        for _ in range(3):
            with profiling.span("fft"):
                torch.fft.fft(torch.ones(64, dtype=torch.complex64))
    s = profiling.summary()
    profiling.reset()
    assert s["fft"]["count"] == 3 and s["fft"]["host_ms_p50"] > 0
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert json.loads((tmp_path / "spans.json").read_text())["spans"]["fft"]["count"] == 3
    assert len(device_inventory()) == torch.cuda.device_count()
