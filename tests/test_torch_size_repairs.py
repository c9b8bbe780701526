"""The sizes the port's kernels refused and JAX takes, on the CPU.

- K6 at any N (``threshold_input``: the hit bitmask in ceil(N/32) words,
  the bits past N zero) against JAX's ``threshold_input`` at N = 1, 5, 16,
  48 and 2^9, with the tolerances of ``tests/test_torch_ops.py``
  (``test_threshold_input_matches_jax``): masks equal where |a - thr| >
  1e-5 thr, the signal within rtol 1e-5 there. K4's and K4s's clip window
  from such a bitmask (a partial last word) against JAX's ``find_centres``
  on JAX's dilated mask: symbols, centres and trust -2 exact.
- K4n at any symbol LUT: its plain version and K4s's NRZ-S form
  (``shard_select_nrzs``, the LUT read through L1 at any size) against
  JAX's ``extract_bits_nrzs`` at M x 2 x K above 12288 entries (48 KB),
  bits and errors exact.
- K2 and K3 at every power of two: ``fft_split``, ``mf_bank_plan`` and
  ``timing_band_plan`` equal the two-pass plans up to 2^18 (frozen copies
  below); above it a numpy model of K2's multi-pass index mapping (pass
  1, the middle passes, pass 2's rows and its output index with the middle
  digits reversed, each transform by ``np.fft`` on its factor, the
  twiddles from the float64-built table) equals ``np.fft.ifft`` within
  2e-5 of its largest magnitude at 2^19 and 2^21 (and on made-up factor
  lists with two and three middle passes); K3's model
  (``test_torch_fft_plan.k3_band_model``) equals ``np.fft.rfft`` at 2^19
  and 2^20 within that file's tolerance.
- The block graph at Nfft 2^4 with clipping, the plain path and the
  kernel path's wrappers on the CPU, against JAX's within the golden table
  of ``tests/test_dsp_golden.py:89-132``."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycusdr_tpu.dsp.block import build_process_block as jax_build_process_block
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.ops.demod_kernels import dilate_mask_dynamic, extract_bits_nrzs, find_centres
from pycusdr_tpu.ops.demod_kernels import threshold_input as jax_threshold_input
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch.convert import spec_from_numpy
from pycusdr_tpu_torch.dsp.block import build_process_batch, build_process_block
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops.layout import PACK_ARRAYS
from test_torch_fft_plan import _bands, _table, k3_band_model

torch.set_num_threads(2)

# ------------------------------------------------ K6 and the clip bitmask at any N


def _spiky(B, N, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N) + 1j * rng.randn(B, N)) / np.sqrt(2)
    x[0, N // 2] += 30.0  # block 0 clipped, block 1 not (unless by chance)
    return x.astype(np.complex64)


@pytest.mark.parametrize("N", [1, 5, 16, 48, 2 ** 9])
def test_threshold_input_any_n_matches_jax(N):
    scale = 2.5
    x = _spiky(2, N, N)
    y, hits, anyk = dk.threshold_input(torch.from_numpy(x), scale)
    assert hits.shape == (2, -(-N // 32)) and hits.dtype == torch.int32
    hit2 = dk.unpack_bits(hits, N)
    assert torch.equal(dk.pack_bits(hit2), hits)
    assert torch.equal(anyk, hit2.any(dim=-1).to(torch.int32))
    for b in range(2):
        jy, jh = (np.asarray(v) for v in jax_threshold_input(jnp.asarray(c2ri(x[b])), scale))
        a = np.abs(x[b].astype(np.complex128))
        thr1 = scale * a.mean()
        a1 = np.minimum(a, thr1)
        thr2 = scale * a1.mean()
        clear = (np.abs(a - thr1) > 1e-5 * thr1) & (np.abs(a1 - thr2) > 1e-5 * thr2)
        th = hit2[b].numpy()
        assert np.array_equal(th[clear], jh[clear])
        yc = y[b].numpy()
        np.testing.assert_allclose(yc.real[clear], jy[0][clear], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(yc.imag[clear], jy[1][clear], rtol=1e-5, atol=1e-6)
    if N > 1:
        assert bool(hit2[0].any())


def _detect_inputs(N, seed, B=2, M=4):
    rng = np.random.RandomState(seed)
    colmax = rng.rand(B, N).astype(np.float32)
    colarg = rng.randint(0, M, (B, N)).astype(np.int32)
    sp = np.array([4.0, 5.5], np.float32)[:B]
    co = np.array([1.3, 0.2], np.float32)[:B]
    hit = np.zeros((B, N), bool)
    hit[0, [0, N - 1]] = True  # the last sample lies in the partial last word
    hit[1, N - 3] = True
    return colmax, colarg, sp, co, hit


DET = dict(windowWidth=3, spsymMin=2)


@pytest.mark.parametrize("N", [48, 100, 1000])
def test_clip_window_partial_last_word_matches_jax(N):
    """K4 (``symbol_detect``) and K4s (``shard_select`` at nd = 1, after
    K4l) given K6's bitmask at N not a multiple of 32: symbols, centres
    and the trust -2 slots equal JAX's ``find_centres`` on its dilated mask."""
    colmax, colarg, sp, co, hit = _detect_inputs(N, N)
    B, S = colmax.shape[0], N // 2
    kw = dict(DET, Nfft=N, numSymMax=S)
    hits = dk.pack_bits(torch.from_numpy(hit))
    lut = torch.tensor([0, 1, 1, 0], dtype=torch.int8)
    args = (torch.from_numpy(colmax), torch.from_numpy(colarg), torch.from_numpy(sp),
            torch.from_numpy(co))
    t = dk.symbol_detect(*args, lut, trust_normal=2, hits=hits, **kw)
    val, key = dk.symbol_detect_local(*args, m0=0, M=4, **kw)
    row = torch.zeros((B, len(PACK_ARRAYS) * S + 12))
    dk.shard_select(dk.pack_pairs(val, key)[None], args[2], args[3], lut, M=4, trust_normal=2,
                    row=row, code_val=torch.zeros(B), hits=hits, **kw)
    for b in range(B):
        spc = jnp.maximum(jnp.float32(sp[b]), float(DET["spsymMin"]))
        clip = dilate_mask_dynamic(jnp.asarray(hit[b]), 2 * jnp.ceil(spc).astype(jnp.int32))
        sym, cen, _, nsym, _, at_win = find_centres(
            None, jnp.float32(sp[b]), jnp.float32(co[b]), **kw, clip_mask=clip,
            cols=(jnp.asarray(colmax[b]), jnp.asarray(colarg[b])), num_masks=4)
        at_win = np.asarray(at_win)
        assert at_win.any()
        assert np.array_equal(t[0][b].numpy(), np.asarray(sym))
        assert np.array_equal(t[1][b].numpy(), np.asarray(cen))
        assert np.array_equal(t[4][b].numpy(), np.where(at_win, -2, 2))
        n = int(nsym)
        trust_s = row[b, S:2 * S].numpy()[:n]  # K4s: trust -1 from nSym on
        assert np.array_equal(trust_s, np.where(at_win[:n], -2, 2))
        assert np.array_equal(row[b, 2 * S:3 * S].numpy(), np.asarray(sym, np.float32))


# ------------------------------------------------ K4n at any LUT size


@pytest.mark.parametrize("M,K", [(2048, 4), (8192, 4), (13000, 1)])
def test_nrzs_large_lut_matches_jax(M, K):
    """NRZ-S over a LUT of M x 2 x K > 12288 entries: the plain version
    against JAX's ``extract_bits_nrzs``, symbols outside [0, M) included;
    K4s's NRZ-S form on the CPU (one shard, a bank of M + 2 masks, so its
    symbols reach past the LUT; -1 taken as M + 1) against JAX on the
    symbols it selects."""
    rng = np.random.RandomState(M + K)
    S = 700
    lut = rng.randint(0, M, (M, 2, K)).astype(np.int32)
    sym = rng.randint(-1, M + 1, S).astype(np.int32)
    nxt = np.roll(sym, -1)
    for i in range(0, S, 3):  # a third of the transitions hit a table
        if 0 <= sym[i] < M:
            lut[sym[i], i % 2, rng.randint(K)] = nxt[i]
    jb, je = (np.asarray(v) for v in extract_bits_nrzs(jnp.asarray(sym), jnp.asarray(lut)))
    bits, err = dk.nrzs_bits_plain(torch.from_numpy(sym), torch.from_numpy(lut))
    assert np.array_equal(bits.numpy(), jb) and np.array_equal(err.numpy(), je)
    assert (~je).sum() > S // 4 and je.any()
    sym_k = np.where(sym < 0, M + 1, sym).astype(np.int32)  # keys are >= 0
    jb, je = (np.asarray(v) for v in extract_bits_nrzs(jnp.asarray(sym_k), jnp.asarray(lut)))
    pairs = dk.pack_pairs(torch.ones((1, 1, S)), torch.from_numpy(sym_k)[None, None])
    row = torch.zeros((1, len(PACK_ARRAYS) * S + 12))
    dk.shard_select_nrzs(pairs, torch.tensor([4.0]), torch.tensor([0.5]), torch.from_numpy(lut),
                         M=M + 2, Nfft=8 * S, windowWidth=3, spsymMin=2, numSymMax=S,
                         trust_normal=2, row=row, code_val=torch.zeros(1))
    assert np.array_equal(row[0, 2 * S:3 * S].numpy(), sym_k.astype(np.float32))
    assert np.array_equal(row[0, :S].numpy(), jb.astype(np.float32))
    assert np.array_equal(row[0, S:2 * S].numpy(), np.where(je, -1, 2).astype(np.float32))
    assert (~je).sum() > S // 4 and je.any()


# ------------------------------------------------ K2 and K3 at every power of two


def _parent_fft_split(N):
    log2n = N.bit_length() - 1
    return 1 << ((log2n + 1) // 2)


def _parent_mf_bank_plan(N, M, B):
    """``mf_bank_plan`` of the two-pass K2 (N <= 2^18), frozen."""
    n1 = _parent_fft_split(N)
    n2 = N // n1
    C = min(n2, dk.FFT_TILE // n1, dk.FFT_MAX_ROWS)
    R = min(8, n1, dk.K2_OUT * dk.FFT_THREADS // n2)
    while R > 2 and B * (n1 // R) < 2 * dk.SM_COUNT:
        R //= 2
    Mg = max(1, min(M, dk.FFT_MAX_ROWS // R, dk.FFT_TILE // (R * n2)))
    return dict(n1=n1, n2=n2, C=C, R=R, Mg=Mg, grid1=(n2 // C, M, B), grid2=(n1 // R, B),
                smem=dk.FFT_SMEM_BYTES, cluster=1)


def _parent_timing_band_plan(N):
    n1 = min(N, dk.FFT_MAX_L)
    n2 = N // n1
    cw = min(n2, dk.K3_CW)
    tiles = n2 // cw
    groups = min(tiles, dk.K3_GROUPS)
    return dict(n1=n1, n2=n2, cw=cw, groups=groups, chunks=tiles // groups,
                smem=dk.FFT_SMEM_BYTES, cluster=1)


@pytest.mark.parametrize("N", [2 ** e for e in range(2, 19)])
def test_plans_up_to_2_18_are_the_two_pass_plans(N):
    assert dk.fft_split(N) == _parent_fft_split(N)
    assert dk.fft_factors(N) == (_parent_fft_split(N), N // _parent_fft_split(N))
    assert dk.timing_band_plan(N) == _parent_timing_band_plan(N)
    for M in (1, 3, 8, 16, 32, 64):
        for B in (1, 2, 16, 64):
            assert dk.mf_bank_plan(N, M, B) == _parent_mf_bank_plan(N, M, B)
            assert dk.mid_code(dk.mf_bank_plan(N, M, B)) == 0


@pytest.mark.parametrize("N", [2 ** e for e in range(19, 31)])
def test_multipass_plans(N):
    """Above 2^18: factors of at most 512 whose product is N, the first 512,
    one middle pass for each beyond two; the tiles and grids the launcher
    (``csrc/mf_bank.cu``) checks and launches; K3 one tile chain a group."""
    f = dk.fft_factors(N)
    assert math.prod(f) == N and f[0] == 512 and max(f) <= 512 and min(f) >= 2
    assert len(f) == 2 + len(dk.mf_bank_plan(N, 1, 1).get("mid", ()))
    assert dk.fft_split(N) == 512
    for M, B in ((1, 1), (8, 4), (8, 64)):
        p = dk.mf_bank_plan(N, M, B)
        n1, n2, C, R, Mg = (p[k] for k in ("n1", "n2", "C", "R", "Mg"))
        mid = p["mid"]
        nmid = math.prod(mid)
        assert (n1, *mid, n2) == f
        assert C * n1 <= dk.FFT_TILE and C <= dk.FFT_MAX_ROWS and (N // n1) % C == 0
        assert Mg * R * n2 <= dk.FFT_TILE and Mg * R <= dk.FFT_MAX_ROWS and 1 <= Mg <= M
        assert R * n2 <= dk.FFT_THREADS * dk.K2_OUT and n1 % R == 0
        assert p["grid1"] == (N // n1 // C, M, B) and p["grid2"] == (n1 // R * nmid, B)
        inner = N // n1
        for F, c, g in zip(mid, p["Cm"], p["grid_mid"]):
            inner //= F
            assert c == min(inner, dk.FFT_TILE // F, dk.FFT_MAX_ROWS) and inner % c == 0
            assert g == B * M * N // (F * inner) * (inner // c) < 2 ** 31
        code = dk.mid_code(p)
        assert [(code >> (4 * i)) & 15 for i in range(len(mid))] == [
            F.bit_length() - 1 for F in mid]
    p3 = dk.timing_band_plan(N)
    assert p3["n1"] == 512 and p3["n1"] * p3["n2"] == N
    assert p3["groups"] * p3["chunks"] * p3["cw"] == p3["n2"]


def _mid_reverse(s, logs):
    """``csrc/mf_bank.cu:mid_reverse``: the middle digits as Y stores them
    (the first factor's most significant) to their place in the output
    index (the first factor's least significant)."""
    pre, o = sum(logs), 0
    for lg in reversed(logs):
        pre -= lg
        o |= (s & ((1 << lg) - 1)) << pre
        s >>= lg
    return o


def k2_multipass_model(x, factors):
    """K2's transform of one (N,) complex64 row through the kernel's index
    maps, each factor's transforms by ``np.fft`` (unnormalised inverse):
    pass 1 down the columns of the (n1, N / n1) view with exp(+2πi n1 k' / N);
    each middle pass over rows of F * inner elements, down the columns
    of their (F, inner) view, with exp(+2πi na kb / (F inner)); pass 2 over
    the rows of the last factor at (n1 << log2(N / n1)) + (s << log2 n2),
    output n1 + (mid_reverse(s) << log2 n1) + (k << log2(n1 nmid)). The
    twiddles come from the float64-built table of N entries."""
    N = x.shape[0]
    n1, *mid, n2 = factors
    logs = [F.bit_length() - 1 for F in mid]
    tw = _table(N)
    lg = N.bit_length() - 1
    Y = x.reshape(n1, N // n1)
    A = (np.fft.ifft(Y, axis=0) * n1).astype(np.complex64)  # [n1, k']
    Y = (A * tw[np.arange(n1)[:, None] * np.arange(N // n1)[None, :]]).reshape(-1)
    inner = N // n1
    for F, lf in zip(mid, logs):
        inner //= F
        rows = Y.reshape(-1, F, inner)  # [row, ka, kb]
        Z = (np.fft.ifft(rows, axis=1) * F).astype(np.complex64)
        sh = lg - lf - (inner.bit_length() - 1)
        w = tw[(np.arange(F)[:, None] * np.arange(inner)[None, :]) << sh]
        Y = (Z * w[None]).astype(np.complex64).reshape(-1)
    nmid = math.prod(mid)
    lmid = sum(logs)
    out = np.empty(N, np.complex64)
    rows = Y.reshape(n1, nmid, n2)  # row (n1, s) at n1 * N / n1 + s * n2
    X = (np.fft.ifft(rows, axis=2) * n2).astype(np.complex64)
    l1, l2 = n1.bit_length() - 1, n2.bit_length() - 1
    for s in range(nmid):
        o = _mid_reverse(s, logs)
        n = np.arange(n1)[:, None] + (o << l1) + (np.arange(n2)[None, :] << (l1 + lmid))
        out[n] = X[:, s]
    assert l1 + lmid + l2 == lg
    return out


@pytest.mark.parametrize("factors", [
    pytest.param(dk.fft_factors(2 ** 19), id="2^19"),
    pytest.param(dk.fft_factors(2 ** 21), id="2^21"),
    pytest.param((8, 4, 16, 8), id="two-middles"),
    pytest.param((4, 2, 8, 4, 16), id="three-middles"),
])
def test_k2_multipass_model_matches_ifft(factors):
    N = math.prod(factors)
    rng = np.random.RandomState(len(factors) + N % 97)
    x = (rng.randn(N) + 1j * rng.randn(N)).astype(np.complex64)
    got = k2_multipass_model(x, factors)
    want = np.fft.ifft(x.astype(np.complex128)) * N
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["lo0", "straddle"])
@pytest.mark.parametrize("N", [2 ** 19, 2 ** 20])
def test_k3_model_above_2_18(N, kind):
    lo, hi = _bands(N)[kind]
    rng = np.random.RandomState(N % 9973 + len(kind))
    x = rng.randn(2, N).astype(np.float32)
    got = k3_band_model(x, lo, hi)
    want = np.fft.rfft(x.astype(np.float64))[:, lo:hi]
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max() * np.log2(N) / 16


# ------------------------------------------------ the block graph at Nfft 2^4 with clipping


@pytest.fixture(scope="module")
def graph16():
    """An STX radio at blockSize 4 (Nfft 16, 2 samples a symbol, W=1, 2
    masks), clipping at scale 4.5: JAX's graph, the port's plain graph and its
    kernel path's wrappers on the CPU, on a noise block with a spike and
    one without."""
    conf = {"Main": {"workerId": "t", "protocols": {"UHF": "bench_FSK"}},
            "GPU": {"STX": {"blockSize": 4, "overlap": 1, "bitWindowWidth": 1,
                            "xcorrMaskSize": 1, "peakThresholdScale": 4.5,
                            "doppCarrierSteps": 1}},
            "Radios": {"rangeRateMax": 7500, "Rx": {"STX": {
                "name": "STX", "CUDA_settings": "STX", "frequency_Hz": 2.4e9,
                "frequencyOffset_Hz": 0, "baud": 9600, "samplesPerSym": 2,
                "doppCarrierSteps": 1, "Protocol": "UHF", "radioBackend": "STX",
                "voteGroup": "STX"}}}}
    jspec = jax_build_spec(conf, jax_loadProtocol("bench_FSK")(conf=conf), "STX")
    jspec = dataclasses.replace(jspec, doppler_search=False, disable_peak_thresholding=False)
    assert jspec.Nfft == 16
    spec = spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})
    rng = np.random.RandomState(16)
    x = ((rng.randn(2, 16) + 1j * rng.randn(2, 16)) / np.sqrt(2)).astype(np.complex64)
    x[0, 5] += 25.0
    jx = [{k: np.asarray(v) for k, v in jax_build_process_block(jspec)(c2ri(x[b])).items()}
          for b in range(2)]
    plain = build_process_block(spec, device="cpu")
    pt = [{k: v.numpy() for k, v in plain(torch.from_numpy(x[b])).items()} for b in range(2)]
    kp = build_process_batch(spec, device="cpu")(torch.from_numpy(x))
    kp = [{k: v[b].numpy() for k, v in kp.items()} for b in range(2)]
    return spec, jx, pt, kp


@pytest.mark.parametrize("path", ["plain", "kernel_path"])
@pytest.mark.parametrize("check", ["timing", "bits", "centres", "trust"])
def test_graph_at_nfft_16_with_clipping_matches_jax(graph16, path, check):
    spec, jx, pt, kp = graph16
    got = pt if path == "plain" else kp
    assert bool(jx[0]["clipped_any"]) and not bool(jx[1]["clipped_any"])
    for b in range(2):
        g, ref = got[b], jx[b]
        n = int(g["nSym"])
        if check == "timing":
            assert abs(float(g["spSym"]) - float(ref["spSym"])) < 1e-3
            assert abs(float(g["codeOffset"]) - float(ref["codeOffset"])) < 0.05
        elif check == "bits":
            assert n == int(ref["nSym"])
            assert np.mean(g["symbols"][:n] == ref["symbols"][:n]) > 0.999
            assert np.array_equal(g["bits"][:n], ref["bits"][:n])
        elif check == "centres":
            d = np.abs(g["centres"][:n] - ref["centres"][:n])
            assert d.max() <= spec.windowWidth and np.mean(d == 0) > 0.75
        else:
            assert np.array_equal(g["trust"][:n], ref["trust"][:n])
            assert bool(g["clipped_any"]) == bool(ref["clipped_any"])
            assert np.any(g["trust"][:n] == -2) == (b == 0)
