"""Each hand-written kernel's plain PyTorch version (what the wrappers
run on a CPU tensor), and the port's torch ops, against the JAX
function they replace, on identical seeded inputs.

Tolerances: K1 within 2e-3 * max|E| (the JAX route contracts FFTs of
P against a phasor matrix, the port sums the Parseval form directly);
K2 colsum/colmax within 1e-4 * max, colargmax equal wherever the top
two masks differ by more than 1e-3 relative; K3 spSym exact and
codeOffset within 0.05; K4 bit-exact given the same inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from conftest import make_fsk_signal
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.ops.demod_kernels import (
    apply_best_doppler_power_cols,
    compute_snr as jax_compute_snr,
    extract_bits_lut,
    find_centres,
    find_code_rate_and_phase_from_power,
)
from pycusdr_tpu.ops.doppler_search import (
    doppler_energy_corr_dft,
    find_doppler_estimate as jax_find_doppler_estimate,
    make_corr_dft_F,
    make_qf_ri,
)
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch.convert import DeviceConsts, spec_from_numpy
from pycusdr_tpu_torch.dsp.signal_gen import modulate_gfsk2
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops import doppler_search as ds

torch.set_num_threads(2)
B = 2


def _carry(jspec):
    return spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})


@pytest.fixture(scope="module", params=["tiny", "bench"])
def case(request, bench_conf):
    """(jax spec, port spec, port consts, (B, N) complex64 blocks)."""
    rng = np.random.RandomState(17)
    if request.param == "tiny":
        jspec = graft.tiny_spec()
        sps = int(jspec.spsym)
        rows = []
        for b in range(B):
            bits = rng.randint(0, 2, jspec.Nfft // sps + 8)
            s = modulate_gfsk2(bits, sps)[: jspec.Nfft]
            f = (jspec.centreFreqOffset + 500.0 * b) / jspec.sampleRate
            rows.append(s * np.exp(2j * np.pi * f * np.arange(jspec.Nfft)))
    else:
        jspec = jax_build_spec(bench_conf, jax_loadProtocol("bench_FSK")(conf=bench_conf),
                               "UHF-H")
        rows = [make_fsk_signal(rng.randint(0, 2, jspec.Nfft // 16), 16,
                                (38400 + 700.0 * b) / jspec.sampleRate, seed=b,
                                noise_std=0.05) for b in range(B)]
    x = np.stack(rows) + 0.05 * (rng.randn(B, jspec.Nfft) + 1j * rng.randn(B, jspec.Nfft))
    spec = _carry(jspec)
    return jspec, spec, DeviceConsts.from_spec(spec, "cpu"), x.astype(np.complex64)


def _spectra(x):
    S = np.fft.fft(x.astype(np.complex128), axis=-1).astype(np.complex64)
    P = (S.real.astype(np.float32) ** 2 + S.imag.astype(np.float32) ** 2)
    return S, P


@pytest.mark.parametrize("centre", [0, 37])
def test_doppler_energy_matches_jax(case, centre):
    jspec, spec, c, x = case
    S, P = _spectra(x)
    qf = jnp.asarray(make_qf_ri(jspec.masks_f))
    F = jnp.asarray(make_corr_dft_F(jspec.Nfft, jspec.dopp_shifts))
    Ej = np.stack([np.asarray(doppler_energy_corr_dft(
        jnp.asarray(P[b]), qf, F, None if centre == 0 else centre)) for b in range(B)])
    cs = None if centre == 0 else torch.full((B,), centre, dtype=torch.int32)
    Et = ds.doppler_energy(torch.from_numpy(P), c.Q, c.shifts, cs).numpy()
    assert Et.shape == (B, spec.D, spec.num_masks)
    assert np.max(np.abs(Et - Ej)) <= 2e-3 * np.max(np.abs(Ej))


def test_doppler_energy_centre_shift_is_a_shift(case):
    """A recentre by c equals evaluating the grid at s_d + c."""
    _, spec, c, x = case
    _, P = _spectra(x)
    Pt = torch.from_numpy(P)
    a = ds.doppler_energy(Pt, c.Q, c.shifts, torch.full((B,), -5, dtype=torch.int32))
    b = ds.doppler_energy(Pt, c.Q, (c.shifts - 5) % spec.Nfft)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("sum_all_masks", [True, False])
def test_find_doppler_estimate_matches_jax(case, sum_all_masks):
    jspec, spec, c, x = case
    _, P = _spectra(x)
    E = ds.doppler_energy(torch.from_numpy(P), c.Q, c.shifts)
    E = torch.cat([E, torch.zeros_like(E[:1])])  # an idle block: index 0, not NaN
    idx, q = ds.find_doppler_estimate(E, spec.num_dopplers, spec.dopp_array_offset,
                                      sum_all_masks)
    for b in range(E.shape[0]):
        ji, jq = jax_find_doppler_estimate(jnp.asarray(E[b].numpy()), spec.num_dopplers,
                                           spec.dopp_array_offset, sum_all_masks)
        assert abs(float(idx[b]) - float(ji)) < 1e-4
        if np.isfinite(float(jq)):
            assert abs(float(q[b]) - float(jq)) < 1e-3
        else:
            assert float(q[b]) == float(jq)
    assert float(idx[-1]) == 0.0


def test_compute_snr_matches_jax(case):
    _, spec, c, x = case
    _, P = _spectra(x)
    absS = np.sqrt(P)
    absS = np.concatenate([absS, np.zeros_like(absS[:1])])  # idle block: -inf
    lo = np.array([3, 17, 0], np.int64)[: absS.shape[0]]
    hi = lo + np.array([2, 5, 1])[: absS.shape[0]]
    snr = ds.compute_snr(torch.from_numpy(absS), torch.from_numpy(lo), torch.from_numpy(hi),
                         spec.snr_window, spec.Nfft)
    for b in range(absS.shape[0]):
        j = float(jax_compute_snr(jnp.asarray(absS[b]), int(lo[b]), int(hi[b]),
                                  spec.snr_window, spec.Nfft))
        if np.isfinite(j):
            assert abs(float(snr[b]) - j) < 1e-3
        else:
            assert float(snr[b]) == j
    assert float(snr[-1]) == float("-inf")


def _jax_cols(jspec, S, shifts, off):
    M = jspec.num_masks
    masks_ri = c2ri(jspec.masks_f)
    outs = [apply_best_doppler_power_cols(c2ri(S[b]), jnp.asarray(masks_ri), int(shifts[b]),
                                          off, M - off) for b in range(len(S))]
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]


@pytest.mark.parametrize("off", [0, 1])
def test_mf_bank_colreduce_matches_jax(case, off):
    jspec, spec, c, x = case
    S, _ = _spectra(x)
    shifts = np.array([int(spec.dopp_offset_idx), spec.Nfft - 3])
    js, jm, ja = _jax_cols(jspec, S, shifts, off)
    ts, tm, ta = (t.numpy() for t in dk.mf_bank_colreduce(
        torch.from_numpy(S), c.masks_f, torch.from_numpy(shifts.astype(np.int32)), off,
        spec.num_masks - off))
    assert np.max(np.abs(ts - js)) <= 1e-4 * np.max(np.abs(js))
    assert np.max(np.abs(tm - jm)) <= 1e-4 * np.max(np.abs(jm))
    # float64 golden power decides which samples have a clear winner
    N = spec.Nfft
    idx = (np.arange(N)[None, :] + shifts[:, None]) % N
    X = np.fft.ifft(np.take_along_axis(S.astype(np.complex128), idx, 1)[:, None, :]
                    * spec.masks_f[None].astype(np.complex128), axis=-1) * N
    pw = np.sort(np.abs(X) ** 2, axis=1)
    clear = (pw[:, -1] - pw[:, -2]) > 1e-3 * pw[:, -1]
    assert clear.mean() > 0.5
    assert np.array_equal(ta[clear], ja[clear])


def test_timing_band_matches_jax(case):
    jspec, spec, c, x = case
    S, _ = _spectra(x)
    shifts = np.full(B, int(spec.dopp_offset_idx))
    colsum = _jax_cols(jspec, S, shifts, 0)[0]
    sp, co, val = (t.numpy() for t in dk.timing_band(
        torch.from_numpy(colsum), spec.code_idx_lo, spec.code_idx_hi))
    for b in range(B):
        jsp, jco, jval = (float(v) for v in find_code_rate_and_phase_from_power(
            jnp.asarray(colsum[b]), spec.code_idx_lo, spec.code_idx_hi, spec.Nfft))
        assert sp[b] == np.float32(jsp)
        assert abs(co[b] - jco) < 0.05
        assert abs(val[b] - jval) <= 1e-3 * jval


def _k4_both(jspec, spec, c, colmax, colarg, spSym, codeOffset):
    kw = dict(Nfft=spec.Nfft, windowWidth=spec.windowWidth, spsymMin=spec.spsymMin,
              numSymMax=spec.numSymMax)
    t = dk.symbol_detect(torch.from_numpy(colmax), torch.from_numpy(colarg),
                         torch.from_numpy(spSym), torch.from_numpy(codeOffset), c.bitLUT,
                         trust_normal=c.trust_normal, **kw)
    for b in range(colmax.shape[0]):
        sym, cen, mag, nsym, _ = find_centres(
            None, jnp.float32(spSym[b]), jnp.float32(codeOffset[b]), **kw,
            cols=(jnp.asarray(colmax[b]), jnp.asarray(colarg[b])), num_masks=spec.num_masks)
        bits = extract_bits_lut(sym, jnp.asarray(jspec.bitLUT.astype(np.int8)))
        assert np.array_equal(t[0][b].numpy(), np.asarray(sym))
        assert np.array_equal(t[1][b].numpy(), np.asarray(cen))
        assert np.array_equal(t[2][b].numpy(), np.asarray(mag))
        assert np.array_equal(t[3][b].numpy(), np.asarray(bits))
        assert np.all(t[4][b].numpy() == 2)
        assert int(t[5][b]) == int(nsym)


def test_symbol_detect_matches_jax_on_signal(case):
    jspec, spec, c, x = case
    S, _ = _spectra(x)
    shifts = np.full(B, int(spec.dopp_offset_idx))
    colsum, colmax, colarg = _jax_cols(jspec, S, shifts, 0)
    sp, co, _ = (np.asarray(v) for v in zip(*[find_code_rate_and_phase_from_power(
        jnp.asarray(colsum[b]), spec.code_idx_lo, spec.code_idx_hi, spec.Nfft)
        for b in range(B)]))
    _k4_both(jspec, spec, c, colmax, colarg.astype(np.int32), sp.astype(np.float32),
             co.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_symbol_detect_matches_jax_on_ties(case, seed):
    """Quantized magnitudes force exact ties (earliest sample wins); odd
    spSym / codeOffset values (negative included) exercise the slot
    truncation and clamping at both array edges."""
    jspec, spec, c, _ = case
    rng = np.random.RandomState(seed)
    N, M = spec.Nfft, spec.num_masks
    colmax = (np.round(rng.rand(B, N).astype(np.float32) * 64) / 8).astype(np.float32)
    colarg = rng.randint(0, M, (B, N)).astype(np.int32)
    spSym = (N / rng.randint(spec.code_idx_lo, spec.code_idx_hi, B)).astype(np.float32)
    codeOffset = rng.uniform(-0.9, spSym).astype(np.float32)
    _k4_both(jspec, spec, c, colmax, colarg, spSym, codeOffset)


def test_wrappers_reject_other_devices():
    """A wrapper runs the plain version only for a CPU tensor; any other
    device launches the kernel or raises, never falls back."""
    spec = graft.tiny_spec()
    c = DeviceConsts.from_spec(_carry(spec), "cpu")
    P = torch.zeros((1, spec.Nfft), device="meta")
    with pytest.raises(ValueError):
        ds.doppler_energy(P, c.Q, c.shifts)
    with pytest.raises(ValueError):
        dk.timing_band(P, spec.code_idx_lo, spec.code_idx_hi)


# ---- slice 2: K6 spike clipping, the clip dilation, K4's clip window, K5


def _spiky(x, seed, n_bursts=3, amp=300.0):
    """x with interference bursts of 1-16 samples; the last burst touches
    the block's end."""
    rng = np.random.RandomState(seed)
    x = x.copy()
    B, N = x.shape
    for b in range(B):
        for i in range(n_bursts):
            w = rng.randint(1, 17)
            at = N - w if i == n_bursts - 1 else rng.randint(0, N - w)
            x[b, at:at + w] += amp * np.exp(2j * np.pi * rng.rand(w))
    return x.astype(np.complex64)


@pytest.mark.parametrize("n_bursts", [0, 1, 3])
def test_threshold_input_matches_jax(case, n_bursts):
    """K6's plain version against JAX ``threshold_input``. The means are
    summed in another order than JAX's, so thr may differ by ulps: masks
    are compared except where |a - thr| <= 1e-5 thr, signals where the
    masks agree (rtol 1e-5: the gains thr / a carry thr's ulps)."""
    from pycusdr_tpu.ops.demod_kernels import threshold_input as jax_threshold_input

    jspec, spec, _, x = case
    x = _spiky(x, n_bursts, n_bursts) if n_bursts else x
    scale = 4.5
    y, hit2 = dk.threshold_input_plain(torch.from_numpy(x), scale)
    yk, hits, anyk = dk.threshold_input(torch.from_numpy(x), scale)
    assert torch.equal(dk.unpack_bits(hits, spec.Nfft), hit2)
    assert torch.equal(yk, y)
    assert torch.equal(anyk, hit2.any(dim=-1).to(torch.int32))
    for b in range(B):
        jy, jh = (np.asarray(v) for v in jax_threshold_input(jnp.asarray(c2ri(x[b])), scale))
        a = np.abs(x[b].astype(np.complex128))
        thr1 = scale * a.mean()
        a1 = np.minimum(a, thr1)
        thr2 = scale * a1.mean()
        clear = (np.abs(a - thr1) > 1e-5 * thr1) & (np.abs(a1 - thr2) > 1e-5 * thr2)
        assert clear.mean() > 0.99
        th = hit2[b].numpy()
        assert np.array_equal(th[clear], jh[clear])
        yc = y[b].numpy()
        np.testing.assert_allclose(yc.real[clear], jy[0][clear], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(yc.imag[clear], jy[1][clear], rtol=1e-5, atol=1e-6)
        if n_bursts:
            assert th.any() and np.abs(yc).max() < 2 * thr1


def test_pack_bits_roundtrip():
    rng = np.random.RandomState(0)
    m = torch.from_numpy(rng.rand(3, 256) > 0.7)
    m[:, 31] = m[:, 255] = True  # the top bit of a word (the int32 sign)
    w = dk.pack_bits(m)
    assert w.dtype == torch.int32 and w.shape == (3, 8)
    assert torch.equal(dk.unpack_bits(w, 256), m)


@pytest.mark.parametrize("hw", [0, 1, 5, 37, 2048, 3000])
def test_dilate_mask_matches_jax(hw):
    """JAX's prefix-count dilation: window [max(i-hw, 0), min(i+hw, N-1)],
    hw clamped at 2048 (3000 exercises the clamp on a 2^13 block)."""
    from pycusdr_tpu.ops.demod_kernels import dilate_mask_dynamic

    rng = np.random.RandomState(hw)
    N = 8192
    m = rng.rand(2, N) > 0.9995
    m[0, 0] = m[1, N - 1] = True  # both edges
    got = dk.dilate_mask_plain(torch.from_numpy(m), torch.tensor([hw, hw], dtype=torch.int32))
    for b in range(2):
        want = np.asarray(dilate_mask_dynamic(jnp.asarray(m[b]), jnp.int32(hw)))
        assert np.array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_symbol_detect_clip_matches_jax(case, seed):
    """K4 with a clip mask (the wrapper given K6's bitmask, which dilates
    by 2 ceil(spc) itself) against ``find_centres(..., clip_mask=...)`` on
    JAX's dilated mask: symbols and at_win exact, trust -2 exactly there."""
    from pycusdr_tpu.ops.demod_kernels import dilate_mask_dynamic

    jspec, spec, c, x = case
    S, _ = _spectra(x)
    shifts = np.full(B, int(spec.dopp_offset_idx))
    colsum, colmax, colarg = _jax_cols(jspec, S, shifts, 0)
    sp, co, _ = (np.asarray(v, np.float32) for v in zip(*[find_code_rate_and_phase_from_power(
        jnp.asarray(colsum[b]), spec.code_idx_lo, spec.code_idx_hi, spec.Nfft)
        for b in range(B)]))
    rng = np.random.RandomState(seed)
    hit = np.zeros((B, spec.Nfft), bool)
    for b in range(B):  # three hits, one at an edge
        hit[b, rng.randint(0, spec.Nfft, 2)] = True
        hit[b, (0, spec.Nfft - 1)[b % 2]] = True
    kw = dict(Nfft=spec.Nfft, windowWidth=spec.windowWidth, spsymMin=spec.spsymMin,
              numSymMax=spec.numSymMax)
    t = dk.symbol_detect(torch.from_numpy(colmax), torch.from_numpy(colarg.astype(np.int32)),
                         torch.from_numpy(sp), torch.from_numpy(co), c.bitLUT,
                         trust_normal=c.trust_normal, hits=dk.pack_bits(torch.from_numpy(hit)),
                         **kw)
    assert len(t) == 7
    for b in range(B):
        spc = jnp.maximum(jnp.float32(sp[b]), float(spec.spsymMin))
        clip = dilate_mask_dynamic(jnp.asarray(hit[b]), 2 * jnp.ceil(spc).astype(jnp.int32))
        sym, cen, mag, nsym, _, at_win = find_centres(
            None, jnp.float32(sp[b]), jnp.float32(co[b]), **kw, clip_mask=clip,
            cols=(jnp.asarray(colmax[b]), jnp.asarray(colarg[b])), num_masks=spec.num_masks)
        at_win = np.asarray(at_win)
        assert at_win.any() and not at_win.all()
        assert np.array_equal(t[0][b].numpy(), np.asarray(sym))
        assert np.array_equal(t[1][b].numpy(), np.asarray(cen))
        assert np.array_equal(t[6][b].numpy(), at_win)
        assert np.array_equal(t[4][b].numpy(), np.where(at_win, -2, 2))


def _est_spec(bench_conf, variant):
    conf = {k: (dict(v) if isinstance(v, dict) else v) for k, v in bench_conf.items()}
    conf["Radios"] = dict(conf["Radios"], Rx={"UHF-H": dict(conf["Radios"]["Rx"]["UHF-H"])})
    radio = conf["Radios"]["Rx"]["UHF-H"]
    if variant == "noise_bin":  # a noise-measurement bin leads the grid: offset 1
        radio["noise_measure_offset_Hz"] = -60000.0
    elif variant == "dc":  # the grid straddles DC: shifts ~N-1 next to 0
        radio["frequencyOffset_Hz"] = 0.0
    return jax_build_spec(conf, jax_loadProtocol("bench_FSK")(conf=conf), "UHF-H")


def _jax_estimate(jspec, E, P, sum_all_masks):
    """JAX's estimate, interpolation and SNR as pycusdr_tpu/dsp/block.py:245-267."""
    N, D = jspec.Nfft, jspec.D
    ji, jq = jax_find_doppler_estimate(jnp.asarray(E), jspec.num_dopplers,
                                       jspec.dopp_array_offset, sum_all_masks)
    lo = jnp.clip(jnp.floor(ji).astype(jnp.int32), 0, D - 1)
    hi = jnp.clip(jnp.ceil(ji).astype(jnp.int32), 0, D - 1)
    frac = jnp.mod(ji, 1.0)
    hz = jnp.asarray(jspec.dopp_hz_lut.astype(np.float32))
    sh_t = jnp.asarray(jspec.dopp_shifts.astype(np.int32))
    dhz = hz[lo] + (hz[hi] - hz[lo]) * frac
    sh_signed = jnp.mod(sh_t + N // 2, N) - N // 2
    sl, sh = sh_signed[lo].astype(jnp.float32), sh_signed[hi].astype(jnp.float32)
    shift = jnp.mod(jnp.round(sl + (sh - sl) * frac).astype(jnp.int32), N)
    snr = jax_compute_snr(jnp.sqrt(jnp.asarray(P)), sh_t[lo], sh_t[hi], jspec.snr_window, N)
    return [float(v) for v in (ji, jq, dhz, dhz - jspec.centreFreqOffset, snr)] + [int(shift)]


@pytest.mark.parametrize("sum_all_masks", [True, False])
@pytest.mark.parametrize("variant", ["bench", "noise_bin", "dc"])
def test_doppler_estimate_matches_jax(bench_conf, variant, sum_all_masks):
    """K5's plain version (and the wrapper writing the packed row's tail)
    against JAX's find_doppler_estimate + interpolation + compute_snr:
    shift exact, dopp_idx within 1e-5 relative, Hz within 1e-2, quality
    and SNR within 1e-3 dB. The last block is all zeros: index 0, SNR
    -inf, quality -inf without a noise bin (0/0 = NaN with one, in JAX
    too)."""
    jspec = _est_spec(bench_conf, variant)
    spec = _carry(jspec)
    c = DeviceConsts.from_spec(spec, "cpu")
    N = spec.Nfft
    rng = np.random.RandomState(11)
    rows = [make_fsk_signal(rng.randint(0, 2, N // 16), 16,
                            (spec.centreFreqOffset + f) / spec.sampleRate, seed=i,
                            noise_std=0.1) for i, f in enumerate((900.0, -2500.0))]
    x = np.stack(rows + [np.zeros(N, np.complex64)])
    _, P = _spectra(x)
    Pt = torch.from_numpy(P)
    E = ds.doppler_energy(Pt, c.Q, c.shifts)
    kw = dict(num_dopplers=spec.num_dopplers, array_offset=spec.dopp_array_offset,
              sum_all_masks=sum_all_masks, snr_window=spec.snr_window,
              centre_freq_offset=spec.centreFreqOffset)
    got = ds.doppler_estimate_plain(E, Pt, c.shifts, c.shifts_signed, c.hz_lut, **kw)
    tail = torch.full((3, 12 + spec.D * spec.num_masks), float("nan"))
    viaw = ds.doppler_estimate(E, Pt, c.shifts, c.shifts_signed, c.hz_lut, **kw, tail=tail)
    same = dict(rtol=0, atol=0, equal_nan=True)
    for a, b in zip(got, viaw):
        torch.testing.assert_close(a, b, **same)
    torch.testing.assert_close(tail[:, 5:11], torch.stack([v.float() for v in got], dim=-1),
                               **same)
    assert torch.equal(tail[:, 12:], E.reshape(3, -1))
    for b in range(3):
        want = _jax_estimate(jspec, E[b].numpy(), P[b], sum_all_masks)
        idx, q, dhz, foff, snr, shift = (float(v[b]) for v in got)
        assert abs(idx - want[0]) <= 1e-5 * max(1.0, abs(want[0]))
        assert abs(dhz - want[2]) < 1e-2 and abs(foff - want[3]) < 1e-2
        assert int(shift) == want[5]
        for u, w in ((q, want[1]), (snr, want[4])):
            if np.isfinite(w):
                assert abs(u - w) < 1e-3
            else:
                assert (np.isnan(u) and np.isnan(w)) or u == w
    assert float(got[0][2]) == 0.0 and float(got[4][2]) == float("-inf")
    if spec.dopp_array_offset == 0:
        assert float(got[1][2]) == float("-inf")
    if variant == "dc":
        assert (c.shifts.numpy() > N // 2).any() and (c.shifts.numpy() < N // 2).any()


def test_new_wrappers_reject_other_devices():
    spec = graft.tiny_spec()
    c = DeviceConsts.from_spec(_carry(spec), "cpu")
    x = torch.zeros((1, spec.Nfft), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        dk.threshold_input(x, 4.5)
    E = torch.zeros((1, spec.D, spec.num_masks), device="meta")
    with pytest.raises(ValueError):
        ds.doppler_estimate(E, x.real, c.shifts, c.shifts_signed, c.hz_lut, num_dopplers=16,
                            array_offset=0, sum_all_masks=True, snr_window=5,
                            centre_freq_offset=0.0)
