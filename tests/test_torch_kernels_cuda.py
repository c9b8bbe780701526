"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at the test shapes (tiny Nfft 2^9 and the bench_conf 2^13).
Marked ``cuda``: they skip on a machine without a card. ``chip_smoke.py``
holds the same kernels against the same plain versions at the flagship
shape. Run on a card (which needs no JAX) with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.dsp.block import build_process_batch
from pycusdr_tpu_torch.dsp.signal_gen import modulate_fsk
from pycusdr_tpu_torch.dsp.spec import build_spec
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops import doppler_search as ds
from pycusdr_tpu_torch.protocol import loadProtocol

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["tiny", "bench"])
def case(request, cuda):
    if request.param == "tiny":
        spec = configs.tiny_spec()
    else:  # the bench_conf shape of tests/conftest.py: Nfft 2^13, D=16, W=7
        conf = configs._conf(blockSize=13, overlap=10, spsym=16, doppSteps=16)
        spec = build_spec(conf, loadProtocol("bench_FSK")(conf=conf), configs.RADIO)
    rng = np.random.RandomState(7)
    N, sps = spec.Nfft, int(spec.spsym)
    f = spec.centreFreqOffset / spec.sampleRate
    x = np.stack([modulate_fsk(rng.randint(0, 2, N // sps), sps) for _ in range(3)])
    x = x * np.exp(2j * np.pi * f * np.arange(N)) + 0.05 * (rng.randn(3, N) + 1j * rng.randn(3, N))
    x = torch.from_numpy(x.astype(np.complex64)).to(cuda)
    c = DeviceConsts.from_spec(spec, cuda)
    ref = build_process_batch(spec, device=cuda, plain=True)(x)
    return spec, c, x, ref


def test_doppler_energy(case):
    spec, c, x, _ = case
    S = torch.fft.fft(x)
    P = S.real * S.real + S.imag * S.imag
    for centre in (None, torch.tensor([0, 5, -9], dtype=torch.int32, device=x.device)):
        Ek = ds.doppler_energy(P, c.Q, c.shifts, centre)
        Ep = ds.doppler_energy_plain(P, c.Q, c.shifts, centre)
        assert float((Ek - Ep).abs().max()) <= 1e-4 * float(Ep.abs().max())


def test_mf_bank_colreduce(case):
    spec, c, x, ref = case
    S = torch.fft.fft(x)
    shift = ref["shift"].to(torch.int32)
    M = spec.num_masks
    ks, km, ka = dk.mf_bank_colreduce(S, c.masks_f, shift, 1, M - 1, tw=c.tw)
    ps, pm, pa = dk.mf_bank_colreduce_plain(S, c.masks_f, shift, 1, M - 1)
    assert float((ks - ps).abs().max()) <= 1e-4 * float(ps.abs().max())
    assert float((km - pm).abs().max()) <= 1e-4 * float(pm.abs().max())
    top2 = torch.topk(dk.mf_bank_power_plain(S, c.masks_f, shift), 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0]
    assert int(((ka != pa) & clear).sum()) == 0


def test_timing_band_and_symbol_detect(case):
    spec, c, x, ref = case
    S = torch.fft.fft(x)
    shift = ref["shift"].to(torch.int32)
    M = spec.num_masks
    colsum, colmax, colarg = dk.mf_bank_colreduce_plain(S, c.masks_f, shift, 0, M)
    sp, co, _ = dk.timing_band(colsum, spec.code_idx_lo, spec.code_idx_hi, tw=c.tw)
    psp, pco, _ = dk.timing_band_plain(colsum, spec.code_idx_lo, spec.code_idx_hi)
    assert torch.equal(sp, psp)
    assert float((co - pco).abs().max()) <= 1e-3
    kw = dict(Nfft=spec.Nfft, windowWidth=spec.windowWidth, spsymMin=spec.spsymMin,
              numSymMax=spec.numSymMax, trust_normal=c.trust_normal)
    a = dk.symbol_detect(colmax, colarg, psp, pco, c.bitLUT, **kw)
    b = dk.symbol_detect_plain(colmax, colarg, psp, pco, c.bitLUT, **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_block_graph_decisions_match_plain(case):
    spec, c, x, ref = case
    out = build_process_batch(spec, device=x.device)(x)
    assert torch.equal(out["shift"], ref["shift"])
    n = int(ref["nSym"].min())
    assert torch.equal(out["bits"][:, :n], ref["bits"][:, :n])


@pytest.mark.parametrize("N,M,D", [(512, 16, 20), (1024, 32, 7), (8192, 4, 3)])
def test_doppler_energy_mask_counts(cuda, N, M, D):
    """The 16- and 32-mask kernel variants (deep banks, xcorrMaskSize 4-5)
    and grids whose D is not a multiple of the shift tile."""
    rng = np.random.RandomState(N + M)
    P = torch.from_numpy(rng.rand(2, N).astype(np.float32)).to(cuda)
    Q = torch.from_numpy(rng.rand(M, N).astype(np.float32)).to(cuda)
    shifts = torch.from_numpy(rng.randint(0, N, D).astype(np.int32)).to(cuda)
    centre = torch.tensor([3, 5 - N], dtype=torch.int32, device=cuda)
    Ek = ds.doppler_energy(P, Q, shifts, centre)
    Ep = ds.doppler_energy_plain(P, Q, shifts, centre)
    assert float((Ek - Ep).abs().max()) <= 1e-4 * float(Ep.abs().max())


@pytest.mark.parametrize("N,M", [(4, 3), (16, 4), (2048, 5), (2 ** 17, 2), (2 ** 18, 1)])
def test_mf_bank_colreduce_sizes(cuda, N, M):
    """K2's four-step split at every corner it supports: 2^2 up to 2^18
    (STX is 2^17), odd mask counts, a mask-sum subset."""
    rng = np.random.RandomState(N + M)
    S = torch.from_numpy((rng.randn(2, N) + 1j * rng.randn(2, N)).astype(np.complex64)).to(cuda)
    masks = torch.from_numpy((rng.randn(M, N) + 1j * rng.randn(M, N))
                             .astype(np.complex64)).to(cuda)
    shift = torch.tensor([1, N - 1], dtype=torch.int32, device=cuda)
    lo, hi = (1, M - 1) if M > 2 else (0, M)
    ks, km, ka = dk.mf_bank_colreduce(S, masks, shift, lo, hi)
    ps, pm, pa = dk.mf_bank_colreduce_plain(S, masks, shift, lo, hi)
    assert float((ks - ps).abs().max()) <= 1e-4 * max(float(ps.abs().max()), 1e-30)
    assert float((km - pm).abs().max()) <= 1e-4 * float(pm.abs().max())
    if M > 1:
        top2 = torch.topk(dk.mf_bank_power_plain(S, masks, shift), 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0]
        assert int(((ka != pa) & clear).sum()) == 0


def test_process_capture_matches_process_many_on_card(cuda):
    """processCapture (device framing with unfold, dispatch cap 4 -> 4 + 2)
    gives the bits of two processMany calls on the same padded hops."""
    from pycusdr_tpu_torch.models import UHF

    conf = configs._conf(blockSize=13, overlap=10, spsym=16, doppSteps=16)
    protocol = loadProtocol("bench_FSK")(conf=conf)
    dC, dD = (UHF.Demodulator(conf, protocol, configs.RADIO) for _ in range(2))
    ov, hop, K = dC.sigOverlap, dC.Nfft - dC.sigOverlap, 6
    rng = np.random.RandomState(3)
    f = dC.spec.centreFreqOffset / dC.spec.sampleRate
    n = ov + K * hop
    sig = modulate_fsk(rng.randint(0, 2, n // 16 + 1), 16)[:n] * np.exp(2j * np.pi * f * np.arange(n))
    sig = (sig + 0.05 * (rng.randn(n) + 1j * rng.randn(n))).astype(np.complex64)
    for d in (dC, dD):
        d.get_signalBufferHostPointer()[:ov] = sig[:ov]
    capture = sig[ov : n - hop // 3]
    padded = np.zeros(K * hop, np.complex64)
    padded[: len(capture)] = capture
    seqC = dC.processCapture(capture, max_hops_per_dispatch=4)
    seqD = dD.processMany(padded[: 4 * hop].reshape(4, hop)) + dD.processMany(
        padded[4 * hop :].reshape(2, hop))
    assert len(seqC) == len(seqD) == K
    for a, b in zip(seqC, seqD):
        np.testing.assert_array_equal(a["bits"], b["bits"])
        np.testing.assert_array_equal(a["trust"], b["trust"])


# ---- slice 2: K5 doppler_estimate, K6 threshold_input, K4's clip window


def _k5_kw(spec, sum_all):
    return dict(num_dopplers=spec.num_dopplers, array_offset=spec.dopp_array_offset,
                sum_all_masks=sum_all, snr_window=spec.snr_window,
                centre_freq_offset=spec.centreFreqOffset)


def _assert_k5_close(got, want):
    """shift exact; dopp_idx within 1e-5 relative; Hz within 1e-2; quality
    and SNR within 1e-3 dB where finite, equal where not."""
    assert torch.equal(got[5], want[5])
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 * max(1.0, float(want[0].abs().max()))
    for i in (2, 3):
        assert float((got[i] - want[i]).abs().max()) < 1e-2
    for i in (1, 4):
        fin = torch.isfinite(want[i])
        assert torch.equal(fin, torch.isfinite(got[i]))
        assert float(torch.cat([(got[i] - want[i])[fin].abs(), fin.new_zeros(1)]).max()) < 1e-3
        assert torch.equal(got[i][~fin].nan_to_num(), want[i][~fin].nan_to_num())


def test_doppler_estimate(case):
    """K5 against its plain version, an all-zero block included (index 0,
    quality and SNR -inf), in both mask modes and into the row's tail."""
    spec, c, x, _ = case
    x = torch.cat([x, torch.zeros_like(x[:1])])
    S = torch.fft.fft(x)
    P = S.real * S.real + S.imag * S.imag
    E = ds.doppler_energy_plain(P, c.Q, c.shifts)
    args = (E, P, c.shifts, c.shifts_signed, c.hz_lut)
    for sum_all in (True, False):
        got = ds.doppler_estimate(*args, **_k5_kw(spec, sum_all))
        want = ds.doppler_estimate_plain(*args, **_k5_kw(spec, sum_all))
        _assert_k5_close(got, want)
        assert float(got[0][-1]) == 0.0 and float(got[1][-1]) == float("-inf")
        assert float(got[4][-1]) == float("-inf")
    L = 5 * spec.numSymMax + 12 + spec.D * spec.num_masks
    row = torch.full((4, L), float("nan"), device=x.device)
    tail = row[:, 5 * spec.numSymMax:]
    got = ds.doppler_estimate(*args, **_k5_kw(spec, spec.sum_all_masks), tail=tail)
    torch.cuda.synchronize()
    assert torch.equal(tail[:, 5:11], torch.stack([v.float() for v in got], dim=-1))
    assert torch.equal(tail[:, 12:], E.reshape(4, -1))
    assert torch.isnan(row[:, :5 * spec.numSymMax + 5]).all() and torch.isnan(tail[:, 11]).all()


def _spiky(rng, B, N):
    x = (rng.randn(B, N) + 1j * rng.randn(B, N)) / np.sqrt(2)
    for b in range(B - 1):  # the last block has no spike
        for w, at in ((8, N // 3), (1, 5), (16, N - 16)):
            x[b, at:at + w] += 60.0 * np.exp(2j * np.pi * rng.rand(w))
    return x.astype(np.complex64)


@pytest.mark.parametrize("N", [2 ** 13, 2 ** 17])
def test_threshold_input(cuda, N):
    """K6 against its plain version: masks equal except where |a - thr|
    <= 1e-5 thr (the two sum in different orders), signals where the masks
    agree (rtol 1e-5); a block alone gives the same bits as in a batch."""
    rng = np.random.RandomState(N)
    xh = _spiky(rng, 3, N)
    x = torch.from_numpy(xh).to(cuda)
    y, hits, anyk = dk.threshold_input(x, 4.5)
    yp, hp = dk.threshold_input_plain(x, 4.5)
    hk = dk.unpack_bits(hits, N)
    a = np.abs(xh.astype(np.complex128))
    thr1 = 4.5 * a.mean(axis=1, keepdims=True)
    a1 = np.minimum(a, thr1)
    thr2 = 4.5 * a1.mean(axis=1, keepdims=True)
    clear = torch.from_numpy((np.abs(a - thr1) > 1e-5 * thr1)
                             & (np.abs(a1 - thr2) > 1e-5 * thr2)).to(cuda)
    assert int((hk != hp)[clear].sum()) == 0
    assert bool(hp[0].any()) and not bool(hp[2].any())
    agree = hk == hp
    torch.testing.assert_close(torch.view_as_real(y)[agree], torch.view_as_real(yp)[agree],
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(anyk, hp.any(dim=-1).to(torch.int32))
    y1, h1, a1k = dk.threshold_input(x[1:2].contiguous(), 4.5)
    assert torch.equal(y1[0], y[1]) and torch.equal(h1[0], hits[1]) and int(a1k[0]) == int(anyk[1])


def test_symbol_detect_clip(case):
    """K4 with K6's bitmask against its plain version on the dilated mask:
    all seven outputs bit-exact; the row form writes the same values."""
    spec, c, x, ref = case
    S = torch.fft.fft(x)
    M, N, B = spec.num_masks, spec.Nfft, x.shape[0]
    colsum, colmax, colarg = dk.mf_bank_colreduce_plain(S, c.masks_f, ref["shift"], 0, M)
    sp, co, cv = dk.timing_band_plain(colsum, spec.code_idx_lo, spec.code_idx_hi)
    rng = np.random.RandomState(1)
    hit = np.zeros((B, N), bool)
    for b in range(B):
        hit[b, rng.randint(0, N, 3)] = True
    hit[0, 0] = hit[1, N - 1] = True
    hit = torch.from_numpy(hit).to(x.device)
    hits = dk.pack_bits(hit)
    kw = dict(Nfft=N, windowWidth=spec.windowWidth, spsymMin=spec.spsymMin,
              numSymMax=spec.numSymMax, trust_normal=c.trust_normal)
    a = dk.symbol_detect(colmax, colarg, sp, co, c.bitLUT, hits=hits, **kw)
    clip = dk.dilate_mask_plain(hit, dk.clip_halfwidth(sp, spec.spsymMin))
    b = dk.symbol_detect_plain(colmax, colarg, sp, co, c.bitLUT, clip_mask=clip, **kw)
    assert len(a) == len(b) == 7 and bool(b[6].any())
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    S_ = spec.numSymMax
    row = torch.full((B, 5 * S_ + 12), float("nan"), device=x.device)
    anyc = hit.any(dim=-1).to(torch.int32)
    dk.symbol_detect(colmax, colarg, sp, co, c.bitLUT, hits=hits, row=row, code_val=cv,
                     clipped_any=anyc, **kw)
    for i, t in enumerate((b[3], b[4], b[0], b[1], b[2])):
        assert torch.equal(row[:, i * S_:(i + 1) * S_], t.float())
    sc = row[:, 5 * S_:]
    for i, t in ((0, b[5]), (1, b[5]), (2, sp), (3, co), (4, cv), (11, anyc)):
        assert torch.equal(sc[:, i], t.float())
    assert torch.isnan(sc[:, 5:11]).all()


@pytest.fixture(scope="module")
def stx_case(cuda):
    """The STX mode at Nfft 2^13 (W=3, D=1, clipping at 4.5), three
    blocks, a burst in block 1."""
    conf = configs._conf(blockSize=13, overlap=10, spsym=16, doppSteps=1, windowWidth=3)
    conf["Radios"]["Rx"][configs.RADIO].update(radioBackend="STX",
                                               disablePeakThresholding=False)
    conf["GPU"]["UHF"]["peakThresholdScale"] = 4.5
    spec = build_spec(conf, loadProtocol("bench_FSK")(conf=conf), configs.RADIO)
    rng = np.random.RandomState(9)
    N = spec.Nfft
    f = spec.centreFreqOffset / spec.sampleRate
    x = np.stack([modulate_fsk(rng.randint(0, 2, N // 16), 16) for _ in range(3)])
    x = x * np.exp(2j * np.pi * f * np.arange(N)) + 0.05 * (rng.randn(3, N) + 1j * rng.randn(3, N))
    x[1, N // 2:N // 2 + 8] += 300.0
    return spec, torch.from_numpy(x.astype(np.complex64)).to(cuda)


def test_stx_graph_decisions_match_plain(stx_case):
    """The STX graph's kernels (K6, K2 at the fixed shift, K3, K4 with the
    clip window) against the plain path on the card."""
    spec, x = stx_case
    out = build_process_batch(spec, device=x.device)(x)
    ref = build_process_batch(spec, device=x.device, plain=True)(x)
    assert torch.equal(out["shift"], ref["shift"].contiguous())
    assert torch.equal(out["clipped_any"], ref["clipped_any"])
    assert out["clipped_any"].tolist() == [False, True, False]
    assert not out["E"].any() and not out["dopp_idx"].any() and not out["snr_db"].any()
    n = int(ref["nSym"].min())
    assert torch.equal(out["bits"][:, :n], ref["bits"][:, :n])
    assert torch.equal(out["trust"][:, :n], ref["trust"][:, :n])
    assert bool((out["trust"][1, :n] == -2).any())


@pytest.mark.parametrize("variant", ["noise_bin", "dc"])
def test_doppler_estimate_grids(cuda, variant):
    """K5's other grid branches against its plain version: a noise bin
    leading the grid (offset 1: quality against it; an all-zero block's
    quality is 0/0 = NaN, as in JAX) and a grid straddling DC (the shift
    interpolated on unwrapped bins)."""
    conf = configs._conf(blockSize=13, overlap=10, spsym=16, doppSteps=16)
    radio = conf["Radios"]["Rx"][configs.RADIO]
    if variant == "noise_bin":
        radio["noise_measure_offset_Hz"] = -60000.0
    else:
        radio["frequencyOffset_Hz"] = 0.0
    spec = build_spec(conf, loadProtocol("bench_FSK")(conf=conf), configs.RADIO)
    c = DeviceConsts.from_spec(spec, cuda)
    N = spec.Nfft
    rng = np.random.RandomState(5)
    f = (spec.centreFreqOffset + np.array([[-2500.0], [900.0], [0.0]])) / spec.sampleRate
    x = np.stack([modulate_fsk(rng.randint(0, 2, N // 16), 16) for _ in range(3)])
    x = x * np.exp(2j * np.pi * f * np.arange(N)) + 0.1 * (rng.randn(3, N) + 1j * rng.randn(3, N))
    x[2] = 0
    S = torch.fft.fft(torch.from_numpy(x.astype(np.complex64)).to(cuda))
    P = S.real * S.real + S.imag * S.imag
    E = ds.doppler_energy_plain(P, c.Q, c.shifts)
    args = (E, P, c.shifts, c.shifts_signed, c.hz_lut)
    for sum_all in (True, False):
        got = ds.doppler_estimate(*args, **_k5_kw(spec, sum_all))
        want = ds.doppler_estimate_plain(*args, **_k5_kw(spec, sum_all))
        _assert_k5_close(got, want)
    if variant == "noise_bin":
        assert spec.dopp_array_offset == 1 and torch.isnan(got[1][2])
    else:
        sh = c.shifts.cpu().numpy()
        assert (sh > N // 2).any() and (sh < N // 2).any()


def test_symbol_detect_clip_halfwidth_clamp(case):
    """K4's clip half width 2 ceil(spc) at its edges: spSym below spsymMin
    (spc clamps up) and far above it (hw clamps to 2048), on random
    magnitudes, bit-exact against the plain dilation + detection."""
    spec, c, x, _ = case
    B, N = x.shape
    rng = np.random.RandomState(2)
    colmax = torch.from_numpy(rng.rand(B, N).astype(np.float32)).to(x.device)
    colarg = torch.from_numpy(rng.randint(0, spec.num_masks, (B, N)).astype(np.int32)).to(x.device)
    sp = torch.tensor([0.5, 1500.0, float(spec.spsym)][:B], device=x.device)
    co = torch.tensor([0.3, 7.9, -0.6][:B], device=x.device)
    hit = torch.zeros((B, N), dtype=torch.bool, device=x.device)
    hit[:, N // 2] = True
    kw = dict(Nfft=N, windowWidth=spec.windowWidth, spsymMin=spec.spsymMin,
              numSymMax=spec.numSymMax, trust_normal=c.trust_normal)
    a = dk.symbol_detect(colmax, colarg, sp, co, c.bitLUT, hits=dk.pack_bits(hit), **kw)
    hw = dk.clip_halfwidth(sp, spec.spsymMin)
    assert int(hw[1]) > dk.CLIP_HW_MAX
    b = dk.symbol_detect_plain(colmax, colarg, sp, co, c.bitLUT,
                               clip_mask=dk.dilate_mask_plain(hit, hw), **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
