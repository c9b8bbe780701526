"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at the test shapes (tiny Nfft 2^9 and the bench_conf 2^13; K7
on ragged batches at the chunk edges, up to T=2144 and S=129, and the
ViterbiStream at one launch a feed; the bench_BPSK graph at the tiny
shape; K8 on
random rows and in the group graph; K9 at every fused M from 1 to 1024
at K = 1, 8 and 32 (ragged, T < K - 1 with a carry, T = 2^16), the wide
form, one launch a fused call; K1 and K5 with
``centre_shift``; K8 with ``master_idx``; the channel-parallel step; K4l
and K4s on one and two shards, K4s with the clip window, K8 without its
pad mask, and the generic step (also on bench_BPSK at the bench_conf
shape); K2 at M=16 and 32, B=1 and 64, and K3 at
every N from 2^2 to 2^18 at the band edges, with zero and NaN rows; K1 at
33, 64 and 128 masks; K5 with planted ties, grids of 2048 and 3000 entries,
1 to 128 masks and noise alone in its SNR bands; K4 at B=64 on six window
shapes, each block alone; K6 at every form of its plan, at N not a multiple
of 32 and above 2^18, equal bit for bit to the numpy model of its order; K4
and K4s with a partial last clip word; K2 and K3 at 2^19 and 2^20; K4's
NRZ-S form (K4n in K4's launch) against its plain version at the
bench_BPSK shape, S from 1 to 36480, B = 1/16/64, with a clip bitmask, the
sample-by-sample form and LUTs of 64 and 256 KB; K8 at C = 1 to 256, S =
1/31/4608, with and without its pad mask; K4l in every plan, on unaligned
rows and a window wider than 9 samples; K4s in every plan at nd = 1/2/4,
with and without a clip bitmask, hw near its clamp, with a centre-bit LUT
and in its NRZ-S form (K4n in K4s's launch) with bench_BPSK's LUT and LUTs
of 64 and 256 KB); K1-K5 at the CC11xx station's shape (Nfft 2^16, 128
samples a symbol) at B = 1/16/64, each block alone.
Marked ``cuda``: they skip on a machine without a card. ``chip_smoke.py``
holds the same kernels against the same plain versions at the flagship
shape. Run on a card (which needs no JAX) with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.dsp.block import build_process_batch, packed_len
from pycusdr_tpu_torch.dsp.signal_gen import modulate_bpsk, modulate_fsk
from pycusdr_tpu_torch.dsp.spec import build_spec
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops import doppler_search as ds
from pycusdr_tpu_torch.ops import viterbi as vit
from pycusdr_tpu_torch.parallel import build_sharded_demod_step, make_mesh
from pycusdr_tpu_torch.parallel import channelizer as pch
from pycusdr_tpu_torch.parallel import vote as pv
from pycusdr_tpu_torch.protocol import loadProtocol
from pycusdr_tpu_torch.runtime.channel_group_process import build_group_graph

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


#: (N, M, D, grid, B, the paths it must take: "window", "global" or "both")
K1_GRIDS = [(512, 16, 20, "random", 2, "window"), (1024, 32, 7, "random", 2, "window"),
            (8192, 4, 3, "random", 2, "window"), (512, 16, 1, "random", 64, "window"),
            (999, 1, 3, "random", 2, "window"), (1000, 5, 3, "random", 64, "window"),
            (4096, 32, 129, "random", 2, "window"), (2 ** 16, 5, 129, "compact", 2, "window"),
            (2 ** 17, 32, 3, "compact", 2, "window"), (2 ** 17, 8, 129, "mixed", 2, "both"),
            (2 ** 16, 8, 64, "compact", 64, "window"), (2 ** 18, 5, 3, "random", 2, "global"),
            (2 ** 18, 1, 129, "random", 2, "both")]


def _k1_grid(N, D, grid, rng):
    """D shifts of kind ``grid``: anywhere on the circle, 3 bins apart, or 64
    shifts 7 bins apart and the rest spread over half the circle."""
    if grid == "random":
        return rng.randint(0, N, D)
    if grid == "compact":
        return (rng.randint(0, N) + 3 * np.arange(D)) % N
    h = min(64, D // 2)
    return np.r_[7 * np.arange(h), N // 8 + (N // 2 // (D - h)) * np.arange(D - h)]


@pytest.mark.parametrize("N,M,D,grid,B,path", K1_GRIDS)
def test_doppler_energy_mask_counts(cuda, N, M, D, grid, B, path):
    """The 8-, 16- and 32-mask kernel variants (deep banks, xcorrMaskSize
    4-5), grids whose D is not a multiple of the shift tile, N from 512 to
    2^18, grids whose arc takes the window, the global-read path or both,
    B = 2 and 64, recentred off the circle and not: within 1e-4 of max|E|,
    two runs equal, each block alone equal to its row of the batch."""
    rng = np.random.RandomState(N + M + D)
    P = torch.from_numpy(rng.rand(B, N).astype(np.float32)).to(cuda)
    Q = torch.from_numpy(rng.rand(M, N).astype(np.float32)).to(cuda)
    shifts = torch.from_numpy(_k1_grid(N, D, grid, rng).astype(np.int32)).to(cuda)
    centre = torch.tensor(([3, 5 - N] * B)[:B], dtype=torch.int32, device=cuda)
    for cs in (centre, None):
        Ek = ds.doppler_energy(P, Q, shifts, cs)
        Ep = ds.doppler_energy_plain(P, Q, shifts, cs)
        assert float((Ek - Ep).abs().max()) <= 1e-4 * float(Ep.abs().max())
        assert torch.equal(Ek, ds.doppler_energy(P, Q, shifts, cs))
        for b in range(B):
            one = ds.doppler_energy(P[b:b + 1], Q, shifts, None if cs is None else cs[b:b + 1])
            assert torch.equal(one[0], Ek[b])
    plan = ds.doppler_energy_plan(shifts.cpu().numpy(), N, M)
    nw, ng = plan.window_groups(shifts.cpu().numpy()), len(plan.group_arcs(shifts.cpu().numpy()))
    assert {"window": nw == ng, "global": nw == 0, "both": 0 < nw < ng}[path], (nw, ng)


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


@pytest.mark.parametrize("M", [16, 32])
@pytest.mark.parametrize("B", [1, 64])
def test_mf_bank_colreduce_batches(cuda, B, M):
    """K2 at bench_BPSK's 16 masks and at 32, B=1 and 64, on a mask-sum
    subset, at the flagship Nfft 2^16: within 1e-4 of the plain version,
    and each block's bits equal to that block alone (the plan's rows per
    block change with B, the arithmetic does not)."""
    N = 2 ** 16
    rng = np.random.RandomState(B + M)
    S = torch.from_numpy((rng.randn(B, N) + 1j * rng.randn(B, N)).astype(np.complex64)).to(cuda)
    masks = torch.from_numpy((rng.randn(M, N) + 1j * rng.randn(M, N))
                             .astype(np.complex64)).to(cuda)
    shift = torch.from_numpy(rng.randint(0, N, B).astype(np.int32)).to(cuda)
    lo, hi = 2, M - 3
    ks, km, ka = dk.mf_bank_colreduce(S, masks, shift, lo, hi)
    ps, pm, pa = dk.mf_bank_colreduce_plain(S, masks, shift, lo, hi)
    assert float((ks - ps).abs().max()) <= 1e-4 * float(ps.abs().max())
    assert float((km - pm).abs().max()) <= 1e-4 * float(pm.abs().max())
    top2 = torch.topk(dk.mf_bank_power_plain(S, masks, shift), 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0]
    assert int(((ka != pa) & clear).sum()) == 0
    b = B - 1
    one = dk.mf_bank_colreduce(S[b:].contiguous(), masks, shift[b:].contiguous(), lo, hi)
    for u, v in zip(one, (ks, km, ka)):
        assert torch.equal(u[0], v[b])


@pytest.mark.parametrize("N", [2 ** 19, 2 ** 20])
def test_bank_and_band_above_2_18(cuda, N):
    """K2 (the middle passes) and K3 above 2^18 against their plain
    versions, two blocks, each alone equal to its row."""
    rng = np.random.RandomState(N % 1009)
    M = 3
    S = torch.from_numpy((rng.randn(2, N) + 1j * rng.randn(2, N)).astype(np.complex64)).to(cuda)
    masks = torch.from_numpy((rng.randn(M, N) + 1j * rng.randn(M, N))
                             .astype(np.complex64)).to(cuda)
    shift = torch.tensor([3, N - 7], dtype=torch.int32, device=cuda)
    ks, km, ka = dk.mf_bank_colreduce(S, masks, shift, 1, M)
    ps, pm, pa = dk.mf_bank_colreduce_plain(S, masks, shift, 1, M)
    assert float((ks - ps).abs().max()) <= 1e-4 * float(ps.abs().max())
    assert float((km - pm).abs().max()) <= 1e-4 * float(pm.abs().max())
    top2 = torch.topk(dk.mf_bank_power_plain(S, masks, shift), 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0]
    assert int(((ka != pa) & clear).sum()) == 0
    one = dk.mf_bank_colreduce(S[1:].contiguous(), masks, shift[1:].contiguous(), 1, M)
    assert all(torch.equal(u[0], v[1]) for u, v in zip(one, (ks, km, ka)))
    kt = N // 16 + 5
    n = np.arange(N)
    x = np.stack([0.2 * rng.randn(N) + np.cos(2 * np.pi * kt * n / N + 0.7),
                  rng.randn(N)]).astype(np.float32)
    x = torch.from_numpy(x).to(cuda)
    for lo, hi in ((N // 32, N // 8), (kt - 3, kt + 40)):
        sp, co, cv = dk.timing_band(x, lo, hi)
        psp, pco, pcv = dk.timing_band_plain(x, lo, hi)
        assert torch.equal(sp, psp), (sp.tolist(), psp.tolist())
        assert float((cv - pcv).abs().max()) <= 1e-4 * float(pcv.abs().max())
        assert abs(float(co[0] - pco[0])) <= 1e-3
        one = dk.timing_band(x[1:].contiguous(), lo, hi)
        assert all(torch.equal(u[0], v[1]) for u, v in zip(one, (sp, co, cv)))


def test_clip_bitmask_partial_last_word(cuda):
    """K4 and K4s with K6's bitmask at N = 1000 (a partial last word, hits
    on its last sample) against their plain versions."""
    N, S, B, M = 1000, 500, 2, 4
    rng = np.random.RandomState(1000)
    colmax = torch.from_numpy(rng.rand(B, N).astype(np.float32)).to(cuda)
    colarg = torch.from_numpy(rng.randint(0, M, (B, N)).astype(np.int32)).to(cuda)
    sp = torch.tensor([4.0, 5.5], device=cuda)
    co = torch.tensor([1.3, 0.2], device=cuda)
    hit = torch.zeros((B, N), dtype=torch.bool)
    hit[0, [0, N - 1]] = True
    hit[1, N - 3] = True
    hit = hit.to(cuda)
    hits = dk.pack_bits(hit)
    lut = torch.tensor([0, 1, 1, 0], dtype=torch.int8, device=cuda)
    kw = dict(Nfft=N, windowWidth=3, spsymMin=2, numSymMax=S, trust_normal=2)
    a = dk.symbol_detect(colmax, colarg, sp, co, lut, hits=hits, **kw)
    clip = dk.dilate_mask_plain(hit, dk.clip_halfwidth(sp, 2))
    b = dk.symbol_detect_plain(colmax, colarg, sp, co, lut, clip_mask=clip, **kw)
    assert bool(b[6][:, -10:].any())
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    kl = {k: v for k, v in kw.items() if k != "trust_normal"}
    val, key = dk.symbol_detect_local(colmax, colarg, sp, co, m0=0, M=M, **kl)
    rows = [torch.zeros((B, 5 * S + 12), device=cuda) for _ in range(2)]
    k4s = dict(kw, M=M, code_val=torch.zeros(B, device=cuda), hits=hits)
    dk.shard_select(dk.pack_pairs(val, key)[None], sp, co, lut, row=rows[0], **k4s)
    dk.shard_select_rows_plain(val[None], key[None], sp, co, lut, row=rows[1], **k4s)
    torch.cuda.synchronize()
    assert torch.equal(rows[0], rows[1])


def _band_kinds(N):
    """Bands from bin 0, up to N/2+1, one bin wide, and across K3's tile
    boundary k = n1 (tests/test_torch_fft_plan.py holds the model)."""
    n1 = dk.timing_band_plan(N)["n1"]
    half = N // 2 + 1
    edge = min(n1, half - 1)
    return {"lo0": (0, min(half, 40)), "top": (max(half - 40, 0), half),
            "one": (half // 3, half // 3 + 1),
            "straddle": (max(edge - 3, 0), min(edge + 5, half))}


@pytest.mark.parametrize("kind", ["lo0", "top", "one", "straddle"])
@pytest.mark.parametrize("N", [2 ** e for e in range(2, 19)])
def test_timing_band_sizes(cuda, N, kind):
    """K3 at every N it takes and at the band edges: a tone at a band bin
    under noise (spSym exact, code_val within 1e-4, codeOffset within 1e-3
    where the phase is clear of its wraps at 0 and ±π, and finite where
    the plain one is), an all-zero row (the first
    bin, code_val 0) and a NaN row (bin 0); each row alone gives its bits
    in the batch."""
    lo, hi = _band_kinds(N)[kind]
    rng = np.random.RandomState(N % 1009 + len(kind))
    kt = (lo + hi - 1) // 2
    n = np.arange(N)
    x = np.stack([0.2 * rng.randn(N) + np.cos(2 * np.pi * kt * n / N + 0.7),
                  rng.randn(N), np.zeros(N), np.full(N, np.nan)]).astype(np.float32)
    x = torch.from_numpy(x).to(cuda)
    sp, co, cv = dk.timing_band(x, lo, hi)
    psp, pco, pcv = dk.timing_band_plain(x, lo, hi)
    assert torch.equal(sp[:2], psp[:2]), (sp.tolist(), psp.tolist())
    assert float(sp[2]) == float(np.float32(N) / np.float32(lo)) and float(cv[2]) == 0.0
    assert float(sp[3]) == float(psp[3]) == float(np.float32(N) / np.float32(lo))
    assert float((cv[:2] - pcv[:2]).abs().max()) <= 1e-4 * float(pcv[:2].abs().max())
    R = torch.fft.rfft(x[:2].double())[:, lo:hi]
    k = torch.argmax(R.abs(), dim=1)
    phase = torch.angle(R.gather(1, k[:, None]))[:, 0].abs().cpu()
    # codeOffset wraps where the phase crosses 0 (and ±π): compare away from both
    clear = (phase > 1e-3) & (phase < np.pi - 1e-3) & torch.isfinite(pco[:2]).cpu()
    d = (co[:2] - pco[:2]).abs().cpu()
    assert float(torch.where(clear, d, torch.zeros_like(d)).max()) <= 1e-3
    assert torch.equal(torch.isfinite(co), torch.isfinite(pco))
    for b in range(4):
        one = dk.timing_band(x[b:b + 1].contiguous(), lo, hi)
        assert all(torch.equal(u[0].nan_to_num(), v[b].nan_to_num())
                   for u, v in zip(one, (sp, co, cv)))


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
    spikes = ((8, N // 3), (1, 5), (16, N - 16)) if N >= 64 else ((1, N // 2),)
    for b in range(B - 1):  # the last block has no spike
        for w, at in spikes:
            x[b, at:at + w] += 60.0 * np.exp(2j * np.pi * rng.rand(w))
    return x.astype(np.complex64)


#: K6's forms: the cluster form at one chunk (N < 4096, not a multiple of
#: 32 among them), 2, 32 (STX), 33 and 64 chunks; the long form above 2^18
K6_NS = [1, 5, 48, 4097, 2 ** 13, 2 ** 17, 33 * 4096 + 7, 2 ** 18, 2 ** 19 + 3]


@pytest.mark.parametrize("N", K6_NS)
def test_threshold_input(cuda, N):
    """K6 against its plain version: masks equal except where |a - thr|
    <= 1e-5 thr (the two sum in different orders), signals where the masks
    agree (rtol 1e-5); a block alone gives the same bits as in a batch; the
    thresholds, y and hit words equal the numpy model of the kernel's order
    (``tests/test_torch_threshold_plan.py``) bit for bit."""
    from test_torch_threshold_plan import clip_model, parent_thresholds

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
    if N > 1:
        assert bool(hp[0].any()) and not bool(hp[2].any())
    agree = hk == hp
    torch.testing.assert_close(torch.view_as_real(y)[agree], torch.view_as_real(yp)[agree],
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(anyk, hp.any(dim=-1).to(torch.int32))
    y1, h1, a1k = dk.threshold_input(x[1:2].contiguous(), 4.5)
    assert torch.equal(y1[0], y[1]) and torch.equal(h1[0], hits[1]) and int(a1k[0]) == int(anyk[1])
    for b in range(3):
        ym, hm = clip_model(xh[b], *parent_thresholds(xh[b], 4.5))
        assert np.array_equal(y[b].cpu().numpy(), ym.astype(np.complex64))
        assert torch.equal(hits[b].cpu(), dk.pack_bits(torch.from_numpy(hm)[None])[0])


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


def viterbi_symbols(kind, S, Tmax, seed):
    """(S, Tmax, 2) f32 received symbols of random coded bits: hard bits
    with 4% flips, soft ±1 with flips and erasures (0), or soft ±1 plus
    Gaussian noise."""
    rng = np.random.RandomState(seed)
    sym = vit.conv_encode(rng.randint(0, 2, S * Tmax - 6)).reshape(S, Tmax, 2)
    if kind == "hard":
        return (sym ^ (rng.rand(S, Tmax, 2) < 0.04)).astype(np.float32)
    x = sym.astype(np.float32) * 2 - 1
    if kind == "soft_pm1":
        x[rng.rand(S, Tmax, 2) < 0.03] *= -1
        x[rng.rand(S, Tmax, 2) < 0.1] = 0.0
        return x
    return (x + 0.8 * rng.randn(S, Tmax, 2)).astype(np.float32)


#: K7's ragged batches: lengths around the 32-step chunk edges (and 0), the
#: one launch of a ccsds feed (the two node-sync pairings and the decode
#: buffer), and 64 and 129 sequences (16 and 33 blocks of four warps)
VIT_EDGES = [0, 1, 31, 32, 33, 63, 65, 2144]
VIT_LENGTHS = {"edges": VIT_EDGES, "mixed": [300, 0, 1, 31, 32, 33, 257],
               "feed": [2016, 2015, 2144], "S64": (VIT_EDGES * 8)[::-1],
               "S129": (VIT_EDGES * 17)[:129]}


@pytest.mark.parametrize("lengths", list(VIT_LENGTHS))
@pytest.mark.parametrize("decode", [True, False])
@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("kind", ["hard", "soft_pm1", "soft_float"])
def test_viterbi_sweep(cuda, kind, terminated, decode, lengths):
    """K7 against its plain version on ragged batches (VIT_LENGTHS): bits
    equal, metrics equal (random-float soft: within 1e-6 relative)."""
    lengths = VIT_LENGTHS[lengths]
    x = torch.from_numpy(viterbi_symbols(kind, len(lengths), max(lengths), 11)).to(cuda)
    kw = dict(soft=kind != "hard", terminated=terminated, decode=decode)
    before = vit.viterbi_sweep.launches
    bk, mk = vit.viterbi_sweep(x, lengths, **kw)
    assert vit.viterbi_sweep.launches == before + 1
    bp, mp = vit.viterbi_sweep_plain(x, lengths, **kw)
    torch.cuda.synchronize()
    if kind == "soft_float":
        assert torch.allclose(mk, mp, rtol=1e-6, atol=0)
    else:
        assert torch.equal(mk, mp)
    if decode:
        assert torch.equal(bk, bp)
    else:
        assert bk is None and bp is None


def test_viterbi_long_sequence(cuda):
    """One sequence of 2^13 steps beside a short one: bits and metric equal."""
    x = torch.from_numpy(viterbi_symbols("soft_pm1", 2, 2 ** 13, 12)).to(cuda)
    kw = dict(soft=True, terminated=False, decode=True)
    for a, b in zip(vit.viterbi_sweep(x, [2 ** 13, 100], **kw),
                    vit.viterbi_sweep_plain(x, [2 ** 13, 100], **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("soft", [False, True])
def test_viterbi_stream_kernel_matches_plain(cuda, soft):
    """ViterbiStream on the card through K7 and with ``plain=True`` give
    the same bits and state after every feed, through a one-symbol slip;
    each feed launches K7 at most once (once when it holds 64 symbols)."""
    x = viterbi_symbols("soft_pm1" if soft else "hard", 1, 3000, 13).reshape(-1)
    x = np.r_[x[:2501], x[2502:]]
    a = vit.ViterbiStream(soft=soft, device=cuda)
    b = vit.ViterbiStream(soft=soft, device=cuda, plain=True)
    pos = 0
    for n in (3, 30, 700, 1, 1300, 901, 2100, 64, 900):
        before = vit.viterbi_sweep.launches
        ya = a.feed(x[pos:pos + n])
        launched = vit.viterbi_sweep.launches - before
        assert launched == 1 if n >= 64 else launched <= 1
        yb = b.feed(x[pos:pos + n])
        pos += n
        assert np.array_equal(ya, yb) and a.parity == b.parity
        assert np.array_equal(a.carry, b.carry) and np.array_equal(a.pending, b.pending)


@pytest.fixture(scope="module")
def bpsk_case(cuda):
    """bench_BPSK at the tiny shape (Nfft 2^9, 16 masks of 4 bits, the
    (8, 2, 2) NRZ-S LUT): the block graph's rows of 4 blocks, bits, trust
    and nBits overwritten, trust -2 on every 5th slot, the last block's
    symbols random in [-1, 16]."""
    conf = configs._conf(blockSize=9, overlap=7, spsym=8, doppSteps=16, windowWidth=5,
                         maskSize=4)
    conf["Main"]["protocols"] = {"UHF": "bench_BPSK"}
    spec = build_spec(conf, loadProtocol("bench_BPSK")(conf=conf), configs.RADIO)
    rng = np.random.RandomState(8)
    N, S = spec.Nfft, spec.numSymMax
    x = np.stack([modulate_bpsk(rng.randint(0, 2, N // 8), 8)[:N] for _ in range(4)])
    x = x * np.exp(2j * np.pi * spec.centreFreqOffset / spec.sampleRate * np.arange(N))
    x = x + 0.05 * (rng.randn(4, N) + 1j * rng.randn(4, N))
    rows = build_process_batch(spec, device=cuda, packed=True)(x.astype(np.complex64))
    rows[-1, 2 * S:3 * S] = torch.from_numpy(rng.randint(-1, 17, S).astype(np.float32))
    rows[:, :S], rows[:, S:2 * S], rows[:, 5 * S + 1] = 9.0, 4.0, -3.0
    rows[:, S:2 * S:5] = -2.0
    return spec, DeviceConsts.from_spec(spec, cuda), rows


def test_bpsk_graph_decisions_match_plain(bpsk_case, cuda):
    spec, c, rows = bpsk_case
    x = torch.from_numpy(np.random.RandomState(2).randn(2, spec.Nfft).astype(np.complex64))
    x = x.to(cuda)
    got = build_process_batch(spec, device=cuda)(x)
    want = build_process_batch(spec, device=cuda, plain=True)(x)
    for k in ("bits", "trust", "symbols", "nSym", "nBits"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("C", [1, 2, 3, 7, 64])
def test_vote(cuda, C):
    """K8 against the plain vote on random rows (trust in {-2..127}, ragged
    nBits): masked rows and the voted pair equal."""
    S, L = 300, 5 * 300 + 12 + 8
    rng = np.random.RandomState(C)
    rows = np.zeros((C, L), np.float32)
    rows[:, :S] = rng.randint(0, 2, (C, S))
    rows[:, S:2 * S] = rng.choice([-2, -1, 0, 1, 2, 3, 5, 127], (C, S))
    rows[:, 5 * S + 1] = rng.randint(S // 2, S + 1, C)
    rows = torch.from_numpy(rows).to(cuda)
    rk, rp = rows.clone(), rows.clone()
    ok = pv.vote_rows(rk, S, 1.2)
    op = pv.vote_rows_plain(rp, S, 1.2, torch.empty((2, S), device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(rk, rp) and torch.equal(ok, op)


def test_group_graph_matches_plain(case, cuda):
    """The group vector (rows + voted pair) of the kernel path against the
    plain path on three channels: decisions and the vote equal."""
    spec, c, x, _ = case
    L, S = packed_len(spec), spec.numSymMax
    got = build_group_graph(spec, 3, 1.2, device=cuda)(x)
    want = build_group_graph(spec, 3, 1.2, device=cuda, plain=True)(x)
    for ch in range(3):
        assert torch.equal(got[ch * L:ch * L + 4 * S], want[ch * L:ch * L + 4 * S])
    assert torch.equal(got[3 * L:], want[3 * L:])


# ---- slice 5: K9 channelize, K5 and K1 with centre_shift, K8 with master_idx


def _k9_t(M, K, kind):
    """T of a K9 card case: "ragged" (three tiles of the plan and 7 rows),
    "short" (T < K - 1 where K allows, so the carry mixes old state and x;
    one row at K <= 2), "full" (2^16)."""
    if kind == "full":
        return 2 ** 16
    if kind == "short":
        return max(1, K - 3)
    plan = pch.k9_plan(M, K)
    return 3 * plan["TT"] + 7 if plan["form"] != "wide" else 21


#: the fused form at every row split (G x V) from M = 1 to 1024 and both forms
#: of k9_plan ("direct" at (1024, 8) and (1024, 32)), each T kind
K9_CARD = [(M, K, _k9_t(M, K, kind)) for M in (1, 2, 4, 8, 64, 256, 1024) for K in (1, 8, 32)
           for kind in ("ragged", "short", "full")]


@pytest.mark.parametrize("M,K,T", [(64, 8, 4096), (8, 4, 1001), (1024, 32, 40), (1, 3, 7),
                                   (2048, 8, 16), (64, 40, 64), (4096, 2, 8), (16384, 8, 5),
                                   (64, 40, 16), (32768, 3, 4)] + K9_CARD)
@pytest.mark.parametrize("with_state", [True, False])
def test_channelize(cuda, M, K, T, with_state):
    """K9 against its plain version: y within 1e-5 of max|y| (the DFT in
    registers against cuFFT), the carry equal (written by the fused kernel);
    a ragged last tile, T < K - 1 (the carry holds old state rows), T = 2^16,
    every fused M from 1 to 1024 at K = 1, 8 and 32 (both plan forms), the
    wide form at (2048, 8), (64, 40), (4096, 2), the largest M (16384) and T
    < K - 1, and the split form (32768, 3); the stream split in halves
    through the carry within 1e-5 of one call, the carry after them
    equal."""
    rng = np.random.RandomState(M + K + T)
    x = torch.from_numpy((rng.randn(T * M) + 1j * rng.randn(T * M)).astype(np.complex64)).to(cuda)
    h2 = torch.from_numpy(rng.randn(K, M).astype(np.float32)).to(cuda)
    st = (torch.from_numpy((rng.randn(K - 1, M) + 1j * rng.randn(K - 1, M)).astype(np.complex64))
          .to(cuda) if with_state else None)
    yk, sk = pch.channelize(x, h2, st)
    yp, sp = pch.channelize_plain(x, h2, st)
    torch.cuda.synchronize()
    assert float((yk - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    assert torch.equal(sk, sp)
    if T >= 2:
        h = T // 2 * M
        y1, s1 = pch.channelize(x[:h], h2, st)
        y2, s2 = pch.channelize(x[h:], h2, s1)
        torch.cuda.synchronize()
        assert float((torch.cat([y1, y2], 1) - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
        assert torch.equal(s2, sp)


def _k9w_cases():
    """The wide form at every row of its table: K = 2, 33 and one past the
    row's span stage (the rows stage), T a ragged three tiles and T < K - 1."""
    out = []
    for M, (NT, MB, TT, C, TR, KS) in pch.k9_wide_layouts().items():
        for K in sorted({2, 33, KS + 1}):
            out += [(M, K, 3 * TT + 7), (M, K, max(1, K - 3))]
    return out


@pytest.mark.parametrize("M,K,T", _k9w_cases())
def test_channelize_wide_every_row(cuda, M, K, T):
    """K9's wide kernel forced at every M of its table, in the span and the
    rows stage, against the plain version with a random carry: y within 1e-5
    of max|y|, the carry equal, two halves through the carry within 1e-5."""
    rng = np.random.RandomState(M + K + T)
    x = torch.from_numpy((rng.randn(T * M) + 1j * rng.randn(T * M)).astype(np.complex64)).to(cuda)
    h2 = torch.from_numpy(rng.randn(K, M).astype(np.float32)).to(cuda)
    st = torch.from_numpy((rng.randn(K - 1, M) + 1j * rng.randn(K - 1, M))
                          .astype(np.complex64)).to(cuda)
    yk, sk = pch.channelize_wide(x, h2, st)
    yp, sp = pch.channelize_plain(x, h2, st)
    torch.cuda.synchronize()
    assert float((yk - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    assert torch.equal(sk, sp)
    if T >= 2:
        h = T // 2 * M
        y1, s1 = pch.channelize_wide(x[:h], h2, st)
        y2, s2 = pch.channelize_wide(x[h:], h2, s1)
        torch.cuda.synchronize()
        assert float((torch.cat([y1, y2], 1) - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
        assert torch.equal(s2, sp)


@pytest.mark.parametrize("M,K", [(64, 8), (4, 8), (1024, 8), (2048, 8), (64, 40), (4096, 2)])
def test_channelize_one_launch(cuda, M, K):
    """A K9 call in the fused form (the wideband shape, the vote's, a
    direct-form one) or the wide form ((2048, 8), (64, 40), (4096, 2)) is
    one launch of its kernel and nothing else on the card: no FFT, no
    transpose, no copy of the carry (torch.profiler); ``channelize``'s
    counter counts one, ``channelize_wide``'s one for the wide form."""
    T = 2 ** 12
    x = torch.randn(T * M, dtype=torch.complex64, device=cuda)
    ch = pch.Channelizer(M, K, device=cuda)
    st = torch.randn(K - 1, M, dtype=torch.complex64, device=cuda)
    ch(x, st)
    torch.cuda.synchronize()
    wide = pch.k9_plan(M, K)["form"] == "wide"
    before = pch.channelize.launches, pch.channelize_wide.launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ch(x, st)
        torch.cuda.synchronize()
    assert (pch.channelize.launches, pch.channelize_wide.launches) == (
        before[0] + 1, before[1] + wide)
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    name = "channelize_wide<" if wide else "channelize<"
    assert [e.count for e in ev] == [1] and name in ev[0].key, [(e.key, e.count) for e in ev]


def test_channelize_halves_equal_one_shot(cuda):
    """Two half hops through the card's Channelizer with the carried state
    give the one-shot hop (same kernel, same rows: equal)."""
    M, T = 64, 2048
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randn(T * M) + 1j * rng.randn(T * M)).astype(np.complex64)).to(cuda)
    ch = pch.Channelizer(M, device=cuda)
    one, st = ch(x)
    halves = torch.cat([ch.process(x[:T * M // 2]), ch.process(x[T * M // 2:])], dim=1)
    torch.cuda.synchronize()
    assert torch.equal(halves, one) and torch.equal(ch.state, st)


@pytest.mark.parametrize("sum_all", [True, False])
def test_doppler_estimate_centre_shift(case, sum_all):
    """K1 and K5 with a runtime recentre (0, positive, negative, wrapping
    past N) against their plain versions."""
    spec, c, x, _ = case
    N = spec.Nfft
    S = torch.fft.fft(x)
    P = S.real * S.real + S.imag * S.imag
    for vals in ((0, 3, -5), (N - 2, -N - 7, 2 * N + 1)):
        centre = torch.tensor(vals, dtype=torch.int32, device=x.device)
        E = ds.doppler_energy(P, c.Q, c.shifts, centre)
        Ep = ds.doppler_energy_plain(P, c.Q, c.shifts, centre)
        assert float((E - Ep).abs().max()) <= 1e-4 * float(Ep.abs().max())
        args = (Ep, P, c.shifts, c.shifts_signed, c.hz_lut)
        kw = dict(_k5_kw(spec, sum_all), centre_shift=centre, bin_hz=spec.sampleRate / N)
        _assert_k5_close(ds.doppler_estimate(*args, **kw), ds.doppler_estimate_plain(*args, **kw))


def test_recentred_graph_matches_plain(case):
    spec, c, x, _ = case
    centre = torch.tensor([0, 4, -6], dtype=torch.int32)
    got = build_process_batch(spec, device="cuda")(x, centre_shift=centre)
    want = build_process_batch(spec, device="cuda", plain=True)(x, centre_shift=centre)
    for k in ("bits", "trust", "symbols", "nSym", "nBits", "shift"):
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k


@pytest.mark.parametrize("C,master", [(3, 0), (3, 1), (3, 2), (7, 6), (64, 63), (64, -1)])
def test_vote_master_idx(cuda, C, master):
    """K8 with another master channel against the plain vote, ties included
    (master trust 5 -> weight 6.0 against 3 + 3)."""
    S, L = 300, 5 * 300 + 12 + 8
    rng = np.random.RandomState(C + 7)
    rows = np.zeros((C, L), np.float32)
    rows[:, :S] = rng.randint(0, 2, (C, S))
    rows[:, S:2 * S] = rng.choice([-2, -1, 0, 1, 2, 3, 5, 127], (C, S))
    rows[:, 5 * S + 1] = rng.randint(S // 2, S + 1, C)
    m = master % C
    others = [o for o in range(C) if o != m][:2]
    rows[m, :S:10], rows[m, S:2 * S:10] = 1, 5
    rows[others, :S:10], rows[others, S:2 * S:10] = 0, 3
    rows[[o for o in range(C) if o != m and o not in others], S:2 * S:10] = -1
    rows = torch.from_numpy(rows).to(cuda)
    rk, rp = rows.clone(), rows.clone()
    ok = pv.vote_rows(rk, S, 1.2, master_idx=master)
    op = pv.vote_rows_plain(rp, S, 1.2, torch.empty((2, S), device=cuda), master)
    torch.cuda.synchronize()
    assert torch.equal(rk, rp) and torch.equal(ok, op)


def test_channel_parallel_step_matches_plain(case, cuda):
    """The one-card channel-parallel step with the vote, kernel path against
    plain path: every decision and the voted pair equal; K8 launched once."""
    spec, c, x, _ = case
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=[cuda])
    pv.vote_rows.launches = 0
    got = build_sharded_demod_step(spec, mesh, master_idx=1)(x)
    want = build_sharded_demod_step(spec, mesh, master_idx=1, plain=True)(x)
    assert pv.vote_rows.launches == 1
    for k in ("bits", "trust", "symbols", "nSym", "nBits", "shift", "bits_voted", "trust_voted"):
        assert torch.equal(got[k], want[k]), k


# ---- slice 6: K4l symbol_detect_local, K4s shard_select, K8 without its pad mask


def _shard_pairs(colmax_parts, colarg_parts, sp, co, spec, kernel):
    """K4l (or its plain version) on each shard's columns: (vals, keys) stacked."""
    fn = dk.symbol_detect_local if kernel else dk.symbol_detect_local_plain
    M, nd = spec.num_masks, len(colmax_parts)
    kw = dict(M=M, Nfft=spec.Nfft, windowWidth=spec.windowWidth, spsymMin=spec.spsymMin,
              numSymMax=spec.numSymMax)
    out = [fn(cm, ca, sp, co, m0=d * (M // nd), **kw)
           for d, (cm, ca) in enumerate(zip(colmax_parts, colarg_parts))]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


@pytest.mark.parametrize("nd", [1, 2])
def test_symbol_detect_local_and_shard_select(case, nd):
    """K4l on each half of the bank and K4s on the stacked pairs against
    their plain versions (pairs, the rows exact); at nd = 1 the rows' bits,
    symbols, centres and mags equal K4's."""
    spec, c, x, ref = case
    S = torch.fft.fft(x)
    shift = ref["shift"].to(torch.int32)
    M, Ml, L = spec.num_masks, spec.num_masks // nd, packed_len(spec)
    cols = [dk.mf_bank_colreduce_plain(S, c.masks_f[d * Ml:(d + 1) * Ml], shift, 0, Ml)
            for d in range(nd)]
    colsum = sum(col[0] for col in cols)
    sp, co, cv = dk.timing_band_plain(colsum, spec.code_idx_lo, spec.code_idx_hi)
    cm, ca = [col[1] for col in cols], [col[2] for col in cols]
    vk, kk = _shard_pairs(cm, ca, sp, co, spec, True)
    vp, kp = _shard_pairs(cm, ca, sp, co, spec, False)
    assert torch.equal(vk, vp) and torch.equal(kk, kp)
    kw = dict(M=M, Nfft=spec.Nfft, windowWidth=spec.windowWidth, spsymMin=spec.spsymMin,
              numSymMax=spec.numSymMax, trust_normal=c.trust_normal, code_val=cv)
    pairs = dk.pack_pairs(vp, kp)
    rk = dk.shard_select(pairs, sp, co, c.bitLUT, row=torch.zeros((3, L), device=x.device), **kw)
    rp = dk.shard_select(pairs.cpu(), sp.cpu(), co.cpu(), c.bitLUT.cpu(),
                         row=torch.zeros((3, L)), **dict(kw, code_val=cv.cpu()))
    torch.cuda.synchronize()
    assert torch.equal(rk.cpu(), rp)
    if nd == 1:
        k4 = dk.symbol_detect(cm[0], ca[0], sp, co, c.bitLUT, Nfft=spec.Nfft,
                              windowWidth=spec.windowWidth, spsymMin=spec.spsymMin,
                              numSymMax=spec.numSymMax, trust_normal=c.trust_normal)
        Sn = spec.numSymMax
        for j, at in ((3, 0), (0, 2), (1, 3), (2, 4)):  # bits, symbols, centres, mags
            assert torch.equal(rk[:, at * Sn:(at + 1) * Sn], k4[j].float())


def test_shard_select_clip(cuda):
    """K4s with a clip bitmask against its plain version (trust -2 equal)."""
    N, M, S, B = 4096, 8, 200, 2
    rng = np.random.RandomState(4)
    vals = torch.from_numpy(rng.randint(0, 4, (2, B, S)).astype(np.float32)).to(cuda)
    keys = torch.from_numpy(rng.randint(0, 7 * M, (2, B, S)).astype(np.int32)).to(cuda)
    sp = torch.tensor([16.2, 15.9], device=cuda)
    co = torch.tensor([3.5, 11.25], device=cuda)
    hit = torch.zeros((B, N), dtype=torch.bool)
    hit[:, [5, 1000, 4095]] = True
    hits = dk.pack_bits(hit).to(cuda)
    kw = dict(M=M, Nfft=N, windowWidth=7, spsymMin=8, numSymMax=S, trust_normal=2)
    L = 5 * S + 12
    cv, ca = torch.ones(B, device=cuda), torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    pairs = dk.pack_pairs(vals, keys)
    rk = dk.shard_select(pairs, sp, co, None, row=torch.zeros((B, L), device=cuda),
                         code_val=cv, hits=hits, clipped_any=ca, **kw)
    rp = dk.shard_select(pairs.cpu(), sp.cpu(), co.cpu(), None, row=torch.zeros((B, L)),
                         code_val=cv.cpu(), hits=hits.cpu(), clipped_any=ca.cpu(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(rk.cpu(), rp) and (rp[:, S:2 * S] == -2).any()


@pytest.mark.parametrize("C", [2, 16])
def test_vote_without_pad_mask(cuda, C):
    S, L = 300, 5 * 300 + 12 + 8
    rng = np.random.RandomState(C + 3)
    rows = np.zeros((C, L), np.float32)
    rows[:, :S] = rng.randint(0, 2, (C, S))
    rows[:, S:2 * S] = rng.choice([-2, -1, 0, 1, 2, 3, 5], (C, S))
    rows[:, 5 * S + 1] = rng.randint(S // 2, S + 1, C)
    rows = torch.from_numpy(rows).to(cuda)
    rk, rp = rows.clone(), rows.clone()
    ok = pv.vote_rows(rk, S, 1.2, mask_pad=False)
    op = pv.vote_rows_plain(rp, S, 1.2, torch.empty((2, S), device=cuda), mask_pad=False)
    torch.cuda.synchronize()
    assert torch.equal(rk, rows) and torch.equal(rp, rows) and torch.equal(ok, op)


def test_generic_step_matches_channel_parallel(case, cuda):
    """The generic step on the one-card mesh: bits, symbols and centres
    equal the channel-parallel step's, and its kernel path equals its plain
    path's decisions."""
    spec, c, x, _ = case
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=[cuda])
    fast = build_sharded_demod_step(spec, mesh)(x)
    gen = build_sharded_demod_step(spec, mesh, force_generic=True)(x)
    plain = build_sharded_demod_step(spec, mesh, force_generic=True, plain=True)(x)
    for k in ("bits", "symbols", "centres"):
        assert torch.equal(fast[k], gen[k]), k
    for k in ("bits", "trust", "symbols", "nSym", "nBits", "shift", "bits_voted"):
        assert torch.equal(gen[k], plain[k]), k


@pytest.fixture(scope="module")
def bpsk_bench_case(cuda):
    """bench_BPSK at the bench_conf shape (Nfft 2^13, D=16, 16 masks of 4
    bits, the (8, 2, 2) NRZ-S LUT): 3 blocks of seeded BPSK."""
    conf = configs._conf(blockSize=13, overlap=10, spsym=16, doppSteps=16, maskSize=4)
    conf["Main"]["protocols"] = {"UHF": "bench_BPSK"}
    spec = build_spec(conf, loadProtocol("bench_BPSK")(conf=conf), configs.RADIO)
    rng = np.random.RandomState(9)
    N = spec.Nfft
    x = np.stack([modulate_bpsk(rng.randint(0, 2, N // 16), 16)[:N] for _ in range(3)])
    x = x * np.exp(2j * np.pi * spec.centreFreqOffset / spec.sampleRate * np.arange(N))
    x = x + 0.05 * (rng.randn(3, N) + 1j * rng.randn(3, N))
    return spec, torch.from_numpy(x.astype(np.complex64)).to(cuda)


def test_generic_bpsk_step_matches_channel_parallel(bpsk_bench_case, cuda):
    """The generic step on bench_BPSK (the NRZ-S bits after the cross-shard
    select): bits, symbols and centres equal the channel-parallel step's
    (K4's NRZ-S form), and its kernel path equals its plain path's decisions."""
    spec, x = bpsk_bench_case
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=[cuda])
    fast = build_sharded_demod_step(spec, mesh)(x)
    gen = build_sharded_demod_step(spec, mesh, force_generic=True)(x)
    plain = build_sharded_demod_step(spec, mesh, force_generic=True, plain=True)(x)
    for k in ("bits", "symbols", "centres"):
        assert torch.equal(fast[k], gen[k]), k
    for k in ("bits", "trust", "symbols", "nSym", "nBits", "shift", "bits_voted", "trust_voted"):
        assert torch.equal(gen[k], plain[k]), k
    assert bool((gen["trust"] == -1).any())


# ---- slice 12: K5 and K4 redesigned, K1 and K5 for any mask count and grid


def _k5_pair(args, kw):
    got = ds.doppler_estimate(*args, **kw)
    want = ds.doppler_estimate_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_k5_close(got, want)
    return got, want


@pytest.mark.parametrize("sum_all", [True, False])
@pytest.mark.parametrize("where", list(smoke.K5_TIES))
def test_doppler_estimate_ties(cuda, where, sum_all):
    """K5 with planted equal grid entries at D = 2048: within one thread's
    entries, one lane's, across lanes and across warps. The lower index wins,
    as the plain version's argmax does."""
    D, M = 2048, 8
    rng = np.random.RandomState(len(where))
    args = smoke.k5_grid_inputs(rng, 3, D, M, ties=smoke.K5_TIES[where])
    kw = dict(num_dopplers=D, array_offset=0, sum_all_masks=sum_all, snr_window=5,
              centre_freq_offset=0.0)
    got, want = _k5_pair(args, kw)
    a, b = sorted(smoke.K5_TIES[where][:2])
    assert float(want[0][0]) == pytest.approx((a + b) / 2, rel=1e-6)


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("nd", [1, 31, 33, 64, 2047])
@pytest.mark.parametrize("D", [2048, 3000])
def test_doppler_estimate_grid_sizes(cuda, D, nd, off):
    """K5 over nd of D grid entries from array_offset, both forms, at D =
    2048 and 3000 (more grid entries than K5 has threads)."""
    nd = min(nd, D - off)
    rng = np.random.RandomState(D + nd + off)
    args = smoke.k5_grid_inputs(rng, 4, D, 8)
    for sum_all in (True, False):
        _k5_pair(args, dict(num_dopplers=nd, array_offset=off, sum_all_masks=sum_all,
                            snr_window=5, centre_freq_offset=1.5e3))


@pytest.mark.parametrize("centred", [False, True])
@pytest.mark.parametrize("sum_all", [True, False])
@pytest.mark.parametrize("M", [1, 5, 64, 128])
def test_doppler_estimate_mask_counts(cuda, M, sum_all, centred):
    """K5 at M = 1 to 128 masks (xcorrMaskSize up to 7; the per-mask form's
    means run in rounds of 32 masks), with and without a recentre, E also
    into the packed row."""
    D, N, B = 64, 4096, 4
    rng = np.random.RandomState(M)
    args = smoke.k5_grid_inputs(rng, B, D, M, N=N)
    kw = dict(num_dopplers=D, array_offset=0, sum_all_masks=sum_all, snr_window=5,
              centre_freq_offset=0.0)
    if centred:
        kw.update(centre_shift=torch.tensor([7, -300, N + 5, 0], dtype=torch.int32,
                                            device=cuda), bin_hz=9.375)
    got, _ = _k5_pair(args, kw)
    row = torch.full((B, 3 + 12 + D * M), float("nan"), device=cuda)  # a row misaligned by 12 B
    tail = row[:, 3:]
    ds.doppler_estimate(*args, **kw, tail=tail)
    torch.cuda.synchronize()
    assert torch.equal(tail[:, 5:11], torch.stack([v.float() for v in got], dim=-1))
    assert torch.equal(tail[:, 12:], args[0].reshape(B, -1))


@pytest.mark.parametrize("case4", smoke.K4_CASES, ids=[k[0] for k in smoke.K4_CASES])
def test_symbol_detect_windows(cuda, case4):
    """K4 at B = 64 against its plain version on chip_smoke's K4_CASES, every
    output equal: tied magnitudes (the earliest sample wins), A clamped at 0
    and at N - W, clip hits on the bitmask's word edges, the form without
    the clip mask, the row form, and each block alone equal to its row of
    the batch (``chip_smoke.check_k4_case``)."""
    smoke.check_k4_case(case4)


def test_doppler_estimate_noise_bands(cuda):
    """K5 with noise alone in both SNR bands (the band ratio near 1, where
    the dB of ratio - 1 magnifies f32 rounding): every output but the SNR
    under the contract, and the kernel's band ratio and the plain
    version's each within f32 rounding of float64's
    (``chip_smoke.check_doppler_estimate_noise``)."""
    worst = smoke.check_doppler_estimate_noise()
    assert max(worst[3:5]) <= 1.0


@pytest.mark.parametrize("M", [33, 64, 128])
def test_doppler_energy_deep_banks(cuda, M):
    """K1 at more than 32 masks (xcorrMaskSize 6 and 7): one launch per
    group of at most 32 masks, E's columns in mask order, within 1e-4 of
    max|E| of the plain version, with and without a recentre; a block
    alone equals its row of the batch; a wrapper call counts one launch
    per group."""
    N, D, B = 2 ** 13, 64, 4
    rng = np.random.RandomState(M)
    P = torch.from_numpy(rng.exponential(1.0, (B, N)).astype(np.float32)).to(cuda)
    Q = torch.from_numpy(rng.exponential(1.0, (M, N)).astype(np.float32)).to(cuda)
    shifts = torch.from_numpy((rng.randint(0, N) + 3 * np.arange(D)).astype(np.int32) % N
                              ).to(cuda)
    centre = torch.tensor([0, 5, -9, N + 1], dtype=torch.int32, device=cuda)
    for cs in (None, centre):
        before = ds.doppler_energy.launches
        Ek = ds.doppler_energy(P, Q, shifts, cs)
        assert ds.doppler_energy.launches == before + len(ds.k1_mask_groups(M))
        Ep = ds.doppler_energy_plain(P, Q, shifts, cs)
        assert Ek.shape == (B, D, M)
        assert float((Ek - Ep).abs().max()) <= 1e-4 * float(Ep.abs().max())
        one = ds.doppler_energy(P[2:3], Q, shifts, None if cs is None else cs[2:3])
        assert torch.equal(one[0], Ek[2])


# ---- slice 15: K4n in K4's launch on the block graph, K8 redesigned

NRZS_S = [1, 2, 63, 64, 65, 4607, 4608, 36480]


def _nrzs_inputs(cuda, S, B, M, seed, W=None, unaligned=False):
    """K4's inputs at the bench_BPSK shape (Nfft 2^16, its window and
    spsymMin) for S slots: seeded colmax, colargmax in [-1, M + 1] (symbols
    outside an M-row LUT), spSym about N / S (clamped to spsymMin), a
    sparse clip bitmask; ``W`` a wider window, ``unaligned`` rows that are
    not 16-byte aligned (both take the sample-by-sample form). Returns
    (args, kwargs) of ``symbol_detect`` on the card."""
    bspec = smoke.bpsk_configuration()[2]
    N = bspec.Nfft
    rng = np.random.RandomState(seed)
    colmax = rng.rand(B, N).astype(np.float32)
    colarg = rng.randint(-1, M + 2, (B, N)).astype(np.int32)
    if unaligned:
        buf = torch.zeros(B * N + 1, device=cuda)
        buf[1:] = torch.from_numpy(colmax.ravel()).to(cuda)
        cm = buf[1:].view(B, N)
        ibuf = torch.zeros(B * N + 1, dtype=torch.int32, device=cuda)
        ibuf[1:] = torch.from_numpy(colarg.ravel()).to(cuda)
        ca = ibuf[1:].view(B, N)
    else:
        cm, ca = torch.from_numpy(colmax).to(cuda), torch.from_numpy(colarg).to(cuda)
    sp = (N / S * (1 + 0.01 * rng.randn(B))).astype(np.float32)
    co = rng.uniform(-20, 20, B).astype(np.float32)
    hits = dk.pack_bits(torch.from_numpy(rng.rand(B, N) < 0.001)).to(cuda)
    kw = dict(Nfft=N, windowWidth=W or bspec.windowWidth, spsymMin=bspec.spsymMin,
              numSymMax=S, trust_normal=4, hits=hits)
    return (cm, ca, torch.from_numpy(sp).to(cuda), torch.from_numpy(co).to(cuda)), kw


def _nrzs_form_vs_plain(args, kw, lut, B):
    """The fused form's rows and the plain version's on the CPU; the fused
    call counts one K4 launch and one of the NRZ-S form, and nothing else."""
    from pycusdr_tpu_torch import ops

    S = kw["numSymMax"]
    L = 5 * S + 12 + 3
    code_val = torch.ones(B, device=lut.device)
    before = ops.launch_counts()
    fused = dk.symbol_detect_nrzs(*args, lut, **kw, row=torch.zeros((B, L), device=lut.device),
                                  code_val=code_val)
    moved = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
    assert moved == {"symbol_detect": 1, "symbol_detect_nrzs": 1}, moved
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    plain = dk.symbol_detect(*(a.cpu() for a in args), None, **cpu, row=torch.zeros((B, L)),
                             code_val=code_val.cpu(), symbolLUT=lut.cpu())
    torch.cuda.synchronize()
    return fused, plain


@pytest.mark.parametrize("B", [1, 16, 64])
@pytest.mark.parametrize("S", NRZS_S)
def test_symbol_detect_nrzs_form(cuda, S, B):
    """K4's NRZ-S form (K4n in K4's launch) at the bench_BPSK shape with the
    (8, 2, 2) LUT and a clip bitmask: rows equal to the plain version's,
    over every ``k4_plan`` form that B x S picks."""
    lut = DeviceConsts.from_spec(smoke.bpsk_configuration()[2], cuda).symbolLUT
    args, kw = _nrzs_inputs(cuda, S, B, lut.shape[0], seed=S + B)
    fused, plain = _nrzs_form_vs_plain(args, kw, lut, B)
    assert torch.equal(fused.cpu(), plain)
    if S >= 4607:
        trust = fused[:, S:2 * S]
        assert bool((trust == -1).any()) and bool((trust == -2).any())


@pytest.mark.parametrize("form", ["wide", "unaligned"])
@pytest.mark.parametrize("B", [1, 16])
def test_symbol_detect_nrzs_form_sample_by_sample(cuda, B, form):
    """The NRZ-S form's sample-by-sample instantiation (a window wider than
    9 samples, or rows that are not 16-byte aligned) against the plain
    version."""
    lut = DeviceConsts.from_spec(smoke.bpsk_configuration()[2], cuda).symbolLUT
    args, kw = _nrzs_inputs(cuda, 4608, B, lut.shape[0], seed=B + 5,
                            W=12 if form == "wide" else None, unaligned=form == "unaligned")
    fused, plain = _nrzs_form_vs_plain(args, kw, lut, B)
    assert torch.equal(fused.cpu(), plain)


@pytest.mark.parametrize("M,K", [(2048, 4), (8192, 4)])
@pytest.mark.parametrize("B", [1, 16])
def test_symbol_detect_nrzs_form_large_lut(cuda, B, M, K):
    """The NRZ-S form with LUTs of 64 and 256 KB (read through L1), a third
    of the transitions planted in a table: rows equal to the plain
    version's."""
    S = 4608
    args, kw = _nrzs_inputs(cuda, S, B, M, seed=M + B)
    sym = dk.symbol_detect(*args, None, **kw)[0].cpu().numpy()
    rng = np.random.RandomState(M)
    lut = rng.randint(0, M, (M, 2, K)).astype(np.int32)
    for b in range(B):
        for i in range(0, S, 3):
            if 0 <= sym[b, i] < M:
                lut[sym[b, i], i % 2, i % K] = sym[b, (i + 1) % S]
    fused, plain = _nrzs_form_vs_plain(args, kw, torch.from_numpy(lut).to(cuda), B)
    assert torch.equal(fused.cpu(), plain)
    assert bool((fused[:, :S] == 1).any()) and bool((fused[:, S:2 * S] == -1).any())


@pytest.mark.parametrize("mask_pad", [True, False])
@pytest.mark.parametrize("S", [1, 31, 4608])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 16, 64, 65, 256])
def test_vote_tiles(cuda, C, S, mask_pad):
    """K8 (tiles of 32 slots, channels across warps, chunks of 256) against
    the plain vote on ``chip_smoke.vote_input`` rows (pinned ties, all
    disqualified slots, ragged nBits), master 0 and C - 1: masked rows and
    voted pair equal; one launch a call."""
    L = 5 * S + 12 + 8
    for master in (0, -1):
        rows, _ = smoke.vote_input(C, S, L)
        rk, rp = rows.clone(), rows.clone()
        before = pv.vote_rows.launches
        ok = pv.vote_rows(rk, S, 1.2, master_idx=master, mask_pad=mask_pad)
        assert pv.vote_rows.launches == before + 1
        op = pv.vote_rows_plain(rp, S, 1.2, torch.empty((2, S), device=cuda), master, mask_pad)
        torch.cuda.synchronize()
        assert torch.equal(rk, rp) and torch.equal(ok, op), f"master {master}"


# ---- slice 16: K4l and K4s redesigned, K4n in K4s's launch


def _split_inputs(cuda, B, S, nd, seed, W=7, M=16, unaligned=False, spc=None):
    """K4l's and K4s's inputs at the bench_BPSK shape (Nfft 2^16, 16 masks)
    for S slots and nd shards: each shard's colmax (quantised: tied
    windows) and colargmax in [0, M / nd), spSym about N / S (or ``spc``),
    codeOffset in [-20, 20), a sparse clip bitmask; ``unaligned`` rows that
    are not 16-byte aligned. Returns (cols, sp, co, hits, kw of K4l)."""
    N = 2 ** 16
    rng = np.random.RandomState(seed)
    cols = []
    for _ in range(nd):
        colmax = rng.randint(0, 6, (B, N)).astype(np.float32)
        colarg = rng.randint(0, M // nd, (B, N)).astype(np.int32)
        if unaligned:
            cm = torch.zeros(B * N + 1, device=cuda)
            cm[1:] = torch.from_numpy(colmax.ravel()).to(cuda)
            ca = torch.zeros(B * N + 1, dtype=torch.int32, device=cuda)
            ca[1:] = torch.from_numpy(colarg.ravel()).to(cuda)
            cols.append((cm[1:].view(B, N), ca[1:].view(B, N)))
        else:
            cols.append((torch.from_numpy(colmax).to(cuda), torch.from_numpy(colarg).to(cuda)))
    sp = (spc or N / S) * (1 + 0.01 * rng.randn(B))
    co = rng.uniform(-20, 20, B)
    hits = dk.pack_bits(torch.from_numpy(rng.rand(B, N) < 0.0005)).to(cuda)
    kw = dict(M=M, Nfft=N, windowWidth=W, spsymMin=8, numSymMax=S)
    return (cols, torch.from_numpy(sp.astype(np.float32)).to(cuda),
            torch.from_numpy(co.astype(np.float32)).to(cuda), hits, kw)


def _k4l_pairs(cols, sp, co, kw):
    """K4l on every shard, packed, and its plain version's pairs, stacked."""
    Ml = kw["M"] // len(cols)
    got = torch.stack([dk.symbol_detect_local(cm, ca, sp, co, m0=d * Ml, packed=True, **kw)
                       for d, (cm, ca) in enumerate(cols)])
    want = torch.stack([dk.pack_pairs(*dk.symbol_detect_local_plain(cm, ca, sp, co, m0=d * Ml,
                                                                   **kw))
                        for d, (cm, ca) in enumerate(cols)])
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("form", ["chunks", "wide", "unaligned"])
@pytest.mark.parametrize("B,S", [(1, 4608), (16, 4608), (64, 4608), (1, 36480), (3, 33)])
def test_symbol_detect_local_plans(cuda, B, S, form):
    """K4l in every ``k4_plan`` form that B x S picks (64 threads with
    colargmax read with the windows; 128 threads with one or two slots a
    thread), on 16-byte chunks, a window wider than 9 samples and rows that
    are not 16-byte aligned (both sample by sample), with tied windows: the
    packed pairs equal the plain version's, the views equal its (val, key);
    one launch a call."""
    cols, sp, co, _, kw = _split_inputs(cuda, B, S, 2, seed=B + S, W=12 if form == "wide" else 7,
                                        unaligned=form == "unaligned")
    before = dk.symbol_detect_local.launches
    got, want = _k4l_pairs(cols, sp, co, kw)
    assert dk.symbol_detect_local.launches == before + 2
    assert torch.equal(got, want)
    v, k = dk.symbol_detect_local(*cols[1], sp, co, m0=8, **kw)
    assert torch.equal(v, dk.pair_views(want[1])[0]) and torch.equal(k, want[1, ..., 1])


def _k4s_rows(pairs, sp, co, hits, kw, lut=None, bitLUT=None):
    """K4s (the NRZ-S form with ``lut``) on the card and its plain version on
    the CPU: (rows, plain rows)."""
    B, S = pairs.shape[1], kw["numSymMax"]
    L = 5 * S + 12 + 5
    k4s = dict(kw, trust_normal=3, code_val=torch.arange(B, dtype=torch.float32, device=sp.device),
               hits=hits)
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in k4s.items()}
    if lut is None:
        got = dk.shard_select(pairs, sp, co, bitLUT, row=torch.zeros((B, L), device=sp.device),
                              **k4s)
        want = dk.shard_select(pairs.cpu(), sp.cpu(), co.cpu(),
                               None if bitLUT is None else bitLUT.cpu(), row=torch.zeros((B, L)),
                               **cpu)
    else:
        got = dk.shard_select_nrzs(pairs, sp, co, lut, row=torch.zeros((B, L), device=sp.device),
                                   **k4s)
        want = dk.shard_select_nrzs(pairs.cpu(), sp.cpu(), co.cpu(), lut.cpu(),
                                    row=torch.zeros((B, L)), **cpu)
    torch.cuda.synchronize()
    return got.cpu(), want


@pytest.mark.parametrize("kind", ["bits", "nrzs"])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("nd", [1, 2, 4])
@pytest.mark.parametrize("B,S", [(1, 4608), (16, 4608), (64, 4608), (3, 33), (1, 1)])
def test_shard_select_plans(cuda, B, S, nd, clip, kind):
    """K4s in every ``k4s_plan`` form that B x S picks, on the pairs K4l
    finds on nd shards (tied windows), with and without a clip bitmask, with
    a centre-bit LUT and in the NRZ-S form (K4n in the same launch; the (8,
    2, 2) LUT of bench_BPSK): rows
    equal to the plain version's; the NRZ-S form counts one K4s launch and
    one of the form."""
    cols, sp, co, hits, kw = _split_inputs(cuda, B, S, nd, seed=7 * B + S + nd)
    pairs, _ = _k4l_pairs(cols, sp, co, kw)
    if kind == "bits":
        lut8 = torch.from_numpy((np.arange(16) % 3 == 1).astype(np.int8)).to(cuda)
        got, want = _k4s_rows(pairs, sp, co, hits if clip else None, kw, bitLUT=lut8)
    else:
        lut = DeviceConsts.from_spec(smoke.bpsk_configuration()[2], cuda).symbolLUT
        before = (dk.shard_select.launches, dk.shard_select_nrzs.launches)
        got, want = _k4s_rows(pairs, sp, co, hits if clip else None, kw, lut=lut)
        assert (dk.shard_select.launches, dk.shard_select_nrzs.launches) == (
            before[0] + 1, before[1] + 1)
        if S > 1:
            assert bool((got[:, S:2 * S] == -1).any())
    assert torch.equal(got, want)
    if clip and S == 4608:
        assert bool((got[:, S:2 * S] == -2).any())


@pytest.mark.parametrize("kind", ["bits", "nrzs"])
@pytest.mark.parametrize("B", [1, 16])
def test_shard_select_clip_at_clamp(cuda, B, kind):
    """K4s with hw near its clamp (spSym about 1000: hw 2000, far more clip
    words than a slot holds in registers, tested in global memory): rows
    equal to the plain version's, some slot -2."""
    cols, sp, co, hits, kw = _split_inputs(cuda, B, 66, 2, seed=B + 66, spc=1000.0)
    pairs, _ = _k4l_pairs(cols, sp, co, kw)
    if kind == "bits":
        got, want = _k4s_rows(pairs, sp, co, hits, kw,
                              bitLUT=torch.ones(16, dtype=torch.int8, device=cuda))
    else:
        lut = DeviceConsts.from_spec(smoke.bpsk_configuration()[2], cuda).symbolLUT
        got, want = _k4s_rows(pairs, sp, co, hits, kw, lut=lut)
    assert 2 * int(np.ceil(float(sp.min()))) > 4 * 32
    assert torch.equal(got, want) and bool((got[:, 66:132] == -2).any())


@pytest.mark.parametrize("M,K", [(2048, 4), (8192, 4)])
@pytest.mark.parametrize("B", [1, 16])
def test_shard_select_nrzs_large_lut(cuda, B, M, K):
    """K4s's NRZ-S form with LUTs of 64 and 256 KB (read through L1) on a
    bank of M + 2 masks (symbols past the LUT's rows), a third of the
    transitions planted in a table: rows equal to the plain version's, some
    bits 1, some transition errors."""
    S, nd, W = 4608, 2, 7
    Mb = M + 2
    rng = np.random.RandomState(M + B)
    vals = torch.from_numpy(rng.randint(0, 4, (nd, B, S)).astype(np.float32))
    keys = torch.from_numpy((rng.randint(0, W, (nd, B, S)) * Mb
                             + rng.randint(0, Mb, (nd, B, S))).astype(np.int32))
    pairs = dk.pack_pairs(vals, keys)
    sp = torch.full((B,), 2 ** 16 / S, device=cuda)
    co = torch.full((B,), 3.5, device=cuda)
    kw = dict(M=Mb, Nfft=2 ** 16, windowWidth=W, spsymMin=8, numSymMax=S)
    base = dk.shard_select(pairs, sp.cpu(), co.cpu(), None, row=torch.zeros((B, 5 * S + 12)),
                           trust_normal=3, code_val=torch.zeros(B), **kw)
    sym = base[:, 2 * S:3 * S].long().numpy()
    lut = rng.randint(0, M, (M, 2, K)).astype(np.int32)
    for b in range(B):
        for i in range(0, S, 3):
            if sym[b, i] < M:
                lut[sym[b, i], i % 2, i % K] = sym[b, (i + 1) % S]
    got, want = _k4s_rows(pairs.to(cuda), sp, co, None, kw, lut=torch.from_numpy(lut).to(cuda))
    assert torch.equal(got, want)
    assert bool((got[:, :S] == 1).any()) and bool((got[:, S:2 * S] == -1).any())


@pytest.fixture(scope="module")
def cc11xx_case(cuda):
    conf, protocol, spec, _ = smoke.cc11xx_configuration()
    return spec, DeviceConsts.from_spec(spec, cuda)


@pytest.mark.parametrize("B", [1, 16, 64])
def test_cc11xx_shape_kernels(cc11xx_case, B):
    """K1-K5 at the station's CC11xx shape (Nfft 2^16, 128 samples a
    symbol, S=640, K3's band of 103 bins, 64 shifts about the IF bin
    10240) against their plain versions (``smoke.check_cc11xx_kernels``:
    the flagship's contracts, K1 within 1e-4 of max|E|, every block alone
    equal to its row of the batch)."""
    spec, consts = cc11xx_case
    assert (spec.Nfft, spec.spsym, spec.numSymMax) == (2 ** 16, 128.0, 640)
    assert (spec.code_idx_lo, spec.code_idx_hi, spec.dopp_offset_idx) == (465, 568, 10240)
    _, (nwin, nglob), rel = smoke.check_cc11xx_kernels(spec, consts, B)
    assert rel <= smoke.K1_REL and nwin + nglob >= 1
