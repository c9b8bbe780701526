"""The host side of K1's mask groups, K4 and K5 on the CPU.

- K1 (``csrc/doppler_energy.cu``) takes at most 32 masks a launch; a deeper
  bank runs one launch per ``ops/doppler_search.k1_mask_groups`` group.
- K4 (``csrc/symbol_detect.cu``): a numpy model of what a thread of
  ``ops/demod_kernels.k4_plan``'s launch reads (the slots it takes, the
  16-byte chunks around each window, the clip words around it) holds
  every window and every clip range that the plain version reads, on
  seeded spSym and codeOffset, the clamps of A at 0 and N - W among them.
- K5's plain version (``doppler_search.find_doppler_estimate``) against
  JAX's at D = 2048 and M = 128, with planted ties.
- The port's plain block graph against JAX's at xcorrMaskSize 6 (M = 64),
  within the golden table of ``tests/test_dsp_golden.py:89-132``.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_fsk_signal
from pycusdr_tpu.dsp.block import build_process_block as jax_build_process_block
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.ops.doppler_search import find_doppler_estimate as jax_find_doppler_estimate
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch.convert import spec_from_numpy
from pycusdr_tpu_torch.dsp.block import build_process_block
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops import doppler_search as ds

torch.set_num_threads(2)


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize("M", [1, 8, 31, 32, 33, 64, 100, 128])
def test_k1_mask_groups_cover_the_bank_in_order(M):
    groups = ds.k1_mask_groups(M)
    assert groups[0][0] == 0 and groups[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    assert all(0 < m1 - m0 <= ds.K1_MAX_MASKS for m0, m1 in groups)
    assert len(groups) == -(-M // ds.K1_MAX_MASKS)
    for m0, m1 in groups:  # each group has a plan of its own
        ds.doppler_energy_plan(np.arange(0, 640, 10), 4096, m1 - m0)


def test_k1_plan_refuses_a_group_above_32_masks():
    with pytest.raises(ValueError):
        ds.doppler_energy_plan(np.arange(64), 4096, ds.K1_MAX_MASKS + 1)


# ---------------------------------------------------------------- K4

#: (label, N, S, W, spsymMin, spsym): the flagship, STX, tiny, a one-sample
#: window and a window wider than the symbol
K4_SHAPES = [("flagship", 2 ** 16, 4608, 7, 8, 16.0), ("stx", 2 ** 17, 9216, 3, 8, 16.0),
             ("tiny", 512, 128, 5, 4, 8.0), ("w1", 2 ** 13, 600, 1, 8, 16.0),
             ("wide", 2 ** 13, 1100, 24, 4, 8.0)]


def _k4_inputs(rng, B, N, spsymMin, spsym):
    """Seeded spSym and codeOffset: near the symbol rate, below spsymMin,
    far above it, and offsets that clamp A at 0 and at N - W (block 0 at
    the symbol rate clamps at both ends: S slots span more than N)."""
    sp = spsym * (1 + 0.01 * rng.randn(B))
    sp[5::5] = spsymMin * rng.uniform(0.2, 1.0, len(sp[5::5]))
    sp[3::7] = rng.uniform(100, 3000, len(sp[3::7]))
    co = rng.uniform(-2 * spsym, 2 * spsym, B)
    co[1::4] = -rng.uniform(0, 5 * spsym, len(co[1::4]))
    co[2::6] = N - rng.uniform(0, 3 * spsym, len(co[2::6]))
    sp[0], co[0] = spsym, -0.7 * spsym
    return (torch.from_numpy(sp.astype(np.float32)), torch.from_numpy(co.astype(np.float32)))


def _k4_reads(A, spc, N, W):
    """What a K4 thread reads for each slot, as ``csrc/symbol_detect.cu``
    computes it from the window starts A (B, S) of ``_slot_geometry``: the
    16-byte chunks [q0, q1] that cover the window, and the clip words
    [wlo, wlo + nw) around it (held in registers when nw <= 4)."""
    hw = np.minimum(2 * np.ceil(spc).astype(np.int64), dk.CLIP_HW_MAX)[:, None]
    q0, q1 = A >> 2, (A + W - 1) >> 2
    wlo = np.maximum(A - hw, 0) >> 5
    nw = (np.minimum(A + W - 1 + hw, N - 1) >> 5) - wlo + 1
    return q0, q1, hw, wlo, nw


@pytest.mark.parametrize("B", [1, 16, 64])
@pytest.mark.parametrize("shape", K4_SHAPES, ids=[s[0] for s in K4_SHAPES])
def test_k4_plan_covers_every_window_and_clip_range(shape, B):
    """K4's launch takes every slot once (a thread's SPT slots strided by
    the CTA's threads); the chunks a thread reads cover the window the plain
    version reads, at most three of them for W <= 9, inside the row; the
    clip words it reads cover [j - hw, j + hw] for every sample j of the
    window; at spSym = spsym the flagship's and the STX's words fit the
    registers."""
    label, N, S, W, spsymMin, spsym = shape
    rng = np.random.RandomState(B + N + W)
    sp, co = _k4_inputs(rng, B, N, spsymMin, spsym)
    spc, _, A0, A = dk._slot_geometry(sp, co, W, N, S, spsymMin)
    A, spc = A.numpy(), spc.numpy()
    assert (A0.numpy() < 0).any() and (A == N - W).any(), "no clamp at 0 or at N - W"
    threads, spt, argwin = dk.k4_plan(B, S)
    assert argwin == (B * S <= dk.K4_LATENCY_SLOTS) and (spt == 1 or not argwin)
    per_cta = threads * spt
    x = (np.arange(-(-S // per_cta))[:, None, None] * per_cta
         + np.arange(spt)[None, :, None] * threads + np.arange(threads)[None, None, :]).ravel()
    assert np.array_equal(np.sort(x[x < S]), np.arange(S))
    q0, q1, hw, wlo, nw = _k4_reads(A, spc, N, W)
    assert (4 * q0 <= A).all() and (A + W <= 4 * q1 + 4).all() and (4 * q1 + 4 <= N).all()
    if W <= dk.K4_MAX_CHUNK_W:
        assert (q1 - q0 < 3).all()
    win = A[:, :, None] + np.arange(W)  # the samples the plain version reads
    assert win.min() >= 0 and win.max() < N
    lo = np.maximum(win - hw[:, :, None], 0) >> 5
    hi = np.minimum(win + hw[:, :, None], N - 1) >> 5
    assert (lo >= wlo[:, :, None]).all() and (hi < (wlo + nw)[:, :, None]).all()
    if label in ("flagship", "stx"):  # block 0, at the symbol rate
        assert (nw[0] <= dk.K4_REG_WORDS).all()


def test_k4_plan_by_batch():
    """B=1 reads colargmax with the windows on CTAs of 64 slots (72 for the
    flagship block, the parent's 36 of 128); B=16 one slot a thread, B=64
    two, colargmax at the winning sample."""
    assert dk.k4_plan(1, 4608) == (64, 1, True) and dk.k4_plan(1, 9216) == (64, 1, True)
    assert dk.k4_plan(16, 4608) == (128, 1, False) and dk.k4_plan(16, 9216) == (128, 1, False)
    assert dk.k4_plan(64, 4608) == (128, 2, False) and dk.k4_plan(64, 9216) == (128, 2, False)


# ---------------------------------------------------------------- K5


def _energy_with_ties(rng, D, M):
    """Seeded E (D, M) with planted ties: two equal top rows (the first
    and the second maximum), and, in every mask column, equal values at
    entries 32 and 64 apart (one lane of a warp) and 1 apart (two lanes)."""
    E = rng.exponential(1.0, (D, M)).astype(np.float32)
    E[[700, 1500]] = E.max() + 1.0  # the top two tie in both forms
    E[[9, 41, 73]] = E[700] - 0.5  # the next ones tie too
    E[[10, 11]] = E[9] - 0.25
    return E


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("sum_all", [True, False])
def test_k5_plain_matches_jax_at_d2048_m128(sum_all, off):
    D, M = 2048, 128
    rng = np.random.RandomState(2048 + off)
    Es = [_energy_with_ties(rng, D, M) for _ in range(3)]
    Es[2][[700, 1500]] = 0.0  # the tie moves to the planted next ones
    nd = D - off
    got = ds.find_doppler_estimate(torch.from_numpy(np.stack(Es)), nd, off, sum_all)
    for b, E in enumerate(Es):
        want = jax_find_doppler_estimate(jnp.asarray(E), nd, off, sum_all)
        assert abs(float(got[0][b]) - float(want[0])) <= 1e-5 * max(1.0, abs(float(want[0])))
        assert abs(float(got[1][b]) - float(want[1])) < 1e-3
    if sum_all:  # the first index of the tie wins; the weights are equal
        assert float(got[0][0]) == pytest.approx((700 + 1500) / 2, rel=1e-6)


# ------------------------------------------------ the block graph at M = 64


@pytest.fixture(scope="module")
def deep_bank(bench_conf):
    """bench_conf at xcorrMaskSize 6 (64 masks), one FSK block: the JAX and
    port plain graphs' results."""
    conf = copy.deepcopy(bench_conf)
    conf["GPU"]["UHF"]["xcorrMaskSize"] = 6
    jspec = jax_build_spec(conf, jax_loadProtocol("bench_FSK")(conf=conf), "UHF-H")
    assert jspec.num_masks == 64
    rng = np.random.RandomState(64)
    sig = make_fsk_signal(rng.randint(0, 2, jspec.Nfft // int(jspec.spsym)), int(jspec.spsym),
                          38400 / jspec.sampleRate, seed=64, noise_std=0.05)
    jx = {k: np.asarray(v) for k, v in jax_build_process_block(jspec)(c2ri(sig)).items()}
    spec = spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})
    pt = {k: v.numpy() for k, v in
          build_process_block(spec, device="cpu")(torch.from_numpy(sig)).items()}
    return spec, jx, pt


def _golden(check, spec, ref, pt):
    n = int(pt["nSym"])
    if check == "energy":
        assert pt["E"].shape == ref["E"].shape == (spec.num_dopplers, 64)
        assert np.allclose(pt["E"], ref["E"], rtol=2e-3)
    elif check == "doppler":
        assert abs(float(pt["dopp_idx"]) - float(ref["dopp_idx"])) < 0.01
        assert abs(float(pt["doppler_hz"]) - float(ref["doppler_hz"])) < 1.0
        assert int(pt["shift"]) == int(ref["shift"])
    elif check == "timing":
        assert abs(float(pt["spSym"]) - float(ref["spSym"])) < 1e-3
        assert abs(float(pt["codeOffset"]) - float(ref["codeOffset"])) < 0.05
    elif check == "bits":
        assert n == int(ref["nSym"])
        assert np.mean(pt["symbols"][:n] == ref["symbols"][:n]) > 0.999
        assert np.array_equal(pt["bits"][:n], ref["bits"][:n])
    elif check == "centres":
        d = np.abs(pt["centres"][:n] - ref["centres"][:n])
        assert d.max() <= spec.windowWidth and np.mean(d == 0) > 0.75
    elif check == "snr":
        assert abs(float(pt["snr_db"]) - float(ref["snr_db"])) < 0.5
    else:
        assert np.all(pt["trust"][:n] == 2)


@pytest.mark.parametrize("check", ["energy", "doppler", "timing", "bits", "centres", "snr",
                                   "trust"])
def test_plain_graph_matches_jax_at_64_masks(deep_bank, check):
    spec, jx, pt = deep_bank
    _golden(check, spec, jx, pt)
