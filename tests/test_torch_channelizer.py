"""The port's wideband channelizer (K9's plain version on the CPU) against
the JAX package's ``Channelizer`` and the numpy golden, with the bars of
``tests/test_channelizer.py``: max|Δ|/max|ref| < 1e-5 against both, the
streaming halves against one shot within rtol 1e-4, atol 1e-5, the tone
routing at M=64, the taps equal bit for bit, the carry handed over by
``convert.channelizer_from_jax``, a numpy model of K9's wide form (the
kernel's tiles, staged chunks, FIR ring, Stockham passes, store order and
carry) against JAX, and the channelizer into the port's channel-parallel
step against JAX's step on the same wideband capture."""

import dataclasses

import numpy as np
import pytest
import torch

from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.ops.cfft import c2ri, ri2c
from pycusdr_tpu.parallel import build_sharded_demod_step as jax_step
from pycusdr_tpu.parallel import make_mesh as jax_make_mesh
from pycusdr_tpu.parallel.channelizer import Channelizer as JaxChannelizer
from pycusdr_tpu.parallel.channelizer import channelize_numpy as jax_channelize_numpy
from pycusdr_tpu.parallel.channelizer import design_prototype as jax_design_prototype
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.convert import channelizer_from_jax, spec_from_numpy
from pycusdr_tpu_torch.ops.demod_kernels import twiddle_table
from pycusdr_tpu_torch.parallel import Channelizer, build_sharded_demod_step, make_mesh
from pycusdr_tpu_torch.parallel import channelizer as pch
from pycusdr_tpu_torch.parallel.channelizer import (
    channelize,
    channelize_numpy,
    channelize_plain,
    design_prototype,
    k9_check_shape,
    k9_fused,
)

from conftest import make_fsk_signal

torch.set_num_threads(2)

#: the bar of tests/test_channelizer.py:19 (a DFT other than JAX's four-step)
REL = 1e-5


def _noise(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


def _rel(a, ref):
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


def _state(state_ri):
    st = np.asarray(state_ri)
    return (st[0] + 1j * st[1]).astype(np.complex64)


@pytest.mark.parametrize("M,K,T", [(16, 8, 256), (8, 4, 512)])
def test_matches_jax_and_numpy(M, K, T):
    x = _noise(M * T, M + K)
    y, st = Channelizer(M, K, device="cpu")(torch.from_numpy(x))
    jy, jst = JaxChannelizer(M, K, jit=False)(c2ri(x))
    ref = channelize_numpy(x, M, K)
    assert np.array_equal(ref, jax_channelize_numpy(x, M, K))  # the copy is JAX's
    assert y.shape == (M, T) and y.dtype == torch.complex64 and y.is_contiguous()
    assert _rel(y.numpy(), ri2c(np.asarray(jy))) < REL
    assert _rel(y.numpy(), ref) < REL
    np.testing.assert_array_equal(st.numpy(), _state(jst))


@pytest.mark.parametrize("split", [256, 100, 3])
def test_streaming_state_continuity(split):
    """Chunked processing with the carried state equals one shot (JAX's
    bar), and so does JAX's one shot; a split shorter than the K-1 rows of
    state carries part of the old state along."""
    M, K, T = 8, 4, 512
    x = _noise(M * T, 1)
    ch = Channelizer(M, taps_per_branch=K, device="cpu")
    y_full, st_full = ch(torch.from_numpy(x))
    h = M * split
    ys = [ch.process(torch.from_numpy(x[:h])), ch.process(torch.from_numpy(x[h:]))]
    y_chunks = torch.cat(ys, dim=1).numpy()
    np.testing.assert_allclose(y_chunks, y_full.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ch.state.numpy(), st_full.numpy())
    jy, _ = JaxChannelizer(M, K, jit=False)(c2ri(x))
    assert _rel(y_chunks, ri2c(np.asarray(jy))) < REL
    # a call shorter than the carry: its new state holds old state rows
    y3, st3 = channelize_plain(torch.from_numpy(x[:2 * M]), ch.h2, torch.from_numpy(
        np.arange(3 * M, dtype=np.float32).reshape(3, M).astype(np.complex64)))
    assert st3.shape == (3, M) and float(st3[0, 0].real) == 2 * M


def test_tone_routing():
    """A tone at channel m's centre appears (only) in channel m."""
    M, T = 64, 512
    n = np.arange(M * T)
    ch = Channelizer(M, device="cpu")
    for m0 in [0, 3, 31, 63]:
        x = np.exp(2j * np.pi * m0 / M * n).astype(np.complex64)
        y, _ = ch(x)
        power = np.mean(np.abs(y.numpy()[:, 64:]) ** 2, axis=1)  # skip the ramp-in
        assert np.argmax(power) == m0
        assert power[m0] > 100 * np.delete(power, m0).max(), f"leakage too high for m0={m0}"


@pytest.mark.parametrize("M,K,beta", [(64, 8, 9.0), (16, 4, 6.0), (1024, 32, 9.0)])
def test_taps_equal_jax(M, K, beta):
    np.testing.assert_array_equal(design_prototype(M, K, beta), jax_design_prototype(M, K, beta))
    ours = Channelizer(M, K, beta, device="cpu").h2.numpy()
    assert np.array_equal(ours, JaxChannelizer(M, K, beta, jit=False).h2)


@pytest.mark.parametrize("M,K", [(3, 8), (2048, 8), (64, 33), (64, 0)])
def test_unsupported_shapes_raise(M, K):
    """The channelizer takes any power-of-two M and any K >= 1, as JAX's
    does: M=3 and K=0 are refused on every device (JAX fails on them too).
    K9's shape check, which its wrapper runs on a CUDA tensor, refuses the
    same and nothing more: (2048, 8) and (64, 33) take its wide form."""
    if M & (M - 1) or K < 1:
        with pytest.raises(ValueError, match="power of two"):
            Channelizer(M, K, device="cpu")
        with pytest.raises(ValueError, match="power of two"):
            k9_check_shape(M, K)
    else:
        Channelizer(M, K, device="cpu")
        k9_check_shape(M, K)
        assert not k9_fused(M, K)


def _pad(i):
    """Element i of a padded shared-memory buffer (``csrc/channelizer_wide.cu:pad``)."""
    return i + (i >> 4)


def _wide_twiddles(M):
    """Every pass's twiddle table as the kernel stages it (``stage_twiddles``),
    from the float64-built table: [(radix, Ns, table)]; table[(r - 1) Ns + k]
    up to Ns = 16, else a [r - 1][k mod 16] part and a [r - 1][k div 16] part."""
    tw = twiddle_table(M, "cpu").numpy()
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    out, ns = [], 1
    for R in pch.k9_radices(M):
        step = M // (ns * R) if ns > 1 else 0
        if ns == 1:
            tab = None
        elif ns <= 16:
            tab = np.array([np.conj(tw[r * k * step]) for r in range(1, R) for k in range(ns)])
        else:
            lo = [np.conj(tw[r * kl * step]) for r in range(1, R) for kl in range(16)]
            hi = [np.conj(tw[r * 16 * kh * step]) for r in range(1, R) for kh in range(ns // 16)]
            tab = (np.array(lo, np.complex64), np.array(hi, np.complex64))
        out.append((R, ns, tab))
        ns *= R
    return out


def _wide_passes(W, M, TT, passes):
    """The Stockham passes over the TT rows of the padded tile W, in place:
    pass s reads each job's R values j + r M / R of its row, twiddles them,
    takes the R-point DFT and writes them to (j - k) R + k + r Ns (k = j mod
    Ns), the last pass channel-major at m TT + row."""
    for R, ns, tab in passes:
        NB = M // R
        u = np.arange(TT * NB)
        row, j = u // NB, u % NB
        k = j % ns
        a = np.stack([W[_pad(row * M + j + r * NB)] for r in range(R)])  # (R, jobs)
        if ns > 1:
            for r in range(1, R):
                if ns <= 16:
                    w = tab[(r - 1) * ns + k]
                else:
                    w = tab[0][(r - 1) * 16 + (k & 15)] * tab[1][(r - 1) * (ns // 16) + (k >> 4)]
                a[r] = (a[r] * w).astype(np.complex64)
        a = np.fft.fft(a.astype(np.complex128), axis=0).astype(np.complex64)
        last = ns * R == M
        for r in range(R):
            i = (j + r * ns) * TT + row if last else row * M + (j - k) * R + k + r * ns
            W[_pad(i)] = a[r]
    return W


def k9w_model(x, h2, state, grid=3):
    """A numpy model of K9's wide form (``csrc/channelizer_wide.cu``) at
    ``k9_plan``'s layout, CTA by CTA of a grid of ``grid``: tiles of TT rows
    grid-strided; each tile's FIR chunk by chunk of C branches, a chunk's
    rows staged (span: TT + K - 1 rows of xp, zeros past the end; rows: TT
    rows, the K - 1 older read from xp), jobs of R rows of one branch
    sliding a ring of R rows in f32 in k order into the padded tile W at
    row-major q M + c C + p; the passes; the store of a tile in parts, part
    c (flat indices q M + c C + p, channel-major: y[m, t0 + t] at m TT + t)
    before the CTA's next tile writes chunk c, the last tile's at the end;
    the carry. W lives from tile to tile with NaN where never written.
    Returns (y (M, T), carry, how many times each y was written)."""
    K, M = h2.shape
    T = len(x) // M
    plan = pch.k9_plan(M, K)
    assert plan["form"] == "wide"
    TT, C, R, span = plan["TT"], plan["C"], plan["R"], plan["stage"] == "span"
    taps = h2.astype(np.float32)
    st = np.zeros((K - 1, M), np.complex64) if state is None else state
    xp = np.concatenate([st, x.reshape(T, M), np.zeros((TT + K, M), np.complex64)])
    passes = _wide_twiddles(M)
    ntiles = -(-T // TT)
    y = np.full((M, T), np.nan, np.complex64)
    written = np.zeros((M, T), int)

    def store(W, tp, c):
        u = np.arange(TT * C)
        i = u // C * M + c * C + u % C
        m, t = i // TT, i % TT
        ok = tp + t < T
        y[m[ok], tp + t[ok]] = W[_pad(i[ok])]
        np.add.at(written, (m[ok], tp + t[ok]), 1)

    for cta in range(min(grid, ntiles)):
        W = np.full(_pad(TT * M) + 2, np.nan, np.complex64)
        prev = None
        for ct in range(cta, ntiles, min(grid, ntiles)):
            t0 = ct * TT
            for c in range(M // C):
                if prev is not None:
                    store(W, prev, c)
                cols = slice(c * C, c * C + C)
                S = xp[t0:t0 + TT + K - 1, cols] if span else xp[t0 + K - 1:t0 + K - 1 + TT, cols]
                p = np.arange(C)
                for q0 in range(0, TT, R):
                    def own(i):
                        return S[q0 + K - 1 + i] if span else S[q0 + i]

                    def older(q):
                        if span:
                            return S[q0 + q]
                        return S[q0 + q - (K - 1)] if q0 + q >= K - 1 else xp[t0 + q0 + q, cols]

                    ring = [own(i) for i in range(R)]
                    re = np.zeros((R, C), np.float32)
                    im = np.zeros((R, C), np.float32)
                    for k0 in range(0, K, R):
                        nw = [older(K - 1 - (k0 + u)) if 0 < k0 + u < K else None
                              for u in range(R)]
                        for u in range(R):
                            k = k0 + u
                            if k >= K:
                                break
                            if k > 0:
                                ring[(R - u) % R] = nw[u]
                            h = taps[k, cols]
                            for i in range(R):
                                v = ring[(i - u) % R]
                                re[i] = re[i] + h * v.real.astype(np.float32)
                                im[i] = im[i] + h * v.imag.astype(np.float32)
                    for i in range(R):
                        W[_pad((q0 + i) * M + c * C + p)] = re[i] + 1j * im[i]
            _wide_passes(W, M, TT, passes)
            prev = t0
        for c in range(M // C):
            store(W, prev, c)
    return y, xp[T:T + K - 1].copy(), written


#: (M, K, T): the three shapes the old wide form was modelled at, the
#: largest M the wide form takes, T < K - 1 (the carry holds state rows),
#: and K past the span stage of M = 2048 (the rows stage)
K9W_CASES = [(2048, 8, 16), (64, 40, 64), (4096, 2, 8), (16384, 8, 4), (64, 40, 16),
             (2048, 9, 12)]


@pytest.mark.parametrize("M,K,T", K9W_CASES)
def test_wide_form_index_map(M, K, T):
    """K9's wide form, modelled in numpy (``k9w_model``), on a stream cut in
    halves (the second half reads the carried rows) and in one shot: each
    within 1e-5 of max|y| of the numpy golden's and JAX's one-shot run,
    every y written once (no NaN of an unwritten tile slot reaches y), the
    carries equal to JAX's and to the plain version's."""
    x = _noise(M * T, M + K + 1)
    h2 = design_prototype(M, K).reshape(K, M).astype(np.float32)
    golden = channelize_numpy(x, M, K)
    jch = JaxChannelizer(M, K, jit=False)
    jy, jst = jch(c2ri(x))
    jy = ri2c(np.asarray(jy))
    y, st, n = k9w_model(x, h2, None)
    assert (n == 1).all() and np.isfinite(y).all()
    assert _rel(y, golden) < REL and _rel(y, jy) < REL
    np.testing.assert_array_equal(st, _state(jst))
    h = T // 2
    y1, st1, n1 = k9w_model(x[:h * M], h2, None)
    y2, st2, n2 = k9w_model(x[h * M:], h2, st1)
    assert (n1 == 1).all() and (n2 == 1).all()
    y12 = np.concatenate([y1, y2], axis=1)
    assert _rel(y12, golden) < REL and _rel(y12, jy) < REL
    np.testing.assert_array_equal(st2, _state(jst))
    _, sp = channelize_plain(torch.from_numpy(x[h * M:]), torch.from_numpy(h2),
                             torch.from_numpy(st1))
    np.testing.assert_array_equal(st2, sp.numpy())


@pytest.mark.parametrize("M,K,T", [(2048, 8, 16), (64, 40, 64), (4096, 2, 8)])
def test_wide_shapes_match_jax(M, K, T):
    """Beyond K9's limits the plain version matches JAX and the numpy golden."""
    x = _noise(M * T, M + K)
    y, st = Channelizer(M, K, device="cpu")(torch.from_numpy(x))
    jy, jst = JaxChannelizer(M, K, jit=False)(c2ri(x))
    assert _rel(y.numpy(), ri2c(np.asarray(jy))) < REL
    assert _rel(y.numpy(), channelize_numpy(x, M, K)) < REL
    np.testing.assert_array_equal(st.numpy(), _state(jst))


def test_wrapper_on_cpu_is_the_plain_version():
    M, K, T = 16, 8, 64
    x = torch.from_numpy(_noise(M * T, 5))
    ch = Channelizer(M, K, device="cpu")
    st = torch.from_numpy(_noise((K - 1) * M, 6).reshape(K - 1, M))
    a, sa = channelize(x, ch.h2, st)
    b, sb = channelize_plain(x, ch.h2, st)
    assert torch.equal(a, b) and torch.equal(sa, sb)
    assert channelize.launches == 0  # a CPU tensor launches nothing
    with pytest.raises(ValueError, match="samples"):
        channelize(x[:-1], ch.h2)


def test_wide_wrapper_takes_card_tensors_only():
    """K9's wide wrapper launches its kernel or raises: a CPU tensor is
    refused (only ``channelize`` gives a CPU tensor to the plain version),
    and nothing is counted; its counter is among the kernel wrappers'
    (``ops.kernel_wrappers``)."""
    from pycusdr_tpu_torch import ops

    M, K, T = 2048, 8, 4
    x = torch.from_numpy(_noise(M * T, 7))
    h2 = torch.from_numpy(design_prototype(M, K).reshape(K, M).astype(np.float32))
    before = pch.channelize.launches, pch.channelize_wide.launches
    with pytest.raises(ValueError, match="unsupported device"):
        pch.channelize_wide(x, h2)
    assert (pch.channelize.launches, pch.channelize_wide.launches) == before
    assert ops.kernel_wrappers()["channelize_wide"] is pch.channelize_wide
    y, st = channelize(x, h2)  # the plain version
    assert y.shape == (M, T) and st.shape == (K - 1, M)


def test_channelizer_from_jax_round_trip():
    """JAX channelizes the first half; its taps and carry go to a port
    channelizer, which continues the stream: the second half equals JAX's
    second half and the port's own one-shot run."""
    M, K, T = 16, 8, 256
    x = _noise(M * T, 8)
    h = M * T // 2
    jch = JaxChannelizer(M, K, jit=False)
    _, jst = jch(c2ri(x[:h]))
    jy2, jst2 = jch(c2ri(x[h:]), jst)
    ch = channelizer_from_jax(jch.h2, np.asarray(jst), device="cpu")
    assert np.array_equal(ch.h2.numpy(), jch.h2)
    np.testing.assert_array_equal(ch.state.numpy(), _state(jst))
    y2 = ch.process(torch.from_numpy(x[h:])).numpy()
    assert _rel(y2, ri2c(np.asarray(jy2))) < REL
    np.testing.assert_array_equal(ch.state.numpy(), _state(jst2))
    full, _ = Channelizer(M, K, device="cpu")(x)
    np.testing.assert_allclose(y2, full.numpy()[:, T // 2:], rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="state_ri"):
        channelizer_from_jax(jch.h2, np.zeros((2, K, M), np.float32), device="cpu")


def _wideband(spec, M, seed):
    """One FSK packet per channel (same bits, different noise), each at the
    demod IF offset, FFT-interpolated to the wideband rate and mixed to its
    channel (tests/test_channelizer.py:115-145)."""
    N = spec.Nfft
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, N // int(spec.spsym))
    wb = np.zeros(N * M, complex)
    wbn = np.arange(N * M)
    for m in range(M):
        nb = make_fsk_signal(bits, int(spec.spsym), spec.centreFreqOffset / spec.sampleRate,
                             seed=10 + m, noise_std=0.05)
        X = np.fft.fft(nb)
        Xup = np.zeros(N * M, complex)
        Xup[: N // 2] = X[: N // 2]
        Xup[-N // 2:] = X[N // 2:]
        wb += np.fft.ifft(Xup) * M * np.exp(2j * np.pi * m / M * wbn)
    return (wb * M).astype(np.complex64)  # * M: the filter gain split


@pytest.mark.parametrize("master_idx", [0, 3])
def test_channelizer_into_channel_parallel_step(master_idx):
    """BASELINE #5 at tiny_spec, C=4: wideband capture -> channelizer ->
    channel-parallel step with the vote. Each channel's bits and trust and
    the voted pair equal JAX's step on make_mesh({"channel": 4, "dopp":
    1}) fed by JAX's channelizer; the channels agree with the vote."""
    conf = configs.tiny_conf()
    jspec = jax_build_spec(conf, jax_loadProtocol("bench_GFSK")(conf=conf), configs.RADIO)
    spec = spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})
    M = 4
    wb = _wideband(spec, M, seed=5)
    jy, _ = JaxChannelizer(M, jit=False)(c2ri(wb))
    jres = jax_step(jspec, jax_make_mesh({"channel": 4, "dopp": 1}),
                    master_idx=master_idx)(np.asarray(jy))
    y, _ = Channelizer(M, device="cpu")(wb)
    res = build_sharded_demod_step(spec, make_mesh({"channel": 1, "dopp": 1}, devices=["cpu"]),
                                   master_idx=master_idx)(y)
    for k in ("bits", "trust", "bits_voted", "trust_voted", "nSym", "nBits", "shift"):
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]), err_msg=k)
    n = int(res["nSym"][0])
    mid = slice(8, n - 8)
    for c in range(M):
        agree = np.mean(res["bits"][c].numpy()[mid] == res["bits_voted"].numpy()[mid])
        assert agree > 0.93, f"chan {c} disagrees with the vote"
