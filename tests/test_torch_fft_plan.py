"""The index mapping of the shared-memory transforms in K2
(``csrc/mf_bank.cu``) and K3 (``csrc/timing_band.cu``), on the CPU.

The CUDA kernels run only on the card, so this file holds a numpy model
of each: the same launch plans (``ops/demod_kernels.py:timing_band_plan``,
``mf_bank_plan``), the same mixed-radix Stockham passes (``fft_radices``,
the twiddle index r k L / (Ns R) of the staged table, the output place
(j - k) R + k + r Ns), the same four-step index maps, and K3's per-group
partials added in the kernel's order (with K3's two real columns packed in
one complex row). The models are held against numpy's
FFT, JAX's ``band_dft_real`` and ``ifft_unnorm_power_colreduce_ri`` and the
plain PyTorch versions, for every power-of-two N from 2^2 to 2^18.

Tolerances (complex64 arithmetic in the model against float64 or other
f32 routes): K3's band bins within 2e-5 of the band's largest magnitude
times log2 N / 16 and spSym exact where the peak is clear; K2's colsum and
colmax within 1e-4 of their maximum (the kernel's bar on the card), and
colargmax equal wherever the top two masks differ by more than 1e-4
relative. The launch plans: dynamic shared memory within the 227 KB a
block may use (four blocks to an SM), a cluster of one, tiles within
``FFT_TILE`` elements and ``FFT_MAX_ROWS`` rows, and the padded
shared-memory layout one-to-one inside the buffer."""

import numpy as np
import pytest
import torch

from pycusdr_tpu.ops.cfft import band_dft_real, ifft_unnorm_power_colreduce_ri
from pycusdr_tpu_torch.ops import demod_kernels as dk

torch.set_num_threads(2)
NS = [2 ** e for e in range(2, 19)]
SMEM_LIMIT = 227 * 1024
#: the kernels' static tile buffer (float2s), csrc/fft_smem.cuh:kFftBuf
FFT_BUF = dk.FFT_TILE + dk.FFT_TILE // 16 + 16 * dk.FFT_MAX_ROWS


def _table(N):
    return dk.twiddle_table(N, "cpu").numpy().view(np.complex64)[:, 0]


def _split_twiddle(m, N, sign):
    """exp(sign 2πi m / N) as the kernels form it: the product of the
    float64-built table's entries at the high and low bits of m (split at
    ceil(log2 N / 2) bits), in complex64; above 2^18 the table's entry."""
    tw = _table(N)
    split = (N.bit_length() - 1 + 1) // 2
    m = np.asarray(m)
    w = tw[m] if N > 2 ** 18 else tw[(m >> split) << split] * tw[m & ((1 << split) - 1)]
    return w if sign > 0 else np.conj(w)


def fft_pad(i):
    return i + (i >> 4)


def stockham_rows(x, sign, twL):
    """The kernels' ``fft_rows``: in-place Stockham passes (radices
    ``fft_radices(L)``) over the rows of x (..., L) complex64, natural
    order in and out; twL[j] = exp(+2πi j / L) from the float64 table."""
    L = x.shape[-1]
    Ns = 1
    for R in dk.fft_radices(L):
        nbf = L // R
        j = np.arange(nbf)
        k = j & (Ns - 1)
        r = np.arange(R)[:, None]
        v = x[..., j[None, :] + r * nbf]  # (..., R, nbf): what each butterfly loads
        if Ns > 1:
            w = twL[r * k[None, :] * (L // (Ns * R))]
            v = v * (w if sign > 0 else np.conj(w))
        F = np.exp(sign * 2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
        F = F.astype(np.complex64)
        V = np.einsum("qr,...rj->...qj", F, v)
        out = np.empty_like(x)
        out[..., ((j - k) * R + k)[None, :] + r * Ns] = V
        x = out
        Ns *= R
    return x


def k3_band_model(x, lo, hi):
    """K3's pass 1 and the partial sum of pass 2: (B, hi - lo) complex64."""
    B, N = x.shape
    p = dk.timing_band_plan(N)
    n1, n2, cw, G, chunks = p["n1"], p["n2"], p["cw"], p["groups"], p["chunks"]
    tw = _table(N)
    twL = tw[::N // n1]
    k = lo + np.arange(hi - lo)
    k1, k2 = k & (n1 - 1), k // n1
    part = np.zeros((B, G, hi - lo), np.complex64)
    for g in range(G):
        for ch in range(chunks):
            c0 = (g * chunks + ch) * cw
            a = np.arange(n1)[:, None]
            c = c0 + np.arange(cw)[None, :]
            cols = x[:, a * n2 + c].transpose(0, 2, 1)  # (B, cw, n1)
            if cw > 1:  # columns 2p and 2p+1 as one complex row, split after the transform
                Z = stockham_rows((cols[:, 0::2] + 1j * cols[:, 1::2]).astype(np.complex64),
                                  -1, twL)
                Zm = np.conj(Z[..., (-np.arange(n1)) % n1])
                A = np.empty((B, cw, n1), np.complex64)
                A[:, 0::2] = np.float32(0.5) * (Z + Zm)
                A[:, 1::2] = np.float32(0.5) * (Z - Zm) * np.complex64(-1j)
            else:
                A = stockham_rows(cols.astype(np.complex64), -1, twL)
            A = A * _split_twiddle(c.T * np.arange(n1)[None, :], N, -1)
            acc = part[:, g]
            for cc in range(cw):
                w = np.conj(tw[(((c0 + cc) * k2) & (n2 - 1)) * n1])
                acc = acc + w * A[:, cc, k1]
            part[:, g] = acc
    band = part[:, 0]
    for g in range(1, G):
        band = band + part[:, g]
    return band


def _bands(N):
    """The band kinds: from bin 0, up to N/2+1, one bin wide, and across a
    tile boundary of k = k1 + n1 k2 (and of k1 = 0)."""
    n1 = dk.timing_band_plan(N)["n1"]
    half = N // 2 + 1
    edge = min(n1, half - 1)
    return {"lo0": (0, min(half, 40)), "top": (max(half - 40, 0), half),
            "one": (half // 3, half // 3 + 1),
            "straddle": (max(edge - 3, 0), min(edge + 5, half))}


@pytest.mark.parametrize("kind", ["lo0", "top", "one", "straddle"])
@pytest.mark.parametrize("N", NS)
def test_k3_model_matches_band_dft(N, kind):
    lo, hi = _bands(N)[kind]
    rng = np.random.RandomState(N % 9973 + len(kind))
    x = rng.randn(2, N).astype(np.float32)
    got = k3_band_model(x, lo, hi)
    want = np.fft.rfft(x.astype(np.float64))[:, lo:hi]
    jr = np.asarray(band_dft_real(x, lo, hi))
    jax_bins = jr[:, 0] + 1j * jr[:, 1]
    scale = np.abs(want).max()
    tol = 2e-5 * scale * max(1.0, np.log2(N) / 16)
    assert np.abs(got - want).max() <= tol
    assert np.abs(got - jax_bins).max() <= 2 * tol


@pytest.mark.parametrize("N", NS)
def test_k3_model_spsym_matches_plain(N):
    """A tone at a band bin: the model's argmax and spSym equal the plain
    K3's and JAX's band; the whole band [0, N/2+1) and an all-zero row
    (first bin) ride along."""
    half = N // 2 + 1
    rng = np.random.RandomState(N % 101)
    kt = max(1, (2 * half) // 5)
    n = np.arange(N)
    x = np.stack([0.1 * rng.randn(N) + np.cos(2 * np.pi * kt * n / N + 0.3),
                  np.zeros(N)]).astype(np.float32)
    band = k3_band_model(x, 0, half)
    k = np.argmax(band.real * band.real + band.imag * band.imag, axis=1)
    assert k[0] == kt and k[1] == 0
    sp, _, cv = dk.timing_band_plain(torch.from_numpy(x), 0, half)
    assert sp[0].item() == np.float32(N) / np.float32(kt)
    assert sp[0].item() == np.float32(N / k[0])
    assert cv[1].item() == 0.0


def k2_model(S, masks, shift, sum_lo, sum_hi):
    """K2's two passes over the plan's tiles: (colsum, colmax, colargmax)."""
    B, N = S.shape
    M = masks.shape[0]
    p = dk.mf_bank_plan(N, M, B)
    n1, n2, C, R, Mg = p["n1"], p["n2"], p["C"], p["R"], p["Mg"]
    tw = _table(N)
    sh = np.broadcast_to(shift, (B,)) & (N - 1)
    Y = np.empty((B, M, n1, n2), np.complex64)
    for c0 in range(0, n2, C):  # pass 1: blocks (tile, m, b), vectorised over m and b
        k1 = np.arange(n1)[:, None]
        k = k1 * n2 + c0 + np.arange(C)[None, :]  # (n1, C)
        x = S[np.arange(B)[:, None, None], (k[None] + sh[:, None, None]) & (N - 1)]
        x = x[:, None] * masks[None][:, :, k]  # (B, M, n1, C)
        A = stockham_rows(x.transpose(0, 1, 3, 2), 1, tw[::N // n1])  # (B, M, C, n1)
        k2 = c0 + np.arange(C)
        Y[:, :, :, c0:c0 + C] = (A * _split_twiddle(k2[:, None] * np.arange(n1)[None, :], N, 1)
                                 ).transpose(0, 1, 3, 2)
    out = [np.empty((B, N), np.float32), np.empty((B, N), np.float32), np.empty((B, N), np.int32)]
    for r0 in range(0, n1, R):  # pass 2: blocks (row tile, b)
        s = np.zeros((B, R, n2), np.float32)
        mx = np.zeros((B, R, n2), np.float32)
        arg = np.zeros((B, R, n2), np.int32)
        for m0 in range(0, M, Mg):
            rows = stockham_rows(Y[:, m0:m0 + Mg, r0:r0 + R], 1, tw[::N // n2])
            for mm in range(rows.shape[1]):
                m = m0 + mm
                v = rows[:, mm]
                pw = v.real * v.real + v.imag * v.imag
                if sum_lo <= m < sum_hi:
                    s = s + pw
                take = (pw > mx) | (m == 0)
                mx = np.where(take, pw, mx)
                arg = np.where(take, m, arg)
        n = r0 + np.arange(R)[:, None] + n1 * np.arange(n2)[None, :]
        for o, v in zip(out, (s, mx, arg)):
            o[:, n] = v
    return out


def _k2_inputs(N, M, B, seed):
    rng = np.random.RandomState(seed)
    S = (rng.randn(B, N) + 1j * rng.randn(B, N)).astype(np.complex64)
    masks = (rng.randn(M, N) + 1j * rng.randn(M, N)).astype(np.complex64)
    shift = rng.randint(0, N, B).astype(np.int32)
    return S, masks, shift


def _assert_k2_close(got, S, masks, shift, sum_lo, sum_hi):
    N = S.shape[1]
    idx = (np.arange(N)[None, :] + shift[:, None]) % N
    X = np.fft.ifft(np.take_along_axis(S.astype(np.complex128), idx, 1)[:, None] * masks[None],
                    axis=-1) * N
    P = X.real ** 2 + X.imag ** 2
    ws, wm = P[:, sum_lo:sum_hi].sum(axis=1), P.max(axis=1)
    assert np.abs(got[0] - ws).max() <= 1e-4 * ws.max()
    assert np.abs(got[1] - wm).max() <= 1e-4 * wm.max()
    top2 = -np.sort(-P, axis=1)[:, :2]
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0]
    assert np.all((got[2] == np.argmax(P, axis=1)) | ~clear)
    return P


@pytest.mark.parametrize("N", NS)
def test_k2_model_matches_ifft(N):
    M, B = (3, 2) if N <= 2 ** 14 else (2, 1)
    S, masks, shift = _k2_inputs(N, M, B, N % 997)
    got = k2_model(S, masks, shift, 1, M)
    _assert_k2_close(got, S, masks, shift, 1, M)


@pytest.mark.parametrize("N,M,B", [(2 ** 10, 8, 1), (2 ** 12, 16, 2), (2 ** 9, 32, 64)])
def test_k2_model_matches_jax_colreduce(N, M, B):
    """Against JAX's fused op on the same rolled products (a mask-sum
    subset), and the plain K2 on the same inputs."""
    S, masks, shift = _k2_inputs(N, M, B, 7 * M + B)
    lo, hi = 1, M - 2
    got = k2_model(S, masks, shift, lo, hi)
    idx = (np.arange(N)[None, :] + shift[:, None]) % N
    x = np.take_along_axis(S, idx, 1)[:, None] * masks[None]
    ri = np.stack([x.real, x.imag], axis=-2).astype(np.float32)
    js, jm, _ = (np.asarray(v) for v in ifft_unnorm_power_colreduce_ri(ri, lo, hi))
    assert np.abs(got[0] - js).max() <= 1e-4 * js.max()
    assert np.abs(got[1] - jm).max() <= 1e-4 * jm.max()
    ps, pm, pa = dk.mf_bank_colreduce_plain(torch.from_numpy(S), torch.from_numpy(masks),
                                            torch.from_numpy(shift), lo, hi)
    P = _assert_k2_close(got, S, masks, shift, lo, hi)
    assert np.abs(got[0] - ps.numpy()).max() <= 1e-4 * js.max()
    top2 = -np.sort(-P, axis=1)[:, :2]
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0]
    assert np.all((got[2] == pa.numpy()) | ~clear)


def test_stockham_radix_plan():
    for e in range(1, 10):
        L = 2 ** e
        assert np.prod(dk.fft_radices(L)) == L
        x = (np.random.RandomState(e).randn(3, L) + 1j).astype(np.complex64)
        got = stockham_rows(x, -1, _table(L))
        assert np.abs(got - np.fft.fft(x)).max() <= 1e-5 * np.abs(x).sum(axis=1).max()


def _tile_indices(rows, L):
    pitch = dk.fft_pitch(L)
    i = np.arange(L)
    return (np.arange(rows)[:, None] * pitch + fft_pad(i)[None, :]).ravel()


@pytest.mark.parametrize("N", NS)
def test_launch_plans(N):
    """Shared bytes within a block's 227 KB (four blocks to an SM), a
    cluster of one, tiles within the buffer and one-to-one, grids that
    cover N, K2's pass-2 outputs within a thread's eight."""
    assert 4 * (dk.FFT_SMEM_BYTES + 1024) <= 228 * 1024  # four blocks on an SM
    p3 = dk.timing_band_plan(N)
    assert p3["cluster"] == 1 and p3["smem"] <= SMEM_LIMIT
    assert p3["n1"] * p3["n2"] == N and p3["n1"] <= dk.FFT_MAX_L
    assert p3["groups"] * p3["chunks"] * p3["cw"] == p3["n2"]
    assert p3["n1"] * p3["cw"] <= dk.FFT_TILE and p3["cw"] <= dk.FFT_MAX_ROWS
    tiles = [(p3["cw"], p3["n1"])]
    for M in (1, 3, 8, 16, 32):
        for B in (1, 16, 64):
            p2 = dk.mf_bank_plan(N, M, B)
            n1, n2, C, R, Mg = (p2[k] for k in ("n1", "n2", "C", "R", "Mg"))
            assert p2["cluster"] == 1 and p2["smem"] <= SMEM_LIMIT
            assert n1 * n2 == N and max(n1, n2) <= dk.FFT_MAX_L and n1 >= n2
            assert p2["grid1"] == (n2 // C, M, B) and n2 % C == 0
            assert p2["grid2"] == (n1 // R, B) and n1 % R == 0
            assert C * n1 <= dk.FFT_TILE and Mg * R * n2 <= dk.FFT_TILE
            assert C <= dk.FFT_MAX_ROWS and Mg * R <= dk.FFT_MAX_ROWS and 1 <= Mg <= M
            assert R * n2 <= dk.FFT_THREADS * dk.K2_OUT
            tiles += [(C, n1), (Mg * R, n2)]
    for rows, L in tiles:
        idx = _tile_indices(rows, L)
        assert len(np.unique(idx)) == idx.size and idx.max() < FFT_BUF
    if N >= 2 ** 16:  # at the main paths' sizes B=1 fills the card's SMs in K2's passes
        p = dk.mf_bank_plan(N, 8, 1)
        assert p["grid1"][0] * p["grid1"][1] >= dk.SM_COUNT / 2
        assert p["grid2"][0] >= dk.SM_COUNT - 4


def test_plans_refuse_bad_n():
    for N in (2, 3, 12):
        with pytest.raises(ValueError):
            dk.timing_band_plan(N)
        with pytest.raises(ValueError):
            dk.mf_bank_plan(N, 4, 1)
