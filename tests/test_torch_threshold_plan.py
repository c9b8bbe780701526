"""K6's launch plan and its order of summation, on the CPU.

K6 (``csrc/threshold.cu``) runs only on the card, so this file holds a
numpy model of the sums it takes: the parent design's (``thr_pass1``: one
CTA of 256 threads a chunk of ``K6_CHUNK`` samples, thread t adding every
256th sample from t in order, the warp butterfly, the chunk's 8 warps in
order, then the chunk sums in chunk order) and the cluster form's (a
cluster of ``k6_plan(N)["cluster"]`` CTAs a row, CTA r's thread group g
summing chunk r * chunks + g the same way, the group's thread 0 writing
the sum into every CTA's shared memory, every CTA adding them in chunk
order). The two must give the same float32 bits at every N, so the
cluster form's thresholds, y and hit words equal the parent kernel's; the
model's y and hits are held against the plain version (masks equal where
|a - thr| > 1e-5 thr, y within rtol 1e-5, as the card's check). Also:
``k6_plan`` is a function of N alone and covers the row; ``pack_bits`` and
``unpack_bits`` round-trip at any N with the bits past N zero."""

import inspect

import numpy as np
import pytest
import torch

from pycusdr_tpu_torch.ops import demod_kernels as dk

torch.set_num_threads(2)
F32 = np.float32
THREADS = 256  # threads that sum one chunk
NS = [1, 5, 16, 31, 32, 33, 48, 512, 4095, 4096, 4097, 2 ** 13 + 5, 2 ** 16, 2 ** 17,
      33 * 4096 + 7, 2 ** 18, 2 ** 18 + 1, 2 ** 19]
#: the shared memory a block may take
SMEM_LIMIT = 227 * 1024


def _mag(x):
    re, im = x.real.astype(F32), x.imag.astype(F32)
    return np.sqrt(re * re + im * im)


def _chunk_sums(v, N):
    """The sum of each chunk of the (N,) float32 values v as one 256-thread
    group takes it: per thread in sample order, the warp butterfly, the 8
    warps in order. Returns (nch,) float32."""
    nch = -(-N // dk.K6_CHUNK)
    pad = np.zeros(nch * dk.K6_CHUNK, F32)
    pad[:N] = v
    per = pad.reshape(nch, dk.K6_CHUNK // THREADS, THREADS)  # [chunk, i, t]: sample t + 256 i
    s = np.zeros((nch, THREADS), F32)
    for i in range(per.shape[1]):  # the padded samples add +0 to a sum >= +0: no bit moves
        s = s + per[:, i]
    lanes = s.reshape(nch, THREADS // 32, 32)
    for o in (16, 8, 4, 2, 1):  # v += shfl_xor(v, o)
        lanes = lanes + lanes[:, :, np.arange(32) ^ o]
    tot = np.zeros(nch, F32)
    for w in range(THREADS // 32):
        tot = tot + lanes[:, w, 0]
    return tot


def _in_order(parts):
    s = F32(0)
    for p in parts:
        s = F32(s + p)
    return s


def _threshold(s, N, scale):
    return F32(F32(scale) * F32(F32(s) / F32(N)))


def parent_thresholds(x, scale):
    """thr1, thr2 of one block as the three-pass parent kernel sums them."""
    N = x.shape[0]
    a = _mag(x)
    t1 = _threshold(_in_order(_chunk_sums(a, N)), N, scale)
    t2 = _threshold(_in_order(_chunk_sums(np.where(a > t1, t1, a), N)), N, scale)
    return t1, t2


def cluster_thresholds(x, scale):
    """thr1, thr2 of one block as the cluster form sums them: CTA r takes
    chunks r k .. r k + k - 1 and writes each one's sum to index j of every
    CTA's ``sums``, and each CTA adds sums[0 .. nch) in order."""
    N = x.shape[0]
    p = dk.k6_plan(N)
    assert p["form"] == "cluster"
    k, G, nch = p["chunks"], p["cluster"], p["nch"]
    a = _mag(x)
    out = []
    for v in (a, None):
        if v is None:
            v = np.where(a > out[0], out[0], a)
        sums = _chunk_sums(v, N)
        shared = np.zeros((G, 4 * -(-nch // 4)), F32)  # each CTA's sums, zero past nch
        for r in range(G):
            for g in range(k):
                if r * k + g < nch:
                    shared[:, r * k + g] = sums[r * k + g]
        assert all(np.array_equal(shared[0], shared[r]) for r in range(G))
        out.append(_threshold(_in_order(shared[0]), N, scale))
    return tuple(out)


def clip_model(x, t1, t2):
    """y and hit2 of the last pass, one rounded f32 op at a time."""
    a = _mag(x)
    h1 = a > t1
    a1 = np.where(h1, t1, a)
    h2 = a1 > t2
    with np.errstate(divide="ignore", invalid="ignore"):
        g1 = np.where(h1, t1 / np.where(h1, a, F32(1)), F32(1)).astype(F32)
        g2 = np.where(h2, t2 / np.where(h2, a1, F32(1)), F32(1)).astype(F32)
    re = (x.real.astype(F32) * g1) * g2
    im = (x.imag.astype(F32) * g1) * g2
    return re + 1j * im, h2


def _spiky(N, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(N) + 1j * rng.randn(N)) / np.sqrt(2)
    for at in rng.randint(0, N, max(1, N // 2000)):
        x[at:at + 4] += 40.0 * np.exp(2j * np.pi * rng.rand(len(x[at:at + 4])))
    return x.astype(np.complex64)


def test_k6_plan_depends_on_n_alone():
    """One argument, cached: every batch of N-sample blocks runs one plan,
    so a block's sums are the same alone and in any batch."""
    assert list(inspect.signature(dk.k6_plan).parameters) == ["N"]
    assert dk.k6_plan(2 ** 17) is dk.k6_plan(2 ** 17)


@pytest.mark.parametrize("N", NS)
def test_k6_plan_covers_the_row(N):
    p = dk.k6_plan(N)
    nch = -(-N // dk.K6_CHUNK)
    assert p["nch"] == nch
    if N <= dk.K6_MAX_CLUSTER * dk.K6_MAX_CHUNKS * dk.K6_CHUNK:
        assert p["form"] == "cluster"
        k, G = p["chunks"], p["cluster"]
        assert 1 <= k <= dk.K6_MAX_CHUNKS and 1 <= G <= dk.K6_MAX_CLUSTER
        assert (G - 1) * k < nch <= G * k  # every CTA holds a chunk
        assert p["threads"] == 256 * k
        assert p["smem"] == 8 * min(N, k * dk.K6_CHUNK) <= SMEM_LIMIT
    else:
        assert p["form"] == "long" and p["smem"] == 0
    if N in (2 ** 16, 2 ** 17, 2 ** 18):  # the main paths' sizes: 16 CTAs a row
        assert p["cluster"] == 16


@pytest.mark.parametrize("N", [n for n in NS if n <= 2 ** 18])
def test_cluster_order_equals_the_parent_order(N):
    """The cluster form's thresholds are the parent kernel's bit for bit,
    and so are its y and hit words (the same arithmetic on the same
    thresholds; the long form is the parent's three passes)."""
    scale = 4.5
    x = _spiky(N, N % 1013)
    t_par = parent_thresholds(x, scale)
    t_clu = cluster_thresholds(x, scale)
    assert t_clu[0].tobytes() == t_par[0].tobytes() and t_clu[1].tobytes() == t_par[1].tobytes()
    a = np.abs(x.astype(np.complex128))
    thr1 = scale * a.mean()
    thr2 = scale * np.minimum(a, thr1).mean()
    assert abs(float(t_par[0]) - thr1) <= 1e-5 * thr1
    assert abs(float(t_par[1]) - thr2) <= 1e-5 * thr2


@pytest.mark.parametrize("N", [5, 48, 4097, 2 ** 17])
def test_model_matches_plain_version(N):
    """The model's y and packed hits against ``threshold_input_plain`` (the
    two sum in different orders: masks equal where |a - thr| > 1e-5 thr,
    y within rtol 1e-5 where the masks agree) and the words' bits past N
    zero."""
    scale = 4.5
    x = _spiky(N, 7 + N % 11)
    y, h2 = clip_model(x, *cluster_thresholds(x, scale))
    yp, hp = dk.threshold_input_plain(torch.from_numpy(x)[None], scale)
    hp = hp[0].numpy()
    a = np.abs(x.astype(np.complex128))
    thr1 = scale * a.mean()
    a1 = np.minimum(a, thr1)
    thr2 = scale * a1.mean()
    clear = (np.abs(a - thr1) > 1e-5 * thr1) & (np.abs(a1 - thr2) > 1e-5 * thr2)
    assert np.array_equal(h2[clear], hp[clear])
    agree = h2 == hp
    np.testing.assert_allclose(y[agree], yp[0].numpy()[agree], rtol=1e-5, atol=1e-6)
    words = dk.pack_bits(torch.from_numpy(h2)[None])
    assert words.shape == (1, -(-N // 32))
    assert torch.equal(dk.unpack_bits(words, N)[0], torch.from_numpy(h2))


@pytest.mark.parametrize("N", [1, 5, 31, 32, 33, 48, 100, 2 ** 9 + 3, 4096])
def test_pack_bits_roundtrip_any_n(N):
    rng = np.random.RandomState(N)
    m = torch.from_numpy(rng.rand(3, N) > 0.6)
    m[:, -1] = True
    m[0, :] = True  # every bit, the int32 sign among them
    w = dk.pack_bits(m)
    assert w.dtype == torch.int32 and w.shape == (3, -(-N // 32))
    assert torch.equal(dk.unpack_bits(w, N), m)
    rest = 32 * w.shape[1] - N
    if rest:  # the bits past N are zero
        top = (w[:, -1].to(torch.int64) & 0xFFFFFFFF) >> (32 - rest)
        assert not bool(top.any())
