"""A numpy model of K7 (``pycusdr_tpu_torch/csrc/viterbi.cu``), the
Viterbi trellis kernel, on the CPU.

The CUDA kernel runs only on the card, so this file holds a lane-level
model of one warp of it: lane l owns states l and l + 32, holds their
metrics before the last step's minimum is subtracted, and reads its
predecessors' from lanes l >> 1 and 16 + (l >> 1) (the shuffles, then
the subtraction); the candidate adds, the strict compare for the decision bit
and ``fminf`` for the kept value; the step minimum as the integer minimum
of an order-preserving u32 key of each f32 (``redux.sync``), mapped back;
the 32-step full chunk and the tail; the decision words stored as the
kernel stores its (S, Tmax) uint2 scratch (lane j keeps step j's two
ballots); the first-least-state butterfly; and the traceback from those
words, chunk by chunk. The model is held against the plain version
(``viterbi_sweep_plain``) and JAX's ``viterbi_decode``, and
``ViterbiStream.feed`` is held to one sweep a feed.

Tolerances: metrics and bits exactly equal, for every input kind (the
model does the kernel's f32 operations in the scan's order, so they are
expected equal to the plain version's; ``np.array_equal`` holds -0 ==
+0, which is all a signed zero may change). The key map: exact.
"""

import numpy as np
import pytest
import torch

from pycusdr_tpu.ops import viterbi as jv
from pycusdr_tpu_torch.ops import viterbi as pv

torch.set_num_threads(2)
F32 = np.float32
LANE = np.arange(32)
SRC_LO, SRC_HI = LANE >> 1, 16 + (LANE >> 1)
KINDS = ("hard", "soft_pm1", "soft_gauss")
LENGTHS = (0, 1, 31, 32, 33, 63, 64, 65, 2144)


# ------------------------------------------------------------- the key map


def f32_key(f):
    """The kernel's ``f32_key``: bits ^ 0x80000000 for a clear sign bit,
    ~bits for a set one (an arithmetic shift makes the mask)."""
    u = np.asarray(f, F32).view(np.uint32)
    return u ^ ((u.view(np.int32) >> 31).view(np.uint32) | np.uint32(0x80000000))


def key_f32(k):
    """The kernel's ``key_f32``, the inverse of ``f32_key``."""
    k = np.asarray(k, np.uint32)
    return (k ^ (~(k.view(np.int32) >> 31).view(np.uint32) | np.uint32(0x80000000))).view(F32)


def key_values(seed):
    """f32 values with negatives, ±0, 1e6, subnormals, ±inf and repeats."""
    rng = np.random.RandomState(seed)
    tiny = np.finfo(F32).tiny
    special = np.array([0.0, -0.0, 1e6, -1e6, tiny / 8, -tiny / 8, tiny, -tiny, np.inf,
                        -np.inf, 1.0, 1.0, -1.0, -1.0, 3.5, -3.5], F32)
    rand = np.r_[rng.randn(200) * 10 ** rng.uniform(-40, 30, 200),
                 rng.randint(-4, 5, 56)].astype(F32)
    return np.r_[special, rand].astype(F32)


def test_key_inverse_is_identity():
    x = key_values(0)
    assert np.array_equal(key_f32(f32_key(x)).view(np.uint32), x.view(np.uint32))


def test_key_order_is_float_order():
    """Sorted by key is sorted as floats, with -0 before +0."""
    x = key_values(1)
    y = x[np.argsort(f32_key(x), kind="stable")]
    assert np.all(y[:-1] <= y[1:])
    negative = y[y == 0].view(np.uint32) >> 31  # every -0 keys below every +0
    assert negative[0] == 1 and negative[-1] == 0 and np.all(np.diff(negative.astype(int)) <= 0)


@pytest.mark.parametrize("seed", range(8))
def test_key_minimum_equals_float_minimum(seed):
    """The minimum through the keys of 32-lane groups (one per warp step)
    equals np.minimum.reduce of the f32 values."""
    x = key_values(seed)
    x = np.random.RandomState(seed).permutation(np.r_[x, x[:16]])  # 288 = 9 x 32
    for w in x.reshape(-1, 32):
        got = key_f32(np.minimum.reduce(f32_key(w)))
        assert got == np.minimum.reduce(w)


# ------------------------------------------------------ one warp of the kernel


def expected(state, b):
    """The kernel's ``expected`` with the inversion on, as f32 pairs."""
    reg = (np.asarray(state) << 1) | b
    e0 = np.array([bin(r & pv.G1).count("1") & 1 for r in np.ravel(reg)], F32)
    e1 = np.array([(bin(r & pv.G2).count("1") & 1) ^ 1 for r in np.ravel(reg)], F32)
    return e0, e1


def branch_metric(e, r0, r1, soft):
    """The kernel's ``branch_metric`` in f32, one value per lane."""
    r0, r1 = F32(r0), F32(r1)
    if soft:
        s0 = e[0] * F32(2) - F32(1)
        s1 = e[1] * F32(2) - F32(1)
        return -(s0 * r0 + s1 * r1)
    return np.abs(e[0] - r0) + np.abs(e[1] - r1)


def ballot(pred):
    return np.uint32(np.sum(pred.astype(np.uint64) << LANE.astype(np.uint64)))


class Warp:
    """One warp's registers, the metrics un-normalised as the kernel holds
    them: pm[l] = lo[l] - m, pm[l + 32] = hi[l] - m (m the last step's
    minimum, 0 before the first), and tot."""

    def __init__(self, soft, terminated):
        b = LANE & 1
        self.soft = soft
        self.e = [expected(SRC_LO, b), expected(SRC_LO | 32, b),
                  expected(SRC_HI, b), expected(SRC_HI | 32, b)]
        self.lo = np.where(terminated & (LANE != 0), F32(1e6), F32(0)).astype(F32)
        self.hi = np.full(32, 1e6 if terminated else 0.0, F32)
        self.m = self.tot = F32(0)

    def acs(self, r0, r1):
        """``acs``: one step; returns the decision words (w.x, w.y)."""
        bm = [branch_metric(e, r0, r1, self.soft) for e in self.e]
        # the shuffles, then the last step's minimum subtracted
        pa_lo, pb_lo = self.lo[SRC_LO] - self.m, self.hi[SRC_LO] - self.m
        pa_hi, pb_hi = self.lo[SRC_HI] - self.m, self.hi[SRC_HI] - self.m
        ca_lo, cb_lo = pa_lo + bm[0], pb_lo + bm[1]
        ca_hi, cb_hi = pa_hi + bm[2], pb_hi + bm[3]
        w = (ballot(cb_lo < ca_lo), ballot(cb_hi < ca_hi))
        self.lo, self.hi = np.minimum(ca_lo, cb_lo), np.minimum(ca_hi, cb_hi)
        self.m = key_f32(np.minimum.reduce(f32_key(np.minimum(self.lo, self.hi))))  # redux.sync
        self.tot = F32(self.tot + self.m)
        return w


def warp_sweep(x, soft, terminated):
    """One warp of K7 over symbols x (T, 2) f32 with decode on: returns
    (bits (T,) uint8, met (2,) f32, dec (T, 2) uint32 scratch)."""
    T = len(x)
    xp = np.zeros((T + 32, 2), F32)  # a lane reads a symbol only below T
    xp[:T] = x
    w = Warp(soft, terminated)
    dec = np.zeros((T, 2), np.uint32)

    def chunk(t0, n, cur):
        k = np.zeros((32, 2), np.uint32)
        for j in range(n):
            words = w.acs(cur[j, 0], cur[j, 1])  # the symbol broadcasts
            k[LANE == j] = words
        dec[t0:t0 + n] = k[:n]  # lane l stores step t0 + l's words

    nxt = xp[:32].copy()
    t0 = 0
    while t0 + 32 <= T:  # full chunks; the next one's symbols in flight
        cur, nxt = nxt, np.where((t0 + 32 + LANE < T)[:, None], xp[t0 + 32:t0 + 64], nxt)
        chunk(t0, 32, cur)
        t0 += 32
    if T - t0 > 0:  # the tail
        chunk(t0, T - t0, nxt)

    # least final metric and its first state: the kernel's butterfly
    lo, hi = w.lo - w.m, w.hi - w.m
    v = np.where(hi < lo, hi, lo)
    arg = np.where(hi < lo, LANE + 32, LANE)
    for o in (16, 8, 4, 2, 1):
        ov, oi = v[LANE ^ o], arg[LANE ^ o]
        take = (ov < v) | ((ov == v) & (oi < arg))
        v, arg = np.where(take, ov, v), np.where(take, oi, arg)
    met = np.array([w.tot, v[0]], F32)

    bits = np.zeros(T, np.uint8)
    state = 0 if terminated else int(arg[0])
    for t1 in range(T, 0, -32):
        c0 = max(t1 - 32, 0)
        words = dec[c0:t1]  # lane l holds step c0 + l's words
        for j in range(t1 - c0 - 1, -1, -1):
            bits[c0 + j] = state & 1
            word = words[j, 0] if state < 32 else words[j, 1]
            state = (state >> 1) | 32 if (int(word) >> (state & 31)) & 1 else state >> 1
    return bits, met, dec


def received(kind, T, seed):
    """(T, 2) f32 received symbols of random coded bits: hard with 4%
    flips, soft ±1 with 3% flips and 10% erasures (0), or soft ±1 plus
    Gaussian noise (sigma 0.8)."""
    rng = np.random.RandomState(seed)
    sym = jv.conv_encode(rng.randint(0, 2, T))[: 2 * T].reshape(T, 2)
    if kind == "hard":
        return (sym ^ (rng.rand(T, 2) < 0.04)).astype(F32)
    x = sym.astype(F32) * 2 - 1
    if kind == "soft_pm1":
        x[rng.rand(T, 2) < 0.03] *= -1
        x[rng.rand(T, 2) < 0.1] = 0.0
        return x
    return (x + 0.8 * rng.randn(T, 2)).astype(F32)


def plain_decisions(x, soft, terminated):
    """The plain version's decision bits (T, 64) from the same inputs, by
    the scan step it repeats (``pycusdr_tpu/ops/viterbi.py:99-109``)."""
    o0, o1 = pv._branch_tables(True)
    e = np.stack([o0, o1]).astype(F32)
    pm = np.zeros(64, F32)
    if terminated:
        pm[1:] = 1e6
    out = np.zeros((len(x), 64), bool)
    for t, (r0, r1) in enumerate(x):
        if soft:
            sgn = e * F32(2) - F32(1)
            bm = -(sgn[..., 0] * r0 + sgn[..., 1] * r1)
        else:
            bm = np.abs(e[..., 0] - r0) + np.abs(e[..., 1] - r1)
        ca = pm[pv.PA] + bm[pv.B_IN, pv.PA]
        cb = pm[pv.PB] + bm[pv.B_IN, pv.PB]
        out[t] = cb < ca
        pm_new = np.where(out[t], cb, ca)
        pm = pm_new - pm_new.min()
    return out


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_warp_model_matches_plain_and_jax(kind, terminated):
    """At every length of LENGTHS (the chunk edges, 0 and 2144): the
    model's metrics equal the plain version's, its bits equal the plain
    version's and JAX's ``viterbi_decode`` (every step), and its decision
    words are the ballots of the scan's decisions."""
    soft = kind != "hard"
    xs = [received(kind, T, 100 + T) for T in LENGTHS]
    batch = np.zeros((len(LENGTHS), max(LENGTHS), 2), F32)
    for i, x in enumerate(xs):
        batch[i, : len(x)] = x
    bits_p, met_p = pv.viterbi_sweep_plain(torch.from_numpy(batch), list(LENGTHS), soft=soft,
                                           terminated=terminated, decode=True)
    for i, (T, x) in enumerate(zip(LENGTHS, xs)):
        bits, met, dec = warp_sweep(x, soft, terminated)
        assert np.array_equal(met, met_p[i].numpy()), f"T={T}: metrics"
        assert np.array_equal(bits, bits_p[i, :T].numpy()), f"T={T}: bits against plain"
        if T in (1, 33, 65, 2144):  # JAX recompiles its scan per call: the edges only
            want = jv.viterbi_decode(x.reshape(-1), n_bits=T, soft=soft, terminated=terminated)
            assert np.array_equal(bits, want), f"T={T}: bits against JAX"
        if T in (33, 2144):
            take = plain_decisions(x, soft, terminated)
            words = np.stack([np.packbits(take[:, :32], axis=1, bitorder="little"),
                              np.packbits(take[:, 32:], axis=1, bitorder="little")], 1)
            assert np.array_equal(dec, words.view(np.uint32)[..., 0]), f"T={T}: decisions"


# ------------------------------------------------------ one sweep a feed

#: the feeds of tests/test_torch_viterbi.py (short chunks and odd lengths)
CHUNKS = [3, 30, 700, 1, 1300, 901, 2100, 64, 1500]


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("slip", [False, True])
def test_stream_sweeps_once_a_feed(monkeypatch, slip, plain):
    """``ViterbiStream.feed`` calls the sweep at most once (once when the
    feed holds 64 symbols or more), with decode on and at most four
    sequences, through K7's wrapper or ``plain=True``; a slip resyncs."""
    calls = []
    real = pv.viterbi_sweep_plain

    def counted(sym, lengths, **kw):
        calls.append((len(lengths), kw["decode"]))
        return real(sym, lengths, **kw)

    monkeypatch.setattr(pv, "viterbi_sweep_plain", counted)
    rng = np.random.RandomState(5)
    x = received("soft_pm1", 3000, 5).reshape(-1)
    if slip:
        x = np.r_[x[:2501], x[2502:]]
    vs = pv.ViterbiStream(soft=True, device="cpu", plain=plain)
    pos, parities = 0, set()
    for n in CHUNKS + list(rng.randint(1, 80, 6)):
        before = len(calls)
        vs.feed(x[pos:pos + n])
        pos += n
        made = calls[before:]
        assert len(made) == 1 if n >= 64 else len(made) <= 1, f"after {pos}: {made}"
        assert all(dec and 1 <= S <= 4 for S, dec in made), made
        parities.add(vs.parity)
    assert len(parities) == (2 if slip else 1)
