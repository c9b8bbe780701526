"""The port's convolutional coding (``pycusdr_tpu_torch/ops/viterbi.py``)
against the JAX package's (``pycusdr_tpu/ops/viterbi.py``) on the CPU,
where the K7 wrapper runs its plain version.

Tolerances: bits, parities and stream state exactly equal; path-metric
totals exactly equal where the symbols are integer-valued (hard bits,
soft ±1/0, where every f32 sum is exact), and within 1e-6 relative for
random-float soft symbols (the plain version repeats the scan's f32
order, so they are expected equal there too).
"""

import numpy as np
import pytest
import torch

from pycusdr_tpu.ops import viterbi as jv
from pycusdr_tpu_torch.convert import viterbi_stream_state
from pycusdr_tpu_torch.ops import viterbi as pv

KINDS = ("hard", "soft_pm1", "soft_float")


def coded(n_bits, seed):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, n_bits).astype(np.uint8)
    return bits, jv.conv_encode(bits), rng


def channel(kind, sym, rng):
    """Received symbols: hard bits with 4% flips, soft ±1 with 3% flips
    and 10% erasures (0), or soft ±1 plus Gaussian noise (sigma 0.8)."""
    if kind == "hard":
        return (sym ^ (rng.rand(len(sym)) < 0.04)).astype(np.float32)
    x = (sym.astype(np.float32) * 2 - 1)
    if kind == "soft_pm1":
        x[rng.rand(len(x)) < 0.03] *= -1
        x[rng.rand(len(x)) < 0.10] = 0.0
        return x
    return (x + 0.8 * rng.randn(len(x))).astype(np.float32)


def assert_metric(kind, got, want):
    if kind == "soft_float":
        assert got == pytest.approx(want, rel=1e-6)
    else:
        assert got == want


@pytest.mark.parametrize("invert_g2", [True, False])
def test_branch_tables_equal(invert_g2):
    for a, b in zip(pv._branch_tables(invert_g2), jv._branch_tables(invert_g2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("invert_g2", [True, False])
@pytest.mark.parametrize("n", [0, 1, 7, 300])
def test_conv_encode_equal(invert_g2, n):
    bits = np.random.RandomState(n).randint(0, 2, n)
    a, b = pv.conv_encode(bits, invert_g2), jv.conv_encode(bits, invert_g2)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("output", ["bits", "metric"])
@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_viterbi_decode_matches_jax(kind, terminated, output):
    bits, sym, rng = coded(400, 1)
    x = channel(kind, sym, rng)
    if not terminated:
        x = x[2 * 37:]  # enter the trellis mid-stream
    kw = dict(soft=kind != "hard", terminated=terminated)
    if output == "metric":
        assert_metric(kind, pv.viterbi_decode(x, _return_metric=True, device="cpu", **kw),
                      jv.viterbi_decode(x, _return_metric=True, **kw))
        return
    n_bits = None if terminated else len(x) // 2
    got = pv.viterbi_decode(x, n_bits=n_bits, device="cpu", **kw)
    want = jv.viterbi_decode(x, n_bits=n_bits, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if terminated:
        assert np.mean(got != bits) < 0.01  # the channel is within the code's reach


@pytest.mark.parametrize("decode", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_batched_ragged_sweep_matches_jax_per_sequence(kind, decode):
    """S = 3 sequences of unequal lengths in one sweep: each equals JAX's
    decode (streaming start) of that sequence alone; bits beyond a
    sequence's length are 0."""
    _, sym, rng = coded(300, 2)
    x = channel(kind, sym, rng).reshape(-1, 2)
    lengths = [len(x), len(x) - 51, 9]
    batch = np.zeros((3, len(x), 2), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = x[len(x) - n:]
    bits, met = pv.viterbi_sweep(torch.from_numpy(batch), lengths, soft=kind != "hard",
                                 terminated=False, decode=decode)
    for i, n in enumerate(lengths):
        seq = x[len(x) - n:].reshape(-1)
        kw = dict(soft=kind != "hard", terminated=False)
        assert_metric(kind, float(met[i, 0]) + float(met[i, 1]),
                      jv.viterbi_decode(seq, _return_metric=True, **kw))
        if decode:
            assert np.array_equal(bits[i, :n].numpy(), jv.viterbi_decode(seq, n_bits=n, **kw))
            assert not bits[i, n:].any()
    assert (bits is None) == (not decode)


def test_sweep_rejects_bad_arguments():
    x = torch.zeros((2, 5, 2))
    with pytest.raises(ValueError, match="lengths"):
        pv.viterbi_sweep(x, [5, 6], soft=True, terminated=False, decode=True)
    with pytest.raises(ValueError, match="S lengths"):
        pv.viterbi_sweep(x, [5], soft=True, terminated=False, decode=True)
    with pytest.raises(ValueError, match="unsupported device"):
        pv.viterbi_sweep(x.to("meta"), [5, 5], soft=True, terminated=False, decode=True)


#: chunk lengths fed to the streams: short chunks (< 4 and < 64 symbols,
#: the branches that skip the node-sync sweeps) and odd lengths
CHUNKS = [3, 30, 700, 1, 1300, 901, 2100, 64, 1500]


def stream_input(soft, slip, seed=3):
    """Symbols for the streams: 3000 coded bits (hard with flips, or soft
    ±1/0); with ``slip`` one symbol is dropped after 2500, so every later
    pair is misaligned until node sync resyncs."""
    _, sym, rng = coded(3000, seed)
    x = channel("soft_pm1" if soft else "hard", sym, rng)
    return np.r_[x[:2501], x[2502:]] if slip else x


def assert_same_state(p, j):
    assert p.parity == j.parity
    for name in ("carry", "pending"):
        a, b = getattr(p, name), getattr(j, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("slip", [False, True])
@pytest.mark.parametrize("soft", [False, True])
def test_stream_matches_jax_after_every_feed(soft, slip):
    x = stream_input(soft, slip)
    ps = pv.ViterbiStream(soft=soft, device="cpu")
    js = jv.ViterbiStream(soft=soft)
    pos, parities = 0, []
    for n in CHUNKS:
        a, b = ps.feed(x[pos:pos + n]), js.feed(x[pos:pos + n])
        pos += n
        assert a.dtype == b.dtype and np.array_equal(a, b), f"after {pos} symbols"
        assert_same_state(ps, js)
        parities.append(ps.parity)
    assert pos >= len(x)
    # the slip forces one resync; a clean stream keeps its first parity
    assert len(set(parities)) == (2 if slip else 1)


@pytest.mark.parametrize("soft", [False, True])
def test_stream_handed_over_mid_way_continues_identically(soft):
    """A JAX stream's state handed to a port stream after four chunks
    (``convert.viterbi_stream_state``): both then give the same bits."""
    x = stream_input(soft, slip=True, seed=4)
    js = jv.ViterbiStream(soft=soft)
    pos = 0
    for n in CHUNKS[:4]:
        js.feed(x[pos:pos + n])
        pos += n
    ps = viterbi_stream_state(js.carry, js.pending, js.parity, soft=soft, device="cpu")
    assert_same_state(ps, js)
    for n in CHUNKS[4:]:
        a, b = ps.feed(x[pos:pos + n]), js.feed(x[pos:pos + n])
        pos += n
        assert np.array_equal(a, b)
        assert_same_state(ps, js)
