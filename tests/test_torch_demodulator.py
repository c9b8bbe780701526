"""The port's Demodulator on a multi-block stream (plain path, CPU):
per-block ``process``, batched ``processMany`` and ``processCapture``
give the same healed bit stream, and it equals that of the JAX
package's Demodulator on the same samples (cf. tests/test_batching.py)."""

import numpy as np
import pytest
import torch

from conftest import make_fsk_signal
from pycusdr_tpu.models import UHF as JaxUHF
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch.models import UHF
from pycusdr_tpu_torch.protocol import loadProtocol

torch.set_num_threads(2)
K = 6


@pytest.fixture(scope="module")
def stream(bench_conf):
    protocol = loadProtocol("bench_FSK")(conf=bench_conf)
    d = UHF.Demodulator(bench_conf, protocol, "UHF-H", device="cpu")
    ov, hop = d.sigOverlap, d.Nfft - d.sigOverlap
    rng = np.random.RandomState(3)
    bits = rng.randint(0, 2, (ov + hop * K) // 16 + 8)
    sig = make_fsk_signal(bits, 16, 38400 / d.spec.sampleRate, seed=4, noise_std=0.05)
    # the overlap-save history holds signal too: a block of pure zeros
    # has only rounding noise to decide on, and MKL's CPU FFT rounds a
    # batch differently from a single transform
    return protocol, sig[:ov], sig[ov : ov + hop * K].reshape(K, hop)


def _dem(conf, protocol, history, make=UHF.Demodulator, **kw):
    d = make(conf, protocol, "UHF-H", **kw)
    d.get_signalBufferHostPointer()[: len(history)] = history
    return d


def _per_block(d, hops):
    ov = d.sigOverlap
    raw = d.get_signalBufferHostPointer()
    out = []
    for h in hops:
        raw[ov:] = h
        out.append(d.process(raw))
        raw[:ov] = raw[-ov:]
    return out


def _assert_same(seqA, seqB):
    assert len(seqA) == len(seqB) == K
    for i, (a, b) in enumerate(zip(seqA, seqB)):
        np.testing.assert_array_equal(a["bits"], b["bits"], err_msg=f"bits differ at block {i}")
        np.testing.assert_array_equal(a["trust"], b["trust"], err_msg=f"trust at block {i}")


def test_process_many_matches_per_block(bench_conf, stream):
    protocol, history, hops = stream
    dA, dB = (_dem(bench_conf, protocol, history, device="cpu") for _ in range(2))
    seqA = _per_block(dA, hops)
    seqB = dB.processMany(hops[:3]) + dB.processMany(hops[3:])
    _assert_same(seqA, seqB)
    # overlap-save history left where the per-block API expects it
    ov = dA.sigOverlap
    np.testing.assert_array_equal(dB.get_signalBufferHostPointer()[:ov],
                                  dA.get_signalBufferHostPointer()[:ov])


def test_process_capture_matches_process_many(bench_conf, stream):
    """processCapture frames each dispatch's blocks on the device; a final
    partial hop is zero-padded, and dispatch cap 4 splits the 6 blocks
    into 4 + 2, like the two processMany calls it is held against."""
    protocol, history, hops = stream
    dA, dC, dD = (_dem(bench_conf, protocol, history, device="cpu") for _ in range(3))
    hop = hops.shape[1]
    capture = hops.reshape(-1)[: K * hop - hop // 3]
    padded = np.zeros(K * hop, np.complex64)
    padded[: len(capture)] = capture
    padded = padded.reshape(K, hop)
    seqC = dC.processCapture(capture, max_hops_per_dispatch=4)
    seqD = dD.processMany(padded[:4]) + dD.processMany(padded[4:])
    _assert_same(seqD, seqC)
    seqA = _per_block(dA, hops)
    for i in range(K - 1):  # every whole hop matches live streaming
        np.testing.assert_array_equal(seqA[i]["bits"], seqC[i]["bits"])
    ov = dC.sigOverlap
    np.testing.assert_array_equal(dC.get_signalBufferHostPointer()[:ov],
                                  dD.get_signalBufferHostPointer()[:ov])


def test_process_capture_uploads_one_dispatch_at_a_time(bench_conf, stream):
    """A capture of 2.5 P hops at P = 2: every upload holds at most P hops
    (the carry stays on the device between dispatches), and the results
    equal processMany's over the same dispatches and JAX's processCapture."""
    protocol, history, hops = stream
    P, n_hops = 2, 5
    hop = hops.shape[1]
    capture = hops[:n_hops].reshape(-1)
    dC, dD = (_dem(bench_conf, protocol, history, device="cpu") for _ in range(2))
    sizes = []
    upload = dC._upload

    def spy(host, *args):
        sizes.append(np.asarray(host).size)
        return upload(host, *args)

    dC._upload = spy
    seqC = dC.processCapture(capture, max_hops_per_dispatch=P)
    assert len(sizes) == 1 + 3 and max(sizes) <= P * hop, sizes  # the history, then 2 + 2 + 1
    seqD = sum((dD.processMany(hops[i:min(i + P, n_hops)]) for i in range(0, n_hops, P)), [])
    jprotocol = jax_loadProtocol("bench_FSK")(conf=bench_conf)
    seqJ = _dem(bench_conf, jprotocol, history, make=JaxUHF.Demodulator).processCapture(
        capture, max_hops_per_dispatch=P)
    assert len(seqC) == len(seqD) == len(seqJ) == n_hops
    for i, (c, d, j) in enumerate(zip(seqC, seqD, seqJ)):
        for k in ("bits", "trust"):
            np.testing.assert_array_equal(c[k], d[k], err_msg=f"{k} vs processMany, block {i}")
            np.testing.assert_array_equal(c[k], j[k], err_msg=f"{k} vs JAX, block {i}")
    ov = dC.sigOverlap
    np.testing.assert_array_equal(dC.get_signalBufferHostPointer()[:ov],
                                  dD.get_signalBufferHostPointer()[:ov])


def test_healed_bits_equal_jax_demodulator(bench_conf, stream):
    protocol, history, hops = stream
    jprotocol = jax_loadProtocol("bench_FSK")(conf=bench_conf)
    seqT = _per_block(_dem(bench_conf, protocol, history, device="cpu"), hops)
    seqJ = _per_block(_dem(bench_conf, jprotocol, history, make=JaxUHF.Demodulator), hops)
    _assert_same(seqT, seqJ)
    for t, j in zip(seqT, seqJ):
        assert abs(t["doppler"] - j["doppler"]) < 1.0
        assert abs(t["SNR"] - j["SNR"]) < 0.5
        assert abs(t["spSymEst"] - j["spSymEst"]) < 1e-3


def test_dispatch_collect_and_warmup(bench_conf, stream):
    """warmup touches no streaming state; dispatch snapshots its input, so
    the caller may overwrite the buffer before collect."""
    protocol, history, hops = stream
    dA, dB = (_dem(bench_conf, protocol, history, device="cpu") for _ in range(2))
    dB.warmup()
    ov = dA.sigOverlap
    seqA = _per_block(dA, hops[:2])
    raw = dB.get_signalBufferHostPointer()
    raw[ov:] = hops[0]
    h0 = dB.dispatch(raw)
    block1 = np.r_[raw[-ov:], hops[1]]
    raw[:] = 0
    h1 = dB.dispatch(block1)
    seqB = [dB.collect(h0), dB.collect(h1)]
    for a, b in zip(seqA, seqB):
        np.testing.assert_array_equal(a["bits"], b["bits"])
    with pytest.raises(RuntimeError):
        UHF.Demodulator(bench_conf, protocol, "UHF-H", device="cpu").demodulate()
