"""The port's whole-capture processors (``dsp/block.py``:
``build_process_stream``, one block at a time with the carry on the device,
and ``build_process_capture``, the blocks framed on the device and run as
one batch) against JAX's (``pycusdr_tpu/dsp/block.py:427,458``) on the
bench_FSK input of ``tests/test_batching.py:272``, at K = 5 and 6 hops, JAX's
capture at its default chunk and at ``chunk=3``. The bar is the golden table
of ``tests/test_dsp_golden.py:89-132`` on every block (the routes drop E, as
JAX's do), and the carry bit-equal. The port's two routes are decision-equal
to each other, and ``Demodulator.processCapture`` frames the same blocks as
``build_process_capture`` and gives their decisions."""

import numpy as np
import pytest
import torch

from conftest import make_fsk_signal
from pycusdr_tpu.dsp.block import build_process_capture as jax_capture
from pycusdr_tpu.dsp.block import build_process_stream as jax_stream
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch.dsp.block import (
    build_process_capture,
    build_process_stream,
    frame_blocks,
    unpack_rows,
)
from pycusdr_tpu_torch.dsp.spec import build_spec
from pycusdr_tpu_torch.models import UHF
from pycusdr_tpu_torch.protocol import loadProtocol

torch.set_num_threads(2)

KS = (5, 6)
#: the decisions of a block (``bench/hw_selfcheck.py``'s)
DECISIONS = ("bits", "trust", "symbols", "centres", "nSym", "nBits", "shift")
#: (output, bar) of the golden table's analog rows
ANALOG = (("dopp_idx", 0.01), ("doppler_hz", 1.0), ("spSym", 1e-3), ("codeOffset", 0.05),
          ("snr_db", 0.5))


@pytest.fixture(scope="module")
def specs(bench_conf):
    return (jax_build_spec(bench_conf, jax_loadProtocol("bench_FSK")(conf=bench_conf), "UHF-H"),
            build_spec(bench_conf, loadProtocol("bench_FSK")(conf=bench_conf), "UHF-H"))


def _capture(spec, K):
    """``tests/test_batching.py:286-294``: the carry and K hops of bench_FSK."""
    N, ov = spec.Nfft, spec.sigOverlap
    hop = N - ov
    rng = np.random.RandomState(8 + K)
    bits = rng.randint(0, 2, (ov + hop * K) // 16 + 8)
    sig = make_fsk_signal(bits, 16, 38400 / spec.sampleRate, seed=5, noise_std=0.05)
    sig = np.r_[sig, np.zeros(hop * K + ov, np.complex64)]
    return sig[:ov], sig[ov:ov + K * hop].reshape(K, hop)


@pytest.fixture(scope="module")
def runs(specs):
    """K -> (JAX's stream, JAX's capture at its default chunk, at chunk=3,
    the port's stream, the port's capture): each (res as numpy, carry)."""
    jspec, spec = specs
    out = {}
    for K in KS:
        carry, hops = _capture(spec, K)
        jargs = (np.stack([c2ri(h) for h in hops]), c2ri(carry))
        targs = (torch.from_numpy(hops), torch.from_numpy(carry))
        routes = (jax_stream(jspec), jax_capture(jspec), jax_capture(jspec, chunk=3),
                  build_process_stream(spec, device="cpu"),
                  build_process_capture(spec, device="cpu"))
        res = []
        for i, fn in enumerate(routes):
            r, c = fn(*(jargs if i < 3 else targs))
            c = np.asarray(c)
            res.append(({k: np.asarray(v) for k, v in r.items()},
                        c[0] + 1j * c[1] if i < 3 else c))
        out[K] = res
    return out


def _assert_golden(got, ref, W):
    assert set(got) == set(ref)
    for k in ("bits", "trust", "nSym", "nBits", "shift"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for b, n in enumerate(ref["nSym"]):
        sym = got["symbols"][b, :n] == ref["symbols"][b, :n]
        assert np.mean(sym) > 0.999, f"block {b}: symbols"
        d = np.abs(got["centres"][b, :n] - ref["centres"][b, :n])
        assert d.max() <= W and np.mean(d == 0) > 0.75, f"block {b}: centres"
    for k, bar in ANALOG:
        d = np.abs(got[k] - ref[k])
        assert np.all((d <= bar) | (got[k] == ref[k])), k  # equal covers -inf SNR


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("route", ["stream", "capture"])
@pytest.mark.parametrize("jax_route", ["stream", "capture", "capture_chunk3"])
def test_route_matches_jax(runs, specs, K, route, jax_route):
    """Each port route against each JAX route: the golden table on every
    block, the carry bit-equal."""
    jres, jcarry = runs[K][("stream", "capture", "capture_chunk3").index(jax_route)]
    res, carry = runs[K][3 if route == "stream" else 4]
    assert res["bits"].shape[0] == K
    _assert_golden(res, jres, specs[1].windowWidth)
    np.testing.assert_array_equal(carry, jcarry.astype(np.complex64))


@pytest.mark.parametrize("K", KS)
def test_port_routes_decision_equal(runs, K):
    """The stream and the capture route: every decision and the carry equal;
    the analog outputs within f32 rounding of the batched FFT."""
    (a, ca), (b, cb) = runs[K][3], runs[K][4]
    assert set(a) == set(b)
    for k in DECISIONS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(ca, cb)
    for k in ("mags", "spSym", "codeOffset", "doppler_hz", "quality_db"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_frame_blocks_is_overlap_save():
    """Block k of ``frame_blocks`` is samples [k hop, k hop + Nfft) of the
    carry and the hops; the tail is the last ov samples; the batch is
    contiguous."""
    ov, hop, K = 6, 10, 4
    head = torch.arange(ov, dtype=torch.float32).to(torch.complex64)
    new = torch.arange(ov, ov + K * hop, dtype=torch.float32).to(torch.complex64)
    blocks, tail = frame_blocks(head, new, ov + hop)
    sig = torch.cat([head, new])
    assert blocks.shape == (K, ov + hop) and blocks.is_contiguous()
    for k in range(K):
        assert torch.equal(blocks[k], sig[k * hop:k * hop + ov + hop])
    assert torch.equal(tail, sig[-ov:])


@pytest.mark.parametrize("K", KS)
def test_process_capture_frames_as_capture(bench_conf, specs, K):
    """``Demodulator.processCapture`` (dispatches of at most 4 hops) hands
    the block graph the blocks ``build_process_capture`` frames, and its
    rows give the capture route's decisions."""
    spec = specs[1]
    carry, hops = _capture(spec, K)
    dem = UHF.Demodulator(bench_conf, loadProtocol("bench_FSK")(conf=bench_conf), "UHF-H",
                          device="cpu")
    dem.get_signalBufferHostPointer()[:spec.sigOverlap] = carry
    seen, rows = [], []
    graph = dem._process_batch

    def record(blocks, **kw):
        seen.append(blocks.clone())
        rows.append(graph(blocks, **kw))
        return rows[-1]

    dem._process_batch = record
    dem.processCapture(hops.reshape(-1), max_hops_per_dispatch=4)
    assert [b.shape[0] for b in seen] == [min(4, K - i) for i in range(0, K, 4)]
    want, _ = build_process_capture(spec, device="cpu")(torch.from_numpy(hops),
                                                         torch.from_numpy(carry))
    blocks, _ = frame_blocks(torch.from_numpy(carry), torch.from_numpy(hops.reshape(-1)),
                             spec.Nfft)
    assert torch.equal(torch.cat(seen), blocks)
    got = unpack_rows(torch.cat(rows), spec)
    for k in DECISIONS:
        assert torch.equal(got[k], want[k]), k
