"""NRZ-S (BPSK) in the port against the JAX package: K4n's plain version
against ``extract_bits_nrzs``, K4s's NRZ-S form on the CPU against its
centre-bit form and ``nrzs_rows_plain``, a bench_BPSK block through the port's
block graph against ``build_process_block`` (UHF, and STX with the clip
window, where -2 must win over -1), and bench_BPSK packets through the
port's ``Demodulator`` and ``Decoder`` against JAX's (as
``tests/test_e2e_modem.py:87-101``)."""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as g
from pycusdr_tpu.decode import Decoder as JaxDecoder
from pycusdr_tpu.dsp.block import build_process_block as jax_build_process_block
from pycusdr_tpu.dsp.signal_gen import get_padded_packet as jax_get_padded_packet
from pycusdr_tpu.dsp.signal_gen import modulate_bpsk as jax_modulate_bpsk
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.models import UHF as JaxUHF
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.ops.demod_kernels import extract_bits_nrzs
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu.protocol.benchmark.bench_bpsk import _reference_lut as jax_reference_lut
from pycusdr_tpu_torch.convert import DeviceConsts, spec_from_numpy
from pycusdr_tpu_torch.decode import Decoder
from pycusdr_tpu_torch.dsp.block import build_process_batch, packed_len
from pycusdr_tpu_torch.dsp.signal_gen import get_padded_packet, modulate_bpsk, packet_data
from pycusdr_tpu_torch.models import UHF
from pycusdr_tpu_torch.ops import demod_kernels as dk
from pycusdr_tpu_torch.ops.demod_kernels import nrzs_bits_plain, nrzs_rows_plain
from pycusdr_tpu_torch.protocol import loadProtocol
from pycusdr_tpu_torch.protocol.benchmark.bench_bpsk import _reference_lut

torch.set_num_threads(2)

#: the golden tolerance table (tests/test_dsp_golden.py:89-132) for the
#: block outputs that are not decisions; E is held at rtol 2e-3
TOL = {"dopp_idx": 0.01, "doppler_hz": 1.0, "freq_offset_hz": 1.0, "spSym": 1e-3,
       "codeOffset": 0.05, "snr_db": 0.5}
EXACT = ("bits", "trust", "nBits", "nSym", "symbols", "shift", "clipped_any")


@pytest.mark.parametrize("maskLen", [4, 5])
@pytest.mark.parametrize("span", ["lut", "outside"])
def test_nrzs_bits_plain_matches_jax(maskLen, span):
    """Seeded random symbols (inside the LUT's rows, or from -1 to twice
    its rows, as a 16-mask bank gives symbols the 8-row LUT lacks): bits
    and err exactly JAX's, per block and batched."""
    lut = _reference_lut(maskLen)
    np.testing.assert_array_equal(lut, jax_reference_lut(maskLen))
    M = lut.shape[0]
    rng = np.random.RandomState(maskLen * 10 + (span == "outside"))
    lo, hi = (0, M) if span == "lut" else (-1, 2 * M + 1)
    sym = rng.randint(lo, hi, (3, 500)).astype(np.int32)
    bits, err = nrzs_bits_plain(torch.from_numpy(sym), torch.from_numpy(lut.astype(np.int32)))
    for b in range(3):
        jb, je = extract_bits_nrzs(sym[b], lut.astype(np.int32))
        np.testing.assert_array_equal(bits[b].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(err[b].numpy(), np.asarray(je))
    assert 0 < float(err.float().mean()) < 1, "the case must hold errors and matches"


def test_nrzs_row_pass_on_cpu_is_the_plain_version():
    """K4s's NRZ-S form (``shard_select_nrzs``) on CPU pairs is its
    centre-bit form with bits 0, then ``nrzs_rows_plain`` on those rows:
    bits from the symbols, trust -1 on an error unless the clip window set
    -2, nBits = nSym - 1. Exact."""
    lut = torch.from_numpy(_reference_lut(4).astype(np.int32))
    N, S, B, M, W = 1024, 64, 2, 16, 5
    rng = np.random.RandomState(3)
    pairs = dk.pack_pairs(torch.from_numpy(rng.randint(0, 4, (2, B, S)).astype(np.float32)),
                          torch.from_numpy(rng.randint(0, W * M, (2, B, S)).astype(np.int32)))
    hit = np.zeros((B, N), bool)
    hit[:, [100, 700]] = True
    kw = dict(M=M, Nfft=N, windowWidth=W, spsymMin=8, numSymMax=S, trust_normal=4,
              code_val=torch.ones(B), hits=dk.pack_bits(torch.from_numpy(hit)))
    sp, co = torch.tensor([15.7, 16.2]), torch.tensor([3.5, 0.25])
    L = 5 * S + 12 + 4
    got = dk.shard_select_nrzs(pairs, sp, co, lut, row=torch.zeros((B, L)), **kw)
    base = dk.shard_select(pairs, sp, co, None, row=torch.zeros((B, L)), **kw)
    assert torch.equal(got, nrzs_rows_plain(base.clone(), lut, S))
    bits, err = nrzs_bits_plain(base[:, 2 * S:3 * S].int(), lut)
    assert torch.equal(got[:, :S], bits.float())
    trust, before = got[:, S:2 * S], base[:, S:2 * S]
    assert bool((trust == -2).any()) and bool((trust == -1).any())
    assert torch.equal(trust == -2, before == -2)
    assert torch.equal(trust == -1, (err & (before != -2)) | (before == -1))
    assert got[:, 5 * S + 1].tolist() == (base[:, 5 * S] - 1).tolist()


def _bpsk_spec(mode):
    conf = g._conf(blockSize=9, overlap=7, spsym=8, doppSteps=16, windowWidth=5, maskSize=4)
    conf["Main"]["protocols"] = {"UHF": "bench_BPSK"}
    jspec = jax_build_spec(conf, jax_loadProtocol("bench_BPSK")(conf=conf), "UHF-H")
    if mode == "stx_clip":
        jspec = dataclasses.replace(jspec, doppler_search=False, disable_peak_thresholding=False,
                                    peak_threshold_scale=4.5)
    spec = spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})
    return jspec, spec


def _bpsk_blocks(spec, mode, B=3):
    """B blocks of one BPSK signal at the IF offset, independent noise
    each; in the clip mode a 6-sample burst in every block."""
    rng = np.random.RandomState(12)
    nb = modulate_bpsk(rng.randint(0, 2, spec.Nfft // int(spec.spsym)), int(spec.spsym))
    np.testing.assert_array_equal(
        nb, jax_modulate_bpsk(np.random.RandomState(12).randint(0, 2, spec.Nfft // 8), 8))
    n = np.arange(len(nb))
    base = nb * np.exp(2j * np.pi * spec.centreFreqOffset / spec.sampleRate * n)
    blocks = []
    for b in range(B):
        x = base[:spec.Nfft] + 0.05 * (rng.randn(spec.Nfft) + 1j * rng.randn(spec.Nfft))
        if mode == "stx_clip":
            x[100 + 50 * b:106 + 50 * b] += 60.0
        blocks.append(x)
    return np.stack(blocks).astype(np.complex64)


@pytest.mark.parametrize("mode", ["uhf", "stx_clip"])
@pytest.mark.parametrize("plain", [False, True])
def test_bpsk_block_matches_jax(mode, plain):
    """bench_BPSK (the ``_conf(maskSize=4)`` of tests/test_parallel.py:144-
    148) through the port's graph: the kernel path's structure (CPU
    wrappers, K4n on the rows) and the plain path, against JAX's
    ``build_process_block``: decisions exact, the rest within the golden
    tolerance table."""
    jspec, spec = _bpsk_spec(mode)
    assert spec.bitLUT is None and spec.symbolLUT is not None
    blocks = _bpsk_blocks(spec, mode)
    out = build_process_batch(spec, device="cpu", plain=plain)(blocks)
    jax_block = jax_build_process_block(jspec)
    for b in range(blocks.shape[0]):
        jx = {k: np.asarray(v) for k, v in jax_block(c2ri(blocks[b])).items()}
        assert int(jx["nBits"]) == int(jx["nSym"]) - 1
        for k in EXACT:
            np.testing.assert_array_equal(out[k][b].numpy(), jx[k], err_msg=f"{k} block {b}")
        for k, tol in TOL.items():
            assert abs(float(out[k][b]) - float(jx[k])) <= tol, k
        assert np.allclose(out["E"][b].numpy(), jx["E"], rtol=2e-3)
        n = int(jx["nSym"])
        assert np.abs(out["centres"][b].numpy()[:n] - jx["centres"][:n]).max() <= spec.windowWidth
        trust = jx["trust"]
        assert (trust == -1).any(), "the block must hold NRZ-S transition errors"
        if mode == "stx_clip":
            assert (trust == -2).any() and bool(jx["clipped_any"])


def test_bpsk_packed_rows_kernel_structure_equal_plain():
    """The kernel path's rows (K4 then K4n written into one row) equal the
    plain path's packed dict bit for bit in every decision slot."""
    _, spec = _bpsk_spec("stx_clip")
    blocks = _bpsk_blocks(spec, "stx_clip")
    rows = build_process_batch(spec, device="cpu", packed=True)(blocks)
    ref = build_process_batch(spec, device="cpu", packed=True, plain=True)(blocks)
    S = spec.numSymMax
    assert rows.shape == ref.shape == (3, packed_len(spec))
    assert torch.equal(rows[:, :4 * S], ref[:, :4 * S])
    assert torch.equal(rows[:, 5 * S:5 * S + 2], ref[:, 5 * S:5 * S + 2])
    assert DeviceConsts.from_spec(spec, "cpu").symbolLUT.dtype == torch.int32


def _modem_stream(demod, decoder, sig):
    """Stream ``sig`` through per-block demodulation and the decoder
    (tests/test_e2e_modem.py:run_modem_stream); returns the packets."""
    ov, step = demod.sigOverlap, demod.Nfft - demod.sigOverlap
    n_blocks = int(np.ceil(len(sig) / step)) + 1
    sig = np.r_[sig, np.zeros(n_blocks * step - len(sig) + step, dtype=np.complex64)]
    raw = demod.get_signalBufferHostPointer()
    packets, pos = [], 0
    while pos + step <= len(sig):
        raw[ov:] = sig[pos:pos + step]
        demod.uploadAndFindCarrier(raw)
        bits = demod.demodulate()[0]
        packets.extend(decoder.findFrames(bits, 0)[0])
        raw[:ov] = raw[-ov:]
        pos += step
    return packets


def test_bpsk_packets_match_jax(bench_conf):
    """A clean 1000-bit bench_BPSK packet at the IF offset through the
    port's ``Demodulator`` + ``Decoder`` and through JAX's: the same
    packets, bit for bit, with at most 2 bit errors."""
    conf = {k: (dict(v) if isinstance(v, dict) else v) for k, v in bench_conf.items()}
    conf["Main"] = dict(conf["Main"], PacketLen=1000, protocols={"UHF": "bench_BPSK"})
    conf["GPU"] = {"UHF": dict(conf["GPU"]["UHF"], xcorrMaskSize=4)}
    bits = packet_data(1000, 123)
    sig, _ = get_padded_packet("BPSK", 16, 9600 * 16, offset_freq=38400, raw_bits=bits, pad=6000)
    jsig, _ = jax_get_padded_packet("BPSK", 16, 9600 * 16, offset_freq=38400, raw_bits=bits,
                                    pad=6000)
    np.testing.assert_array_equal(sig, jsig)

    protocol = loadProtocol("bench_BPSK")(conf=conf)
    pkts = _modem_stream(UHF.Demodulator(conf, protocol, "UHF-H", device="cpu"),
                         Decoder(conf, protocol), sig)
    jprotocol = jax_loadProtocol("bench_BPSK")(conf=conf)
    jpkts = _modem_stream(JaxUHF.Demodulator(conf, jprotocol, "UHF-H"),
                          JaxDecoder(conf, jprotocol), sig)
    assert len(pkts) == len(jpkts) >= 1, "BPSK: no packet decoded"
    for p, jp in zip(pkts, jpkts):
        np.testing.assert_array_equal(p.bits, jp.bits)
        assert p.frameStartIdx == jp.frameStartIdx
    assert min(p.checkPacketData() for p in pkts) <= 2
