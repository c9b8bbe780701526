"""The port's whole per-block graph (plain path, CPU) against the numpy
golden (``dsp/reference.demod_block_numpy``) and the JAX graph, with
the golden tolerance table of ``tests/test_dsp_golden.py:89-132``; the
packed layout against the JAX package's unpacker; batch vs per-block."""

import dataclasses

import numpy as np
import pytest
import torch

from pycusdr_tpu.dsp.block import build_process_block as jax_build_process_block
from pycusdr_tpu.dsp.block import packed_len as jax_packed_len
from pycusdr_tpu.dsp.block import unpack_block_outputs as jax_unpack
from pycusdr_tpu.dsp.reference import demod_block_numpy
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu_torch.convert import spec_from_numpy
from pycusdr_tpu_torch.dsp.block import (
    build_process_batch,
    build_process_block,
    packed_len,
    unpack_block_outputs,
)

torch.set_num_threads(2)


def _carry(jspec):
    return spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})


@pytest.fixture(scope="module")
def results(fsk_block):
    jspec, bits, sig = fsk_block
    ref = demod_block_numpy(jspec, sig)
    jx = {k: np.asarray(v) for k, v in jax_build_process_block(jspec)(c2ri(sig)).items()}
    spec = _carry(jspec)
    pt = {k: v.numpy() for k, v in
          build_process_block(spec, device="cpu")(torch.from_numpy(sig)).items()}
    return {"numpy": (spec, ref, pt), "jax": (spec, jx, pt)}


ORACLES = ["numpy", "jax"]


@pytest.mark.parametrize("oracle", ORACLES)
class TestTorchVsGolden:
    def test_energy_matrix(self, results, oracle):
        spec, ref, pt = results[oracle]
        assert np.allclose(pt["E"], ref["E"], rtol=2e-3)

    def test_doppler_decision(self, results, oracle):
        spec, ref, pt = results[oracle]
        assert abs(float(pt["dopp_idx"]) - float(ref["dopp_idx"])) < 0.01
        assert abs(float(pt["doppler_hz"]) - float(ref["doppler_hz"])) < 1.0
        assert int(pt["shift"]) == int(ref["shift"])

    def test_timing(self, results, oracle):
        spec, ref, pt = results[oracle]
        assert abs(float(pt["spSym"]) - float(ref["spSym"])) < 1e-3
        assert abs(float(pt["codeOffset"]) - float(ref["codeOffset"])) < 0.05

    def test_symbols_and_bits_match(self, results, oracle):
        spec, ref, pt = results[oracle]
        n = int(pt["nSym"])
        assert n == (len(ref["symbols"]) if oracle == "numpy" else int(ref["nSym"]))
        sym_match = np.mean(pt["symbols"][:n] == ref["symbols"][:n])
        assert sym_match > 0.999, f"symbol mismatch rate {1 - sym_match}"
        assert np.array_equal(pt["bits"][:n], ref["bits"][:n])

    def test_centres_match(self, results, oracle):
        spec, ref, pt = results[oracle]
        n = int(pt["nSym"])
        # flat-topped FSK magnitudes: the in-window argmax may land on
        # another plateau sample (see tests/test_dsp_golden.py)
        d = np.abs(pt["centres"][:n] - ref["centres"][:n])
        assert d.max() <= spec.windowWidth
        assert np.mean(d == 0) > 0.75

    def test_snr(self, results, oracle):
        spec, ref, pt = results[oracle]
        assert abs(float(pt["snr_db"]) - float(ref["snr_db"])) < 0.5

    def test_trust(self, results, oracle):
        spec, ref, pt = results[oracle]
        n = int(pt["nSym"])
        assert np.all(pt["trust"][:n] == 2)


def test_bits_recover_transmitted(fsk_block):
    jspec, bits, sig = fsk_block
    out = build_process_block(_carry(jspec), device="cpu")(torch.from_numpy(sig))
    n = int(out["nSym"])
    rx, tx = out["bits"].numpy()[5 : n - 5], bits[5:]
    # BER after searching a small alignment shift (mask-centre offset),
    # as tests/test_dsp_golden.py:best_aligned_ber does
    m = 8
    L = min(len(rx), len(tx)) - 2 * m
    best = min(np.mean(rx[m + s : m + s + L] != tx[m : m + L]) for s in range(-m, m + 1))
    assert best < 0.01


def test_packed_layout_matches_jax(bench_conf):
    """The packed vector has the JAX length and decodes, through the JAX
    package's own unpacker, to exactly the port's dict outputs."""
    from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
    from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol

    jspec = jax_build_spec(bench_conf, jax_loadProtocol("bench_GFSK")(conf=bench_conf), "UHF-H")
    spec = _carry(jspec)
    rng = np.random.RandomState(3)
    sig = torch.from_numpy((rng.randn(spec.Nfft) + 1j * rng.randn(spec.Nfft)).astype(np.complex64))
    d = build_process_block(spec, device="cpu")(sig)
    vec = build_process_block(spec, device="cpu", packed=True)(sig).numpy()
    assert vec.shape == (packed_len(spec),) == (jax_packed_len(jspec),)
    assert vec.dtype == np.float32
    rj, rt = jax_unpack(vec, jspec), unpack_block_outputs(vec, spec)
    assert set(rj) == set(rt) == set(d)
    for k in rj:
        assert np.array_equal(np.asarray(rj[k]), np.asarray(rt[k])), k
        dv = d[k].numpy()
        assert dv.dtype.kind == "b" or np.array_equal(dv.astype(np.float32),
                                                      np.asarray(rt[k]).astype(np.float32)), k


def test_batch_equals_per_block(bench_conf):
    from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
    from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol

    jspec = jax_build_spec(bench_conf, jax_loadProtocol("bench_GFSK")(conf=bench_conf), "UHF-H")
    spec = _carry(jspec)
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(3, spec.Nfft) + 1j * rng.randn(3, spec.Nfft))
                         .astype(np.complex64))
    batch = build_process_batch(spec, device="cpu")(x)
    single = build_process_block(spec, device="cpu")
    for b in range(3):
        one = single(x[b])
        for k, v in batch.items():
            a, s = v[b].numpy(), one[k].numpy()
            if a.dtype.kind in "iub" or k in ("bits", "trust", "symbols", "centres"):
                assert np.array_equal(a, s), k
            else:
                np.testing.assert_allclose(a, s, rtol=1e-5, atol=0, err_msg=k)


@pytest.mark.parametrize("change", [dict(bitLUT=None)])
def test_unported_modes_raise(fsk_block, change):
    """Every bit mode is ported: STX (tests/test_torch_stx.py) and NRZ-S,
    which needs the protocol's symbol LUT (tests/test_torch_nrzs.py). A
    spec with neither a centre-bit LUT nor a symbol LUT is refused."""
    jspec, _, _ = fsk_block
    spec = dataclasses.replace(_carry(jspec), **change)
    assert spec.symbolLUT is None
    with pytest.raises(ValueError, match="neither a centre-bit LUT nor an NRZ-S symbol LUT"):
        build_process_block(spec, device="cpu")
