"""The port's STX path (spike clipping, trust -2 near clipped samples, no
Doppler search: the fixed IF shift) on the CPU, against the JAX graph
and the numpy golden (``dsp/reference.demod_block_numpy``) with the
golden tolerance table of ``tests/test_dsp_golden.py:89-132``, plus
trust equal to JAX's; the packed row against the JAX unpacker; the
kernel path's row assembly against the plain path; and the STX
``Demodulator`` (``process``, ``processMany``, ``processCapture``, the
two scenarios of ``tests/test_stx.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import make_fsk_signal
from pycusdr_tpu.dsp.block import build_process_block as jax_build_process_block
from pycusdr_tpu.dsp.block import unpack_block_outputs as jax_unpack
from pycusdr_tpu.dsp.reference import demod_block_numpy
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.models import STX as JaxSTX
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.convert import spec_from_numpy
from pycusdr_tpu_torch.dsp.block import (
    build_process_batch,
    build_process_block,
    pack_block_outputs,
    unpack_block_outputs,
)
from pycusdr_tpu_torch.models import STX
from pycusdr_tpu_torch.protocol import loadProtocol

torch.set_num_threads(2)
OFFSET_HZ = 38400.0
SPIKE_AT = 4096
K = 4


def _carry(jspec):
    return spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})


@pytest.fixture(scope="module")
def stx_conf(bench_conf):
    """The STX radio of tests/test_stx.py on the bench_conf block (2^13)."""
    conf = {k: (dict(v) if isinstance(v, dict) else v) for k, v in bench_conf.items()}
    conf["GPU"] = dict(conf["GPU"])
    conf["GPU"]["STX"] = dict(conf["GPU"]["UHF"], peakThresholdScale=4.5)
    conf["Radios"] = {"rangeRateMax": 7500, "Rx": {"STX": {
        "name": "STX", "CUDA_settings": "STX", "frequency_Hz": 2.4e9,
        "frequencyOffset_Hz": OFFSET_HZ, "baud": 9600, "samplesPerSym": 16,
        "doppCarrierSteps": 1, "Protocol": "UHF", "radioBackend": "STX", "voteGroup": "STX"}}}
    return conf


@pytest.fixture(scope="module")
def jspec(stx_conf):
    spec = jax_build_spec(stx_conf, jax_loadProtocol("bench_FSK")(conf=stx_conf), "STX")
    return dataclasses.replace(spec, doppler_search=False, disable_peak_thresholding=False)


def _signal(spec, seed, spike, noise_std=0.02):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, spec.Nfft // 16)
    sig = make_fsk_signal(bits, 16, OFFSET_HZ / spec.sampleRate, seed=seed,
                          noise_std=noise_std)[:spec.Nfft].copy()
    if spike:
        sig[SPIKE_AT:SPIKE_AT + 8] += 300.0  # a strong interference burst
    return bits, sig


@pytest.fixture(scope="module", params=["clean", "spike"])
def results(request, jspec):
    _, sig = _signal(jspec, 42, request.param == "spike")
    ref = demod_block_numpy(jspec, sig)
    jx = {k: np.asarray(v) for k, v in jax_build_process_block(jspec)(c2ri(sig)).items()}
    spec = _carry(jspec)
    pt = {k: v.numpy() for k, v in
          build_process_block(spec, device="cpu")(torch.from_numpy(sig)).items()}
    return request.param, {"numpy": (spec, ref, pt), "jax": (spec, jx, pt)}


@pytest.mark.parametrize("oracle", ["numpy", "jax"])
class TestStxVsGolden:
    def test_fixed_offset(self, results, oracle):
        _, r = results
        spec, ref, pt = r[oracle]
        for k in ("dopp_idx", "quality_db", "doppler_hz", "freq_offset_hz", "snr_db"):
            assert float(pt[k]) == float(ref[k]) == 0.0, k
        assert int(pt["shift"]) == int(ref["shift"]) == spec.dopp_offset_idx
        assert pt["E"].shape == (spec.D, spec.num_masks) and not pt["E"].any()

    def test_timing(self, results, oracle):
        _, r = results
        spec, ref, pt = r[oracle]
        assert abs(float(pt["spSym"]) - float(ref["spSym"])) < 1e-3
        assert abs(float(pt["codeOffset"]) - float(ref["codeOffset"])) < 0.05

    def test_symbols_and_bits_match(self, results, oracle):
        _, r = results
        spec, ref, pt = r[oracle]
        n = int(pt["nSym"])
        assert n == (len(ref["symbols"]) if oracle == "numpy" else int(ref["nSym"]))
        assert np.mean(pt["symbols"][:n] == ref["symbols"][:n]) > 0.999
        assert np.array_equal(pt["bits"][:n], ref["bits"][:n])

    def test_centres_match(self, results, oracle):
        _, r = results
        spec, ref, pt = r[oracle]
        n = int(pt["nSym"])
        d = np.abs(pt["centres"][:n] - ref["centres"][:n])
        assert d.max() <= spec.windowWidth
        assert np.mean(d == 0) > 0.75

    def test_trust_and_clipping(self, results, oracle):
        kind, r = results
        spec, ref, pt = r[oracle]
        n = int(pt["nSym"])
        assert np.array_equal(pt["trust"][:n], ref["trust"][:n])
        clipped = len(ref["clipped_idx"]) > 0 if oracle == "numpy" else bool(ref["clipped_any"])
        assert bool(pt["clipped_any"]) == clipped == (kind == "spike")
        assert np.any(pt["trust"][:n] == -2) == (kind == "spike")


@pytest.mark.parametrize("mode", ["stx_clean", "stx_spike", "uhf"])
def test_kernel_path_rows_equal_plain_path(jspec, fsk_block, mode):
    """The kernel path's rows (the wrappers writing K4's and K5's outputs
    into one buffer, here on their CPU side) equal the plain path packed
    by ``pack_block_outputs``, and decode through the JAX unpacker to the
    plain path's dict."""
    js = fsk_block[0] if mode == "uhf" else jspec
    spec = _carry(js)
    x = np.stack([_signal(spec, s, mode == "stx_spike" and s == 1)[1] for s in (0, 1, 2)])
    x = torch.from_numpy(x)
    rows = build_process_batch(spec, device="cpu", packed=True)(x)
    plain = build_process_batch(spec, device="cpu", plain=True)(x)
    torch.testing.assert_close(rows, pack_block_outputs(plain), rtol=0, atol=0)
    for b in range(3):
        rj = jax_unpack(rows[b].numpy(), js)
        for k, v in plain.items():
            assert np.array_equal(np.asarray(rj[k]), v[b].numpy()), k


def test_stx_packed_row_layout(jspec):
    """STX's row: Doppler scalars 0, the fixed shift, clipped_any, and a
    (D, M) = (1, 8) zero E; port and JAX unpackers agree exactly."""
    spec = _carry(jspec)
    _, sig = _signal(spec, 3, True)
    vec = build_process_block(spec, device="cpu", packed=True)(torch.from_numpy(sig)).numpy()
    rj, rt = jax_unpack(vec, jspec), unpack_block_outputs(vec, spec)
    assert set(rj) == set(rt)
    for k in rj:
        assert np.array_equal(np.asarray(rj[k]), np.asarray(rt[k])), k
    assert rt["E"].shape == (1, 8) and not rt["E"].any()
    assert rt["shift"] == spec.dopp_offset_idx and rt["clipped_any"] is True


def _stream(spec, seed, spike_hop=None):
    ov, hop = spec.sigOverlap, spec.Nfft - spec.sigOverlap
    rng = np.random.RandomState(seed)
    n = ov + K * hop
    bits = rng.randint(0, 2, n // 16 + 8)
    sig = make_fsk_signal(bits, 16, OFFSET_HZ / spec.sampleRate, seed=seed, noise_std=0.05)[:n]
    sig = sig.copy()
    if spike_hop is not None:
        at = ov + spike_hop * hop + hop // 2
        sig[at:at + 8] += 300.0
    return sig[:ov], sig[ov:].reshape(K, hop)


def _dem(conf, history, make=STX.Demodulator, proto=loadProtocol, **kw):
    d = make(conf, proto("bench_FSK")(conf=conf), "STX", **kw)
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


def test_stx_demodulator_paths_agree(stx_conf, jspec):
    """process x K == processMany(K) == processCapture on the STX path,
    with a clipped burst in hop 1, and the healed bits equal those of the
    JAX package's STX Demodulator."""
    history, hops = _stream(jspec, 5, spike_hop=1)
    dA, dB, dC = (_dem(stx_conf, history, device="cpu") for _ in range(3))
    seqA = _per_block(dA, hops)
    seqB = dB.processMany(hops)
    seqC = dC.processCapture(hops.reshape(-1), max_hops_per_dispatch=3)
    seqJ = _per_block(_dem(stx_conf, history, make=JaxSTX.Demodulator,
                           proto=jax_loadProtocol), hops)
    assert len(seqA) == len(seqB) == len(seqC) == len(seqJ) == K
    for i, (a, b, c, j) in enumerate(zip(seqA, seqB, seqC, seqJ)):
        for other in (b, c, j):
            np.testing.assert_array_equal(a["bits"], other["bits"], err_msg=f"block {i}")
            np.testing.assert_array_equal(a["trust"], other["trust"], err_msg=f"block {i}")
        assert a["doppler"] == a["doppler_std"] == a["SNR"] == 0.0
        assert abs(a["spSymEst"] - j["spSymEst"]) < 1e-3
    assert np.any(seqA[1]["trust"] == -2) and not np.any(seqA[3]["trust"] == -2)


def test_stx_demodulates_at_fixed_offset(stx_conf):
    """tests/test_stx.py's first scenario on the port: BER < 0.02."""
    from test_dsp_golden import best_aligned_ber

    demod = _dem(stx_conf, [], device="cpu")
    assert not demod.spec.doppler_search and not demod.spec.disable_peak_thresholding
    rng = np.random.RandomState(3)
    bits = rng.randint(0, 2, demod.Nfft // 16)
    sig = make_fsk_signal(bits, 16, OFFSET_HZ / demod.spec.sampleRate, noise_std=0.05)
    fOff, sdev, clipped, snr = demod.uploadAndFindCarrier(sig[: demod.Nfft])
    assert fOff == sdev == snr == 0.0 and len(clipped) == 0
    got, centres, trust, spSym = demod.demodulate()
    assert abs(spSym - 16) < 0.3
    assert best_aligned_ber(got[5:-5], bits[5:], max_shift=80) < 0.02


def test_stx_spike_clipping_tags_trust(stx_conf):
    """tests/test_stx.py's second scenario: trust -2 near a clipped burst,
    > 90% positive trust far from it."""
    demod = _dem(stx_conf, [], device="cpu")
    rng = np.random.RandomState(4)
    bits = rng.randint(0, 2, demod.Nfft // 16)
    sig = make_fsk_signal(bits, 16, OFFSET_HZ / demod.spec.sampleRate, noise_std=0.02)
    sig = sig[: demod.Nfft].copy()
    spike_at = demod.Nfft // 2
    sig[spike_at : spike_at + 8] += 300.0
    demod.uploadAndFindCarrier(sig)
    _, centres, trust, _ = demod.demodulate()
    dist = np.abs(np.asarray(centres, np.int64) - spike_at)
    assert np.any(trust[dist < 4 * 16] == -2)
    assert np.mean(trust[dist > 8 * 16] > 0) > 0.9


def test_stx_config_matches_graft_entry():
    """configs.stx_spec is the JAX entry module's STX spec (Nfft 2^17,
    numSymMax 9216, timing band [7447, 9102), fixed shift 16384)."""
    import __graft_entry__ as graft

    from test_torch_spec import assert_same_spec, spec_fields

    own = configs.stx_spec()
    assert_same_spec(spec_from_numpy(spec_fields(graft.stx_spec())), own)
    assert (own.Nfft, own.sigOverlap, own.D, own.num_masks, own.windowWidth) == \
        (1 << 17, 1 << 11, 1, 8, 3)
    assert (own.numSymMax, own.code_idx_lo, own.code_idx_hi) == (9216, 7447, 9102)
    assert own.dopp_offset_idx == 16384 and own.peak_threshold_scale == 4.5
    assert not own.doppler_search and not own.disable_peak_thresholding
