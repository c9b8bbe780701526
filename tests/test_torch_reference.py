"""The port's numpy golden (``pycusdr_tpu_torch/dsp/reference.py``) against
the JAX package's (``pycusdr_tpu/dsp/reference.py``): on the same seeded
blocks and the same spec, ``demod_block_numpy`` and every stage function
give equal outputs (``np.array_equal``, every key of the result dict) at
the tiny spec (Nfft 2^9, bench_GFSK), at an STX-like spec with spike
clipping (no Doppler search, the fixed shift, scale 4.5) and at NRZ-S specs
(bench_BPSK, with and without clipping). The golden's packed row
(``bench/ber_delta.golden_row``) unpacks to the golden's own outputs. The
module imports no torch."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pycusdr_tpu.dsp import reference as jax_ref
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.convert import spec_from_numpy
from pycusdr_tpu_torch.dsp import reference as ref
from pycusdr_tpu_torch.dsp.signal_gen import get_padded_packet

REPO = Path(__file__).resolve().parent.parent


def _specs(kind):
    """(JAX spec, the port's spec carried from it) of ``kind``."""
    if kind.startswith("nrzs"):
        conf = configs._conf(blockSize=9, overlap=7, spsym=8, doppSteps=16, windowWidth=5,
                             maskSize=4)
        protocol = "bench_BPSK"
    else:
        conf, protocol = configs.tiny_conf(), "bench_GFSK"
    conf["Main"]["protocols"] = {"UHF": protocol}
    jspec = jax_build_spec(conf, jax_loadProtocol(protocol)(conf=conf), configs.RADIO)
    if kind.endswith("clip"):
        jspec = dataclasses.replace(jspec, doppler_search=False, disable_peak_thresholding=False,
                                    peak_threshold_scale=4.5)
    spec = spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})
    return jspec, spec


def _block(spec, kind, seed):
    """One seeded block of the kind's modulation at the IF offset (a 6-sample
    interference burst in the clip kinds) over AWGN."""
    rng = np.random.RandomState(seed)
    sps = int(spec.spsym)
    bits = rng.randint(0, 2, 2 * spec.Nfft // sps)
    mod = "BPSK" if kind.startswith("nrzs") else "GFSK"
    sig, _ = get_padded_packet(mod, sps, spec.sampleRate, offset_freq=spec.centreFreqOffset,
                               raw_bits=bits, pad=0)
    start = rng.randint(0, len(sig) - spec.Nfft)
    x = sig[start:start + spec.Nfft] + 0.05 * (rng.randn(spec.Nfft) + 1j * rng.randn(spec.Nfft))
    if kind.endswith("clip"):
        x[100:106] += 60.0
    return x.astype(np.complex64)


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, list):
        return a == b
    return np.array_equal(np.asarray(a), np.asarray(b))


KINDS = ["tiny", "stx_clip", "nrzs", "nrzs_clip"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_demod_block_numpy_equals_jax(kind, seed):
    jspec, spec = _specs(kind)
    x = _block(spec, kind, seed)
    want = jax_ref.demod_block_numpy(jspec, x)
    got = ref.demod_block_numpy(spec, x)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _equal(got[k], want[k]), f"{kind} seed {seed}: {k} differs"
    if kind.endswith("clip"):
        assert len(got["clipped_idx"]) and np.any(got["trust"] == -2), "no clip exercised"
    if kind.startswith("nrzs"):
        assert len(got["bits"]) == len(got["symbols"]) - 1


@pytest.mark.parametrize("kind", ["tiny", "stx_clip"])
def test_stage_functions_equal_jax(kind):
    """Each stage function the golden chains, on the same inputs."""
    jspec, spec = _specs(kind)
    x = _block(spec, kind, 7)
    for a, b in zip(ref.threshold_input(x, 4.5), jax_ref.threshold_input(x, 4.5)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref.fill_peak_gaps(np.array([3, 50, 60, 400]), spec.Nfft),
                                  jax_ref.fill_peak_gaps(np.array([3, 50, 60, 400]), spec.Nfft))
    S = np.fft.fft(x)
    E = ref.doppler_energy(S, spec.masks_f, spec.dopp_shifts)
    np.testing.assert_array_equal(E, jax_ref.doppler_energy(S, spec.masks_f, spec.dopp_shifts))
    np.testing.assert_allclose(ref.doppler_energy_bruteforce(S, spec.masks_f, spec.dopp_shifts),
                               E, rtol=1e-6)
    assert ref.find_doppler_est(E, spec) == jax_ref.find_doppler_est(E, jspec)
    assert ref.interpolate_doppler(3.25, spec) == jax_ref.interpolate_doppler(3.25, jspec)
    assert ref.compute_snr(S, spec, 4, 9) == jax_ref.compute_snr(S, jspec, 4, 9)
    X = ref.demod_lag_tensor(S, spec.masks_f, 5)
    np.testing.assert_array_equal(X, jax_ref.demod_lag_tensor(S, spec.masks_f, 5))
    rate = ref.find_code_rate_and_phase(X, spec)
    assert rate == jax_ref.find_code_rate_and_phase(X, jspec)
    for a, b in zip(ref.find_centres(X, spec, rate[0], rate[1]),
                    jax_ref.find_centres(X, jspec, rate[0], rate[1])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_golden_row_unpacks_to_the_golden(kind):
    """``ber_delta``'s golden arm hands the port's ``Demodulator`` a row of
    the port's layout: unpacked, it holds the golden's outputs (f32)."""
    from pycusdr_tpu_torch.bench.ber_delta import golden_row
    from pycusdr_tpu_torch.dsp.block import unpack_block_outputs

    _, spec = _specs(kind)
    out = ref.demod_block_numpy(spec, _block(spec, kind, 5))
    r = unpack_block_outputs(golden_row(spec, out), spec)
    nSym, nBits = len(out["symbols"]), len(out["bits"])
    assert int(r["nSym"]) == nSym and int(r["nBits"]) == nBits
    for k in ("bits", "trust", "symbols", "centres"):
        n = nBits if k in ("bits", "trust") else nSym
        np.testing.assert_array_equal(r[k][:n], np.asarray(out[k])[:n], err_msg=k)
    np.testing.assert_array_equal(r["mags"][:nSym], np.asarray(out["mags"], np.float32))
    for k in ("spSym", "codeOffset", "doppler_hz", "snr_db", "shift"):
        assert r[k] == np.float32(out[k]), k
    assert r["clipped_any"] == (len(out["clipped_idx"]) > 0)
    E = np.zeros((spec.D, spec.num_masks), np.float32) if out["E"] is None else out["E"]
    np.testing.assert_array_equal(r["E"], np.asarray(E, np.float32))


def test_reference_imports_no_torch():
    code = ("import sys; import pycusdr_tpu_torch.dsp.reference as r; "
            "print(hasattr(r, 'demod_block_numpy'), 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert out.stdout.split() == ["True", "False"], out.stderr
