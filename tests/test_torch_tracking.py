"""The search-and-track loop in the port (on the CPU) against the JAX
package: the block graph with a runtime ``centre_shift`` against JAX's
``build_process_block(spec)(x, centre_shift)`` to the golden table of
``tests/test_dsp_golden.py:89-132`` (shift exact, E rtol 2e-3, SNR within
0.5 dB, bits equal); the port's ``DopplerTracker`` against JAX's on the
ramp and S-curve passes of ``tests/test_tracking.py`` (modes equal on
every block, doppler_hz within 1 Hz); and a resume mid-pass through
``convert.tracker_state``."""

import dataclasses

import numpy as np
import pytest
import torch

from pycusdr_tpu.dsp.block import build_process_block as jax_build_process_block
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.models.tracking import DopplerTracker as JaxTracker
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.convert import spec_from_numpy, tracker_state
from pycusdr_tpu_torch.dsp.block import build_process_batch, build_process_block
from pycusdr_tpu_torch.models import ACQUIRING, TRACKING, DopplerTracker

from conftest import make_fsk_signal

torch.set_num_threads(2)

#: tests/test_tracking.py's tracker at tiny_spec
TRACKER_KW = dict(track_bins=8, track_span_bins=16, snr_threshold_db=3.0, lost_limit=3)


@pytest.fixture(scope="module")
def specs():
    conf = configs.tiny_conf()
    jspec = jax_build_spec(conf, jax_loadProtocol("bench_GFSK")(conf=conf), configs.RADIO)
    return jspec, spec_from_numpy({f.name: getattr(jspec, f.name)
                                   for f in dataclasses.fields(jspec)})


def _ramp_blocks(spec, n_blocks, f0, slope_hz_per_block, seed=0, noise=0.05):
    """FSK blocks under a linear Doppler ramp (tests/test_tracking.py:24-38)."""
    N, fs = spec.Nfft, spec.sampleRate
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (N * n_blocks) // int(spec.spsym) + 4)
    base = make_fsk_signal(bits, int(spec.spsym), 0.0, seed=seed, noise_std=noise)
    n = np.arange(N * n_blocks)
    phase = 2 * np.pi * np.cumsum(f0 + slope_hz_per_block * (n / N)) / fs
    sig = (base[: N * n_blocks] * np.exp(1j * phase)).astype(np.complex64)
    return sig.reshape(n_blocks, N)


def _s_curve_blocks(spec, n_blocks=60, seed=11):
    """The S-curve pass of tests/test_tracking.py:74-101 (A = 12 bins)."""
    N, fs = spec.Nfft, spec.sampleRate
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (N * n_blocks) // int(spec.spsym) + 4)
    base = make_fsk_signal(bits, int(spec.spsym), 0.0, seed=seed, noise_std=0.05)
    t = np.arange(N * n_blocks) / N
    A = 12 * fs / N
    f_inst = spec.centreFreqOffset - A * np.tanh((t - n_blocks / 2) / (n_blocks / 6))
    sig = (base[: N * n_blocks] * np.exp(1j * 2 * np.pi * np.cumsum(f_inst) / fs))
    return sig.astype(np.complex64).reshape(n_blocks, N)


def _pass_blocks(spec, name):
    if name == "ramp":
        blocks = _ramp_blocks(spec, 24, spec.centreFreqOffset - 1200.0, 100.0)
        rng = np.random.RandomState(9)  # then signal loss: reacquire
        noise = (0.01 * (rng.randn(spec.Nfft) + 1j * rng.randn(spec.Nfft))).astype(np.complex64)
        return np.concatenate([blocks, np.repeat(noise[None], TRACKER_KW["lost_limit"] + 1, 0)])
    return _s_curve_blocks(spec)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("c", [0, 3, -5, "N-2"])
def test_recentred_graph_matches_jax(specs, c, plain):
    jspec, spec = specs
    N = spec.Nfft
    c = N - 2 if c == "N-2" else c
    # the carrier 4 bins above the IF offset, so the recentre moves the grid
    # across the signal
    rng = np.random.RandomState(17)
    bits = rng.randint(0, 2, N // int(spec.spsym))
    f = (spec.centreFreqOffset + 4 * spec.sampleRate / N) / spec.sampleRate
    sig = make_fsk_signal(bits, int(spec.spsym), f, seed=3, noise_std=0.05)
    ref = {k: np.asarray(v) for k, v in
           jax_build_process_block(jspec)(c2ri(sig), np.int32(c)).items()}
    pt = {k: v.numpy() for k, v in build_process_batch(spec, device="cpu", plain=plain)(
        sig[None], centre_shift=c).items()}
    pt = {k: v[0] for k, v in pt.items()}
    assert int(pt["shift"]) == int(ref["shift"])
    assert np.allclose(pt["E"], ref["E"], rtol=2e-3)
    assert abs(float(pt["dopp_idx"]) - float(ref["dopp_idx"])) < 0.01
    assert abs(float(pt["doppler_hz"]) - float(ref["doppler_hz"])) < 1.0
    assert abs(float(pt["freq_offset_hz"]) - float(ref["freq_offset_hz"])) < 1.0
    assert abs(float(pt["snr_db"]) - float(ref["snr_db"])) < 0.5
    n = int(pt["nSym"])
    assert n == int(ref["nSym"])
    assert np.array_equal(pt["bits"][:n], ref["bits"][:n])
    assert np.all(pt["trust"][:n] == ref["trust"][:n])


def test_recentre_forms_agree(specs):
    """An int, a (1,) and a (B,) centre_shift give the same rows; a batch
    recentres each block by its own value; a spec without the Doppler
    search ignores the recentre, as JAX's graph does."""
    _, spec = specs
    rng = np.random.RandomState(4)
    x = (rng.randn(3, spec.Nfft) + 1j * rng.randn(3, spec.Nfft)).astype(np.complex64)
    g = build_process_batch(spec, device="cpu", packed=True)
    a = g(x, centre_shift=7)
    assert torch.equal(a, g(x, centre_shift=torch.tensor([7])))
    assert torch.equal(a, g(x, centre_shift=torch.tensor([7, 7, 7], dtype=torch.int32)))
    mixed = g(x, centre_shift=torch.tensor([0, 7, -3]))
    single = build_process_block(spec, device="cpu", packed=True)
    for b, c in enumerate((0, 7, -3)):
        assert torch.equal(mixed[b], single(x[b], c))
    np.testing.assert_array_equal(g(x).numpy(), g(x, centre_shift=0).numpy())
    with pytest.raises(ValueError, match="centre_shift"):
        g(x, centre_shift=torch.tensor([1, 2]))
    nosearch = dataclasses.replace(spec, doppler_search=False)
    h = build_process_batch(nosearch, device="cpu", packed=True)
    assert torch.equal(h(x), h(x, centre_shift=5))


def _run(tracker, blocks, as_ri):
    out = []
    for b in blocks:
        r = tracker.process(c2ri(b) if as_ri else b)
        out.append((r["mode"], float(r["doppler_hz"]), np.asarray(r["bits"])[:int(r["nBits"])]))
    return out


def _assert_same_pass(got, want, label):
    for i, ((m, hz, bits), (jm, jhz, jbits)) in enumerate(zip(got, want)):
        assert m == jm, f"{label} block {i}: mode {m} != JAX's {jm}"
        assert abs(hz - jhz) < 1.0, f"{label} block {i}: {hz} Hz against JAX's {jhz}"
    assert len(got) == len(want)


@pytest.mark.parametrize("name", ["ramp", "s_curve"])
def test_tracker_matches_jax(specs, name):
    jspec, spec = specs
    kw = dict(TRACKER_KW, history=6) if name == "s_curve" else TRACKER_KW
    blocks = _pass_blocks(spec, name)
    want = _run(JaxTracker(spec=jspec, **kw), blocks, True)
    tracker = DopplerTracker(spec=spec, device="cpu", **kw)
    got = _run(tracker, blocks, False)
    _assert_same_pass(got, want, name)
    modes = [m for m, _, _ in got]
    assert modes[0] == ACQUIRING and TRACKING in modes
    assert tracker.track_spec.num_dopplers < spec.num_dopplers
    if name == "ramp":  # the noise blocks at the end drop the lock
        assert tracker.state == ACQUIRING and modes[-2] == TRACKING
    else:
        assert np.mean(np.asarray(modes) == TRACKING) > 0.8
    locked = [i for i, m in enumerate(modes) if m == TRACKING]
    assert all(np.array_equal(got[i][2], want[i][2]) for i in locked[:5])


def test_tracker_resumes_from_jax_state(specs):
    """JAX tracks the first half of the S-curve pass; ``tracker_state``
    hands its state, histories and counters to a port tracker, which
    continues the pass as JAX's own tracker does."""
    jspec, spec = specs
    kw = dict(TRACKER_KW, history=6)
    blocks = _s_curve_blocks(spec)
    half = len(blocks) // 2
    jt = JaxTracker(spec=jspec, **kw)
    _run(jt, blocks[:half], True)
    assert jt.state == TRACKING
    pt = tracker_state(jt.state, jt._t, jt._hz, jt._lost, jt._blocks, spec=spec,
                       device="cpu", **kw)
    assert pt.predict_hz(half) == pytest.approx(jt.predict_hz(half), abs=1e-9)
    _assert_same_pass(_run(pt, blocks[half:], False), _run(jt, blocks[half:], True), "resume")
    with pytest.raises(ValueError, match="tracker state"):
        tracker_state("lost", [], [], 0, 0, spec=spec, device="cpu")
