"""Reference waveform generators and the AWGN channel for tests and the
chip smoke run: the FSK and GFSK modulators and ``awgn`` of
``pycusdr_tpu/dsp/signal_gen.py``, copied."""

import numpy as np

from pycusdr_tpu_torch.utils.filters import gaussian_filter


def modulate_fsk(raw_bits, spsym: int) -> np.ndarray:
    """2-FSK at baud/2 spacing (π rad/symbol)."""
    raw_bits = np.asarray(raw_bits).astype(np.int64)
    wave = np.ones(spsym) / spsym * np.pi
    lut = np.array([-wave, wave])
    phase = np.cumsum(lut[raw_bits]) - (raw_bits[0] * 2 - 1) * np.pi / 2
    return np.exp(1j * np.mod(phase, 2 * np.pi)).astype(np.complex64)


def modulate_gfsk2(raw_bits, spsym: int) -> np.ndarray:
    """Gaussian-filtered FSK, BT=1."""
    gaus = gaussian_filter(1, 1, spsym, 4 * spsym)
    phase = np.convolve(gaus, np.repeat(np.asarray(raw_bits) * 2 - 1, spsym))
    return np.exp(1j * np.cumsum(phase) / spsym * np.pi).astype(np.complex64)


def awgn(sig, snr_db, measured: bool = True, rng=None):
    """AWGN channel; when ``measured`` the SNR is relative to actual
    signal power."""
    rng = rng or np.random
    if measured:
        sigp = 10 * np.log10(np.linalg.norm(np.abs(sig), 2) ** 2 / len(sig))
        snr_db = snr_db - sigp
    noiseP = 10 ** (-snr_db / 10)
    if np.iscomplexobj(sig):
        noise = np.sqrt(noiseP / 2) * (rng.standard_normal(len(sig)) + 1j * rng.standard_normal(len(sig)))
    else:
        noise = np.sqrt(noiseP) * rng.standard_normal(len(sig))
    return sig + noise
