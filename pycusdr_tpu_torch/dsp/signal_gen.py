"""Reference waveform generators and the AWGN channel for tests and the
chip smoke run: copies of ``pycusdr_tpu/dsp/signal_gen.py``'s seeded
packet bits, BPSK (RRC, NRZ-S), FSK, GFSK and GMSK modulators, ``awgn``,
zero padding and the IF-offset single-packet signal."""

import numpy as np

from pycusdr_tpu_torch.utils.filters import gaussian_filter, rrcosfilter
from pycusdr_tpu_torch.utils.nrzs import encode_nrzs


def packet_data(n_bits: int = 10000, seed: int = 123) -> np.ndarray:
    """Deterministic random packet bits; preserves global RNG state."""
    state = np.random.get_state()
    np.random.seed(seed)
    bits = np.random.randint(0, 2, n_bits)
    np.random.set_state(state)
    return bits


def zeropad(sig: np.ndarray, n: int) -> np.ndarray:
    return np.concatenate((np.zeros(n, dtype=sig.dtype), sig, np.zeros(n, dtype=sig.dtype)))


def modulate_bpsk(raw_bits, spsym: int) -> np.ndarray:
    """BPSK with NRZ-S precoding; RRC beta=0.5 span 6."""
    bits_nrzs = encode_nrzs(np.concatenate(([1, 0, 1], raw_bits))).astype(float) * 2 - 1
    filt = rrcosfilter(0.5, 6, spsym)
    filt = filt / np.sum(filt)
    return np.convolve(filt, np.repeat(bits_nrzs, spsym)).astype(np.complex64)


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


def modulate_gmsk(raw_bits, spsym: int) -> np.ndarray:
    """GMSK, BT=0.5, π/2 per symbol."""
    gaus = gaussian_filter(1, 0.5, spsym, 4 * spsym)
    phase = np.convolve(gaus, np.repeat(np.asarray(raw_bits) * 2 - 1, spsym))
    return np.exp(1j * np.cumsum(phase) / spsym * np.pi / 2).astype(np.complex64)


_MODULATORS = {
    "BPSK": modulate_bpsk,
    "FSK": modulate_fsk,
    "GFSK": modulate_gfsk2,
    "GMSK": modulate_gmsk,
}


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


def get_padded_packet(modulation: str, spsym: int = 16, fs: float = 9600 * 16,
                      offset_freq=None, raw_bits=None, pad: int = 10000):
    """Zero-padded, IF-offset single-packet test signal.

    Returns (complex64 signal, packet bits)."""
    if offset_freq is None:
        offset_freq = fs / 4
    if raw_bits is None or len(raw_bits) == 0:
        raw_bits = packet_data()
    if modulation not in _MODULATORS:
        raise TypeError(f"supported modulations: {sorted(_MODULATORS)}")
    sig = _MODULATORS[modulation](raw_bits, spsym)
    sig_full = zeropad(sig, pad)
    n = np.arange(len(sig_full))
    sig_full = sig_full * np.exp(1j * 2 * np.pi * offset_freq / fs * n)
    return sig_full.astype(np.complex64), raw_bits
