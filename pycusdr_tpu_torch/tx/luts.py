"""LUT modulators (OSI L1): phase-increment tables integrated by cumsum
(the port's copy of ``pycusdr_tpu/tx/luts.py``).

Capability parity with ``pyCuSDR/modulator/modulators/`` — FSK
(``FSK_LUT.py:9-42``), GFSK2 (``GFSK2_LUT.py:8-75``) and GMSK
(``GMSK_LUT.py:6-72``). The LUT holds per-sample phase increments per
bit (or 3-bit context); the modulator core adds Doppler/IF offsets to
the LUT before integration, so pre-compensation is free.
"""

import logging

import numpy as np

from pycusdr_tpu_torch.utils.filters import gaussian_filter

log = logging.getLogger(__name__)


class BaseLUT:
    name = "base"

    def __init__(self, protocol, confRadio):
        self.LUT = None

    def getLUT(self):
        return self.LUT

    def modulate(self, bitData, lut):
        raise NotImplementedError


def _context3_pulse_shapes(spsym: int, bw: float, phase_scale: float) -> np.ndarray:
    """Centre-bit pulse shapes for all 8 3-bit contexts.

    Each bit's pulse depends on its neighbours through the Gaussian
    premodulation filter; the LUT row for context (b-1, b, b+1) is the
    middle symbol of the filtered NRZ impulse train.
    """
    gaus = gaussian_filter(1, bw, spsym, 4 * spsym)
    filt = np.convolve(gaus, np.ones(spsym))
    grpT = len(filt) // 2
    interp = np.r_[1, np.zeros(spsym - 1)]

    shapes = np.zeros((8, spsym))
    for ctx in range(8):
        bits = np.array([(ctx >> 2) & 1, (ctx >> 1) & 1, ctx & 1]) * 2 - 1
        train = np.kron(bits, interp)
        filtered = np.convolve(filt, train)
        pulse = filtered[grpT + spsym // 2 : grpT + int(1.5 * spsym)]
        shapes[ctx] = pulse * phase_scale
    return shapes


class FSKmod(BaseLUT):
    """2-FSK at baud/2 spacing: ±π phase per symbol, no ISI."""

    name = "FSK"

    def __init__(self, protocol, confRadio):
        self.spSym = spsym = confRadio["samplesPerSym"]
        wave = np.ones(spsym) / spsym * 2 * np.pi * 0.5
        self.LUT = np.array([-wave, wave])

    def modulate(self, bitData, lut):
        bitData = np.asarray(bitData).astype(np.int64)
        phase = np.cumsum(lut[bitData]) - (bitData[0] * 2 - 1) * np.pi / 2
        return np.exp(1j * np.mod(phase, 2 * np.pi)).astype(np.complex64)


class GFSK2mod(BaseLUT):
    """Gaussian-filtered 2-FSK (BT=1), 3-bit-context LUT."""

    name = "GFSK2"

    def __init__(self, protocol, confRadio):
        self.spSym = spsym = confRadio["samplesPerSym"]
        self.LUT = _context3_pulse_shapes(spsym, bw=1.0, phase_scale=np.pi / spsym)

    def modulate(self, bitData, lut):
        bitData = np.asarray(bitData).astype(np.int64)
        idx = _context_indices(bitData)
        phase = np.cumsum(lut[idx].reshape(-1)) - (bitData[0] * 2 - 1) * np.pi / 2
        return np.exp(1j * np.mod(phase, 2 * np.pi)).astype(np.complex64)


class GMSKmod(BaseLUT):
    """GMSK (BT=0.5): π/2 per symbol, 3-bit-context LUT."""

    name = "GMSK"

    def __init__(self, protocol, confRadio):
        self.spSym = spsym = confRadio["samplesPerSym"]
        self.LUT = _context3_pulse_shapes(spsym, bw=0.5, phase_scale=np.pi / 2 / spsym)

    def modulate(self, bitData, lut):
        bitData = np.asarray(bitData).astype(np.int64)
        idx = _context_indices(bitData)
        phase = np.cumsum(lut[idx].reshape(-1))
        return np.exp(1j * np.mod(phase, 2 * np.pi)).astype(np.complex64)


def _context_indices(bitData: np.ndarray) -> np.ndarray:
    """3-bit context index per bit; edge bits use truncated contexts
    (reference GMSK_LUT.py:57-62)."""
    idx_start = 2 * bitData[0] + bitData[1] if len(bitData) > 1 else bitData[0]
    idx_end = 4 * bitData[-2] + 2 * bitData[-1] if len(bitData) > 1 else bitData[-1]
    if len(bitData) <= 2:
        return np.array([idx_start, idx_end])
    ctx = 4 * bitData[:-2] + 2 * bitData[1:-1] + bitData[2:]
    return np.r_[idx_start, ctx, idx_end]
