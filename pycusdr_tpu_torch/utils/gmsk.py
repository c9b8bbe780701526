"""Reference GMSK waveform generator (host-side).

Capability parity with ``pyCuSDR/lib/gmskmod.py:10-43``; used to build
the GMSK matched-filter bank templates. The port's copy of
``pycusdr_tpu/utils/gmsk.py``.
"""

import numpy as np

from pycusdr_tpu_torch.utils.filters import gaussian_filter


def gmsk_mod(bits, spsym: int, bw: float = 0.5, ntaps=None, gain: float = 1.0):
    """GMSK-modulate ``bits``.

    Returns (complex waveform, phase, filter length). Bits may be 0/1 or
    ±1; 0/1 inputs are NRZ-mapped.
    """
    bits = np.asarray(bits, dtype=float)
    if not bits.min() < 0:
        bits = bits * 2 - 1
    if ntaps is None:
        ntaps = 4 * spsym

    filt = gaussian_filter(gain, bw, spsym, ntaps) * np.pi / 2 / spsym
    filt_bits = np.convolve(filt, np.repeat(bits, spsym))
    phase = np.cumsum(filt_bits)
    return np.exp(1j * phase), phase, len(filt)
