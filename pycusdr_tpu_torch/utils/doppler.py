"""Rangerate <-> Doppler frequency conversions.

Capability parity with ``pyCuSDR/lib/freq_from_rangerate.py:17-26``
(used by the hamlib rig server to let gpredict steer Doppler); the
port's copy of ``pycusdr_tpu/utils/doppler.py``.
"""

import scipy.constants

C = scipy.constants.speed_of_light


def rangerate_from_freq(freq: float, Fc: float) -> float:
    """Recover rangerate (m/s) from an absolute tuned frequency."""
    return (freq - Fc) * C / Fc


def freq_from_rangerate(rangerate: float, Fc: float) -> float:
    """Doppler-shifted absolute frequency for a given rangerate (m/s)."""
    return Fc + rangerate / C * Fc


def doppler_hz_from_rangerate(rangerate: float, Fc: float) -> float:
    """Doppler offset in Hz (not absolute frequency)."""
    return rangerate / C * Fc
