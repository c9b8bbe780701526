"""GFSK2 matched-filter bank.

Capability parity with ``pyCuSDR/protocol/GFSK2_base.py:22-60``:
Gaussian-filtered FSK phase templates (BT=1, half a period per symbol),
Hamming-weighted, conj-FFT'd. The port's copy of
``pycusdr_tpu/protocol/gfsk2.py``.
"""

import numpy as np
from scipy import signal as sp_signal

from pycusdr_tpu_torch.protocol.base import ProtocolBase
from pycusdr_tpu_torch.protocol.fsk2 import fft_filter_bank
from pycusdr_tpu_torch.utils.filters import gaussian_filter

BT = 1.0


def gfsk_templates(masks01: np.ndarray, spsym: int, bt: float = BT) -> list:
    """Gaussian-filtered phase templates trimmed to maskLen*spsym samples."""
    filt = gaussian_filter(1, bt, spsym, 4 * spsym) * np.pi / spsym
    f_len = len(filt)
    out = []
    for m in masks01:
        phase_rate = np.convolve(np.repeat(m * 2 - 1, spsym), filt)
        tmp = np.exp(1j * np.cumsum(phase_rate))
        out.append(tmp[f_len // 2 : -f_len // 2 + 1])
    return out


def hamming_weight(templates: list) -> list:
    w = sp_signal.get_window("hamming", len(templates[0]))
    return [t * w for t in templates]


class GFSK2(ProtocolBase):
    name = "GFSK2 Base"

    def get_filter(self, Nfft, spsym, maskSize):
        masks = self._get_xcorrMasks(maskSize)
        templates = hamming_weight(gfsk_templates(masks, spsym))
        bank = fft_filter_bank(np.asarray(templates), Nfft)
        return bank.shape[0], bank
