"""FSK benchmark protocol (±π/2 rad/sample templates).

Capability parity with ``pyCuSDR/protocol/benchmark/bench_FSK.py``:
FSK templates at baud/2 spacing (π rad/symbol), centre-bit LUT,
SUM_ALL_MASKS Doppler search.
"""

from pycusdr_tpu_torch.protocol.benchmark.bench_base import BenchBase
from pycusdr_tpu_torch.protocol.fsk2 import fft_filter_bank, fsk_phase_templates

import numpy as np


class BenchFSK(BenchBase):
    name = "bench_FSK"
    SUM_ALL_MASKS_PYTHON = True

    def getModulator(self, confRadio):
        from pycusdr_tpu_torch.tx.luts import FSKmod

        return FSKmod

    def get_filter(self, Nfft, spsym, maskSize):
        symbols = self._get_xcorrMasks(maskSize)
        # wavePhase = linspace(1/spsym,1,spsym)*pi  == 2*pi*nCycles with nCycles=0.5
        phase = fsk_phase_templates(symbols, spsym, nCycles=0.5)
        bank = fft_filter_bank(np.exp(1j * phase), Nfft)
        return bank.shape[0], bank
