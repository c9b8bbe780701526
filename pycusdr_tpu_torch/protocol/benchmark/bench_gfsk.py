"""GFSK benchmark protocol.

Capability parity with ``pyCuSDR/protocol/benchmark/bench_GFSK.py``.
Note the reference uses plain FSK templates for the GFSK bench filter
(its Gaussian-filtered variant is commented out, ``bench_GFSK.py:67``);
the narrow ISI of GFSK at BT=1 correlates well against FSK templates.
We mirror that behaviour for BER parity.
"""

import numpy as np

from pycusdr_tpu_torch.protocol.benchmark.bench_base import BenchBase
from pycusdr_tpu_torch.protocol.fsk2 import fft_filter_bank, fsk_phase_templates


class BenchGFSK(BenchBase):
    name = "bench_GFSK"
    SUM_ALL_MASKS_PYTHON = True

    def getModulator(self, confRadio):
        from pycusdr_tpu_torch.tx.luts import GFSK2mod

        return GFSK2mod

    def get_filter(self, Nfft, spsym, maskSize):
        symbols = self._get_xcorrMasks(maskSize)
        phase = fsk_phase_templates(symbols, spsym, nCycles=0.5)
        bank = fft_filter_bank(np.exp(1j * phase), Nfft)
        return bank.shape[0], bank
