"""GMSK benchmark protocol.

Capability parity with ``pyCuSDR/protocol/benchmark/bench_GMSK.py``:
GMSK (BT=0.5) templates from the reference GMSK modulator, trimmed to
the mask span, Hamming-weighted, conj-FFT'd. The port's copy of
``pycusdr_tpu/protocol/benchmark/bench_gmsk.py``.
"""

import numpy as np

from pycusdr_tpu_torch.protocol.benchmark.bench_base import BenchBase
from pycusdr_tpu_torch.protocol.fsk2 import fft_filter_bank
from pycusdr_tpu_torch.protocol.gfsk2 import hamming_weight
from pycusdr_tpu_torch.utils.gmsk import gmsk_mod


class BenchGMSK(BenchBase):
    name = "bench_GMSK"
    SUM_ALL_MASKS_PYTHON = True

    def getModulator(self, confRadio):
        from pycusdr_tpu_torch.tx.luts import GMSKmod

        return GMSKmod

    def get_filter(self, Nfft, spsym, maskSize):
        masks = self._get_xcorrMasks(maskSize)
        templates = []
        for m in masks:
            wave, _phase, f_len = gmsk_mod(m, spsym)
            templates.append(wave[f_len // 2 : -f_len // 2 + 1])
        templates = hamming_weight(templates)
        bank = fft_filter_bank(np.asarray(templates), Nfft)
        return bank.shape[0], bank
