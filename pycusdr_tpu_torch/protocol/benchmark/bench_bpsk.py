"""BPSK benchmark protocol with NRZ-S phase-ambiguity resolution (a copy
of ``pycusdr_tpu/protocol/benchmark/bench_bpsk.py``, as it matches
``pyCuSDR/protocol/benchmark/bench_BPSK.py``):
RRC-filtered ±1 templates (beta=0.5, span 6), and a 3-D NRZ-S symbol
transition LUT that resolves the BPSK 180° phase ambiguity by looking
at symbol transitions instead of absolute phase. bitLUT is None, which
routes the demodulator through the NRZ-S extraction path.
"""

import numpy as np

from pycusdr_tpu_torch.protocol.benchmark.bench_base import BenchBase
from pycusdr_tpu_torch.protocol.fsk2 import fft_filter_bank
from pycusdr_tpu_torch.utils.filters import rrcosfilter


# Hand tables matching the reference (bench_BPSK.py:84-195): these group
# symbols by the *last two* observed levels rather than the centre, and
# are what field operation validated. Kept verbatim-by-value.
def _reference_lut(maskLen: int) -> np.ndarray:
    if maskLen == 4:
        return np.array(
            [
                [[0, 1], [2, 3]],
                [[0, 1], [2, 3]],
                [[6, 7], [4, 5]],
                [[6, 7], [4, 5]],
                [[6, 7], [4, 5]],
                [[6, 7], [4, 5]],
                [[0, 1], [2, 3]],
                [[0, 1], [2, 3]],
            ],
            dtype=np.int64,
        )
    if maskLen == 5:
        blk_a = [[0, 1, 2, 3], [4, 5, 6, 7]]
        blk_b = [[12, 13, 14, 15], [8, 9, 10, 11]]
        rows = [blk_a] * 4 + [blk_b] * 8 + [blk_a] * 4
        return np.array(rows, dtype=np.int64)
    raise ValueError(f"bench_BPSK: unsupported mask length {maskLen}")


class BenchBPSK(BenchBase):
    name = "bench_BPSK"
    SUM_ALL_MASKS_PYTHON = True

    def get_filter(self, Nfft, spsym, maskSize):
        self.num_masks = int(2 ** (maskSize - 1))
        masks = self._get_xcorrMasks(maskSize) * 2 - 1

        filt = rrcosfilter(0.5, 6, spsym)
        filt = filt / np.sum(filt)
        f_len = len(filt)

        templates = []
        for m in masks:
            t = np.convolve(np.repeat(m, spsym), filt)
            templates.append(t[f_len // 2 : -f_len // 2 + 1])

        bank = fft_filter_bank(np.asarray(templates, dtype=np.complex128), Nfft)
        return bank.shape[0], bank

    def get_symbolLUT2(self, maskLen: int):
        # bitLUT None -> demodulator takes the NRZ-S 3-D LUT path
        return None, _reference_lut(maskLen)
