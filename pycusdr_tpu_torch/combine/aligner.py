"""Cross-correlation alignment of delayed bit streams (the port's copy
of ``pycusdr_tpu/combine/aligner.py``).

The combiner receives the same transmission from channels with unknown
relative delays (different ground stations, network paths). Alignment
is a circular FFT cross-correlation of the bit streams with a
peak-significance test: accept the best lag only if its correlation
beats ``mean + varianceMultiplier * std`` of the 3rd..15th best peaks
(reference ``softCombiner.py:697-726``).

Beyond-reference extension: ``BufferAligner`` caches the FFT of one
slave buffer so *segments* of a master window can each be aligned at
their own lag. The reference assigns a single lag to the whole
compare window (``softCombiner.py:703-726``), which silently
mis-votes the tail of a window whenever the demodulators slip a bit
against each other mid-window (block-boundary timing slips at low SNR)
or when burst arrivals make windows span many blocks; per-segment lags
follow the slip instead.
"""

import numpy as np

N_PEAKS = 15


class BufferAligner:
    """Aligns bit sequences inside one buffer, reusing the buffer FFT.

    ``match(seg)`` returns ``(lag, accepted)``: ``lag`` is where ``seg``
    most likely starts inside the buffer, ``accepted`` the
    peak-significance verdict (same test as the reference's whole-window
    alignment).
    """

    def __init__(self, bits, varianceMultiplier: float):
        self.bits = np.asarray(bits)
        self.var = varianceMultiplier
        self.n = len(self.bits)
        if self.n:
            self.N = int(2 ** np.ceil(np.log2(max(self.n, 2))))
            padded = np.r_[self.bits.astype(float), np.zeros(self.N - self.n)]
            self._fft = np.fft.fft(padded)

    def match(self, seg):
        m = min(len(seg), self.n)
        if self.n == 0 or m == 0:
            return 0, False
        B = np.fft.fft(np.asarray(seg[:m], float), self.N)
        xc = np.abs(np.fft.ifft(self._fft * np.conj(B)))

        k = min(N_PEAKS, len(xc))
        top = np.sort(np.partition(xc, -k)[-k:])[::-1]
        lag = int(np.argmax(xc))
        if k <= 3:
            return lag, False
        cond = np.mean(top[2:]) + self.var * np.std(top[2:])
        return lag, bool(top[0] > cond)


def xcorr_peak(bitsT: np.ndarray, bitsM: np.ndarray, varianceMultiplier: float):
    """Find where ``bitsM`` starts inside ``bitsT`` (whole-window form).

    Returns (lag, accepted): ``lag`` is the argmax of
    |xcorr(pad2(bitsT), bitsM[:len(bitsT)])|; ``accepted`` is the
    significance verdict.
    """
    return BufferAligner(bitsT, varianceMultiplier).match(bitsM)
