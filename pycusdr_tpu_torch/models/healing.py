"""Cross-block bit-stream healing (±1-symbol boundary alignment).

Port of the reference ``checkSymbolOverlap``
(``demodulator/demodulator_base.py:863-988``): consecutive overlap-save
blocks can emit the boundary symbol twice (one-early) or drop it
(one-late); comparing the saved tail of the previous block against the
head of the current one under on-time/early/late hypotheses repairs the
stream. Extracted as a standalone class so both the per-channel
``Demodulator`` and the multi-channel group runtime can heal each
channel independently of how the device graph was dispatched.

Deliberate deviation from the JAX package (``pycusdr_tpu/models/
healing.py``), taken only where the half overlap holds fewer symbols
than the bit-match window (``overlapOffset``), as at the CC11xx
station's 128 samples a symbol (1024 / 2 samples: 4 symbols, so the
match sees at most 3 bits and never fires): there the window starts at
the symbol the previous block's clock predicts (its last emitted centre,
one hop earlier, plus a symbol), which neither repeats nor drops the
symbol on the blocks' seam. JAX's bit match at those shapes lets the
seam repeat or drop a symbol, and every packet across it fails its CRC
(ROADMAP.md Queue 3). At 16 samples a symbol (32 symbols in the half
overlap) both packages run the same bit match, bit for bit.
"""

import logging

import numpy as np

from pycusdr_tpu_torch.obs.profiling import traced

log = logging.getLogger(__name__)

SYMBOL_CHECK_OVERLAP_OFFSET = 20
SYMBOL_CHECK_ERROR_THRESHOLD = 1000
SYMBOL_CHECK_MATCH_NUM_ERRORS_ALLOWED = 10


class BlockHealer:
    """Per-channel healing state + overlap-window selection."""

    def __init__(self, Nfft: int, sigOverlap: int,
                 overlapOffset: int = SYMBOL_CHECK_OVERLAP_OFFSET,
                 error_threshold: int = SYMBOL_CHECK_ERROR_THRESHOLD,
                 match_num_errors_allowed: int = SYMBOL_CHECK_MATCH_NUM_ERRORS_ALLOWED):
        self.Nfft = Nfft
        self.hop = Nfft - sigOverlap
        self.sigOverlapWin = sigOverlap // 2
        self.overlapOffset = overlapOffset
        self.error_threshold = error_threshold
        self.match_threshold = overlapOffset - match_num_errors_allowed

        self.poswinP = np.array([], dtype=np.int8)  # post-window bits of prev block
        self.posSymEnd = np.array([], dtype=np.int8)
        self.lastCentre = None  # the prev block's last emitted centre (its samples)

    @traced("heal")
    def heal(self, noError, centres, idxSymbol, dataBits, trustSymbol, spSym=None):
        """Select the non-overlap window and repair the boundary.
        ``spSym``: the block's samples a symbol; where the half overlap
        holds fewer than ``overlapOffset`` symbols the window starts on the
        symbol clock (``_clock_start``).

        Returns (centresWin, bitsWin, trustWin, idxSymbolWin)."""
        startCand = np.where(centres >= self.sigOverlapWin)[0]
        endCand = np.where(centres > (self.Nfft - self.sigOverlapWin))[0]
        startOverlap = int(startCand[0]) if len(startCand) else 0
        endOverlap = int(endCand[0]) if len(endCand) else len(centres)
        if spSym and self.sigOverlapWin < self.overlapOffset * spSym:
            return self._window(self._clock_start(centres, spSym, startOverlap), endOverlap,
                                centres, dataBits, trustSymbol)

        idxSymbolWin = dataBits[startOverlap:endOverlap]
        idxSymbolPreWin = dataBits[:startOverlap]

        off = self.overlapOffset
        allowed = off - self.match_threshold  # errors tolerated at full window

        def _match(a, b):
            """Match count + effective threshold over the common length.

            The reference compares fixed 20-symbol slices and silently
            fails on shorter tails (demodulator_base.py:965-967); here
            the error allowance scales with the usable length."""
            L = min(len(a), len(b), off)
            if L < 4:
                return -1, 0
            matches = int(np.sum(np.asarray(a[:L]) == np.asarray(b[:L])))
            thr_l = L - max(1, int(round(allowed * L / off)))
            return matches, thr_l

        try:
            if noError > self.error_threshold:
                log.debug("Too many symbol errors -- skip overlap check")
            elif len(self.poswinP) > 0 and len(idxSymbolWin) > 1:
                pre = self.poswinP
                symPre, thrP = _match(pre, idxSymbolWin)
                symEarlyPre, thrEP = _match(pre, idxSymbolWin[1:])
                symLatePre, thrLP = _match(pre[1:], idxSymbolWin)

                tail_prev = self.posSymEnd
                tail_cur = idxSymbolPreWin
                Lt = min(len(tail_prev) - 1, len(tail_cur), off)
                if Lt >= 4:
                    symPos = int(np.sum(tail_prev[-Lt:] == tail_cur[-Lt:]))
                    symEarlyPos = int(np.sum(tail_prev[-Lt - 1 : -1] == tail_cur[-Lt:]))
                    symLatePos = (int(np.sum(tail_prev[-Lt:] == tail_cur[-Lt - 1 : -1]))
                                  if len(tail_cur) > Lt else -1)
                    thrT = Lt - max(1, int(round(allowed * Lt / off)))
                else:
                    symPos = symEarlyPos = symLatePos = -1
                    thrT = 0

                if symPre >= thrP and symPre >= max(symEarlyPre, symLatePre):
                    pass  # on-time
                else:
                    maxPre = max(symPre, symEarlyPre, symLatePre)
                    if symEarlyPre >= thrEP and symEarlyPre == maxPre:
                        # current window repeats the prev block's last bit
                        if symEarlyPos < 0 or symEarlyPos >= max(symPos, thrT):
                            log.debug("overlap healing: removed duplicated first bit")
                            startOverlap += 1
                    elif symLatePre >= thrLP and symLatePre == maxPre:
                        # one bit was dropped at the boundary
                        if symLatePos < 0 or symLatePos >= max(symPos, thrT):
                            log.debug("overlap healing: re-inserted dropped first bit")
                            startOverlap -= 1
        except Exception as e:  # healing must never kill the stream
            log.error("symbol overlap healing failed:")
            log.exception(e)
        return self._window(startOverlap, endOverlap, centres, dataBits, trustSymbol)

    def _clock_start(self, centres, spSym, startOverlap):
        """The index of the symbol one symbol after the previous block's
        last emitted one (its centre moved back one hop), where this block
        has a symbol within half a symbol of that; else ``startOverlap``."""
        if self.lastCentre is None or not len(centres):
            return startOverlap
        want = self.lastCentre - self.hop + spSym
        k = int(np.argmin(np.abs(centres - want)))
        return k if abs(float(centres[k]) - want) <= spSym / 2 else startOverlap

    def _window(self, startOverlap, endOverlap, centres, dataBits, trustSymbol):
        """Emit [startOverlap, endOverlap) and keep the state the next
        block's healing reads."""
        off = self.overlapOffset
        startOverlap = max(startOverlap, 0)
        dataBitsWin = dataBits[startOverlap:endOverlap]
        trustSymbolWin = trustSymbol[startOverlap:endOverlap]
        centresWin = centres[startOverlap:endOverlap]
        # NB the matching above runs on dataBits, not idxSymbol — an
        # inherited reference quirk (demodulator_base.py:863+ does the
        # same despite its docstring); idxSymbol is accepted for API
        # parity and the 4th return mirrors the bits window
        idxSymbolWin = dataBitsWin

        self.poswinP = dataBits[endOverlap:]
        # refresh unconditionally (reference demodulator_base.py:978):
        # a short window must not leave a stale tail for the next vote
        self.posSymEnd = dataBitsWin[-off - 1 :]
        self.lastCentre = float(centresWin[-1]) if len(centresWin) else None

        return centresWin, dataBitsWin, trustSymbolWin, idxSymbolWin
