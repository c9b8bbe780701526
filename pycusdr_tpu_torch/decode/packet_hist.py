"""Cross-channel packet de-duplication by content hash (a copy of
``pycusdr_tpu/decode/packet_hist.py``).

Capability parity with ``pyCuSDR/decoder_process.py:516-558``
(``PacketHist``): with N diversity channels (and the softCombiner
emitting every master/slave combination) the same packet arrives up to
N times; an MD5-over-payload history with a timeout drops duplicates.
``maxLen=None`` keeps every hash within the timeout (the decoder's
history while planned restarts are armed).
"""

import hashlib
import time


class PacketHist:
    def __init__(self, maxLen: int = 40, timeout: float = 1.0):
        self.maxLen = maxLen
        self.timeout = timeout
        self._hashes = []  # list of (hash, t)

    def _prune(self, now):
        self._hashes = [(h, t) for (h, t) in self._hashes if now - t <= self.timeout]
        if self.maxLen is not None and len(self._hashes) > self.maxLen:
            self._hashes = self._hashes[-self.maxLen :]

    def checkHash(self, payload, numWorkers: int = 1) -> bool:
        """True if this payload is NEW (not seen within the timeout).

        With a single channel there is nothing to dedup (every copy is a
        genuine retransmission) — record and accept, matching the
        reference's numWorkers==1 shortcut (decoder_process.py:533-537).
        """
        now = time.time()
        self._prune(now)
        h = hashlib.md5(bytes(bytearray(payload))).hexdigest()
        if numWorkers == 1:
            self._hashes.append((h, now))
            return True
        for hh, _ in self._hashes:
            if hh == h:
                return False
        self._hashes.append((h, now))
        return True
