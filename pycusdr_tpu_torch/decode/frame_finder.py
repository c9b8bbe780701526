"""Frame finder: locate packets in the soft-bit stream by header/sync
correlation and slice them out across block boundaries.

Capability parity with ``pyCuSDR/decoder.py:16-293``:
* header match: correlate the ±1 header mask against the bit stream,
  threshold at ``numOnesHeader - headerTol`` (``:96-104``),
* sync-flag correlation for end detection (``:112-114``),
* three end modes: FLAGS (state machine resuming packets across
  blocks, ``:122-243``), FIXED (known length with wait-for-more-data,
  ``:245-281``), IN_DATA (length field inside packet),
* ``numBitsOverlap`` bits chained between consecutive blocks (``:89-90``).

The port of ``pycusdr_tpu/decode/frame_finder.py``. The header/sync
correlations run the native C++ scanner (``native.bit_correlate``) when
the library is there and fall back to ``np.convolve``; both give the same
float64 scores, so no decision depends on which ran (the JAX package's
native form returns int32, its fallback float64).
"""

import logging
import time

import numpy as np

from pycusdr_tpu_torch import native
from pycusdr_tpu_torch.obs.profiling import traced
from pycusdr_tpu_torch.protocol.base import PacketEndDetect

log = logging.getLogger(__name__)


def _correlate_pm1(bits: np.ndarray, mask_pm1: np.ndarray) -> np.ndarray:
    """np.convolve(bits, mask) — mask is ±1 and already flipped."""
    return native.bit_correlate(bits, mask_pm1)


class Decoder:
    """Per-channel frame finder + packet slicer."""

    maxPacketLenBits = int(2**13)
    minNumBitsBeforeProcessing = int(2**10)

    def __init__(self, config, protocol):
        self.conf = config
        self.protocol = protocol
        log.info("decoder protocol %s", protocol.name)

        self.preprocessor = protocol.decoderPreprocessor
        self.postprocessor = protocol.decoderPostprocessor

        self.mask = np.asarray(protocol.get_mask(), dtype=np.float64)
        self.syncSig = np.asarray(protocol.get_syncFlag(), dtype=np.float64)

        self.numBitsOverlap = protocol.numBitsOverlap
        self.bitsOverlapBuf = np.zeros(self.numBitsOverlap)

        # streaming context for line-coding preprocessors (e.g. NRZI
        # needs the previous block's last raw level; a streaming Viterbi
        # keeps its trellis carry in the mutable state dict)
        self._prevRawLast = None
        self._preprocState = {}

        # FLAGS-mode resume state
        self.headerFrameStartIdx = None
        self.packetBuffer = None
        self.headerMaskBitErrors = None

        self.packetEndDetectMode = protocol.packetEndDetectMode
        self.packetEndLenDecoder = protocol.packetEndLenDecoder
        self.packetSizes = protocol.packet_sizes
        self.packetLen = protocol.packetLen
        self.packetEndLenField = protocol.packetEndLenField
        self.packetEndLenFieldNumBytes = protocol.packetEndLenFieldNumBytes
        self.Packet = protocol.Packet

        log.info(
            "Packet end detection: %s (len=%s)",
            self.packetEndDetectMode.name,
            self.packetLen,
        )

    # ------------------------------------------------------------------

    @traced("decode.frames")
    def findFrames(self, bits_raw, frameStartIdx, trust=None, debugMode=False):
        """Returns (packets, preprocessed bits, numSyncSig).

        ``trust`` (optional, same length as ``bits_raw``) is the demod's
        per-bit trust; soft-decision preprocessors (e.g. the concatenated
        CCSDS inner Viterbi) use it to weight/erase symbols."""
        bits_raw = np.asarray(bits_raw)
        bits_less_raw = self.preprocessor(bits_raw, prev_raw_last=self._prevRawLast,
                                          stream_state=self._preprocState,
                                          trust=trust)
        if len(bits_raw):
            self._prevRawLast = int(bits_raw[-1])

        rawBits = np.concatenate((self.bitsOverlapBuf, bits_less_raw))
        self.bitsOverlapBuf = rawBits[-self.numBitsOverlap :]

        t = time.time()
        score = _correlate_pm1(rawBits, self.mask)
        log.debug("convolve time %f s", time.time() - t)

        idxCand = np.where(score >= self.protocol.numOnesHeader - self.protocol.headerTol)[0]
        packetIdx = idxCand - len(self.mask) + 1  # match fires at mask end

        syncScore = _correlate_pm1(rawBits, self.syncSig)
        syncSigStartIdx = np.where(
            syncScore >= self.protocol.numOnesSyncSig - self.protocol.syncSigTol
        )[0]
        numSyncSig = len(syncSigStartIdx)

        packets = []
        mode = self.packetEndDetectMode
        if mode == PacketEndDetect.FLAGS:
            packets = self._find_flags(
                rawBits, bits_less_raw, packetIdx, idxCand, score, syncSigStartIdx, frameStartIdx
            )
        elif mode == PacketEndDetect.FIXED:
            packets = self._find_fixed(rawBits, packetIdx, idxCand, score)
        elif mode == PacketEndDetect.IN_DATA:
            packets = self._find_in_data(rawBits, packetIdx, idxCand, score)

        return packets, bits_less_raw, numSyncSig

    # ------------------------------------------------------------------

    def _find_flags(self, rawBits, newBits, packetIdx, idxCand, score, syncStarts, frameStartIdx):
        packets = []
        numOnes = self.protocol.numOnesSyncSig
        tol = self.protocol.syncSigTol

        if self.headerFrameStartIdx is not None:
            # resume a packet left open by the previous block
            if len(syncStarts) == 0:
                frameEnd = None
            else:
                endIdx = int(np.argmax(syncStarts > 0))
                # ignore sync hits inside the overlapped head of the
                # stream (reference decoder.py:151-153): they belong to
                # the previous block and would close the packet with
                # zero new bits
                if syncStarts[endIdx] < numOnes - tol:
                    frameEnd = None
                else:
                    frameEnd = int(min(syncStarts[endIdx] + 16, syncStarts[-1]))

            if frameEnd is None:
                room = self.maxPacketLenBits - len(self.packetBuffer)
                if room > len(newBits):
                    self.packetBuffer = np.append(self.packetBuffer, newBits)
                else:
                    self.packetBuffer = np.append(self.packetBuffer, newBits[:room])
                    packets.append(
                        self.Packet(self.packetBuffer, self.headerFrameStartIdx, self.headerMaskBitErrors)
                    )
                    self.headerFrameStartIdx = None
            else:
                splitIdx = len(self.packetBuffer)
                self.packetBuffer = np.append(
                    self.packetBuffer, rawBits[self.numBitsOverlap : frameEnd]
                )
                packets.append(
                    self.Packet(
                        self.packetBuffer,
                        self.headerFrameStartIdx,
                        self.headerMaskBitErrors,
                        frameSplitIdx=splitIdx,
                    )
                )
                self.headerFrameStartIdx = None

        if self.headerFrameStartIdx is None:
            for i in range(len(packetIdx)):
                if len(syncStarts) == 0:
                    frameEnd = None
                else:
                    endIdx = int(np.argmax(syncStarts > packetIdx[i] + 120))
                    if endIdx == 0:
                        frameEnd = None
                    else:
                        frameEnd = int(min(syncStarts[endIdx] + 16, syncStarts[-1]))

                if frameEnd is None:
                    # frame continues into the next block
                    self.packetBuffer = rawBits[packetIdx[i] :]
                    self.headerFrameStartIdx = frameStartIdx + packetIdx[i] - self.numBitsOverlap
                    self.headerMaskBitErrors = self.protocol.numOnesHeader - score[idxCand[i]]
                else:
                    bits = rawBits[packetIdx[i] : frameEnd]
                    if len(bits) >= 128:  # minimum frame length
                        packets.append(
                            self.Packet(
                                bits,
                                packetIdx[i] + frameStartIdx,
                                self.protocol.numOnesHeader - score[idxCand[i]],
                            )
                        )
        return packets

    def _find_fixed(self, rawBits, packetIdx, idxCand, score):
        packets = []
        for i in range(len(packetIdx)):
            if len(rawBits) - packetIdx[i] < self.packetLen:
                # wait for more data; widen the overlap buffer to keep all
                # candidate bits (reference decoder.py:254-263)
                startIdx = max(0, packetIdx[i] - 20)
                if len(rawBits) - startIdx > self.numBitsOverlap:
                    self.bitsOverlapBuf = rawBits[startIdx:]
                break
            bits = rawBits[packetIdx[i] : packetIdx[i] + self.packetLen]
            if len(bits) > 0:
                packets.append(
                    self.Packet(
                        bits,
                        packetIdx[i],
                        self.protocol.numOnesHeader - score[idxCand[i]],
                    )
                )
        return packets

    def _find_in_data(self, rawBits, packetIdx, idxCand, score):
        """Length field inside the (possibly whitened) packet.

        The overlap buffer is held from the FIRST candidate that still
        needs more data (so a genuine truncated frame deep inside the
        block survives to the next call even when junk candidates
        follow it), while the scan continues past it so complete frames
        behind a starving sidelobe candidate still decode this block.
        Frames emitted from inside a held window are remembered by their
        offset in the held buffer and skipped when they reappear on the
        next call.
        """
        packets = []
        emitted_prev = getattr(self, "_inDataEmittedPrev", set())
        emitted_abs = []
        held_start = None

        def hold(idx):
            nonlocal held_start
            if held_start is not None:
                return  # keep the earliest (largest) held window
            startIdx = max(0, idx - 20)
            if len(rawBits) - startIdx > self.numBitsOverlap:
                self.bitsOverlapBuf = rawBits[startIdx:]
                held_start = startIdx

        for i in range(len(packetIdx)):
            if packetIdx[i] in emitted_prev:
                # Already emitted from the previous held window; keep the
                # offset alive in case the window is held yet again, or the
                # frame would re-emit on the call after next.
                emitted_abs.append(int(packetIdx[i]))
                continue
            avail = len(rawBits) - packetIdx[i]
            hdr_len = (self.packetEndLenField + self.packetEndLenFieldNumBytes) * 8
            if avail < hdr_len:
                hold(packetIdx[i])
                continue
            lenBits = rawBits[
                packetIdx[i] + self.packetEndLenField * 8 : packetIdx[i] + hdr_len
            ]
            plen_bits = int(self.packetEndLenDecoder(lenBits)) * 8
            if plen_bits <= 0 or plen_bits > self.maxPacketLenBits:
                continue
            total = hdr_len + plen_bits
            if avail < total:
                hold(packetIdx[i])
                continue
            bits = rawBits[packetIdx[i] : packetIdx[i] + total]
            emitted_abs.append(int(packetIdx[i]))
            packets.append(
                self.Packet(bits, packetIdx[i], self.protocol.numOnesHeader - score[idxCand[i]])
            )
        if held_start is not None:
            self._inDataEmittedPrev = {p - held_start for p in emitted_abs
                                       if p >= held_start}
        else:
            self._inDataEmittedPrev = set()
        return packets
