"""CCSDS TM protocol plug-in — new capability over the reference.

The reference advertises Reed-Solomon via an external package but never
wires it into a link (SURVEY §0). This plug-in speaks CCSDS-style
telemetry frames: the 32-bit Attached Sync Marker ``0x1ACFFC1D``
followed by one RS(255,223) codeword (223 payload bytes + 32 parity),
bits MSB-first. The decoder corrects up to 16 byte errors per frame —
the modem keeps delivering clean frames well below the uncoded BER
cliff. FSK air interface (matched-filter bank shared with the bench
links); FIXED packet-end detection with the codeword length.

The port of ``pycusdr_tpu/protocol/ccsds.py``; ``CCSDSConv`` takes the
device its inner Viterbi runs on.
"""

import logging

import numpy as np

from pycusdr_tpu_torch.decode.rs import RSCodec, RSError
from pycusdr_tpu_torch.protocol.base import Packet, PacketEndDetect
from pycusdr_tpu_torch.protocol.fsk2 import FSK2

log = logging.getLogger(__name__)

ASM = np.array([0x1A, 0xCF, 0xFC, 0x1D], dtype=np.uint8)
ASM_BITS = np.unpackbits(ASM)  # 32 bits, MSB-first
RS_N, RS_K = 255, 223


class CCSDS(FSK2):
    name = "CCSDS"
    packetEndDetectMode = PacketEndDetect.FIXED
    packetLen = len(ASM_BITS) + RS_N * 8  # ASM + one codeword
    numBitsOverlap = 2 * packetLen  # frames may straddle blocks

    headerTol = 3
    syncSigTol = 2
    SUM_ALL_MASKS_PYTHON = True

    def __init__(self, **kwargs):
        self.conf = kwargs.get("conf")
        self.rs = RSCodec(RS_N, RS_K)

    def get_symbolLUT2(self, maskLen: int):
        masks = self._get_xcorrMasks(maskLen)
        return masks[:, maskLen // 2], []

    def get_mask(self):
        mask = ASM_BITS.astype(np.float64)
        self.numOnesHeader = float(np.sum(mask))
        return np.flipud(mask * 2 - 1)

    def get_syncFlag(self):
        # FIXED mode does not use the sync correlator; reuse the ASM so
        # numSyncSig telemetry counts markers
        self.numOnesSyncSig = float(np.sum(ASM_BITS))
        return np.flipud(ASM_BITS.astype(np.float64) * 2 - 1)

    def Packet(self, *args, **kwargs):
        return PacketCCSDS(self, *args, **kwargs)

    # ---------------- Tx ----------------

    def getFramer(self, confRadio):
        from pycusdr_tpu_torch.tx.encoders import CCSDSEncoder

        return CCSDSEncoder

    def getModulator(self, confRadio):
        from pycusdr_tpu_torch.tx.luts import FSKmod

        return FSKmod

    def initTxHeader(self, noFlags: int = 0):
        return np.array([], dtype=np.uint8), ASM_BITS.copy()

    def initTxTail(self, noFlags: int = 0):
        return np.array([], dtype=np.uint8), np.array([], dtype=np.uint8)


class PacketCCSDS(Packet):
    """ASM + RS(255,223) codeword -> corrected 223-byte payload."""

    def __init__(self, protocol, bits, frameStartIdx=0, maskBitErrors=0,
                 frameSplitIdx=0, **kwargs):
        self.protocol = protocol
        self.frameStartIdx = frameStartIdx
        self.maskBitErrors = maskBitErrors
        self.bits = np.asarray(bits, dtype=np.uint8)

    def getBinaryData(self):
        """Returns (payload bytes, nCorrectedErrors or -1, payload)."""
        b = self.bits
        cw_bits = b[len(ASM_BITS) : len(ASM_BITS) + RS_N * 8]
        if len(cw_bits) < RS_N * 8:
            return np.array([], np.uint8), -1, np.array([], np.uint8)
        cw = np.packbits(cw_bits)
        try:
            payload, nerr = self.protocol.rs.decode(cw)
        except RSError:
            return np.packbits(cw_bits)[:RS_K], -1, np.array([], np.uint8)
        return payload, int(nerr), payload

    def getBinaryRawData(self):
        return self.bits

    def getAsciiAddress(self):
        return "CCSDS-TM"

    def checkPacketData(self):
        _, nerr, _ = self.getBinaryData()
        return nerr


class CCSDSConv(CCSDS):
    """Concatenated CCSDS: convolutional K=7 r=1/2 inner code (Viterbi
    inner decode over the whole bit stream) + RS(255,223) outer code.

    The ASM is attached before convolutional encoding (CCSDS 131.0-B),
    so the Rx pipeline Viterbi-decodes the demodulated stream in the
    ``decoderPreprocessor`` and the frame finder then sees the clean
    ASM + codeword domain. Per-block decoding leaves a few bit errors
    near block seams (no cross-block trellis state); the outer RS code
    absorbs them — exactly the division of labour the concatenated
    design is for.
    """

    name = "CCSDS-conv"

    def __init__(self, device=None, **kwargs):
        """``device``: where the inner Viterbi runs (kernel K7); None
        means the card (the stream raises without one), "cpu" the plain
        version."""
        super().__init__(**kwargs)
        self.device = device

    def decoderPreprocessor(self, bits, stream_state=None, trust=None, **kwargs):
        """Streaming inner Viterbi: trellis carry + node sync live in
        the frame finder's per-stream state dict, so consecutive blocks
        decode with full cross-seam context.

        When the demod's per-bit ``trust`` is available the decode is
        soft-decision: distrusted bits (clip-tagged or symbol-error,
        trust < 0) become erasures (weight 0) instead of hard lies —
        worth ~2 dB on the inner code and the difference between a lost
        and a recovered frame under pulsed interference."""
        from pycusdr_tpu_torch.ops.viterbi import ViterbiStream

        if stream_state is None:
            stream_state = {}
        vs = stream_state.get("viterbi")
        if vs is None:
            vs = stream_state["viterbi"] = ViterbiStream(soft=trust is not None,
                                                         device=self.device)

        bits = np.asarray(bits)
        if vs.soft:
            sym = bits.astype(np.float32) * 2.0 - 1.0
            if trust is not None and len(trust) == len(bits):
                sym = sym * (np.asarray(trust) >= 0)
            return vs.feed(sym)
        return vs.feed(bits)

    def getFramer(self, confRadio):
        from pycusdr_tpu_torch.tx.encoders import CCSDSConvEncoder

        return CCSDSConvEncoder
