"""Tx framers/encoders (OSI L2), the port of ``pycusdr_tpu/tx/encoders.py``.

Capability parity with ``pyCuSDR/modulator/encoders/`` — the base hook
pipeline (pre-frame → frame → post-frame, ``encoder_base.py:10-90``),
the benchmark pass-through framer and the CCSDS framers. The CC11xx and
AX.25 framers come with their protocols.
"""

import logging

import numpy as np

log = logging.getLogger(__name__)


def _as_u8(data):
    """Payloads arrive as ndarray from the process layer but as bytes
    from direct library use (np.asarray rejects bytes for uint8)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


class Encoder:
    """Base framer: identity pipeline with the standard hooks."""

    name = "base"

    def __init__(self, protocol, confRadio):
        self.protocol = protocol
        self.confRadio = confRadio

    def preframingProcess(self, byteData):
        return byteData

    def frame(self, bitData):
        return bitData

    def postframingProcess(self, bitData):
        return bitData

    def encodeAndFrame(self, data):
        data = _as_u8(data)
        data = self.preframingProcess(data)
        bits = np.unpackbits(data)
        return self.postframingProcess(self.frame(bits))


class RawEncoder(Encoder):
    """Pass-through bit framer used by benchmark protocols: prepends the
    protocol's seeded header so the bench decoder's mask matches."""

    name = "raw-bench"

    def __init__(self, protocol, confRadio):
        super().__init__(protocol, confRadio)
        self.Flags, self.Header = protocol.initTxHeader()

    def encodeAndFrame(self, data):
        bits = _as_u8(data)
        if bits.max(initial=0) > 1:  # bytes given, expand
            bits = np.unpackbits(bits)
        return np.r_[self.Flags, self.Header, bits].astype(np.uint8)


class CCSDSEncoder(Encoder):
    """CCSDS TM framer: 223-byte payload -> RS(255,223) codeword,
    prefixed by the 32-bit ASM (see protocol/ccsds.py)."""

    name = "ccsds"

    def __init__(self, protocol, confRadio):
        super().__init__(protocol, confRadio)
        _, self.asm_bits = protocol.initTxHeader()

    def encodeAndFrame(self, data):
        from pycusdr_tpu_torch.protocol.ccsds import RS_K

        payload = _as_u8(data)
        if len(payload) > RS_K:
            raise ValueError(f"CCSDS payload must be <= {RS_K} bytes, got {len(payload)}")
        if len(payload) < RS_K:  # virtual fill (zero padding) per CCSDS
            payload = np.r_[payload, np.zeros(RS_K - len(payload), np.uint8)]
        cw = self.protocol.rs.encode(payload)
        return np.r_[self.asm_bits, np.unpackbits(np.asarray(cw, np.uint8))].astype(np.uint8)


class CCSDSConvEncoder(CCSDSEncoder):
    """Concatenated CCSDS Tx: (ASM + RS codeword) -> K=7 r=1/2
    convolutional encoding (see protocol/ccsds.py CCSDSConv)."""

    name = "ccsds-conv"

    def encodeAndFrame(self, data):
        from pycusdr_tpu_torch.ops.viterbi import conv_encode

        inner = super().encodeAndFrame(data)
        return conv_encode(inner).astype(np.uint8)
