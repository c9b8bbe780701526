"""Tx framers/encoders (OSI L2), the port of ``pycusdr_tpu/tx/encoders.py``.

Capability parity with ``pyCuSDR/modulator/encoders/`` — the base hook
pipeline (pre-frame → frame → post-frame, ``encoder_base.py:10-90``),
the benchmark pass-through framer, the CC11xx framer (length byte +
CRC-16 + PN9 whitening + preamble/sync, ``CC11xx.py:16-148``), the AX.25
framer and the CCSDS framers.
"""

import logging

import numpy as np

from pycusdr_tpu_torch.utils.crc import crc16_cc
from pycusdr_tpu_torch.utils.shift_registers import pn9

log = logging.getLogger(__name__)

MAX_TX_DATA_LEN = 255  # the on-air length byte is uint8


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


class CC11xxEncoder(Encoder):
    """CC11xx compatible framer.

    frame layout: preamble flags | sync | [len | payload | CRC16] where
    the bracketed section is PN9-whitened when the protocol asks for it.
    """

    name = "CC11xx"

    def __init__(self, protocol, confRadio):
        super().__init__(protocol, confRadio)
        self.whiten = protocol.whiten
        self.Flags, self.Header = protocol.initTxHeader()
        self.TailFlags, self.Tail = protocol.initTxTail()
        if self.whiten:
            self.PN9seq = pn9()

    def preframingProcess(self, byteData):
        if self.whiten:
            byteData = np.bitwise_xor(byteData, self.PN9seq[: len(byteData)].astype(np.uint8))
        return byteData

    def encodeAndFrame(self, data):
        from pycusdr_tpu_torch.tx import DataLengthError

        data = _as_u8(data)
        dataLen = len(data) + 2  # CRC included in the length count
        if dataLen > MAX_TX_DATA_LEN:
            raise DataLengthError(
                f"TX maximum allowed data length {MAX_TX_DATA_LEN} bytes, got {dataLen}"
            )

        framed = np.r_[np.uint8(dataLen), data].astype(np.uint8)
        crc = crc16_cc(framed)
        crc_packed = np.array([crc & 0xFF, crc >> 8], dtype=np.uint8)  # [low, high]
        framed = np.r_[framed, crc_packed].astype(np.uint8)

        framed = self.preframingProcess(framed)
        bits = np.unpackbits(framed)
        return self.postframingProcess(self.frame(bits))

    def frame(self, bits):
        preamble = np.r_[self.Flags, self.Header].astype(np.uint8)
        return np.r_[preamble, bits].astype(np.uint8)


class AX25Encoder(Encoder):
    """HDLC/AX.25 framer: UI frame bytes -> LSB-first bits -> bit
    stuffing -> flag wrapping -> NRZI line coding (see protocol/ax25.py)."""

    name = "ax25"

    def __init__(self, protocol, confRadio):
        super().__init__(protocol, confRadio)
        self.preFlags, _ = protocol.initTxHeader()
        self.postFlags, _ = protocol.initTxTail()

    def encodeAndFrame(self, data):
        from pycusdr_tpu_torch.protocol.ax25 import (
            bit_stuff,
            build_ui_frame,
            bytes_to_bits_lsb,
            nrzi_encode,
            scramble_g3ruh,
        )

        frame = build_ui_frame(_as_u8(data))
        stuffed = bit_stuff(bytes_to_bits_lsb(frame))
        bits = np.r_[self.preFlags, stuffed, self.postFlags].astype(np.uint8)
        if getattr(self.protocol, "nrzi", True):
            bits = nrzi_encode(bits)
        if getattr(self.protocol, "scramble", False):
            bits = scramble_g3ruh(bits)
        return bits


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
