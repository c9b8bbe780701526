"""CRC-16 implementations (replaces the reference's ``crcmod`` dependency;
the port's copy of ``pycusdr_tpu/utils/crc.py``, for the CC11xx framer).

The CC11xx link uses CRC-16 with polynomial 0x8005 (full poly 0x18005),
init 0xFFFF, no reflection, no final xor — the exact parameters passed
to ``crcmod.mkCrcFun`` in the reference (``pyCuSDR/protocol/CC11xx.py:255``
and ``pyCuSDR/modulator/encoders/CC11xx.py:42``).
"""

import numpy as np


def _build_table(poly: int = 0x8005) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            if crc & 0x8000:
                crc = ((crc << 1) ^ poly) & 0xFFFF
            else:
                crc = (crc << 1) & 0xFFFF
        table[byte] = crc
    return table


_CRC16_TABLE = _build_table()


def crc16_cc(data, init: int = 0xFFFF) -> int:
    """CRC-16/0x8005, MSB-first, init 0xFFFF, xorOut 0 (CC11xx flavour)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        buf = np.asarray(data).astype(np.uint8)
    crc = init
    for b in buf:
        crc = ((crc << 8) & 0xFFFF) ^ int(_CRC16_TABLE[((crc >> 8) ^ int(b)) & 0xFF])
    return crc


def crc16_bytes_le(data) -> np.ndarray:
    """CRC over ``data`` packed [low byte, high byte] as the CC11xx frame
    carries it (``modulator/encoders/CC11xx.py:90-92``: CRCH=uint8(CRC),
    CRCL=CRC//256, packed [CRCH, CRCL])."""
    crc = crc16_cc(data)
    return np.array([crc & 0xFF, crc >> 8], dtype=np.uint8)
