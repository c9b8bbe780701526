"""Bit/byte packing helpers (MSB-first wire order).

Capability parity with ``pyCuSDR/lib/msbLsbBinOps.py``; the port's copy
of ``pycusdr_tpu/utils/binops.py``.
"""

import numpy as np


def unpack_bits_msb(byte_data) -> np.ndarray:
    """Bytes -> bits, MSB first (matches np.unpackbits)."""
    return np.unpackbits(np.asarray(byte_data, dtype=np.uint8))


def pack_bits_msb(bits) -> np.ndarray:
    """Bits (MSB first) -> bytes; truncates trailing partial bytes."""
    bits = np.asarray(bits).astype(np.uint8)
    n = (len(bits) // 8) * 8
    return np.packbits(bits[:n])


def bits_to_uint(bits, msb_first: bool = True) -> int:
    bits = np.asarray(bits).astype(np.int64)
    if msb_first:
        weights = 2 ** np.arange(len(bits) - 1, -1, -1)
    else:
        weights = 2 ** np.arange(len(bits))
    return int(np.dot(bits, weights))


def hexstr(data) -> str:
    return " ".join(f"{int(x) & 0xFF:02X}" for x in data)
