"""NRZ-S line coding (phase-ambiguity-free BPSK): a 1 keeps the previous
level, a 0 toggles it. A copy of ``pycusdr_tpu/utils/nrzs.py``."""

import numpy as np


def encode_nrzs(bits) -> np.ndarray:
    bits = np.asarray(bits).astype(np.uint8)
    out = np.zeros(len(bits), dtype=np.uint8)
    out[0] = bits[0]
    for i in range(1, len(bits)):
        out[i] = out[i - 1] if bits[i] == 1 else (~out[i - 1]) & 1
    return out


def decode_nrzs(levels) -> np.ndarray:
    levels = np.asarray(levels).astype(np.uint8)
    out = np.zeros(len(levels), dtype=np.uint8)
    out[0] = levels[0]
    out[1:] = (levels[1:] == levels[:-1]).astype(np.uint8)
    return out
