"""Shift-register sequence generators: PN9 whitening, SSRG, Barker codes.

Capability parity with ``pyCuSDR/lib/shift_registers.py:6-91``; the
port's copy of ``pycusdr_tpu/utils/shift_registers.py``.
"""

import numpy as np

_BARKER = {
    2: [np.array([1, 1]), np.array([1, 1]), np.array([1, -1])],
    3: [np.array([1, 1, -1])],
    4: [np.array([1, 1, -1, 1]), np.array([1, 1, 1, -1])],
    5: [np.array([1, 1, 1, -1, 1])],
    7: [np.array([1, 1, 1, -1, -1, 1, -1])],
    11: [np.array([1, 1, 1, -1, -1, -1, 1, -1, -1, 1, -1])],
    13: [np.array([1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1])],
}


def pn9(num_codes: int = 300, initial_value=None) -> np.ndarray:
    """PN9 whitening byte LUT, polynomial x^9 + x^5 + 1 (CC11xx data sheet).

    The register clocks once per bit; a whitening byte is formed from
    the low 8 register bits every 8 clocks. Returns ``num_codes`` bytes.
    """
    state = np.ones(9, dtype=np.uint8) if initial_value is None else np.asarray(initial_value, np.uint8).copy()
    out = np.empty(num_codes, dtype=np.uint16)
    weights = np.r_[2 ** np.arange(8), 0]  # byte from register bits 0..7
    for i in range(num_codes):
        out[i] = int(np.dot(state, weights))
        for _ in range(8):
            fb = state[0] ^ state[5]
            state[:-1] = state[1:]
            state[-1] = fb
    return out.astype(np.int64)


def ssrg(L: int, fbtaps) -> np.ndarray:
    """Simple shift register generator; ``fbtaps`` 1-indexed feedback taps.

    Returns the length ``2**L - 1`` binary m-sequence.
    """
    taps0 = [t - 1 for t in fbtaps]
    reg = np.ones(L, dtype=np.int64)
    seq = np.empty(2**L - 1, dtype=np.int64)
    for i in range(2**L - 1):
        first = reg[0]
        reg[0] = np.sum(reg[taps0]) % 2
        reg[2:] = reg[1:-1]
        reg[1] = first
        seq[i] = reg[-1]
    return seq


def barker_code(L: int, codeIdx: int = 0) -> np.ndarray:
    """Length-``L`` Barker code (±1). ``codeIdx`` picks among variants."""
    if L not in _BARKER:
        raise IndexError(
            f"Barker code of length {L} not found. Available lengths: {sorted(_BARKER)}"
        )
    variants = _BARKER[L]
    return variants[min(codeIdx, len(variants) - 1)].copy()
