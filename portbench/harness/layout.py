"""The packed result row the block graph returns, one f32 vector a block: a
frozen copy of the layout the program documents in ``ops/layout.py``, so that
a change to the program's layout fails the comparison instead of being read
through.

    [0, S) bits  [S, 2S) trust  [2S, 3S) symbols  [3S, 4S) centres
    [4S, 5S) mags  [5S, 5S+12) the scalars  [5S+12, L) E, (D, M) row-major
"""

import numpy as np

ARRAYS = ("bits", "trust", "symbols", "centres", "mags")
SCALARS = ("nSym", "nBits", "spSym", "codeOffset", "code_val", "dopp_idx", "quality_db",
           "doppler_hz", "freq_offset_hz", "snr_db", "shift", "clipped_any")


def row_len(S: int, D: int, M: int) -> int:
    return len(ARRAYS) * S + len(SCALARS) + D * M


def unpack(rows: np.ndarray, S: int, D: int, M: int) -> dict:
    """(B, L) packed rows -> a dict of (B, ...) numpy arrays."""
    rows = np.asarray(rows)
    if rows.ndim != 2 or rows.shape[1] != row_len(S, D, M):
        raise ValueError(f"expected (B, {row_len(S, D, M)}) rows, got {rows.shape}")
    out = {k: rows[:, i * S:(i + 1) * S] for i, k in enumerate(ARRAYS)}
    tail = rows[:, len(ARRAYS) * S:]
    out.update({k: tail[:, i] for i, k in enumerate(SCALARS)})
    out["E"] = tail[:, len(SCALARS):].reshape(-1, D, M)
    return out
