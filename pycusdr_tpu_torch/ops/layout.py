"""The packed result row: one f32 vector per block, in the layout of
``pycusdr_tpu/dsp/block.py:60-111``. On the card the kernels write their
outputs straight into it (K4 the per-slot arrays and its scalars, K5 the
Doppler scalars and E); ``dsp/block.pack_block_outputs`` builds the same
row from a result dict.

    [0, S)        bits          [S, 2S)    trust        [2S, 3S)  symbols
    [3S, 4S)      centres       [4S, 5S)   mags
    [5S, 5S+12)   the scalars, in PACK_SCALARS order
    [5S+12, L)    E, (D, M) row-major

with S = numSymMax. Integer payloads are < 2^24, so f32 holds them exactly.
"""

#: per-slot arrays in row order
PACK_ARRAYS = ("bits", "trust", "symbols", "centres", "mags")

#: scalar outputs in row order
PACK_SCALARS = ("nSym", "nBits", "spSym", "codeOffset", "code_val",
                "dopp_idx", "quality_db", "doppler_hz", "freq_offset_hz",
                "snr_db", "shift", "clipped_any")

#: index of each scalar within the row's tail row[:, 5 S:]
SCALAR = {k: i for i, k in enumerate(PACK_SCALARS)}

#: where E starts within the tail
E_AT = len(PACK_SCALARS)


def row_len(numSymMax: int, D: int, M: int) -> int:
    return len(PACK_ARRAYS) * numSymMax + len(PACK_SCALARS) + D * M
