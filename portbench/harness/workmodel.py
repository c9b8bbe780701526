"""The frozen work model: the least work each stage's function needs, and the
card's peaks that turn it into a least time.

Copied from the program's ``bench/profile_stages.py`` (``kernel_work``,
``k6_work``, ``stage_work``: compulsory bytes, inputs read once and outputs
written once, and the operations of the cheapest known algorithm, an FFT of
length n counted as 5 n log2 n complex, 2.5 n log2 n real), so that a later
change to the program cannot move the yardstick. One change: operations are
divided by the TF32 dense peak, not the f32 rate outside the tensor cores,
since tensor cores can compute the transforms and the products at f32
accuracy (K1 already does, as 3xTF32); a stage rewritten for them then still
reads under 100%. K5's SNR bands are counted at no bins (its least work is
then a little lower than the inputs need).

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit).
"""

import math

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12


def bound(nbytes: float, ops: float):
    """(seconds, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the TF32 dense rate."""
    tb, tf = nbytes / HBM_BYTES_PER_S, ops / TF32_FLOPS_PER_S
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def _rfft(N):
    return 2.5 * N * math.log2(N)


def doppler(B, N, D, M):
    """K1 then K5: P, Q, the shifts in, E out | the cheaper of the shifted dot
    and the FFT correlation; then E and the grid tables in, the scalars, the
    shift and E out | the mask sums, the two top-2 scans, the scalar tail."""
    k1 = (4 * (B * N + M * N + D + B * D * M),
          min(2 * B * D * M * N, _rfft(N) * (B + M + B * M) + 3 * B * M * N))
    k5 = (4 * (2 * B * D * M + 3 * D + 7 * B), B * (D * M + 2 * D) + 40 * B)
    return k1[0] + k5[0], k1[1] + k5[1]


def mask_bank(B, N, M):
    """K2: S, masks, shift in; colsum, colmax, colargmax out | M complex
    inverse FFTs, the mask product and the power a block."""
    return 8 * B * N + 8 * M * N + 4 * B + 12 * B * N, B * M * (2 * _rfft(N) + 9 * N)


def clip(B, N):
    """K6: x in; the clipped signal, the hit bitmask and clipped_any out |
    |x|, two compares, two sums, four multiplies a sample."""
    return 16 * B * N + 4 * B * -(-N // 32) + 4 * B, 12 * B * N


def channelize(M, T, K):
    """K9: x, the taps and the carry in; y and the new carry out | the K-tap
    FIR a branch sample (complex by real) and an M-point DFT a row."""
    return (8 * M * T * 2 + 4 * K * M + 2 * 8 * (K - 1) * M,
            8 * K * M * T + 5 * M * T * math.log2(M))
