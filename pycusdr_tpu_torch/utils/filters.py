"""Pulse-shaping filter design (host-side numpy): the root-raised-cosine
filter of the BPSK templates and test signal, and the Gaussian pulse
filter the GFSK test-signal generator uses (copies of
``pycusdr_tpu/utils/filters.py:rrcosfilter`` and ``gaussian_filter``)."""

import numpy as np


def rrcosfilter(beta: float, span: int, spsym: int) -> np.ndarray:
    """Root-raised-cosine FIR taps with rolloff ``beta``.

    Truncated to ``span`` symbols at ``spsym`` samples/symbol; unit
    energy. Matches MATLAB ``rcosdesign(beta, span, sps, 'sqrt')``.
    """
    delay = span * spsym / 2
    t = np.arange(-delay, delay + 1) / spsym

    b = np.zeros(len(t))

    # t == 0 midpoint
    idx_mid = np.where(t == 0)[0]
    if idx_mid.size:
        b[idx_mid] = -1 / (np.pi * spsym) * (np.pi * (beta - 1) - 4 * beta)

    # |4*beta*t| == 1 singular points
    eps = np.sqrt(np.finfo(float).eps)
    idx_sing = np.where(np.abs(np.abs(4 * beta * t) - 1) < eps)[0]
    if idx_sing.size:
        b[idx_sing] = (
            1
            / (2 * np.pi * spsym)
            * (
                np.pi * (beta + 1) * np.sin(np.pi * (beta + 1) / (4 * beta))
                - 4 * beta * np.sin(np.pi * (beta - 1) / (4 * beta))
                + np.pi * (beta - 1) * np.cos(np.pi * (beta - 1) / (4 * beta))
            )
        )

    # regular points
    idx_reg = np.setdiff1d(np.arange(len(t)), np.concatenate([idx_mid, idx_sing]))
    tr = t[idx_reg]
    b[idx_reg] = (
        -4
        * beta
        / spsym
        * (np.cos((1 + beta) * np.pi * tr) + np.sin((1 - beta) * np.pi * tr) / (4 * beta * tr))
        / (np.pi * ((4 * beta * tr) ** 2 - 1))
    )

    return b / np.sqrt(np.sum(b**2))


def gaussian_filter(gain: float, BT: float, spsym: int, ntaps: int) -> np.ndarray:
    """Gaussian pulse filter taps (GMSK/GFSK premodulation).

    ``BT`` is the bandwidth-time product; normalized so the taps sum to
    ``1/gain``.
    """
    a = np.sqrt(np.log(2) / 2) / BT
    t = np.linspace(-0.5 * ntaps, 0.5 * ntaps - 1, ntaps) / spsym

    ft = np.sqrt(np.pi) / a * np.exp(-(np.pi**2 * t**2) / a**2)
    ft /= np.sum(ft) * gain
    return ft
