"""FFT cross-correlation helpers: the port of ``pycusdr_tpu/utils/xcorr.py``.

``custom_xcorr`` and ``custom_xcorr_fast`` are copies of the JAX
package's numpy functions (the softCombiner's alignment,
``pyCuSDR/lib/customXCorr.py:5-30``). ``custom_xcorr_torch`` is the
counterpart of ``custom_xcorr_jax`` for tensors on a device: three plain
transforms and a conjugate product with nothing fused between them, so
it goes to cuFFT through ``torch.fft`` on the card, as the block graph's
own FFT does.
"""

import numpy as np
import torch


def custom_xcorr(a, b, N=None):
    """Circular cross-correlation via FFT: ifft(fft(a) * conj(fft(b))).

    The peak index locates where ``b`` starts inside ``a``.
    """
    Na, Nb = len(a), len(b)
    if N is None:
        N = max(Na, Nb)
    A = np.fft.fft(a, N)
    B = np.fft.fft(b, N)
    return np.fft.ifft(A * np.conj(B), N)


def custom_xcorr_fast(a, b):
    """Zero-pad to the next power of two before correlating."""
    N = int(2 ** np.ceil(np.log2(max(len(a), len(b)))))
    return custom_xcorr(a, b, N)


def custom_xcorr_torch(a: torch.Tensor, b: torch.Tensor, N: int) -> torch.Tensor:
    """``custom_xcorr`` on tensors at a fixed FFT length ``N``: each input is
    zero-padded to N, or cut to its first N samples, as ``jnp.fft.fft(a, N)``
    does; the result is complex, (N,)."""
    A = torch.fft.fft(torch.as_tensor(a), n=N)
    B = torch.fft.fft(torch.as_tensor(b), n=N)
    return torch.fft.ifft(A * torch.conj(B), n=N)
