"""Wideband polyphase channelizer front end (kernel K9).

The port of ``pycusdr_tpu/parallel/channelizer.py`` (BASELINE config #5):
a critically sampled M-channel analysis filterbank that splits one
wideband capture into M baseband channels at fs/M each. Channel m is
centred at m·fs/M:

    xp      = [state; x as (T, M) rows]
    v[t, p] = sum_k h2[k, p] · xp[t + K-1-k, p]       (branch p: taps h[kM + p])
    y[m, t] = sum_p v[t, p] · e^{-2πi p m / M}

``channelize_plain`` is the plain PyTorch version; ``channelize`` is K9's
wrapper (``csrc/channelizer.cu``), which counts its launches. The
(M, T) complex64 output is channel-major and contiguous: the (B = M,
Nfft = T) batch that ``parallel.build_sharded_demod_step`` takes with no
copy. ``design_prototype`` and ``channelize_numpy`` are copies of the JAX
package's.
"""

import numpy as np
import torch

from pycusdr_tpu_torch.ops import _lib
from pycusdr_tpu_torch.ops.demod_kernels import twiddle_table

#: K9 takes power-of-two M up to this many branches ...
K9_MAX_M = 1024
#: ... and up to this many taps per branch (the plain version takes any
#: power-of-two M and any K >= 1, as JAX's channelizer does)
K9_MAX_K = 32


def design_prototype(M: int, taps_per_branch: int = 8, beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, cutoff 1/(2M), length M*taps."""
    L = M * taps_per_branch
    n = np.arange(L) - (L - 1) / 2
    h = np.sinc(n / M) * np.kaiser(L, beta)
    return (h / h.sum()).astype(np.float64)


def channelize_numpy(x: np.ndarray, M: int, taps_per_branch: int = 8,
                     beta: float = 9.0) -> np.ndarray:
    """Direct numpy reference (golden for tests): same math on complex."""
    h = design_prototype(M, taps_per_branch, beta)
    K = taps_per_branch
    T = len(x) // M
    xp = np.concatenate([np.zeros((K - 1) * M, x.dtype), x[: T * M]])
    xm = xp.reshape(T + K - 1, M)
    h2 = h.reshape(K, M)
    v = np.zeros((T, M), np.complex128)
    for k in range(K):
        v += h2[k][None, :] * xm[K - 1 - k : K - 1 - k + T]
    return np.fft.fft(v, axis=1).T  # (M, T)


def _check_shape(M: int, K: int) -> None:
    if M < 1 or M & (M - 1) or K < 1:
        raise ValueError(f"channelizer: M must be a power of two and K >= 1, got M={M}, K={K}")


def k9_check_shape(M: int, K: int) -> None:
    """K9's own limits (its shared-memory tile): a power-of-two M <= 1024
    and 1 <= K <= 32. Beyond them the wrapper raises on a CUDA tensor."""
    _check_shape(M, K)
    if M > K9_MAX_M or K > K9_MAX_K:
        raise ValueError(f"channelize: K9 takes M <= {K9_MAX_M} and K <= {K9_MAX_K} (a power "
                         f"of two M), got M={M}, K={K}")


def _rows(x: torch.Tensor, M: int) -> int:
    if x.dim() != 1 or x.numel() % M or x.numel() == 0:
        raise ValueError(f"channelizer: x must be (T*{M},) samples, got {tuple(x.shape)}")
    return x.numel() // M


def _new_state(x: torch.Tensor, state: torch.Tensor, T: int, K: int, M: int) -> torch.Tensor:
    """The last K-1 rows of [state; x]: the carry into the next call."""
    xm = x.view(T, M)
    if T >= K - 1:
        return xm[T - (K - 1):].clone()
    if state is None:
        state = torch.zeros((K - 1, M), dtype=x.dtype, device=x.device)
    return torch.cat([state[T:], xm])


def channelize_plain(x: torch.Tensor, h2: torch.Tensor, state: torch.Tensor = None):
    """Plain PyTorch K9. x: (T*M,) complex64; h2: (K, M) f32; state:
    (K-1, M) complex64, None for zeros. Returns (y (M, T) complex64,
    new_state (K-1, M)): the K-tap sum in JAX's order, then
    ``torch.fft.fft`` across the branches."""
    K, M = h2.shape
    T = _rows(x, M)
    if state is None:
        state = torch.zeros((K - 1, M), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x.reshape(T, M)])
    v = torch.zeros((T, M), dtype=torch.complex64, device=x.device)
    for k in range(K):
        v = v + h2[k] * xp[K - 1 - k:K - 1 - k + T]
    return torch.fft.fft(v, dim=1).T.contiguous(), xp[T:].clone()


def channelize(x: torch.Tensor, h2: torch.Tensor, state: torch.Tensor = None,
               tw: torch.Tensor = None):
    """K9: the channelizer in one launch (arguments and outputs as
    ``channelize_plain``; ``tw``: the (M, 2) ``twiddle_table(M)``, built
    when None). A CPU tensor takes the plain version; a CUDA tensor
    launches ``csrc/channelizer.cu`` or raises (``k9_check_shape``): it
    never gives way to the plain version. ``new_state`` is a copy of the
    last K-1 input rows."""
    if x.device.type == "cpu":
        return channelize_plain(x, h2, state)
    if x.device.type != "cuda":
        raise ValueError(f"channelize: unsupported device {x.device}")
    K, M = h2.shape
    k9_check_shape(M, K)
    T = _rows(x, M)
    _lib.check(x, "x", torch.complex64, (T * M,))
    _lib.check(h2, "h2", torch.float32, (K, M), x.device)
    if state is not None:
        _lib.check(state, "state", torch.complex64, (K - 1, M), x.device)
    if tw is None:
        tw = twiddle_table(M, x.device)
    _lib.check(tw, "tw", torch.float32, (M, 2), x.device)
    y = torch.empty((M, T), dtype=torch.complex64, device=x.device)
    _lib.launch("pycusdr_channelize", _lib.ptr(x), _lib.ptr(state), _lib.ptr(h2),
                _lib.ptr(tw), _lib.ptr(y), T, M, K)
    channelize.launches += 1
    return y, _new_state(x, state, T, K, M)


channelize.launches = 0


class Channelizer:
    """Critically sampled M-channel analysis PFB with streaming state.

    ``device``: None means the card (raises without one); "cpu" runs the
    plain version. ``ch(x, state=None)`` returns ``(y, new_state)`` as the
    JAX ``Channelizer`` does (None: zero state); ``ch.process(x)`` carries
    ``ch.state`` from call to call."""

    def __init__(self, M: int, taps_per_branch: int = 8, beta: float = 9.0, device=None):
        _check_shape(M, taps_per_branch)
        self.M = M
        self.K = taps_per_branch
        self.device = _lib.resolve_device(device)
        h = design_prototype(M, taps_per_branch, beta)
        # polyphase decomposition: branch p uses taps h[kM + p]
        self.h2 = torch.from_numpy(h.reshape(self.K, M).astype(np.float32)).to(self.device)
        self.tw = twiddle_table(M, self.device)
        self.state = self.init_state()

    def init_state(self) -> torch.Tensor:
        return torch.zeros((self.K - 1, self.M), dtype=torch.complex64, device=self.device)

    def __call__(self, x, state=None):
        x = torch.as_tensor(x).to(self.device, torch.complex64).reshape(-1).contiguous()
        if state is not None:
            state = torch.as_tensor(state).to(self.device, torch.complex64).contiguous()
        return channelize(x, self.h2, state, tw=self.tw)

    def process(self, x) -> torch.Tensor:
        """Channelize the next ``x`` of a stream: the carry goes in from and
        out to ``self.state``. Returns y (M, T)."""
        y, self.state = self(x, self.state)
        return y
