"""State carried across from the JAX package, and onto the device.

The demodulator has no weights; what plays their part is the resolved
``DemodSpec`` (filter bank, Doppler grid, timing band, LUTs).
``spec_from_numpy`` rebuilds the port's ``DemodSpec`` from the JAX
spec's fields given as plain numpy and Python values, so both packages
can compute from identical constants. ``DeviceConsts.from_spec`` puts
the tensors the block graph reads on the device (one shard's masks for
the generic channel x dopp step).

The decoder's tables (the branch tables of ``ops/viterbi._branch_tables``,
the RS generator and GF tables) are numpy copies that the tests hold
equal to the JAX package's. Its running state is the streaming Viterbi's
(``carry``, ``pending``, ``parity``): ``viterbi_stream_state`` hands a
JAX ``ViterbiStream``'s state over to a port stream mid-way. The
channelizer's taps and carry (``channelizer_from_jax``) and the tracker's
ramp history and state (``tracker_state``) cross over the same way.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pycusdr_tpu_torch.dsp.spec import DemodSpec
from pycusdr_tpu_torch.globals import TRUST_NORMAL_SCALE
from pycusdr_tpu_torch.ops.viterbi import ViterbiStream
from pycusdr_tpu_torch.ops.demod_kernels import fft_split, twiddle_table

_ARRAY_DTYPES = {"masks_f": np.complex64, "dopp_shifts": np.int32,
                 "dopp_hz_lut": np.float64}


def spec_from_numpy(fields: dict) -> DemodSpec:
    """A ``DemodSpec`` from its fields as numpy / Python values (e.g.
    ``{f.name: getattr(jax_spec, f.name) for f in dataclasses.fields(jax_spec)}``).
    The field set must match exactly."""
    names = {f.name for f in dataclasses.fields(DemodSpec)}
    if set(fields) != names:
        raise ValueError(f"DemodSpec fields differ: missing {sorted(names - set(fields))}, "
                         f"unknown {sorted(set(fields) - names)}")
    kw = dict(fields)
    for name, dt in _ARRAY_DTYPES.items():
        kw[name] = np.array(kw[name], dtype=dt)
    for name in ("bitLUT", "symbolLUT"):
        if kw[name] is not None:
            kw[name] = np.array(kw[name])
    return DemodSpec(**kw)


@dataclass(frozen=True)
class DeviceConsts:
    """The spec's tensors on one device."""

    masks_f: torch.Tensor  # (M, N) complex64 (the shard's rows with a mask_range)
    Q: torch.Tensor  # (M, N) f32, |masks_f|^2 computed in float64
    shifts: torch.Tensor  # (D,) int32 grid shifts in [0, N)
    shifts_signed: torch.Tensor  # (D,) int32 unwrapped into [-N/2, N/2)
    hz_lut: torch.Tensor  # (D,) f32
    bitLUT: torch.Tensor  # (M,) int8, or None for NRZ-S protocols
    symbolLUT: torch.Tensor  # (M, 2, K) int32 NRZ-S transition LUT, or None
    tw: torch.Tensor  # (N, 2) f32 twiddle table exp(+2πi j/N)
    fixed_shift: torch.Tensor  # (1,) int32 spectrum shift of the no-search mode
    n1: int  # K2's four-step split N = n1 * (N / n1)
    trust_normal: int
    threshold_scale: float  # spike clipping: thr = scale * mean|x|

    @classmethod
    def from_spec(cls, spec: DemodSpec, device, mask_range: tuple = None) -> "DeviceConsts":
        """``mask_range``: (m0, m1), one shard's masks of the generic
        channel x dopp step: ``masks_f`` and ``Q`` hold rows [m0, m1) only
        (the LUTs stay whole: they are indexed by the global symbol).
        None: every mask."""
        N = spec.Nfft
        shifts = np.asarray(spec.dopp_shifts, np.int64)
        masks = np.asarray(spec.masks_f, np.complex64)
        if mask_range is not None:
            m0, m1 = mask_range
            if not 0 <= m0 < m1 <= masks.shape[0]:
                raise ValueError(f"mask_range {mask_range} outside [0, {masks.shape[0]})")
            masks = masks[m0:m1]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(
            masks_f=t(masks),
            Q=t((np.abs(masks.astype(np.complex128)) ** 2).astype(np.float32)),
            shifts=t(shifts.astype(np.int32)),
            shifts_signed=t((np.mod(shifts + N // 2, N) - N // 2).astype(np.int32)),
            hz_lut=t(np.asarray(spec.dopp_hz_lut).astype(np.float32)),
            bitLUT=(None if spec.bitLUT is None
                    else t(np.asarray(spec.bitLUT).astype(np.int8))),
            symbolLUT=(None if spec.symbolLUT is None
                       else t(np.asarray(spec.symbolLUT).astype(np.int32))),
            tw=twiddle_table(N, device),
            fixed_shift=t(np.array([spec.dopp_offset_idx], np.int32)),
            n1=fft_split(N),
            # clamp: a fractional voteWeight config must not truncate to 0
            trust_normal=max(1, int(TRUST_NORMAL_SCALE * spec.voteWeight)),
            threshold_scale=float(spec.peak_threshold_scale),
        )


def viterbi_stream_state(carry, pending, parity, **stream_kw) -> ViterbiStream:
    """A port ``ViterbiStream`` that continues from another stream's state:
    ``carry`` and ``pending`` as numpy symbol arrays, ``parity`` None, 0 or
    1 (e.g. the attributes of a JAX ``ViterbiStream``). ``stream_kw`` are
    ``ViterbiStream``'s arguments (``soft``, ``invert_g2``, ``Dl``, ``Dh``,
    ``device``, ``plain``), which must match the other stream's."""
    vs = ViterbiStream(**stream_kw)
    vs.carry = np.array(carry, dtype=np.float32)
    vs.pending = np.array(pending, dtype=np.float32)
    vs.parity = None if parity is None else int(parity)
    return vs


def channelizer_from_jax(h2, state_ri, device=None):
    """A port ``Channelizer`` with a JAX ``Channelizer``'s taps ``h2``
    ((K, M) f32) and carry ``state_ri`` ((2, K-1, M) split re/im f32, as
    numpy), so ``process`` continues the JAX stream. ``device`` as the
    ``Channelizer``'s."""
    from pycusdr_tpu_torch.parallel.channelizer import Channelizer

    h2 = np.asarray(h2, np.float32)
    st = np.asarray(state_ri, np.float32)
    K, M = h2.shape
    if st.shape != (2, K - 1, M):
        raise ValueError(f"state_ri: expected (2, {K - 1}, {M}), got {st.shape}")
    ch = Channelizer(M, K, device=device)
    ch.h2 = torch.from_numpy(h2.copy()).to(ch.device)
    ch.state = torch.from_numpy((st[0] + 1j * st[1]).astype(np.complex64)).to(ch.device)
    return ch


def tracker_state(state, t_hist, hz_hist, lost, blocks, **tracker_kw):
    """A port ``DopplerTracker`` that resumes another tracker mid-pass: its
    mode (``ACQUIRING`` or ``TRACKING``), block-index and Doppler histories,
    weak-block count and block counter (a JAX tracker's ``state``, ``_t``,
    ``_hz``, ``_lost`` and ``_blocks``). ``tracker_kw`` are
    ``DopplerTracker``'s arguments, which must match the other tracker's."""
    from pycusdr_tpu_torch.models.tracking import ACQUIRING, TRACKING, DopplerTracker

    if state not in (ACQUIRING, TRACKING):
        raise ValueError(f"unknown tracker state {state!r}")
    tr = DopplerTracker(**tracker_kw)
    tr.state = state
    tr._t = [int(t) for t in t_hist]
    tr._hz = [float(h) for h in hz_hist]
    tr._lost = int(lost)
    tr._blocks = int(blocks)
    return tr
