"""State carried across from the JAX package, and onto the device.

The demodulator has no weights; what plays their part is the resolved
``DemodSpec`` (filter bank, Doppler grid, timing band, LUTs).
``spec_from_numpy`` rebuilds the port's ``DemodSpec`` from the JAX
spec's fields given as plain numpy and Python values, so both packages
can compute from identical constants. ``DeviceConsts.from_spec`` puts
the tensors the block graph reads on the device.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pycusdr_tpu_torch.dsp.spec import DemodSpec
from pycusdr_tpu_torch.globals import TRUST_NORMAL_SCALE
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

    masks_f: torch.Tensor  # (M, N) complex64
    Q: torch.Tensor  # (M, N) f32, |masks_f|^2 computed in float64
    shifts: torch.Tensor  # (D,) int32 grid shifts in [0, N)
    shifts_signed: torch.Tensor  # (D,) int32 unwrapped into [-N/2, N/2)
    hz_lut: torch.Tensor  # (D,) f32
    bitLUT: torch.Tensor  # (M,) int8
    tw: torch.Tensor  # (N, 2) f32 twiddle table exp(+2πi j/N)
    fixed_shift: torch.Tensor  # (1,) int32 spectrum shift of the no-search mode
    n1: int  # K2's four-step split N = n1 * (N / n1)
    trust_normal: int
    threshold_scale: float  # spike clipping: thr = scale * mean|x|

    @classmethod
    def from_spec(cls, spec: DemodSpec, device) -> "DeviceConsts":
        N = spec.Nfft
        shifts = np.asarray(spec.dopp_shifts, np.int64)
        masks = np.asarray(spec.masks_f, np.complex64)

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
            tw=twiddle_table(N, device),
            fixed_shift=t(np.array([spec.dopp_offset_idx], np.int32)),
            n1=fft_split(N),
            # clamp: a fractional voteWeight config must not truncate to 0
            trust_normal=max(1, int(TRUST_NORMAL_SCALE * spec.voteWeight)),
            threshold_scale=float(spec.peak_threshold_scale),
        )
