"""Streaming demodulation of T consecutive overlap-save hops in one call.

The port of ``pycusdr_tpu/parallel/halo.py`` on one card: block k's
head is the ``sigOverlap``-sample tail of hop k-1 (of the carry for the
first hop), which JAX exchanges between the shards of the ``time`` mesh
axis with ``ppermute``. Here all T blocks are assembled on the device
and demodulated by one batched call of the block graph. A ``time`` axis
over more than one device is ROADMAP Queue 1 item 16 (``parallel/mesh.py``
refuses such a mesh).
"""

import torch

from pycusdr_tpu_torch.dsp.block import build_process_batch
from pycusdr_tpu_torch.dsp.spec import DemodSpec
from pycusdr_tpu_torch.parallel.mesh import MULTI_DEVICE, Mesh


def build_time_sharded_stream(spec: DemodSpec, mesh: Mesh, axis: str = "time"):
    """Return ``stream(new_samples, carry_tail) -> (res, carry_out)``.

    ``new_samples``: (T, hop) complex64, T consecutive hops of ``hop =
    Nfft - sigOverlap`` fresh samples; ``carry_tail``: (sigOverlap,)
    complex64, the tail carried in from the previous call. ``res`` is the
    block graph's result dict without ``E``, each output with a leading T
    axis; ``carry_out`` the tail for the next call. Requires hop >=
    sigOverlap, as JAX does."""
    N, ov = spec.Nfft, spec.sigOverlap
    hop = N - ov
    if hop < ov:
        raise ValueError(f"hop ({hop}) must be >= sigOverlap ({ov})")
    if mesh.shape[axis] > 1:
        raise NotImplementedError(f"a '{axis}' axis of {mesh.shape[axis]}: {MULTI_DEVICE}")
    dev = mesh.device
    batch = build_process_batch(spec, device=dev)

    def stream(new_samples, carry_tail):
        new = torch.as_tensor(new_samples).to(dev, torch.complex64)
        carry = torch.as_tensor(carry_tail).to(dev, torch.complex64)
        if new.dim() != 2 or new.shape[1] != hop or tuple(carry.shape) != (ov,):
            raise ValueError(f"expected (T, {hop}) hops and a ({ov},) carry, got "
                             f"{tuple(new.shape)} and {tuple(carry.shape)}")
        tails = torch.cat([carry[None], new[:-1, hop - ov:]])  # (T, ov) block heads
        res = batch(torch.cat([tails, new], dim=1))
        res.pop("E")
        return res, new[-1, hop - ov:].clone()

    return stream
