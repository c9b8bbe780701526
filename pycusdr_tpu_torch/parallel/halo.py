"""Streaming demodulation of T consecutive overlap-save hops in one call,
sharded over the ``time`` axis of a mesh.

The port of ``pycusdr_tpu/parallel/halo.py``: block k's head is the
``sigOverlap``-sample tail of hop k-1 (of the carry for the first hop).
Each rank holds Tl consecutive hops of the T; it sends its last hop's
tail to the next rank with ``ppermute`` (``halo.py:46-53``), rank 0 takes
the carry instead, and every rank demodulates its Tl blocks in one
batched call of the block graph. On a one-device mesh all T blocks are
assembled on the device and demodulated together.
"""

import torch

from pycusdr_tpu_torch.dsp.block import build_process_batch
from pycusdr_tpu_torch.dsp.spec import DemodSpec
from pycusdr_tpu_torch.parallel.collectives import all_gather, ppermute
from pycusdr_tpu_torch.parallel.mesh import Mesh


def build_time_sharded_stream(spec: DemodSpec, mesh: Mesh, axis: str = "time"):
    """Return ``stream(new_samples, carry_tail) -> (res, carry_out)``.

    ``new_samples``: (Tl, hop) complex64, this rank's Tl of T consecutive
    hops of ``hop = Nfft - sigOverlap`` fresh samples (the ranks of the
    ``axis`` hold them in axis order); ``carry_tail``: (sigOverlap,)
    complex64, the tail carried in from the previous call (rank 0 reads
    it). ``res`` is the block graph's result dict without ``E``, each
    output with a leading Tl axis; ``carry_out`` the tail of the last
    rank's last hop, the same on every rank: the next call's carry.
    Requires hop >= sigOverlap, as JAX does."""
    N, ov = spec.Nfft, spec.sigOverlap
    hop = N - ov
    if hop < ov:
        raise ValueError(f"hop ({hop}) must be >= sigOverlap ({ov})")
    n = mesh.size(axis)
    first = mesh.coord(axis) == 0
    dev = mesh.device
    batch = build_process_batch(spec, device=dev)

    def stream(new_samples, carry_tail):
        new = torch.as_tensor(new_samples).to(dev, torch.complex64)
        carry = torch.as_tensor(carry_tail).to(dev, torch.complex64)
        if new.dim() != 2 or new.shape[1] != hop or tuple(carry.shape) != (ov,):
            raise ValueError(f"expected (T, {hop}) hops and a ({ov},) carry, got "
                             f"{tuple(new.shape)} and {tuple(carry.shape)}")
        mine = new[-1, hop - ov:]
        left = ppermute(mine, mesh, axis, [(i, (i + 1) % n) for i in range(n)])
        head = carry if first else left
        tails = torch.cat([head[None], new[:-1, hop - ov:]])  # (Tl, ov) block heads
        res = batch(torch.cat([tails, new], dim=1))
        res.pop("E")
        return res, all_gather(mine, mesh, axis, tiled=False)[-1].clone()

    return stream
