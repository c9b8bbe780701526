"""The channel-parallel demodulation step on one card.

The port of ``pycusdr_tpu/parallel/sharded_demod.py``'s pure channel
parallelism (``_build_channel_parallel_step``, ``:107-163``): the block
graph runs once over all C channel blocks (the output of the wideband
channelizer, or C lockstep antennas) and, with ``vote``, the diversity
vote (K8) combines them. The block graph's kernels write the C packed
rows into one vector and K8 writes the voted pair into its tail, as
``runtime/channel_group_process.build_group_graph`` does.

The generic channel x dopp program (``:224-491``: the Doppler grid and
the mask bank sharded over the ``dopp`` axis) and any mesh of more than
one device are ROADMAP Queue 1 item 16 and raise ``NotImplementedError``.
"""

import torch

from pycusdr_tpu_torch.dsp.block import build_process_batch, packed_len, unpack_rows
from pycusdr_tpu_torch.dsp.spec import DemodSpec
from pycusdr_tpu_torch.parallel.mesh import MULTI_DEVICE, Mesh
from pycusdr_tpu_torch.parallel.vote import vote_rows, vote_rows_plain

#: the per-channel outputs of the step (``sharded_demod.py:118-120``)
KEYS = ("bits", "trust", "symbols", "centres", "mags", "nSym", "nBits", "spSym",
        "doppler_hz", "freq_offset_hz", "quality_db", "snr_db", "shift")


def build_sharded_demod_step(spec: DemodSpec, mesh: Mesh, vote: bool = True,
                             master_idx: int = 0, master_weight: float = 1.2,
                             force_generic: bool = False, plain: bool = False):
    """Return ``step(blocks) -> dict`` for (C, Nfft) complex64 channel
    blocks on ``mesh.device``: the ``KEYS`` outputs, each with a leading
    C axis (trust as the block graph gives it), and with ``vote``
    ``bits_voted`` (int8) and ``trust_voted`` (f32), (S,) each.

    ``plain``: every kernel's plain version (the reference the kernels
    are held against). ``force_generic`` and a ``dopp`` axis of size > 1
    raise ``NotImplementedError`` (ROADMAP Queue 1 item 16)."""
    if force_generic or mesh.shape.get("dopp", 1) > 1:
        raise NotImplementedError(
            "the generic channel x dopp program (Doppler grid and mask bank sharded "
            f"over the dopp axis) is not ported: {MULTI_DEVICE}")
    if "channel" not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no 'channel' axis")
    dev = mesh.device
    batch = build_process_batch(spec, device=dev, packed=True, plain=plain)
    L, S = packed_len(spec), spec.numSymMax
    vote_fn = vote_rows_plain if plain else vote_rows

    def step(blocks):
        x = torch.as_tensor(blocks)
        if x.dim() != 2:
            raise ValueError(f"expected (C, {spec.Nfft}) blocks, got {tuple(x.shape)}")
        C = x.shape[0]
        vec = torch.empty(C * L + (2 * S if vote else 0), dtype=torch.float32, device=dev)
        rows = vec[:C * L].view(C, L)
        batch(x, row=rows)
        # the casts copy trust before K8 masks the pad slots in the rows
        res = unpack_rows(rows, spec)
        out = {k: res[k] for k in KEYS}
        if vote:
            pair = vote_fn(rows, S, master_weight, vec[C * L:].view(2, S), master_idx)
            out["bits_voted"] = pair[0].to(torch.int8)
            out["trust_voted"] = pair[1]
        return out

    return step
