"""On-device diversity vote across time-aligned channels (kernel K8).

The port of ``pycusdr_tpu/parallel/vote.py``: bits whose trust is
negative are disqualified, each remaining channel votes with weight
``trust`` (the master channel, ``master_idx``, scaled by ``masterVoteWeight``),
and the combined trust is ``votersAgreed + quorum/10``, or -1 when no
voter qualifies (reference ``softCombiner.py:570-618``).

``vote_n_device_plain`` is the plain PyTorch version on (C, S) bits and
trust. ``vote_rows`` is K8's wrapper: it votes straight from the C
channels' packed result rows (``ops/layout.py``), marking each channel's
slots at or beyond its nBits with trust -1 first, as the channel group's
graph does (``pycusdr_tpu/runtime/channel_group_process.py:308-314``);
``mask_pad=False`` skips that mask, for the generic channel x dopp step
(``pycusdr_tpu/parallel/sharded_demod.py:429-434``).
"""

import torch

from pycusdr_tpu_torch.ops import _lib
from pycusdr_tpu_torch.ops.layout import PACK_ARRAYS, PACK_SCALARS, SCALAR


def vote_n_device_plain(bits: torch.Tensor, trust: torch.Tensor, master_idx: int = 0,
                        master_weight: float = 1.2):
    """Weighted majority vote over axis 0. bits: (C, S) int8 {0, 1};
    trust: (C, S) int8 (negative = distrust). Returns (voted int8 (S,),
    combined trust f32 (S,)). The weighted sum runs in channel order from
    0 in f32, as JAX's reduce over axis 0 does: ties (a master trust of 5
    weighs 5 * 1.2f = 6.0 exactly) decide the vote."""
    valid = trust >= 0
    w = torch.where(valid, trust.float(), 0.0)
    w[master_idx] = w[master_idx] * torch.tensor(master_weight, dtype=torch.float32)
    nrz = bits.float() * 2.0 - 1.0
    score = torch.zeros(bits.shape[1], dtype=torch.float32, device=bits.device)
    for c in range(bits.shape[0]):
        score = score + w[c] * nrz[c]
    voted = (score > 0).to(torch.int8)
    agree = (valid & (bits == voted[None, :])).sum(dim=0)
    quorum = valid.sum(dim=0)
    # a tensor divisor: PyTorch's CUDA kernel multiplies by the reciprocal
    # of a scalar one, which rounds differently from JAX's and K8's x / 10
    q = quorum.float()
    combined = agree.float() + q / torch.full_like(q, 10.0)
    return voted, torch.where(quorum == 0, -1.0, combined)


def _master(master_idx: int, C: int) -> int:
    """``master_idx`` in [0, C), a negative one counted from the end."""
    if not -C <= master_idx < C:
        raise ValueError(f"master_idx {master_idx} out of range for {C} channels")
    return master_idx % C


def vote_rows_plain(rows: torch.Tensor, numSymMax: int, master_weight: float,
                    out: torch.Tensor, master_idx: int = 0, mask_pad: bool = True) -> torch.Tensor:
    """The plain version of ``vote_rows``: with ``mask_pad``, trust -1 in
    place at each row's slots s >= nBits; then ``vote_n_device_plain`` on
    the rows' bits and trust, into ``out``."""
    S = numSymMax
    trust = rows[:, S:2 * S]
    if mask_pad:
        nbits = rows[:, len(PACK_ARRAYS) * S + SCALAR["nBits"]]
        slot = torch.arange(S, device=rows.device, dtype=torch.float32)
        trust.copy_(torch.where(slot[None, :] < nbits[:, None], trust, -1.0))
    voted, combined = vote_n_device_plain(rows[:, :S].to(torch.int8), trust.to(torch.int8),
                                          _master(master_idx, rows.shape[0]), master_weight)
    out[0] = voted.float()
    out[1] = combined
    return out


def vote_rows(rows: torch.Tensor, numSymMax: int, master_weight: float,
              out: torch.Tensor = None, master_idx: int = 0,
              mask_pad: bool = True) -> torch.Tensor:
    """K8: vote the (C, L) f32 packed rows of C lockstep channels (channel
    ``master_idx`` the master). With ``mask_pad`` their pad slots' trust
    becomes -1 in place (as in ``vote_rows_plain``); without it the trust
    votes as the rows hold it (the generic step's, masked at nSym by K4s).
    The voted bits and the combined trust go to ``out`` (2, S) f32
    (allocated when None), which is returned."""
    S = numSymMax
    C = rows.shape[0]
    if rows.dim() != 2 or rows.shape[1] < len(PACK_ARRAYS) * S + len(PACK_SCALARS):
        raise ValueError(f"vote_rows: rows shape {tuple(rows.shape)} too small for S={S}")
    master_idx = _master(master_idx, C)
    if out is None:
        out = torch.empty((2, S), dtype=torch.float32, device=rows.device)
    if rows.device.type == "cpu":
        return vote_rows_plain(rows, S, master_weight, out, master_idx, mask_pad)
    if rows.device.type != "cuda":
        raise ValueError(f"vote_rows: unsupported device {rows.device}")
    _lib.check(rows, "rows", torch.float32)
    _lib.check(out, "out", torch.float32, (2, S), rows.device)
    _lib.launch("pycusdr_vote", _lib.ptr(rows), _lib.ptr(out), C, rows.shape[1], S,
                master_idx, float(master_weight), int(mask_pad))
    vote_rows.launches += 1
    return out


vote_rows.launches = 0
