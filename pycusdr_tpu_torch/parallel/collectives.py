"""Collectives along one axis of a ``Mesh``, on that axis's
``torch.distributed`` process subgroup: the counterparts of
``jax.lax.all_gather``, ``psum`` and ``ppermute`` inside JAX's
``shard_map`` programs (``pycusdr_tpu/parallel/sharded_demod.py``,
``halo.py``).

On an axis of size 1 each one is the identity and needs no process
group. The backend is the group's: NCCL for cards, gloo for CPU
tensors. Gloo takes no CUDA tensor in these calls, so on a gloo group a
CUDA tensor is copied to the host, exchanged there and copied back: that
happens because of the group's backend alone (several ranks on one card,
which NCCL refuses), never because a call failed. The kernels around the
collectives still run on the card.
"""

import torch
import torch.distributed as dist

from pycusdr_tpu_torch.parallel.mesh import Mesh


def _via_host(x: torch.Tensor, group) -> bool:
    """True when ``x`` lies on a card and ``group`` runs on gloo."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every shard's ``x`` along ``axis``, in axis order: concatenated
    along ``dim`` (``tiled``) or stacked on a new axis ``dim``."""
    n = mesh.size(axis)
    if n == 1:
        return x if tiled else x.unsqueeze(dim)
    g = mesh.groups[axis]
    host = _via_host(x, g)
    src = (x.cpu() if host else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=g)
    out = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
    return out.to(x.device) if host else out


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of every shard's ``x`` along ``axis`` (a new tensor)."""
    if mesh.size(axis) == 1:
        return x
    g = mesh.groups[axis]
    host = _via_host(x, g)
    out = x.cpu().contiguous() if host else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
    return out.to(x.device) if host else out


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: for each (src, dst) pair of axis coordinates in
    ``perm``, shard dst receives shard src's ``x``; a shard that receives
    nothing gets zeros. Point-to-point ``isend``/``irecv`` on the axis's
    group."""
    if mesh.size(axis) == 1:
        return x
    g = mesh.groups[axis]
    me = mesh.coord(axis)
    host = _via_host(x, g)
    src = (x.cpu() if host else x).contiguous()
    out = torch.zeros_like(src)
    reqs = []
    for s, d in perm:
        if s == me:
            reqs.append(dist.isend(src, dist.get_global_rank(g, d), group=g))
        if d == me:
            reqs.append(dist.irecv(out, dist.get_global_rank(g, s), group=g))
    for r in reqs:
        r.wait()
    return out.to(x.device) if host else out
