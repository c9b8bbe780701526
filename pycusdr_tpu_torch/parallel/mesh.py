"""Device meshes over the ranks of ``torch.distributed``, as
``pycusdr_tpu/parallel/mesh.py`` builds them over JAX devices.

A mesh of n > 1 devices is n processes (ranks) of one
``torch.distributed`` world, one device each. Rank r sits at the
row-major coordinate of r in the mesh shape (JAX reshapes its device
list the same way). Every axis of size > 1 gets the process subgroups of
the ranks that share all other coordinates; ``collectives.py`` runs the
all-gathers, sums and permutations of the sharded steps on them. A mesh
of one device needs no process group at all.

``make_mesh`` raises ``ValueError`` when the world's size is not the
mesh's: a multi-device layout is never run on one device in its place.
``parallel/multihost.py`` starts the world.
"""

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from pycusdr_tpu_torch.ops import _lib


@dataclass(frozen=True)
class Mesh:
    """``shape``: {axis name: size}, as ``jax.sharding.Mesh.shape``;
    ``devices``: this rank's torch device (one); ``coords``: this rank's
    coordinate on each axis; ``groups``: the process subgroup of each axis
    of size > 1; ``rank``: this process's rank in the world (0 alone)."""

    shape: dict
    devices: tuple
    coords: dict = field(default_factory=dict)
    groups: dict = field(default_factory=dict)
    rank: int = 0

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def size(self, axis: str) -> int:
        """The axis's size, 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's coordinate on the axis, 0 for one it does not have."""
        return self.coords.get(axis, 0)


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """Build a mesh with the given ``{axis_name: size}`` layout for this
    process. One device: ``devices`` None means the card (raises without
    one); pass ``["cpu"]`` to run on the CPU. n > 1 devices: the
    ``torch.distributed`` world must have n ranks (else ``ValueError``);
    ``devices`` lists the n devices in rank order (None: ``cuda:r`` modulo
    the cards present), and this rank takes its own. Every rank must call
    ``make_mesh`` with the same layout: the subgroups are made
    collectively."""
    names = tuple(axis_sizes)
    sizes = tuple(int(v) for v in axis_sizes.values())
    n = int(np.prod(sizes, dtype=np.int64))
    if n == 1:
        devs = [None] if devices is None else list(devices)
        return Mesh(dict(axis_sizes), (_lib.resolve_device(devs[0]),), dict.fromkeys(names, 0))
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"mesh {axis_sizes} needs {n} ranks of torch.distributed, and no "
                         "process group is initialised (parallel.multihost.init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"mesh {axis_sizes} needs {n} ranks, the world has {world}")
    if devices is None:
        dev = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
    else:
        devs = list(devices)
        if len(devs) < n:
            raise ValueError(f"mesh {axis_sizes} needs {n} devices, have {len(devs)}")
        dev = devs[rank]
    grid = np.arange(n).reshape(sizes)
    coords = {a: int(c) for a, c in zip(names, np.unravel_index(rank, sizes))}
    groups = {}
    for i, a in enumerate(names):
        if sizes[i] == 1:
            continue
        # every rank makes every line's group, in the same order
        for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[a] = g
    return Mesh(dict(axis_sizes), (_lib.resolve_device(dev),), coords, groups, rank)


def choose_mesh(n_devices: int, devices=None) -> Mesh:
    """Default 2-D (channel, dopp) factorisation of ``n_devices``, as JAX's
    ``choose_mesh``: channels get the larger factor, dopp 2 from 4 devices."""
    nd = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    nc = n_devices // nd
    return make_mesh({"channel": nc, "dopp": nd}, devices)
