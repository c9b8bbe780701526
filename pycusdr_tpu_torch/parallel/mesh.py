"""Device meshes over torch devices, as ``pycusdr_tpu/parallel/mesh.py``
builds them over JAX devices.

One card is supported: every axis of the mesh has size 1, and the
sharded steps (``sharded_demod.py``, ``halo.py``) run their whole work on
that device. A layout that needs more than one device raises
``NotImplementedError``: the multi-device forms on ``torch.distributed``
are ROADMAP Queue 1 item 16. Such a layout is refused, never run on one
device in its place.
"""

from dataclasses import dataclass

import numpy as np
import torch

from pycusdr_tpu_torch.ops import _lib

MULTI_DEVICE = ("a mesh of more than one device (the multi-device forms on "
                "torch.distributed, ROADMAP Queue 1 item 16) is not ported")


@dataclass(frozen=True)
class Mesh:
    """``shape``: {axis name: size}, as ``jax.sharding.Mesh.shape``;
    ``devices``: the torch devices in mesh order (one)."""

    shape: dict
    devices: tuple

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """Build a mesh with the given ``{axis_name: size}`` layout. ``devices``:
    None means the card (raises without one); pass ``["cpu"]`` to run on
    the CPU."""
    n = int(np.prod(tuple(axis_sizes.values()), dtype=np.int64))
    if n > 1:
        raise NotImplementedError(f"mesh {axis_sizes}: {MULTI_DEVICE}")
    devs = [None] if devices is None else list(devices)
    if n > len(devs):
        raise ValueError(f"mesh {axis_sizes} needs {n} devices, have {len(devs)}")
    return Mesh(dict(axis_sizes), (_lib.resolve_device(devs[0]),))


def choose_mesh(n_devices: int, devices=None) -> Mesh:
    """Default 2-D (channel, dopp) factorisation of ``n_devices``, as JAX's
    ``choose_mesh``; only ``n_devices = 1`` is supported."""
    nd = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    nc = n_devices // nd
    return make_mesh({"channel": nc, "dopp": nd}, devices)
