"""Across-channel and across-device work: the wideband channelizer (K9),
the demodulation step sharded over channels and over the mask bank
(the generic channel x dopp step with K4l and K4s), the streaming of
many hops in one call sharded over time, the diversity vote (K8), and
the meshes, collectives and multi-process start-up they run on.

The JAX package expresses these as axes of one ``jax.sharding.Mesh``
(``channel``, ``dopp``, ``time``); the port lays a mesh over the ranks of
a ``torch.distributed`` world, one device each (``parallel/mesh.py``),
or over one device.
"""

from pycusdr_tpu_torch.parallel.mesh import Mesh, choose_mesh, make_mesh  # noqa: F401
from pycusdr_tpu_torch.parallel.collectives import all_gather, all_reduce, ppermute  # noqa: F401
from pycusdr_tpu_torch.parallel.sharded_demod import build_sharded_demod_step  # noqa: F401
from pycusdr_tpu_torch.parallel.halo import build_time_sharded_stream  # noqa: F401
from pycusdr_tpu_torch.parallel.multihost import (  # noqa: F401
    init_distributed,
    local_channel_slice,
    make_global_mesh,
)
from pycusdr_tpu_torch.parallel.vote import vote_n_device_plain as vote_n_device  # noqa: F401
from pycusdr_tpu_torch.parallel.channelizer import Channelizer, channelize_numpy  # noqa: F401
