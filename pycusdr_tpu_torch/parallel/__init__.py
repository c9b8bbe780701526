"""Across-channel device work on one card: the wideband channelizer
(K9), the channel-parallel demodulation step, the streaming of many hops
in one call, and the diversity vote (K8).

The JAX package expresses these as axes of one ``jax.sharding.Mesh``
(``channel``, ``dopp``, ``time``); the port runs them on one card, and a
mesh of more than one device raises ``NotImplementedError`` (ROADMAP
Queue 1 item 16).
"""

from pycusdr_tpu_torch.parallel.mesh import choose_mesh, make_mesh  # noqa: F401
from pycusdr_tpu_torch.parallel.sharded_demod import build_sharded_demod_step  # noqa: F401
from pycusdr_tpu_torch.parallel.halo import build_time_sharded_stream  # noqa: F401
from pycusdr_tpu_torch.parallel.vote import vote_n_device_plain as vote_n_device  # noqa: F401
from pycusdr_tpu_torch.parallel.channelizer import Channelizer, channelize_numpy  # noqa: F401
