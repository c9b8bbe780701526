"""Many processes, on one host or several: the port of
``pycusdr_tpu/parallel/multihost.py`` on ``torch.distributed``.

Each process is one rank with one device. ``init_distributed`` starts
the world (a no-op for a single process); ``make_global_mesh`` lays the
(channel, dopp) mesh over all ranks channel-major, so the ranks of one
station's channels sit next to each other; ``local_channel_slice`` says
which global channel rows this process feeds. Nothing here tells a
program of a cluster: the address, the world size and the rank come
from the arguments or from ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK``.
"""

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from pycusdr_tpu_torch.parallel.mesh import Mesh, make_mesh

log = logging.getLogger(__name__)

#: the bound on every rendezvous and collective of the world, s
TIMEOUT_S = 60.0


def init_distributed(coordinator_address: str = None, num_processes: int = None,
                     process_id: int = None, backend: str = None,
                     timeout_s: float = TIMEOUT_S) -> bool:
    """Start ``torch.distributed`` from the arguments (``coordinator_address``
    "host:port", ``num_processes``, ``process_id``) or, when
    ``num_processes`` is None, from ``MASTER_ADDR``/``MASTER_PORT``/
    ``WORLD_SIZE``/``RANK``. One process (or no ``WORLD_SIZE``) is a no-op
    that returns False. ``backend``: None means NCCL when a card is
    present, else gloo; several ranks on one card need "gloo"."""
    if num_processes is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            log.info("single-process run: torch.distributed not initialised")
            return False
        init = "env://"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if num_processes <= 1:
            log.info("single-process run: torch.distributed not initialised")
            return False
        if coordinator_address is None or process_id is None:
            raise ValueError("init_distributed: a coordinator address and a process id are "
                             "needed with num_processes > 1")
        init = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))
    log.info("torch.distributed up (%s): rank %d of %d", backend, dist.get_rank(),
             dist.get_world_size())
    return True


def make_global_mesh(dopp: int = 1, devices=None) -> Mesh:
    """A (channel, dopp) mesh over every rank of the world, channel-major:
    rank r is channel shard r // dopp and dopp shard r % dopp.
    ``devices`` as ``make_mesh``'s."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n % dopp:
        raise ValueError(f"{n} ranks do not factor into dopp={dopp}")
    return make_mesh({"channel": n // dopp, "dopp": dopp}, devices)


def local_channel_slice(mesh: Mesh, n_channels_global: int) -> slice:
    """The global channel rows this process feeds: its channel shard's."""
    nc = mesh.size("channel")
    if n_channels_global % nc:
        raise ValueError(f"{n_channels_global} channels do not divide over {nc} channel shards")
    per = n_channels_global // nc
    lo = mesh.coord("channel") * per
    return slice(lo, lo + per)
