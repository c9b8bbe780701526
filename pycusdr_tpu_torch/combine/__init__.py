"""Diversity combining ("trust processor"): the port's copy of
``pycusdr_tpu/combine/`` (host numpy and ZMQ; no device, no JAX).

Multi-channel / multi-ground-station soft-bit combining with the same
capabilities as the reference softCombiner (``pyCuSDR/softCombiner.py``):
arbitrarily delayed bit streams from demodulators are buffered per
worker, aligned by FFT cross-correlation, and merged by trust-weighted
majority vote before decoding. No precise timing is required, so the
channels can come from dispersed, unsynchronised ground sites.

Host path: ``SoftCombiner`` (a multiprocessing.Process speaking ZMQ)
with ``Worker`` bookkeeping and the numpy vote kernels in ``votes``.
Device path: time-aligned mesh-sharded channels vote on-chip instead —
see ``pycusdr_tpu_torch.parallel.vote`` (K8).
"""

from pycusdr_tpu_torch.combine.worker import Slave, Worker, WorkerIdError  # noqa: F401
from pycusdr_tpu_torch.combine.votes import do_vote2, do_voteN  # noqa: F401
from pycusdr_tpu_torch.combine.aligner import xcorr_peak  # noqa: F401
from pycusdr_tpu_torch.combine.combiner import SoftCombiner  # noqa: F401
