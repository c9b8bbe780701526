"""The station harnesses, run against the port's modem on the card:

- ``hw_selfcheck``: the on-card exactness gate of the block graph;
- ``ber``: the BER-vs-Eb/N0 acceptance sweep through ``PyCuSDR``;
- ``ber_delta``: the block graph against the numpy golden on identical
  noisy packets;
- ``diversity``: one channel against three voted by the softCombiner;
- ``streaming_rt``: the CC11xx station fed in real time by the software
  front end (``frontend/sim_frontend.py``).

Each runs as ``python -m pycusdr_tpu_torch.bench.<name>`` (``--cpu`` asks
for the plain PyTorch path on the CPU).
"""

from pycusdr_tpu_torch.bench.ber import run_ber_sweep  # noqa: F401
