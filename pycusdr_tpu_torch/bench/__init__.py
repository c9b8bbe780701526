"""The harnesses, run against the port's modem on the card.

The station harnesses:

- ``hw_selfcheck``: the on-card exactness gate of the block graph;
- ``ber``: the BER-vs-Eb/N0 acceptance sweep through ``PyCuSDR``;
- ``ber_delta``: the block graph against the numpy golden on identical
  noisy packets;
- ``diversity``: one channel against three voted by the softCombiner;
- ``streaming_rt``: the CC11xx station fed in real time by the software
  front end (``frontend/sim_frontend.py``).

The timing harnesses:

- ``profile_stages``: the card's timers (``cuda_ms``, ``device_ms``,
  ``profile_calls``), the work model (``kernel_work``, ``bounds``) and the
  measured roofs, which ``chip_smoke.py`` imports; the block graph's device
  time by stage against its bound, alone or in one trace of the graph;
- ``subsystems``: the channelizer's tone purity and rate, the tracker over
  an S-curve pass;
- ``capture_probe``: whole-capture reprocessing, batched against block by
  block;
- ``scaling``: the sharded step on the one-card mesh, and worlds of n
  ``torch.distributed`` ranks;
- ``hw_leak_probe``: host memory kept a host-to-device transfer.

Each runs as ``python -m pycusdr_tpu_torch.bench.<name>`` on the card
(``--cpu`` asks for the plain PyTorch path on the CPU; without a card and
without ``--cpu`` it raises). ``chip_smoke.py`` drives the station harnesses
in phase 4q and the timing harnesses in phase 4r.
"""

from pycusdr_tpu_torch.bench.ber import run_ber_sweep  # noqa: F401
