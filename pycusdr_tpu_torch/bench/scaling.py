"""Rank scaling of the sharded demodulation step: the port of
``pycusdr_tpu/bench/scaling.py``.

``sharded_per_chip_msps`` times ``parallel.build_sharded_demod_step`` on the
one-card mesh at C channels: the channel-parallel step (the block graph and
the vote, K8) or, with ``force_generic``, the generic channel x dopp program
(K4l, K4s and K8 in place of K4), as Msamples/s of new samples.

``run_scaling`` times the step with and without the vote on worlds of n
ranks of ``torch.distributed`` (one process a rank, spawned; a world of one
runs in this process), each rank feeding ``channels_per_device`` channels,
and reports ``{devices, Msamples_per_s, efficiency, vote_overhead_pct}`` a
world, the voted and unvoted steps timed in turns. The ranks take the cards
in turn; where they outnumber the cards they share them over gloo (NCCL
refuses two ranks on one card), and then ``efficiency`` measures the
ranks' contention for the card and the host, not scaling: the row says so,
as JAX's docstring says of its virtual CPU mesh. Scaling over cards needs a
machine with as many cards as ranks.

Times come from ``profile_stages.cuda_ms`` (CUDA events on the card, each
rank its own stream). Every JSON carries the card's name and power limit.

Run: python -m pycusdr_tpu_torch.bench.scaling [--devices 1 2 4 8] or
[--per-chip --channels 16 [--generic] [--mask-size 3]] (on the card;
``--cpu`` runs the plain versions on the CPU, at ``configs.tiny_spec``
for the rank sweep).
"""

import argparse
import json
import math
import multiprocessing
import queue
import time

import numpy as np
import torch

from pycusdr_tpu_torch import ops
from pycusdr_tpu_torch.bench.profile_stages import cuda_ms
from pycusdr_tpu_torch.ops._lib import resolve_device
from pycusdr_tpu_torch.utils.device_info import card_line

#: the first port of the rank sweep's rendezvous (one a world), below the
#: kernel's ephemeral range (32768-60999)
SCALING_PORT = 12800
#: the bound on a world's start, timings and exit, s
WORLD_WAIT_S = 300.0
#: rounds of (voted, unvoted) timings a world
ROUNDS = 8


def _blocks(spec, n_channels, seed=0):
    """(C, Nfft) complex64 seeded noise blocks on the host."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n_channels, spec.Nfft) + 1j * rng.randn(n_channels, spec.Nfft)
            ).astype(np.complex64)


def sharded_per_chip_msps(spec=None, n_channels=16, T=40, repeats=7, force_generic=False,
                          mask_size=None, device=None):
    """Msamples/s of new samples of the sharded step on a one-device mesh
    at ``n_channels`` channels (the vote on), ``T`` calls a timing.
    ``force_generic``: the generic channel x dopp program that an nd > 1
    mesh runs, instead of the channel-parallel step. ``spec`` None is
    ``configs.flagship_spec(mask_size)`` (xcorrMaskSize, 3 when None)."""
    from pycusdr_tpu_torch.configs import flagship_spec
    from pycusdr_tpu_torch.parallel import build_sharded_demod_step, make_mesh

    dev = resolve_device(device)
    if spec is None:
        spec = flagship_spec() if mask_size is None else flagship_spec(mask_size)
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=[dev])
    step = build_sharded_demod_step(spec, mesh, force_generic=force_generic)
    x = torch.from_numpy(_blocks(spec, n_channels)).to(dev)
    ms = cuda_ms(lambda: step(x), T, repeats, dev)
    return n_channels * (spec.Nfft - spec.sigOverlap) / (ms * 1e-3) / 1e6


def measure_step(spec, mesh, n_channels, T=10, vote=True):
    """(samples, once) for the step on ``mesh`` over ``n_channels`` global
    channels: ``once()`` gives the seconds of T calls on this rank's rows
    (CUDA events on the card); ``samples`` the new samples they carry."""
    from pycusdr_tpu_torch.parallel import build_sharded_demod_step, local_channel_slice

    step = build_sharded_demod_step(spec, mesh, vote=vote)
    blocks = _blocks(spec, n_channels)[local_channel_slice(mesh, n_channels)]
    x = torch.from_numpy(blocks).to(mesh.device)

    def once():
        return T * cuda_ms(lambda: step(x), T, 1, mesh.device) / 1e3

    return n_channels * (spec.Nfft - spec.sigOverlap) * T, once


def _world(spec, mesh, channels_per_device):
    """(best seconds voted, unvoted, samples) on this rank: the two steps in
    turns, ROUNDS rounds, so host drift meets both alike."""
    nc = mesh.size("channel") * channels_per_device
    smp, once_v = measure_step(spec, mesh, nc)
    _, once_n = measure_step(spec, mesh, nc, vote=False)
    tv = tn = math.inf
    for _ in range(ROUNDS):
        tv = min(tv, once_v())
        tn = min(tn, once_n())
    return tv, tn, smp


def _rank(rank, n, port, spec, channels_per_device, devices, backend, results):
    """One rank of a world of ``n``: the timings on ``choose_mesh(n)``; puts
    (rank, (tv, tn, samples), launches) on ``results``."""
    import torch.distributed as dist

    from pycusdr_tpu_torch.parallel import choose_mesh, init_distributed

    init_distributed(f"127.0.0.1:{port}", n, rank, backend=backend)
    out = _world(spec, choose_mesh(n, devices), channels_per_device)
    results.put((rank, out, ops.launch_counts()))
    dist.barrier()
    dist.destroy_process_group()


def _spawn_world(n, port, spec, channels_per_device, dev):
    """A world of n spawned ranks on ``dev``'s type: rank 0's timings and
    the launches of every rank. The ranks take the cards in turn and share
    them over gloo where they outnumber them."""
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    devices = [f"cuda:{r % cards}" for r in range(n)] if cards else ["cpu"] * n
    backend = "gloo" if n > cards else None
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, n, port, spec, channels_per_device, devices,
                                             backend, results)) for r in range(n)]
    got, launches = {}, {}
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        while len(got) < n:
            if time.perf_counter() - t0 > WORLD_WAIT_S:
                raise RuntimeError(f"{n - len(got)} of {n} ranks did not report in "
                                   f"{WORLD_WAIT_S} s")
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"ranks exited with {failed}")
            try:
                rank, out, counts = results.get(timeout=1.0)
            except queue.Empty:
                continue
            got[rank] = out
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return got[0], launches, cards


def run_scaling(device_counts=(1, 2, 4, 8), spec=None, channels_per_device=1, device=None,
                port=SCALING_PORT, launches=None):
    """A row a world size n of ``device_counts``: Msamples/s of the voted
    step over all channels (rank 0's time), its ``efficiency`` a rank
    against the first world's, and the vote's share of the time. ``spec``
    None: ``configs.tiny_spec()`` on the CPU, ``flagship_spec()`` on the
    card (as JAX picks by its backend). ``launches``: a dict the spawned
    ranks' kernel launches are added to (a world of one runs in this
    process, whose wrappers count its launches)."""
    from pycusdr_tpu_torch.configs import flagship_spec, tiny_spec
    from pycusdr_tpu_torch.parallel import make_mesh

    dev = resolve_device(device)
    if spec is None:
        spec = tiny_spec() if dev.type == "cpu" else flagship_spec()
    card = card_line(dev)
    rows, base = [], None
    for i, n in enumerate(device_counts):
        if n == 1:
            mesh = make_mesh({"channel": 1, "dopp": 1}, devices=[dev])
            (tv, tn, smp), cards = _world(spec, mesh, channels_per_device), 1
        else:
            (tv, tn, smp), counts, cards = _spawn_world(n, port + i, spec, channels_per_device,
                                                        dev)
            if launches is not None:
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
        sps, sps_novote = smp / tv, smp / tn
        if base is None:
            base = sps / n  # the first world is the baseline
        row = {"devices": n, "Msamples_per_s": sps / 1e6, "efficiency": (sps / n) / base,
               "vote_overhead_pct": max(0.0, 1.0 - sps / sps_novote) * 100,
               "channels": n * channels_per_device, "device": str(dev), "card": card}
        if n > max(cards, 1):
            row["efficiency_measures"] = (f"contention of {n} ranks sharing "
                                          f"{max(cards, 1)} device(s), not scaling")
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="rank scaling of the sharded demodulation step")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="world sizes of the rank sweep")
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    ap.add_argument("--per-chip", action="store_true",
                    help="the sharded step's Msamples/s on a one-card mesh (flagship spec) "
                         "instead of the rank sweep")
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--generic", action="store_true",
                    help="with --per-chip: the generic channel x dopp program (what an nd>1 "
                         "mesh runs) instead of the channel-parallel step")
    ap.add_argument("--mask-size", type=int, default=None,
                    help="with --per-chip: xcorrMaskSize (bank depth M = 2^maskSize)")
    args = ap.parse_args(argv)
    dev = "cpu" if args.cpu else None
    if args.per_chip:
        msps = sharded_per_chip_msps(n_channels=args.channels, force_generic=args.generic,
                                     mask_size=args.mask_size, device=dev)
        d = resolve_device(dev)
        print(json.dumps({"metric": "sharded_program_per_chip", "n_channels": args.channels,
                          "program": "generic" if args.generic else "auto",
                          "mask_size": 3 if args.mask_size is None else args.mask_size,
                          "Msamples_per_s": msps, "device": str(d),
                          "card": card_line(d)}))
        return
    for row in run_scaling(tuple(args.devices), device=dev):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
