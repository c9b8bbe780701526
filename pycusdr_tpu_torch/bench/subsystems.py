"""The device subsystems beside the block graph, checked and timed on the
card: the port of ``pycusdr_tpu/bench/subsystems.py``.

- the polyphase channelizer (``parallel/channelizer.py``, K9): a tone at
  channel c's centre must keep more than 0.9 of its energy in channel c
  (JAX's check, ``subsystems.py:44-58``), then its time a hop and the
  wideband Msamples/s at batches of B hops in one call;
- the LEO search-and-track loop (``models/tracking.py``: K1-K5 with the
  runtime recentre) over a simulated pass whose Doppler follows an S-curve:
  the first lock, the lock fraction after it and the median error in bins,
  and the acquire and track graphs' ms a block at B=1.

Times come from ``bench.profile_stages.cuda_ms`` (CUDA events on the card).
Every JSON carries the card's name and power limit.

Run: python -m pycusdr_tpu_torch.bench.subsystems [--blocks 48] [--out f.json]
(on the card; ``--cpu`` runs the plain versions on the CPU, ``--spec tiny``
the CPU tests' size).
"""

import argparse
import json

import numpy as np
import torch

from pycusdr_tpu_torch.bench.profile_stages import REPS, cuda_ms, device_ms
from pycusdr_tpu_torch.dsp.signal_gen import awgn, modulate_fsk
from pycusdr_tpu_torch.ops._lib import resolve_device
from pycusdr_tpu_torch.utils.device_info import card_line


def channelizer_bench(M: int = 64, taps_per_branch: int = 8, n_samples: int = 65536,
                      batches=(1, 4), T: int = 30, device=None):
    """Check the M-channel PFB with a tone at channel ``min(5, M - 1)``'s
    centre (purity > 0.9), then time it on B hops of ``n_samples`` in one
    call for each B of ``batches`` (``T`` calls a timing): us a hop, the
    wideband Msamples/s, and K9's device us a hop on the card."""
    from pycusdr_tpu_torch.parallel.channelizer import Channelizer, k9_plan

    dev = resolve_device(device)
    ch = Channelizer(M, taps_per_branch, device=dev)
    c = min(5, M - 1)
    tone = np.exp(2j * np.pi * (c / M) * np.arange(n_samples)).astype(np.complex64)
    y = ch(tone)[0].cpu().numpy()
    assert np.isfinite(y).all(), "channelizer output not finite"
    energy = (np.abs(y) ** 2).sum(axis=1)
    purity = float(energy[c] / energy.sum())
    assert purity > 0.9, f"tone leaked across channels (purity {purity:.3f})"

    form = k9_plan(M, taps_per_branch)["form"]
    kernel = {"wide": "channelize_wide", "split": "channelize_split"}.get(form, "channelize")
    rng = np.random.RandomState(0)
    rows = {}
    for B in batches:
        n = B * n_samples
        x = torch.from_numpy((rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)).to(dev)
        ms = cuda_ms(lambda: ch(x), T, REPS, dev)
        rows[f"B{B}"] = {
            "us_per_call": 1e3 * ms / B,
            "wideband_msps": n / (ms * 1e-3) / 1e6,
            "device_us_per_call": (1e3 * device_ms(lambda: ch(x), kernel, T) / B
                                   if dev.type == "cuda" else None),
        }
    return {"M": M, "taps_per_branch": taps_per_branch, "n_samples": n_samples,
            "tone_purity": purity, "form": form,
            "throughput": rows, "device": str(dev), "card": card_line(dev)}


def s_curve_blocks(spec, n_blocks, f_max, t_mid, tau, snr_db, seed=3):
    """FSK blocks under an S-curve Doppler pass with AWGN at ``snr_db``
    (``pycusdr_tpu/bench/subsystems.py:73-89``); returns (blocks complex64,
    truth Hz)."""
    N, fs, sps = spec.Nfft, spec.sampleRate, int(spec.spsym)
    rng = np.random.RandomState(seed)
    base = modulate_fsk(rng.randint(0, 2, (N * n_blocks) // sps + 8), sps)[:N * n_blocks]
    t_blk = np.arange(N * n_blocks) / N
    f_inst = spec.centreFreqOffset - f_max * np.tanh((t_blk - t_mid) / tau)
    sig = base * np.exp(1j * 2 * np.pi * np.cumsum(f_inst) / fs)
    sig = awgn(sig.astype(np.complex64), snr_db, rng=rng)
    truth = spec.centreFreqOffset - f_max * np.tanh((np.arange(n_blocks) + 0.5 - t_mid) / tau)
    return sig.astype(np.complex64).reshape(n_blocks, N), truth


def s_curve_swing(spec, n_blocks, track_span_bins):
    """(f_max Hz, tau blocks) of the pass, sized as JAX sizes it
    (``subsystems.py:106-121``): inside 0.7 of the acquisition grid's span,
    and a slew the track grid follows (0.4 of its half-span a block)."""
    bin_hz = spec.sampleRate / spec.Nfft
    grid_span_hz = float(spec.dopp_hz_lut.max() - spec.dopp_hz_lut.min())
    tau = n_blocks / 6
    slew_limit = 0.4 * (track_span_bins / 2) * bin_hz  # Hz per block
    return min(0.35 * grid_span_hz, slew_limit * tau), tau


def tracking_bench(spec=None, n_blocks: int = 400, track_bins: int = 16,
                   track_span_bins: int = 32, snr_db: float = 10.0,
                   time_graphs: bool = True, T: int = 50, device=None):
    """Drive a simulated LEO pass through the search-and-track loop on
    ``device`` (None: the card); with ``time_graphs`` time the acquire and
    track graphs at B=1 (``cuda_ms``, ``T`` calls). ``spec`` None is
    ``configs.flagship_spec()``."""
    from pycusdr_tpu_torch.models.tracking import TRACKING, DopplerTracker

    dev = resolve_device(device)
    if spec is None:
        from pycusdr_tpu_torch.configs import flagship_spec

        spec = flagship_spec()
    tracker = DopplerTracker(spec=spec, track_bins=track_bins, track_span_bins=track_span_bins,
                             snr_threshold_db=3.0, lost_limit=5, device=dev)
    bin_hz = spec.sampleRate / spec.Nfft
    grid_span_hz = float(spec.dopp_hz_lut.max() - spec.dopp_hz_lut.min())
    f_max, tau = s_curve_swing(spec, n_blocks, track_span_bins)
    blocks, truth = s_curve_blocks(spec, n_blocks, f_max, n_blocks / 2, tau, snr_db)
    xb = torch.from_numpy(blocks).to(dev)
    modes, est = [], []
    for b in xb:
        res = tracker.process(b)
        modes.append(res["mode"])
        est.append(float(res["doppler_hz"]))

    locked = [m == TRACKING for m in modes]
    assert any(locked), "tracker never locked during the pass"
    first = locked.index(True)
    err_bins = np.abs(np.asarray(est)[first:] - truth[first:]) / bin_hz
    out = {
        "n_blocks": n_blocks,
        "doppler_swing_hz": 2 * f_max,
        "swing_fraction_of_grid": 2 * f_max / grid_span_hz,
        "max_slew_hz_per_block": f_max / tau,
        "snr_db": snr_db,
        "first_lock_block": first,
        "lock_fraction_after_first": float(np.mean(locked[first:])),
        "median_err_bins": float(np.median(err_bins)),
        "acquire_bins": int(spec.num_dopplers),
        "track_bins": int(tracker.track_spec.num_dopplers),
        "device": str(dev), "card": card_line(dev),
    }
    if time_graphs:
        # the single-block graphs the tracker itself runs, the track graph
        # recentred at run time
        t_acq = cuda_ms(lambda: tracker._acquire(xb[0]), T, REPS, dev)
        t_trk = cuda_ms(lambda: tracker._track(xb[0], 0), T, REPS, dev)
        out["acquire_us_per_block"] = 1e3 * t_acq
        out["track_us_per_block"] = 1e3 * t_trk
        out["track_speedup"] = t_acq / t_trk
    return out


def main(argv=None):
    from pycusdr_tpu_torch.configs import flagship_spec, tiny_spec

    ap = argparse.ArgumentParser(description="the channelizer and the tracker, checked and timed")
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    ap.add_argument("--out", default=None)
    ap.add_argument("--blocks", type=int, default=48, help="blocks of the tracking pass")
    ap.add_argument("--spec", choices=["flagship", "tiny"], default="flagship",
                    help="the tracker's spec: flagship (a track grid of 16 bins over 32), "
                         "or tiny (Nfft 2^9, 8 bins over 16: the CPU tests' size)")
    args = ap.parse_args(argv)
    dev = "cpu" if args.cpu else None
    spec, grid = ((flagship_spec(), {}) if args.spec == "flagship"
                  else (tiny_spec(), {"track_bins": 8, "track_span_bins": 16}))
    res = {
        "channelizer": channelizer_bench(device=dev),
        "tracking": tracking_bench(spec=spec, n_blocks=args.blocks, device=dev, **grid),
    }
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
