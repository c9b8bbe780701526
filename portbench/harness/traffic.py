"""The one traffic generator: a pool of distinct input batches made from the
seed, on the device in a few large calls, then pinned in host memory, as a
front end's DMA ring would hold them.

A mix is a data file of parameters (``portbench/traffic/<name>.json``):

- ``entry``: "batch" (C co-sampled channels, one overlap-save block of each a
  call, into the block graph) or "wideband" (one stream of M channels' band,
  a hop of M x Nfft samples a call, into the channelizer and the step);
- ``channels``: C ("batch"); ``occupied``: carriers among the M channels
  ("wideband", the rest carry noise alone);
- ``snr_db``: [lo, hi], each carrier's SNR a sample, uniform;
- ``range_rate_mps``: [lo, hi], each carrier's constant range rate, uniform;
- ``bursts``: null, or {"per_hop", "length", "amplitude"}: impulsive
  interference, that many bursts of that many samples at that amplitude
  (the signal's is 1) in every hop of every channel, at random places and
  phases;
- ``pool_bytes``: the pool holds at least this many bytes, and at least
  ``MIN_BATCHES`` batches;
- ``checked_calls``: how many of the window's calls the comparison reads.

Every carrier is continuous-phase GFSK (BT 1, a Gaussian pulse four symbols
long) of random bits at the radio's baud, at the radio's IF offset plus its
Doppler shift. The sizes and the number of carriers never depend on the
seed; only the bits, SNRs, range rates, burst places and which channels are
occupied do.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0
MIN_BATCHES = 4


@dataclass
class Pool:
    batches: torch.Tensor  # (P, C, Nfft) or (P, M * Nfft) complex64, pinned on a card
    samples_per_call: int  # new input samples a call carries
    blocks_per_call: int

    def __len__(self):
        return self.batches.shape[0]


def radio(conf: dict):
    """(name, Rx radio entry, its GPU settings) of the configuration's one Rx radio."""
    (name, rx), = conf["Radios"]["Rx"].items()
    return name, rx, conf["GPU"][rx["CUDA_settings"]]


def _uniform(g, n, lo_hi, dev):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=g, device=dev, dtype=torch.float64)


def _gaussian_taps(sps: int, bt: float = 1.0) -> np.ndarray:
    ntaps = 4 * sps
    a = math.sqrt(math.log(2) / 2) / bt
    t = np.linspace(-0.5 * ntaps, 0.5 * ntaps - 1, ntaps) / sps
    h = np.sqrt(np.pi) / a * np.exp(-(np.pi ** 2) * t ** 2 / a ** 2)
    return h / h.sum()


def _gfsk_phase(g, n_ch: int, n: int, sps: int, dev) -> torch.Tensor:
    """(n_ch, n) float64 phase of GFSK at ``sps`` samples a symbol."""
    n_sym = n // sps + 8
    bits = torch.randint(0, 2, (n_ch, n_sym), generator=g, device=dev)
    nrz = (2.0 * bits - 1.0).to(torch.float32).repeat_interleave(sps, dim=1)
    taps = torch.as_tensor(_gaussian_taps(sps), dtype=torch.float32, device=dev)
    f = torch.nn.functional.conv1d(nrz[:, None, :], taps.flip(0)[None, None, :],
                                   padding=len(taps) // 2)[:, 0, :n]
    return torch.cumsum(f.to(torch.float64) * (math.pi / sps), dim=1)


def _noise(g, shape, var, dev) -> torch.Tensor:
    """Complex white noise of variance ``var`` (broadcast over ``shape``)."""
    re = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
    im = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
    return torch.complex(re, im) * torch.sqrt(torch.as_tensor(var, device=dev) / 2).to(
        torch.float32)


def _doppler_hz(rr: torch.Tensor, rx: dict) -> torch.Tensor:
    return rr * (rx["frequency_Hz"] - rx["frequencyOffset_Hz"]) / SPEED_OF_LIGHT


def _bursts(g, sig: torch.Tensor, hop: int, n_hops: int, b: dict, dev) -> None:
    """Add ``b["per_hop"]`` bursts to every hop of every row of ``sig`` in place."""
    C = sig.shape[0]
    per, length = int(b["per_hop"]), int(b["length"])
    start = torch.randint(0, hop - length, (C, n_hops, per), generator=g, device=dev)
    start = start + torch.arange(n_hops, device=dev)[None, :, None] * hop
    idx = (start.reshape(C, -1, 1) + torch.arange(length, device=dev)).reshape(C, -1)
    ph = 2 * math.pi * torch.rand(idx.shape, generator=g, device=dev, dtype=torch.float64)
    burst = torch.polar(torch.full_like(ph, float(b["amplitude"])), ph).to(torch.complex64)
    flat = (idx + torch.arange(C, device=dev)[:, None] * sig.shape[1]).reshape(-1)
    sig.view(-1).index_add_(0, flat, burst.reshape(-1))


def _batch_pool(g, conf, traffic, dev, n_batches=None):
    _, rx, gpu = radio(conf)
    N, ov = 2 ** gpu["blockSize"], 2 ** gpu["overlap"]
    sps, fs = int(rx["samplesPerSym"]), rx["baud"] * rx["samplesPerSym"]
    C = int(traffic["channels"])
    hop = N - ov
    P = n_batches or max(MIN_BATCHES, -(-int(traffic["pool_bytes"]) // (C * N * 8)))
    L = P * hop + ov
    snr = _uniform(g, C, traffic["snr_db"], dev)
    f = rx["frequencyOffset_Hz"] + _doppler_hz(_uniform(g, C, traffic["range_rate_mps"], dev),
                                               rx)
    n = torch.arange(L, device=dev, dtype=torch.float64)
    phase = _gfsk_phase(g, C, L, sps, dev) + (2 * math.pi / fs) * f[:, None] * n[None, :]
    sig = torch.polar(torch.ones_like(phase), torch.remainder(phase, 2 * math.pi))
    del phase
    sig = sig.to(torch.complex64) + _noise(g, (C, L), 10.0 ** (-snr[:, None] / 10), dev)
    if traffic.get("bursts"):
        _bursts(g, sig, hop, P, traffic["bursts"], dev)
    blocks = sig.unfold(1, N, hop).permute(1, 0, 2).contiguous()  # (P, C, N)
    return blocks, C * hop, C


def _wideband_pool(g, conf, traffic, dev, n_batches=None):
    _, rx, gpu = radio(conf)
    wb = conf["Wideband"]
    M, T = int(wb["M"]), 2 ** gpu["blockSize"]
    sps, fs = int(rx["samplesPerSym"]), rx["baud"] * rx["samplesPerSym"]
    P = n_batches or max(MIN_BATCHES, -(-int(traffic["pool_bytes"]) // (M * T * 8)))
    L = P * M * T
    occ = torch.randperm(M, generator=g, device=dev)[:int(traffic["occupied"])]
    snr = _uniform(g, len(occ), traffic["snr_db"], dev)
    f = (occ.to(torch.float64) * fs + rx["frequencyOffset_Hz"]
         + _doppler_hz(_uniform(g, len(occ), traffic["range_rate_mps"], dev), rx))
    n = torch.arange(L, device=dev, dtype=torch.float64)
    # unit noise in each channel: the prototype's taps sum to 1, their
    # energy is about 1 / M
    sig = _noise(g, (L,), torch.tensor(float(M), dtype=torch.float64), dev)
    for i in range(len(occ)):
        ph = _gfsk_phase(g, 1, L // M, sps, dev)[0].repeat_interleave(M) / M
        ph = ph + (2 * math.pi / (M * fs)) * f[i] * n
        amp = torch.full_like(ph, 1.0) * 10.0 ** (snr[i] / 20)
        sig += torch.polar(amp, torch.remainder(ph, 2 * math.pi)).to(torch.complex64)
        del ph, amp
    return sig.reshape(P, M * T), M * T, M


def make_pool(conf: dict, traffic: dict, seed: int, device, n_batches: int = None) -> Pool:
    """The pool of input batches of ``traffic`` under ``conf`` from ``seed``,
    made on ``device``; on a card it is moved to pinned host memory and
    nothing of it is left on the card. ``n_batches``: a pool of that many
    batches instead of ``pool_bytes``' (the CPU tests' size)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (2 ** 63))
    make = {"batch": _batch_pool, "wideband": _wideband_pool}[traffic["entry"]]
    with torch.no_grad():
        batches, samples, blocks = make(g, conf, traffic, dev, n_batches)
    if dev.type == "cuda":
        host = torch.empty(batches.shape, dtype=batches.dtype, pin_memory=True)
        host.copy_(batches)
        del batches
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        batches = host
    return Pool(batches=batches, samples_per_call=samples, blocks_per_call=blocks)
