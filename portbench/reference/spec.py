"""The demodulator's constants, worked out again from a configuration file.

A frozen, independent copy of what the measured program derives from the
same pyCuSDR-schema configuration (the filter bank, the Doppler grid, the
timing band, the slot bound, the LUT). It imports nothing of the program:
the reference takes the configuration, never the program's tables.

Only the bench_GFSK protocol is known here (the FSK phase templates that
pyCuSDR's ``protocol/benchmark/bench_GFSK.py`` correlates against); a
configuration naming another protocol is refused.
"""

from dataclasses import dataclass

import numpy as np

SPEED_OF_LIGHT = 299792458.0
#: trust of a normal bit is this many times the radio's voteWeight
TRUST_NORMAL_SCALE = 2
TRUST_CLIPPED = -2


@dataclass(frozen=True)
class RefSpec:
    Nfft: int
    sigOverlap: int
    spsym: float
    sampleRate: float
    masks01: np.ndarray  # (M, maskLen) bit patterns
    masks_f: np.ndarray  # (M, Nfft) complex128 conj FFT of each template
    windowWidth: int
    dopp_shifts: np.ndarray  # (D,) int64 in [0, Nfft)
    dopp_hz_lut: np.ndarray  # (D,) float64
    num_dopplers: int
    dopp_array_offset: int
    dopp_offset_idx: int
    sum_all_masks: bool
    doppler_search: bool
    clipping: bool
    peak_threshold_scale: float
    centreFreqOffset: float
    bitLUT: np.ndarray  # (M,) int8 centre bit of each mask
    spsymMin: int
    numSymMax: int
    code_idx_lo: int
    code_idx_hi: int
    trust_normal: int
    snr_window: int = 5
    code_search_mask_offset: int = 0

    @property
    def M(self) -> int:
        return self.masks_f.shape[0]

    @property
    def D(self) -> int:
        return len(self.dopp_shifts)


def _bit_patterns(mask_len: int) -> np.ndarray:
    idx = np.arange(2 ** mask_len, dtype=np.int64)
    return ((idx[:, None] >> np.arange(mask_len - 1, -1, -1)) & 1).astype(np.float64)


def fsk_templates(masks01: np.ndarray, spsym: int, n_cycles: float = 0.5) -> np.ndarray:
    """Continuous-phase FSK template of each bit pattern: +-2 pi n_cycles a
    symbol, a linear ramp inside each symbol, offset -p0 pi / 2."""
    wave = np.linspace(1.0 / spsym, 1.0, spsym) * np.pi * 2 * n_cycles
    p = masks01 * 2.0 - 1.0
    base = np.cumsum(p * wave[-1], axis=1) - p * wave[-1]
    phase = (base[:, :, None] + p[:, :, None] * wave[None, None, :]).reshape(p.shape[0], -1)
    return np.exp(1j * (phase - p[:, :1] * np.pi / 2))


def doppler_grid(Nfft, num_dopplers, baud, spsym, frequency_Hz, frequencyOffset_Hz,
                 rangeRateMax):
    """(shifts, hz_lut, fixed shift, sample rate) of the Doppler search grid:
    centred on the IF offset, rangeRateMax wide on each side."""
    fs = baud * spsym
    dopp_offset = frequencyOffset_Hz / fs
    dmax = rangeRateMax * (frequency_Hz - frequencyOffset_Hz) / SPEED_OF_LIGHT / fs
    grid = np.linspace(dopp_offset - dmax, dopp_offset + dmax, num_dopplers)
    shifts = np.round(grid * Nfft).astype(np.int64) % Nfft
    return shifts, grid * fs, int(round(dopp_offset * Nfft)) % Nfft, fs


def build(conf: dict, radio: str = "UHF-H") -> RefSpec:
    """The RefSpec of ``conf``'s Rx radio ``radio``."""
    rx = conf["Radios"]["Rx"][radio]
    gpu = conf["GPU"][rx["CUDA_settings"]]
    protocol = conf["Main"]["protocols"][rx["Protocol"]]
    if protocol != "bench_GFSK":
        raise ValueError(f"the reference knows bench_GFSK only, not {protocol!r}")
    Nfft = 2 ** gpu["blockSize"]
    spsym = float(rx["samplesPerSym"])
    baud = float(rx["baud"])
    num_dopplers = int(rx.get("doppCarrierSteps", gpu.get("doppCarrierSteps", 64)))
    if rx.get("noise_measure_offset_Hz"):
        raise ValueError("the reference has no noise-measurement bin")
    masks01 = _bit_patterns(int(gpu["xcorrMaskSize"]))
    templates = fsk_templates(masks01, int(spsym))
    masks_f = np.conj(np.fft.fft(templates, Nfft, axis=1))
    shifts, hz, fixed, fs = doppler_grid(Nfft, num_dopplers, baud, spsym, rx["frequency_Hz"],
                                         rx["frequencyOffset_Hz"],
                                         conf["Radios"].get("rangeRateMax", 27500))
    backend = rx.get("radioBackend", "UHF")
    spsym_min = int(spsym / 2)
    hi = int(Nfft / (0.9 * spsym))
    return RefSpec(
        Nfft=Nfft, sigOverlap=2 ** gpu["overlap"], spsym=spsym, sampleRate=fs,
        masks01=masks01, masks_f=masks_f, windowWidth=int(gpu["bitWindowWidth"]),
        dopp_shifts=shifts, dopp_hz_lut=hz, num_dopplers=num_dopplers,
        dopp_array_offset=0, dopp_offset_idx=fixed, sum_all_masks=True,
        doppler_search=backend == "UHF",
        clipping=not bool(rx.get("disablePeakThresholding", backend == "UHF")),
        peak_threshold_scale=float(gpu.get("peakThresholdScale", 40.5)),
        centreFreqOffset=float(rx["frequencyOffset_Hz"]),
        bitLUT=masks01[:, masks01.shape[1] // 2].astype(np.int8),
        spsymMin=spsym_min,
        numSymMax=min(int(Nfft / spsym_min), -(-hi // 128) * 128),
        code_idx_lo=int(Nfft / (1.1 * spsym)), code_idx_hi=hi,
        trust_normal=max(1, int(TRUST_NORMAL_SCALE * rx.get("voteWeight", 1))),
    )
