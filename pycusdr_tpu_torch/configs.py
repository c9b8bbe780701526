"""The demodulator configurations the port runs, with the same confs as
the JAX package's entry module (``__graft_entry__.py:20-95``).

``flagship_spec``: the operational UHF envelope (bench_GFSK, Nfft 2^16,
overlap 2^10, D=64 Doppler bins, M=8 masks, W=7, spsym 16).
``stx_spec``: the S-band STX envelope (config/base.json GPU.STX: Nfft
2^17, overlap 2^11, W=3, spsym 16, spike clipping at scale 4.5, no
Doppler search, the fixed shift of the IF offset).
``tiny_spec``: the CPU-test size (Nfft 2^9, D=16, W=5, spsym 8).
"""

from pycusdr_tpu_torch.dsp.spec import build_spec
from pycusdr_tpu_torch.protocol import loadProtocol

RADIO = "UHF-H"


def _conf(blockSize, overlap, spsym, doppSteps, *, baud=9600.0, maskSize=3,
          windowWidth=7, rangeRateMax=7500.0):
    fs = baud * spsym
    return {
        "Main": {"workerId": "graft", "protocols": {"UHF": "bench_GFSK"}},
        "GPU": {
            "UHF": {
                "blockSize": blockSize,
                "overlap": overlap,
                "bitWindowWidth": windowWidth,
                "xcorrMaskSize": maskSize,
                "doppCarrierSteps": doppSteps,
            }
        },
        "Radios": {
            "rangeRateMax": rangeRateMax,
            "Rx": {
                RADIO: {
                    "name": "UHF",
                    "CUDA_settings": "UHF",
                    "frequency_Hz": 437.3e6,
                    "frequencyOffset_Hz": fs / 8,
                    "baud": baud,
                    "samplesPerSym": spsym,
                    "doppCarrierSteps": doppSteps,
                    "Protocol": "UHF",
                    "radioBackend": "UHF",
                    "voteGroup": "UHF",
                }
            },
        },
    }


def flagship_conf(mask_size=3):
    """Config dict of the flagship spec (for ``models.uhf.Demodulator``)."""
    return _conf(blockSize=16, overlap=10, spsym=16, doppSteps=64,
                 maskSize=mask_size)


def stx_conf():
    """Config dict of the STX spec (for ``models.stx.Demodulator``)."""
    conf = _conf(blockSize=17, overlap=11, spsym=16, doppSteps=1, windowWidth=3)
    conf["Radios"]["Rx"][RADIO].update(radioBackend="STX", disablePeakThresholding=False)
    conf["GPU"]["UHF"]["peakThresholdScale"] = 4.5
    return conf


def tiny_conf():
    return _conf(blockSize=9, overlap=7, spsym=8, doppSteps=16, windowWidth=5)


def _spec(conf):
    protocol = loadProtocol("bench_GFSK")(conf=conf)
    return build_spec(conf, protocol, RADIO)


def flagship_spec(mask_size=3):
    """Operational-envelope UHF spec; ``mask_size`` 3 is the M=8 bank."""
    return _spec(flagship_conf(mask_size))


def stx_spec():
    """STX-envelope spec (Nfft 2^17, no Doppler search, clipping on)."""
    return _spec(stx_conf())


def tiny_spec():
    """CPU-test-sized spec (Nfft 512)."""
    return _spec(tiny_conf())
