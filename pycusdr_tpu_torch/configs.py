"""The demodulator configurations the port runs, with the same confs as
the JAX package's entry module (``__graft_entry__.py:20-95``).

``flagship_spec``: the operational UHF envelope (bench_GFSK, Nfft 2^16,
overlap 2^10, D=64 Doppler bins, M=8 masks, W=7, spsym 16).
``stx_spec``: the S-band STX envelope (config/base.json GPU.STX: Nfft
2^17, overlap 2^11, W=3, spsym 16, spike clipping at scale 4.5, no
Doppler search, the fixed shift of the IF offset).
``tiny_spec``: the CPU-test size (Nfft 2^9, D=16, W=5, spsym 8).
``ccsds_spec``: the flagship envelope speaking the concatenated CCSDS
downlink (``ccsds_conv``: RS(255,223) + conv K=7 r=1/2 over FSK), with a
Tx radio for the port's ``Modulator``; ``ccsds_example_conf`` is the
CPU-sized conf of ``examples/ccsds_downlink.py:24-45`` (Nfft 2^13).
``wideband_conf``: the 64-channel polyphase channelizer in front of the
flagship spec per channel (BASELINE #5, ``bench/subsystems.py:31``).
``tracking_conf``: the search-and-track loop's settings (BASELINE #3,
``bench/subsystems.py:115-117``).
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


def _tx_radio(conf):
    """The Tx entry matching the Rx radio (the modulator pre-compensates
    the same IF offset the demodulator searches around)."""
    rx = conf["Radios"]["Rx"][RADIO]
    return {"baud": rx["baud"], "samplesPerSym": rx["samplesPerSym"],
            "frequency_Hz": rx["frequency_Hz"], "frequencyOffset_Hz": rx["frequencyOffset_Hz"],
            "Protocol": "UHF"}


def ccsds_conf():
    """Config dict of the flagship envelope with ``Main.protocols.UHF =
    "ccsds_conv"`` and a ``Radios.Tx.UHF`` entry."""
    conf = flagship_conf()
    conf["Main"]["protocols"]["UHF"] = "ccsds_conv"
    conf["Radios"]["Tx"] = {"UHF": _tx_radio(conf)}
    return conf


def ccsds_example_conf():
    """The conf of ``examples/ccsds_downlink.py:build_conf`` (Nfft 2^13,
    overlap 2^10, D=16, IF offset 38.4 kHz): the CPU-test size."""
    conf = _conf(blockSize=13, overlap=10, spsym=16, doppSteps=16)
    conf["Main"].update(workerId="demo", protocols={"UHF": "ccsds_conv"}, PacketLen=10000,
                        RandSeed=123)
    conf["GPU"]["UHF"].update(doppMaxRangeRate=7500, peakThresholdScale=8)
    del conf["GPU"]["UHF"]["doppCarrierSteps"]  # the example sets it on the radio only
    conf["Radios"]["Rx"][RADIO]["frequencyOffset_Hz"] = 38400
    conf["Radios"]["Tx"] = {"UHF": _tx_radio(conf)}
    return conf


def tiny_conf():
    return _conf(blockSize=9, overlap=7, spsym=8, doppSteps=16, windowWidth=5)


def _spec(conf, protocol="bench_GFSK"):
    protocol = loadProtocol(protocol)(conf=conf)
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


def ccsds_spec():
    """Flagship-envelope spec of the concatenated CCSDS downlink."""
    return _spec(ccsds_conf(), "ccsds_conv")


def wideband_conf():
    """The wideband front end: an M=64 channelizer (K=8 taps per branch,
    Kaiser beta 9) whose every channel runs the flagship spec, so the
    wideband rate is 64 x 153.6 ks/s = 9.8304 Ms/s. Keys: ``M``,
    ``taps_per_branch``, ``beta`` (``parallel.Channelizer``'s arguments)
    and ``channel_conf`` (the flagship conf)."""
    return {"M": 64, "taps_per_branch": 8, "beta": 9.0, "channel_conf": flagship_conf()}


def tracking_conf():
    """``models.DopplerTracker``'s keyword arguments of the LEO pass: a
    16-bin track grid over 32 FFT bins, lock above 3 dB SNR, reacquire
    after 5 weak blocks."""
    return {"track_bins": 16, "track_span_bins": 32, "snr_threshold_db": 3.0,
            "lost_limit": 5}
