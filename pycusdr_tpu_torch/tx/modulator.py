"""Modulator core: framing + LUT modulation + Doppler pre-compensation
(the port's copy of ``pycusdr_tpu/tx/modulator.py``; host numpy only).

Capability parity with ``pyCuSDR/modulator/modulator.py:34-213``:
Doppler/IF pre-compensation is applied by *adding phase increments to
the LUT* before cumsum integration (``:97-118``), the waveform is padded
with low-power noise so front-end hardware (USRP) stabilizes
(``SIG_MIN_LENGTH`` behaviour, ``:14-31,117-123``).
"""

import logging
import time

import numpy as np

from pycusdr_tpu_torch.globals import MODULATORDTYPE, SAVETX_DATA

log = logging.getLogger(__name__)

SIG_MIN_LENGTH = 16384
NOISE_LEN = 4096
NOISE_VAR = 1e-8


class Modulator:
    """Framing (L2) + LUT modulation (L1) for one Tx radio."""

    def __init__(self, conf, confRadio, protocol):
        self.conf = conf
        self.confRadio = confRadio
        self.protocol = protocol

        encoderCls = protocol.getFramer(confRadio)
        self.encoder = encoderCls(protocol, confRadio)
        modulatorCls = protocol.getModulator(confRadio)
        self.modulatorCLS = modulatorCls(protocol, confRadio)
        log.info("Using modulator %s with encoder %s", self.modulatorCLS.name, self.encoder.name)

        self._spSym = confRadio["samplesPerSym"]
        self.Fc = confRadio["frequency_Hz"]
        self._TxFreqOffset = confRadio["frequencyOffset_Hz"]
        self._TxCentreFreqOffset = confRadio.get("centreFrequencyOffset", 0.0)
        self.baudRate = confRadio["baud"]

        rng = np.random.RandomState(0xC0FFEE & 0x7FFFFFFF)
        self.noise = (
            NOISE_VAR * (rng.randn(SIG_MIN_LENGTH) + 1j * rng.randn(SIG_MIN_LENGTH))
        ).astype(np.complex64)
        self._rangerate = 0.0
        self._numSyncFlags = int(getattr(protocol, "tx_num_preambles",
                                 getattr(protocol, "tx_num_flags", 0)) or 0)

    # ---------------- main entry points ----------------

    def encodeAndModulate(self, byteMessage):
        t = time.time()
        framed = self.encoder.encodeAndFrame(byteMessage)
        log.debug("Frame time %.3f ms", 1000 * (time.time() - t))
        return self.modulate(framed)

    def encodeAndFrame(self, byteMessage):
        return self.encoder.encodeAndFrame(byteMessage)

    def modulate(self, bitData):
        """Doppler/IF-compensate the LUT, integrate, pad for hardware."""
        dopplerCoef = self.getDoppler() / self.baudRate / self.spSym
        freqOffset = self.TxFreqOffsetRads / self.baudRate / self.spSym
        centreFreqOffset = self.TxCentreFreqOffsetRads / self.baudRate / self.spSym
        offsetCoef = freqOffset + centreFreqOffset

        lut = self.modulatorCLS.LUT + dopplerCoef + offsetCoef

        t = time.time()
        txSig = self.modulatorCLS.modulate(np.asarray(bitData), lut)
        log.debug("Modulation time %.3f ms", 1000 * (time.time() - t))

        txSig = np.concatenate((self.noise[:NOISE_LEN], txSig, self.noise[:NOISE_LEN]))
        if len(txSig) < SIG_MIN_LENGTH:
            txSig = np.concatenate((self.noise[: SIG_MIN_LENGTH - len(txSig)], txSig))

        if SAVETX_DATA:
            np.save("tx_waveform_snapshot", txSig)
        return txSig.astype(MODULATORDTYPE)

    # ---------------- RPC-facing setters/getters ----------------

    @property
    def numSyncFlags(self):
        """Preamble-flag repetition count (RPC surface,
        rpcInterface.py:228-236; the reference registers the methods but
        left the modulator plumbing commented out,
        modulator_process.py:143 — here it actually reframes)."""
        return self._numSyncFlags

    @numSyncFlags.setter
    def numSyncFlags(self, n):
        n = int(n)
        if n <= 0 or n == getattr(self, "_numSyncFlags", None):
            return
        self._numSyncFlags = n
        # the repetition count lives on the protocol; re-derive the
        # encoder's cached preamble bits from it
        if hasattr(self.protocol, "tx_num_preambles"):
            self.protocol.tx_num_preambles = n
        if hasattr(self.protocol, "tx_num_flags"):
            self.protocol.tx_num_flags = n
        try:
            flags, hdr = self.protocol.initTxHeader()
        except Exception:
            log.warning("protocol %s cannot re-derive Tx flags", self.protocol.name)
            return
        enc = self.encoder
        if hasattr(enc, "preFlags"):
            enc.preFlags = flags
        elif hasattr(enc, "Flags"):
            enc.Flags, enc.Header = flags, hdr

    def get_rangerate(self):
        return self._rangerate

    def set_rangerate(self, rangerate):
        self._rangerate = rangerate

    def getDoppler(self):
        """Doppler in rad/s for the current rangerate."""
        return self._rangerate / 3e8 * self.Fc * 2 * np.pi

    def get_samp_rate(self):
        return self.baudRate * self._spSym

    def set_samp_rate(self, samp_rate):
        log.warning("Setting sample rate should be done through the config")

    def get_Tx_Fc(self):
        return self.Fc

    def set_Tx_Fc(self, Fc):
        self.Fc = Fc

    @property
    def spSym(self):
        return self._spSym

    @spSym.setter
    def spSym(self, spSym):
        self._spSym = spSym
        self.TxFreqOffset = spSym * self.baudRate / 4

    @property
    def TxTotalFreqOffset(self):
        return self._TxFreqOffset + self._TxCentreFreqOffset + self._rangerate / 3e8 * self.Fc

    @property
    def TxFreqOffset(self):
        return self._TxFreqOffset

    @TxFreqOffset.setter
    def TxFreqOffset(self, fo):
        self._TxFreqOffset = fo

    @property
    def TxFreqOffsetRads(self):
        return self._TxFreqOffset * 2 * np.pi

    @property
    def TxCentreFreqOffset(self):
        return self._TxCentreFreqOffset

    @TxCentreFreqOffset.setter
    def TxCentreFreqOffset(self, offset):
        self._TxCentreFreqOffset = offset

    @property
    def TxCentreFreqOffsetRads(self):
        return self._TxCentreFreqOffset * 2 * np.pi
