"""Tx process: payload bytes in, Doppler-precompensated waveform out.

The port of ``pycusdr_tpu/runtime/modulator_process.py``. Capability
parity with the reference ``Modulator_process``
(``pyCuSDR/modulator_process.py``): PULLs payload bytes (plus an
optional ``TxManualIn`` bypass socket), applies the rangerate set via
RPC/hamlib, frames + modulates via the protocol's LUT modulator, and
PUSHes the complex64 waveform to GNU Radio. Monitored frequencies are
exposed as locked ``multiprocessing.Value`` properties.

The Tx chain (``tx/modulator.py``) is host numpy, so this child touches
no device.
"""

import logging
import multiprocessing
import signal
import time

import numpy as np

from pycusdr_tpu_torch.globals import MODULATORDTYPE
from pycusdr_tpu_torch.tx.modulator import Modulator
from pycusdr_tpu_torch.utils.binops import hexstr
from pycusdr_tpu_torch.utils.doppler import freq_from_rangerate, rangerate_from_freq

# spawn, as the port's other children (see demodulator_process)
_mp = multiprocessing.get_context("spawn")
Event, Process, Value = _mp.Event, _mp.Process, _mp.Value

log = logging.getLogger(__name__)


class Modulator_process(Process):
    timeOut_ms = 100

    def __init__(self, conf, protocol, radioName=""):
        Process.__init__(self)
        self.conf = conf
        self.protocol = protocol
        self.logLevel = log.getEffectiveLevel()
        if radioName:
            self.name = radioName
            self.confRadio = conf["Radios"]["Tx"][radioName]
        else:
            self.name = protocol.name
            self.confRadio = conf["Radios"]["Tx"]

        self.__rangerate = Value("f", 0)
        self.__Fc = Value("d", self.confRadio.get("frequency_Hz", 1))
        # gpredict may steer against a different centre frequency
        self.__Fc_hl = self.confRadio.get("frequency_hamlib_Hz", self.__Fc.value)
        self.__Fs = Value("d", self.confRadio["samplesPerSym"] * self.confRadio["baud"])
        self.__baudRate = Value("d", self.confRadio["baud"])
        self.__centreFreqOffset = Value("d", self.confRadio.get("centreFrequencyOffset", 0.0))
        self.__freqOffset = Value("d", self.confRadio["frequencyOffset_Hz"])
        self.__totalFreqOffset = Value("f", 0)
        self.__numSyncFlags = Value("i", -1)  # -1 = protocol default

        self.daemon = True
        self.runStatus = Event()
        self.runStatus.set()
        # set once the waveform and payload sockets are bound
        self.boundFlag = Event()
        log.info("[%s]: Modulator initialized", self.name)

    def stop(self):
        log.info("Received request to stop")
        self.runStatus.clear()

    def run(self):
        import zmq

        from pycusdr_tpu_torch.utils.logger import child_logger_setup

        child_logger_setup(self.logLevel)
        time.sleep(0.5)
        ctx = zmq.Context()
        interfaces = self.confRadio.get("Interfaces", {})
        TX_addr = interfaces.get(
            "TxModToUSRPPort",
            self.conf["Interfaces"]["Internal"].get("TxModToUSRPPort"),
        )
        log.info("[%s]: Opening GRC TX socket %s", self.name, TX_addr)
        TXsock = ctx.socket(zmq.PUSH)
        TXsock.setsockopt(zmq.LINGER, 0)
        TXsock.bind(TX_addr)

        byteDataIn_ZMQ = ctx.socket(zmq.PULL)
        byteDataIn_ZMQ.setsockopt(zmq.LINGER, 0)
        log.info("[%s]: Opening byte data In socket %s", self.name, interfaces["TxDataIn"])
        byteDataIn_ZMQ.bind(interfaces["TxDataIn"])

        TxManualInSock = None
        if "TxManualIn" in interfaces:
            TxManualInSock = ctx.socket(zmq.PULL)
            TxManualInSock.setsockopt(zmq.LINGER, 0)
            try:
                TxManualInSock.bind(interfaces["TxManualIn"])
            except zmq.ZMQError as e:
                log.error("[%s]: failed to open manual Tx socket [%s]", self.name, e)
                TxManualInSock.close()
                TxManualInSock = None

        poller = zmq.Poller()
        poller.register(byteDataIn_ZMQ, zmq.POLLIN)
        if TxManualInSock:
            poller.register(TxManualInSock, zmq.POLLIN)
        self.boundFlag.set()

        modul = Modulator(self.conf, self.confRadio, self.protocol)
        orig_sigterm = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, lambda *_: None)
        try:
            while self.runStatus.is_set():
                evts = dict(poller.poll(self.timeOut_ms))
                with self.__rangerate.get_lock():
                    rr = self.__rangerate.value
                    modul.set_rangerate(rr)
                modul.TxCentreFreqOffset = self.__centreFreqOffset.value
                if self.__numSyncFlags.value > 0:
                    modul.numSyncFlags = self.__numSyncFlags.value

                if evts:
                    if byteDataIn_ZMQ in evts:
                        rawTxData = byteDataIn_ZMQ.recv()
                    elif TxManualInSock and TxManualInSock in evts:
                        rawTxData = TxManualInSock.recv()
                    else:
                        rawTxData = None
                    if rawTxData:
                        TxData = np.frombuffer(rawTxData, dtype=np.uint8)
                        log.info(
                            "[%s]: RangeRate %s m/s (Doppler %.0f Hz) offset %s Hz -- "
                            "transmitting %d bytes %s",
                            self.name, rr, rr / 3e8 * self.Fc,
                            self.centreFreqOffset, len(TxData), hexstr(TxData),
                        )
                        sigMod = modul.encodeAndModulate(TxData)
                        try:
                            TXsock.send(sigMod.astype(MODULATORDTYPE), zmq.NOBLOCK)
                        except zmq.error.Again:
                            log.warning("[%s]: timeout sending waveform to GNU Radio", self.name)

                # publish monitored values for the RPC thread
                with self.__Fc.get_lock():
                    self.__Fc.value = modul.Fc - modul.TxFreqOffset
                with self.__Fs.get_lock():
                    self.__Fs.value = modul.get_samp_rate()
                with self.__freqOffset.get_lock():
                    self.__freqOffset.value = modul.TxFreqOffset
                with self.__totalFreqOffset.get_lock():
                    self.__totalFreqOffset.value = modul.TxTotalFreqOffset
                with self.__baudRate.get_lock():
                    self.__baudRate.value = modul.baudRate
        except Exception as e:
            log.exception(e)
        finally:
            TXsock.close()
            byteDataIn_ZMQ.close()
            if TxManualInSock:
                TxManualInSock.close()
            ctx.term()
            signal.signal(signal.SIGTERM, orig_sigterm)
            log.info("[%s]: Process finished -- Bye", self.name)

    # ---------------- monitored-value properties ----------------

    @property
    def Fs(self):
        return self.__Fs.value

    @property
    def baudRate(self):
        return self.__baudRate.value

    @property
    def rangerate(self):
        return self.__rangerate.value

    @rangerate.setter
    def rangerate(self, rangerate):
        with self.__rangerate.get_lock():
            self.__rangerate.value = float(rangerate)

    @property
    def Fc(self):
        return self.__Fc.value

    @property
    def centreFreqOffset(self):
        return self.__centreFreqOffset.value

    @centreFreqOffset.setter
    def centreFreqOffset(self, fo):
        with self.__centreFreqOffset.get_lock():
            self.__centreFreqOffset.value = int(fo)

    @property
    def freqOffset(self):
        return self.__freqOffset.value

    @freqOffset.setter
    def freqOffset(self, val):
        with self.__freqOffset.get_lock():
            self.__freqOffset.value = int(val)

    @property
    def totalFreqOffset(self):
        return self.__totalFreqOffset.value

    @property
    def numSyncFlags(self):
        n = self.__numSyncFlags.value
        return n if n > 0 else self.conf.get("Radios", {}).get(
            "Protocol", {}).get("tx_num_preambles", -1)

    @numSyncFlags.setter
    def numSyncFlags(self, n):
        with self.__numSyncFlags.get_lock():
            self.__numSyncFlags.value = int(n)

    @property
    def doppler(self):
        return freq_from_rangerate(self.__rangerate.value, self.__Fc_hl) - self.__Fc_hl

    @property
    def freq_hl(self):
        """Hamlib-facing tuned frequency (Fc + Doppler)."""
        return self.__Fc_hl + self.doppler

    @freq_hl.setter
    def freq_hl(self, val):
        self.rangerate = rangerate_from_freq(val, self.__Fc_hl)
