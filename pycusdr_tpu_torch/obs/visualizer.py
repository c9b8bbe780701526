"""Per-worker statistics ring buffers (a copy of
``pycusdr_tpu/obs/visualizer.py``).

Capability parity with the reference ``VisualizerData``
(``pyCuSDR/decoder_process.py:417-513``): fixed-size arrays of the
per-block telemetry keys, fail-safe against missing fields; the decoder
ships these to the orchestrator at shutdown for ``obs.stats`` plotting.
"""

import logging

import numpy as np

log = logging.getLogger(__name__)


class VisualizerData:
    keys = ["timestamp", "count", "doppler", "doppler_std", "spSymEst", "SNR",
            "numSyncSig", "packetSuc", "numBits", "packetFail", "baudRate",
            "numSlaves"]

    def __init__(self, workerId, bufferSize, showWarnings=True):
        self.data = {"workerId": workerId}
        for f in self.keys:
            self.data[f] = np.zeros(bufferSize)
        self.idx = 0
        self.bufferSize = bufferSize
        self.workerId = workerId
        self.showWarnings = showWarnings

    def safeAdd(self, key, dataCont, nValues=1):
        if key not in dataCont:
            if self.showWarnings:
                log.warning("Key %s not found for worker %s", key, dataCont.get("workerId"))
            return
        try:
            val = dataCont[key]
            if isinstance(val, (list, np.ndarray)):
                self.data[key][self.idx : self.idx + nValues] = np.asarray(val)[
                    self.idx : self.idx + nValues
                ]
            else:
                self.data[key][self.idx : self.idx + nValues] = val
        except Exception as e:
            log.error("Key %s", key)
            log.exception(e)

    def addData(self, dataCont):
        if isinstance(dataCont["timestamp"], float):
            nValues = 1
        else:
            nValues = min(len(dataCont["timestamp"]), self.bufferSize - self.idx)
        if self.idx < self.bufferSize:
            for k in self.keys:
                self.safeAdd(k, dataCont, nValues=nValues)
        self.idx += nValues

    def getData(self):
        out = {"workerId": self.workerId}
        for k in self.keys:
            out[k] = self.data[k][: self.idx].tolist()
        return out
