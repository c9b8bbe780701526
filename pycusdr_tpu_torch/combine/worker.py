"""Per-channel soft-bit buffer bookkeeping for the diversity combiner
(the port's copy of ``pycusdr_tpu/combine/worker.py``).

Capability parity with the reference ``Worker``/``Slave`` classes
(``softCombiner.py:55-451``): growing bit+trust arrays per demodulator
channel, per-consumer head/tail cursors (one ``Slave`` cursor per peer
the data is served to), arrival-time based pruning of stale data, and
scalar telemetry carried along for the decoder/visualiser.
"""

import logging
import time

import numpy as np

from pycusdr_tpu_torch.globals import DATATYPE, TRUSTTYPE

log = logging.getLogger(__name__)

SLAVE_TIMEOUT = 5.0  # seconds (reference softCombiner.py:53)


class WorkerIdError(AssertionError):
    pass


class Slave:
    """Head/tail cursor tracking what one consumer has already seen
    (reference softCombiner.py:56-91)."""

    def __init__(self, slaveId, head, tail):
        self.workerId = slaveId
        self.count = 0
        self.head = head
        self.tail = tail
        self.timestamp = time.time()

    def updateIdx(self, newHead):
        """Shift cursors down after ``newHead`` elements were pruned.
        Returns -1 when this consumer has timed out and should go."""
        if time.time() - self.timestamp > SLAVE_TIMEOUT:
            return -1
        if self.head < newHead:
            log.warning("slave %s -- removing more data than has been processed", self.workerId)
            self.head = 0
            self.tail -= newHead
        else:
            self.head -= newHead
            self.tail -= newHead
        return 0

    def updateTail(self, idx):
        self.tail = idx

    def resetHeadTail(self):
        self.head = 0
        self.tail = 0


class Worker:
    """Buffer + cursors for one demodulator channel
    (reference softCombiner.py:92-451)."""

    keyNames = ["count", "timestamp", "voteGroup", "doppler", "doppler_std",
                "spSymEst", "SNR", "baudRate", "protocol"]
    keyDataTypes = {
        "count": int, "timestamp": float, "voteGroup": int, "doppler": float,
        "doppler_std": float, "spSymEst": float, "SNR": float,
        "TxRangeRate": float, "baudRate": int, "protocol": str,
    }
    arrayKeyNames = ["data", "trust"]
    arrayDataTypes = {"data": DATATYPE, "trust": TRUSTTYPE}

    def __init__(self, workerData, timestampTimeOut=0.5, showWarnings=False):
        self.showWarnings = showWarnings
        self.getCount = 0  # number of times data was actually served
        self.totalRequestCount = 0
        self._dataRequestCounter = 0  # cleared whenever data is sent onward

        self.arrivalTimes = [{"time": time.time(), "idx": 0,
                              "count": int(workerData.get("count", 0))}]
        self.data = {}

        self.workerId = str(workerData["workerId"])
        self.timestamp = time.time()
        # frontier bookkeeping: channels in a vote group demodulate the
        # same stream, so block counts are comparable across workers —
        # the latest count tells how far this channel has processed
        self.latestCount = int(workerData.get("count", 0))
        self.lastArrival = time.time()

        for key in self.keyNames:
            self.safeAdd(key, workerData)
        for key in self.arrayKeyNames:
            self.data[key] = np.array([], dtype=self.arrayDataTypes[key])
            self.safeAppend(key, workerData)

        self.voteGroup = self.data.get("voteGroup", 0)
        if "voteGroup" not in self.data:
            log.warning("%s: 'voteGroup' not defined -- assigning 0", self.workerId)

        assert len(self.data["data"]) == len(self.data["trust"]), \
            "data and trust lengths differ"

        self.head = 0
        self.tail = len(self.data["data"])
        self.timestampTimeOut = timestampTimeOut
        self.slaves = []  # per-consumer cursors
        self.activeSlave = None

    # ---------------- request accounting ----------------

    def clearDataRequestCounter(self):
        self._dataRequestCounter = 0

    def getDataRequestCounter(self):
        return self._dataRequestCounter

    # ---------------- pruning ----------------

    def removeOldData(self):
        """Drop buffered chunks older than ``timestampTimeOut``
        (reference softCombiner.py:188-232)."""
        while self.arrivalTimes[0]["time"] < time.time() - self.timestampTimeOut:
            if len(self.arrivalTimes) <= 1:
                break
            newHead = self.arrivalTimes[1]["idx"]
            for key in self.arrayKeyNames:
                self.data[key] = self.data[key][newHead:]

            for s in list(self.slaves):
                try:
                    if s.updateIdx(newHead) == -1:
                        log.info("slave %s timed out -- removing", s.workerId)
                        self.slaves.remove(s)
                except Exception as e:
                    log.error("error updating slave %s of %s", s.workerId, self.workerId)
                    log.exception(e)
                    self.slaves.remove(s)

            if self.slaves:
                self.head = min(s.head for s in self.slaves)
                self.tail = min(s.tail for s in self.slaves)
            elif self.head < newHead:
                log.warning("worker %s: removing more data than processed", self.workerId)
                self.head = 0
                self.tail -= newHead
            else:
                self.head -= newHead
                self.tail -= newHead

            for at in self.arrivalTimes[1:]:
                at["idx"] -= newHead
            self.arrivalTimes.pop(0)

    # ---------------- ingest ----------------

    def insertData(self, workerData):
        """Append a demodulator block dict (reference softCombiner.py:240-276)."""
        if self.workerId != workerData["workerId"]:
            raise WorkerIdError(
                f"data workerId {workerData['workerId']} does not match {self.workerId}"
            )

        now = time.time()
        self.arrivalTimes.append({"time": now, "idx": self.tail,
                                  "count": int(workerData.get("count", 0))})
        self.latestCount = int(workerData.get("count", self.latestCount))
        self.lastArrival = now

        if workerData["count"] - 1 > self.data.get("count", 0):
            log.warning(
                "Missing %d packets (last %s, current %s)",
                workerData["count"] - self.data.get("count", 0) - 1,
                self.data.get("count"), workerData["count"],
            )

        for key in self.keyNames:
            self.safeAdd(key, workerData)
        for key in self.arrayKeyNames:
            self.safeAppend(key, workerData)

        Ndata = len(self.data["data"])
        for s in self.slaves:
            s.updateTail(Ndata)
        self.tail = Ndata
        assert len(self.data["data"]) == len(self.data["trust"])

    # ---------------- serving ----------------

    def getData(self, idx=None):
        """All (or first ``idx``) buffered bits+trust."""
        if idx is None:
            return self.data["data"], self.data["trust"]
        if idx >= len(self.data["data"]):
            raise IndexError("index out of range")
        return self.data["data"][:idx], self.data["trust"][:idx]

    def updateIdx(self, idx, dataUsed=True):
        """Roll back the head by ``idx`` (data was peeked, not consumed)."""
        if self.activeSlave:
            self.activeSlave.head -= idx
        else:
            self.head -= idx
        if not dataUsed:
            self.getCount -= 1

    def getSelf(self, slaveId=None):
        """Serve unseen data (for ``slaveId``'s cursor, or the own head)
        plus the scalar telemetry (reference softCombiner.py:303-355)."""
        out = {"workerId": self.workerId}
        for key in self.keyNames:
            out[key] = self.safeGet(key)

        if slaveId:
            s = next((s for s in self.slaves if s.workerId == slaveId), None)
            if s is None:
                s = Slave(slaveId, self.head, self.tail)
                self.slaves.append(s)
            self.activeSlave = s
            for key in self.arrayKeyNames:
                out[key] = self.data[key][s.head : s.tail]
            if len(out["data"]) > 0:
                s.count += 1
                s.head = s.tail
        else:
            self.activeSlave = None
            for key in self.arrayKeyNames:
                out[key] = self.data[key][self.head : self.tail]
            # block count of each container overlapping the window,
            # keyed by its offset inside the window (frontier holds)
            out["countWindow"] = [
                (max(0, at["idx"] - self.head), at["count"])
                for at in self.arrivalTimes
                if at["idx"] < self.tail and "count" in at
            ]
            out["count"] = self.getCount
            if len(out["data"]) > 0:
                self.totalRequestCount += 1
                self._dataRequestCounter += 1
                self.getCount += 1
            self.head = self.tail
        return out

    def removeData(self, idx=None):
        """Truncate consumed data (reference softCombiner.py:358-397)."""
        if idx is None or idx == len(self.data["data"]):
            for key in self.arrayKeyNames:
                self.data[key] = np.array([], dtype=self.arrayDataTypes[key])
            self.head = 0
            self.tail = 0
            for s in self.slaves:
                s.resetHeadTail()
            return

        if idx > len(self.data["data"]):
            Ndata = len(self.data["data"])
            for key in self.arrayKeyNames:
                self.data[key] = np.array([], dtype=self.arrayDataTypes[key])
            self.head = 0
            self.tail = 0
            for s in self.slaves:
                s.resetHeadTail()
            raise IndexError(f"index {idx} out of range in array length {Ndata}")

        for key in self.arrayKeyNames:
            self.data[key] = self.data[key][idx:]
        for s in self.slaves:
            s.updateIdx(idx)
        self.head = min(s.head for s in self.slaves) if self.slaves else 0
        self.tail = min(s.tail for s in self.slaves) if self.slaves else len(self.data["data"])

    # ---------------- dict helpers ----------------

    def safeAdd(self, key, dataIn):
        if key in dataIn:
            try:
                self.data[key] = self.keyDataTypes[key](dataIn[key])
            except Exception as e:
                log.error("error while adding key %s", key)
                log.exception(e)
        elif self.showWarnings:
            log.warning("key %s not found for worker %s", key, dataIn.get("workerId"))

    def safeAppend(self, key, dataIn):
        if key in dataIn:
            self.data[key] = np.r_[
                self.data[key], np.asarray(dataIn[key], dtype=self.arrayDataTypes[key])
            ]
        elif self.showWarnings:
            log.warning("key %s not found for worker %s", key, dataIn.get("workerId"))

    def safeGet(self, key):
        if key in self.data:
            return self.data[key]
        if self.showWarnings:
            log.warning("key %s not found for worker %s", key, self.workerId)
        return []

    def __eq__(self, other):
        if isinstance(other, self.__class__):
            return self.workerId == other.workerId and self.timestamp == other.timestamp
        return False

    def __ne__(self, other):
        return not self.__eq__(other)
