"""IQ sample ingest: ZMQ SUB + re-blocking ring buffer.

Capability parity with the reference ``sigFIFO`` (``pyCuSDR/sigFIFO.py``):
GNU Radio publishes complex64 chunks of arbitrary size; ``RingBuffer``
re-blocks them into exact demodulator hop sizes (flush-on-overflow),
and ``SigFIFO.getBlock`` polls with timeout/retry semantics, raising
``TimeoutError`` so the demod process can detect that the radio
front-end went away. A copy of ``pycusdr_tpu/runtime/sigfifo.py``: the
SigFIFO takes the C++ ring (``native.NativeRingBuffer``) when the native
library is there, else this numpy ``RingBuffer``; each counts its inserts
in ``native.counts["ring"]``.
"""

import logging
import sys

import numpy as np
import zmq

from pycusdr_tpu_torch import native

log = logging.getLogger(__name__)


class RingBuffer:
    """Fixed-size circular sample buffer (reference sigFIFO.py:13-104)."""

    def __init__(self, outLen, bufLen=None, dtype=np.complex64):
        self.outLen = outLen
        if bufLen is None:
            bufLen = 10 * outLen
        elif bufLen < outLen:
            raise IndexError("bufLen < outLen", "buffer too small for output block")
        self.bufLen = bufLen
        self.dtype = dtype
        self.buf = np.empty(self.bufLen, dtype=dtype)
        self.headIdx = 0
        self.tailIdx = 0
        self.currentBufSize = 0

    def insert(self, data):
        """Append; on overflow the whole buffer is flushed (the stream
        is real-time — stale samples are worthless)."""
        native.counts["ring"][1] += 1
        if data.dtype != self.dtype:
            log.error("wrong datatype, expected %s", self.dtype)
            data = data.astype(self.dtype)
        N = len(data)
        if N > self.bufLen:
            # network chunk bigger than the whole ring: keep the newest
            # samples (real-time stream -- old data is worthless)
            log.error("chunk of %d > buffer %d: keeping tail", N, self.bufLen)
            data = data[-self.bufLen :]
            N = self.bufLen
        if self.currentBufSize + N > self.bufLen:
            log.error("buffer full: flush")
            self.flush()

        bufEnd = N + self.headIdx
        if bufEnd > self.bufLen:
            Nmid = self.bufLen - self.headIdx
            self.buf[self.headIdx :] = data[:Nmid]
            self.headIdx = N - Nmid
            self.buf[: self.headIdx] = data[Nmid:]
        else:
            self.buf[self.headIdx : bufEnd] = data
            self.headIdx = bufEnd
        self.currentBufSize += N
        return self.currentBufSize

    def popBlock(self, noSamples):
        """Return exactly ``noSamples`` or [] if not enough buffered."""
        if self.currentBufSize < noSamples:
            return []
        popEnd = self.tailIdx + noSamples
        if popEnd > self.bufLen:
            data = np.empty(noSamples, dtype=self.dtype)
            Nmid = self.bufLen - self.tailIdx
            data[:Nmid] = self.buf[-Nmid:]
            self.tailIdx = noSamples - Nmid
            data[Nmid:] = self.buf[: self.tailIdx]
        else:
            # copy: returning a view would let later inserts overwrite
            # a popped block the caller is still holding
            data = self.buf[self.tailIdx : popEnd].copy()
            self.tailIdx = 0 if popEnd == self.bufLen else popEnd
        self.currentBufSize -= noSamples
        return data

    def flush(self):
        self.headIdx = 0
        self.tailIdx = 0
        self.currentBufSize = 0


class SigFIFO:
    """ZMQ SUB sample source with timeout semantics
    (reference sigFIFO.py:108-181)."""

    def __init__(self, socket, reqDataSize, dtype=np.complex64, timeOut_ms=1000,
                 exitOnTimeout=False, enableTimeoutException=False,
                 timeoutRetries=120, runStatus=None):
        self.blockSize = reqDataSize
        self.dtype = dtype
        self.timeoutRetries = timeoutRetries
        self.runStatus = runStatus

        log.debug("Configuring RX socket: %s", socket)
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.SUB)
        try:
            self.socket.connect(socket)
            self.socket.setsockopt_string(zmq.SUBSCRIBE, "")
            self.poller = zmq.Poller()
            self.poller.register(self.socket, zmq.POLLIN)
        except Exception as e:
            log.error("Exception connecting to RX socket:")
            log.exception(e)

        # 4 hops of headroom (the reference uses 2; a little more slack
        # tolerates scheduling jitter without changing semantics).
        # The C++ ring buffer is preferred when built (native/).
        if dtype == np.complex64 and native.AVAILABLE:
            self.buf = native.NativeRingBuffer(self.blockSize, bufLen=self.blockSize * 4)
        else:
            self.buf = RingBuffer(self.blockSize, bufLen=self.blockSize * 4, dtype=dtype)
        self.timeOut_ms = timeOut_ms
        self.exitOnTimeout = exitOnTimeout
        self.raiseExceptionOnTimeout = enableTimeoutException

    def close(self):
        """Close the SUB socket without lingering and end its context."""
        self.socket.close(linger=0)
        self.context.term()

    def getBlock(self):
        """Block until a full hop of samples is available.

        Raises TimeoutError after ``timeoutRetries`` empty polls (or
        immediately when runStatus is cleared) so the caller can detect
        the front-end going away (reference sigFIFO.py:147-181).
        """
        data = []
        timeoutCount = 0
        while len(data) == 0:
            evts = self.poller.poll(self.timeOut_ms)
            if len(evts) > 0:
                timeoutCount = 0
                rawBytes = self.socket.recv()
                self.buf.insert(np.frombuffer(rawBytes, dtype=self.dtype))
            else:
                log.debug("ZMQ poll timed out")
                timeoutCount += 1
                if self.runStatus is not None and not self.runStatus.is_set():
                    raise TimeoutError("Terminated")
                if timeoutCount > self.timeoutRetries:
                    if self.raiseExceptionOnTimeout:
                        raise TimeoutError("ZMQ poll timed out")
                    if self.exitOnTimeout:
                        log.info("Exiting....")
                        sys.exit()
            data = self.buf.popBlock(self.blockSize)
        return data

    def idle(self):
        """True when the next ``getBlock`` would have to wait: no full
        hop buffered and nothing pending on the socket. Used by the
        pipelined streaming paths to drain in-flight results the moment
        the feed pauses."""
        if self.buf.currentBufSize >= self.blockSize:
            return False
        return len(self.poller.poll(0)) == 0

    def getBlocks(self, max_n: int = 1):
        """One blocking block plus up to ``max_n - 1`` more that are
        already buffered (no extra waiting) — lets the demodulator batch
        several hops into one device dispatch when it falls behind.

        Pops eagerly between single-message inserts: draining the whole
        socket backlog first would overflow the ring (it holds only a
        few hops) and flush-drop samples mid-packet."""
        out = [self.getBlock()]
        while len(out) < max_n:
            nxt = self.buf.popBlock(self.blockSize)
            if len(nxt):
                out.append(nxt)
                continue
            evts = self.poller.poll(0)
            if not evts:
                break
            self.buf.insert(np.frombuffer(self.socket.recv(), dtype=self.dtype))
        return out
