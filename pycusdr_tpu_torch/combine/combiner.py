"""The SoftCombiner process: collect per-channel soft bits, align,
vote, forward to the decoder (the port's copy of
``pycusdr_tpu/combine/combiner.py``; host numpy, no device).

Capability parity with the reference ``SoftCombiner(Process)``
(``softCombiner.py:457-958``): ZMQ PULL of demodulator dicts, a
``Worker`` per channel, periodic all-pairs compare where every worker
takes a turn as *master* (so N copies of each stream reach the decoder
and its dedup/CRC picks survivors), xcorr alignment + N-way/2-way vote,
hold-back of unmatched data for ``workerDataRequestThreshold`` cycles
or ``MAX_DATA_LEN_BEFORE_TRANSMIT`` bits, worker timeout cleanup, and
an Event+Queue channel serving active-worker stats to the RPC thread.

The reference paces compares with a SIGALRM timer
(``softCombiner.py:841-849``); a monotonic-clock deadline inside the
poll loop gives the same cadence without signal handlers.
"""

import logging
import queue
import signal
import time
import multiprocessing

# spawn, never fork (see runtime/decoder_process)
_mp = multiprocessing.get_context("spawn")
Event, Process, Queue = _mp.Event, _mp.Process, _mp.Queue

import numpy as np
import zmq

from pycusdr_tpu_torch.combine.aligner import BufferAligner
from pycusdr_tpu_torch.combine.votes import do_vote2, do_voteN
from pycusdr_tpu_torch.combine.worker import Worker

log = logging.getLogger(__name__)

MAX_DATA_LEN_BEFORE_TRANSMIT = 6000  # bits (reference softCombiner.py:37)


class SoftCombiner(Process):
    def __init__(self, conf):
        Process.__init__(self)
        self.name = "softCombiner"
        self.conf = conf

        c = conf["SoftCombiner"]
        self.dataRequestThreshold = c["workerDataRequestThreshold"]
        self.demodInAddr = conf["Interfaces"]["Internal"]["demodIn"]
        self.decoderOutAddr = conf["Interfaces"]["Internal"]["decodeOut"]
        self.MIN_LENGTH = c["minProcessingLength"]
        self.pollingTimeout = c["pollingTimeout"]  # ms
        self.workerTimeout = c["workerTimeout"]  # s
        self.workerDataTimeout = c["workerDataTimeout"]  # s
        self.compareInterval = c["processingInterval"]  # s
        self.varMultiplier = c["varianceMultiplier"]
        self.masterVoteWeight = c["masterVoteWeight"]
        # recursive segmented alignment (beyond reference; see
        # combine/aligner.py): a window is voted at one lag only if its
        # halves independently confirm that lag; otherwise each side of
        # the slip is aligned on its own, down to alignMinSegment bits.
        # A match only counts if the aligned bits actually agree at
        # better than minSegmentAgreement (chance level is 0.5).
        self.alignMinSegment = c.get("alignMinSegment", 256)
        self.minSegmentAgreement = c.get("minSegmentAgreement", 0.7)
        # size valve for the hold-back of unmatched master data: the
        # reference hard-codes 6000 bits (softCombiner.py:37), sized for
        # real-time windows of ~1 block; channels that stall and burst
        # (shared-host simulation, batched catch-up) need more headroom
        # or burst windows get forwarded unvoted the moment they appear
        self.maxHoldBits = c.get("maxHoldBits", MAX_DATA_LEN_BEFORE_TRANSMIT)
        self.logLevel = log.getEffectiveLevel()

        self.getWorkerStatsFlag = Event()
        # set once the ZMQ sockets are bound: spawn-start takes ~1-2 s
        # (interpreter boot), so senders should wait on this instead of
        # sleeping — a burst backlog landing on a freshly-booted
        # combiner makes the first vote round span whole buffers
        self.ready = Event()
        self.workersSubmittedToRPCQueue = Queue()

        self.daemon = True
        self.runStatus = Event()
        self.runStatus.set()
        log.info("Starting SoftCombiner")

    def stop(self):
        log.info("Received request to stop")
        self.runStatus.clear()

    def getActiveWorkers(self, timeout=0.15):
        """Names of workers that submitted since the last query (serves
        the RPC thread; reference softCombiner.py:505-525)."""
        while not self.workersSubmittedToRPCQueue.empty():
            try:
                self.workersSubmittedToRPCQueue.get(False)
            except queue.Empty:
                break
        self.getWorkerStatsFlag.set()
        try:
            return self.workersSubmittedToRPCQueue.get(True, timeout=timeout)
        except queue.Empty:
            log.warning("querying active workers timed out -- returning empty list")
            return []

    # ---------------- ingest ----------------

    def receiveData(self, demodIn):
        data = demodIn.recv_pyobj(zmq.DONTWAIT)
        workerId = data.get("workerId")
        if workerId is None:
            log.error("Invalid data format: expected 'workerId'")
            return
        for worker in self.workers:
            if worker.workerId == workerId:
                worker.insertData(data)
                if worker not in self.workersSubmitted:
                    self.workersSubmitted.append(worker)
                return
        log.debug("registering new worker %s", workerId)
        worker = Worker(data, timestampTimeOut=self.workerDataTimeout)
        self.workers.append(worker)
        self.workersSubmitted.append(worker)

    def _purge_superseded(self):
        """Drop dead planned-restart generations.

        The orchestrator's make-before-break restart re-registers a
        channel as ``base~rN``; the older generation of the same base
        talks only through the short overlap window and is then dead
        forever. Purge any worker whose base has a NEWER generation
        registered once it has been silent past the data timeout (plus
        margin), or a long capped soak grows one dead Worker per
        restart and compareWorkers iterates (and the overlap window
        double-weights) dead channels indefinitely."""
        if len(self.workers) < 2:
            return
        latest = {}  # base -> newest generation index seen
        def gen(wid):
            base, _, suf = wid.partition("~r")
            try:
                return base, int(suf) if suf else 0
            except ValueError:
                return wid, 0
        for w in self.workers:
            base, g = gen(w.workerId)
            latest[base] = max(latest.get(base, 0), g)
        now = time.time()
        silence = max(10.0, 2 * self.workerDataTimeout)
        keep = []
        for w in self.workers:
            base, g = gen(w.workerId)
            if g < latest[base] and now - w.lastArrival > silence:
                log.info("purging superseded worker generation %s",
                         w.workerId)
                if w in self.workersSubmitted:
                    self.workersSubmitted.remove(w)
            else:
                keep.append(w)
        self.workers[:] = keep

    # ---------------- compare ----------------

    def _align_track(self, bitsM, bitsT, trustT):
        """Build one slave's aligned track against the master window.

        Slip-aware alignment: the window is aligned at the strongest
        xcorr lag, then *verified* chunk-by-chunk (``alignMinSegment``
        bits) against measured bit agreement; chunks below
        ``minSegmentAgreement`` (chance level is 0.5) are masked out
        and each contiguous masked gap is re-aligned at its own lag.
        An inter-channel bit slip therefore only costs the vote ~one
        chunk around the slip point, where the reference's single
        whole-window lag silently mis-votes everything on the far side
        of the slip (softCombiner.py:703-726).

        Returns (track, ttrack, covered, pending) or None if nothing
        matched; unmatched spans carry trust −1, which the vote kernels
        treat as per-bit disqualification. ``pending`` means the slave
        buffer physically ends before this window's projected end — its
        tail data hasn't arrived from that channel yet.
        """
        nM, nT = len(bitsM), len(bitsT)
        ch = self.alignMinSegment
        aligner = BufferAligner(bitsT, self.varMultiplier)
        track = np.zeros(nM, dtype=bitsM.dtype)
        ttrack = np.full(nM, -1, dtype=trustT.dtype)
        covered = np.zeros(nM, bool)
        proj = {"a": -1, "end": 0}  # window-end projection of last piece

        def apply(a, b, lag):
            cand = bitsT[lag : lag + (b - a)]
            nc = len(cand)
            if nc == 0:
                return False
            good = False
            gaps = []  # chunks that failed verification, merged
            for x in range(0, nc, ch):
                y = min(x + ch, nc)
                agree = float(np.mean(cand[x:y] == bitsM[a + x : a + y]))
                if agree >= self.minSegmentAgreement:
                    track[a + x : a + y] = cand[x:y]
                    ttrack[a + x : a + y] = trustT[lag + x : lag + y]
                    covered[a + x : a + y] = True
                    good = True
                elif gaps and gaps[-1][1] == a + x:
                    gaps[-1][1] = a + y
                else:
                    gaps.append([a + x, a + y])
            if not good:
                return False
            if a > proj["a"]:
                proj["a"], proj["end"] = a, lag + nM - a
            # a failed span usually means the piece's lag is wrong
            # there (a slip): give each gap its own lag. Gaps are
            # strictly smaller than [a, b), so this terminates.
            for ga, gb in gaps:
                if gb - ga >= ch:
                    align(ga, gb)
            return True

        budget = {"n": 48}  # xcorr attempts per track (noise windows)

        def align(a, b, depth=0):
            if b - a < ch // 2 or budget["n"] <= 0:
                return False
            budget["n"] -= 1
            lag, ok = aligner.match(bitsM[a:b])
            got = apply(a, b, lag) if ok else False
            if not got and depth < 3 and b - a >= 2 * ch:
                # no usable lag for the whole span (a slip straddling
                # the middle, or a false global peak on a burst
                # window): let each half find its own peak
                mid = (a + b) // 2
                g1 = align(a, mid, depth + 1)
                return align(mid, b, depth + 1) or g1
            return got

        if nT == 0 or not align(0, nM):
            return None
        return track, ttrack, covered, proj["end"] > nT

    def correlate(self, master, slaves):
        """One master-vs-slaves round (reference softCombiner.py:665-798).

        Returns the combined data dict to forward, or None to wait.

        Beyond-reference behavior: slip-aware recursive alignment per
        slave (see ``_align_track``). If a slave's buffer simply hasn't
        received the window tail yet, the tail is rolled back and
        re-voted next round (the segmented analog of the reference's
        shrink-to-match, softCombiner.py:739-749).
        """
        dataM = master.getSelf()
        if len(dataM["data"]) == 0:
            return None

        bitsM, trustM = dataM["data"], dataM["trust"]
        nM = len(bitsM)
        if (nM < self.MIN_LENGTH
                and master.getDataRequestCounter() < self.dataRequestThreshold):
            # window too short to align reliably: wait for more data
            # (reference's short-match retry, softCombiner.py:735-737)
            master.updateIdx(nM, dataUsed=False)
            return None

        group = [s for s in slaves if s.voteGroup == master.voteGroup]

        # frontier hold (beyond reference): every container carries the
        # demodulator's block count, and channels in a vote group
        # demodulate the same stream, so counts are comparable. Any
        # window bits produced after the slowest *live* slave's latest
        # count cannot be voted yet — hold exactly those instead of
        # forwarding them unvoted (the reference has no notion of
        # channel skew; its windows are assumed real-time-small)
        pend_off = nM
        cw = dataM.pop("countWindow", None)
        if cw and group:
            now = time.time()
            for s in group:
                if now - s.lastArrival > self.workerDataTimeout:
                    continue  # stale channel: don't wait for it
                if s.latestCount < cw[0][1] - 100:
                    continue  # desynced counter (restarted channel)
                off = next((o for o, c in cw if c > s.latestCount), nM)
                pend_off = min(pend_off, off)

        bitsS, trustS, nameS = [], [], []
        covered = np.zeros(nM, bool)
        proj_pending = False  # a slave buffer ends inside our window

        for s in group:
            bitsT, trustT = s.getData()
            nT = len(bitsT)
            got = self._align_track(bitsM, bitsT, trustT)
            if log.isEnabledFor(logging.DEBUG):
                log.debug(
                    "align master %s (%d bits) vs slave %s (%d buffered): "
                    "%s covered",
                    master.workerId, nM, s.workerId, nT,
                    f"{got[2].mean():.2f}" if got else "nothing",
                )
            if got is None:
                continue
            track, ttrack, cov, pending = got
            covered |= cov
            proj_pending = proj_pending or pending
            bitsS.append(track)
            trustS.append(ttrack)
            nameS.append(s.workerId)

        if not bitsS:
            if pend_off < nM and nM - pend_off <= self.maxHoldBits:
                # the pending tail is data no live slave has produced
                # yet: hold it (without consuming the lone-master
                # counter — the frontier *knows* a slave is coming);
                # anything older failed alignment (noise): forward it
                # unvoted
                if pend_off == 0:
                    master.updateIdx(nM, dataUsed=False)
                    return None
                master.updateIdx(nM - pend_off)
                for key in ("data", "trust"):
                    dataM[key] = dataM[key][:pend_off]
            elif nM > self.maxHoldBits:
                # nothing aligned: hold the data unless it has waited
                # long enough or grown too large
                log.debug("too many unprocessed bits -- sending unvoted")
            elif master.getDataRequestCounter() < self.dataRequestThreshold:
                master.updateIdx(nM, dataUsed=False)
                return None
        else:
            lastCovered = int(np.nonzero(covered)[0][-1]) + 1
            # vote up to what's covered; hold what the slowest live
            # channel hasn't produced yet (bits in between failed
            # alignment against data the slaves do have — forward them)
            if pend_off < nM:
                hold_from = max(lastCovered, pend_off)
            elif proj_pending:
                hold_from = lastCovered
            else:
                hold_from = nM
            tail = nM - hold_from
            if 0 < tail <= self.maxHoldBits and hold_from > 0:
                master.updateIdx(tail)
                bitsM, trustM = bitsM[:hold_from], trustM[:hold_from]
                bitsS = [t[:hold_from] for t in bitsS]
                trustS = [t[:hold_from] for t in trustS]

        if len(bitsS) > 1:
            bitsM, trustM = do_voteN(bitsM, trustM, bitsS, trustS, self.masterVoteWeight)
            dataM["data"], dataM["trust"] = bitsM, trustM
        elif len(bitsS) == 1:
            bitsM, trustM = do_vote2(bitsM, trustM, bitsS[0], trustS[0])
            dataM["data"], dataM["trust"] = bitsM, trustM

        master.clearDataRequestCounter()
        dataM["numSlaves"] = len(bitsS)
        dataM["slaveNames"] = nameS
        return dataM

    def compareWorkers(self):
        """Every worker takes a turn as master (softCombiner.py:807-838)."""
        for m in range(len(self.workers)):
            slaves = self.workers.copy()
            master = slaves.pop(m)
            data = self.correlate(master, slaves)
            if data is not None:
                try:
                    self.decodeOut.send_pyobj(data, zmq.NOBLOCK)
                except zmq.error.Again as e:
                    log.error("Failed to send data. Message [%s]", e)
        for m in self.workers:
            m.removeOldData()

    # ---------------- main loop ----------------

    def run(self):
        from pycusdr_tpu_torch.utils.logger import child_logger_setup

        child_logger_setup(self.logLevel)
        time.sleep(0.5)
        ctx = zmq.Context()
        log.info("Registering demodulator input socket on %s", self.demodInAddr)
        demodIn = ctx.socket(zmq.PULL)
        demodIn.setsockopt(zmq.LINGER, 0)
        demodIn.bind(self.demodInAddr)

        log.info("Registering decoder output socket on %s", self.decoderOutAddr)
        self.decodeOut = ctx.socket(zmq.PUSH)
        self.decodeOut.connect(self.decoderOutAddr)
        self.ready.set()

        poller = zmq.Poller()
        poller.register(demodIn, zmq.POLLIN)

        self.workers = []
        self.workersSubmitted = []
        timeoutCount = 0.0
        nextCompare = time.monotonic() + self.compareInterval

        orig_sigterm = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, lambda *_: None)  # parent coordinates shutdown
        log.info(
            "SoftCombiner running: poll %s ms, worker timeout %s s, interval %s s",
            self.pollingTimeout, self.workerTimeout, self.compareInterval,
        )
        try:
            while self.runStatus.is_set():
                socks = poller.poll(self.pollingTimeout)
                if socks and socks[0][1] == zmq.POLLIN:
                    self.receiveData(demodIn)
                    timeoutCount = 0.0
                else:
                    timeoutCount += self.pollingTimeout / 1000.0
                    if timeoutCount > self.workerTimeout:
                        if self.workers:
                            log.info("Input silent %.1f s -- cleaning up workers", timeoutCount)
                            self.workers.clear()
                            self.workersSubmitted = []
                        timeoutCount = 0.0

                if time.monotonic() >= nextCompare and self.runStatus.is_set():
                    nextCompare = time.monotonic() + self.compareInterval
                    self._purge_superseded()
                    self.compareWorkers()

                if self.getWorkerStatsFlag.is_set():
                    self.getWorkerStatsFlag.clear()
                    names = [w.workerId for w in self.workersSubmitted]
                    log.info("Active workers: %s", names)
                    self.workersSubmittedToRPCQueue.put(names)
                    self.workersSubmitted = []
        except Exception as e:
            log.exception(e)
            raise
        finally:
            log.info("shutting down")
            self.workersSubmittedToRPCQueue.close()
            self.decodeOut.close()
            demodIn.close()
            signal.signal(signal.SIGTERM, orig_sigterm)
            log.info("closed")
