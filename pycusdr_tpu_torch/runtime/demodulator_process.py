"""Per-channel Rx process: stream blocks from ZMQ into the demod graph on
the card and ship soft bits downstream.

The port of ``pycusdr_tpu/runtime/demodulator_process.py``. Capability
parity with the reference ``Demodulator_process``
(``pyCuSDR/demodulator_process.py``): overlap-save staging buffer,
per-block worker dict with the same keys, Tx/Rx IF offset + rangerate
computation, spSym-gated running stats behind locked
``multiprocessing.Value`` properties for the RPC thread, optional
duplicate PUSH to an external (remote) decoder, and GRC-timeout
signalling via an Event. The CUDA context and the kernels are created
INSIDE the child process, as the reference's per-process CUDA context
(``demodulator_process.py:242``); the child runs on the device
``globals.torch_device`` names (the card unless ``PYCUSDR_TORCH_DEVICE``
says "cpu") and reports it in ``device``, and its kernel launches since
it was warm in ``launches`` (``ops.launch_counts``, published after every
block it ships, with the count of those blocks in ``blocks`` and the card
memory it holds in ``card_memory``), and its ``native.AVAILABLE`` and
native and numpy calls (the SigFIFO ring's inserts among them) in
``native_counts``.
"""

import logging
import multiprocessing
import signal
import sys
import time

import numpy as np
import scipy.constants

from pycusdr_tpu_torch import native, ops

# The demodulator child owns a CUDA context, which a forked child cannot
# inherit, so this process uses the spawn start method.
_mp = multiprocessing.get_context("spawn")
Array, Event, Process, Value = _mp.Array, _mp.Event, _mp.Process, _mp.Value

log = logging.getLogger(__name__)

TOLVAL = 0.5  # spSym tolerance gating the running stats


def radioBackendVoteGroupIDX(radioBackend):
    """Map a radio backend name to (backend module name, vote group)
    (reference demodulator_process.py:21-36). Returns the module NAME so
    the mapping stays picklable for the spawn start method; the module
    itself is resolved inside the child (``_resolve_backend``)."""
    table = {"UHF": ("UHF", 0), "STX": ("STX", 1), "STX1": ("STX", 2), "STX2": ("STX", 3)}
    if radioBackend not in table:
        raise Exception(f"radioBackend {radioBackend} not defined in voteGroup")
    return table[radioBackend]


def _resolve_backend(name):
    from pycusdr_tpu_torch import models

    return getattr(models, name)


#: the card memory a child publishes (``Demodulator_process.card_memory``)
CARD_MEMORY = ("reserved", "max_allocated")


def card_memory() -> dict:
    """This process's card memory in bytes: its allocator's reservation and
    its tensors' peak."""
    import torch

    return {"reserved": int(torch.cuda.memory_reserved()),
            "max_allocated": int(torch.cuda.max_memory_allocated())}


def child_device(device_value):
    """In a spawned child: one intra-op thread (a station runs one child
    per channel), the device from ``globals.torch_device``, written into
    the shared ``device_value`` Array for the parent to read."""
    import torch

    from pycusdr_tpu_torch.globals import torch_device

    torch.set_num_threads(1)
    dev = torch_device()
    device_value.value = dev.type.encode()
    return dev


class Demodulator_process(Process):
    def __init__(self, conf, protocol, radio):
        Process.__init__(self)
        # host ms per block, averaged in the child, readable by the parent
        self._timeMA = Value("d", 0.0)
        self.iterCount = 0

        worker_radio_name = conf["Radios"]["Rx"][radio].get("name", radio)
        self.radioName = radio
        self.conf = conf
        self.protocol = protocol
        self.confRadio = confRadio = conf["Radios"]["Rx"][radio]
        self.confGPU = confGPU = conf["GPU"][confRadio["CUDA_settings"]]

        self.overlap = 2 ** confGPU["overlap"]
        self.blockSize = 2 ** confGPU["blockSize"]
        self.samplesPerSlice = self.blockSize - self.overlap
        log.info("[%s]: Block size %d samples, overlap %d samples",
                 radio, self.blockSize, self.overlap)

        logInfo = conf.get("LogInfo", {})
        self.PRINT_ALWAYS = logInfo.get("demodulator_print_always", False)
        self.PRINT_NTH_BLOCK = logInfo.get("demodulator_print_interval", 5)
        self.PRINT_THRESHOLD_ENABLED = logInfo.get("demodulator_print_threshold_enabled", False)
        self.PRINT_THRESHOLD_LVL = logInfo.get("demodulator_print_threshold_lvl", 4)

        self.baudRate = confRadio["baud"]
        self.spSym = confRadio["samplesPerSym"]
        self.sigFIFOTimeout = conf.get("Demodulator", {}).get("timeoutSeconds", 120)

        self.name = f"demod-{radio}"
        interfaces = confRadio.get("Interfaces", {})
        if "RxInPort" in interfaces:
            self.RxInAddr = interfaces["RxInPort"]
        elif "RxInPort" in confRadio:
            self.RxInAddr = confRadio["RxInPort"]
        else:
            raise KeyError(f"[{radio}]: no Rx input channel defined")

        self.workerId = conf["Main"]["workerId"] + "-" + worker_radio_name
        self.radioBackend = confRadio["radioBackend"]
        self.demodulatorName = radioBackendVoteGroupIDX(self.radioBackend)[0]
        self.voteGroup = radioBackendVoteGroupIDX(
            confRadio.get("voteGroup", self.radioBackend)
        )[1]
        self.decoderProtocol = confRadio.get("Protocol", "None")

        if "demodOut" in interfaces:
            self.demodOutAddr = interfaces["demodOut"]
        else:
            self.demodOutAddr = conf["Interfaces"]["Internal"]["demodOut"]

        # optional duplicate stream to a remote decoder on another host
        self.demodOutAddrClient = interfaces.get("demodOutExternal")
        self.client = self.demodOutAddrClient is not None

        # monitored values readable/settable across processes (RPC)
        self.__rangerate = Value("f", 1)
        self.__Fc = Value("d", float(confRadio["frequency_Hz"] - confRadio["frequencyOffset_Hz"]))
        txconf = conf["Radios"].get("Tx", {})
        if isinstance(txconf, dict) and "frequency_Hz" in txconf:
            self.TxFc = txconf["frequency_Hz"]
        else:
            self.TxFc = self.__Fc.value
        self.__Fs = Value("d", float(self.baudRate * self.spSym))
        self.__TxRangeRate = Value("f", 0)
        self.__RxIFFreqOffset = Value("f", 0)
        self.__TxIFFreqOffset = Value("f", 0)
        self.__SNR = Value("f", 0)
        self.__RxFreqOffset = Value("f", 0)
        self.__baudRateEst = Value("f", 0)

        self.daemon = True
        self.runStatus = Event()
        self.runStatus.set()
        self.GRCTimeoutFlag = Event()
        # warmedFlag is set once the kernels are built and every graph
        # has run, BEFORE the SigFIFO subscribes; a caller may clear
        # subscribeGate before start() to hold the child at that point
        # (the JAX package's make-before-break restarts use the pair)
        self.warmedFlag = Event()
        self.subscribeGate = Event()
        self.subscribeGate.set()
        self._device = Array("c", 16)  # the child's torch device type
        # the child's kernel launches since it was warm, then its blocks
        # shipped, then its card memory (``card_memory``)
        self._kernels = tuple(ops.kernel_wrappers())
        self._launches = Array("q", len(self._kernels) + 1 + len(CARD_MEMORY))
        self._native = native.shared_counts(_mp)
        self.logLevel = log.getEffectiveLevel()
        log.info("[%s]: Demodulator process initialized", radio)

    def stop(self):
        log.info("PID %s -- received request to stop", self.pid)
        self.runStatus.clear()

    def GRCTimeout(self):
        return self.GRCTimeoutFlag.is_set()

    @property
    def device(self):
        """The child's torch device type ("cuda" or "cpu"); "" until it
        has started."""
        return self._device.value.decode()

    @property
    def launches(self) -> dict:
        """Kernel name -> the child's launches since it was warm (its
        warm-up's launches are not counted)."""
        return dict(zip(self._kernels, self._launches[:len(self._kernels)]))

    @property
    def blocks(self) -> int:
        """Blocks the child has shipped since it was warm."""
        return self._launches[len(self._kernels)]

    @property
    def card_memory(self) -> dict:
        """The child's card memory in bytes when it last shipped a block:
        ``reserved`` (``torch.cuda.memory_reserved``, what its allocator
        holds) and ``max_allocated`` (``torch.cuda.max_memory_allocated``,
        its tensors' peak); 0 on the CPU. In a container every process can
        read as the same pid to ``nvidia-smi``, so the child publishes them."""
        at = len(self._kernels) + 1
        return dict(zip(CARD_MEMORY, self._launches[at:at + len(CARD_MEMORY)]))

    @property
    def native_counts(self) -> dict:
        """The child's ``native.AVAILABLE`` and its native and numpy calls
        of each binding (``native.read``), published with ``launches``."""
        return native.read(self._native)

    def _publish_launches(self, counts: dict) -> None:
        """Publish ``counts`` (kernel name -> launches), one more block
        shipped, and the card memory."""
        memory = card_memory() if self.device == "cuda" else dict.fromkeys(CARD_MEMORY, 0)
        with self._launches.get_lock():
            for i, name in enumerate(self._kernels):
                self._launches[i] = counts[name]
            at = len(self._kernels)
            self._launches[at] += 1
            for i, key in enumerate(CARD_MEMORY):
                self._launches[at + 1 + i] = memory[key]
        native.publish(self._native)

    @property
    def timeMA(self):
        """Running mean of the host seconds per block (fetch wait +
        post-processing; the batched path's per-block share)."""
        return self._timeMA.value

    @timeMA.setter
    def timeMA(self, t):
        self._timeMA.value = float(t)

    def computeMATime(self, t):
        self.iterCount += 1
        self.timeMA = self.timeMA + (t - self.timeMA) / self.iterCount
        return self.timeMA

    # ---------------- main loop (child process) ----------------

    def run(self):
        import zmq  # contexts must be created in the child

        from pycusdr_tpu_torch.runtime import sigfifo
        from pycusdr_tpu_torch.utils.logger import child_logger_setup

        # spawn children start with an unconfigured logger (fresh
        # interpreter): attach a console handler at the parent's level
        child_logger_setup(self.logLevel)

        time.sleep(0.5)
        self.GRCTimeoutFlag.clear()

        maxBatch = self.confGPU.get("TPU", {}).get("maxBatchBlocks", 4)
        try:
            # the CUDA context and the kernels live in THIS process
            dev = child_device(self._device)
            backend = _resolve_backend(self.demodulatorName)
            demod = backend.Demodulator(self.conf, self.protocol, self.radioName, device=dev)

            # Build the kernels and run every graph shape this loop can
            # dispatch BEFORE the SUB socket subscribes: a first call
            # compiles the kernels (nvcc) and fills the allocator caches,
            # and samples arriving meanwhile would overflow the ring.
            t0 = time.time()
            demod.warmup()  # single-block (pipelined) path
            if maxBatch > 1:
                # the batched backlog path
                demod.processMany(
                    np.zeros((maxBatch, self.samplesPerSlice), np.complex64))
                demod.get_signalBufferHostPointer()[:] = 0
            log.info("[%s]: kernels built + graphs warmed on %s in %.1f s "
                     "(pre-subscribe)", self.radioName, dev, time.time() - t0)
        except Exception as e:
            log.exception(e)
            raise

        # the launches counted from here on are the feed's
        ops.reset_launches()
        # hold point: graphs are warm, nothing is subscribed yet (a caller
        # may clear subscribeGate before start() to hold the child here)
        self.warmedFlag.set()
        while not self.subscribeGate.wait(0.2):
            if not self.runStatus.is_set():
                return

        # the sockets connect once the child is warm: by then the decoder
        # has bound its input, so a connect is not left retrying against a
        # port that nothing listens on yet
        ctx = zmq.Context()
        log.info("[%s]: Configuring demodulator output socket: %s",
                 self.radioName, self.demodOutAddr)
        demodOut = ctx.socket(zmq.PUSH)
        demodOut.setsockopt(zmq.LINGER, 0)
        demodOut.connect(self.demodOutAddr)

        demodOutClient = None
        if self.client:
            log.info("[%s]: Configuring remote output socket: %s",
                     self.radioName, self.demodOutAddrClient)
            demodOutClient = ctx.socket(zmq.PUSH)
            demodOutClient.setsockopt(zmq.LINGER, 1000)
            demodOutClient.connect(self.demodOutAddrClient)

        try:
            sigIn = sigfifo.SigFIFO(
                self.RxInAddr, self.samplesPerSlice, dtype=np.complex64,
                enableTimeoutException=True, timeoutRetries=self.sigFIFOTimeout,
                runStatus=self.runStatus,
            )
        except Exception as e:
            log.exception(e)
            demodOut.close()
            if demodOutClient is not None:
                demodOutClient.close()
            ctx.term()
            raise

        count = 0
        raw = demod.get_signalBufferHostPointer()

        data = {
            "workerId": self.workerId, "count": 0, "timestamp": 0,
            "voteGroup": self.voteGroup, "doppler": 0, "doppler_std": 0,
            "data": np.array([]), "trust": np.array([]), "spSymEst": 0,
            "SNR": 0.0, "rangerateEst": 0, "baudRate": self.baudRate,
            "baudRate_est": 0, "sample_rate": self.Fs,
            "protocol": self.decoderProtocol,
        }

        log.info("[%s]: Demodulator process running", self.radioName)
        orig_sigterm = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, lambda *_: None)
        # pipelineDepth >= 2 keeps depth-1 blocks in flight on the
        # device: block k is dispatched (async) before block k-1's
        # results are fetched, so device compute and the dispatch/fetch
        # round trip hide behind host post-processing and the wait for
        # the next hop. Results ship one block later; steering stats
        # (Doppler -> rangerate) lag by the same one block, which is
        # well inside the tracking loop's smoothing window. Depth 1
        # (default) is the reference's synchronous per-block semantics.
        pipelineDepth = self.confGPU.get("TPU", {}).get("pipelineDepth", 1)
        def ship(d):
            try:
                # NOBLOCK: a stalled combiner/decoder must drop blocks,
                # not wedge the demodulator (real-time)
                demodOut.send_pyobj(d, zmq.NOBLOCK)
            except zmq.error.Again as e:
                log.error("[%s]: failed to send to decoder [%s]", self.radioName, e)
            if demodOutClient is not None:
                try:
                    demodOutClient.send_pyobj(d, zmq.NOBLOCK)
                except zmq.error.Again as e:
                    log.warning("[%s]: failed to send to external decoder [%s]",
                                self.radioName, e)

        from pycusdr_tpu_torch.runtime.pipeline import InflightPipeline

        def ship_result(res, cnt, timeStamp):
            """One result dict -> the wire schema, stats, and the PUSH
            socket. Shared by the per-block and batched paths so the
            output schema cannot diverge between them."""
            data["timestamp"] = timeStamp
            data["count"] = cnt
            data["doppler"] = res["doppler"]
            data["doppler_std"] = res["doppler_std"]
            data["SNR"] = res["SNR"]
            data["data"] = res["bits"]
            data["trust"] = res["trust"]
            data["spSymEst"] = res["spSymEst"]
            data["baudRate_est"] = self.Fs / max(res["spSymEst"], 1e-9)
            TxFreqOffset, _RxFreqOffset, data["rangerate"] = self.computeTxFreqOffset(
                res["doppler"], res["spSymEst"]
            )
            self.SNRStats(res["SNR"], res["spSymEst"])
            ship(data)
            self._publish_launches(ops.launch_counts())
            return TxFreqOffset

        def emit(handle, timeStamp, cnt):
            """Collect one in-flight block's device results and ship."""
            t0 = time.time()
            res = demod.collect(handle)
            TxFreqOffset = ship_result(res, cnt, timeStamp)

            # host cost of this block: fetch wait + post-processing
            # (in pipelined mode the device computed while we were away)
            timeSpend = time.time() - t0
            self.computeMATime(timeSpend)
            printStats = (self.PRINT_THRESHOLD_ENABLED
                          and float(data["SNR"]) > self.PRINT_THRESHOLD_LVL)
            if (log.getEffectiveLevel() < logging.INFO
                    or cnt % self.PRINT_NTH_BLOCK == 0
                    or self.PRINT_ALWAYS or printStats):
                log.info(
                    "[%s]: freq offset % 6.0f Hz, sd % 5.5f Hz, TxFreqOffset %4.0f Hz, "
                    "SNR % 2.1f dB, est spsym % 3.2f, time % 3.2f ms (avg % 3.2f ms), "
                    "rate %5.0f ksamples/s (avg %5.0f)",
                    self.radioName, data["doppler"], data["doppler_std"],
                    TxFreqOffset, data["SNR"], data["spSymEst"],
                    timeSpend * 1000, self.timeMA * 1000,
                    self.samplesPerSlice / timeSpend / 1000,
                    self.samplesPerSlice / max(self.timeMA, 1e-9) / 1000,
                )

        pipeline = InflightPipeline(pipelineDepth, emit)

        try:
            while self.runStatus.is_set():
                try:
                    hops = sigIn.getBlocks(maxBatch)
                    if len(hops) == maxBatch > 1:
                        # preserve result order: drain the pipelined
                        # per-block dispatches before the batched ones
                        pipeline.flush()
                        # fell behind by a full batch: demodulate the
                        # backlog in ONE warmed batched dispatch (smaller
                        # backlogs take the single-block path)
                        timeStamp = time.time()
                        for res in demod.processMany(np.stack(hops)):
                            ship_result(res, count, time.time())
                            count += 1
                        dt = (time.time() - timeStamp) / len(hops)
                        self.computeMATime(dt)
                        log.debug("[%s]: batch of %d blocks, %.2f ms/block",
                                  self.radioName, len(hops), dt * 1000)
                        continue

                    for hop in hops:  # partial backlogs: per-block path
                        raw[self.overlap :] = hop
                        # async dispatch: the input is snapshotted inside,
                        # so the staging buffer may advance immediately
                        pipeline.push(demod.dispatch(raw), time.time(), count)
                        raw[: self.overlap] = raw[-self.overlap :]
                        count += 1
                    if len(pipeline) and sigIn.idle():
                        # feed paused: don't hold computed results back
                        pipeline.flush()
                except (TimeoutError, ConnectionRefusedError):
                    log.info("[%s]: ZMQ from GRC timed out", self.radioName)
                    # signal BEFORE flushing: a wedged device fetch must
                    # not mask the feed loss from the watchdog
                    self.GRCTimeoutFlag.set()
                    pipeline.flush()  # stream gone: ship what's computed
                    count = 0
        except Exception as e:
            log.exception(e)
        finally:
            try:
                pipeline.flush()
            except Exception:
                log.exception("failed to flush in-flight blocks")
            demodOut.close()
            if demodOutClient is not None:
                demodOutClient.close()
            sigIn.close()
            ctx.term()
            log.info("[%s]: Finished", self.radioName)
            signal.signal(signal.SIGTERM, orig_sigterm)
            sys.stdout.flush()

    # ---------------- offsets + running stats ----------------

    def computeTxFreqOffset(self, Doppler_Hz, spSym):
        """Doppler -> rangerate + Tx/Rx IF offsets
        (reference demodulator_process.py:360-374)."""
        c = scipy.constants.speed_of_light
        Rx_rangerate = -Doppler_Hz / self.Fc * c
        dRangeRate = self.TxRangeRate - Rx_rangerate
        rangerate = Rx_rangerate
        RxIFFreqOffset = dRangeRate * self.Fc / c
        TxFreqOffset = dRangeRate * self.TxFc / c
        self.freqOffsetEstStats(TxFreqOffset, RxIFFreqOffset, rangerate, spSym, Doppler_Hz)
        return TxFreqOffset, RxIFFreqOffset, rangerate

    def SNRStats(self, snr, spSym):
        """Average SNR over blocks that look like data (spSym near
        nominal), reset when the getter drains the value."""
        if self.__SNR.value == 0:
            self.__SNRArray = [snr]
            self.__SNRLastSpSym = spSym
        elif abs(spSym - self.spSym) < TOLVAL:
            if abs(self.__SNRLastSpSym - self.spSym) > TOLVAL and len(self.__SNRArray) == 1:
                self.__SNRArray = [snr]
                self.__SNRLastSpSym = spSym
            else:
                self.__SNRArray.append(snr)
        self.SNR = sum(self.__SNRArray) / len(self.__SNRArray)

    def freqOffsetEstStats(self, txIFOffset, rxIFOffset, rangerate, spSym, doppler_Hz):
        baudRateEst = self.Fs / max(spSym, 1e-9)
        if self.__TxIFFreqOffset.value == 0:
            self.__TxIFFreqOffsetArray = [txIFOffset]
            self.__RxIFFreqOffsetArray = [rxIFOffset]
            self.__rangerateArray = [rangerate]
            self.__TxIFFreqOffsetLastSpSym = spSym
            self.__RxFreqOffsetArray = [doppler_Hz]
            self.__baudRateEstArray = [baudRateEst]
        elif abs(spSym - self.spSym) < TOLVAL:
            if (abs(self.__TxIFFreqOffsetLastSpSym - self.spSym) > TOLVAL
                    and len(self.__TxIFFreqOffsetArray) == 1):
                self.__TxIFFreqOffsetArray = [txIFOffset]
                self.__RxIFFreqOffsetArray = [rxIFOffset]
                self.__rangerateArray = [rangerate]
                self.__TxIFFreqOffsetLastSpSym = spSym
                self.__RxFreqOffsetArray = [doppler_Hz]
                self.__baudRateEstArray = [baudRateEst]
            else:
                self.__TxIFFreqOffsetArray.append(txIFOffset)
                self.__RxIFFreqOffsetArray.append(rxIFOffset)
                self.__rangerateArray.append(rangerate)
                self.__RxFreqOffsetArray.append(doppler_Hz)
                self.__baudRateEstArray.append(baudRateEst)

        self.TxIFFreqOffset = sum(self.__TxIFFreqOffsetArray) / len(self.__TxIFFreqOffsetArray)
        self.RxIFFreqOffset = sum(self.__RxIFFreqOffsetArray) / len(self.__RxIFFreqOffsetArray)
        self.rangerate = sum(self.__rangerateArray) / len(self.__rangerateArray)
        self.RxFreqOffset = (sum(self.__RxFreqOffsetArray) / len(self.__RxFreqOffsetArray)
                             + self.baudRate * self.spSym / 4)
        self.baudRateEst = sum(self.__baudRateEstArray) / len(self.__baudRateEstArray)

    # ---------------- monitored-value properties ----------------

    @property
    def Fs(self):
        return self.__Fs.value

    @property
    def rangerate(self):
        """Read-and-clear averaged rangerate."""
        with self.__rangerate.get_lock():
            val = self.__rangerate.value
            self.__rangerate.value = 0
        return val

    @rangerate.setter
    def rangerate(self, rangerate):
        with self.__rangerate.get_lock():
            self.__rangerate.value = float(rangerate)

    @property
    def Fc(self):
        return self.__Fc.value

    @Fc.setter
    def Fc(self, Fc):
        with self.__Fc.get_lock():
            self.__Fc.value = float(Fc)

    @property
    def TxRangeRate(self):
        return self.__TxRangeRate.value

    @TxRangeRate.setter
    def TxRangeRate(self, val):
        with self.__TxRangeRate.get_lock():
            self.__TxRangeRate.value = float(val)

    @property
    def RxIFFreqOffset(self):
        with self.__RxIFFreqOffset.get_lock():
            val = self.__RxIFFreqOffset.value
            self.__RxIFFreqOffset.value = 0
        return val

    @RxIFFreqOffset.setter
    def RxIFFreqOffset(self, val):
        with self.__RxIFFreqOffset.get_lock():
            self.__RxIFFreqOffset.value = float(val)

    @property
    def TxIFFreqOffset(self):
        with self.__TxIFFreqOffset.get_lock():
            val = self.__TxIFFreqOffset.value
            self.__TxIFFreqOffset.value = 0
        return val

    @TxIFFreqOffset.setter
    def TxIFFreqOffset(self, val):
        with self.__TxIFFreqOffset.get_lock():
            self.__TxIFFreqOffset.value = float(val)

    @property
    def SNR(self):
        with self.__SNR.get_lock():
            val = self.__SNR.value
            self.__SNR.value = 0
        return val

    @SNR.setter
    def SNR(self, val):
        with self.__SNR.get_lock():
            self.__SNR.value = float(val)

    @property
    def RxFreqOffset(self):
        return self.__RxFreqOffset.value

    @RxFreqOffset.setter
    def RxFreqOffset(self, val):
        with self.__RxFreqOffset.get_lock():
            self.__RxFreqOffset.value = float(val)

    @property
    def baudRateEst(self):
        return self.__baudRateEst.value

    @baudRateEst.setter
    def baudRateEst(self, val):
        with self.__baudRateEst.get_lock():
            self.__baudRateEst.value = float(val)
