"""Multi-channel Rx in lockstep: one process, one device dispatch per
block for a whole vote group, the diversity vote on the device (K8).

The port of ``pycusdr_tpu/runtime/channel_group_process.py``. When the
Rx channels share a sample clock (co-located antennas on one digitizer,
or the outputs of a channelizer) they run LOCKSTEP: every block, the C
channels' hops are assembled into a (C, Nfft) batch and demodulated in
one dispatch of the block graph, whose kernels write the C packed rows
into one group vector; K8 then votes them on the device into the same
vector's tail, and the host fetches the whole vector with ONE
device-to-host copy (``build_group_graph``). Per-channel soft bits are
still published (so the decoder sees each antenna), plus one extra
"-voted" stream carrying the combined bits.

Geographically dispersed, unsynchronised stations use the JAX package's
softCombiner, which this port does not carry yet.

Enable with ``Main.channelGroup_enabled: true`` (the orchestrator swaps
it in for the per-radio processes when all Rx radios share one vote
group and identical DSP settings).
"""

import logging
import signal
import sys
import time

import numpy as np
import torch

from pycusdr_tpu_torch.dsp.block import build_process_batch, packed_len
from pycusdr_tpu_torch.dsp.spec import DemodSpec
from pycusdr_tpu_torch.parallel.vote import vote_rows, vote_rows_plain
from pycusdr_tpu_torch.runtime.demodulator_process import Array, Event, Process, Value, child_device

log = logging.getLogger(__name__)


def build_group_graph(spec: DemodSpec, C: int, master_weight: float, device=None,
                      plain: bool = False):
    """Return ``group(blocks) -> vec`` for (C, Nfft) complex64 blocks of C
    lockstep channels (channel 0 the master): ``vec`` is one f32 tensor of
    C·L + 2·S on the device, in the layout of the JAX package's
    ``_group_graph`` (``pycusdr_tpu/runtime/channel_group_process.py:
    301-322``): the C packed rows (``ops/layout.py``), their trust -1 at
    the slots at or beyond each channel's nBits, then the voted bits and
    the combined trust, S each.

    ``device``: None means the card (raises without one); "cpu" runs the
    plain PyTorch versions. ``plain``: the plain path of the block graph
    and the plain vote, the reference the kernels are held against."""
    batch = build_process_batch(spec, device=device, packed=True, plain=plain)
    L, S = packed_len(spec), spec.numSymMax
    vote = vote_rows_plain if plain else vote_rows

    def group(blocks):
        vec = torch.empty(C * L + 2 * S, dtype=torch.float32, device=batch.device)
        rows = vec[:C * L].view(C, L)
        x = torch.as_tensor(blocks)
        if x.shape[0] != C:
            raise ValueError(f"expected {C} channels, got {tuple(x.shape)}")
        batch(x, row=rows)
        vote(rows, S, master_weight, vec[C * L:].view(2, S))
        return vec

    group.device = batch.device
    return group


class ChannelGroup_process(Process):
    def __init__(self, conf, protocol, radios):
        Process.__init__(self)
        self.conf = conf
        self.protocol = protocol
        self.radios = list(radios)
        self.name = "demod-group-" + "+".join(self.radios)

        r0 = conf["Radios"]["Rx"][self.radios[0]]
        confGPU = conf["GPU"][r0["CUDA_settings"]]
        self.overlap = 2 ** confGPU["overlap"]
        self.blockSize = 2 ** confGPU["blockSize"]
        self.samplesPerSlice = self.blockSize - self.overlap
        self.baudRate = r0["baud"]
        self.spSym = r0["samplesPerSym"]
        self.Fs = float(self.baudRate * self.spSym)
        self.sigFIFOTimeout = conf.get("Demodulator", {}).get("timeoutSeconds", 120)
        self.decoderProtocol = r0.get("Protocol", "None")
        # >=2: keep depth-1 group dispatches in flight (async; results
        # lag that many blocks) — same semantics as the per-radio
        # demodulator process's knob
        self.pipelineDepth = confGPU.get("TPU", {}).get("pipelineDepth", 1)
        self.voteGroup = 0
        self.masterVoteWeight = conf.get("SoftCombiner", {}).get("masterVoteWeight", 1.2)

        self.workerIds = [
            conf["Main"]["workerId"] + "-" + conf["Radios"]["Rx"][r].get("name", r)
            for r in self.radios
        ]
        self.RxInAddrs = [
            conf["Radios"]["Rx"][r]["Interfaces"]["RxInPort"] for r in self.radios
        ]
        self.demodOutAddr = conf["Radios"]["Rx"][self.radios[0]]["Interfaces"].get(
            "demodOut", conf["Interfaces"]["Internal"]["demodOut"]
        )

        self.daemon = True
        self.runStatus = Event()
        self.runStatus.set()
        self.GRCTimeoutFlag = Event()
        # set once the kernels are built and the group graph has run,
        # before the SigFIFOs subscribe
        self.warmedFlag = Event()
        self._device = Array("c", 16)  # the child's torch device type
        self.logLevel = log.getEffectiveLevel()

        # RPC-facing monitored values (group-level)
        self.__SNR = Value("f", 0)
        self.__TxRangeRate = Value("f", 0)
        log.info("[%s]: channel-group process initialized (%d channels)",
                 self.name, len(self.radios))

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

    # minimal monitored-value surface (RPC parity where it matters)
    @property
    def SNR(self):
        with self.__SNR.get_lock():
            v = self.__SNR.value
            self.__SNR.value = 0
        return v

    @SNR.setter
    def SNR(self, v):
        with self.__SNR.get_lock():
            self.__SNR.value = float(v)

    @property
    def TxRangeRate(self):
        return self.__TxRangeRate.value

    @TxRangeRate.setter
    def TxRangeRate(self, v):
        with self.__TxRangeRate.get_lock():
            self.__TxRangeRate.value = float(v)

    # remaining RPC Rx surface (control/rpc.py dereferences these on
    # whatever sits in the demodulator list): group-level scalars
    rangerate = 0.0
    baudRateEst = 0.0
    RxFreqOffset = 0.0
    RxIFFreqOffset = 0.0
    TxIFFreqOffset = 0.0

    @property
    def Fc(self):
        r0 = self.conf["Radios"]["Rx"][self.radios[0]]
        return float(r0["frequency_Hz"] - r0["frequencyOffset_Hz"])

    @property
    def workerId(self):
        return self.workerIds[0]

    def run(self):
        import zmq

        from pycusdr_tpu_torch.dsp.block import unpack_block_outputs
        from pycusdr_tpu_torch.dsp.spec import build_spec
        from pycusdr_tpu_torch.models.demodulator import finish_download, start_download
        from pycusdr_tpu_torch.models.healing import BlockHealer
        from pycusdr_tpu_torch.runtime import sigfifo
        from pycusdr_tpu_torch.runtime.pipeline import InflightPipeline
        from pycusdr_tpu_torch.utils.logger import child_logger_setup

        child_logger_setup(self.logLevel)
        time.sleep(0.5)

        C = len(self.radios)
        spec = build_spec(self.conf, self.protocol, self.radios[0])
        try:
            dev = child_device(self._device)
            group_fn = build_group_graph(spec, C, self.masterVoteWeight, device=dev)
            # build the kernels and run the graph once before subscribing
            t0 = time.time()
            finish_download(start_download(
                group_fn(np.zeros((C, spec.Nfft), np.complex64))))
            log.info("[%s]: kernels built + group graph warmed on %s in %.1f s",
                     self.name, dev, time.time() - t0)
        except Exception as e:
            log.exception(e)
            raise
        self.warmedFlag.set()

        ctx = zmq.Context()
        demodOut = ctx.socket(zmq.PUSH)
        demodOut.setsockopt(zmq.LINGER, 0)
        demodOut.connect(self.demodOutAddr)
        fifos = [
            sigfifo.SigFIFO(addr, self.samplesPerSlice, dtype=np.complex64,
                            enableTimeoutException=True,
                            timeoutRetries=self.sigFIFOTimeout,
                            runStatus=self.runStatus)
            for addr in self.RxInAddrs
        ]

        healers = [BlockHealer(spec.Nfft, spec.sigOverlap) for _ in range(C)]
        healers.append(BlockHealer(spec.Nfft, spec.sigOverlap))  # voted stream

        tails = np.zeros((C, self.overlap), np.complex64)
        count = 0
        self.GRCTimeoutFlag.clear()
        log.info("[%s]: channel-group running (%d lockstep channels)", self.name, C)
        orig_sigterm = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, lambda *_: None)

        def ship(d):
            try:
                demodOut.send_pyobj(d, zmq.NOBLOCK)
            except zmq.error.Again as e:
                log.error("[%s]: failed to send [%s]", self.name, e)

        L = packed_len(spec)
        S = spec.numSymMax

        def emit(pending, cnt, ts):
            """Wait for one in-flight group dispatch's copy; heal + ship
            its C per-channel streams and the device-voted stream. ``ts``
            is the dispatch-time stamp (same meaning as the per-radio
            process: when the signal block was taken, not when its
            results were collected)."""
            vec = finish_download(pending)  # the ONE transfer
            chans = [unpack_block_outputs(vec[c * L:(c + 1) * L], spec)
                     for c in range(C)]
            bits_voted = vec[C * L: C * L + S]
            trust_voted = vec[C * L + S: C * L + 2 * S]

            snrs = []
            for c, r in enumerate(chans):
                nBits = int(r["nBits"])
                _, bits, trust, _ = healers[c].heal(
                    int(np.sum(r["trust"][:nBits] == -1)),
                    r["centres"][:nBits], r["symbols"][:nBits],
                    r["bits"][:nBits], r["trust"][:nBits], float(r["spSym"]),
                )
                snrs.append(float(r["snr_db"]))
                ship({
                    "workerId": self.workerIds[c], "count": cnt,
                    "timestamp": ts, "voteGroup": self.voteGroup,
                    "doppler": float(r["freq_offset_hz"]),
                    "doppler_std": 0.0,
                    "data": bits.astype(np.uint8),
                    "trust": trust.astype(np.int8),
                    "spSymEst": float(r["spSym"]),
                    "SNR": float(r["snr_db"]),
                    "baudRate": self.baudRate, "baudRate_est":
                        self.Fs / max(float(r["spSym"]), 1e-9),
                    "sample_rate": self.Fs,
                    "protocol": self.decoderProtocol,
                    "numSlaves": 0,
                })

            # the device-voted stream (numSlaves = C-1 voters)
            r0 = chans[0]
            nBits = int(r0["nBits"])
            vtrust8 = np.clip(trust_voted[:nBits], -2, 127).astype(np.int8)
            _, vbits, vtrust, _ = healers[-1].heal(
                0, r0["centres"][:nBits], r0["symbols"][:nBits],
                bits_voted[:nBits].astype(np.int8), vtrust8, float(r0["spSym"]),
            )
            ship({
                "workerId": self.workerIds[0] + "-voted", "count": cnt,
                "timestamp": ts, "voteGroup": self.voteGroup,
                "doppler": float(r0["freq_offset_hz"]),
                "doppler_std": 0.0,
                "data": vbits.astype(np.uint8),
                "trust": vtrust.astype(np.int8),
                "spSymEst": float(r0["spSym"]),
                "SNR": float(np.max(snrs)),
                "baudRate": self.baudRate,
                "baudRate_est": self.Fs / max(float(r0["spSym"]), 1e-9),
                "sample_rate": self.Fs,
                "protocol": self.decoderProtocol,
                "numSlaves": C - 1,
            })
            self.SNR = float(np.max(snrs))

        pipeline = InflightPipeline(self.pipelineDepth, emit)

        try:
            while self.runStatus.is_set():
                try:
                    hops = [f.getBlock() for f in fifos]  # lockstep
                    if self.GRCTimeoutFlag.is_set():
                        self.GRCTimeoutFlag.clear()  # feed recovered
                    blocks = np.concatenate(
                        [tails, np.stack(hops)], axis=1
                    )  # (C, Nfft)
                    tails = blocks[:, -self.overlap :].copy()

                    # async dispatch and copy; depth-1 of them stay in
                    # flight so the card overlaps with healing and the
                    # lockstep wait
                    pipeline.push(start_download(group_fn(blocks)), count, time.time())
                    count += 1
                    if len(pipeline) and any(f.idle() for f in fifos):
                        # feed paused: don't hold computed results back
                        pipeline.flush()
                except (TimeoutError, ConnectionRefusedError):
                    log.info("[%s]: sample feed timed out", self.name)
                    # signal BEFORE flushing: a wedged device fetch must
                    # not mask the feed loss from the watchdog
                    self.GRCTimeoutFlag.set()
                    pipeline.flush()  # feed gone: ship what's computed
                    count = 0
                    # a partial lockstep read consumed hops from some
                    # channels only: flush every ring and zero the
                    # overlap tails so recovery restarts sample-aligned
                    for f in fifos:
                        f.buf.flush()
                    tails[:] = 0
        except Exception as e:
            log.exception(e)
        finally:
            try:
                pipeline.flush()
            except Exception:
                log.exception("failed to flush in-flight group blocks")
            demodOut.close()
            for f in fifos:
                f.close()
            ctx.term()
            signal.signal(signal.SIGTERM, orig_sigterm)
            log.info("[%s]: finished", self.name)
            sys.stdout.flush()
