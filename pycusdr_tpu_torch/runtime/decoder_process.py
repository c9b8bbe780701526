"""Decoder process: soft bits in, deduplicated packet bytes out.

The port of ``pycusdr_tpu/runtime/decoder_process.py`` (capability parity
with the reference ``Decoder(Process)``, ``pyCuSDR/decoder_process.py``):
PULLs worker dicts, lazily creates one frame finder per workerId (keyed
to that worker's protocol), MD5-dedups packets across diversity
channels, PUSHes payload bytes to per-protocol external ZMQ sockets,
accumulates ``VisualizerData`` ring buffers, optionally exports telegraf
metrics (``Main.telegraf_ip``/``telegraf_port``, the ``mon.modem``
metric, when the ``telegraf`` package is installed), and ships the stats
to the parent over a one-shot ZMQ pair at shutdown. For ``ccsds_conv``
the frame finder's streaming Viterbi runs kernel K7 on the protocol's
device; its correlations run the native scanner (``native.bit_correlate``),
whose calls the child publishes (``native_counts``).

With ``Main.maxWorkerRssMb`` armed, a planned restart makes the
replacement demodulator's stream ``base~rN``: the dedup window widens to
``Main.restartOverlapSeconds`` + 3 s, older generations of a base are
marked stale, their silence clock refreshes while they talk, and their
frame finder is evicted 60 s after their last message (their stats stay,
as in the JAX package). Departures from the JAX package: a stream is
marked stale only when a newer generation of its base is registered (the
JAX decoder marks every other generation, so a straggler of an evicted
one would mark the live one stale), and the armed dedup history is pruned
by its timeout alone (the JAX decoder keeps at most 40 hashes, fewer than
the widened window holds at more than 5 packets a second). At shutdown the
parent waits for the stats while the child lives (``STATS_FIRST_WAIT_S``);
the JAX parent gives up after one 2 s poll, which a child leaving a busy
loop on a loaded host has missed, leaving no stats at all.
"""

import logging
import multiprocessing
import signal
import sys
import time

from pycusdr_tpu_torch import native
from pycusdr_tpu_torch.decode import frame_finder
from pycusdr_tpu_torch.decode.packet_hist import PacketHist
from pycusdr_tpu_torch.obs.visualizer import VisualizerData

try:
    from telegraf.client import TelegrafClient
    TELEGRAF_AVAILABLE = True
except ModuleNotFoundError:
    TELEGRAF_AVAILABLE = False

# spawn, never fork: the orchestrator's parent process is multi-threaded
# (torch, zmq, logging); a forked child can deadlock on inherited locks
_mp = multiprocessing.get_context("spawn")
Event, Process = _mp.Event, _mp.Process

log = logging.getLogger(__name__)

STATS_PORT = 11001  # one-shot stats hand-off channel (reference :83-86)
#: how long the parent waits, while the child lives, for its first stats
#: message at shutdown (the child leaves its loop within one poll, then binds)
STATS_FIRST_WAIT_S = 10.0
#: a superseded stream's frame finder goes this long after its last message
EVICT_S = 60.0


def generation(workerId):
    """(base, N) of a planned restart's ``base~rN`` workerId (N = 0 for
    the first generation), as the combiner parses it."""
    base, _, suf = workerId.partition("~r")
    try:
        return base, int(suf) if suf else 0
    except ValueError:
        return workerId, 0


def superseded(workerIds, workerId):
    """The workerIds of ``workerIds`` (with ``workerId`` among them) of
    ``workerId``'s base with a generation below the newest there."""
    base = generation(workerId)[0]
    gens = {w: generation(w)[1] for w in workerIds if generation(w)[0] == base}
    newest = max(gens.values())
    return [w for w, g in gens.items() if g < newest]


class Decoder(Process):
    pollTimeout = 1000  # ms

    def __init__(self, conf, protocol):
        Process.__init__(self)
        self.name = "Decoder"
        self.conf = conf
        self.protocol = protocol  # dict of protocols, or a single one
        self.logLevel = log.getEffectiveLevel()

        external = conf["Interfaces"].get("External", {})
        if "decodeBytesOut_ZMQ" not in external:
            raise ValueError("'decodeBytesOut_ZMQ' not specified")
        self.decodeBytesOutAddr_ZMQ = {}
        prot_keys = self.protocol.keys() if isinstance(self.protocol, dict) else [None]
        for k in prot_keys:
            key = k if k is not None else next(iter(external["decodeBytesOut_ZMQ"]))
            if key not in external["decodeBytesOut_ZMQ"]:
                raise ValueError(
                    "all 'decodeBytesOut_ZMQ' addresses must be defined in "
                    "Interfaces/External/decodeBytesOut_ZMQ"
                )
            self.decodeBytesOutAddr_ZMQ[key] = external["decodeBytesOut_ZMQ"][key]

        self.decodeInAddr = conf["Interfaces"]["Internal"]["decodeIn"]
        self.visualLogBufferSize = conf["Main"].get("plotBufferSize", 10000)
        self.statsPort = conf.get("decoder", {}).get("statsPort", STATS_PORT)

        self.daemon = True
        self.runStatus = Event()
        self.runStatus.set()
        self.boundFlag = Event()  # set once the input and output sockets are bound
        self.showWarnings = log.getEffectiveLevel() < 20
        self.workerData = {}
        self._native = native.shared_counts(_mp)
        log.debug("Decoder configured")

    @property
    def native_counts(self) -> dict:
        """The child's ``native.AVAILABLE`` and its native and numpy calls
        of each binding (``native.read``), published after every message."""
        return native.read(self._native)

    def stop(self):
        log.info("PID %s -- received request to stop", self.pid)
        self.runStatus.clear()

    def _protocol_for(self, dataCont):
        if isinstance(self.protocol, dict):
            return self.protocol[dataCont["protocol"]]
        return self.protocol

    def run(self):
        import zmq

        from pycusdr_tpu_torch.utils.logger import child_logger_setup

        child_logger_setup(self.logLevel)
        protocols = self.protocol.values() if isinstance(self.protocol, dict) else [self.protocol]
        if any(hasattr(p, "device") for p in protocols):
            # only a protocol with device work (ccsds_conv's Viterbi, K7)
            # needs torch here; any other decoder leaves it unloaded, and
            # with it the CUDA libraries' pages
            import torch

            # one intra-op thread: a station runs one child per channel
            torch.set_num_threads(1)

        ctx = zmq.Context()
        log.info("Configuring decoder input socket: %s", self.decodeInAddr)
        decodeIn = ctx.socket(zmq.PULL)
        decodeIn.setsockopt(zmq.LINGER, 0)
        decodeIn.bind(self.decodeInAddr)
        poller = zmq.Poller()
        poller.register(decodeIn, zmq.POLLIN)

        decodeOutZMQPorts = {}
        for k, addr in self.decodeBytesOutAddr_ZMQ.items():
            log.info("Configuring ZMQ PUSH output for %s on %s", k, addr)
            sock = ctx.socket(zmq.PUSH)
            sock.setsockopt(zmq.LINGER, 0)
            sock.bind(addr)
            decodeOutZMQPorts[k] = sock
        self.boundFlag.set()

        decoders = {}
        dconf = self.conf.get("decoder", {})
        timeout = dconf.get("packetCheckHistTimeout", 0)
        maxLen = dconf.get("packetCheckHist", 40)
        main_conf = self.conf.get("Main", {})
        if main_conf.get("maxWorkerRssMb"):
            # a planned restart decodes the overlap in both the outgoing and
            # the replacement child; their copies arrive up to the overlap
            # plus the replacement's catch-up apart. Widen (never narrow)
            # the window, and keep every hash in it
            floor_s = float(main_conf.get("restartOverlapSeconds", 5.0)) + 3.0
            if timeout < floor_s:
                log.info("RSS-cap restarts armed: widening packet dedup window "
                         "%.1f s -> %.1f s (restart overlap + catch-up skew)",
                         timeout, floor_s)
                timeout = floor_s
            maxLen = None
        hashHist = PacketHist(maxLen=maxLen if timeout else 0, timeout=timeout)

        telegraf = None
        if TELEGRAF_AVAILABLE and "telegraf_ip" in main_conf:
            try:
                telegraf = TelegrafClient(host=main_conf["telegraf_ip"],
                                          port=int(main_conf["telegraf_port"]))
            except Exception:
                log.exception("Unable to start telegraf:")

        orig_sigterm = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, lambda *_: None)
        native.publish(self._native)
        log.info("Decoder process initialized and running")
        dataCont = {}
        # superseded restart generations pending eviction: workerId -> the
        # time of its last message since it was marked
        stale_workers = {}
        try:
            while self.runStatus.is_set():
                socks = poller.poll(self.pollTimeout)
                if not (socks and socks[0][1] == zmq.POLLIN):
                    continue
                try:
                    dataCont = decodeIn.recv_pyobj(zmq.DONTWAIT)
                    workerId = dataCont["workerId"]
                    if workerId not in decoders:
                        log.info("Adding new worker %s (protocol %s)",
                                 workerId, dataCont.get("protocol"))
                        decoders[workerId] = frame_finder.Decoder(
                            dconf, self._protocol_for(dataCont)
                        )
                        self.workerData[workerId] = VisualizerData(
                            workerId, self.visualLogBufferSize,
                            showWarnings=self.showWarnings,
                        )
                        for old in superseded(decoders, workerId):
                            stale_workers.setdefault(old, time.time())
                    elif workerId in stale_workers:
                        # the outgoing child talks through the overlap:
                        # eviction comes EVICT_S after its last message
                        stale_workers[workerId] = time.time()
                    now = time.time()
                    for old, t_stale in list(stale_workers.items()):
                        if now - t_stale > EVICT_S:
                            log.info("Evicting superseded worker stream %s", old)
                            decoders.pop(old, None)
                            stale_workers.pop(old, None)

                    rawBits = dataCont["data"]
                    t = time.time()
                    packets, bits_DS, numSyncSig = decoders[workerId].findFrames(
                        rawBits, 0, trust=dataCont.get("trust"))
                    pktsErr = pktsSuc = 0
                    if packets:
                        log.info("worker %-10s bits %6d syncSigs %s packets %d time %.2f ms",
                                 workerId, len(rawBits), numSyncSig, len(packets),
                                 (time.time() - t) * 1000)
                    for packet in packets:
                        byteData, noError, correctBytes = packet.getBinaryData()
                        if noError < 0:
                            pktsErr += 1
                        else:
                            pktsSuc += 1
                        log.info("worker %s found packet %s, bit errors: %s, voters: %s",
                                 workerId, packet.getAsciiAddress(), noError,
                                 dataCont.get("numSlaves", 0))
                        packet.printPacket(
                            pre_str=(f"worker {workerId}, SNR {dataCont.get('SNR')} dB, "
                                     f"freq offset {dataCont.get('doppler')} Hz."),
                            workerId=workerId, verbosity=log.getEffectiveLevel(),
                        )

                        if noError > -1:
                            newPacket = (len(correctBytes) > 0
                                         and hashHist.checkHash(correctBytes, len(decoders)))
                        else:
                            newPacket = True  # forward failed packets anyway
                        if newPacket:
                            try:
                                decodeOutZMQPorts[dataCont["protocol"]].send(
                                    bytes(bytearray(byteData)), zmq.NOBLOCK
                                )
                            except zmq.error.Again as e:
                                log.error("worker %s failed to send bytes [%s]", workerId, e)
                        else:
                            log.info("worker %s duplicate packet -- not forwarding", workerId)

                    dataCont["packetFail"] = pktsErr
                    dataCont["packetSuc"] = pktsSuc
                    dataCont["numSyncSig"] = (
                        numSyncSig / max(len(rawBits), 1) * dataCont.get("baudRate", 0)
                    )
                    dataCont["numBits"] = len(rawBits)
                    self.workerData[workerId].addData(dataCont)
                    native.publish(self._native)

                    if telegraf:
                        vals = {k: v for k, v in dataCont.items()
                                if k not in ("data", "trust", "slaveNames",
                                             "workerId", "voteGroup", "protocol",
                                             "timestamp")}
                        vals["packets_decoded"] = pktsErr + pktsSuc
                        tags = {"workerId": dataCont.get("workerId"),
                                "voteGroup": dataCont.get("voteGroup"),
                                "protocol": dataCont.get("protocol")}
                        try:
                            telegraf.metric("mon.modem", vals, tags=tags,
                                            timestamp=int(dataCont["timestamp"] * 1e9))
                        except Exception:
                            log.exception("Unable to log to telegraf!")
                except Exception as e:
                    log.error("Exception for worker %s", dataCont.get("workerId"))
                    log.exception(e)
        except SystemExit:
            pass
        except Exception as e:
            log.exception(e)
        finally:
            for sock in decodeOutZMQPorts.values():
                sock.close()
            decodeIn.close()

            # one-shot stats hand-off to the parent (reference :394-414)
            workerRet = ctx.socket(zmq.PUSH)
            workerRet.setsockopt(zmq.SNDTIMEO, 500)
            workerRet.setsockopt(zmq.LINGER, 0)
            try:
                workerRet.bind(f"tcp://*:{self.statsPort}")
                log.info("Preparing data for stats")
                for w in self.workerData.values():
                    try:
                        workerRet.send_pyobj(w.getData())
                    except zmq.error.Again:
                        log.error("failed sending stats data (no receiver)")
                        break
            except Exception as e:
                log.error("stats hand-off failed: %s", e)
            workerRet.close()
            ctx.term()
            signal.signal(signal.SIGTERM, orig_sigterm)
            log.info("Finished")
            sys.stdout.flush()

    def getVisualData(self):
        """Collect the stats dicts the child pushes at shutdown (call
        together with or after stop(), in the parent): until 2 s pass
        without one, and before the first one for as long as the child
        lives, at most STATS_FIRST_WAIT_S."""
        import zmq

        ctx = zmq.Context()
        sock = ctx.socket(zmq.PULL)
        sock.setsockopt(zmq.LINGER, 0)
        sock.connect(f"tcp://localhost:{self.statsPort}")
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)
        data = []
        deadline = time.time() + STATS_FIRST_WAIT_S
        while True:
            evts = poller.poll(2000)
            if evts and evts[0][1] == zmq.POLLIN:
                data.append(sock.recv_pyobj())
            elif data or time.time() > deadline or not self.is_alive():
                break
        sock.close()
        ctx.term()
        return data
