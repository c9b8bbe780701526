"""The orchestrator: wire up and supervise the whole modem.

The port of ``pycusdr_tpu/runtime/orchestrator.py`` (capability parity
with the reference ``PyCuSDR`` class, ``pyCuSDR/pyCuSDR.py:44-346``):
modular-JSON config load, per-name protocol instantiation, demodulators
/ softCombiner / decoder / RPC construction, a watchdog ``is_alive``
that ends the run when any process dies or every demodulator lost its
sample feed (or, with ``Main.restartDeadProcesses``, rebuilds the dead
process), and an ordered shutdown that collects the decoder's stats for
post-pass plots.

Tx radios get one ``Modulator_process`` each (host numpy: framing, LUT
modulation, Doppler pre-compensation; no device). Rx radios get one
``Demodulator_process`` each, or, with ``Main.channelGroup_enabled`` and
several homogeneous radios, ONE lockstep ``ChannelGroup_process`` that
demodulates them in one dispatch and votes on the device. Every Rx child
runs on ``globals.torch_device``: the card unless
``PYCUSDR_TORCH_DEVICE`` says "cpu".

With ``Main.softCombiner_enabled`` and more than one Rx radio, the
demodulators send to a ``SoftCombiner`` child (``combine/``, host numpy),
which aligns and votes the channels' bits and forwards them to the
decoder; otherwise they send straight to the decoder (``decodeIn =
demodIn``). The combiner is ``self.combiner``, and the RPC server's
``get_active_workers`` asks it.

Not yet ported, refused with ``NotImplementedError`` (ROADMAP.md Queue
1): ``Main.maxWorkerRssMb`` (planned restarts) and telegraf metrics
(``Main.telegraf_ip``).
"""

import logging
import time

from pycusdr_tpu_torch import __version__
from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.globals import LOG_NAME, torch_device
from pycusdr_tpu_torch.protocol import loadProtocol
from pycusdr_tpu_torch.utils.graceful import GracefulKiller
from pycusdr_tpu_torch.utils.logger import logger_setup

log = logging.getLogger(__name__)

#: seconds ``terminate`` waits for the children to stop, then to join
STOP_TIMEOUT = 5.0
JOIN_TIMEOUT = 10.0


def check_supported(conf) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    main = conf["Main"]
    refused = []
    if main.get("maxWorkerRssMb", 0):
        refused.append("Main.maxWorkerRssMb (planned restarts, ROADMAP.md Queue 1 item 20)")
    if "telegraf_ip" in main:
        refused.append("Main.telegraf_ip (telegraf metrics, ROADMAP.md Queue 1 item 22)")
    if refused:
        raise NotImplementedError("not yet ported: " + "; ".join(refused))


class PyCuSDR:
    """Top-level API: ``PyCuSDR(configFile, args).start() / run()``."""

    def __init__(self, config_file_name, args=None):
        self.start_time = time.time()
        self.args = args
        if isinstance(config_file_name, dict):
            self.configFile = config_file_name
        else:
            log.info("Loading configuration from %s", config_file_name)
            self.configFile = load_modular_json(config_file_name)
        check_supported(self.configFile)
        # resolve the device now: without a card (and without "cpu" asked
        # for) this raises before any child starts
        self.device = torch_device()

        self._init_logging()
        log.info("Starting pycusdr_tpu_torch %s on %s", __version__, self.device)

        self._init_protocols()
        self.radios = self.configFile["Radios"]["Rx"].keys()
        self._restart_enabled = self.configFile["Main"].get("restartDeadProcesses", False)
        self._max_restarts = self.configFile["Main"].get("maxProcessRestarts", 3)
        self._restarts = 0
        self.passStats = []
        self._init_SDR()
        self._running = False
        self.killer = None

    # ---------------- lifecycle ----------------

    def start(self):
        self._running = True
        for t in self.tasks:
            t.start()
        self.killer = GracefulKiller()

    def is_alive(self):
        """False when killed, every demod timed out, or a process died.

        With ``Main.restartDeadProcesses`` a crashed worker is rebuilt
        from its factory and restarted (up to ``maxProcessRestarts``
        times) instead of aborting the pass."""
        if self.killer is not None and self.killer.kill_now:
            log.debug("killed")
            return False
        if self._demodulators and all(d.GRCTimeout() for d in self._demodulators):
            log.debug("all demodulators timed out")
            return False
        for i, t in enumerate(self.tasks):
            time.sleep(0.1)
            if t.is_alive():
                continue
            if self._restart_enabled and self._restarts < self._max_restarts:
                self._restarts += 1
                log.error("Process %s died -- restarting (%d/%d)",
                          t.name, self._restarts, self._max_restarts)
                new_t = self._task_factories[i]()
                self._replace_task(i, t, new_t)
                new_t.start()
                continue
            raise Exception(f"Process {t.name} died unexpectedly -- shutting down")
        return True

    def _replace_task(self, i, old, new):
        self.tasks[i] = new
        for coll in (self._demodulators, self._modulators):
            for j, x in enumerate(coll):
                if x is old:
                    coll[j] = new
        if old is self.dec:
            self.dec = new
        if old is self.combiner:
            self.combiner = new
            if self.rpcInt is not None:
                self.rpcInt.softCombiner = new
        # keep the RPC thread pointed at live processes
        if self.rpcInt is not None:
            for j, x in enumerate(self.rpcInt.demodulator):
                if x is old:
                    self.rpcInt.demodulator[j] = new
            for k, v in list(self.rpcInt.modulator.items()):
                if v is old:
                    self.rpcInt.modulator[k] = new

    def run(self):
        try:
            self.start()
            while self.is_alive():
                time.sleep(0.1)
        except SystemExit:
            log.error("SYSTEMEXIT")
        except Exception as e:
            log.error("Error in process")
            log.exception(e)
        finally:
            self.terminate()

    def terminate(self):
        self._shutdown()

    def shutdown_tasks(self):
        """Hook run during shutdown, before force-terminating: collect
        the decoder stats (kept in ``passStats``: one dict of per-block
        lists for each worker) and write post-pass analytics."""
        self._running = False
        try:
            plotData = self.passStats = self.dec.getVisualData()
            if plotData:
                from pycusdr_tpu_torch.obs import stats

                saveLoc = stats.processData(self.configFile, plotData, self.start_time)
                log.info("Saved pass stats to %s", saveLoc)
        except Exception as e:
            log.error("could not generate stats")
            log.exception(e)

    def _shutdown(self):
        log.info("Shutting down")
        self._running = False
        started = [t for t in self.tasks if t.pid is not None]
        for t in started:
            t.stop()
        self.shutdown_tasks()
        if self.rpcInt is not None:
            self.rpcInt.terminate()

        deadline = time.time() + STOP_TIMEOUT
        while time.time() < deadline and any(t.is_alive() for t in started):
            time.sleep(0.1)
        for t in started:
            t.terminate()
            t.join(timeout=JOIN_TIMEOUT)
            if t.is_alive():
                log.error("Process %s ignored terminate; killing it", t.name)
                t.kill()
                t.join(timeout=JOIN_TIMEOUT)
        if self.rpcInt is not None:
            self.rpcInt.join(timeout=JOIN_TIMEOUT)
        log.info("Finished -- Bye")
        from pycusdr_tpu_torch.utils.logger import shutdown_logging

        shutdown_logging()

    # ---------------- construction ----------------

    def _init_SDR(self):
        from pycusdr_tpu_torch.combine import SoftCombiner
        from pycusdr_tpu_torch.runtime.decoder_process import Decoder
        from pycusdr_tpu_torch.runtime.demodulator_process import Demodulator_process
        from pycusdr_tpu_torch.runtime.modulator_process import Modulator_process

        log.info("Utilizing %d channels: %s", len(self.radios), ", ".join(self.radios))
        self.tasks = tasks = []
        # one factory per task (same index) so a crashed worker can
        # be rebuilt when restartDeadProcesses is enabled
        self._task_factories = factories = []

        # the softCombiner binds demodIn and sends to the decoder's
        # decodeIn; without it the demodulators send straight to the decoder
        if self.configFile["Main"].get("softCombiner_enabled", False) and len(self.radios) > 1:
            self.combiner = SoftCombiner(self.configFile)
            log.info("SoftCombiner initialized.")
        else:
            self.configFile["Interfaces"]["Internal"]["decodeIn"] = \
                self.configFile["Interfaces"]["Internal"]["demodIn"]
            self.combiner = None
            log.info("SoftCombiner not started. Sending bits directly to decoder")

        # the decoder starts first: it binds the socket the combiner or the
        # demodulators connect to (kept as attribute: stats are fetched at
        # shutdown)
        self.dec = Decoder(self.configFile, self.protocols)
        tasks.append(self.dec)
        factories.append(lambda: Decoder(self.configFile, self.protocols))
        if self.combiner is not None:
            tasks.append(self.combiner)
            factories.append(lambda: SoftCombiner(self.configFile))

        # Tx modulators: one process per Tx radio, protocol from config
        self._modulators = []
        for m, confTx in self.configFile["Radios"].get("Tx", {}).items():
            mk = (lambda name=m, prot=confTx["Protocol"]:
                  Modulator_process(self.configFile, self.protocols[prot], name))
            self._modulators.append(mk())
            factories.append(mk)
        tasks.extend(self._modulators)
        if not self._modulators:
            log.warning("Modulator not initialized ('Tx' not in config)")

        # Rx demodulators: one process per channel (reference model),
        # or one lockstep channel-group process demodulating every
        # channel in a single device dispatch + on-device vote
        # (clock-shared antennas / channelizer outputs; see
        # runtime/channel_group_process.py)
        self._demodulators = []
        groupEnabled = self.configFile["Main"].get("channelGroup_enabled", False)
        if groupEnabled and len(self.radios) > 1:
            from pycusdr_tpu_torch.runtime.channel_group_process import ChannelGroup_process

            rx = self.configFile["Radios"]["Rx"]
            keys = ("Protocol", "baud", "samplesPerSym", "CUDA_settings", "voteGroup")
            first = {k: next(iter(rx.values())).get(k) for k in keys}
            for name, rc in rx.items():
                for k in keys:
                    if rc.get(k) != first[k]:
                        raise ValueError(
                            f"channelGroup_enabled requires homogeneous Rx radios: "
                            f"{name}.{k}={rc.get(k)!r} differs from {first[k]!r}"
                        )
            protocolName = first["Protocol"]
            mk = (lambda prot=protocolName:
                  ChannelGroup_process(self.configFile, self.protocols[prot],
                                       list(self.radios)))
            self._demodulators.append(mk())
            factories.append(mk)
        else:
            for radio in self.radios:
                protocolName = self.configFile["Radios"]["Rx"][radio]["Protocol"]
                mk = (lambda r=radio, prot=protocolName:
                      Demodulator_process(self.configFile, self.protocols[prot], r))
                self._demodulators.append(mk())
                factories.append(mk)
        tasks.extend(self._demodulators)

        # control plane
        if self.configFile.get("RPC", {}).get("enabled", True):
            from pycusdr_tpu_torch.control.rpc import RpcInterface

            self.rpcInt = RpcInterface(self.configFile, self._modulators, self._demodulators,
                                       self.combiner)
        else:
            self.rpcInt = None

    def _init_logging(self):
        v = getattr(self.args, "v", 0) if self.args is not None else 0
        logLevel = max(1, 30 - v * 10)
        fileName = self.configFile.get("Main", {}).get("logFile")
        logger_setup(fileName=fileName, logLevel=logLevel)
        self.log = logging.getLogger(LOG_NAME)

    def _init_protocols(self):
        main = self.configFile["Main"]
        if "protocols" not in main:
            raise KeyError('"protocols" not defined in "Main"')
        self.protocols = {}
        self.protocolNamesDict = {}
        for pName, implName in main["protocols"].items():
            self.protocolNamesDict[pName] = implName
            protocol = loadProtocol(implName)(conf=self.configFile)
            if hasattr(protocol, "device"):
                # a protocol with device work (ccsds_conv's Viterbi, K7)
                # runs it where the runtime runs
                protocol.device = self.device.type
            self.protocols[pName] = protocol
        log.info("Found protocols %s", self.protocolNamesDict)

    # ---------------- getters ----------------

    @property
    def demodulators(self):
        return self._demodulators

    @property
    def modulators(self):
        return self._modulators
