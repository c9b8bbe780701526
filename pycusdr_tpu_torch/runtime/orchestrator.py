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

With ``Main.maxWorkerRssMb`` (MB, 0 = off) a maintenance thread restarts,
as planned maintenance, a child whose resident set exceeds the cap: a
demodulator child make-before-break (the replacement, workerId
``base~rN``, warms while the old child decodes, both decode through
``Main.restartOverlapSeconds``, then the old child is torn down), any
other child break-before-make. The resident set is read from
``/proc/<pid>/statm``, as psutil reads it on Linux.

Departure from the JAX package: ``is_alive`` never runs the RSS check, so
a caller that polls it never becomes the restarter and never waits out a
warm-up and an overlap; the maintenance thread alone restarts.
"""

import logging
import os
import threading
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
#: planned restarts: the maintenance thread's period, seconds between RSS
#: checks, the storm guard's window, the bound on a replacement's warm-up,
#: and the teardown's waits for the old child to stop, to join after
#: terminate, and to join after SIGKILL
MAINT_PERIOD_S = 2.0
RSS_CHECK_S = 10.0
STORM_S = 120.0
WARM_S = 300.0
RESTART_STOP_S, RESTART_JOIN_S, RESTART_KILL_S = 5.0, 10.0, 5.0

_PAGE = os.sysconf("SC_PAGE_SIZE")


def rss_mb(pid: int) -> float:
    """Resident set of process ``pid`` in MB (1e6 bytes): resident pages
    from ``/proc/<pid>/statm`` times the page size."""
    with open(f"/proc/{pid}/statm") as f:
        return int(f.read().split()[1]) * _PAGE / 1e6


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
        # planned-maintenance restart when a child's RSS exceeds this cap
        # (MB; 0 = off): a long pass keeps each child's host footprint
        # bounded, whatever grows in it
        self._max_rss_mb = self.configFile["Main"].get("maxWorkerRssMb", 0)
        self._last_rss_check = 0.0
        # crash restarts (is_alive) and planned ones (the maintenance
        # thread) are serialized by this lock
        self._maint_lock = threading.Lock()
        self._maint_thread = None
        # tasks being torn down by a planned restart: their dead state is
        # not a crash, and their feed timeout is shutdown signalling
        self._maint_restarting = set()
        self._rss_restart_at = {}  # task index -> end of its last planned restart
        self._restart_seq = 0  # workerId suffix of replacement children
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
        if self._max_rss_mb:
            # the cap fires whether or not the caller polls is_alive()
            def maint():
                while self._running:
                    try:
                        self._check_rss_caps()
                    except Exception:
                        log.exception("RSS maintenance check failed")
                    time.sleep(MAINT_PERIOD_S)

            self._maint_thread = threading.Thread(target=maint, daemon=True)
            self._maint_thread.start()

    def is_alive(self):
        """False when killed, every demod timed out, or a process died.

        With ``Main.restartDeadProcesses`` a crashed worker is rebuilt
        from its factory and restarted (up to ``maxProcessRestarts``
        times) instead of aborting the pass. A child in the middle of a
        planned restart is neither dead nor timed out."""
        if self.killer is not None and self.killer.kill_now:
            log.debug("killed")
            return False
        # a planned restart's stop() makes the old child's SigFIFO raise
        # and set its feed-timeout flag: shutdown signalling, not a lost feed
        active = [d for d in self._demodulators if id(d) not in self._maint_restarting]
        if active and all(d.GRCTimeout() for d in active):
            log.debug("all demodulators timed out")
            return False
        for i, t in enumerate(self.tasks):
            time.sleep(0.1)
            if t.is_alive():
                continue
            if id(t) in self._maint_restarting or self.tasks[i] is not t:
                continue  # planned restart in progress / already replaced
            if self._restart_enabled and self._restarts < self._max_restarts:
                # non-blocking: a planned restart holds the lock across a
                # warm-up and an overlap; the dead task is retried on the
                # next poll once the lock frees
                if not self._maint_lock.acquire(blocking=False):
                    continue
                try:
                    if self.tasks[i] is not t:
                        continue  # the maintenance thread already replaced it
                    self._restarts += 1
                    log.error("Process %s died -- restarting (%d/%d)",
                              t.name, self._restarts, self._max_restarts)
                    new_t = self._task_factories[i]()
                    self._replace_task(i, t, new_t)
                    new_t.start()
                finally:
                    self._maint_lock.release()
                continue
            raise Exception(f"Process {t.name} died unexpectedly -- shutting down")
        return True

    def _check_rss_caps(self):
        """Planned restart of a child whose RSS exceeds
        ``Main.maxWorkerRssMb`` (at most one a check, so the pipeline never
        loses every stage at once). Non-blocking: a restart already in
        progress holds the lock."""
        if not self._max_rss_mb or not self._running:
            return
        if not self._maint_lock.acquire(blocking=False):
            return
        try:
            self._check_rss_caps_locked()
        finally:
            self._maint_lock.release()

    def _check_rss_caps_locked(self):
        now = time.time()
        if now - self._last_rss_check < RSS_CHECK_S:
            return
        self._last_rss_check = now
        for i, t in enumerate(self.tasks):
            pid = t.pid
            if not pid:
                continue
            try:
                rss = rss_mb(pid)
            except OSError:
                continue
            if rss <= self._max_rss_mb:
                continue
            # storm guard: a child over the cap again within STORM_S of its
            # last planned restart has a baseline footprint above the cap;
            # restarting it in a loop would decode nothing
            if time.time() - self._rss_restart_at.get(i, 0.0) < STORM_S:
                log.error(
                    "Process %s exceeds maxWorkerRssMb=%d MB immediately "
                    "after a planned restart (baseline footprint above the "
                    "cap) -- disabling the RSS cap; raise it above the "
                    "worker's warm RSS", t.name, self._max_rss_mb)
                self._max_rss_mb = 0
                return
            log.warning("Process %s RSS %.0f MB exceeds cap %d MB -- "
                        "planned restart", t.name, rss, self._max_rss_mb)
            self._maint_restarting.add(id(t))
            try:
                self._planned_restart(i, t, pid)
            finally:
                # stamped after the restart: a warm-up and an overlap can
                # outlast the storm window themselves
                self._rss_restart_at[i] = time.time()
                self._maint_restarting.discard(id(t))
            return

    def _planned_restart(self, i, t, pid):
        """Replace task ``i`` (``t``, process ``pid``). A child with
        ``warmedFlag`` and ``subscribeGate`` (the demodulator) is replaced
        make-before-break: the replacement, workerId ``base~rN`` so that
        the decoder keeps its stream apart, warms while ``t`` decodes,
        subscribes, and both decode for ``Main.restartOverlapSeconds``
        before ``t`` is torn down. If the replacement dies while warming,
        or for any other child, break-before-make: ``t`` goes down first,
        then its factory's new child starts."""
        new_t = None
        if hasattr(t, "warmedFlag") and hasattr(t, "subscribeGate"):
            new_t = self._task_factories[i]()
            self._restart_seq += 1
            new_t.workerId = f"{new_t.workerId}~r{self._restart_seq}"
            new_t.subscribeGate.clear()
            new_t.start()
            deadline = time.time() + WARM_S
            while (time.time() < deadline and self._running and new_t.is_alive()
                   and not new_t.warmedFlag.wait(0.5)):
                pass
            if not new_t.is_alive():
                log.error("replacement %s died during warm-up -- "
                          "falling back to break-before-make", new_t.name)
                new_t = None
            elif not new_t.warmedFlag.is_set():
                log.error("replacement %s not warm yet -- swapping anyway "
                          "(it will subscribe when ready)", new_t.name)
            if new_t is not None:
                # the feed is PUB/SUB: the replacement subscribes while the
                # old child still decodes, so every burst lies wholly in
                # one child's stream; the decoder drops the duplicates
                new_t.subscribeGate.set()
                overlap = float(self.configFile["Main"].get("restartOverlapSeconds", 5.0))
                t_end = time.time() + overlap
                while time.time() < t_end and self._running:
                    time.sleep(0.1)
        t.stop()
        deadline = time.time() + RESTART_STOP_S
        while t.is_alive() and time.time() < deadline:
            time.sleep(0.1)
        t.terminate()
        # the demodulator masks SIGTERM while it runs: never hold the lock
        # on an unbounded join
        t.join(timeout=RESTART_JOIN_S)
        if t.is_alive():
            log.error("Process %s ignored terminate; SIGKILL %d", t.name, pid)
            t.kill()
            t.join(timeout=RESTART_KILL_S)
        if new_t is None:
            new_t = self._task_factories[i]()
            self._replace_task(i, t, new_t)
            new_t.start()
        else:
            self._replace_task(i, t, new_t)

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
        # stop the maintenance thread first and wait out a restart in flight
        self._running = False
        with self._maint_lock:
            pass
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
