"""XML-RPC management/monitoring server (a copy of
``pycusdr_tpu/control/rpc.py``).

Capability parity with the reference ``RpcInterface``
(``pyCuSDR/rpcInterface.py``): a daemon thread serving the full get/set
surface over SimpleXMLRPCServer — Tx/Rx rangerate, frequencies, IF
offsets, SNR, baud rates, gains and sample rates (the radio-hardware
ones proxied to GNU Radio's own XML-RPC server), the STX S-band
surface, GRC service start/kill forwarding, and the softCombiner
active-worker query. Higher-level ops software (pass schedulers,
gpredict glue) drives the modem through this surface.

Method parity audit vs ``rpcInterface.py:106-431`` (all 48 reference
registrations + start/kill):

====================  =====================================================
registered here       notes
====================  =====================================================
start / kill          GRC service control forwarding (:484-503)
get_config            (:108-111)
get/set_Tx_rangerate  (:113-125)
get/set_Tx_samp_rate  GRC proxy (:128-142)
get/set_STX_Tx_samp_rate  GRC proxy (:133-147)
get/set_Tx_freq       set raises NotImplementedError like ref (:152-177)
get_STX_Tx_freq       GRC proxy w/ modulator fallback (:165-175)
get/set_Tx_freq_offset    (:183-196)
get_Tx_GRC_freq_offset    (:198-201)
get_Tx_total_freq_offset  (:203-206)
get/set_Tx_gain       GRC proxy (:203-216 region)
get/set_STX_Tx_gain   GRC proxy (:208-221)
get_Tx_baud_rate      (:223-226)
get/set_Tx_num_sync_flags  (:228-236; the reference registers these but
                      its modulator plumbing is commented out,
                      modulator_process.py:143 — here the setter really
                      reframes via Modulator.numSyncFlags)
get/set_Rx_rangerate  set raises NotImplementedError like ref (:244-253)
get/set_Rx_baud_rate  get via GRC; set proxies GRC (:256-263)
get_Rx_baud_rate_est  (:266-269)
get/set_Rx_samp_rate  GRC proxy with FS_TOL verification (:272-287)
get/set_Rx_freq       GRC proxy with FC_TOL verification (:291-313)
get_Rx_GRC_freq_offset    (:316-319)
get_Rx_freq_offset    (:321-324)
get/set_Rx_IF_freq_offset_est  set raises NotImplementedError (:327-335)
get/set_Tx_IF_freq_offset_est  set raises NotImplementedError (:337-343)
get_Rx_SNR            (:345-347)
get/set_Rx_gain       GRC proxy (:349-357)
get_Rx_antenna_name   (:360-363)
get/set_STX_gain      GRC proxy (:367-375)
get/set_STX_freq      GRC proxy with FC_TOL verification (:377-395)
get/set_STX_samp_rate GRC proxy with FS_TOL verification (:398-412)
get_STX_baud_rate     GRC proxy (:415-418)
get_active_workers    softCombiner query (:423-430)
====================  =====================================================

Deliberate deviations (none silent): the reference *returns* exception
instances from the three not-implemented setters (XML-RPC cannot
marshal them, so clients saw a marshalling Fault); here they ``raise``
NotImplementedError directly, which reaches clients as a clean Fault
with the message intact.
"""

import logging
import socket
import threading
from xmlrpc.server import Fault, SimpleXMLRPCRequestHandler, SimpleXMLRPCServer

log = logging.getLogger(__name__)

FC_TOL = 1e5
FS_TOL = 1e4


class RequestHandler(SimpleXMLRPCRequestHandler):
    rpc_paths = ("/RPC2",)


class RpcInterface(threading.Thread):
    GRCRunning = False

    def __init__(self, conf, modulator=None, demodulator=None, softCombiner=None):
        threading.Thread.__init__(self)
        self.daemon = True
        self.conf = conf

        # normalize modulators to a name->process dict; fall back to a
        # dummy for unit tests (reference rpcInterface.py:33-52)
        if not modulator:
            self.modulator = {"UHF": dummyModulator()}
        elif isinstance(modulator, dict):
            self.modulator = modulator
        elif isinstance(modulator, list):
            self.modulator = {m.name: m for m in modulator}
        else:
            self.modulator = {"UHF": modulator}

        if demodulator is None:
            self.demodulator = [dummyModulator()]
        elif isinstance(demodulator, list):
            self.demodulator = demodulator
        else:
            self.demodulator = [demodulator]

        self.softCombiner = softCombiner
        self._stopEvent = threading.Event()

        # optional GNU Radio service-control + flowgraph RPC clients
        self.GRCServiceControl = None
        self.GRCRpc = None
        import xmlrpc.client

        try:
            addr = conf["Interfaces"]["External"]["GRCServiceControl"]
            log.info("Registering GRC servicecontrol on %s", addr)
            self.GRCServiceControl = xmlrpc.client.Server(addr)
        except Exception as e:
            log.warning("No GRC service control: %s", e)

        socket.setdefaulttimeout(1)
        try:
            addr = conf["Interfaces"]["Internal"]["GRCRpc"]
            log.info("Registering GRC RPC interface on %s", addr)
            self.GRCRpc = xmlrpc.client.Server(addr)
        except Exception as e:
            log.warning("No GRC flowgraph RPC: %s", e)

        rpcAddr = conf["Interfaces"]["External"]["XMLRpcIn"]
        log.info("Registering XMLRPC server on %s", rpcAddr)
        addr, port = rpcAddr.rsplit(":", 1)
        self.rpcServ = server = SimpleXMLRPCServer(
            (addr, int(port)), requestHandler=RequestHandler,
            allow_none=True, logRequests=False,
        )
        server.register_introspection_functions()

        server.register_function(self.kill_GRC, "kill")
        server.register_function(self.start_GRC, "start")
        self._registerTxMethods(server)
        self._registerRxMethods(server)
        self._registerSTXMethods(server)
        self._registerSoftCombinerMethods(server)

        self.start()

    # ---------------- Tx surface ----------------

    def _registerTxMethods(self, server):
        @server.register_function
        def get_config():
            """Returns the config"""
            return self.conf

        @server.register_function
        def get_Tx_rangerate(name="UHF"):
            return self.modulator[name].rangerate

        @server.register_function
        def set_Tx_rangerate(rangerate):
            """Sets the Tx rangerate for all modulators (and informs the
            demodulators, which use it for IF offset estimation)."""
            for modul in self.modulator.values():
                modul.rangerate = rangerate
            for demod in self.demodulator:
                demod.TxRangeRate = rangerate

        @server.register_function
        def get_Tx_samp_rate():
            return self._get_GRC("get_tx_samp_rate")

        @server.register_function
        def set_Tx_samp_rate(Fs):
            self._set_GRC("set_tx_samp_rate", Fs)

        @server.register_function
        def get_STX_Tx_samp_rate():
            return self._get_GRC("get_STX_Tx_sample_rate")

        @server.register_function
        def set_STX_Tx_samp_rate(Fs):
            self._set_GRC("set_STX_Tx_sample_rate", Fs)

        @server.register_function
        def get_STX_Tx_freq():
            try:
                return self._get_GRC("get_STX_Tx_Freq")
            except Exception:
                log.warning("Could not read GRC STX Tx frequency")
                for name, m in self.modulator.items():
                    if "STX" in name:
                        return m.Fc
                return 0

        @server.register_function
        def get_STX_Tx_gain():
            return self._get_GRC("get_STX_Tx_Gain")

        @server.register_function
        def set_STX_Tx_gain(gain):
            self._set_GRC("set_STX_Tx_Gain", gain)

        @server.register_function
        def get_Tx_freq():
            try:
                return self._get_GRC("get_Tx_Freq")
            except Exception:
                log.warning("Could not read GRC Tx frequency")
                for name, m in self.modulator.items():
                    if "UHF" in name:
                        return m.Fc
                return 0

        @server.register_function
        def set_Tx_freq(Fc):
            raise NotImplementedError("Setting TxFc is not implemented")

        @server.register_function
        def get_Tx_freq_offset(name="UHF"):
            return self.modulator[name].centreFreqOffset

        @server.register_function
        def set_Tx_freq_offset(val, name="UHF"):
            self.modulator[name].centreFreqOffset = int(val)

        @server.register_function
        def get_Tx_GRC_freq_offset(name="UHF"):
            return self.modulator[name].freqOffset

        @server.register_function
        def get_Tx_total_freq_offset(name="UHF"):
            return self.modulator[name].totalFreqOffset

        @server.register_function
        def get_Tx_gain():
            return self._get_GRC("get_Tx_Gain")

        @server.register_function
        def set_Tx_gain(gain):
            self._set_GRC("set_Tx_Gain", gain)

        @server.register_function
        def get_Tx_baud_rate(name="UHF"):
            return self.modulator[name].baudRate

        @server.register_function
        def get_Tx_num_sync_flags(name="UHF"):
            """Preamble-flag repetition count currently framing Tx."""
            return self.modulator[name].numSyncFlags

        @server.register_function
        def set_Tx_num_sync_flags(val, name="UHF"):
            self.modulator[name].numSyncFlags = int(val)

    # ---------------- Rx surface ----------------

    def _registerRxMethods(self, server):
        @server.register_function
        def get_Rx_rangerate(antenna=0):
            return self.demodulator[antenna].rangerate

        @server.register_function
        def set_Rx_rangerate(rangerate, antenna=0):
            raise NotImplementedError("Setting the RxRangeRate is not implemented")

        @server.register_function
        def get_Rx_baud_rate(antenna=0):
            return self._get_GRC("get_baudRate")

        @server.register_function
        def set_Rx_baud_rate(baud, antenna=0):
            """Baud rate is provided by GRC (rpcInterface.py:261-263)."""
            self.GRCRpc.set_baud_rate(baud)

        @server.register_function
        def get_Rx_baud_rate_est(antenna=0):
            return self.demodulator[antenna].baudRateEst

        @server.register_function
        def get_Rx_samp_rate(antenna=0):
            return self._get_GRC("get_sample_rate")

        @server.register_function
        def set_Rx_samp_rate(Fs, antenna=0):
            try:
                self.GRCRpc.set_sample_rate(Fs)
            except Fault as e:
                Fs_read = self.GRCRpc.get_sample_rate()
                if abs(Fs - Fs_read) > FS_TOL:
                    raise Exception(
                        f"sample rate off: reading {Fs_read} Hz, desired {Fs} Hz"
                    ) from e

        @server.register_function
        def get_Rx_freq(antenna=0):
            try:
                return self._get_GRC("get_Rx_freq")
            except Exception:
                log.warning("Could not read GRC Rx frequency")
                return self.demodulator[antenna].Fc

        @server.register_function
        def set_Rx_freq(Fc, antenna=0):
            log.info("Setting Rx centre frequency to %s Hz", Fc)
            try:
                self.GRCRpc.set_Rx_Fc(Fc)
            except Fault as e:
                freq = self._get_GRC("get_Rx_freq")
                if abs(freq - Fc) > FC_TOL:
                    raise Exception(
                        f"failed to set Rx frequency to {Fc} Hz (read {freq} Hz)"
                    ) from e

        @server.register_function
        def get_Rx_GRC_freq_offset(antenna=0):
            return self._get_GRC("get_Rx_Freq_Offset")

        @server.register_function
        def get_Rx_freq_offset(antenna=0):
            return self.demodulator[antenna].RxFreqOffset

        @server.register_function
        def get_Rx_IF_freq_offset_est(antenna=0):
            return self.demodulator[antenna].RxIFFreqOffset

        @server.register_function
        def set_Rx_IF_freq_offset_est(val, antenna=0):
            """An estimate computed in the modem; cannot be set."""
            raise NotImplementedError("Setting Rx frequency offset is not implemented")

        @server.register_function
        def get_Tx_IF_freq_offset_est(antenna=0):
            return self.demodulator[antenna].TxIFFreqOffset

        @server.register_function
        def set_Tx_IF_freq_offset_est(val):
            """An estimate computed in the modem; cannot be set."""
            raise NotImplementedError("Setting Tx frequency offset is not implemented")

        @server.register_function
        def get_Rx_SNR(antenna=0):
            return self.demodulator[antenna].SNR

        @server.register_function
        def get_Rx_gain():
            return self._get_GRC("get_RxGain")

        @server.register_function
        def set_Rx_gain(val):
            self.GRCRpc.set_RxGain(val)

        @server.register_function
        def get_Rx_antenna_name(antenna=0):
            return self.demodulator[antenna].workerId

    # ---------------- STX (S-band) surface ----------------

    def _registerSTXMethods(self, server):
        """S-band receiver knobs, all proxied to the GNU Radio flowgraph
        (reference rpcInterface.py:365-418)."""

        @server.register_function
        def get_STX_gain():
            return self._get_GRC("get_STXGain")

        @server.register_function
        def set_STX_gain(val):
            self._set_GRC("set_STXGain", val)

        @server.register_function
        def get_STX_freq():
            return self._get_GRC("get_STX_freq")

        @server.register_function
        def set_STX_freq(Fc):
            log.info("Setting STX frequency to %s Hz", Fc)
            try:
                self.GRCRpc.set_STX_freq(Fc)
            except Fault as e:
                freq = self._get_GRC("get_STX_freq")
                if abs(freq - Fc) > FC_TOL:
                    raise Exception(
                        f"STX centre frequency reading {freq} Hz, desired {Fc} Hz"
                    ) from e

        @server.register_function
        def get_STX_samp_rate():
            return self._get_GRC("get_STX_sample_rate")

        @server.register_function
        def set_STX_samp_rate(Fs):
            try:
                self.GRCRpc.set_STX_sample_rate(Fs)
            except Fault as e:
                Fs_read = self._get_GRC("get_STX_sample_rate")
                if abs(Fs - Fs_read) > FS_TOL:
                    raise Exception(
                        f"STX sample rate off: reading {Fs_read} Hz, desired {Fs} Hz"
                    ) from e

        @server.register_function
        def get_STX_baud_rate():
            return self._get_GRC("get_STXbaudRate")

    def _registerSoftCombinerMethods(self, server):
        @server.register_function
        def get_active_workers(timeout=0.25):
            """Names of diversity channels that submitted data recently."""
            if self.softCombiner is None:
                return []
            return self.softCombiner.getActiveWorkers(timeout)

    # ---------------- lifecycle ----------------

    def terminate(self):
        self._stopEvent.set()
        try:
            self.rpcServ.server_close()
        except Exception:
            pass

    def run(self):
        self.rpcServ.timeout = 0.5
        while not self._stopEvent.is_set():
            self.rpcServ.handle_request()
        log.info("XMLRPC server terminated")

    # ---------------- GRC helpers ----------------

    def _get_GRC(self, cmd):
        try:
            return getattr(self.GRCRpc, cmd)()
        except Exception:
            msg = f"Could not execute GRC command '{cmd}' -- is GRC running?"
            log.warning("RPC call error: %s", msg)
            raise Exception(msg)

    def _set_GRC(self, cmd, val):
        try:
            getattr(self.GRCRpc, cmd)(val)
        except Exception:
            msg = f"Could not execute GRC command '{cmd}' -- is GRC running?"
            log.warning("RPC call error: %s", msg)
            raise Exception(msg)

    def start_GRC(self):
        """Forward start() to the GRC service control."""
        log.info("Starting GRC")
        self.GRCServiceControl.start()
        self.GRCRunning = True
        return 1

    def kill_GRC(self):
        """Forward kill() to the GRC service control."""
        log.info("Stopping GRC")
        self.GRCRunning = False
        try:
            socket.setdefaulttimeout(5)
            self.GRCServiceControl.kill()
            socket.setdefaulttimeout(1)
        except socket.timeout:
            raise TimeoutError("Timeout while attempting to kill GRC")
        return 1


class dummyModulator:
    """Implements the modulator/demodulator value surface for unit tests
    (reference rpcInterface.py:505-529)."""

    def __init__(self):
        self._Fs = 256
        self._rangerate = 10.2
        self._Fc = 10000
        self.TxRangeRate = 0.0
        self.RxFreqOffset = 0.0
        self.RxIFFreqOffset = 0.0
        self.TxIFFreqOffset = 0.0
        self.SNR = 0.0
        self.baudRateEst = 0.0
        self.workerId = "dummy"
        self.centreFreqOffset = 0
        self.freqOffset = 0
        self.totalFreqOffset = 0
        self.baudRate = 9600
        self.numSyncFlags = 2

    @property
    def Fs(self):
        return self._Fs

    @property
    def Fc(self):
        return self._Fc

    @property
    def rangerate(self):
        return self._rangerate

    @rangerate.setter
    def rangerate(self, rangerate):
        log.warning("Dummy method received rangerate %f", rangerate)
        self._rangerate = rangerate
