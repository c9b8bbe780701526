"""Hamlib ``rigctld``-compatible rig server (the port's copy of
``pycusdr_tpu/control/rig_server.py``, byte for byte on the wire).

Capability parity with ``pyCuSDR/rig_server.py``: implements enough of
the hamlib wire protocol (``\\set_freq``, ``\\get_freq``,
``\\set_split_freq``, ``\\chk_vfo``, ``\\dump_state``, plus the
single-letter short commands) that **gpredict can steer Doppler**: a
``set_freq`` is converted to a rangerate via the radio's configured
centre frequency and pushed into the modulator/demodulator processes.
One ``Rig_server`` thread serves one accepted TCP client.

On a booted modem the Tx steer (``I``, ``\\set_split_freq``, and
``\\set_rangerate``) reaches the ``Modulator_process`` child through its
shared values. The Rx steer (``F``) assigns ``freq_hl`` on the first Rx
radio, which a ``Demodulator_process`` does not have (neither does the
JAX package's): it stores a parent-side attribute that ``f`` reads back,
and the child's own Doppler search is untouched, as in the reference.
"""

import logging
import socket
import threading
from enum import Enum

from pycusdr_tpu_torch.control.dummy_radios import DummyRadio

log = logging.getLogger(__name__)


class Response_codes(Enum):
    SUCCESS = 0
    UNIMPLEMENTED = -4
    PARAM = -1
    PROTOCOL = -8


SHORT_TO_LONG_CMD = {
    b"f": b"\\get_freq",
    b"F": b"\\set_freq",
    b"I": b"\\set_split_freq",
    b"i": b"\\get_split_freq",
    b"S": b"\\set_split_vfo",
    b"s": b"\\get_split_vfo",
    b"V": b"\\set_vfo",
    b"v": b"\\get_vfo",
    b"M": b"\\set_mode",
    b"m": b"\\get_mode",
    b"X": b"\\set_split_mode",
    b"x": b"\\get_split_mode",
}

# minimal rigctld capability dump accepted by gpredict/hamlib
DUMP_STATE = (
    "0\n2\n2\n150000.000000 30000000.000000  0x900af -1 -1 0x10 000003 0x3\n"
    "0 0 0 0 0 0 0\n"
    "150000.000000 30000000.000000  0x900af -1 -1 0x10 000003 0x3\n"
    "0 0 0 0 0 0 0\n0 0\n0 0\n0\n0\n0\n0\n\n\n0x0\n0x0\n0x0\n0x0\n0x0"
)


class Rig_server(threading.Thread):
    """Serves one hamlib TCP client (gpredict connection)."""

    def __init__(self, sock, addr, radios_rx, radios_tx):
        threading.Thread.__init__(self)
        self.daemon = True
        self.addr = addr
        self.sock = sock
        self.sock.settimeout(0.5)

        self.radios_rx = radios_rx if radios_rx else [DummyRadio()]
        self.radios_tx = radios_tx if radios_tx else [DummyRadio()]

        self._running_state = True
        self.rx_buf = b""
        self._mode = "CW"
        self._vfo = "VFOA"
        log.info("hamlib client from %s", addr)

    # ---------------- wire helpers ----------------

    def _send(self, data_bs):
        try:
            self.sock.sendall(data_bs)
        except socket.error:
            self.sock.close()
            self._running_state = False

    def send_response(self, data):
        if isinstance(data, Enum):
            self._send(f"RPRT {data.value}\n".encode("ascii"))
        else:
            self._send(f"{data}\n".encode("ascii"))

    # ---------------- command dispatch ----------------

    def parse_commands(self, cmd, val):
        if b"set" in cmd:
            if cmd == b"\\set_freq":
                self.rx_freq = float(val)
                self.send_response(Response_codes.SUCCESS)
            elif cmd == b"\\set_split_freq":
                self.tx_freq = float(val)
                self.send_response(Response_codes.SUCCESS)
            elif cmd == b"\\set_rangerate":
                rr = float(val)
                for r in self.radios_rx + self.radios_tx:
                    r.rangerate = rr
                self.send_response(Response_codes.SUCCESS)
            elif cmd == b"\\set_vfo":
                self._vfo = val.decode("ascii", "replace").strip()
                self.send_response(Response_codes.SUCCESS)
            else:
                self.send_response(Response_codes.UNIMPLEMENTED)
        else:
            if cmd == b"\\get_freq":
                self.send_response(self.rx_freq)
            elif cmd == b"\\get_split_freq":
                self.send_response(self.tx_freq)
            elif cmd == b"\\get_vfo":
                self.send_response(self.vfo)
            elif cmd == b"\\get_split_vfo":
                self.send_response(f"0 {self.vfo}")
            elif cmd == b"\\get_rangerate":
                self.send_response(self.radios_rx[0].rangerate)
            else:
                self.send_response(Response_codes.UNIMPLEMENTED)

    def check_for_commands(self):
        while b"\n" in self.rx_buf:
            cmd_full, self.rx_buf = self.rx_buf.split(b"\n", 1)
            cmd_full = cmd_full.strip()
            if not cmd_full:
                continue
            try:
                if cmd_full.startswith(b"\\\\") or cmd_full.startswith(b"\\c") or \
                        cmd_full.startswith(b"\\d"):
                    if b"chk_vfo" in cmd_full:
                        self.send_response("CHKVFO 0")
                    elif b"dump" in cmd_full:
                        self.send_response(DUMP_STATE)
                    else:
                        self.send_response(Response_codes.UNIMPLEMENTED)
                elif cmd_full.startswith(b"\\"):
                    parts = cmd_full.split(b" ", 1)
                    cmd = parts[0]
                    val = parts[1] if len(parts) > 1 else b"0"
                    self.parse_commands(cmd, val)
                else:
                    parts = cmd_full.split(b" ", 1)
                    cmd = SHORT_TO_LONG_CMD.get(parts[0], b"")
                    val = parts[1] if len(parts) > 1 else b"0"
                    if cmd == b"":
                        self.send_response(Response_codes.UNIMPLEMENTED)
                    else:
                        self.parse_commands(cmd, val)
            except Exception as e:
                log.error("error parsing hamlib command %s", cmd_full)
                log.exception(e)

    def run(self):
        while self._running_state:
            try:
                t = self.sock.recv(1024)
            except socket.timeout:
                continue
            except socket.error:
                continue
            if not t:
                break
            self.rx_buf += t
            self.check_for_commands()
        log.info("hamlib socket from %s:%s closed", self.addr[0], self.addr[1])

    def terminate(self):
        self._running_state = False

    # ---------------- radio steering ----------------

    @property
    def rx_freq(self):
        return self.radios_rx[0].freq_hl

    @rx_freq.setter
    def rx_freq(self, val):
        self.radios_rx[0].freq_hl = val
        log.debug("rx rangerate %s", self.radios_rx[0].rangerate)

    @property
    def tx_freq(self):
        return self.radios_tx[0].freq_hl

    @tx_freq.setter
    def tx_freq(self, val):
        # all Tx channels derive their rangerate from the same steer
        for r in self.radios_tx:
            r.freq_hl = val

    @property
    def vfo(self):
        return self._vfo


class Rig_listener(threading.Thread):
    """Accept loop: spawns one Rig_server per hamlib client."""

    def __init__(self, host, port, radios_rx, radios_tx):
        threading.Thread.__init__(self)
        self.daemon = True
        self.radios_rx = radios_rx
        self.radios_tx = radios_tx
        self.servers = []
        self._stop = threading.Event()
        self.lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.lsock.bind((host, port))
        self.lsock.listen(4)
        self.lsock.settimeout(0.5)
        log.info("hamlib rig listener on %s:%s", host, port)

    def run(self):
        while not self._stop.is_set():
            try:
                sock, addr = self.lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            srv = Rig_server(sock, addr, self.radios_rx, self.radios_tx)
            srv.start()
            self.servers.append(srv)
        self.lsock.close()

    def terminate(self):
        self._stop.set()
        for s in self.servers:
            s.terminate()
