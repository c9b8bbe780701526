"""Hamlib daemon: boot a full modem per incoming hamlib connection (the
port's copy of ``pycusdr_tpu/control/hamlib_daemon.py``; the modem is the
port's ``PyCuSDR``, on the card unless ``PYCUSDR_TORCH_DEVICE=cpu`` asks
for the CPU).

Capability parity with ``start_pyCuSDR_hamlib_daemon.py:49-106``: every
radio in ``hamlib_sockets.json`` gets its own TCP listener, all served
CONCURRENTLY (one daemon process covers the whole ground station, like
the reference's per-port fork loop); on connect, a complete ``PyCuSDR``
instance for that radio's config is started together with a
``Rig_server`` steering it, and everything is torn down when the client
disconnects.

Run: ``python -m pycusdr_tpu_torch.control.hamlib_daemon -c
pycusdr_tpu_torch/config/configs/hamlib_sockets.json [-v]``
"""

import argparse
import logging
import os
import socket
import threading
import time

from pycusdr_tpu_torch.config.loader import load_modular_json

log = logging.getLogger(__name__)


def _default_modem_factory(cfg_path, args):
    from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

    sdr = PyCuSDR(cfg_path, args)
    sdr.start()
    return sdr


def _default_rig_factory(sock, client, sdr):
    from pycusdr_tpu_torch.control.rig_server import Rig_server

    rig = Rig_server(sock, client, sdr.demodulators, sdr.modulators)
    rig.start()
    return rig


def serve_radio(name, entry, base_dir, args, *, modem_factory=_default_modem_factory,
                rig_factory=_default_rig_factory, stop=None, ready=None):
    """Listen on this radio's hamlib port; one modem per connection.

    ``stop`` (threading.Event) ends the accept loop; ``ready`` is set
    once the listener is bound (used by the concurrent daemon + tests).
    """
    addr, port = entry["addr"], int(entry["port"])
    cfg_path = os.path.join(base_dir, entry["config"])

    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind((addr, port))
    lsock.listen(1)
    lsock.settimeout(0.5)
    log.info("[%s] hamlib listener on %s:%s (config %s)", name, addr, port, cfg_path)
    if ready is not None:
        ready.set()

    try:
        while stop is None or not stop.is_set():
            try:
                sock, client = lsock.accept()
            except socket.timeout:
                continue
            log.info("[%s] client %s connected -- booting modem", name, client)
            sdr = modem_factory(cfg_path, args)
            rig = rig_factory(sock, client, sdr)
            try:
                while rig.is_alive() and sdr.is_alive():
                    if stop is not None and stop.is_set():
                        break
                    time.sleep(0.2)
            finally:
                log.info("[%s] client gone -- tearing down modem", name)
                rig.terminate()
                sdr.terminate()
    finally:
        lsock.close()


def serve_all(sockets, base_dir, args, *, modem_factory=_default_modem_factory,
              rig_factory=_default_rig_factory, stop=None, ready_events=None):
    """One listener thread per radio entry, all concurrent (reference
    ``start_pyCuSDR_hamlib_daemon.py:63-106`` serves every configured
    port simultaneously). Returns the (daemon) threads."""
    threads = []
    for name, entry in sockets.items():
        ready = None if ready_events is None else ready_events.setdefault(
            name, threading.Event())
        t = threading.Thread(
            target=serve_radio, args=(name, entry, base_dir, args),
            kwargs=dict(modem_factory=modem_factory, rig_factory=rig_factory,
                        stop=stop, ready=ready),
            name=f"hamlib-{name}", daemon=True)
        t.start()
        threads.append(t)
    return threads


def main(argv=None):
    p = argparse.ArgumentParser(prog="pycusdr_tpu_torch-hamlib-daemon")
    p.add_argument("-c", "--configFile", required=True,
                   help="hamlib_sockets.json (per-radio ports + configs)")
    p.add_argument("-r", "--radio", default=None,
                   help="serve only this radio entry (default: all, concurrently)")
    p.add_argument("-v", action="count", default=0, dest="v")
    args = p.parse_args(argv)

    sockets = load_modular_json(args.configFile)
    base_dir = os.path.dirname(os.path.abspath(args.configFile))
    if args.radio is not None:
        serve_radio(args.radio, sockets[args.radio], base_dir, args)
        return
    threads = serve_all(sockets, base_dir, args)
    for t in threads:
        t.join()


if __name__ == "__main__":
    main()
