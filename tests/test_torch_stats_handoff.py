"""The decoder's stats hand-off at shutdown (``runtime/decoder_process.py``):
the parent (``Decoder.getVisualData``) waits for the first stats message
while the child lives, so a child that binds its PUSH socket more than one
2 s poll after the parent connected still hands its stats over; a child
that is gone and sent nothing costs one poll. Ports 19945-19947, below the
kernel's ephemeral range."""

import threading
import time

import zmq

from pycusdr_tpu_torch.runtime.decoder_process import Decoder

STATS_PORT = 19945


def _decoder():
    conf = {"Main": {}, "decoder": {"statsPort": STATS_PORT},
            "Interfaces": {"External": {"decodeBytesOut_ZMQ": {"UHF": "tcp://*:19946"}},
                           "Internal": {"decodeIn": "tcp://*:19947"}}}
    return Decoder(conf, None)


def _late_child(delay, items):
    """What the child does at shutdown, ``delay`` s after the parent began
    waiting: bind the stats port and push ``items``."""
    time.sleep(delay)
    ctx = zmq.Context()
    sock = ctx.socket(zmq.PUSH)
    sock.setsockopt(zmq.SNDTIMEO, 2000)
    sock.bind(f"tcp://*:{STATS_PORT}")
    for item in items:
        sock.send_pyobj(item)
    sock.close(linger=2000)
    ctx.term()


def test_stats_of_a_late_child_arrive():
    dec = _decoder()
    dec.is_alive = lambda: True  # the child is still leaving its loop
    items = [{"workerId": "a", "n": 1}, {"workerId": "a~r1", "n": 2}]
    child = threading.Thread(target=_late_child, args=(3.0, items))
    child.start()
    try:
        assert dec.getVisualData() == items
    finally:
        child.join(timeout=10)
    assert not child.is_alive()


def test_a_gone_child_costs_one_poll():
    dec = _decoder()
    dec.is_alive = lambda: False
    t0 = time.time()
    assert dec.getVisualData() == []
    assert time.time() - t0 < 4.0
