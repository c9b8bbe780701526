"""The port's station harnesses (``pycusdr_tpu_torch/bench/``) on the CPU
(``device="cpu"``), against the JAX package's (``pycusdr_tpu/bench/``):

- ``modulation_bandwidth`` and ``popcount_bit_errors`` equal JAX's;
- ``run_ber_sweep`` through the port's ``PyCuSDR`` at a clean SNR returns
  the packet JAX's sweep counts its errors against (the JAX protocol's
  bytes of the seeded packet), bit-exact, with the children's kernel
  launches (one of each of K1-K5 a block: their plain versions on the CPU
  count none) and devices; the model is ``tests/test_bench.py:9-20``;
- ``run_diversity`` at a clean SNR: both arms deliver packets, the voted
  arm a clean one (``tests/test_bench.py:31-53``);
- ``ber_delta``'s two arms (the port's block graph, the port's golden)
  equal JAX's two arms (its block graph, its golden) at 10 dB on FSK at
  blockSize 13 with 1000-bit packets: the same packets found in the same
  runs with the same bit errors;
- ``hw_selfcheck`` on the CPU passes every check and returns 0.

Process tests bind ports 19500-19515, 19600-19615, 19700-19715 and
19800-19815; every wait in the harnesses is bounded (``ready_timeout``,
``drain_cap``)."""

import numpy as np
import pytest

from pycusdr_tpu.bench import ber as jax_ber
from pycusdr_tpu.config.loader import load_modular_json as jax_load
from pycusdr_tpu.dsp.signal_gen import packet_data as jax_packet_data
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch.bench import ber, ber_delta, diversity, hw_selfcheck

PACKET_LEN = 1000


def _jax_expected(modulation="FSK"):
    """The bytes JAX's ``run_ber_sweep`` compares every decoded packet to."""
    conf = jax_load(f"{jax_ber.CONF_DIR}/benchmark/bench_{modulation}.json")
    conf["Main"].update(PacketLen=PACKET_LEN, RandSeed=123)
    bits = jax_packet_data(PACKET_LEN, 123)
    proto = jax_loadProtocol(f"bench_{modulation}")(conf=conf)
    return bytes(bytearray(proto.Packet(bits).getBinaryData()[0]))


@pytest.mark.parametrize("mod", ["FSK", "GFSK", "GMSK", "BPSK"])
def test_modulation_bandwidth_equals_jax(mod):
    for baud in (1200.0, 7416.0, 9600.0):
        assert ber.modulation_bandwidth(mod, baud) == jax_ber.modulation_bandwidth(mod, baud)


def test_popcount_bit_errors_equals_jax():
    rng = np.random.RandomState(3)
    for n, m in ((0, 0), (16, 16), (16, 12), (5, 9)):
        a, b = rng.bytes(n), rng.bytes(m)
        assert ber.popcount_bit_errors(a, b) == jax_ber.popcount_bit_errors(a, b)


def test_ber_sweep_on_the_cpu_gives_jax_packets():
    res = ber.run_ber_sweep("FSK", nRuns=3, snrs=[18.0], packetLen=PACKET_LEN, blockSize=13,
                            basePort=19500, fsSimFactor=2.0, settle=8.0, device="cpu")
    want = _jax_expected("FSK")
    got = res["payloads"][0]
    assert len(got) >= 2, f"too few packets: {res['numPackets']}"
    assert all(p == want for p in got), f"bit errors {res['bitErrors']}"
    assert res["BER"][0] == 0.0
    assert abs(res["EBN0"][0] - (18.0 + 10 * np.log10(3.0))) < 0.01
    assert res["devices"] == ["cpu"] and res["blocks"] > 0
    # the CPU runs every kernel's plain version: no launch is counted
    assert res["launches"] and not any(res["launches"].values()), res["launches"]


def test_diversity_on_the_cpu_delivers_voted_packets():
    rows = diversity.run_diversity("FSK", snrs=(18.0,), runs=2, packetLen=PACKET_LEN,
                                   basePort=19510, fsSimFactor=2.0, fsSimFactor3=1.5,
                                   verbose=False, device="cpu", blockSize=13,
                                   settle=10.0)
    (row,) = rows
    assert row["packets_1ch"] >= 1 and row["ber_1ch"] == 0.0, row
    assert row["packets_3ch_voted"] >= 1, f"no packets through the vote: {row}"
    # combiner slicing can split a packet across vote boundaries: the
    # acceptance is a clean BEST voted packet, as tests/test_bench.py has it
    assert min(row["bit_errors_3ch"]) <= 5, row
    assert row["devices"] == ["cpu"] * 4 and row["blocks_1ch"] > 0 and row["blocks_3ch"] > 0


def test_ber_delta_arms_equal_jax_arms():
    from pycusdr_tpu.bench import ber_delta as jax_ber_delta

    kw = dict(modulations=("FSK",), snrs=[10.0], runs=2, packetLen=PACKET_LEN, blockSize=13,
              verbose=False)
    (row,) = ber_delta.run_delta(device="cpu", **kw)
    (want,) = jax_ber_delta.run_delta(**kw)
    assert row["found_device"] == want["found_tpu"] == 2, (row, want)
    assert row["found_golden"] == want["found_golden"] == 2, (row, want)
    assert sorted(row["bit_errors_device"]) == sorted(want["bit_errors_tpu"])
    assert sorted(row["bit_errors_golden"]) == sorted(want["bit_errors_golden"])
    assert row["ber_delta"] == want["ber_delta"]
    assert row["errors_by_run_device"] == row["errors_by_run_golden"]


def test_hw_selfcheck_on_the_cpu_passes():
    lines = []
    assert hw_selfcheck.run_selfcheck("cpu", out=lines.append) == 0, lines
    assert sum(line.startswith("PASS") for line in lines) == 5, lines
    assert hw_selfcheck.main(["--cpu"]) == 0
