"""The CC11xx and AX.25 links of the port on the CPU against the JAX
package: the framers' bits and the ``Modulator`` waveforms equal to JAX's
(CC11xx at the operational 128 samples a symbol and at the tests' 16),
the cases of ``tests/test_cc11xx_e2e.py`` and the two full-loop cases of
``tests/test_ax25.py`` through the port's ``models.uhf.Demodulator`` and
``decode.Decoder``, one CC11xx block within the golden table of
``tests/test_dsp_golden.py:89-132`` against JAX's graph, and decoded
packets equal to JAX's byte for byte.

Tolerances: framers, waveforms and decoded packets exactly; the block
outputs as the golden table: E rtol 2e-3, shift and nSym exact, bits
equal, symbols >= 99.9 %, centres within the window W, SNR within 0.5 dB.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pycusdr_tpu.decode import Decoder as JDecoder
from pycusdr_tpu.dsp.block import build_process_block as jax_build_process_block
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.models import UHF as JUHF
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.protocol import loadProtocol as jload
from pycusdr_tpu.tx import encoders as jenc
from pycusdr_tpu.tx.modulator import Modulator as JModulator
from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.convert import spec_from_numpy
from pycusdr_tpu_torch.decode import Decoder
from pycusdr_tpu_torch.dsp.block import build_process_block
from pycusdr_tpu_torch.dsp.signal_gen import awgn
from pycusdr_tpu_torch.models import UHF
from pycusdr_tpu_torch.protocol import loadProtocol
from pycusdr_tpu_torch.tx import DataLengthError
from pycusdr_tpu_torch.tx import encoders as penc
from pycusdr_tpu_torch.tx.modulator import Modulator

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(__file__), "..")
CC11XX_JSON = os.path.join(REPO, "pycusdr_tpu_torch", "config", "configs", "CC11xx.json")
TX_RADIO = {"baud": 9600, "samplesPerSym": 16, "frequency_Hz": 437.3e6,
            "frequencyOffset_Hz": 38400, "Protocol": "UHF"}
CC11XX_PROTOCOL = {
    "rx_preamble": ["0xaa", "0xaa", "0xaa", "0xaa"],
    "rx_sync_seq": ["0xd6", "0xba", "0xd6", "0xba"],
    "tx_preamble": ["0xaa"],
    "tx_num_preambles": 10,
    "tx_sync_seq": ["0xd6", "0xba", "0xd6", "0xba"],
}


def _copy(bench_conf):
    return {k: (dict(v) if isinstance(v, dict) else v) for k, v in bench_conf.items()}


@pytest.fixture(scope="module")
def cc_conf(bench_conf):
    """``tests/test_cc11xx_e2e.py``'s config (blockSize 13, 16 samples a
    symbol, 16 Doppler steps)."""
    conf = _copy(bench_conf)
    conf["Main"] = dict(conf["Main"], protocols={"UHF": "CC11xx"})
    rx = dict(conf["Radios"]["Rx"]["UHF-H"])
    conf["Radios"] = {"rangeRateMax": 7500, "Protocol": dict(CC11XX_PROTOCOL),
                      "Rx": {"UHF-H": rx}, "Tx": {"UHF": dict(TX_RADIO)}}
    return conf


def ax25_conf(bench_conf, modulation):
    conf = _copy(bench_conf)
    conf["Main"] = dict(conf["Main"], protocols={"UHF": "AX25"})
    conf["Radios"] = dict(conf["Radios"])
    if modulation == "GMSK":
        # short preamble, as tests/test_ax25.py's GMSK case
        conf["Radios"]["Protocol"] = {"ax25_modulation": "GMSK", "tx_num_preambles": 4}
    conf["Radios"]["Tx"] = {"UHF": dict(TX_RADIO)}
    return conf


def stream_blocks(demod, sig):
    """Per-hop ``uploadAndFindCarrier`` + ``demodulate`` over ``sig``
    padded to whole hops plus a flush hop (``run_modem_stream``); returns
    the (bits, trust) of each block."""
    ov, step = demod.sigOverlap, demod.Nfft - demod.sigOverlap
    n_blocks = int(np.ceil(len(sig) / step)) + 1
    sig = np.r_[sig, np.zeros(n_blocks * step - len(sig) + step, np.complex64)]
    raw = demod.get_signalBufferHostPointer()
    out, pos = [], 0
    while pos + step <= len(sig):
        raw[ov:] = sig[pos:pos + step]
        demod.uploadAndFindCarrier(raw)
        bits, _, trust, _ = demod.demodulate()
        out.append((np.asarray(bits), np.asarray(trust)))
        raw[:ov] = raw[-ov:]
        pos += step
    return out


def decode(decoder, blocks):
    """Every packet ``findFrames`` returns over the blocks, as (start,
    raw bits, payload bytes, CRC error)."""
    out = []
    for bits, _ in blocks:
        for p in decoder.findFrames(bits, 0)[0]:
            data, err, _ = p.getBinaryData()
            out.append((int(getattr(p, "frameStartIdx", 0)), np.asarray(p.bits).tolist(),
                        np.asarray(data).tolist(), bool(err)))
    return out


def clean_payloads(pkts):
    return [bytes(d) for _, _, d, err in pkts if not err]


# ---------------- framers and waveforms ----------------


@pytest.mark.parametrize("payload_len", [0, 1, 40, 253])
def test_cc11xx_encoder_bits_equal(cc_conf, payload_len):
    payload = np.random.RandomState(payload_len).randint(0, 256, payload_len).astype(np.uint8)
    p = penc.CC11xxEncoder(loadProtocol("CC11xx")(conf=cc_conf), {})
    j = jenc.CC11xxEncoder(jload("CC11xx")(conf=cc_conf), {})
    a, b = p.encodeAndFrame(payload), j.encodeAndFrame(payload)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(p.encodeAndFrame(payload.tobytes()), a)


def test_cc11xx_encoder_refuses_long_payload(cc_conf):
    enc = penc.CC11xxEncoder(loadProtocol("CC11xx")(conf=cc_conf), {})
    with pytest.raises(DataLengthError):
        enc.encodeAndFrame(np.zeros(254, np.uint8))


@pytest.mark.parametrize("modulation", ["FSK", "GMSK"])
def test_ax25_encoder_bits_equal(bench_conf, modulation):
    conf = ax25_conf(bench_conf, modulation)
    payload = np.frombuffer(b"AX25 FRAMER EQUAL TO JAX", np.uint8)
    a = penc.AX25Encoder(loadProtocol("AX25")(conf=conf), {}).encodeAndFrame(payload)
    b = jenc.AX25Encoder(jload("AX25")(conf=conf), {}).encodeAndFrame(payload)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", ["CC11xx.json", "cc_test", "AX25/FSK", "AX25/GMSK"])
def test_modulator_waveforms_equal(bench_conf, cc_conf, case):
    """``Modulator.encodeAndModulate`` at a range rate and a centre
    offset: the port's waveform equal to JAX's."""
    if case == "CC11xx.json":
        conf, name = load_modular_json(CC11XX_JSON), "CC11xx"
    elif case == "cc_test":
        conf, name = cc_conf, "CC11xx"
    else:
        conf, name = ax25_conf(bench_conf, case.split("/")[1]), "AX25"
    radio = conf["Radios"]["Tx"]["UHF"]
    mods = [M(conf, radio, P(name)(conf=conf))
            for M, P in ((Modulator, loadProtocol), (JModulator, jload))]
    payload = np.random.RandomState(11).randint(0, 256, 61).astype(np.uint8)
    waves = []
    for m in mods:
        m.set_rangerate(-1234.5)
        m.TxCentreFreqOffset = 250.0
        m.numSyncFlags = 6
        waves.append(m.encodeAndModulate(payload))
    assert waves[0].dtype == waves[1].dtype == np.complex64
    assert np.array_equal(waves[0], waves[1])


# ---------------- the CC11xx link (tests/test_cc11xx_e2e.py) ----------------

#: the JAX test's payload, one at the length byte's limit, one of a byte
PAYLOADS = [np.r_[np.array([7], np.uint8), np.arange(1, 40, dtype=np.uint8)],
            np.random.RandomState(17).randint(0, 256, 253).astype(np.uint8),
            np.array([0x5A], np.uint8)]


@pytest.fixture(scope="module")
def cc_link(cc_conf):
    """The payloads back to back through both Modulators (equal waves),
    AWGN at 20 dB over them and a tail, then each package's UHF
    demodulator per hop."""
    pp, jp = loadProtocol("CC11xx")(conf=cc_conf), jload("CC11xx")(conf=cc_conf)
    radio = cc_conf["Radios"]["Tx"]["UHF"]
    waves = [np.concatenate([M(cc_conf, radio, p).encodeAndModulate(x) for x in PAYLOADS])
             for M, p in ((Modulator, pp), (JModulator, jp))]
    assert np.array_equal(waves[0], waves[1])
    # the FIXED window (267 bytes after the sync) of the last packet must
    # arrive before the decoder emits it: 5 hops of tail at this shape
    tail = np.zeros(5 * (2**13 - 2**10), np.complex64)
    sig = awgn(np.r_[waves[0], tail].astype(np.complex64), 20.0,
               rng=np.random.RandomState(1)).astype(np.complex64)
    return dict(
        sig=sig, n_signal_hops=len(waves[0]) // (2**13 - 2**10),
        port=stream_blocks(UHF.Demodulator(cc_conf, pp, "UHF-H", device="cpu"), sig),
        jax=stream_blocks(JUHF.Demodulator(cc_conf, jp, "UHF-H"), sig))


def test_cc11xx_tx_to_rx_bit_exact(cc_conf, cc_link):
    """Every payload, the one of 253 bytes over several blocks among
    them, recovered by the port with its CRC intact."""
    pkts = decode(Decoder(cc_conf.get("decoder", {}), loadProtocol("CC11xx")(conf=cc_conf)),
                  cc_link["port"])
    got = clean_payloads(pkts)
    for x in PAYLOADS:
        assert bytes(x) in got, f"payload of {len(x)} bytes not recovered CRC-clean"


def test_cc11xx_packets_equal_jax(cc_conf, cc_link):
    """The port's Decoder on the port's bits gives JAX's Decoder's packets
    on the same bits, and the same payloads as the JAX chain."""
    dconf = cc_conf.get("decoder", {})
    port = decode(Decoder(dconf, loadProtocol("CC11xx")(conf=cc_conf)), cc_link["port"])
    assert port == decode(JDecoder(dconf, jload("CC11xx")(conf=cc_conf)), cc_link["port"])
    jax = decode(JDecoder(dconf, jload("CC11xx")(conf=cc_conf)), cc_link["jax"])
    assert clean_payloads(port) == clean_payloads(jax)
    # the two demodulators may decide differently on noise-dominated
    # samples (ROADMAP.md Queue 3): the blocks wholly inside the packets
    # must be equal, the first (noise, then the preamble) and the tail's
    # are printed where they differ
    inside = range(1, cc_link["n_signal_hops"])
    assert len(inside) >= 4
    for i, ((a_bits, a_trust), (b_bits, b_trust)) in enumerate(zip(cc_link["port"],
                                                                     cc_link["jax"])):
        same = np.array_equal(a_bits, b_bits) and np.array_equal(a_trust, b_trust)
        if i in inside:
            assert same, f"block {i} inside the packets: bits or trust differ from JAX's"
        elif not same:
            print(f"block {i} (noise-dominated): {len(a_bits)} bits, JAX {len(b_bits)}")


@pytest.fixture(scope="module")
def cc_block(cc_conf, cc_link):
    """Block 2 of the stream (inside the 253-byte packet) through both
    graphs."""
    jp = jload("CC11xx")(conf=cc_conf)
    jspec = jax_build_spec(cc_conf, jp, "UHF-H")
    spec = spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})
    assert spec.masks_f.tobytes() == build_spec_port(cc_conf).masks_f.tobytes()
    step = jspec.Nfft - jspec.sigOverlap
    sig = cc_link["sig"][2 * step - jspec.sigOverlap:3 * step]  # block 2, inside a packet
    jx = {k: np.asarray(v) for k, v in jax_build_process_block(jspec)(c2ri(sig)).items()}
    pt = {k: v.numpy() for k, v in
          build_process_block(spec, device="cpu")(torch.from_numpy(sig)).items()}
    return spec, jx, pt


def build_spec_port(conf):
    from pycusdr_tpu_torch.dsp.spec import build_spec

    return build_spec(conf, loadProtocol("CC11xx")(conf=conf), "UHF-H")


class TestCC11xxBlockGolden:
    def test_energy_matrix(self, cc_block):
        _, jx, pt = cc_block
        assert np.allclose(pt["E"], jx["E"], rtol=2e-3)

    def test_doppler_decision(self, cc_block):
        _, jx, pt = cc_block
        assert int(pt["shift"]) == int(jx["shift"])
        assert abs(float(pt["doppler_hz"]) - float(jx["doppler_hz"])) < 1.0

    def test_symbols_bits_centres(self, cc_block):
        spec, jx, pt = cc_block
        n = int(pt["nSym"])
        assert n == int(jx["nSym"])
        assert np.mean(pt["symbols"][:n] == jx["symbols"][:n]) >= 0.999
        assert np.array_equal(pt["bits"][:n], jx["bits"][:n])
        assert np.abs(pt["centres"][:n] - jx["centres"][:n]).max() <= spec.windowWidth

    def test_snr(self, cc_block):
        _, jx, pt = cc_block
        assert abs(float(pt["snr_db"]) - float(jx["snr_db"])) < 0.5


# ---------------- the AX.25 full loops (tests/test_ax25.py) ----------------


@pytest.mark.parametrize("modulation,payload,seed", [
    ("FSK", b"HELLO VIA AX25 FROM THE TPU MODEM " * 3, 4),
    ("GMSK", b"G3RUH AX25 OVER GMSK ON TPU ", 6),
], ids=["FSK", "GMSK"])
def test_ax25_full_modem_loop(bench_conf, modulation, payload, seed):
    """Tx framer + LUT -> AWGN at 22 dB -> streamed Rx -> AX.25 decode on
    the port: the payload CRC-clean, and the packets equal to JAX's
    chain's byte for byte."""
    conf = ax25_conf(bench_conf, modulation)
    pp, jp = loadProtocol("AX25")(conf=conf), jload("AX25")(conf=conf)
    assert pp.modulation == modulation
    payload = np.frombuffer(payload, np.uint8)
    radio = conf["Radios"]["Tx"]["UHF"]
    wave = Modulator(conf, radio, pp).encodeAndModulate(payload)
    assert np.array_equal(wave, JModulator(conf, radio, jp).encodeAndModulate(payload))
    sig = awgn(wave.astype(np.complex64), 22.0,
               rng=np.random.RandomState(seed)).astype(np.complex64)
    port = decode(Decoder(conf, pp),
                  stream_blocks(UHF.Demodulator(conf, pp, "UHF-H", device="cpu"), sig))
    good = [d for _, _, d, err in port if not err]
    assert good, "no CRC-clean AX.25 packet"
    assert bytes(good[0]) == bytes(payload)
    jax = decode(JDecoder(conf, jp), stream_blocks(JUHF.Demodulator(conf, jp, "UHF-H"), sig))
    assert clean_payloads(port) == clean_payloads(jax)


# ---------------- the blocks' seam at 128 samples a symbol ----------------


def seam_blocks(spsym, n_blocks, seed, Nfft=2**13, ov=2**10):
    """Blocks of a symbol stream as the graph hands them to the healer:
    symbol j at global sample phase + j spsym, each block's timing
    estimate off by its own -2..2 samples, and one block whose symbols
    land exactly on the seam (the half overlap's edge). Returns (sent
    bits, [(centres, bits, trust) per block], the index of the first
    symbol of the first block's window)."""
    rng = np.random.RandomState(seed)
    hop = Nfft - ov
    n_sym = (n_blocks * hop + Nfft) // spsym + 2
    sent = rng.randint(0, 2, n_sym).astype(np.int8)
    phase = ov // 2 - spsym * (ov // 2 // spsym)  # a centre exactly on the seam
    blocks = []
    for i in range(n_blocks):
        jitter = 0 if i == 1 else rng.randint(-2, 3)
        g = phase + np.arange(n_sym) * spsym + jitter
        sel = (g >= i * hop + 2) & (g < i * hop + Nfft - 2)
        c = (g[sel] - i * hop).astype(np.float32)
        blocks.append((c, sent[sel], np.full(int(sel.sum()), 2, np.int8)))
        if i == 0:
            first = int(np.nonzero(sel & (g >= ov // 2))[0][0])
    return sent, blocks, first


def heal_stream(healer, blocks, spsym, **kw):
    out = []
    for c, b, tr in blocks:
        _, bits, _, _ = healer.heal(0, c, b, b, tr, **kw)
        out.append(np.asarray(bits))
    return np.concatenate(out)


def test_seam_at_128_samples_a_symbol_keeps_every_symbol():
    """At 128 samples a symbol the half overlap (512 samples) holds 4
    symbols, too few for the bit match: the port's healer starts each
    window on the symbol clock, so the stream is the sent one, with no
    symbol repeated or dropped at any seam. JAX's healer on the same
    blocks repeats or drops symbols at seams (printed)."""
    from pycusdr_tpu.models.healing import BlockHealer as JBlockHealer
    from pycusdr_tpu_torch.models.healing import BlockHealer

    for seed in range(4):
        sent, blocks, first = seam_blocks(128, 24, seed)
        got = heal_stream(BlockHealer(2**13, 2**10), blocks, 128, spSym=128.0)
        assert np.array_equal(got, sent[first:first + len(got)]), f"seed {seed}"
        # 56 symbols a hop; the last window's end moves with its block's jitter
        assert abs(len(got) - 24 * 56) <= 1, f"seed {seed}: {len(got)} symbols"
        jgot = heal_stream(JBlockHealer(2**13, 2**10), blocks, 128)
        print(f"seed {seed}: JAX's healer emits {len(jgot)} symbols of {len(got)}")


@pytest.mark.parametrize("seed", [0, 1])
def test_seam_at_16_samples_a_symbol_equals_jax(seed):
    """Where the half overlap holds 32 symbols the port's healer runs
    JAX's bit match: the same stream as JAX's healer, bit for bit."""
    from pycusdr_tpu.models.healing import BlockHealer as JBlockHealer
    from pycusdr_tpu_torch.models.healing import BlockHealer

    _, blocks, _ = seam_blocks(16, 12, seed)
    assert np.array_equal(heal_stream(BlockHealer(2**13, 2**10), blocks, 16, spSym=16.0),
                          heal_stream(JBlockHealer(2**13, 2**10), blocks, 16))


def test_cc11xx_link_at_128_samples_a_symbol():
    """CC11xx.json's 128 samples a symbol at blockSize 13 (56 symbols a
    hop, 8 in the overlap; 16 Doppler steps): six payloads of 1 to 253
    bytes at their own range rates and -3 dB a sample, each recovered by
    the port CRC-clean. The JAX chain on the same stream is printed."""
    from pycusdr_tpu.models import UHF as JUHF

    conf = load_modular_json(CC11XX_JSON)
    conf["GPU"]["UHF"]["blockSize"] = 13
    conf["Radios"]["Rx"]["UHF-H"]["doppCarrierSteps"] = 16
    conf["Radios"]["rangeRateMax"] = 3000
    pp = loadProtocol("CC11xx")(conf=conf)
    mod = Modulator(conf, conf["Radios"]["Tx"]["UHF"], pp)
    rng = np.random.RandomState(5)
    payloads = [rng.randint(0, 256, n).astype(np.uint8)
                for n in rng.permutation([253, 1, 40, 100, 17, 200])]
    waves = []
    for k, p in enumerate(payloads):
        mod.set_rangerate(-1000.0 + 10.0 * k)
        waves.append(mod.encodeAndModulate(p))
    hop = 2**13 - 2**10
    tail = np.zeros(-(-267 * 8 * 128 // hop) * hop, np.complex64)  # the last FIXED window
    sig = awgn(np.r_[np.concatenate(waves), tail].astype(np.complex64), -3.0, measured=False,
               rng=np.random.RandomState(2)).astype(np.complex64)
    got = clean_payloads(decode(Decoder(conf, pp), stream_blocks(
        UHF.Demodulator(conf, pp, "UHF-H", device="cpu"), sig)))
    assert [len(p) for p in payloads if bytes(p) not in got] == []
    jp = jload("CC11xx")(conf=conf)
    jgot = clean_payloads(decode(JDecoder(conf, jp), stream_blocks(
        JUHF.Demodulator(conf, jp, "UHF-H"), sig)))
    print(f"JAX's chain recovers {sum(bytes(p) in jgot for p in payloads)} of {len(payloads)}")
