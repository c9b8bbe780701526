"""The concatenated CCSDS downlink of the port on the CPU against the JAX
package: RS(255,223), the CRC/PN9 utilities, the framers, the LUT
modulators and ``Modulator``, the frame finder in its three end-detect
modes, and the whole chain (Tx -> AWGN -> UHF demodulator -> streaming
Viterbi -> frame sync -> RS) at the conf of ``examples/ccsds_downlink.py``.

Tolerances: every output is compared exactly (codewords, waveforms,
packets with their start index, ASM errors, ``nerr`` and payload). The
one exception is the whole chain across the two packages: their
demodulators may decide differently on noise-dominated samples (ROADMAP
Queue 3), so there the decoded payloads must be equal and ``nerr`` equal
only where the demodulated bits are; the test prints any difference.
"""

import numpy as np
import pytest

from pycusdr_tpu.decode import Decoder as JDecoder
from pycusdr_tpu.decode import rs as jrs
from pycusdr_tpu.dsp.signal_gen import awgn as jawgn
from pycusdr_tpu.models import UHF as JUHF
from pycusdr_tpu.protocol import loadProtocol as jload
from pycusdr_tpu.protocol.base import PacketEndDetect as JEnd
from pycusdr_tpu.tx import encoders as jenc
from pycusdr_tpu.tx import luts as jluts
from pycusdr_tpu.tx.modulator import Modulator as JModulator
from pycusdr_tpu.utils import crc as jcrc
from pycusdr_tpu.utils import shift_registers as jsr
from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.decode import Decoder
from pycusdr_tpu_torch.decode import rs as prs
from pycusdr_tpu_torch.dsp.signal_gen import awgn
from pycusdr_tpu_torch.models import UHF
from pycusdr_tpu_torch.protocol import loadProtocol
from pycusdr_tpu_torch.protocol.base import PacketEndDetect as PEnd
from pycusdr_tpu_torch.protocol.ccsds import RS_K, RS_N
from pycusdr_tpu_torch.tx import encoders as penc
from pycusdr_tpu_torch.tx import luts as pluts
from pycusdr_tpu_torch.tx.modulator import Modulator
from pycusdr_tpu_torch.utils import crc as pcrc
from pycusdr_tpu_torch.utils import shift_registers as psr

LOW_SNR_DB = -3.0  # per sample, unit-power FSK: raw BER ~5e-3 at the example conf


def protocols(name="ccsds_conv", conf=None):
    """(port protocol on the CPU, JAX protocol)."""
    kw = {"device": "cpu"} if name.startswith("ccsds_conv") else {}
    return loadProtocol(name)(conf=conf, **kw), jload(name)(conf=conf)


def packets_of(pkts):
    """Every packet's start index, ASM/header errors, raw bits, nerr and
    decoded bytes."""
    out = []
    for p in pkts:
        data, nerr, _ = p.getBinaryData()
        out.append((int(p.frameStartIdx), float(p.maskBitErrors),
                    np.asarray(p.bits).tolist(), int(nerr), np.asarray(data).tolist()))
    return out


# ---------------- RS(255,223) and the utilities ----------------


def test_rs_tables_equal():
    p, j = prs.RSCodec(RS_N, RS_K), jrs.RSCodec(RS_N, RS_K)
    assert p.gen == j.gen
    assert np.array_equal(p.gf.exp, j.gf.exp) and np.array_equal(p.gf.log, j.gf.log)


@pytest.mark.parametrize("n_err", [0, 1, 9, 16, 17])
def test_rs_encode_decode_equal(n_err):
    """Encode equal; decode equal up to t = 16 byte errors; with 17 both
    raise RSError."""
    rng = np.random.RandomState(n_err)
    msg = rng.randint(0, 256, RS_K)
    p, j = prs.RSCodec(), jrs.RSCodec()
    cw = p.encode(msg)
    assert np.array_equal(cw, j.encode(msg))
    bad = cw.copy()
    pos = rng.choice(RS_N, n_err, replace=False)
    bad[pos] ^= rng.randint(1, 256, n_err).astype(np.uint8)
    if n_err > p.t:
        with pytest.raises(prs.RSError):
            p.decode(bad)
        with pytest.raises(jrs.RSError):
            j.decode(bad)
        return
    (pm, pn), (jm, jn) = p.decode(bad), j.decode(bad)
    assert pn == jn == n_err
    assert np.array_equal(pm, jm) and np.array_equal(pm, msg.astype(np.uint8))


def test_crc_and_pn9_equal():
    data = np.random.RandomState(0).randint(0, 256, 300).astype(np.uint8)
    assert pcrc.crc16_cc(data) == jcrc.crc16_cc(data)
    assert pcrc.crc16_cc(bytes(data)) == jcrc.crc16_cc(bytes(data))
    assert np.array_equal(pcrc.crc16_bytes_le(data), jcrc.crc16_bytes_le(data))
    assert np.array_equal(psr.pn9(), jsr.pn9())
    assert np.array_equal(psr.ssrg(7, [7, 6]), jsr.ssrg(7, [7, 6]))
    assert np.array_equal(psr.barker_code(13), jsr.barker_code(13))


# ---------------- Tx: framers, LUTs, Modulator ----------------


@pytest.mark.parametrize("payload", ["full", "short", "bytes"])
@pytest.mark.parametrize("name", ["ccsds", "ccsds_conv"])
def test_ccsds_framers_equal(name, payload):
    pp, jp = protocols(name)
    rng = np.random.RandomState(5)
    data = {"full": rng.randint(0, 256, RS_K).astype(np.uint8),
            "short": np.arange(100, dtype=np.uint8),
            "bytes": b"CCSDS FRAME FROM BYTES"}[payload]
    pe = (penc.CCSDSConvEncoder if name == "ccsds_conv" else penc.CCSDSEncoder)(pp, {})
    je = (jenc.CCSDSConvEncoder if name == "ccsds_conv" else jenc.CCSDSEncoder)(jp, {})
    a, b = pe.encodeAndFrame(data), je.encodeAndFrame(data)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(a) == (2 * (32 + RS_N * 8 + 6) if name == "ccsds_conv" else 32 + RS_N * 8)


@pytest.mark.parametrize("lut", ["FSKmod", "GFSK2mod", "GMSKmod"])
def test_lut_modulators_equal(lut):
    conf_radio = {"samplesPerSym": 16}
    p, j = getattr(pluts, lut)(None, conf_radio), getattr(jluts, lut)(None, conf_radio)
    assert np.array_equal(p.LUT, j.LUT)
    bits = np.random.RandomState(1).randint(0, 2, 200)
    a, b = p.modulate(bits, p.LUT + 0.01), j.modulate(bits, j.LUT + 0.01)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["ccsds_conv", "ccsds", "bench_FSK", "bench_GFSK"])
def test_modulator_encode_and_modulate_equal(name):
    """Framing, LUT modulation with Doppler and IF pre-compensation, noise
    padding: equal element for element."""
    conf = configs.ccsds_example_conf()
    conf_tx = conf["Radios"]["Tx"]["UHF"]
    pp, jp = protocols(name, conf)
    pm, jm = Modulator(conf, conf_tx, pp), JModulator(conf, conf_tx, jp)
    for m in (pm, jm):
        m.set_rangerate(2058.0)
    data = np.random.RandomState(2).randint(0, 256, 200 if name.startswith("ccsds") else 1000)
    if not name.startswith("ccsds"):
        data = data % 2  # the bench framer takes bits
    a, b = pm.encodeAndModulate(data), jm.encodeAndModulate(data)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert pm.get_samp_rate() == jm.get_samp_rate()
    assert pm.TxTotalFreqOffset == jm.TxTotalFreqOffset


def test_awgn_equal():
    sig = np.exp(1j * np.arange(1000) / 7).astype(np.complex64)
    for measured in (True, False):
        a = awgn(sig, 3.0, measured=measured, rng=np.random.RandomState(9))
        b = jawgn(sig, 3.0, measured=measured, rng=np.random.RandomState(9))
        assert np.array_equal(a, b)


# ---------------- the frame finder ----------------


def flip_stream():
    """tests/test_ccsds.py:103-129: one concatenated frame between random
    bits, 4% of the symbols flipped (hard decisions, no trust)."""
    pp, _ = protocols()
    onair = penc.CCSDSConvEncoder(pp, {}).encodeAndFrame(np.arange(223, dtype=np.uint8))
    rng = np.random.RandomState(4)
    stream = np.r_[rng.randint(0, 2, 700), onair, rng.randint(0, 2, 700)].astype(np.uint8)
    return stream ^ (rng.rand(len(stream)) < 0.04).astype(np.uint8), None


def erasure_stream():
    """tests/test_ccsds.py:159-192: 12% erased bits (trust -1, random
    values) and 1.5% flips elsewhere (soft decisions through trust)."""
    pp, _ = protocols()
    payload = np.arange(223, dtype=np.uint8)[::-1].copy()
    onair = penc.CCSDSConvEncoder(pp, {}).encodeAndFrame(payload)
    rng = np.random.RandomState(6)
    stream = np.r_[rng.randint(0, 2, 600), onair, rng.randint(0, 2, 600)].astype(np.uint8)
    erased = rng.rand(len(stream)) < 0.12
    flipped = (rng.rand(len(stream)) < 0.015) & ~erased
    stream[erased] = rng.randint(0, 2, int(erased.sum()))
    stream = stream ^ flipped.astype(np.uint8)
    return stream, np.where(erased, -1, 5).astype(np.int8)


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("make", [flip_stream, erasure_stream], ids=["flips", "erasures"])
def test_find_frames_equal_on_ccsds_streams(make, blocks):
    """Whole stream in one call, or cut into three blocks: the same
    packets, Viterbi output and sync-flag count from both decoders, and
    the frame decodes bit-exact."""
    stream, trust = make()
    pp, jp = protocols()
    pd, jd = Decoder({}, pp), JDecoder({}, jp)
    cuts = np.linspace(0, len(stream), blocks + 1).astype(int)
    found = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        t = None if trust is None else trust[a:b]
        (pk, pbits, pn), (jk, jbits, jn) = (d.findFrames(stream[a:b], a, trust=t) for d in (pd, jd))
        assert np.array_equal(pbits, jbits) and pbits.dtype == jbits.dtype and pn == jn
        assert packets_of(pk) == packets_of(jk)
        found += [n for _, _, _, n, _ in packets_of(pk) if n >= 0]
    assert found and min(found) <= 16


def bench_variant(base, End, mode):
    """A bench protocol whose decoder ends packets by ``mode``: FLAGS (the
    sync flag closes the packet) or IN_DATA (a length byte after the
    16-byte header)."""

    class Variant(base):
        packetEndDetectMode = End[mode]
        packetEndLenField = 16
        packetEndLenFieldNumBytes = 1

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.packetLen = 8 * 60  # FIXED mode: a few packets fit the stream

        def packetEndLenDecoder(self, bits, **kwargs):
            return int(np.packbits(np.asarray(bits, np.uint8))[0])

    return Variant(conf=None)


@pytest.mark.parametrize("mode", ["FLAGS", "IN_DATA", "FIXED"])
def test_find_frames_equal_in_every_end_mode(mode):
    """bench_FSK packets (header, a length byte, payload, sync flag) in a
    random bit stream fed in uneven blocks, so that packets straddle block
    seams and resume: the same packets and bits from both decoders."""
    pp = bench_variant(loadProtocol("bench_FSK"), PEnd, mode)
    jp = bench_variant(jload("bench_FSK"), JEnd, mode)
    _, header = pp.initTxHeader()
    flag = (np.flipud(pp.get_syncFlag()) > 0).astype(np.uint8)
    rng = np.random.RandomState(8)
    parts = [rng.randint(0, 2, 300)]
    for n in (20, 90, 40, 150):
        payload = rng.randint(0, 2, 8 * n)
        parts += [header, np.unpackbits(np.uint8(n)), payload, flag, rng.randint(0, 2, 400)]
    stream = np.concatenate(parts).astype(np.uint8)
    pd, jd = Decoder({}, pp), JDecoder({}, jp)
    pos, count = 0, 0
    for n in (500, 1700, 333, 2500, 1200, 4000):
        (pk, pbits, pn), (jk, jbits, jn) = (d.findFrames(stream[pos:pos + n], pos) for d in (pd, jd))
        pos += n
        assert np.array_equal(pbits, jbits) and pn == jn
        assert packets_of(pk) == packets_of(jk)
        count += len(pk)
    assert pos >= len(stream) and count > 0


# ---------------- the whole chain ----------------


@pytest.fixture(scope="module")
def chain():
    """Two frames of seeded payloads at 1500 m/s through both Modulators
    (equal waveforms), AWGN at LOW_SNR_DB, then each package's UHF
    demodulator per hop. Returns the payloads, the equal waveform and the
    per-block (bits, trust) of each demodulator."""
    conf = configs.ccsds_example_conf()
    pp, jp = protocols("ccsds_conv", conf)
    mods = [M(conf, conf["Radios"]["Tx"]["UHF"], p) for M, p in ((Modulator, pp), (JModulator, jp))]
    rng = np.random.RandomState(7)
    payloads = [rng.randint(0, 256, RS_K).astype(np.uint8) for _ in range(2)]
    waves = []
    for m in mods:
        m.set_rangerate(1500.0)
        waves.append(np.concatenate([m.encodeAndModulate(p) for p in payloads]))
    assert np.array_equal(waves[0], waves[1])
    # noise over the whole received stream: the overlap-save history, the
    # frames and two flush blocks (a receiver never sees exact zeros)
    ov, step = 2 ** 10, 2 ** 13 - 2 ** 10
    n_blocks = int(np.ceil(len(waves[0]) / step)) + 2
    clean = np.zeros(ov + n_blocks * step, np.complex64)
    clean[ov:ov + len(waves[0])] = waves[0]
    sig = awgn(clean, LOW_SNR_DB, measured=False,
               rng=np.random.RandomState(3)).astype(np.complex64)

    def demodulate(demod):
        assert (demod.sigOverlap, demod.Nfft - demod.sigOverlap) == (ov, step)
        raw = demod.get_signalBufferHostPointer()
        raw[:ov] = sig[:ov]
        out = []
        for pos in range(ov, len(sig), step):
            raw[ov:] = sig[pos:pos + step]
            demod.uploadAndFindCarrier(raw)
            bits, _, trust, _ = demod.demodulate()
            out.append((np.asarray(bits), np.asarray(trust)))
            raw[:ov] = raw[-ov:]
        return out

    return dict(conf=conf, payloads=payloads, port=demodulate(UHF.Demodulator(
        conf, pp, configs.RADIO, device="cpu")), jax=demodulate(JUHF.Demodulator(
            conf, jp, configs.RADIO)))


def decode_blocks(decoder, blocks, soft):
    pkts = []
    for bits, trust in blocks:
        pkts += decoder.findFrames(bits, 0, trust=trust if soft else None)[0]
    return packets_of(pkts)


def exact_payloads(summary, payloads):
    """Index of the payload each bit-exact packet carries, in order."""
    return [next(i for i, p in enumerate(payloads) if np.array_equal(d[:RS_K], p))
            for _, _, _, n, d in summary
            if n >= 0 and any(np.array_equal(d[:RS_K], p) for p in payloads)]


@pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
def test_ccsds_chain_matches_jax(chain, soft):
    """Tx -> AWGN -> demod -> Decoder on both packages decodes the same
    payloads, as many frames; the port's Decoder on the port's
    demodulated bits gives exactly the JAX Decoder's packets."""
    conf, payloads = chain["conf"], chain["payloads"]
    pp, jp = protocols("ccsds_conv", conf)
    port = decode_blocks(Decoder(conf, pp), chain["port"], soft)
    assert port == decode_blocks(JDecoder(conf, jp), chain["port"], soft)
    jax = decode_blocks(JDecoder(conf, jload("ccsds_conv")(conf=conf)), chain["jax"], soft)
    assert sorted(set(exact_payloads(port, payloads))) == [0, 1]
    assert exact_payloads(port, payloads) == exact_payloads(jax, payloads)
    bits_equal = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                     for a, b in zip(chain["port"], chain["jax"]))
    p_nerr, j_nerr = [s[3] for s in port], [s[3] for s in jax]
    if bits_equal:
        assert p_nerr == j_nerr
    elif p_nerr != j_nerr:
        n_diff = sum(int(np.sum(a[0] != b[0])) if len(a[0]) == len(b[0]) else -1
                     for a, b in zip(chain["port"], chain["jax"]))
        print(f"demodulated bits differ ({n_diff}; -1 per block of unequal length): "
              f"nerr port {p_nerr}, JAX {j_nerr}")
