"""The port's protocols against the JAX package's on the CPU: CC11xx (from
``CC11xx.json``), GFSK2, bench_GMSK and AX.25 with its FSK and its GMSK
air interface, at the operational shape (Nfft 2^16, 128 samples a
symbol) and at the JAX tests' (Nfft 2^13, 16 samples a symbol). Both
sides are host numpy, so the filter banks, the symbol LUTs, the header
and sync masks and the ``numOnes*`` counts must be equal exactly
(``np.array_equal``), and so must the port's ``build_spec`` on
``CC11xx.json`` field by field. Also: the AX.25 helper cases of
``tests/test_ax25.py`` run on the port, ``gmsk_mod``, ``binops`` and
``utils/doppler`` against JAX's, and the registry resolving every name
JAX's resolves."""

import dataclasses
import os

import numpy as np
import pytest

from pycusdr_tpu.config.loader import load_modular_json as jax_load_modular_json
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.protocol import gfsk2 as jgfsk2
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu.utils import binops as jbinops
from pycusdr_tpu.utils import doppler as jdoppler
from pycusdr_tpu.utils import gmsk as jgmsk
from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.dsp.spec import build_spec
from pycusdr_tpu_torch.protocol import gfsk2 as pgfsk2
from pycusdr_tpu_torch.protocol import loadProtocol
from pycusdr_tpu_torch.protocol.ax25 import (
    FLAG,
    bit_destuff,
    bit_stuff,
    build_ui_frame,
    bytes_to_bits_lsb,
    crc16_x25,
    descramble_g3ruh,
    nrzi_decode,
    nrzi_encode,
    scramble_g3ruh,
)
from pycusdr_tpu_torch.utils import binops as pbinops
from pycusdr_tpu_torch.utils import doppler as pdoppler
from pycusdr_tpu_torch.utils import gmsk as pgmsk

REPO = os.path.join(os.path.dirname(__file__), "..")
CC11XX_JSON = os.path.join(REPO, "pycusdr_tpu_torch", "config", "configs", "CC11xx.json")
JAX_CC11XX_JSON = os.path.join(REPO, "pycusdr_tpu", "config", "configs", "CC11xx.json")

#: (Nfft, samples per symbol): the operational CC11xx shape, the JAX tests'
SHAPES = [(2**16, 128), (2**13, 16)]
MASK_SIZE = 3


def _conf(name):
    """The config each protocol case is built from."""
    if name == "CC11xx":
        return load_modular_json(CC11XX_JSON)
    if name.startswith("AX25"):
        return {"Radios": {"Protocol": {"ax25_modulation": name.split("/")[1],
                                        "tx_num_preambles": 8}}}
    return {"Main": {"PacketLen": 1000, "RandSeed": 123}}


def _pair(name):
    """(port protocol, JAX protocol) built from the same config dict."""
    conf = _conf(name)
    if name == "GFSK2":
        return pgfsk2.GFSK2(conf=conf), jgfsk2.GFSK2(conf=conf)
    key = name.split("/")[0]
    return loadProtocol(key)(conf=conf), jax_loadProtocol(key)(conf=conf)


PROTOCOLS = ["CC11xx", "GFSK2", "bench_GMSK", "AX25/FSK", "AX25/GMSK"]


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES, ids=["op", "test"])
@pytest.mark.parametrize("name", PROTOCOLS)
def test_filter_bank_equal(name, shape):
    Nfft, spsym = shape
    p, j = _pair(name)
    n_p, bank_p = p.get_filter(Nfft, spsym, MASK_SIZE)
    n_j, bank_j = j.get_filter(Nfft, spsym, MASK_SIZE)
    assert n_p == n_j == 2**MASK_SIZE
    assert _equal(bank_p, bank_j)


@pytest.mark.parametrize("name", [n for n in PROTOCOLS if n != "GFSK2"])
def test_luts_masks_and_counts_equal(name):
    p, j = _pair(name)
    for maskLen in (MASK_SIZE, 4):
        lp, lj = p.get_symbolLUT2(maskLen), j.get_symbolLUT2(maskLen)
        assert len(lp) == len(lj) == 2
        for a, b in zip(lp, lj):
            assert _equal(a, b)
    assert _equal(p.get_mask(), j.get_mask())
    assert _equal(p.get_syncFlag(), j.get_syncFlag())
    for attr in ("numOnesHeader", "numOnesSyncSig", "syncSigTol", "headerTol",
                 "numBitsOverlap", "packetLen", "SUM_ALL_MASKS_PYTHON"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert p.packetEndDetectMode.name == j.packetEndDetectMode.name
    assert p.name == j.name


@pytest.mark.parametrize("name", [n for n in PROTOCOLS if n != "GFSK2"])
def test_tx_header_and_tail_equal(name):
    p, j = _pair(name)
    for a, b in zip(p.initTxHeader(), j.initTxHeader()):
        assert _equal(a, b)
    for a, b in zip(p.initTxTail(), j.initTxTail()):
        assert _equal(a, b)
    assert p.getFramer({}).__name__ == j.getFramer({}).__name__
    assert p.getModulator({}).__name__ == j.getModulator({}).__name__


@pytest.mark.parametrize("shape", SHAPES, ids=["op", "test"])
def test_gfsk_templates_equal(shape):
    _, spsym = shape
    masks = pgfsk2.GFSK2()._get_xcorrMasks(MASK_SIZE)
    tp = pgfsk2.hamming_weight(pgfsk2.gfsk_templates(masks, spsym))
    tj = jgfsk2.hamming_weight(jgfsk2.gfsk_templates(masks, spsym))
    assert len(tp) == len(tj)
    for a, b in zip(tp, tj):
        assert _equal(a, b)


def test_cc11xx_spec_equals_jax():
    """``build_spec`` on ``CC11xx.json`` at the operational shape: every
    field equal to JAX's, and the shape the chip run relies on."""
    conf = load_modular_json(CC11XX_JSON)
    jconf = jax_load_modular_json(JAX_CC11XX_JSON)
    assert conf == jconf
    own = build_spec(conf, loadProtocol("CC11xx")(conf=conf), "UHF-H")
    jspec = jax_build_spec(jconf, jax_loadProtocol("CC11xx")(conf=jconf), "UHF-H")
    fields = [f.name for f in dataclasses.fields(own)]
    assert fields == [f.name for f in dataclasses.fields(jspec)]
    for f in fields:
        a, b = getattr(own, f), getattr(jspec, f)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert _equal(a, b), f
        else:
            assert a == b, f
    assert (own.Nfft, own.sigOverlap, own.spsym, own.numSymMax) == (2**16, 2**10, 128.0, 640)
    assert (own.code_idx_lo, own.code_idx_hi, own.num_masks, own.num_dopplers) == (465, 568, 8, 64)
    assert own.dopp_offset_idx == 10240 and own.centreFreqOffset == 148320.0
    assert own.disable_peak_thresholding  # K6 does not run on the UHF section


# ---------------- the AX.25 helpers (cases of tests/test_ax25.py) ----------------


def test_stuff_destuff_roundtrip():
    rng = np.random.RandomState(0)
    for _ in range(20):
        bits = rng.randint(0, 2, rng.randint(10, 400)).astype(np.uint8)
        np.testing.assert_array_equal(bit_destuff(bit_stuff(bits)), bits)


def test_stuffing_breaks_flag_pattern():
    stuffed = bit_stuff(np.ones(24, np.uint8))
    assert "111111" not in "".join(map(str, stuffed))


def test_nrzi_roundtrip():
    bits = np.random.RandomState(1).randint(0, 2, 500).astype(np.uint8)
    np.testing.assert_array_equal(nrzi_decode(nrzi_encode(bits)), bits)


def test_crc_x25_vector():
    assert crc16_x25(np.frombuffer(b"123456789", np.uint8)) == 0x906E


def test_ui_frame_roundtrip():
    proto = loadProtocol("AX25")(conf=None)
    payload = np.arange(1, 60, dtype=np.uint8)
    frame = build_ui_frame(payload, dest="CQ", src="N0CALL")
    bits = np.r_[np.tile(FLAG, 3), bit_stuff(bytes_to_bits_lsb(frame)), np.tile(FLAG, 2)]
    pkt = proto.Packet(np.r_[bits, np.zeros(8, np.uint8)])
    data, err, _ = pkt.getBinaryData()
    assert err == 0
    np.testing.assert_array_equal(data, payload)
    assert pkt.getAsciiAddress() == "N0CALL>CQ"


def test_fcs_detects_corruption():
    proto = loadProtocol("AX25")(conf=None)
    raw = bytes_to_bits_lsb(build_ui_frame(np.arange(1, 30, dtype=np.uint8)))
    raw[40] ^= 1
    bits = np.r_[np.tile(FLAG, 3), bit_stuff(raw), np.tile(FLAG, 2)]
    assert proto.Packet(bits).getBinaryData()[1] == -1


def test_finds_ax25_frame_in_stream():
    from pycusdr_tpu_torch.decode import Decoder

    proto = loadProtocol("AX25")(conf=None)
    dec = Decoder({}, proto)
    payload = np.arange(1, 50, dtype=np.uint8)
    onair = np.r_[np.tile(FLAG, 6), bit_stuff(bytes_to_bits_lsb(build_ui_frame(payload))),
                  np.tile(FLAG, 2)].astype(np.uint8)
    filler = np.random.RandomState(3).randint(0, 2, 600).astype(np.uint8)
    filler[::6] = 0  # no fake flags in the noise
    pkts, _, _ = dec.findFrames(nrzi_encode(np.r_[filler, onair, filler]), 0)
    good = [d for d, e, _ in (p.getBinaryData() for p in pkts) if e == 0 and len(d) == len(payload)]
    assert good, "no CRC-clean frame"
    np.testing.assert_array_equal(good[0], payload)


def test_g3ruh_roundtrip_seam_and_error():
    rng = np.random.RandomState(2)
    bits = rng.randint(0, 2, 500).astype(np.uint8)
    tx = scramble_g3ruh(bits)
    d, _ = descramble_g3ruh(tx)
    np.testing.assert_array_equal(d[17:], bits[17:])
    hist, parts = None, []
    for chunk in np.array_split(tx, 7):
        part, hist = descramble_g3ruh(chunk, hist)
        parts.append(part)
    np.testing.assert_array_equal(np.concatenate(parts), d)
    bad = tx.copy()
    bad[100] ^= 1
    db, _ = descramble_g3ruh(bad)
    assert set(np.where(db != d)[0].tolist()) == {100, 112, 117}


def test_gmsk_mode_scrambles_tx_and_preprocessor_streams():
    from pycusdr_tpu_torch.tx.encoders import AX25Encoder

    proto = loadProtocol("AX25")(conf={"Radios": {"Protocol": {"ax25_modulation": "GMSK"}}})
    assert proto.scramble
    onair = AX25Encoder(proto, {}).encodeAndFrame(np.frombuffer(b"HELLO G3RUH", np.uint8))
    plain_flags = "".join(map(str, nrzi_encode(np.tile(FLAG, 4))))
    assert plain_flags not in "".join(map(str, onair[:128]))
    state, parts = {}, []
    for chunk in np.array_split(onair, 5):
        parts.append(proto.decoderPreprocessor(chunk, stream_state=state))
    s = "".join(map(str, np.concatenate(parts).astype(int)))
    assert "".join(map(str, np.tile(FLAG, 4))) in s


@pytest.mark.parametrize("scramble", [False, True])
def test_ax25_preprocessor_equals_jax_across_blocks(scramble):
    """The streamed preprocessor (``prev_raw_last`` / ``stream_state``)
    gives JAX's bits block for block."""
    mod = "GMSK" if scramble else "FSK"
    p, j = _pair(f"AX25/{mod}")
    bits = np.random.RandomState(9).randint(0, 2, 997).astype(np.uint8)
    sp, sj, prev = {}, {}, None
    for chunk in np.array_split(bits, 6):
        a = p.decoderPreprocessor(chunk, prev_raw_last=prev, stream_state=sp)
        b = j.decoderPreprocessor(chunk, prev_raw_last=prev, stream_state=sj)
        assert _equal(a, b)
        prev = chunk[-1]
    assert set(sp) == set(sj)
    for k in sp:
        assert np.array_equal(np.asarray(sp[k]), np.asarray(sj[k]))


# ---------------- gmsk_mod, binops, doppler ----------------


@pytest.mark.parametrize("spsym", [16, 128])
@pytest.mark.parametrize("pm1", [False, True])
def test_gmsk_mod_equal(spsym, pm1):
    bits = np.random.RandomState(spsym).randint(0, 2, 41)
    if pm1:
        bits = bits * 2 - 1
    for a, b in zip(pgmsk.gmsk_mod(bits, spsym), jgmsk.gmsk_mod(bits, spsym)):
        assert _equal(a, b)


def test_binops_equal():
    rng = np.random.RandomState(4)
    data = rng.randint(0, 256, 37).astype(np.uint8)
    assert _equal(pbinops.unpack_bits_msb(data), jbinops.unpack_bits_msb(data))
    bits = rng.randint(0, 2, 301)
    assert _equal(pbinops.pack_bits_msb(bits), jbinops.pack_bits_msb(bits))
    for msb in (True, False):
        assert pbinops.bits_to_uint(bits[:20], msb) == jbinops.bits_to_uint(bits[:20], msb)
    assert pbinops.hexstr(data) == jbinops.hexstr(data)


@pytest.mark.parametrize("rr", [-27500.0, -7.5, 0.0, 1500.0, 27500.0])
def test_doppler_equal(rr):
    Fc = 401.538e6
    f = pdoppler.freq_from_rangerate(rr, Fc)
    assert f == jdoppler.freq_from_rangerate(rr, Fc)
    assert pdoppler.rangerate_from_freq(f, Fc) == jdoppler.rangerate_from_freq(f, Fc)
    assert pdoppler.doppler_hz_from_rangerate(rr, Fc) == jdoppler.doppler_hz_from_rangerate(rr, Fc)
    assert abs(pdoppler.rangerate_from_freq(f, Fc) - rr) < 1e-6 * max(1.0, abs(rr))


def test_json_str_list_to_int_list_equal():
    from pycusdr_tpu.globals import json_str_list_to_int_list as jconv
    from pycusdr_tpu_torch.globals import json_str_list_to_int_list as pconv

    for lst, base in ((["0xaa", "0xd6", "0xBA"], 16), (["10", "7"], 10)):
        assert pconv(lst, base) == jconv(lst, base)


@pytest.mark.parametrize("name", ["CC11xx", "cc11xx", "bench", "bench_GMSK", "AX25", "ax25",
                                  "bench_FSK", "bench_GFSK", "bench_BPSK", "ccsds", "ccsds_conv",
                                  "ccsds-conv"])
def test_registry_resolves_every_jax_name(name):
    assert loadProtocol(name).__name__ == jax_loadProtocol(name).__name__
