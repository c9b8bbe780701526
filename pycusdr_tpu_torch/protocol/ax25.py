"""AX.25 (HDLC) protocol plug-in — new capability over the reference.

The reference ships the CC11xx link plus benchmark modulations; its
FLAGS packet-end machinery (``decoder.py:122-243``) is shaped for
HDLC-style links but no such protocol is included. This plug-in speaks
classic amateur-satellite AX.25 UI frames over FSK/GMSK (G3RUH-style):

* framing: ``0x7E`` flags, bit order LSB-first per byte,
* bit stuffing: a 0 inserted after five consecutive 1s (flags exempt),
* FCS: CRC-16/X25 (poly 0x1021 reflected, init/xorout 0xFFFF) over
  address+control+PID+info,
* line coding: NRZI (0 = transition, 1 = no transition), undone by the
  decoder preprocessor so the frame finder sees logical bits,
* scrambling: the GMSK (9600-baud) air interface applies the G3RUH
  x^17+x^12+1 multiplicative scrambler to the NRZI stream (and the Rx
  preprocessor runs the self-synchronizing descrambler), matching real
  G3RUH hardware; plain-FSK mode stays unscrambled like 1200-baud TNCs,
* Rx correlation bank: FSK templates (the matched-filter front end is
  modulation-level and shared with the bench links).

The port's copy of ``pycusdr_tpu/protocol/ax25.py`` (host numpy).
"""

import logging

import numpy as np

from pycusdr_tpu_torch.protocol.base import Packet, PacketEndDetect
from pycusdr_tpu_torch.protocol.fsk2 import FSK2

log = logging.getLogger(__name__)

FLAG = np.array([0, 1, 1, 1, 1, 1, 1, 0], dtype=np.uint8)  # 0x7E LSB-first


# ---------------- HDLC bit-level codecs ----------------

def bit_stuff(bits: np.ndarray) -> np.ndarray:
    """Insert a 0 after every run of five 1s."""
    out = []
    run = 0
    for b in bits:
        out.append(int(b))
        if b == 1:
            run += 1
            if run == 5:
                out.append(0)
                run = 0
        else:
            run = 0
    return np.array(out, dtype=np.uint8)


def bit_destuff(bits: np.ndarray) -> np.ndarray:
    """Drop the 0 following every run of five 1s."""
    out = []
    run = 0
    skip = False
    for b in bits:
        if skip:
            skip = False
            run = 0
            continue
        out.append(int(b))
        if b == 1:
            run += 1
            if run == 5:
                skip = True
        else:
            run = 0
    return np.array(out, dtype=np.uint8)


def scramble_g3ruh(bits: np.ndarray) -> np.ndarray:
    """G3RUH multiplicative scrambler (x^17 + x^12 + 1): the on-air bit
    is ``d ^ tx[-12] ^ tx[-17]``. Applied to the NRZI-encoded stream —
    the G3RUH modem sits between the TNC's NRZI output and the radio.
    Zero initial state; the receiver's descrambler is self-synchronizing
    so the Tx state never needs to be communicated."""
    bits = np.asarray(bits, np.uint8)
    out = np.empty(len(bits), np.uint8)
    state = 0  # bit i-1 .. i-17 in the low 17 bits
    for i, d in enumerate(bits):
        t = int(d) ^ ((state >> 11) & 1) ^ ((state >> 16) & 1)
        out[i] = t
        state = ((state << 1) | t) & 0x1FFFF
    return out


def descramble_g3ruh(bits: np.ndarray, hist=None):
    """Self-synchronizing inverse of :func:`scramble_g3ruh`:
    ``d[i] = r[i] ^ r[i-12] ^ r[i-17]`` over the RECEIVED stream, so it
    re-locks within 17 bits of any error or stream start. ``hist`` is
    the previous block's last 17 raw bits (streaming seam context);
    returns ``(descrambled, new_hist)``."""
    bits = np.asarray(bits, np.uint8)
    if hist is None:
        hist = np.zeros(17, np.uint8)
    ext = np.r_[np.asarray(hist, np.uint8), bits]
    out = ext[17:] ^ ext[17 - 12 : len(ext) - 12] ^ ext[: len(ext) - 17]
    return out.astype(np.uint8), ext[-17:].copy()


def nrzi_encode(bits: np.ndarray, initial: int = 0) -> np.ndarray:
    """NRZI: 0 toggles the level, 1 keeps it."""
    out = np.empty(len(bits), dtype=np.uint8)
    level = initial
    for i, b in enumerate(bits):
        if b == 0:
            level ^= 1
        out[i] = level
    return out


def nrzi_decode(levels: np.ndarray, initial: int = 0) -> np.ndarray:
    """Inverse of nrzi_encode: same level as previous -> 1, change -> 0."""
    levels = np.asarray(levels, dtype=np.uint8)
    prev = np.r_[np.uint8(initial), levels[:-1]]
    return (levels == prev).astype(np.uint8)


def crc16_x25(data: np.ndarray) -> int:
    """CRC-16/X25: reflected 0x1021, init 0xFFFF, xorout 0xFFFF."""
    crc = 0xFFFF
    for byte in np.asarray(data, dtype=np.uint8):
        crc ^= int(byte)
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
    return crc ^ 0xFFFF


def bytes_to_bits_lsb(data) -> np.ndarray:
    return np.unpackbits(np.asarray(data, np.uint8), bitorder="little")


def bits_to_bytes_lsb(bits) -> np.ndarray:
    bits = np.asarray(bits, np.uint8)
    n = len(bits) // 8 * 8
    return np.packbits(bits[:n], bitorder="little")


def encode_address(dest: str = "CQ", src: str = "N0CALL", ssid_d: int = 0,
                   ssid_s: int = 0) -> np.ndarray:
    """AX.25 address field: callsigns left-shifted one bit, SSID bytes,
    end-of-address bit on the source SSID."""
    def call(c, ssid, last):
        c = (c.upper() + "      ")[:6]
        b = [ord(ch) << 1 for ch in c]
        b.append(0x60 | (ssid << 1) | (1 if last else 0))
        return b

    return np.array(call(dest, ssid_d, False) + call(src, ssid_s, True), np.uint8)


def build_ui_frame(payload, dest="CQ", src="N0CALL") -> np.ndarray:
    """Address + control(0x03) + PID(0xF0) + payload + FCS, as bytes."""
    body = np.r_[encode_address(dest, src), np.array([0x03, 0xF0], np.uint8),
                 np.asarray(payload, np.uint8)]
    fcs = crc16_x25(body)
    return np.r_[body, np.array([fcs & 0xFF, fcs >> 8], np.uint8)]


# ---------------- protocol plug-in ----------------

N_HEADER_FLAGS = 4


class AX25(FSK2):
    name = "AX25"
    packetEndDetectMode = PacketEndDetect.FLAGS
    numBitsOverlap = 2 * 513

    # frame finder thresholds: header = 4 flags (32 bits), sync = 1 flag.
    # syncSigTol MUST be 0: bit stuffing leaves frame content exactly one
    # bit away from a flag (01111100...), so tolerant sync matching fires
    # mid-frame — HDLC end detection is exact-flag by construction.
    headerTol = 2
    syncSigTol = 0

    SUM_ALL_MASKS_PYTHON = True

    def __init__(self, **kwargs):
        self.conf = kwargs.get("conf")
        pconf = {}
        if self.conf is not None:
            pconf = self.conf.get("Radios", {}).get("Protocol", {})
        self.nrzi = bool(pconf.get("ax25_nrzi", True))
        self.tx_num_flags = int(pconf.get("tx_num_preambles", 16))
        # "FSK" (2FSK) or "GMSK" (G3RUH-style 9600) air interface
        self.modulation = str(pconf.get("ax25_modulation", "FSK")).upper()
        # the G3RUH 9600-baud standard scrambles the NRZI stream with
        # x^17+x^12+1; on by default for the GMSK air interface so it
        # interoperates with real G3RUH modems, off for 1200-style FSK
        self.scramble = bool(pconf.get("ax25_scramble",
                                       self.modulation == "GMSK"))

    def get_filter(self, Nfft, spsym, maskSize, nCycles=0.5):
        if self.modulation == "GMSK":
            from pycusdr_tpu_torch.protocol.fsk2 import fft_filter_bank as _bank
            from pycusdr_tpu_torch.protocol.gfsk2 import hamming_weight
            from pycusdr_tpu_torch.utils.gmsk import gmsk_mod

            masks = self._get_xcorrMasks(maskSize)
            templates = []
            for m in masks:
                wave, _phase, f_len = gmsk_mod(m, spsym)
                templates.append(wave[f_len // 2 : -f_len // 2 + 1])
            templates = hamming_weight(templates)
            bank = _bank(np.asarray(templates), Nfft)
            return bank.shape[0], bank
        return super().get_filter(Nfft, spsym, maskSize, nCycles)

    def get_symbolLUT2(self, maskLen: int):
        masks = self._get_xcorrMasks(maskLen)
        return masks[:, maskLen // 2], []

    def get_mask(self):
        mask = np.tile(FLAG, N_HEADER_FLAGS).astype(np.float64)
        self.numOnesHeader = float(np.sum(mask))
        return np.flipud(mask * 2 - 1)

    def get_syncFlag(self):
        self.numOnesSyncSig = float(np.sum(FLAG))
        return np.flipud(FLAG.astype(np.float64) * 2 - 1)

    def decoderPreprocessor(self, bits, prev_raw_last=None, stream_state=None,
                            **kwargs):
        """Undo the line coding so the frame finder sees HDLC bits:
        G3RUH descramble (GMSK mode) then NRZI decode.

        ``prev_raw_last`` (streamed in by the frame finder) carries the
        previous block's final raw level so block boundaries decode
        without an injected error; the descrambler's 17-bit seam
        context and the post-descramble NRZI level live in
        ``stream_state``."""
        bits = np.asarray(bits)
        if self.scramble:
            st = stream_state if stream_state is not None else {}
            desc, st["g3ruh_hist"] = descramble_g3ruh(bits, st.get("g3ruh_hist"))
            if not self.nrzi:
                return desc
            initial = int(st.get("nrzi_last", 0))
            if len(desc):
                st["nrzi_last"] = int(desc[-1])
            return nrzi_decode(desc, initial=initial)
        if not self.nrzi:
            return bits
        initial = 0 if prev_raw_last is None else int(prev_raw_last)
        return nrzi_decode(bits, initial=initial)

    def Packet(self, *args, **kwargs):
        return PacketAX25(self, *args, **kwargs)

    # ---------------- Tx ----------------

    def getFramer(self, confRadio):
        from pycusdr_tpu_torch.tx.encoders import AX25Encoder

        return AX25Encoder

    def getModulator(self, confRadio):
        # the Tx LUT always pairs with the Rx correlation bank
        if self.modulation == "GMSK":
            from pycusdr_tpu_torch.tx.luts import GMSKmod

            return GMSKmod
        from pycusdr_tpu_torch.tx.luts import FSKmod

        return FSKmod

    def initTxHeader(self, noFlags: int = None):
        n = noFlags if noFlags is not None else self.tx_num_flags
        if self.scramble:
            # the receiver's self-synchronizing descrambler garbles the
            # first 17 on-air bits (~2 flags); spend 3 extra preamble
            # flags so the configured flag count survives intact
            n += 3
        return np.tile(FLAG, n), np.array([], dtype=np.uint8)

    def initTxTail(self, noFlags: int = 2):
        return np.tile(FLAG, noFlags), np.array([], dtype=np.uint8)


class PacketAX25(Packet):
    """Bits between HDLC flags -> destuff -> bytes -> FCS check."""

    def __init__(self, protocol, bits, frameStartIdx=0, maskBitErrors=0,
                 frameSplitIdx=0, **kwargs):
        self.protocol = protocol
        self.frameStartIdx = frameStartIdx
        self.maskBitErrors = maskBitErrors
        self.bits = np.asarray(bits, dtype=np.uint8)

    def _payload_bits(self):
        """Locate the span between the last opening flag and the first
        closing flag; the finder hands us bits starting at the matched
        flag run and ending ~16 bits past the closing flag."""
        b = self.bits
        n = len(b)
        flag_at = np.array([
            i for i in range(0, n - 8 + 1)
            if np.array_equal(b[i : i + 8], FLAG)
        ])
        if len(flag_at) < 2:
            return None
        start = flag_at[0]
        # skip consecutive opening flags (8-bit spaced run)
        k = 0
        while k + 1 < len(flag_at) and flag_at[k + 1] == flag_at[k] + 8:
            k += 1
        start = flag_at[k] + 8
        closing = flag_at[flag_at >= start]
        if len(closing) == 0:
            return None
        return b[start : closing[0]]

    def getBinaryData(self):
        span = self._payload_bits()
        if span is None or len(span) < 8 * 5:
            return np.array([], np.uint8), -1, np.array([], np.uint8)
        frame = bits_to_bytes_lsb(bit_destuff(span))
        if len(frame) < 17:  # addr(14)+ctl+pid+fcs(2) minimum
            return frame, -1, frame
        body, fcs = frame[:-2], frame[-2:]
        ok = crc16_x25(body) == (int(fcs[0]) | (int(fcs[1]) << 8))
        payload = body[16:]  # strip addr(14) + control + PID
        return payload, (0 if ok else -1), payload

    def getBinaryRawData(self):
        return self.bits

    def getAsciiAddress(self):
        span = self._payload_bits()
        if span is None:
            return "?"
        frame = bits_to_bytes_lsb(bit_destuff(span))
        if len(frame) < 14:
            return "?"
        dest = "".join(chr(c >> 1) for c in frame[:6]).strip()
        src = "".join(chr(c >> 1) for c in frame[7:13]).strip()
        return f"{src}>{dest}"

    def checkPacketData(self):
        _, err, _ = self.getBinaryData()
        return err
