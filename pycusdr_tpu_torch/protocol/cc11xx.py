"""TI CC11xx-compatible protocol (the operational satellite link).

Capability parity with ``pyCuSDR/protocol/CC11xx.py``:
* GFSK/FSK modulated link, config-driven preamble + sync sequences,
* 2**maskSize correlation masks with centre-bit LUT (``:88-105``),
* fixed packet window of (256 data + 9 header + 2 CRC) bytes (``:46-47``),
* PN9 de-whitening and CRC-16/0x18005 validation (``:216-299``),
* Tx framing: preamble + sync header, CC11xx encoder + FSK LUT
  modulator (``:164-207``).

The port's copy of ``pycusdr_tpu/protocol/cc11xx.py`` (host numpy: the
filter bank, LUTs and masks feed ``dsp/spec.build_spec``; the frame
parser runs in ``decode.Decoder``).
"""

import logging

import numpy as np

from pycusdr_tpu_torch.globals import json_str_list_to_int_list, printBytesAsHex
from pycusdr_tpu_torch.protocol.base import Packet, PacketEndDetect, PacketLenEndianness
from pycusdr_tpu_torch.protocol.fsk2 import FSK2
from pycusdr_tpu_torch.protocol.gfsk2 import GFSK2
from pycusdr_tpu_torch.utils.crc import crc16_cc
from pycusdr_tpu_torch.utils.shift_registers import pn9

log = logging.getLogger(__name__)

DEFAULT_SYNC = [0xAB, 0x35, 0xAB, 0x35]
DEFAULT_PREAMBLE = [0xAA]
DEFAULT_NUM_PREAMBLE = 4

# CC11xx direct-response codes surfaced at WARNING level when seen
RESP_LOOPBACK = 0x27
RESP_GET_VERSION = 0x1D
RESP_MSG_VERSION = 0x1E
RESP_MSG_PING = 0x20
RESP_MSG_CONFIG = 0x23
RESP_SL = 0xC1
RESP_WARNINGS = (RESP_LOOPBACK, RESP_MSG_VERSION, RESP_MSG_PING, RESP_SL)

MOD_IDX = 0  # 0 = FSK-2, 1 = GFSK-2 (reference CC11xx.py:30-32)
_MOD_BASES = (FSK2, GFSK2)
_MOD_NAMES = ("FSK-2", "GFSK-2")


def _bytes_to_pm1_bits(byte_vals) -> np.ndarray:
    """MSB-first bit expansion of a byte list, mapped to ±1."""
    bits = np.unpackbits(np.asarray(byte_vals, dtype=np.uint8)).astype(np.float64)
    return bits


class CC11xx(_MOD_BASES[MOD_IDX]):
    name = f"CC11xx {_MOD_NAMES[MOD_IDX]}"

    packetEndDetectMode = PacketEndDetect.FIXED
    packetLen = (256 + 9 + 2) * 8  # max data + header/flags + CRC, in bits
    packetEndLenField = 9
    packetEndLenFieldNumBytes = 1
    packetEndLenEndianness = PacketLenEndianness.LITTLE
    deWhiten = True  # downlink
    whiten = True  # uplink

    # FSK family: sum all mask energies before the Doppler search
    SUM_ALL_MASKS_PYTHON = True

    numBitsOverlap = 2048

    numOnesSyncSig = 0  # set in get_syncFlag
    numOnesHeader = 0  # set in get_mask
    syncSigTol = 2
    headerTol = 5

    def __init__(self, **kwargs):
        self.PN9seq = pn9()

        cfg = kwargs.get("conf", None)
        cfg_prot = cfg["Radios"].get("Protocol", None) if cfg else None
        if cfg_prot:
            self.rx_preamble = json_str_list_to_int_list(cfg_prot["rx_preamble"])
            self.rx_sync_seq = json_str_list_to_int_list(cfg_prot["rx_sync_seq"])
            self.tx_preamble = json_str_list_to_int_list(cfg_prot["tx_preamble"])
            self.tx_num_preambles = cfg_prot["tx_num_preambles"]
            self.tx_sync_seq = json_str_list_to_int_list(cfg_prot["tx_sync_seq"])
        else:
            log.info("CC11xx: no protocol config provided, using defaults")
            self.rx_preamble = DEFAULT_PREAMBLE * DEFAULT_NUM_PREAMBLE
            self.rx_sync_seq = DEFAULT_SYNC * 4
            self.tx_preamble = DEFAULT_PREAMBLE
            self.tx_num_preambles = DEFAULT_NUM_PREAMBLE
            self.tx_sync_seq = DEFAULT_SYNC

        self.num_tx_preamble_bits = len(self.tx_preamble) * self.tx_num_preambles * 8

    # ---------------- Rx ----------------

    def get_symbolLUT2(self, maskLen: int):
        """Centre-bit LUT: symbol (winning mask) -> its middle bit."""
        masks = self._get_xcorrMasks(maskLen)
        bitLUT = masks[:, maskLen // 2]
        half = 2 ** (maskLen - 1)
        symLUT = np.stack(
            [np.arange(half) * 2 + 1, np.arange(half) * 2], axis=1
        ).astype(np.int64)
        return bitLUT, np.concatenate((symLUT, symLUT), axis=0)

    def get_mask(self):
        """Header correlation sequence: preamble + sync, ±1, flipped for convolve."""
        header_bytes = list(self.rx_preamble) + list(self.rx_sync_seq)
        bits = _bytes_to_pm1_bits(header_bytes)
        self.numOnesHeader = float(np.sum(bits))
        return np.flip(bits * 2 - 1, axis=0)

    def get_syncFlag(self):
        bits = _bytes_to_pm1_bits(list(self.rx_preamble))
        self.numOnesSyncSig = float(np.sum(bits > 0))
        return bits * 2 - 1

    def decoderPreprocessor(self, bits, **kwargs):
        return bits

    def decoderPostprocessor(self, packet, **kwargs):
        return packet

    def Packet(self, *args, **kwargs):
        return PacketCC11xx(self, *args, **kwargs)

    # ---------------- Tx ----------------

    def getFramer(self, confRadio):
        from pycusdr_tpu_torch.tx.encoders import CC11xxEncoder

        return CC11xxEncoder

    def getModulator(self, confRadio):
        from pycusdr_tpu_torch.tx.luts import FSKmod

        return FSKmod

    def initTxHeader(self):
        preamble = np.unpackbits(
            np.array(list(self.tx_preamble) * self.tx_num_preambles, dtype=np.uint8)
        )
        header = np.unpackbits(np.array(self.tx_sync_seq, dtype=np.uint8))
        return preamble, header

    def initTxTail(self):
        return np.array([], dtype=np.uint8), np.array([], dtype=np.uint8)


class PacketCC11xx(Packet):
    """CC11xx frame parser.

    Layout (reference CC11xx.py:219-226)::

        | flags (4B) | sync (4B) | pLen (1B) | addr (1B) | data (pLen-3 B) | CRC (2B) |

    pLen counts [addr + data + CRC] (the encoder adds 2 for the CRC,
    encoders/CC11xx.py:82); pLen and the pLen bytes after it are
    PN9-whitened on air; the CRC covers [pLen byte, addr, data] with
    poly 0x18005 init 0xFFFF.

    Deviation from the reference: the reference slices the frame to
    ``packetLen + 11`` bytes and reads the CRC from the final two —
    which its own encoder layout places two bytes *past* the frame end
    (CC11xx.py:237-254,284-299 vs encoders/CC11xx.py:82-96). We slice to
    the true frame length (``packetLen + 9`` bytes) and check the CRC
    transmitted inside the whitened region.
    """

    packetLenFieldIndex = 8  # byte offset of the (whitened) length byte
    _msb_weights = 2 ** np.arange(7, -1, -1)

    flagLen = 4  # preamble bytes covered by the rx correlation mask
    maskLen = 4  # sync bytes
    pLen = 1  # length-field bytes
    CRClen = 2
    packetPreOverHead = flagLen + maskLen + pLen  # bytes before the counted region
    packetPosOverHead = 0  # CRC is inside the counted region
    packetLenOverHead = packetPreOverHead + packetPosOverHead

    def __init__(self, protocol, bits, *args, **kwargs):
        self.protocol = protocol
        bits = np.asarray(bits)

        raw_len = self._read_len_field(bits)
        if self.protocol.deWhiten:
            self.PN9 = protocol.PN9seq
            self.packetLen = int(raw_len) ^ int(self.PN9[0])
        else:
            self.packetLen = int(raw_len)

        self.bits = bits[: int(self.packetLen + self.packetLenOverHead) * 8]

    def _read_len_field(self, bits) -> int:
        field = bits[self.packetLenFieldIndex * 8 : self.packetLenFieldIndex * 8 + 8]
        return int(np.dot(field, self._msb_weights))

    def deWhitenData(self, byteData: np.ndarray):
        n = min(self.packetLen, len(byteData))
        byteData[:n] = np.bitwise_xor(byteData[:n], self.PN9[1 : n + 1])

    @property
    def bitsRaw(self):
        return self.bits

    def getBinaryData(self):
        """Return (payload bytes, crcError, payload). crcError truthy on mismatch.

        payload = [addr + data] (CRC stripped), de-whitened.
        """
        lenBytes = int(self.packetLen) & 0xFF
        start = self.packetPreOverHead * 8
        avail = (len(self.bits) - start) // 8
        nread = min(lenBytes, avail)
        data = np.dot(
            self.bits[start : start + nread * 8].reshape(nread, 8),
            self._msb_weights,
        ).astype(np.uint8)

        if self.protocol.deWhiten:
            self.deWhitenData(data)

        if nread < lenBytes or lenBytes < self.CRClen:
            return data, True, data  # truncated frame can never pass CRC

        payload = data[: -self.CRClen]
        crc_rx = int(data[-2]) | (int(data[-1]) << 8)  # [low, high] on air
        crc_calc = crc16_cc(np.r_[np.uint8(lenBytes), payload].astype(np.uint8))

        crcError = crc_rx != crc_calc
        return payload, crcError, payload

    def printPacket(self, pre_str="", pos_str="", verbosity=0, **kwargs):
        data = self.getBinaryData()[0]
        try:
            resp_code = data[4]
            if resp_code == RESP_LOOPBACK and len(data) >= 5:
                rssi = float(data[-5])
                rssi = (rssi - 256) / 2 - 75 if rssi >= 128 else rssi / 2 - 75
                freq_est = float(data[-3])
                if freq_est >= 128:
                    freq_est -= 256
                freq_est = freq_est * 26e6 / 2**14
                log.warning(
                    f"{pre_str}\tLoopback response len: {self.packetLen} RSSI {rssi} dBm, "
                    f"LQI {data[-4]}, freq_est {freq_est} Hz, HW_ID {data[-2:]}\n"
                    f"loopback data: {printBytesAsHex(data[5:-5])}\n{pos_str}"
                )
            else:
                log.warning(
                    f"{pre_str}\tlen: {self.packetLen} bytes\t Data:\n"
                    f"{printBytesAsHex(data)}{pos_str}"
                )
        except Exception:
            log.warning(
                f"{pre_str}\tlen: {self.packetLen} bytes\t Data:\n"
                f"{printBytesAsHex(data)}{pos_str}"
            )

    def getAsciiAddress(self):
        header = np.reshape(self.bits[: 8 * 8], (8, 8)) * self._msb_weights
        return np.vectorize(hex)(np.sum(header.astype(np.int64), axis=1))
