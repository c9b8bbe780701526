"""Benchmark protocol base: fixed seeded packets with BER accounting.

Capability parity with ``pyCuSDR/protocol/benchmark/bench_base.py``:
a known 10000-bit packet (numpy seed 123), a known random 16-byte
header mask and 2-byte sync flag (also seed 123), fixed-length packet
end detection, and per-packet bit-error counting against the
regenerated sequence.
"""

import logging

import numpy as np

from pycusdr_tpu_torch.globals import attr_in_config
from pycusdr_tpu_torch.protocol.base import Packet, PacketEndDetect, ProtocolBase

log = logging.getLogger(__name__)

MASKLEN = 16 * 8
FLAGLEN = 8 * 2
PACKETLEN = 10000
RAND_SEED = 123


def seeded_bits(n: int, seed: int = RAND_SEED) -> np.ndarray:
    """Deterministic random bit sequence; preserves global RNG state."""
    state = np.random.get_state()
    np.random.seed(seed)
    bits = np.random.randint(0, 2, n)
    np.random.set_state(state)
    return bits


class BenchBase(ProtocolBase):
    name = "bench_base_class"

    packetEndDetectMode = PacketEndDetect.FIXED
    packetLen = PACKETLEN
    numBitsOverlap = MASKLEN * 2

    numOnesSyncSig = 0
    numOnesHeader = 0
    syncSigTol = 1
    headerTol = 27

    def __init__(self, **kwargs):
        self.conf = kwargs.get("conf", None)
        if self.conf is not None:
            self.packetLen = attr_in_config(self.conf["Main"], "PacketLen", PACKETLEN)
            self.randSeed = attr_in_config(self.conf["Main"], "RandSeed", RAND_SEED)
        else:
            log.warning("No config provided, default packet length %d", PACKETLEN)
            self.packetLen = PACKETLEN
            self.randSeed = RAND_SEED
        log.info(
            "Expects packets of length %d bits. Using seed %d",
            self.packetLen,
            self.randSeed,
        )

    def get_mask(self):
        mask = seeded_bits(MASKLEN, 123)
        self.numOnesHeader = float(np.sum(mask))
        return np.flipud(mask * 2 - 1)

    def get_syncFlag(self):
        mask = seeded_bits(FLAGLEN, 123)
        self.numOnesSyncSig = float(np.sum(mask))
        return np.flipud(mask * 2 - 1)

    def get_symbolLUT2(self, maskLen: int):
        masks = self._get_xcorrMasks(maskLen)
        bitLUT = masks[:, maskLen // 2]
        return bitLUT, []

    def Packet(self, *args, **kwargs):
        return PacketBench(
            self, *args, **kwargs, packetLen=self.packetLen, randSeed=self.randSeed
        )

    def getFramer(self, confRadio):
        from pycusdr_tpu_torch.tx.encoders import RawEncoder

        return RawEncoder

    def getModulator(self, confRadio):
        from pycusdr_tpu_torch.tx.luts import GMSKmod

        return GMSKmod

    TX_FLAG = np.array([0, 1, 1, 1, 1, 1, 1, 0], dtype=np.uint8)  # 0x7e

    def initTxHeader(self, noFlags: int = 2):
        flags = np.tile(self.TX_FLAG, noFlags)
        header = seeded_bits(MASKLEN, 123).astype(np.uint8)
        return flags, header

    def initTxTail(self, noFlags: int = 2):
        return np.tile(self.TX_FLAG, noFlags), np.array([], dtype=np.uint8)


class PacketBench(Packet):
    """Fixed-length packet checked bit-for-bit against the seeded sequence."""

    def __init__(
        self,
        protocol,
        bits,
        frameStartIdx=0,
        maskBitErrors=0,
        frameSplitIdx=0,
        packetLen=PACKETLEN,
        randSeed=RAND_SEED,
    ):
        self.protocol = protocol
        self.frameStartIdx = frameStartIdx
        self.maskBitErrors = maskBitErrors
        self.bits = np.asarray(bits).astype(np.int8)
        self.frameSplitIdx = frameSplitIdx
        self.packetLen = packetLen
        self.randSeed = randSeed

    def checkPacketData(self):
        """Bit errors vs the regenerated seeded sequence (-0.1 if truncated)."""
        if len(self.bits) < self.packetLen:
            log.warning(
                "Length of received bits too short (%d), expected %d",
                len(self.bits),
                self.packetLen,
            )
            return -0.1
        compare = seeded_bits(self.packetLen, self.randSeed)
        return int(np.sum(self.bits[: self.packetLen] != compare))

    def printPacket(self, pre_str="", pos_str="", verbosity=0, workerId=""):
        errs = self.checkPacketData()
        log.info(
            "%s\tbit errors %s\t BER (this packet) %s%s",
            pre_str,
            errs,
            errs / self.packetLen if errs >= 0 else "n/a",
            pos_str,
        )

    def getBinaryData(self):
        return self.bits, 0, self.bits
