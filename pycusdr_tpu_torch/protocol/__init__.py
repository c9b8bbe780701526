"""Protocol registry: maps protocol names (config ``Main.protocols``) to
classes, as the JAX package's registry (``pycusdr_tpu/protocol/__init__.py``)
does: CC11xx, the benchmark FSK/GFSK/GMSK/BPSK protocols ("bench" is
bench_GMSK), AX.25 and CCSDS (plain and concatenated with the
convolutional inner code). Any other name raises ``ValueError``."""

from pycusdr_tpu_torch.protocol.base import (  # noqa: F401
    Packet,
    PacketEndDetect,
    PacketLenEndianness,
    ProtocolBase,
)


def loadProtocol(name: str):
    """Resolve a protocol name to its class."""
    key = name.lower()
    if key == "cc11xx":
        from pycusdr_tpu_torch.protocol.cc11xx import CC11xx

        return CC11xx
    if key in ("bench", "bench_gmsk"):
        # "bench" is the default bench modulation, as in the reference
        from pycusdr_tpu_torch.protocol.benchmark import BenchGMSK

        return BenchGMSK
    if key == "bench_fsk":
        from pycusdr_tpu_torch.protocol.benchmark import BenchFSK

        return BenchFSK
    if key == "bench_gfsk":
        from pycusdr_tpu_torch.protocol.benchmark import BenchGFSK

        return BenchGFSK
    if key == "bench_bpsk":
        from pycusdr_tpu_torch.protocol.benchmark import BenchBPSK

        return BenchBPSK
    if key == "ax25":
        from pycusdr_tpu_torch.protocol.ax25 import AX25

        return AX25
    if key == "ccsds":
        from pycusdr_tpu_torch.protocol.ccsds import CCSDS

        return CCSDS
    if key in ("ccsds_conv", "ccsds-conv"):
        from pycusdr_tpu_torch.protocol.ccsds import CCSDSConv

        return CCSDSConv
    raise ValueError(f"Unknown protocol '{name}'")
