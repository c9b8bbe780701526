"""Protocol registry: maps protocol names (config ``Main.protocols``) to
classes. Ported so far: the benchmark FSK/GFSK/BPSK protocols and CCSDS
(plain and concatenated with the convolutional inner code)."""

from pycusdr_tpu_torch.protocol.base import (  # noqa: F401
    Packet,
    PacketEndDetect,
    PacketLenEndianness,
    ProtocolBase,
)


def loadProtocol(name: str):
    """Resolve a protocol name to its class."""
    key = name.lower()
    if key == "bench_fsk":
        from pycusdr_tpu_torch.protocol.benchmark import BenchFSK

        return BenchFSK
    if key == "bench_gfsk":
        from pycusdr_tpu_torch.protocol.benchmark import BenchGFSK

        return BenchGFSK
    if key == "bench_bpsk":
        from pycusdr_tpu_torch.protocol.benchmark import BenchBPSK

        return BenchBPSK
    if key == "ccsds":
        from pycusdr_tpu_torch.protocol.ccsds import CCSDS

        return CCSDS
    if key in ("ccsds_conv", "ccsds-conv"):
        from pycusdr_tpu_torch.protocol.ccsds import CCSDSConv

        return CCSDSConv
    raise NotImplementedError(f"protocol '{name}' is not yet ported")
