"""Protocol registry: maps protocol names (config ``Main.protocols``) to
classes. Ported so far: the benchmark FSK/GFSK/BPSK protocols and CCSDS
(plain and concatenated with the convolutional inner code).

A name the JAX package's registry (``pycusdr_tpu/protocol/__init__.py``)
knows but the port lacks raises ``NotImplementedError``; any other name
raises ``ValueError``, as JAX's does."""

from pycusdr_tpu_torch.protocol.base import (  # noqa: F401
    Packet,
    PacketEndDetect,
    PacketLenEndianness,
    ProtocolBase,
)

#: names the JAX registry resolves that the port does not have yet
NOT_PORTED = ("cc11xx", "ax25", "bench_gmsk", "bench")


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
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"protocol '{name}' is not yet ported (ROADMAP.md Queue 1 item 23)")
    raise ValueError(f"Unknown protocol '{name}'")
