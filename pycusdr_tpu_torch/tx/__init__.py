from pycusdr_tpu_torch.tx.modulator import Modulator
from pycusdr_tpu_torch.tx.encoders import AX25Encoder, CC11xxEncoder, Encoder, RawEncoder
from pycusdr_tpu_torch.tx.luts import BaseLUT, FSKmod, GFSK2mod, GMSKmod


class DataLengthError(ValueError):
    """Raised when a Tx payload exceeds the protocol's frame capacity."""


__all__ = [
    "Modulator",
    "Encoder",
    "RawEncoder",
    "CC11xxEncoder",
    "AX25Encoder",
    "BaseLUT",
    "FSKmod",
    "GFSK2mod",
    "GMSKmod",
    "DataLengthError",
]
