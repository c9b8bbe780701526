from pycusdr_tpu_torch.models.demodulator import Demodulator
from pycusdr_tpu_torch.models import stx as STX
from pycusdr_tpu_torch.models import uhf as UHF

__all__ = ["Demodulator", "STX", "UHF"]
