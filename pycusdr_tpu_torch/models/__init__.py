from pycusdr_tpu_torch.models.demodulator import Demodulator
from pycusdr_tpu_torch.models import stx as STX
from pycusdr_tpu_torch.models import uhf as UHF
from pycusdr_tpu_torch.models.tracking import ACQUIRING, TRACKING, DopplerTracker

__all__ = ["ACQUIRING", "Demodulator", "DopplerTracker", "STX", "TRACKING", "UHF"]
