"""STX (S-band) radio backend: no Doppler search (the fixed IF shift),
interference spike clipping on, with trust -2 on the bits near clipped
samples (``pycusdr_tpu/models/stx.py``)."""

import dataclasses

from pycusdr_tpu_torch.dsp.spec import build_spec
from pycusdr_tpu_torch.models.demodulator import Demodulator as _Base


class Demodulator(_Base):
    def __init__(self, conf, protocol, radioName, device=None):
        spec = build_spec(conf, protocol, radioName)
        spec = dataclasses.replace(spec, doppler_search=False, disable_peak_thresholding=False)
        super().__init__(conf, protocol, radioName, spec=spec, device=device)
