"""Stand-in radio objects for the rig server / unit tests (the port's
copy of ``pycusdr_tpu/control/dummy_radios.py``).

Capability parity with ``pyCuSDR/dummy_radios.py``: implements the
``freq_hl`` / ``rangerate`` / ``doppler`` surface the rig server
steers, without any modem attached.
"""

import scipy.constants

from pycusdr_tpu_torch.utils.doppler import rangerate_from_freq


class DummyRadio:
    def __init__(self, Fc=186e6):
        self._Fc = Fc
        self._rangerate = 0.0
        self._doppler = 0.0

    @property
    def freq_hl(self):
        return self.Fc + self.doppler

    @freq_hl.setter
    def freq_hl(self, val):
        self.rangerate = rangerate_from_freq(val, self.Fc)

    @property
    def Fc(self):
        return self._Fc

    @Fc.setter
    def Fc(self, val):
        self._Fc = val

    @property
    def rangerate(self):
        return self._rangerate

    @rangerate.setter
    def rangerate(self, val):
        self._doppler = val * self.Fc / scipy.constants.speed_of_light
        self._rangerate = val

    @property
    def doppler(self):
        return self._doppler

    @doppler.setter
    def doppler(self, val):
        self._doppler = val
