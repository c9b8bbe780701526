"""K1 with K5, the Doppler search and estimate, against their least time."""

from portbench.harness import workmodel
from portbench.metrics import _roofline


def read(r):
    s = _roofline.shape(r)
    return _roofline.share(r, "doppler", workmodel.doppler(s["B"], s["N"], s["D"], s["M"]))
