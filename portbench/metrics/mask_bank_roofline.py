"""K2, the matched-filter bank reduced over the masks, against its least time."""

from portbench.harness import workmodel
from portbench.metrics import _roofline


def read(r):
    s = _roofline.shape(r)
    return _roofline.share(r, "mask_bank", workmodel.mask_bank(s["B"], s["N"], s["M"]))
