"""K6, the two-pass spike clipping, against its least time."""

from portbench.harness import workmodel
from portbench.metrics import _roofline


def read(r):
    s = _roofline.shape(r)
    return _roofline.share(r, "clip", workmodel.clip(s["B"], s["N"]))
