"""K9, the wideband channelizer, against its least time (cells of the
"wideband" entry)."""

from portbench.harness import workmodel
from portbench.metrics import _roofline


def read(r):
    s = _roofline.shape(r)
    if "wbM" not in s:
        return None
    return _roofline.share(r, "channelize",
                           workmodel.channelize(s["wbM"], s["N"], s["wbK"]))
