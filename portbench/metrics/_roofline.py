"""Shared by the ``<stage>_roofline`` readers: the least time of the stage's
work a call (the frozen work model, ``harness/workmodel.py``) over the device
time the traced segment gives the stage, in percent. None where the stage
ran no kernel."""

from portbench.harness import workmodel
from portbench.harness.traffic import radio


def shape(r) -> dict:
    """The sizes of a call of the cell: blocks B, Nfft N, Doppler bins D,
    masks M (and, for the wideband entry, the channelizer's M and K)."""
    conf = r.cell.conf
    _, rx, gpu = radio(conf)
    s = {"B": r.pool.blocks_per_call, "N": 2 ** gpu["blockSize"],
         "D": int(rx.get("doppCarrierSteps", gpu.get("doppCarrierSteps", 64))),
         "M": 2 ** int(gpu["xcorrMaskSize"])}
    if "Wideband" in conf and r.cell.traffic["entry"] == "wideband":
        s.update(wbM=int(conf["Wideband"]["M"]), wbK=int(conf["Wideband"]["taps_per_branch"]))
    return s


def share(r, stage: str, work) -> float:
    if r.trace is None or not r.trace.calls or not r.trace.stage_s.get(stage):
        return None
    t_dev = r.trace.stage_s[stage] / r.trace.calls
    t_min, by = workmodel.bound(*work)
    r.bounds[stage] = by
    return 100.0 * t_min / t_dev
