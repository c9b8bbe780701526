"""The reference's outputs for a call of the window, and the comparison of the
kept calls (``compare.py``) that decides ``correct``.

The reference sees only the configuration file and the benchmark's own
input pool: the blocks of the call for the "batch" entry; for the "wideband"
entry the call's hop, behind the carry that the previous call of the pool
cycle left (the last K - 1 rows of that hop), through the plain channelizer.
"""

import numpy as np
import torch

from portbench.harness import compare, layout
from portbench.reference import demod as rdemod
from portbench.reference import spec as rspec

#: the outputs of the channel-parallel step (the "wideband" entry)
STEP_KEYS = ("bits", "trust", "symbols", "centres", "mags", "nSym", "nBits", "spSym",
             "doppler_hz", "freq_offset_hz", "quality_db", "snr_db", "shift")


def reference(cell, pool, i: int, device, precision: str = "f64", ties: bool = False):
    """The reference's outputs (B, ...) for call ``i`` of the pool cycle;
    with ``ties`` also ``{block: outputs}`` of the other side of each tie
    (``reference.demod.alternatives``)."""
    rs = rspec.build(cell.conf)
    P = len(pool)
    x = pool.batches[i % P].to(device)
    if cell.traffic["entry"] == "wideband":
        wb = cell.conf["Wideband"]
        M, K = int(wb["M"]), int(wb["taps_per_branch"])
        state = (None if i == 0 else
                 pool.batches[(i - 1) % P].to(device).reshape(-1, M)[-(K - 1):])
        x, _ = rdemod.channelize(x, M, K, float(wb["beta"]), state, precision)
    out = rdemod.demod(x, rs, precision)
    return (out, rdemod.alternatives(x, rs, out, precision)) if ties else out


def program_outputs(cell, out) -> dict:
    """A kept call's outputs as a dict of (B, ...) arrays."""
    if isinstance(out, dict):
        return out
    rs = rspec.build(cell.conf)
    return layout.unpack(out, rs.numSymMax, rs.D, rs.M)


def tally(cell, pool, kept: dict, device, control: bool = False) -> compare.Tally:
    """Compare the kept calls ({call index: outputs}) with the reference. With
    ``control`` the reference in TF32 takes the program's place."""
    rs = rspec.build(cell.conf)
    hz_step = float(np.diff(rs.dopp_hz_lut[:2])[0]) if rs.D > 1 else 1.0
    t = compare.Tally()
    with torch.no_grad():
        for i in sorted(kept):
            ref, alts = reference(cell, pool, i, device, ties=True)
            if control:
                prog = {k: v.cpu().numpy()
                        for k, v in reference(cell, pool, i, device, "tf32").items()}
                if cell.traffic["entry"] == "wideband":
                    prog = {k: prog[k] for k in STEP_KEYS}
            else:
                prog = program_outputs(cell, kept[i])
            if "E" not in prog or not rs.doppler_search:
                prog.pop("E", None)
            compare.add_blocks(t, prog, ref, rs.Nfft, hz_step, rs.doppler_search, alts)
            del ref, alts
    return t


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a number the limits file lacks fails)."""
    return all(k in limits and numbers[k] <= limits[k] for k in numbers)
