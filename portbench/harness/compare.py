"""The comparison that decides ``correct``: the program's outputs of the
checked calls against the reference's on the same input blocks.

Two numbers are compared, each against its limit from
``portbench/limits/<cell>.json``:

- ``decisions``: the share of the discrete fields that differ, pooled over
  every compared block. A block's fields are its slots' symbols and
  centres (nSym slots) and bits and trust (nBits slots), where slots that
  one side has and the other lacks count as differing, and its integer
  scalars: nSym, nBits, the timing bin N / spSym, the spectrum shift,
  clipped_any, whether its SNR is finite, and which Doppler bins the
  estimate averaged (the estimates more than half a grid step apart, or
  one within rounding of a whole grid index on the other side of it, seen
  from which pair of bins the program's SNR was read at).
- ``analog``: the widest relative gap of a continuous field, over every
  compared block: E (against the block's largest); dopp_idx, doppler_hz and
  freq_offset_hz (in grid steps), where the Doppler bins agree; quality_db
  and, where the bins agree, snr_db as the relative gaps of the ratios they
  are the logarithms of, where finite; and downstream of the spectrum shift, where it agrees (a
  shift one bin over, from an interpolation that rounds the other way, is a
  decision, and everything after it differs by its consequence): mags (over
  slots whose symbol and centre agree and whose window does not start within
  rounding of a whole sample, where another sample may win, against the
  block's largest), and
  where the timing bin agrees too code_val, spSym and codeOffset (against
  spSym, across the wrap at spSym - 1).

A block on a tie, where another rounding tips a choice the algorithm makes
(the Doppler energy's second and third best bins, the shift's rounding at a
half), is held to whichever side of it it matches better: the reference
gives both (``reference.demod.alternatives``).

A field the program's outputs lack (the step gives no E, codeOffset,
code_val, dopp_idx or clipped_any) is not compared.
"""

import math

import numpy as np

#: decibels of a power ratio per unit of its natural logarithm
DB10 = 10.0 / math.log(10.0)


def _np(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


class Tally:
    def __init__(self):
        self.fields = 0
        self.differ = 0
        self.gaps = {}  # component -> widest gap

    def gap(self, name: str, value: float):
        if value > self.gaps.get(name, -1.0):
            self.gaps[name] = float(value)

    def merge(self, other: "Tally"):
        self.fields += other.fields
        self.differ += other.differ
        for k, v in other.gaps.items():
            self.gap(k, v)

    def numbers(self) -> dict:
        return {"decisions": self.differ / max(self.fields, 1),
                "analog": max(self.gaps.values(), default=0.0)}


def add_blocks(t: Tally, prog: dict, ref: dict, Nfft: int, hz_step: float, doppler: bool,
               alts: dict = None):
    """Tally the blocks of one call: ``prog`` the program's outputs, ``ref``
    the reference's (dicts of (B, ...) arrays), ``alts`` {block: the
    reference's outputs on the other side of a tie}; a block on a tie is
    held to whichever side it matches better."""
    ref = {k: _np(v).astype(np.float64) for k, v in ref.items()}
    prog = {k: np.asarray(v, np.float64) for k, v in prog.items()}
    for b in range(len(prog["nSym"])):
        p = {k: v[b] for k, v in prog.items()}
        sides = [{k: v[b] for k, v in ref.items()}]
        if alts and b in alts:
            sides.append({k: _np(v)[0].astype(np.float64) for k, v in alts[b].items()})
        best = None
        for r in sides:
            one = Tally()
            _add_block(one, p, r, Nfft, hz_step, doppler)
            key = (one.differ, max(one.gaps.values(), default=0.0))
            if best is None or key < best[0]:
                best = (key, one)
        t.merge(best[1])


def _discrete(t: Tally, differ: bool):
    t.fields += 1
    t.differ += int(bool(differ))


def _slots(t: Tally, p, r, names, n_p, n_r):
    m = min(n_p, n_r)
    for k in names:
        t.fields += max(n_p, n_r)
        t.differ += int(np.count_nonzero(p[k][:m] != r[k][:m])) + abs(n_p - n_r)


def _add_block(t: Tally, p: dict, r: dict, Nfft: int, hz_step: float, doppler: bool):
    n_p, n_r = int(p["nSym"]), int(r["nSym"])
    nb_p, nb_r = int(p["nBits"]), int(r["nBits"])
    _slots(t, p, r, ("symbols", "centres"), n_p, n_r)
    _slots(t, p, r, ("bits", "trust"), nb_p, nb_r)
    _discrete(t, n_p != n_r)
    _discrete(t, nb_p != nb_r)
    same_shift = int(p["shift"]) == int(r["shift"])
    _discrete(t, not same_shift)
    if "clipped_any" in p:
        _discrete(t, bool(p["clipped_any"]) != bool(r["clipped_any"]))
    k_p, k_r = round(Nfft / p["spSym"]), round(Nfft / r["spSym"])
    _discrete(t, k_p != k_r)

    if "E" in p and doppler:
        scale = np.max(np.abs(r["E"]))
        if scale > 0:
            t.gap("E", np.max(np.abs(p["E"] - r["E"])) / scale)
    if not same_shift:
        return _add_doppler(t, p, r, hz_step, doppler)
    m = min(n_p, n_r)
    agree = (p["symbols"][:m] == r["symbols"][:m]) & (p["centres"][:m] == r["centres"][:m])
    if "window_edge" in r:
        agree &= r["window_edge"][:m] == 0
    scale = np.max(np.abs(r["mags"][:n_r]), initial=0.0)
    if agree.any() and scale > 0:
        t.gap("mags", np.max(np.abs(p["mags"][:m] - r["mags"][:m])[agree]) / scale)
    if k_p == k_r:
        sp = r["spSym"]
        t.gap("spSym", abs(p["spSym"] - sp) / sp)
        if "code_val" in p and r["code_val"] > 0:
            t.gap("code_val", abs(p["code_val"] - r["code_val"]) / r["code_val"])
        if "codeOffset" in p:
            d = abs(p["codeOffset"] - r["codeOffset"])
            t.gap("codeOffset", min(d, abs(d - (sp - 1))) / sp)
    _add_doppler(t, p, r, hz_step, doppler)


#: an estimate this close to a whole grid index may sit on either side of it
#: after rounding, and then reads its SNR bands from the neighbouring bins
BIN_EDGE = 1e-3


def _ratio(snr_db):
    """sig / noise of an SNR in dB (20 log10(sig / noise - 1))."""
    return 1 + 10 ** (snr_db / 20)


def _add_doppler(t: Tally, p: dict, r: dict, hz_step: float, doppler: bool):
    """The Doppler estimate's fields (upstream of the shift)."""
    if not doppler:
        return
    same_bins = abs(p["doppler_hz"] - r["doppler_hz"]) <= 0.5 * hz_step
    if "dopp_idx" in p:
        same_bins &= abs(p["dopp_idx"] - r["dopp_idx"]) <= 0.5
    if same_bins:
        for k in ("doppler_hz", "freq_offset_hz"):
            t.gap(k, abs(p[k] - r[k]) / hz_step)
        if "dopp_idx" in p:
            t.gap("dopp_idx", abs(p["dopp_idx"] - r["dopp_idx"]))
    if np.isfinite(p["quality_db"]) and np.isfinite(r["quality_db"]):
        t.gap("quality_db", abs(p["quality_db"] - r["quality_db"]) / DB10)
    fin_p, fin_r = np.isfinite(p["snr_db"]), np.isfinite(r["snr_db"])
    if same_bins and fin_p and fin_r and "snr_alt_db" in r:
        n = round(r["dopp_idx"])
        if abs(r["dopp_idx"] - n) < BIN_EDGE:
            own = 1 + int(np.sign(r["dopp_idx"] - n))  # below, at, above n
            alt = np.abs(_ratio(r["snr_alt_db"]) - _ratio(p["snr_db"]))
            same_bins = int(np.argmin(alt)) == own
    _discrete(t, not same_bins)
    _discrete(t, fin_p != fin_r)
    if same_bins and fin_p and fin_r:
        t.gap("snr_db", abs(_ratio(p["snr_db"]) - _ratio(r["snr_db"])) / _ratio(r["snr_db"]))
