"""Convolutional coding: CCSDS K=7 rate-1/2 encoder and Viterbi decoder
(the port of ``pycusdr_tpu/ops/viterbi.py``).

The encoder and the branch tables are the same numpy code. The trellis
sweep is kernel K7, ``viterbi_sweep``: on a CUDA tensor it launches
``csrc/viterbi.cu`` (one warp per sequence, add-compare-select over the
64 states, decision words in a device scratch, traceback on the device);
on a CPU tensor it runs ``viterbi_sweep_plain``, a loop over t of
(S, 64) tensor ops. Both repeat the JAX scan step in f32 in the same
order (the branch metric, ``pm + bm``, the strict ``cand_b < cand_a``,
``pm - min``, ``tot + min``), so the path-metric totals that node sync
compares are equal to JAX's, not only close.

Code: G1 = 0o171, G2 = 0o133 (CCSDS 131.0-B; the standard's inversion
of the second symbol is a flag). Supports hard bits or soft values.
"""

import numpy as np
import torch

from pycusdr_tpu_torch.ops import _lib

K = 7
N_STATES = 64
G1 = 0o171
G2 = 0o133

# predecessors of new state ns: pa = ns >> 1, pb = (ns >> 1) | 32; the
# input bit that produced ns is its LSB
_NS = np.arange(N_STATES)
PA = _NS >> 1
PB = (_NS >> 1) | (N_STATES // 2)
B_IN = _NS & 1


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    p = np.zeros_like(x)
    while np.any(x):
        p ^= x & 1
        x >>= 1
    return p


def _branch_tables(invert_g2: bool):
    """out0/out1 for every (state, input) pair; state = last 6 bits,
    newest at LSB; register r = (state << 1) | b (the input bit is the
    NEWEST), outputs are parities of r & G."""
    s = np.arange(N_STATES)
    r0 = (s << 1) | 0
    r1 = (s << 1) | 1
    o0 = np.stack([_parity(r0 & G1), _parity(r0 & G2)], axis=1)
    o1 = np.stack([_parity(r1 & G1), _parity(r1 & G2)], axis=1)
    if invert_g2:
        o0[:, 1] ^= 1
        o1[:, 1] ^= 1
    return o0.astype(np.int8), o1.astype(np.int8)  # (64, 2) each


def conv_encode(bits, invert_g2: bool = True) -> np.ndarray:
    """Encode with K-1 flush zeros appended; returns 2*(n+6) symbols."""
    bits = np.r_[np.asarray(bits, np.uint8), np.zeros(K - 1, np.uint8)]
    o0, o1 = _branch_tables(invert_g2)
    out = np.empty((len(bits), 2), np.uint8)
    state = 0
    for i, b in enumerate(bits):
        out[i] = (o1 if b else o0)[state]
        state = ((state << 1) | int(b)) & (N_STATES - 1)
    return out.reshape(-1)


def _check_lengths(sym: torch.Tensor, lengths) -> list:
    lengths = [int(n) for n in lengths]
    if sym.dim() != 3 or sym.shape[2] != 2 or len(lengths) != sym.shape[0]:
        raise ValueError(f"viterbi_sweep: expected (S, Tmax, 2) symbols and S lengths, got "
                         f"{tuple(sym.shape)} and {len(lengths)}")
    if any(n < 0 or n > sym.shape[1] for n in lengths):
        raise ValueError(f"viterbi_sweep: lengths {lengths} outside [0, {sym.shape[1]}]")
    return lengths


def viterbi_sweep_plain(sym: torch.Tensor, lengths, *, soft: bool, terminated: bool,
                        decode: bool, invert_g2: bool = True):
    """Plain PyTorch K7: the scan of ``pycusdr_tpu/ops/viterbi.py:99-122``
    over S sequences at once, then the traceback of ``:128-134``.

    sym: (S, Tmax, 2) f32, sequence s in ``sym[s, :lengths[s]]``
    (hard bits or soft values, larger = more '1'-like); ``terminated``:
    start in state 0 (else all states equal) and trace back from state 0
    (else from the first state of least metric). Returns (bits, met):
    bits (S, Tmax) uint8, 0 beyond each length, or None unless
    ``decode``; met (S, 2) f32, the accumulated normalization total and
    the least final path metric (JAX's metric is their sum in float64).
    """
    lengths = _check_lengths(sym, lengths)
    S, Tmax, _ = sym.shape
    dev = sym.device
    o0, o1 = _branch_tables(invert_g2)
    e = torch.from_numpy(np.stack([o0, o1]).astype(np.float32)).to(dev)  # (2, 64, 2)
    pa = torch.from_numpy(PA).to(dev)
    pb = torch.from_numpy(PB).to(dev)
    b_in = torch.from_numpy(B_IN).to(dev)
    r0, r1 = sym[..., 0:1], sym[..., 1:2]  # (S, Tmax, 1)

    def branch(ex):  # (64, 2) expected symbols -> (S, Tmax, 64) branch metrics
        if soft:
            sgn = ex * 2.0 - 1.0
            return -(sgn[:, 0] * r0 + sgn[:, 1] * r1)
        return (ex[:, 0] - r0).abs() + (ex[:, 1] - r1).abs()

    bm_a = branch(e[b_in, pa])  # metric of the branch pa -> ns
    bm_b = branch(e[b_in, pb])
    pm = torch.zeros((S, N_STATES), dtype=torch.float32, device=dev)
    if terminated:
        pm[:, 1:] = 1e6
    tot = torch.zeros((S, 1), dtype=torch.float32, device=dev)
    ln = torch.tensor(lengths, device=dev)
    t_all = min(lengths, default=0)  # steps every sequence takes
    take = torch.empty((S, Tmax, N_STATES), dtype=torch.bool, device=dev) if decode else None
    for t in range(Tmax):
        cand_a = pm[:, pa] + bm_a[:, t]
        cand_b = pm[:, pb] + bm_b[:, t]
        take_b = cand_b < cand_a
        pm_new = torch.where(take_b, cand_b, cand_a)
        m = pm_new.min(dim=1, keepdim=True).values
        if t < t_all:
            pm, tot = pm_new - m, tot + m
        else:
            live = (t < ln)[:, None]
            pm, tot = torch.where(live, pm_new - m, pm), torch.where(live, tot + m, tot)
        if decode:
            take[:, t] = take_b
    met = torch.cat([tot, pm.min(dim=1, keepdim=True).values], dim=1)
    if not decode:
        return None, met

    rows = torch.arange(S, device=dev)
    state = (torch.zeros(S, dtype=torch.long, device=dev) if terminated
             else torch.argmin(pm, dim=1))  # the first index on ties, as np.argmin
    bits = torch.zeros((S, Tmax), dtype=torch.uint8, device=dev)
    for t in range(Tmax - 1, -1, -1):
        live = t < ln
        bits[:, t] = torch.where(live, state & 1, 0).to(torch.uint8)
        step = torch.where(take[rows, t, state], pb[state], pa[state])
        state = torch.where(live, step, state)
    return bits, met


def viterbi_sweep(sym: torch.Tensor, lengths, *, soft: bool, terminated: bool,
                  decode: bool, invert_g2: bool = True):
    """K7: the trellis sweep of S sequences in one launch (see
    ``viterbi_sweep_plain`` for the arguments and outputs). A CPU tensor
    takes the plain version; a CUDA tensor launches ``csrc/viterbi.cu`` or
    raises. ``lengths`` is a host sequence of S ints."""
    if sym.device.type == "cpu":
        return viterbi_sweep_plain(sym, lengths, soft=soft, terminated=terminated,
                                   decode=decode, invert_g2=invert_g2)
    if sym.device.type != "cuda":
        raise ValueError(f"viterbi_sweep: unsupported device {sym.device}")
    lengths = _check_lengths(sym, lengths)
    S, Tmax, _ = sym.shape
    dev = sym.device
    _lib.check(sym, "sym", torch.float32, (S, Tmax, 2))
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    met = torch.empty((S, 2), dtype=torch.float32, device=dev)
    dec = torch.empty((S, Tmax, 2), dtype=torch.int32, device=dev) if decode else None
    bits = torch.empty((S, Tmax), dtype=torch.uint8, device=dev) if decode else None
    _lib.launch("pycusdr_viterbi", _lib.ptr(sym), _lib.ptr(ln), _lib.ptr(dec), _lib.ptr(bits),
                _lib.ptr(met), S, Tmax, int(soft), int(terminated), int(invert_g2), int(decode))
    viterbi_sweep.launches += 1
    return bits, met


viterbi_sweep.launches = 0


def viterbi_decode(symbols, n_bits: int = None, invert_g2: bool = True,
                   soft: bool = False, terminated: bool = True,
                   _return_metric: bool = False, device=None):
    """Decode a rate-1/2 stream; ``symbols``: (2T,) hard bits {0,1} or
    soft values (larger = more '1'-like) when ``soft=True``.

    Returns the decoded information bits (flush bits stripped when
    ``n_bits`` is given), or with ``_return_metric`` the path-metric
    total as a Python float. ``device``: None means the card (raises
    without one).
    """
    dev = _lib.resolve_device(device)
    sym = np.asarray(symbols, np.float32).reshape(-1, 2)
    T = len(sym)
    bits, met = viterbi_sweep(torch.from_numpy(sym).to(dev)[None], [T], soft=soft,
                              terminated=terminated, decode=not _return_metric,
                              invert_g2=invert_g2)
    if _return_metric:
        tot, pm_min = met[0].cpu().numpy()
        return float(tot) + float(pm_min)
    bits = bits[0].cpu().numpy()
    if n_bits is not None:
        bits = bits[:n_bits]
    elif T > K - 1:
        bits = bits[: T - (K - 1)]
    return bits


def _pairs(bufs) -> np.ndarray:
    """Symbol buffers (even lengths) -> one zero-padded (S, Tmax, 2) f32 array."""
    T = [len(b) // 2 for b in bufs]
    out = np.zeros((len(bufs), max(T, default=0), 2), np.float32)
    for i, b in enumerate(bufs):
        out[i, : T[i]] = np.asarray(b[: 2 * T[i]], np.float32).reshape(-1, 2)
    return out


class ViterbiStream:
    """Streaming Viterbi with overlap-discard margins and node sync.

    Feed arbitrary chunks of rate-1/2 symbols; get back the decoded bit
    stream (delayed by the traceback margin). Each call re-decodes a
    ``2*(Dl+Dh)``-symbol tail of history so block seams have full left
    and right context — no per-block edge errors. Node sync (the even/
    odd pairing of symbols) is chosen and re-checked per call from the
    normalized path-metric growth; a clearly better alternative parity
    triggers a resync.

    The state (``carry``, ``pending``, ``parity``) is host numpy. Per
    call the two node-sync sweeps are one K7 launch (S = 2) and one read
    of their metrics, and the decode is one launch and one copy of its
    bits to the host. ``device``: None means the card (raises without
    one); ``plain`` runs K7's plain version on that device.
    """

    def __init__(self, invert_g2: bool = True, soft: bool = False,
                 Dl: int = 64, Dh: int = 64, device=None, plain: bool = False):
        self.invert_g2 = invert_g2
        self.soft = soft
        self.Dl = Dl
        self.Dh = Dh
        self.device = _lib.resolve_device(device)
        self.plain = plain
        self.carry = np.zeros(0, np.float32)  # undecided symbol tail
        self.pending = np.zeros(0, np.float32)  # odd leftover symbol
        self.parity = None

    def _sweep(self, bufs, decode: bool):
        x = torch.from_numpy(_pairs(bufs)).to(self.device)
        sweep = viterbi_sweep_plain if self.plain else viterbi_sweep
        return sweep(x, [len(b) // 2 for b in bufs], soft=self.soft, terminated=False,
                     decode=decode, invert_g2=self.invert_g2)

    def _decode(self, buf):
        bits, _ = self._sweep([buf], decode=True)
        return bits[0].cpu().numpy()  # n_bits = len(buf) // 2: every step

    def _metric_rates(self, *bufs):
        """The path-metric total per step of each buffer (JAX's
        ``_metric_rate``), the sweeps of all of them in one launch."""
        _, met = self._sweep(bufs, decode=False)
        return [(float(tot) + float(pm_min)) / (len(b) // 2)
                for b, (tot, pm_min) in zip(bufs, met.cpu().numpy())]

    def feed(self, symbols) -> np.ndarray:
        symbols = np.asarray(symbols, np.float32)
        stream = np.r_[self.pending, symbols]

        # node sync: after the first chunk the local stream is already
        # pair-aligned (``pending`` preserves alignment), so r0 is the
        # CURRENT pairing and r1 the shift-by-one alternative — the
        # global parity flag only records the cumulative shift
        shift = 0
        if len(stream) >= 64:
            r0, r1 = self._metric_rates(stream[: len(stream) // 2 * 2],
                                        stream[1 : 1 + (len(stream) - 1) // 2 * 2])
            if self.parity is None:
                self.parity = 0 if r0 <= r1 else 1
                shift = self.parity
            elif r1 + 0.15 * (abs(r0) + abs(r1)) / 2 + 0.02 < r0:
                # margin form works for hard (positive Hamming rate) and
                # soft (negative correlation rate) metrics alike
                self.parity ^= 1
                self.carry = np.zeros(0, np.float32)  # resync
                shift = 1
        elif self.parity is None:
            self.parity = 0

        stream = stream[shift:] if shift else stream
        usable = len(stream) // 2 * 2
        self.pending = stream[usable:]
        syms = stream[:usable]

        n_prev = len(self.carry) // 2
        buf = np.r_[self.carry, syms]
        if len(buf) < 4:
            self.carry = buf
            return np.zeros(0, np.uint8)

        bits = self._decode(buf)
        n = len(bits)
        start = max(n_prev - self.Dh, 0)
        end = max(n - self.Dh, start)
        out = bits[start:end]

        keep = 2 * (self.Dl + self.Dh)
        self.carry = buf[-keep:] if len(buf) > keep else buf
        return out.astype(np.uint8)
