"""K9's fused form (``csrc/channelizer.cu``) modelled in numpy on the CPU,
and the plan and shared-memory accesses of its wide form
(``csrc/channelizer_wide.cu``; its launch is modelled in
``tests/test_torch_channelizer.py``).

``k9_plan`` is a function of (M, K) alone and gives every power-of-two M up
to 1024 and every K up to 32 a fused launch, the wideband path's shapes
(M = 64 and the vote's M = 4, K = 8) the staged span; the kernel's layout
table (``k9_layouts``) holds at each M the strides with the fewest bank
conflicts (a model of the lanes' shared-memory accesses) and the most taps
whose two spans fit. A numpy model of the
kernel's DFT (a V-point radix-2 DFT in each lane with the float32 twiddle
table, the twiddles across the lanes, the G x G transpose as the kernel's
``__shfl_xor_sync`` steps, a G-point DFT; the kernel's digit order) is held
against ``np.fft.fft`` within 1e-6 of max|y| at every planned M. A numpy
model of the whole launch (the tiles, each span staged as the kernel stages
it with NaN in every slot it leaves unwritten, the FIR threads' sliding
windows in the kernel's f32 order into the tile of v, the DFT lanes' reads
of it, the output tile and the store, the carry written by the last tile) is held against ``channelize_numpy`` and the JAX
``Channelizer``, with a carry, on a ragged last tile and with T < K - 1."""

import numpy as np
import pytest
import torch

from pycusdr_tpu.ops.cfft import c2ri, ri2c
from pycusdr_tpu.parallel.channelizer import Channelizer as JaxChannelizer
from pycusdr_tpu_torch.ops.demod_kernels import twiddle_table
from pycusdr_tpu_torch.parallel import channelizer as pch

#: the bar of the DFT model against float64 (relative to max|y|)
DFT_REL = 1e-6
#: K9's bar (tests/test_channelizer.py:19)
REL = 1e-5
MS_ALL = [1 << e for e in range(11)]
#: the dynamic shared memory a CTA may take (227 KB)
SMEM_MAX = 232448


def _wavefronts(offset, G):
    """Shared-memory wavefronts of one 8-byte access by a warp whose lane
    (r, j) = divmod(lane, G) touches complex ``offset(r, j)``: over its two
    half warps, the most lanes on one pair of banks (16 complex a row of
    banks)."""
    cost = 0
    for h in (0, 16):
        counts = np.bincount([offset(*divmod(lane, G)) % 16 for lane in range(h, h + 16)],
                             minlength=16)
        cost += int(counts.max())
    return cost


def _pad(base, accesses, even):
    """The least ``base + pad`` (pad < 16, even where ``even``) at which the
    ``accesses`` [(offset(stride, r, j), G)], in order of weight, cost the
    fewest wavefronts."""
    pads = range(0, 16, 2 if even else 1)
    return base + min(pads, key=lambda d: (*(_wavefronts(lambda r, j: f(base + d, r, j), g)
                                             for f, g in accesses), d))


def _smem(M, K, plan, staged):
    """Bytes of a fused CTA's shared memory: the twiddle table, the taps, two
    spans of TT + K - 1 rows where ``staged``, the tile of v and of y."""
    TT, MS, MSV, TTP = (plan[k] for k in ("TT", "MS", "MSV", "TTP"))
    span = ((TT + K - 1) * MS + 1) & ~1
    tile = (max(TT * MSV, M * TTP) + 1) & ~1
    return 8 * (((M + 1) & ~1) + ((K * M + 3) & ~3) // 2 + (2 * span if staged else 0) + tile)


def _table(M):
    t = twiddle_table(M, "cpu").numpy()
    return (t[:, 0] + 1j * t[:, 1]).astype(np.complex64)


def _rev(i, n):
    r = 0
    while n > 1:
        r, i, n = (r << 1) | (i & 1), i >> 1, n >> 1
    return r


def dft_model(a, M, tw):
    """``dft<N, M>``: in place over axis 0 (N values of each lane), radix-2
    decimation in time on the bit-reversed values, twiddle j of a span of
    len conj(tw[j M / len]), j = len / 4 as a swap (times -i), in complex64."""
    N = a.shape[0]
    a = a[[_rev(i, N) for i in range(N)]].copy()
    n = 2
    while n <= N:
        h = n // 2
        for j in range(h):
            for i in range(0, N, n):
                b = a[i + j + h]
                if 4 * j == n:
                    b = (b.imag - 1j * b.real).astype(np.complex64)
                elif j:
                    b = b * np.conj(tw[j * (M // n)])
                u = a[i + j]
                a[i + j], a[i + j + h] = u + b, u - b
        n *= 2
    return a


def transpose_model(a, G, lanes):
    """``transpose<G, V>``: step b swaps, between lanes l and l ^ b (one
    ``__shfl_xor_sync`` a value), a[c + i] of the upper lane with a[c + (i |
    b)] of the lower, for every i without bit b."""
    j = lanes % G
    b = G // 2
    while b >= 1:
        upper = (j & b) != 0
        for c in range(0, a.shape[0], G):
            for i in range(G):
                if i & b:
                    continue
                send = np.where(upper, a[c + i], a[c + (i | b)])
                got = send[lanes ^ b]
                a[c + i] = np.where(upper, got, a[c + i])
                a[c + (i | b)] = np.where(upper, a[c + (i | b)], got)
        b //= 2
    return a


def row_dft_model(a, M, G, lanes, tw):
    """The DFT of the rows whose values lane l holds in a[:, l] (value p2 =
    branch j + G p2, j = l % G): returns a with value c + m1 of lane l =
    y[c + j + V m1]."""
    a = dft_model(a, M, tw)
    if G > 1:
        j = lanes % G
        V = a.shape[0]
        for m2 in range(1, V):
            a[m2] = a[m2] * np.conj(tw[j * m2])
        a = transpose_model(a, G, lanes)
        for c in range(0, V, G):
            a[c:c + G] = dft_model(a[c:c + G], M, tw)
    return a


def k9_model(x, h2, state):
    """The fused launch of ``k9_plan(M, K)``, tile by tile, in numpy:
    (y (M, T), carry (K - 1, M)). y is NaN wherever the model writes nothing."""
    K, M = h2.shape
    T = len(x) // M
    plan = pch.k9_plan(M, K)
    G, V, P, TT, R, BR, MS, MSV, TTP = (plan[k] for k in (
        "G", "V", "P", "TT", "R", "BR", "MS", "MSV", "TTP"))
    staged = plan["form"] == "span"
    tw = _table(M)
    taps = h2.reshape(-1).astype(np.float32)
    nt = pch.K9_THREADS
    threads = np.arange(nt)
    # the FIR thread: branch fp + nt b, rows fr .. fr + R - 1
    fp = threads % M if M < nt else threads
    fr = threads // M * R if M < nt else np.zeros(nt, int)
    # the DFT lane: branch j + G p2 of row s RP + rw in pass s
    RP = nt // G
    j, rw = threads % G, threads // G
    st = np.zeros((K - 1, M), np.complex64) if state is None else state
    xp = np.concatenate([st, x.reshape(T, M)])
    ntiles = -(-T // TT)
    y = np.full((M, T), np.nan, np.complex64)
    carry = None
    for tile in range(ntiles):
        t0 = tile * TT
        rows = min(TT, T - t0)
        if staged:  # stage_rows: the xp rows that exist, MS apart, NaN elsewhere
            span = np.full((TT + K - 1) * MS, np.nan, np.complex64)
            for row in range(min(TT + K - 1, T + K - 1 - t0)):
                span[row * MS:row * MS + M] = xp[t0 + row]

            def load(q, p):
                return span[q * MS + p]
        else:  # direct: xp read where it exists, zeros past its end
            ext = np.zeros((t0 + TT + K - 1, M), np.complex64)
            ext[:min(len(xp), len(ext))] = xp[:len(ext)]

            def load(q, p):
                return ext[t0 + q, p]
        vt = np.full(max(TT * MSV, M * TTP), np.nan, np.complex64)
        act = fr < rows
        for b in range(BR):
            p = fp + nt * b
            re = np.zeros((R, nt), np.float32)
            im = np.zeros((R, nt), np.float32)
            win = [load(fr + i + K - 1, p) for i in range(R)]
            for k in range(K):  # tap k for all R rows, then the window slides a row
                h = taps[k * M + p]
                for i in range(R):
                    re[i] = re[i] + h * win[i].real.astype(np.float32)
                    im[i] = im[i] + h * win[i].imag.astype(np.float32)
                if k + 1 < K:
                    win = [load(fr + K - 2 - k, p)] + win[:-1]
            for i in range(R):
                vt[((fr + i) * MSV + p)[act]] = (re[i] + 1j * im[i]).astype(np.complex64)[act]
        if tile == ntiles - 1:
            carry = np.array([load(np.full(M, T + r - t0), np.arange(M)) for r in range(K - 1)],
                             np.complex64).reshape(K - 1, M)
        outs = []
        for s in range(P):
            a = vt[(s * RP + rw)[None, :] * MSV + j[None, :] + G * np.arange(V)[:, None]]
            outs.append(row_dft_model(a, M, G, threads, tw))
        for s in range(P):
            for c in range(0, V, G):
                for m1 in range(G):
                    vt[(c + j + V * m1) * TTP + s * RP + rw] = outs[s][c + m1]
        out = vt[:M * TTP].reshape(M, TTP)
        y[:, t0:t0 + rows] = out[:, :rows]
    return y, carry


def _noise(shape, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(*shape) + 1j * rng.randn(*shape)) / np.sqrt(2)).astype(np.complex64)


def _rel(a, ref):
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("M", MS_ALL)
def test_k9_plan_covers_every_fused_shape(M):
    """Every K up to 32 at this M takes a fused form ("span" or "direct")
    with the DFT in registers, its numbers the kernel's own rules (M = G V,
    G = 2^floor(log2(M) / 2) above M = 4, TT = 256 P / G, MS and TTP even
    where 16-byte copies and reads touch them, the shared memory within a
    CTA's 227 KB); the plan is the same whatever else has been planned (a
    function of (M, K) alone); the span form wherever two spans fit; each
    stride of the layout table the least pad with the fewest bank conflicts
    for the lanes' 8-byte accesses (the FIR's reads of the span; the DFT's
    reads of v, then the FIR's writes; the DFT's writes of y); beyond K =
    32, or M = 2048, the wide form."""
    for K in range(1, 33):
        plan = pch.k9_plan(M, K)
        pch.k9_plan.cache_clear()
        assert pch.k9_plan(M, K) == plan
        G, V, P, TT, R, BR = (plan[k] for k in ("G", "V", "P", "TT", "R", "BR"))
        assert plan["form"] in ("span", "direct") and plan["dft"] == "registers"
        assert G * V == M and G == (1 if M <= 4 else 1 << ((M.bit_length() - 1) // 2))
        assert G <= V and 32 % G == 0
        assert P == max(1, min(64 * G // pch.K9_THREADS, 16 // V))
        assert TT == pch.K9_THREADS // G * P and (P == 1 or P * V <= 16)
        # the FIR threads cover the tile once: R rows of BR branches each, R <= 16
        assert R * BR * pch.K9_THREADS == TT * M and R <= 16
        assert plan["MS"] >= M and plan["MSV"] >= M and plan["TTP"] >= TT
        assert plan["TTP"] % 2 == 0 and (M < 8 or plan["MS"] % 2 == 0)
        W = min(M, 32)  # branches of a warp's FIR access
        assert plan["MS"] == _pad(M, [(lambda ms, r, j: r * R * ms + j, W)], even=M >= 8)
        assert plan["MSV"] == _pad(M, [(lambda mv, r, j: r * mv + j, G),
                                       (lambda mv, r, j: r * R * mv + j, W)], even=False)
        assert plan["TTP"] == _pad(TT, [(lambda ttp, r, j: j * ttp + r, G)], even=True)
        assert _smem(M, K, plan, plan["form"] == "span") <= SMEM_MAX
        assert (plan["form"] == "span") == (_smem(M, K, plan, True) <= SMEM_MAX)
    assert pch.k9_plan(M, 33)["form"] == "wide" and pch.k9_plan(M, 33)["dft"] == "smem"
    assert pch.k9_plan(2048, 8)["form"] == "wide"


WIDE_MS = [1 << e for e in range(15)]


def _wide_smem(M, K, lay, span):
    """Bytes of a wide-form CTA's shared memory (``wide_smem``): every pass's
    twiddles, the resident taps (span, TR = 1), the padded row tile, two
    chunk buffers (rows C apart; span, TR = 0: the chunk's taps)."""
    NT, MB, TT, C, TR, KS = lay
    tw, ns = 0, 1
    for R in pch.k9_radices(M):
        tw += 0 if ns == 1 else (R - 1) * (ns if ns <= 16 else 16 + ns // 16)
        ns *= R
    taps = lambda n: 2 * ((n + 3) // 4)  # noqa: E731
    rows = (((TT + K - 1) if span else TT) * C + 1) & ~1
    chunk = rows + (taps(K * C) if span and not TR else 0)
    return 8 * (((tw + 1) & ~1) + (taps(K * M) if span and TR else 0)
                + ((TT * M + (TT * M >> 4) + 2) & ~1) + 2 * chunk)


def _wide_budget(MB):
    """An SM's MB-th share of its 228 KB for one CTA, at most 227 KB."""
    return min(233472 // MB - 1024, SMEM_MAX)


@pytest.mark.parametrize("M", WIDE_MS)
def test_k9_wide_plan_every_row(M):
    """The wide form's plan at every M of its table (``kWideLayouts``, read
    from the source): a function of (M, K) alone; the form "wide" at K = 33
    and, above M = 1024, at every K; the span stage up to the row's KS taps
    and the rows stage above, KS the most taps whose spans fit the row's
    share of an SM; the chunk divides the row, a FIR job's R rows (4 under
    the 64-register bound, else 8) the tile, the Stockham radices multiply to
    M, at most 16 values a pass a thread (32 under 128 registers), and from
    M = 2048 to 4096 whole 32-byte sectors a run."""
    lay = pch.k9_wide_layouts()[M]
    NT, MB, TT, C, TR, KS = lay
    assert _wide_smem(M, KS, lay, True) <= _wide_budget(MB) < _wide_smem(M, KS + 1, lay, True)
    assert _wide_smem(M, 1, lay, False) <= _wide_budget(MB)
    Ks = sorted({2, 33, KS, KS + 1} | ({1, 8} if M > pch.K9_FUSED_MAX_M else set()))
    for K in (k for k in Ks if k >= 1 and not pch.k9_fused(M, k)):
        plan = pch.k9_plan(M, K)
        pch.k9_plan.cache_clear()
        assert pch.k9_plan(M, K) == plan
        R = min(TT, 4 if NT * MB >= 1024 else 8)
        assert plan["form"] == "wide" and plan["dft"] == "smem"
        assert plan["stage"] == ("span" if K <= KS else "rows")
        assert (plan["NT"], plan["MB"], plan["TT"], plan["C"], plan["TR"]) == (NT, MB, TT, C, TR)
        assert M % C == 0 and plan["chunks"] == M // C and TT % R == 0 and plan["R"] == R
        assert plan["jobs"] == C * TT // R
        assert np.prod(plan["radices"]) == M and all(r in (2, 4, 8, 16) for r in plan["radices"])
        assert plan["values"] == TT * M // NT <= (16 if NT * MB >= 1024 else 32)
        assert plan["run_bytes"] == 8 * TT and (plan["run_bytes"] >= 32 or M > 4096)
    if M > pch.K9_FUSED_MAX_M:
        assert pch.k9_plan(M, 8)["form"] == "wide"


def test_k9_plan_split_above_the_wide_form():
    """Above the wide form's largest M (16384) the split form: the FIR kernel,
    then cuFFT across the branches."""
    assert pch.k9_wide_max_m() == max(WIDE_MS) == 16384
    assert pch.k9_plan(32768, 8) == {"form": "split", "dft": "cuFFT"}
    assert pch.k9_plan(16384, 200)["form"] == "wide"


def _half_warp_wavefronts(addrs):
    """Wavefronts of one 8-byte shared-memory access of a warp's lanes at
    complex ``addrs``: over its two half warps, the most lanes on one pair of
    banks (16 complex a row of banks)."""
    return sum(int(np.bincount(np.asarray(addrs[h:h + 16]) % 16, minlength=16).max())
               for h in (0, 16) if len(addrs) > h)


def _wide_access_costs(M):
    """The wide kernel's 8-byte shared-memory accesses by warp 0, padded
    (``pad``): each pass's reads and writes (the last pass channel-major),
    the FIR's writes of v and reads of the staged chunk, the store's reads;
    {access: worst wavefronts}."""
    NT, MB, TT, C, TR, KS = pch.k9_wide_layouts()[M]
    pad = lambda i: i + (i >> 4)  # noqa: E731
    lanes = np.arange(32)
    out, ns = {}, 1
    for R in pch.k9_radices(M):
        NB = M // R
        u = lanes[lanes < TT * NB]
        row, j = u // NB, u % NB
        k = j % ns
        last = ns * R == M
        out[f"pass {R}/{ns} read"] = max(_half_warp_wavefronts(pad(row * M + j + r * NB))
                                         for r in range(R))
        out[f"pass {R}/{ns} write"] = max(_half_warp_wavefronts(pad(
            (j + r * ns) * TT + row if last else row * M + (j - k) * R + k + r * ns))
            for r in range(R))
        ns *= R
    R = min(TT, 4 if NT * MB >= 1024 else 8)
    u = lanes[lanes < C * (TT // R)]
    p, q0 = u % C, u // C * R
    out["fir write"] = max(_half_warp_wavefronts(pad((q0 + i) * M + p)) for i in range(R))
    out["fir read"] = _half_warp_wavefronts(q0 * C + p)
    out["store read"] = _half_warp_wavefronts(pad(lanes // C * M + lanes % C))
    return out


@pytest.mark.parametrize("M", WIDE_MS)
def test_wide_accesses_bank_conflicts(M):
    """The wide kernel's shared-memory accesses, modelled: from M = 256 up
    every one takes the two wavefronts an 8-byte warp access needs (no bank
    conflict); below, each pass's reads still do, and the last pass's
    channel-major writes and the FIR of chunks narrower than 16 branches
    take at most 8 a half warp."""
    costs = _wide_access_costs(M)
    if M >= 256:
        assert all(v == 2 for v in costs.values()), costs
    else:
        assert all(v == 2 for k, v in costs.items() if k.endswith("read") and "pass" in k), costs
        assert max(costs.values()) <= 8 * 2, costs


@pytest.mark.parametrize("M,K", [(64, 8), (4, 8)])
def test_k9_plan_paths_take_the_new_form(M, K):
    """The wideband path (M = 64) and its vote (M = 4), K = 8: the span
    form, the DFT in registers (8 x 8; radix 4 in one lane), the output
    runs of a channel at least 512 bytes, two CTAs' shared memory within an
    SM's 228 KB, no bank conflict beyond the two wavefronts an 8-byte warp
    access takes on the FIR's reads of the span and the DFT's reads of v
    and writes of y."""
    plan = pch.k9_plan(M, K)
    assert plan["form"] == "span" and plan["dft"] == "registers"
    assert (plan["G"], plan["V"]) == ((8, 8) if M == 64 else (1, 4))
    assert 8 * plan["TT"] >= 512
    assert 2 * (_smem(M, K, plan, True) + 1024) <= 228 * 1024
    G, R, W = plan["G"], plan["R"], min(M, 32)
    assert _wavefronts(lambda r, j: r * R * plan["MS"] + j, W) == 2  # the FIR's reads
    assert _wavefronts(lambda r, j: r * plan["MSV"] + j, G) == 2  # the DFT's reads
    assert _wavefronts(lambda r, j: j * plan["TTP"] + r, G) == 2  # the DFT's writes


@pytest.mark.parametrize("M", MS_ALL)
def test_dft_model_matches_numpy_fft(M):
    """The kernel's DFT across the branches of 256 / G rows, in its digit
    order with the float32 table: within 1e-6 of max|y| of float64's FFT."""
    plan = pch.k9_plan(M, 1)
    G, V = plan["G"], plan["V"]
    lanes = np.arange(pch.K9_THREADS)
    nrows = pch.K9_THREADS // G
    v = _noise((nrows, M), M)
    j, row = lanes % G, lanes // G
    a = v[row[None, :], j[None, :] + G * np.arange(V)[:, None]]  # (V, lanes)
    b = row_dft_model(a, M, G, lanes, _table(M))
    y = np.zeros((nrows, M), np.complex64)
    for c in range(0, V, G):
        for m1 in range(G):
            y[row, c + j + V * m1] = b[c + m1]
    ref = np.fft.fft(v.astype(np.complex128), axis=1)
    assert _rel(y, ref) < DFT_REL


#: (M, K, T1, T2): the stream cut after T1 rows; T2 < K - 1 puts old state
#: rows in the carry; T not a multiple of the plan's TT leaves a ragged tile;
#: (1024, 8) and (512, 16) take the direct form
TILE_CASES = [(64, 8, 130, 200), (64, 8, 64, 3), (4, 8, 300, 5), (4, 8, 256, 700),
              (1, 3, 7, 1), (2, 32, 40, 9), (8, 4, 129, 2), (16, 1, 70, 65),
              (32, 32, 10, 80), (128, 16, 33, 7), (256, 32, 17, 5), (512, 16, 20, 9),
              (1024, 8, 9, 4), (1024, 2, 12, 1)]


@pytest.mark.parametrize("M,K,T1,T2", TILE_CASES)
def test_launch_model_matches_numpy_and_jax(M, K, T1, T2):
    """The modelled launch over a stream in two calls, the carry of the first
    into the second: each half and the one-shot call within 1e-5 of max|y| of
    ``channelize_numpy`` on the whole stream, the second also of JAX's
    ``Channelizer`` given the same carry; every carry equal to JAX's and to
    the plain version's; no NaN (no slot the staging left unwritten) reaches
    a row of y."""
    x = _noise(((T1 + T2) * M,), M + K + T2)
    h2 = pch.design_prototype(M, K).reshape(K, M).astype(np.float32)
    golden = pch.channelize_numpy(x, M, K)
    h = T1 * M
    y1, c1 = k9_model(x[:h], h2, None)
    y2, c2 = k9_model(x[h:], h2, c1)
    y, c = k9_model(x, h2, None)
    for got in (y1, y2, y):
        assert np.isfinite(got).all()
    assert _rel(np.concatenate([y1, y2], axis=1), golden) < REL
    assert _rel(y, golden) < REL
    np.testing.assert_array_equal(y[:, T1:], y2)  # a row's bits do not depend on its tile
    jch = JaxChannelizer(M, K, jit=False)
    _, jst1 = jch(c2ri(x[:h]))
    jy2, jst2 = jch(c2ri(x[h:]), jst1)
    for carry, jst in ((c1, jst1), (c2, jst2)):
        st = np.asarray(jst)
        np.testing.assert_array_equal(carry, (st[0] + 1j * st[1]).astype(np.complex64))
    assert _rel(y2, ri2c(np.asarray(jy2))) < REL
    _, sp = pch.channelize_plain(torch.from_numpy(x[h:]), torch.from_numpy(h2),
                                 torch.from_numpy(c1))
    np.testing.assert_array_equal(c2, sp.numpy())
    np.testing.assert_array_equal(c, c2)
