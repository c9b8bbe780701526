"""A numpy model of K1 (``pycusdr_tpu_torch/csrc/doppler_energy.cu``), the
Doppler energy, on the CPU.

The CUDA kernel runs only on the card, so this file models what it reads
and how it adds: the plan of ``ops/doppler_search.doppler_energy_plan``
(groups of 64 shifts in circular order, dealt to the 8-row halves of their
tiles by offset mod 8, the group's first shift in row 0; chunks of L
samples, eight leaves of L / 8 each); the launch grid of ``k1_grid`` (the
tiles and the blocks a CTA takes at batch B); each CTA's window
[base + c_b + k0, + arc + L) mod N, or its reads of P in global memory where
arc + L exceeds the window; the sample order of a warp's 32-sample step
(lane (g, t) takes 8 t + j and 8 t + 4 + j in sub-step j); and the 3xTF32
products (hi = tf32(x), TF32 = round to nearest, ties away, at 10 mantissa
bits, as ``cvt.rna.tf32.f32``; lo = x - hi, which the tensor core reads
truncated to TF32).

The model's sums follow the kernel's tree: each leaf's products are added
in float64 and rounded once to f32 (the tensor cores add in f32, in an
order the model does not follow), the eight leaves of a chunk pairwise in
f32, then the chunk partials in f32 in chunk order, times the
f32 scale. Tolerances, relative to max|E|: the model within 1e-6 of a
float64 E (the dropped lo*lo term is below 2^-22 of a product, the
truncation of lo below 2^-21, the f32 roundings of the sums about 2^-24
each), and within 1e-4 of ``doppler_energy_plain`` (the bar
``chip_smoke.py`` holds the kernel to); one TF32 product (hi*hi alone)
misses 1e-4 on a flagship block.
"""

import numpy as np
import pytest
import torch

from pycusdr_tpu_torch.configs import RADIO, flagship_conf, tracking_conf
from pycusdr_tpu_torch.convert import DeviceConsts
from pycusdr_tpu_torch.dsp.signal_gen import modulate_gfsk2
from pycusdr_tpu_torch.dsp.spec import build_spec, narrow_spec
from pycusdr_tpu_torch.ops import doppler_search as ds
from pycusdr_tpu_torch.protocol import loadProtocol

torch.set_num_threads(2)
F32 = np.float32
ROWS = ds.K1_ROWS
GROUP = ds.K1_GROUP_TILES * ROWS


@pytest.fixture(scope="module")
def flagship():
    conf = flagship_conf()
    spec = build_spec(conf, loadProtocol("bench_GFSK")(conf=conf), RADIO)
    return spec, DeviceConsts.from_spec(spec, torch.device("cpu"))


def tf32(x):
    """``cvt.rna.tf32.f32``: round to nearest, ties away, at 10 mantissa bits."""
    u = np.asarray(x, F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def truncate(x):
    """What the tensor core reads of an f32 given as a TF32 operand: its top
    19 bits (the low 13 mantissa bits dropped)."""
    return (np.asarray(x, F32).view(np.uint32) & np.uint32(0xFFFFE000)).view(F32)


def split(x):
    """The kernel's ``split``: (hi, lo) as the mma reads them, float64: hi
    = tf32(x), lo = x - hi (exact in f32), truncated to TF32."""
    x = np.asarray(x, F32)
    hi = tf32(x)
    return hi.astype(np.float64), truncate(x - hi).astype(np.float64)


def step_order():
    """The samples of a warp's 32-sample step as its mma fragments take them:
    sub-step j, lane column t, half h (a0/b0 or a2/b1) -> 8 t + 4 h + j."""
    j, t, h = np.meshgrid(np.arange(4), np.arange(4), np.arange(2), indexing="ij")
    return (8 * t + 4 * h + j).reshape(-1)


def ctas(plan, B, grid=None):
    """The CTAs of K1's launch at batch B, on ``grid`` = (tg, bt) (default
    ``k1_grid``'s): yields (chunk c, tile0, tiles, blocks)."""
    tg, bt = grid or ds.k1_grid(B, plan.nch, plan.T, plan.tg_max)
    for c in range(plan.nch):
        for tile0 in range(0, plan.T, tg):
            for b0 in range(0, B, bt):
                yield c, tile0, min(tg, plan.T - tile0), range(b0, min(B, b0 + bt))


def reads(plan, shifts, centre, tile0, ntile, c):
    """The products of one CTA for one block with recentre ``centre``, as the
    kernel maps them: (rows (R,), leaf w of each sample (L,), the samples k
    (L,), the P index (R, L), window or not). Asserts the bounds the kernel
    relies on: a window read lies inside the staged arc + L samples."""
    N, L = plan.N, plan.L
    s = np.mod(np.asarray(shifts, np.int64), N)
    rows = plan.rows[tile0 * ROWS:(tile0 + ntile) * ROWS]
    base = s[plan.rows[tile0 // ds.K1_GROUP_TILES * GROUP]]
    off = np.where(rows >= 0, np.mod(s[np.maximum(rows, 0)] - base, N), 0)
    arc = off.max()
    window = arc + L + ds.K1_WINDOW_SLACK <= plan.wwin
    k0 = c * L
    start = (base + centre + k0) % N
    leaf = L // ds.K1_LEAVES
    ks = np.concatenate([w * leaf + kb + step_order()
                         for w in range(ds.K1_LEAVES) for kb in range(0, leaf, 32)])
    assert np.array_equal(np.sort(ks), np.arange(L))
    if window:
        pos = off[:, None] + ks[None, :]
        assert pos.max() < arc + L  # inside the staged window (the slack is the copies')
        pidx = (start + pos) % N
    else:
        pidx = ((start + off)[:, None] % N + ks[None, :]) % N
    return rows, ks // leaf, k0 + ks, pidx, window


def model_energy(plan, P, Q, shifts, centre=None, passes=3, grid=None):
    """E (B, D, M) as K1 adds it on its launch at this B: each leaf's split
    products in float64, rounded to f32, the leaves pairwise, the chunks in
    order, in f32, times the f32 scale. ``passes=1``:
    hi*hi alone (one TF32 product); ``grid``: the launch's (tg, bt)."""
    B, N = P.shape
    D, M, L = len(shifts), Q.shape[0], plan.L
    Qz = np.zeros((M, plan.nch * L), F32)
    Qz[:, :N] = Q  # zero past N
    Qh, Ql = split(Qz)
    Ph, Pl = split(P)
    part = np.zeros((B, plan.nch, plan.T * ROWS, M), F32)
    for c, tile0, ntile, blocks in ctas(plan, B, grid):
        for b in blocks:
            cb = 0 if centre is None else int(centre[b])
            rows, leaf, ks, pidx, _ = reads(plan, shifts, cb, tile0, ntile, c)
            ah, al = Ph[b][pidx], Pl[b][pidx]
            w = []
            for i in range(ds.K1_LEAVES):
                sel = leaf == i
                bh, bl = Qh[:, ks[sel]], Ql[:, ks[sel]]
                prod = ah[:, sel] @ bh.T
                if passes == 3:
                    prod = prod + ah[:, sel] @ bl.T + al[:, sel] @ bh.T
                w.append(prod.astype(F32))
            r = slice(tile0 * ROWS, (tile0 + ntile) * ROWS)
            while len(w) > 1:  # pairwise
                w = [w[i] + w[i + 1] for i in range(0, len(w), 2)]
            part[b, c, r] = w[0]
    E = np.zeros((B, D, M), F32)
    ok = plan.rows >= 0
    for b in range(B):
        acc = part[b, 0].copy()
        for c in range(1, plan.nch):
            acc = acc + part[b, c]
        E[b, plan.rows[ok]] = acc[ok] * F32(N / ds.ABS_SUM_SCALE)
    return E


def e64(P, Q, shifts, centre=None):
    """E in float64 from the f32 inputs."""
    B, N = P.shape
    out = []
    for b in range(B):
        c = 0 if centre is None else int(centre[b])
        idx = (np.arange(N)[None, :] + np.asarray(shifts, np.int64)[:, None] + c) % N
        out.append(P[b].astype(np.float64)[idx] @ Q.astype(np.float64).T)
    return np.stack(out) * (N / ds.ABS_SUM_SCALE)


def plain(P, Q, shifts, centre=None):
    cs = None if centre is None else torch.from_numpy(np.asarray(centre, np.int32))
    return ds.doppler_energy_plain(torch.from_numpy(P), torch.from_numpy(Q),
                                   torch.from_numpy(np.asarray(shifts, np.int32)), cs).numpy()


def gfsk_block(spec, seed, doppler_hz=3000.0):
    """|FFT|^2 of one flagship block of GFSK at the IF offset plus
    ``doppler_hz`` with light AWGN (chip_smoke's signal), f32."""
    rng = np.random.RandomState(seed)
    N, sps = spec.Nfft, int(spec.spsym)
    sig = modulate_gfsk2(rng.randint(0, 2, N // sps + 8), sps)[:N]
    sig = sig * np.exp(2j * np.pi * (spec.centreFreqOffset + doppler_hz) / spec.sampleRate
                       * np.arange(N))
    sig = (sig + 0.05 / np.sqrt(2) * (rng.randn(N) + 1j * rng.randn(N))).astype(np.complex64)
    S = np.fft.fft(sig).astype(np.complex64)
    return (S.real * S.real + S.imag * S.imag).astype(F32)


# ------------------------------------------------------------------ grids


def grid(name, flagship):
    """(shifts, N, M, recentres of two blocks) of the named grid."""
    spec, c = flagship
    N = spec.Nfft
    rng = np.random.RandomState(GRIDS.index(name))
    if name == "flagship":
        return c.shifts.numpy(), N, spec.num_masks, [0, 37]
    if name == "tiny_wraps":  # a small circle the grid wraps round
        return np.array([500, 505, 510, 3, 9, 14, 20], np.int32), 512, 5, [0, 600]
    if name == "tracking":  # the tracker's 16-bin grid, recentred off the circle both ways
        tc = tracking_conf()
        track = narrow_spec(spec, tc["track_bins"], tc["track_span_bins"])
        return np.asarray(track.dopp_shifts, np.int32), N, spec.num_masks, [-(N + 7), 2 * N + 1]
    if name == "bpsk_m16":
        return c.shifts.numpy(), N, 16, [0, -100]
    if name == "shard_m4":
        return c.shifts.numpy(), N, 4, [5, N - 2]
    if name.startswith("random"):  # random grids: D and M as the card tests take them
        N, D, M = {"random_a": (512, 20, 16), "random_b": (1024, 7, 32),
                   "random_c": (8192, 129, 1)}[name]
        return rng.randint(0, N, D).astype(np.int32), N, M, [3, 5 - N]
    if name == "global_read":  # arcs too long for any window: P from global memory
        N = 2 ** 18
        return rng.randint(0, N, 3).astype(np.int32), N, 2, [1, -N + 11]
    if name == "mixed":  # 64 shifts 7 bins apart, 65 spread over half of 2^17
        N = 2 ** 17
        s = np.r_[7 * np.arange(64), N // 8 + (N // 2 // 65) * np.arange(65)]
        return rng.permutation(s).astype(np.int32), N, 8, [0, 77]
    raise KeyError(name)


GRIDS = ("flagship", "tiny_wraps", "tracking", "bpsk_m16", "shard_m4", "random_a",
         "random_b", "random_c", "global_read", "mixed")


@pytest.mark.parametrize("name", GRIDS)
def test_index_map_reads_each_term_once(flagship, name):
    """For every (d, k < N): exactly one product of a block reads P[(k + s_d
    + c_b) mod N], whichever path its CTA takes (the reads of the launch at
    B = 1, whose CTAs take one tile each; wider CTAs read the same rows
    through the same maps); and the launches at B = 1, 7 and 64 give each
    (block, chunk, tile) to exactly one CTA. Every shift has one row."""
    shifts, N, M, centres = grid(name, flagship)
    plan = ds.doppler_energy_plan(shifts, N, M)
    D = len(shifts)
    assert np.array_equal(np.sort(plan.rows[plan.rows >= 0]), np.arange(D))
    table = plan.table(shifts)  # what the kernel reads: index and shift mod N
    assert np.array_equal(table[:, 0], plan.rows)
    first = np.repeat(table[::GROUP, 1], GROUP)[:len(table)]
    assert np.array_equal(table[:, 1], np.where(plan.rows >= 0, np.mod(
        np.asarray(shifts, np.int64)[np.maximum(plan.rows, 0)], N), first))
    s = np.asarray(shifts, np.int64)
    for B in (1, 7, 64):
        cover = np.zeros((B, plan.nch, plan.T), np.int64)
        for c, tile0, ntile, blocks in ctas(plan, B):
            assert ntile <= plan.tg_max and tile0 // 4 == (tile0 + ntile - 1) // 4  # one group
            cover[list(blocks), c, tile0:tile0 + ntile] += 1
        assert cover.min() == cover.max() == 1  # each (block, chunk, tile) in one CTA
    for cb in centres:
        seen = np.zeros(D * N, np.int64)
        for c, tile0, ntile, _ in ctas(plan, 1):
            rows, _, ks, pidx, _ = reads(plan, shifts, cb, tile0, ntile, c)
            ok = rows >= 0
            inside = ks < N
            d = rows[ok][:, None]
            want = (ks[None, inside] + s[d] + cb) % N
            assert np.array_equal(pidx[ok][:, inside], want)
            np.add.at(seen, (d * N + ks[None, inside]).reshape(-1), 1)
        assert seen.min() == seen.max() == 1


def test_both_paths_are_planned(flagship):
    """The flagship grid fits one window group; a spread grid takes the
    global-read path; the mixed grid takes both; the flagship's window and
    Q's chunk leave room for two CTAs an SM."""
    paths = {}
    for name in GRIDS:
        shifts, N, M, _ = grid(name, flagship)
        plan = ds.doppler_energy_plan(shifts, N, M)
        nw = plan.window_groups(shifts)
        paths[name] = (nw, len(plan.group_arcs(shifts)) - nw)
    assert paths["flagship"] == (1, 0)
    assert paths["global_read"] == (0, 1)
    assert paths["mixed"][0] >= 1 and paths["mixed"][1] >= 1
    assert paths["tiny_wraps"] == paths["tracking"] == (1, 0)
    spec, c = flagship
    plan = ds.doppler_energy_plan(c.shifts.numpy(), spec.Nfft, 8)
    assert (plan.L, plan.nch, plan.T) == (2048, 32, 4)
    assert 4 * (plan.MP * (plan.L + 4) + plan.wwin) <= ds.K1_SMEM


def test_bank_deal_is_optimal(flagship):
    """Within a group each 8-row half repeats an offset mod 8 no more often
    than the pigeonhole forces, ceil(count / halves), and the group's first
    shift sits in its row 0 (the base every CTA of the group reads)."""
    for name in GRIDS:
        shifts, N, M, _ = grid(name, flagship)
        plan = ds.doppler_energy_plan(shifts, N, M)
        s = np.mod(np.asarray(shifts, np.int64), N)
        for g0 in range(0, len(plan.rows), GROUP):
            rows = plan.rows[g0:g0 + GROUP]
            base = s[rows[0]]
            off = {d: np.mod(s[d] - base, N) for d in rows[rows >= 0]}
            assert min(off.values()) == 0
            halves = rows.reshape(-1, 8)
            res = [np.array([off[d] % 8 for d in h if d >= 0], np.int64) for h in halves]
            counts = np.bincount(np.concatenate(res), minlength=8)
            for r in res:
                if len(r):
                    assert np.all(np.bincount(r, minlength=8) <= -(-counts // len(halves)))


def test_launch_grid():
    """``k1_grid``: at least K1_CTA_TARGET CTAs where the batch allows, with
    the most tiles a CTA that do and the blocks in the fewest even runs;
    else one tile and one block a CTA."""
    for B in range(1, 70):
        for nch, T, tg_max in ((32, 4, 4), (128, 1, 4), (1, 9, 2), (4, 3, 4)):
            tg, bt = ds.k1_grid(B, nch, T, tg_max)
            assert tg in (1, 2, 4) and tg <= tg_max and 1 <= bt <= B
            G = -(-T // tg)
            if nch * G * -(-B // bt) < ds.K1_CTA_TARGET:
                assert (tg, bt) == (1, 1)
                continue
            runs = -(-B // bt)
            assert -(-B // runs) == bt  # even runs
            need = -(-ds.K1_CTA_TARGET // (nch * G))
            assert runs == min(r for r in {-(-B // x) for x in range(1, B + 1)} if r >= need)
            if tg < tg_max:  # twice the tiles would not have given enough runs
                assert -(-ds.K1_CTA_TARGET // (nch * -(-T // (2 * tg)))) > B
    assert [ds.k1_grid(B, 32, 4, 4) for B in (1, 16, 64)] == [(1, 1), (4, 2), (4, 8)]


def test_sums_do_not_depend_on_the_batch(flagship):
    """The plan takes no batch and the launch changes no sum: the model of
    K1's launch at B = 64 gives each block the bits it gives it at B = 7 and
    alone (B = 1), though the three launches split tiles and blocks
    differently (a 4096-sample grid, on launch grids of 1, 2 and 4 tiles and
    1, 3 and 8 blocks a CTA, as ``k1_grid`` picks them at larger N)."""
    N = 4096
    rng = np.random.RandomState(3)
    shifts = rng.randint(0, N, 70).astype(np.int32)
    plan = ds.doppler_energy_plan(shifts, N, 8)
    grids = {1: (1, 1), 7: (2, 3), 64: (4, 8)}
    P = rng.rand(64, N).astype(F32)
    Q = rng.rand(8, N).astype(F32)
    centre = rng.randint(-2 * N, 2 * N, 64)
    batch = model_energy(plan, P, Q, shifts, centre, grid=grids[64])
    seven = model_energy(plan, P[:7], Q, shifts, centre[:7], grid=grids[7])
    assert np.array_equal(seven, batch[:7])
    for b in (0, 5, 63):
        alone = model_energy(plan, P[b:b + 1], Q, shifts, centre[b:b + 1], grid=grids[1])
        assert np.array_equal(alone[0], batch[b])


@pytest.mark.parametrize("inference", [False, True])
def test_device_plan_follows_the_grid(inference):
    """The plan kept on the grid tensor is rebuilt after an in-place change
    of the grid: through ``_version``, and at every call for an inference
    tensor, which keeps no version."""
    N, M = 4096, 8
    with torch.inference_mode(inference):
        shifts = torch.arange(0, 4 * 70, 4, dtype=torch.int32)
    plan, table = ds._device_plan(shifts, N, M)
    assert np.array_equal(table.numpy(), plan.table(shifts.numpy()))
    with torch.inference_mode(inference):
        shifts.mul_(3)
    plan2, table2 = ds._device_plan(shifts, N, M)
    assert np.array_equal(table2.numpy(), ds.doppler_energy_plan(shifts.numpy(), N, M)
                          .table(shifts.numpy()))
    assert not np.array_equal(table2.numpy(), table.numpy())


@pytest.mark.parametrize("centre", [None, [-(2 ** 16) - 5]])
def test_3xtf32_within_bound_on_random_inputs(flagship, centre):
    """Flagship-sized random P and Q (uniform, and heavy-tailed): the
    model within 1e-6 * max|E| of float64, and within 1e-4 * max|E| of
    ``doppler_energy_plain``."""
    spec, c = flagship
    N, M = spec.Nfft, spec.num_masks
    shifts = c.shifts.numpy()
    plan = ds.doppler_energy_plan(shifts, N, M)
    rng = np.random.RandomState(11)
    for P, Q in ((rng.rand(1, N), rng.rand(M, N)),
                 (rng.lognormal(0, 3, (1, N)), rng.lognormal(0, 3, (M, N)))):
        P, Q = P.astype(F32), Q.astype(F32)
        ref = e64(P, Q, shifts, centre)
        got = model_energy(plan, P, Q, shifts, centre)
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 1e-6 * scale
        assert np.abs(got - plain(P, Q, shifts, centre)).max() <= 1e-4 * scale


def test_one_tf32_pass_misses_the_bar(flagship):
    """On flagship blocks (the bench_GFSK masks' Q, GFSK spectra) the
    3xTF32 model holds 1e-4 * max|E| against the plain version and 1e-6
    against float64, and hi*hi alone does not: the split stays three
    products."""
    spec, c = flagship
    shifts, Q = c.shifts.numpy(), c.Q.numpy()
    plan = ds.doppler_energy_plan(shifts, spec.Nfft, spec.num_masks)
    P = gfsk_block(spec, 6, -2500.0)[None]
    ref = e64(P, Q, shifts)
    scale = np.abs(ref).max()
    three = model_energy(plan, P, Q, shifts)
    one = model_energy(plan, P, Q, shifts, passes=1)
    assert np.abs(three - ref).max() <= 1e-6 * scale
    assert np.abs(three - plain(P, Q, shifts)).max() <= 1e-4 * scale
    assert np.abs(one - ref).max() > 1e-4 * scale
    assert np.abs(one - plain(P, Q, shifts)).max() > 1e-4 * scale


def test_tf32_rounding():
    """TF32 rounding: ties away from zero at bit 13, exact values kept, and
    hi + lo, lo truncated, reproduces x to within 2^-21 relative."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    assert tf32(one + ulp / 2) == one + ulp  # a tie rounds away
    assert tf32(one + ulp / 2 - np.float32(2.0 ** -23)) == one
    assert tf32(one + ulp) == one + ulp
    x = np.random.RandomState(0).lognormal(0, 5, 10000).astype(F32)
    hi, lo = split(x)
    assert np.all(np.abs(hi + lo - x) <= 2.0 ** -21 * x)
    assert np.all(np.abs(lo) <= 2.0 ** -11 * x)
    assert np.all(tf32(x).view(np.uint32) & 0x1FFF == 0)
