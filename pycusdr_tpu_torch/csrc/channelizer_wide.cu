// K9 channelize, wide form: the banks the fused form (channelizer.cu) does not
// take, M > 1024 or K > 32, as one launch for every K >= 1 and every
// power-of-two M up to kWideMaxM. The same function as the fused form:
//
//   xp       = [state; x as (T, M) rows]            (T + K - 1, M) complex
//   v[t, p]  = sum_{k=0..K-1} h2[k, p] * xp[t + K - 1 - k, p]
//   y[m, t]  = sum_p v[t, p] * exp(-2 pi i p m / M)  (an M-point DFT per row)
//   carry    = xp[T:]                                 (K - 1, M)
//
// x: (T M,) complex64, state: (K - 1, M) complex64 (NULL: zeros), h2: (K, M)
// f32, tw: (M, 2) f32 table of exp(+2 pi i j / M) built in float64, y: (M, T)
// complex64 channel-major, carry: (K - 1, M) complex64.
//
// Replaces pycusdr_tpu/parallel/channelizer.py:Channelizer._apply (:43-64)
// at the shapes the fused form cannot hold. Above kWideMaxM the "split" form
// runs channelizer.cu:channelize_fir, then cuFFT.
//
// Bound: bytes. x is read once and y written once, 16 B a sample: 67.1 MB
// and 0.0200 ms at 3.35 TB/s for T M = 2^22; the f32 work, (4 K + 5 log2 M)
// a sample, is smaller at the wide shapes.
//
// Design. A persistent grid (one CTA an SM above M = 1024, two below); a CTA
// takes a tile of TT consecutive rows and every branch at a time, tiles
// grid-strided, so the CTAs at work write neighbouring runs of each channel
// at once. TT and the other numbers come from M's row of kWideLayouts.
// 1. Staging: the FIR reads the tile in chunks of C branches. A chunk's xp
//    rows (the "span" stage: TT + K - 1 rows, rows of `state` before the
//    input, zeros for NULL and past the end; the "rows" stage, where the
//    span does not fit: the TT own rows, the K - 1 older ones read from L2)
//    are copied by 16-byte cp.async into one of two buffers, two chunks
//    ahead: the next tile's first two chunks load under this tile's DFT.
//    The taps stay in shared memory for the launch (TR = 1) or come with
//    each chunk (TR = 0, where the whole of h2 would not fit).
// 2. The FIR, in k order with __fmul_rn / __fadd_rn as the plain version.
//    A job is R consecutive rows of one branch, consecutive threads on
//    consecutive branches. It keeps a ring of R input rows in registers: at
//    step k row i needs xp row i + K - 1 - k, which sits in slot (i - k) mod
//    R, so with k unrolled by R every slot is known at compile time and a
//    step loads one new row for R outputs; a block of R steps loads its rows
//    and taps before it adds. v goes to the row tile W (TT, M).
// 3. The M-point DFT of each row in W: Stockham passes (radix 2^e first,
//    log2 M = 4 q + e, then q of radix 16). A pass loads each thread's
//    butterflies into registers, barriers, twiddles them by exp(-2 pi i r
//    (j mod Ns) / (Ns R)), runs the R-point DFT in registers (radix 16 as
//    4 x 4 with constant twiddles) and writes the results to their Stockham
//    places in W, so the output ends in natural order; the last pass writes
//    channel-major, row t's y[m] at m TT + t. The twiddles are entries of the
//    float64-built table, one a twiddle where Ns <= 16 and the product of two
//    above (pass_twiddle), laid out so a warp reads consecutive entries.
// 4. The store: TT rows of each channel, one run of 8 TT bytes (32 B or more
//    up to M = 4096: whole sectors). It goes out in parts, before the next
//    tile's FIR writes each chunk's part of W, so it overlaps that tile's
//    loads; the last tile's after its DFT.
// Every index into W goes through pad(): one complex of padding every 16,
// which keeps the strided accesses of the FIR, the passes, the channel-major
// writes and the store on distinct bank pairs from M = 256 up (below, the
// last pass's writes and the FIR of chunks narrower than 16 branches share
// some; tests/test_torch_channelizer_plan.py models them). The carry: every
// thread of the grid writes rows [T, T + K - 1) of xp, grid-strided, before
// its first tile. One launch is the whole call.
//
// Tried on the card and slower, so not kept (PERF.md section 6): CTAs
// of a cluster splitting the branches and exchanging them through
// distributed shared memory; tiles of one or two rows (runs of 8 or 16 bytes,
// each sector written in parts by different tiles); two CTAs an SM; 16-byte
// stores of two rows; twiddles as powers of one staged value.
#include "common.cuh"
#include "fft_smem.cuh"

namespace {

constexpr int kSmemMax = 232448;   // the dynamic shared memory a CTA may take (227 KB)
constexpr int kSmemSM = 233472;    // an SM's shared memory (228 KB), 1 KB of it reserved a CTA

// The wide form's layout at each M, row i for M = 2^i (parallel/channelizer.py
// :k9_plan reads these rows): NT threads a CTA, MB CTAs an SM (the launch
// bounds: 64 registers a thread where NT MB = 1024, else 128), TT rows a
// tile, C branches a staged chunk, TR the taps resident (1) or staged with
// each chunk (0), KS the most taps of the span stage (the TT + K - 1 rows of
// a chunk staged, twice) within an SM's MB-th share of shared memory; above
// KS the rows stage (a chunk's TT rows staged, the K - 1 older rows read
// from L2).
struct WideLayout {
    int M, NT, MB, TT, C, TR, KS;
};
constexpr WideLayout kWideLayouts[] = {
    // M, NT, MB, TT, C, TR, KS
    {1, 128, 2, 512, 1, 1, 5157},
    {2, 128, 2, 256, 2, 1, 2579},
    {4, 128, 2, 128, 4, 1, 1290},
    {8, 128, 2, 64, 8, 1, 645},
    {16, 128, 2, 64, 16, 1, 283},
    {32, 128, 2, 32, 32, 1, 142},
    {64, 128, 2, 32, 64, 1, 51},
    {128, 128, 2, 16, 128, 1, 26},
    {256, 256, 2, 8, 256, 1, 13},
    {512, 256, 2, 8, 256, 1, 8},
    {1024, 512, 1, 8, 512, 1, 8},
    {2048, 512, 1, 4, 512, 1, 8},
    {4096, 512, 1, 4, 512, 1, 2},
    {8192, 1024, 1, 2, 512, 0, 6},
    {16384, 512, 1, 1, 256, 0, 13},
};
constexpr int kWideCount = sizeof(kWideLayouts) / sizeof(kWideLayouts[0]);
constexpr int kWideMaxM = kWideLayouts[kWideCount - 1].M;

__host__ __device__ constexpr int log2c(int n) { return n <= 1 ? 0 : 1 + log2c(n / 2); }
// element i of a padded buffer
__host__ __device__ constexpr int pad(int i) { return i + (i >> 4); }
// float2s of a padded buffer of n elements, rounded up to 16 bytes
__host__ __device__ constexpr int plen(int n) { return (n + (n >> 4) + 2) & ~1; }
// the Stockham passes: log2 M = 4 q + e, radix 2^e first where e > 0, then q of radix 16
__host__ __device__ constexpr int npasses(int M) { return (log2c(M) + 3) / 4; }
__host__ __device__ constexpr int pass_radix(int M, int s) {
    return (s == 0 && log2c(M) % 4 != 0) ? 1 << (log2c(M) % 4) : 16;
}
__host__ __device__ constexpr int pass_ns(int M, int s) {
    return s == 0 ? 1 : pass_ns(M, s - 1) * pass_radix(M, s - 1);
}
// Pass s's twiddles exp(-2 pi i r k / (Ns R)), 1 <= r < R, k < Ns: up to
// Ns = 16 a table [r - 1][k]; above, the product of a table [r - 1][k mod 16]
// and a table [r - 1][k div 16] (one rounding more). A warp's lanes
// (consecutive k) read consecutive entries, or one. Pass 0 (Ns = 1) has none.
__host__ __device__ constexpr int pass_tw_len(int M, int s) {
    return s == 0 ? 0
                  : (pass_radix(M, s) - 1) *
                        (pass_ns(M, s) <= 16 ? pass_ns(M, s) : 16 + pass_ns(M, s) / 16);
}
__host__ __device__ constexpr int pass_tw_off(int M, int s) {
    return s <= 1 ? 0 : pass_tw_off(M, s - 1) + pass_tw_len(M, s - 1);
}
// float2s of every pass's twiddles, rounded up to 16 bytes
__host__ __device__ constexpr int tw_len(int M) { return (pass_tw_off(M, npasses(M)) + 1) & ~1; }
// most rows of a FIR job: 4 under the 64-register bound, else 8
__host__ __device__ constexpr int ring_rows(int NT, int MB) { return NT * MB >= 1024 ? 4 : 8; }
// float2s of a chunk's staged rows (span: TT + K - 1 of them; rows: TT), C
// branches each, unpadded (the FIR's lanes read consecutive branches),
// rounded up to 16 bytes
__host__ __device__ constexpr long long rows_len(int TT, int C, int K, bool span) {
    return (((long long)(span ? TT + K - 1 : TT)) * C + 1) & ~1LL;
}
// float2s of n f32 taps, rounded up to 16 bytes
__host__ __device__ constexpr long long taps_len(long long n) { return 2 * ((n + 3) / 4); }
// The span stage's taps: all of h2 (K, M) for the whole launch (TR = 1), or
// each chunk's K C with its rows (TR = 0); the rows stage reads them through L1.
// A chunk buffer: its rows, then (TR = 0) its taps.
__host__ __device__ constexpr long long chunk_len(int TT, int C, int K, bool span, int TR) {
    return rows_len(TT, C, K, span) + (span && !TR ? taps_len((long long)K * C) : 0);
}
// shared memory (bytes): the twiddles, the resident taps, the row tile (TT,
// M), two chunk buffers
constexpr long long wide_smem(const WideLayout& l, int K, bool span) {
    return 8LL * (tw_len(l.M) + (span && l.TR ? taps_len((long long)K * l.M) : 0) +
                  plen(l.TT * l.M) + 2 * chunk_len(l.TT, l.C, K, span, l.TR));
}
// an SM's MB-th share of shared memory for one CTA
constexpr long long smem_budget(int MB) {
    return kSmemSM / MB - 1024 < kSmemMax ? kSmemSM / MB - 1024 : kSmemMax;
}

// Every row is its M's, its chunk divides it, its tiles fit its share of
// an SM, KS is the most taps whose spans fit, a FIR job's rows divide the
// tile, a pass holds at most 16 values a thread under the 64-register bound,
// else 32.
constexpr bool wide_layouts_hold() {
    for (int i = 0; i < kWideCount; ++i) {
        const WideLayout& l = kWideLayouts[i];
        const int R = l.TT < ring_rows(l.NT, l.MB) ? l.TT : ring_rows(l.NT, l.MB);
        if (l.M != 1 << i || l.NT % 32 || l.NT > 1024 || l.MB < 1 || l.NT * l.MB > 2048 ||
            l.C < 1 || l.C > l.M || l.M % l.C || l.TT < 1 || l.TT % R || l.TR < 0 ||
            l.TR > 1 || (long long)l.TT * l.M > (l.NT * l.MB >= 1024 ? 16LL : 32LL) * l.NT ||
            wide_smem(l, 1, false) > smem_budget(l.MB) || l.KS < 0 ||
            (l.KS > 0 && wide_smem(l, l.KS, true) > smem_budget(l.MB)) ||
            wide_smem(l, l.KS + 1, true) <= smem_budget(l.MB))
            return false;
    }
    return true;
}
static_assert(wide_layouts_hold(), "kWideLayouts: a row does not fit its M, its tiles or its KS");

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// xp row r, branch p: x row r - (K - 1), the carried state below it (zeros
// for NULL), zeros past the end
__device__ __forceinline__ float2 xp_at(const float2* __restrict__ x,
                                        const float2* __restrict__ state, int r, int p, int M,
                                        int T, int K) {
    if (r >= K - 1)
        return r - (K - 1) < T ? __ldg(x + (size_t)(r - (K - 1)) * M + p) : make_float2(0.f, 0.f);
    return state ? __ldg(state + (size_t)r * M + p) : make_float2(0.f, 0.f);
}

// Copy xp row r, branches p and p + 1 into dst (one 16-byte cp.async where
// they exist, else zeros).
__device__ __forceinline__ void stage_two(float2* dst, const float2* __restrict__ x,
                                          const float2* __restrict__ state, int r, int p, int M,
                                          int T, int K) {
    if (r >= K - 1 && r - (K - 1) < T) {
        cp_async16(dst, x + (size_t)(r - (K - 1)) * M + p);
    } else if (r < K - 1 && state) {
        cp_async16(dst, state + (size_t)r * M + p);
    } else {
        dst[0] = make_float2(0.f, 0.f);
        dst[1] = make_float2(0.f, 0.f);
    }
}

// Copy xp row r, branch p into dst (cp.async where it exists, else a zero).
__device__ __forceinline__ void stage_one(float2* dst, const float2* __restrict__ x,
                                          const float2* __restrict__ state, int r, int p, int M,
                                          int T, int K) {
    if (r >= K - 1 && r - (K - 1) < T)
        cp_async8(dst, x + (size_t)(r - (K - 1)) * M + p);
    else if (r < K - 1 && state)
        cp_async8(dst, state + (size_t)r * M + p);
    else
        *dst = make_float2(0.f, 0.f);
}

__device__ __forceinline__ float2 cmulc(float2 a, float c, float s) {  // a (c + i s)
    return make_float2(a.x * c - a.y * s, a.x * s + a.y * c);
}

// X[k] = sum_n v[n] exp(-2 pi i n k / 16), in place, natural order: 4 x 4
// (n = 4 n1 + n2, k = k1 + 4 k2), the twiddles exp(-2 pi i n2 k1 / 16) constant
__device__ __forceinline__ void dft16(float2* v) {
    constexpr float C1 = 0.92387953251128674f, S1 = 0.38268343236508978f,
                    H = 0.70710678118654752f;
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) pycusdr::dft4<-1>(v[n2], v[4 + n2], v[8 + n2], v[12 + n2]);
    // v[4 k1 + n2] now holds the k1-th output of column n2
    v[5] = cmulc(v[5], C1, -S1);
    v[6] = cmulc(v[6], H, -H);
    v[7] = cmulc(v[7], S1, -C1);
    v[9] = cmulc(v[9], H, -H);
    v[10] = make_float2(v[10].y, -v[10].x);  // times -i
    v[11] = cmulc(v[11], -H, -H);
    v[13] = cmulc(v[13], S1, -C1);
    v[14] = cmulc(v[14], -H, -H);
    v[15] = cmulc(v[15], -C1, S1);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1)
        pycusdr::dft4<-1>(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
    float2 o[16];  // v[4 k1 + k2] = X[k1 + 4 k2]
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1)
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) o[k1 + 4 * k2] = v[4 * k1 + k2];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = o[i];
}

template <int R>
__device__ __forceinline__ void dft_r(float2* v) {
    if constexpr (R == 16)
        dft16(v);
    else if constexpr (R > 1)
        pycusdr::dft_reg<R, -1>(v);
}

template <int M, int S>
__device__ __forceinline__ float2 pass_twiddle(const float2* tws, int r, int k) {
    constexpr int R = pass_radix(M, S), NS = pass_ns(M, S), OFF = pass_tw_off(M, S);
    if constexpr (NS <= 16) {
        return tws[OFF + (r - 1) * NS + k];
    } else {
        return pycusdr::cmul(tws[OFF + (r - 1) * 16 + (k & 15)],
                             tws[OFF + (R - 1) * 16 + (r - 1) * (NS / 16) + (k >> 4)]);
    }
}

// Stage every pass's twiddles from tw (M entries exp(+2 pi i j / M), built in
// float64): exp(-2 pi i e / (Ns R)) is conj(tw[e M / (Ns R)]). The passes are
// unrolled at compile time, so every layout number is a constant.
template <int M, int NT, int S = 1>
__device__ __forceinline__ void stage_twiddles(float2* tws, const float2* __restrict__ tw) {
    if constexpr (S < npasses(M)) {
        constexpr int R = pass_radix(M, S), NS = pass_ns(M, S), STEP = M / (NS * R);
        float2* const dst = tws + pass_tw_off(M, S);
        if constexpr (NS <= 16) {
            for (int i = threadIdx.x; i < (R - 1) * NS; i += NT) {
                const int r = i / NS + 1, k = i - (r - 1) * NS;
                dst[i] = pycusdr::conjf2(tw[r * k * STEP]);
            }
        } else {
            for (int i = threadIdx.x; i < (R - 1) * 16; i += NT) {
                const int r = i / 16 + 1, kl = i - (r - 1) * 16;
                dst[i] = pycusdr::conjf2(tw[r * kl * STEP]);
            }
            for (int i = threadIdx.x; i < (R - 1) * (NS / 16); i += NT) {
                const int r = i / (NS / 16) + 1, kh = i - (r - 1) * (NS / 16);
                dst[(R - 1) * 16 + i] = pycusdr::conjf2(tw[r * 16 * kh * STEP]);
            }
        }
        stage_twiddles<M, NT, S + 1>(tws, tw);
    }
}

// One Stockham pass of radix R over the TT rows of the tile W; Ns = the
// product of the earlier passes' radices. The last pass (Ns R = M) writes
// channel-major, row t's y[m] at m TT + t. Where a stride is a multiple of
// 16, pad() of i + r stride is pad(i) + r (stride + stride / 16): one base
// address and constant offsets.
template <int M, int NT, int TT, int S>
__device__ __forceinline__ void wide_pass(float2* W, const float2* tws) {
    constexpr int R = pass_radix(M, S), NS = pass_ns(M, S);
    constexpr int NB = M / R, JOBS = TT * NB, JM = (JOBS + NT - 1) / NT;
    constexpr bool LAST = NS * R == M;
    constexpr int WS = LAST ? NS * TT : NS;  // the write stride
    float2 a[JM][R];
#pragma unroll
    for (int b = 0; b < JM; ++b) {
        const int u = threadIdx.x + b * NT;
        if (JOBS % NT == 0 || u < JOBS) {
            const int row = u / NB, j = u - row * NB;
            if constexpr (NB % 16 == 0) {
                const float2* src = W + pad(row * M + j);
#pragma unroll
                for (int r = 0; r < R; ++r) a[b][r] = src[r * (NB + NB / 16)];
            } else {
#pragma unroll
                for (int r = 0; r < R; ++r) a[b][r] = W[pad(row * M + j + r * NB)];
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < JM; ++b) {
        const int u = threadIdx.x + b * NT;
        if (JOBS % NT == 0 || u < JOBS) {
            const int row = u / NB, j = u - row * NB, k = j & (NS - 1);
            if constexpr (NS > 1) {
#pragma unroll
                for (int r = 1; r < R; ++r)
                    a[b][r] = pycusdr::cmul(a[b][r], pass_twiddle<M, S>(tws, r, k));
            }
            dft_r<R>(a[b]);
            const int i0 = LAST ? j * TT + row : row * M + (j - k) * R + k;
            if constexpr (WS % 16 == 0) {
                float2* dst = W + pad(i0);
#pragma unroll
                for (int r = 0; r < R; ++r) dst[r * (WS + WS / 16)] = a[b][r];
            } else {
#pragma unroll
                for (int r = 0; r < R; ++r) W[pad(i0 + r * WS)] = a[b][r];
            }
        }
    }
}

template <int M, int NT, int TT, int S = 0>
__device__ __forceinline__ void wide_passes(float2* W, const float2* tws) {
    if constexpr (S < npasses(M)) {
        wide_pass<M, NT, TT, S>(W, tws);
        if constexpr (S + 1 < npasses(M)) __syncthreads();
        wide_passes<M, NT, TT, S + 1>(W, tws);
    }
}

// acc[i] = sum_k tap(k) xp[i + K - 1 - k] (rows relative to the job's
// first), k in order: own(i) gives row K - 1 + i (i < R), older(q) row q < K - 1
template <int R, typename Own, typename Older, typename Tap>
__device__ __forceinline__ void fir_job(float2 (&acc)[R], Own own, Older older, Tap tap, int K) {
    float2 ring[R];  // row q in slot (q - (K - 1)) mod R
#pragma unroll
    for (int i = 0; i < R; ++i) {
        acc[i] = make_float2(0.f, 0.f);
        ring[i] = own(i);
    }
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += R) {
        float2 nw[R];
        float hk[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
            const int k = k0 + u;
            hk[u] = k < K ? tap(k) : 0.f;
            nw[u] = (k > 0 && k < K) ? older(K - 1 - k) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
            if (k0 + u >= K) break;
            if (k0 + u > 0) ring[(R - u) % R] = nw[u];  // row K - 1 - k into the oldest slot
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const float2 v = ring[(i - u + R) % R];
                acc[i].x = __fadd_rn(acc[i].x, __fmul_rn(hk[u], v.x));
                acc[i].y = __fadd_rn(acc[i].y, __fmul_rn(hk[u], v.y));
            }
        }
    }
}

// One launch: the carry, the twiddles, then the tiles (see the top of the file).
template <int M, int NT, int MB, int TT, int C, int TR, bool SPAN>
__global__ void __launch_bounds__(NT, MB)
channelize_wide(const float2* __restrict__ x, const float2* __restrict__ state,
                const float* __restrict__ h2, const float2* __restrict__ tw,
                float2* __restrict__ y, float2* __restrict__ carry, int T, int K, int vec16) {
    constexpr int R = TT < ring_rows(NT, MB) ? TT : ring_rows(NT, MB);  // rows of a FIR job
    constexpr int NC = M / C;                                           // chunks a tile
    constexpr int FJOBS = C * (TT / R);                                 // FIR jobs a chunk
    extern __shared__ float4 smem4[];
    constexpr int TWL = tw_len(M);
    float2* const tws = reinterpret_cast<float2*>(smem4);
    const float* const taps = reinterpret_cast<const float*>(tws + TWL);  // h2, span, TR
    float2* const W = tws + TWL + (SPAN && TR ? taps_len((long long)K * M) : 0);  // v, then y
    float2* const S0 = W + plen(TT * M);  // two chunk buffers: rows C apart, (TR = 0) taps
    const int slen = (int)chunk_len(TT, C, K, SPAN, TR);
    const int tapoff = (int)rows_len(TT, C, K, SPAN);  // a chunk's taps in its buffer

    // the carry: rows [T, T + K - 1) of xp
    const long long nc = (long long)(K - 1) * M;
    for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < nc;
         i += (long long)gridDim.x * NT) {
        const int jr = (int)(i / M), p = (int)(i - (long long)jr * M);
        carry[i] = xp_at(x, state, T + jr, p, M, T, K);
    }
    stage_twiddles<M, NT>(tws, tw);

    // job j of this CTA: chunk j mod NC of its (j div NC)-th tile
    const int ntiles = (T + TT - 1) / TT;
    const int njobs = ntiles > (int)blockIdx.x
                          ? ((ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * NC
                          : 0;
    // job j's branches [c C, c C + C) of xp rows [t0, t0 + TT + K - 1) ("span")
    // or of x rows [t0, t0 + TT) ("rows") into buffer j mod 2: one commit group
    auto stage = [&](int jj) {
        const int ct = blockIdx.x + jj / NC * gridDim.x, c = jj % NC;
        float2* const dst = S0 + (jj & 1) * slen;
        const int n = SPAN ? (TT + K - 1) * C : TT * C;
        const int r0 = SPAN ? ct * TT : ct * TT + K - 1;
        if (C % 2 == 0 && vec16) {
            for (int i = 2 * threadIdx.x; i < n; i += 2 * NT) {
                const int q = i / C;
                stage_two(dst + i, x, state, r0 + q, c * C + i - q * C, M, T, K);
            }
        } else {
            for (int i = threadIdx.x; i < n; i += NT) {
                const int q = i / C;
                stage_one(dst + i, x, state, r0 + q, c * C + i - q * C, M, T, K);
            }
        }
        if (SPAN && !TR) {  // h2[k, c C + p] at k C + p
            float* const t = reinterpret_cast<float*>(dst + tapoff);
            if (C % 4 == 0 && vec16) {
                for (int i = 4 * threadIdx.x; i < K * C; i += 4 * NT) {
                    const int k = i / C;
                    cp_async16(t + i, h2 + (size_t)k * M + c * C + i - k * C);
                }
            } else {
                for (int i = threadIdx.x; i < K * C; i += NT) {
                    const int k = i / C;
                    cp_async4(t + i, h2 + (size_t)k * M + c * C + i - k * C);
                }
            }
        }
        cp_async_commit();
    };
    if (SPAN && TR && njobs > 0) {  // the taps, with the first chunk's group
        float* const t = const_cast<float*>(taps);
        if (M % 4 == 0 && vec16) {
            for (int i = 4 * threadIdx.x; i < K * M; i += 4 * NT) cp_async16(t + i, h2 + i);
        } else {
            for (int i = threadIdx.x; i < K * M; i += NT) cp_async4(t + i, h2 + i);
        }
    }
    if (njobs > 0) stage(0);
    if (njobs > 1) stage(1);
    // the store of the tile in W (rows [tp, tp + TT)) channel-major, the part
    // at flat indices [q M + c C, q M + c C + C) for q < TT: channels whole, a
    // run of TT rows each; it precedes the next tile's FIR of chunk c, which
    // writes the same indices
    auto store = [&](int tp, int c) {
        for (int u = threadIdx.x; u < TT * C; u += NT) {
            const int q = u / C, i = q * M + c * C + (u - q * C), m = i / TT, t = i - m * TT;
            if (tp + t < T) y[(size_t)m * T + tp + t] = W[pad(i)];
        }
    };
#pragma unroll 1
    for (int j = 0; j < njobs; ++j) {
        const int ct = blockIdx.x + j / NC * gridDim.x, c = j % NC, t0 = ct * TT;
        const float2* const S = S0 + (j & 1) * slen;
        if (j >= NC) store(t0 - (int)gridDim.x * TT, c);  // the previous tile's, under the wait
        if (j + 1 < njobs)
            cp_async_wait<1>();  // job j's group; job j + 1's may still fly
        else
            cp_async_wait<0>();
        __syncthreads();  // the chunk landed (the first time: the twiddles too); W's part stored

        // the FIR: job u takes branch c C + p, rows [q0, q0 + R) of the tile
        const int pc = c * C;
#pragma unroll 1
        for (int u = threadIdx.x; u < FJOBS; u += NT) {
            const int p = u & (C - 1), q0 = u / C * R;
            float2 acc[R];
            if constexpr (SPAN) {
                const float* const tp =
                    TR ? taps + pc + p : reinterpret_cast<const float*>(S + tapoff) + p;
                constexpr int TS = TR ? M : C;  // the taps' row stride
                fir_job<R>(
                    acc, [&](int i) { return S[(q0 + K - 1 + i) * C + p]; },
                    [&](int q) { return S[(q0 + q) * C + p]; }, [&](int k) { return tp[k * TS]; },
                    K);
            } else {
                fir_job<R>(
                    acc, [&](int i) { return S[(q0 + i) * C + p]; },
                    [&](int q) {
                        return q0 + q >= K - 1 ? S[(q0 + q - (K - 1)) * C + p]
                                               : xp_at(x, state, t0 + q0 + q, pc + p, M, T, K);
                    },
                    [&](int k) { return __ldg(h2 + (size_t)k * M + pc + p); }, K);
            }
#pragma unroll
            for (int i = 0; i < R; ++i) W[pad((q0 + i) * M + pc + p)] = acc[i];
        }
        __syncthreads();  // the chunk is read: its buffer takes job j + 2
        if (j + 2 < njobs) stage(j + 2);
        if (c + 1 < NC) continue;

        // the M-point DFT of each row, ending channel-major (jobs j + 1 and j + 2 fly)
        wide_passes<M, NT, TT>(W, tws);
        __syncthreads();
        if (j + 1 == njobs) {  // the last tile: its store now
            for (int cc = 0; cc < NC; ++cc) store(t0, cc);
        }
    }
}

struct Args {
    const float2* x;
    const float2* state;
    const float* h2;
    const float2* tw;
    float2* y;
    float2* carry;
    int T, M, K;
};

// Launch the kernel at its layout: as many CTAs as the SMs hold, at most one
// a tile. A CTA's shared memory: smem bytes.
template <typename Kern>
int launch(Kern kern, int NT, int TT, int smem, const Args& a, cudaStream_t stream,
           unsigned& attr_set, int& occ_smem, int& occ) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && dev < 32 && !(attr_set & (1u << dev))) {
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (e == cudaSuccess) attr_set |= 1u << dev;
    }
    if (e != cudaSuccess) return (int)e;
    if (smem != occ_smem) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, NT, smem);
        if (e != cudaSuccess) return (int)e;
        if (occ < 1) return (int)cudaErrorInvalidConfiguration;
        occ_smem = smem;
    }
    const long long ntiles = ((long long)a.T + TT - 1) / TT;
    const long long grid = ntiles < (long long)occ * sms ? ntiles : (long long)occ * sms;
    const int vec16 = ((uintptr_t)a.x & 15) == 0 && ((uintptr_t)a.state & 15) == 0 &&
                      ((uintptr_t)a.h2 & 15) == 0;
    kern<<<(unsigned)grid, NT, smem, stream>>>(a.x, a.state, a.h2, a.tw, a.y, a.carry, a.T, a.K,
                                               vec16);
    return (int)cudaGetLastError();
}

template <int L, bool SPAN>
int run(const Args& a, cudaStream_t stream) {
    constexpr WideLayout l = kWideLayouts[L];
    static unsigned attr_set = 0;  // a bit a device
    static int occ_smem = -1, occ = 0;  // the last occupancy asked for
    return launch(channelize_wide<l.M, l.NT, l.MB, l.TT, l.C, l.TR, SPAN>, l.NT, l.TT,
                  (int)wide_smem(l, a.K, SPAN), a, stream, attr_set, occ_smem, occ);
}

// M's row of kWideLayouts; the span stage up to its KS taps, the rows stage above
template <int L = 0>
int dispatch(const Args& a, cudaStream_t stream) {
    if constexpr (L == kWideCount) {
        return (int)cudaErrorInvalidValue;
    } else {
        if (a.M != kWideLayouts[L].M) return dispatch<L + 1>(a, stream);
        if constexpr (kWideLayouts[L].KS > 0) {
            if (a.K <= kWideLayouts[L].KS) return run<L, true>(a, stream);
        }
        return run<L, false>(a, stream);
    }
}

}  // namespace

// x: (T M,) complex64; state: (K - 1, M) complex64 or NULL (zeros); h2: (K,
// M) f32; tw: (M, 2) f32; y: (M, T) complex64; carry: (K - 1, M) complex64.
// M a power of two <= kWideMaxM, K >= 1.
PYCUSDR_API int pycusdr_channelize_wide(const float2* x, const float2* state, const float* h2,
                                        const float2* tw, float2* y, float2* carry, int T, int M,
                                        int K, cudaStream_t stream) {
    if (!x || !h2 || !tw || !y || (K > 1 && !carry) || T <= 0 || K <= 0 || M <= 0 ||
        M > kWideMaxM || (M & (M - 1)) || (long long)T + K > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    return dispatch(Args{x, state, h2, tw, y, carry, T, M, K}, stream);
}
