// K9 channelize: the critically sampled M-channel analysis filterbank.
//
//   xp       = [state; x as (T, M) rows]            (T + K - 1, M) complex
//   v[t, p]  = sum_{k=0..K-1} h2[k, p] * xp[t + K - 1 - k, p]
//   y[m, t]  = sum_p v[t, p] * exp(-2 pi i p m / M)  (an M-point DFT per row)
//   carry    = xp[T:]                                 (K - 1, M), the next call's state
//
// x: (T M,) complex64 wideband samples, state: (K - 1, M) complex64 carry
// (NULL: zeros), h2: (K, M) f32 polyphase taps (branch p uses h[k M + p]),
// tw: (M, 2) f32 table of exp(+2 pi i j / M) built in float64, y: (M, T)
// complex64, channel m centred at m fs / M, channel-major: the (B = M,
// Nfft = T) batch the block graph takes.
//
// Replaces pycusdr_tpu/parallel/channelizer.py:Channelizer._apply (:43-64),
// which concatenates the carried state to the input in HBM, accumulates
// the K shifted taps over the whole (2, T, M) commutator matrix and runs
// the split-complex four-step matmul FFT (ops/cfft.py:fft_ri) across the
// branches, then transposes to (M, 2, T).
//
// Bound at the wideband shape (M = 64, K = 8, T = 2^16): the input read
// once and the output written once, 2 T M 8 = 67.1 MB, 0.0200 ms at 3.35
// TB/s; f32 work (4 K + 5 log2 M) T M = 260 MFLOP, 0.0039 ms at 67 TFLOP/s:
// bytes bound it. The design streams: every byte of x crosses HBM once,
// every byte of y once, and nothing else does.
//
// Fused form (M <= 1024, K <= 32; every number below comes from M's row of
// kLayouts, and K picks the form). A tile is TT consecutive output
// rows across all M branches (TT = 256 P / G, below: 64 at M = 64, 256 at
// M = 4, 8 at M = 1024); a persistent grid (as many CTAs of 256 threads as
// the SMs hold) walks the tiles in a grid-stride loop.
// - "span" form: the TT + K - 1 rows [t0 - K + 1, t0 + TT) of x that a
//   tile needs, one contiguous run of x (rows before the input come from
//   `state`, zeros for NULL), are copied into shared memory by cp.async
//   (16 bytes a copy where x, state and the row stride MS allow, else 8),
//   two tiles ahead in two buffers: a buffer is refilled as soon as the
//   FIR has read it, so the copies run under the DFT and the store of this
//   tile and the FIR of the next. x is read from HBM once; the K - 1 halo
//   rows a tile shares with the tile before come from L2. "direct" form,
//   where two spans do not fit in shared memory (M = 1024 with K >= 2, M =
//   512 with K >= 4, M = 256 with K >= 26): the FIR reads x and state
//   through L1/L2 with __ldg. It still writes y once and skips v's round
//   trip and the transpose, so it beats the wide form at those shapes
//   (chip_smoke.py times both).
// - The FIR, branch-major: a thread takes R consecutive rows of one branch
//   (16 rows at M = 64; of BR branches above M = 256), consecutive threads
//   on consecutive branches. It keeps a window of R input rows in
//   registers and slides it one row a tap (the loop over k unrolled to
//   K <= 32, so the slide is a renaming), so it loads R + K - 1 rows for R
//   outputs; tap k is one shared-memory load for all R. Every output adds
//   its K taps in JAX's order, k = 0..K-1, with __fmul_rn / __fadd_rn. v
//   goes to a shared-memory tile (rows MSV complex apart).
// - The M-point DFT in registers, as M = V G (p = p1 + G p2, m = m2 + V m1),
//   a row in G lanes (G = 1 up to M = 4, then 2, 4, 4, 8, 8, 16, 16, 32 up
//   to 1024) of V = M / G values, P rows a lane (P = 2 at M = 64): lane p1
//   reads v[p1 + G p2], p2 < V, and takes a V-point DFT over p2 (radix-2,
//   unrolled, natural order in and out); multiplies value m2 by
//   exp(-2 pi i p1 m2 / M); a G x G transpose of each block of G values
//   across the row's G lanes by __shfl_xor_sync (log2 G butterfly steps,
//   no shared memory, no barrier); then a G-point DFT over p1: lane j holds
//   y[c G + j + V m1] in value c G + m1. At M = 64: 8 x 8, eight lanes of
//   eight values a row. Twiddles come from the float64-built table, staged
//   once a CTA into shared memory (trivial ones are skipped, -i swaps).
// - The store: the tile's rows go channel-major into the same tile of
//   shared memory (rows TTP complex apart), then out as 16-byte stores (8
//   where T is odd), consecutive threads on consecutive t of one channel:
//   at M = 64 a warp writes a 512-byte run of one channel.
// - The carry: the CTA of the last tile, whose span holds rows [T, T + K -
//   1) of xp (old state rows among them when T < K - 1), writes it. One
//   launch is the whole call.
// MS, MSV and TTP are the least pads with the fewest bank conflicts for the
// lanes' 8-byte accesses (tests/test_torch_channelizer_plan.py models them).
//
// The wide form (M > 1024 or K > 32, up to M = 16384) is one launch of its
// own kernel, channelizer_wide.cu. Above that M the split form runs
// pycusdr_channelize_fir: one thread per v[t, p], p fastest, the same K-tap
// sum in the same order, the taps read through L1 (__ldg: a warp reads 32
// consecutive taps of one k), so K and M are unbounded. It writes v (T, M);
// the M-point DFT across the branches is then a plain transform with nothing
// fused into it, which the wrapper leaves to cuFFT (torch.fft.fft over the
// rows, then the transpose to channel-major), and the wrapper copies the
// carry.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 1024;
constexpr int kMaxK = 32;
constexpr int kSmemMax = 232448;  // the dynamic shared memory a CTA may take (227 KB)

// the bit reversal of i < N (N a power of two), folded at compile time
// inside an unrolled loop
__host__ __device__ constexpr int rev(int i, int N) {
    int r = 0;
    for (int n = N; n > 1; n >>= 1, i >>= 1) r = (r << 1) | (i & 1);
    return r;
}

__host__ __device__ constexpr int log2c(int n) { return n <= 1 ? 0 : 1 + log2c(n / 2); }

// In place, natural order in and out: a[k] <- sum_n a[n] exp(-2 pi i n k / N),
// radix-2 decimation in time; exp(-2 pi i j / N) = conj(tw[j M / N]) from the
// M-entry table in shared memory (all lanes read one address: a broadcast).
template <int N, int M>
__device__ __forceinline__ void dft(float2* a, const float2* __restrict__ tw) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int r = rev(i, N);
        if (i < r) {
            const float2 s = a[i];
            a[i] = a[r];
            a[r] = s;
        }
    }
#pragma unroll
    for (int e = 1; e <= log2c(N); ++e) {  // linear counters, so every loop unrolls
        const int len = 1 << e, half = len >> 1;
#pragma unroll
        for (int j = 0; j < half; ++j) {
            const float2 w = (j == 0 || 4 * j == len) ? make_float2(1.f, 0.f)
                                                      : pycusdr::conjf2(tw[j * (M / len)]);
#pragma unroll
            for (int i = 0; i < N; i += len) {
                float2 b = a[i + j + half];
                if (4 * j == len)
                    b = make_float2(b.y, -b.x);  // times -i
                else if (j != 0)
                    b = pycusdr::cmul(b, w);
                const float2 u = a[i + j];
                a[i + j] = pycusdr::cadd(u, b);
                a[i + j + half] = pycusdr::csub(u, b);
            }
        }
    }
}

// Transpose each G x G block of values (a[c G + i], i < G) across the G
// lanes of a row: afterwards lane l holds, in a[c G + i], what lane i held
// in a[c G + l]. Step b swaps, between lanes l and l ^ b, the values whose
// index bit b differs from the lane's bit b: log2 G steps of V / 2 swaps.
template <int G, int V>
__device__ __forceinline__ void transpose(float2 (&a)[V], int l) {
#pragma unroll
    for (int e = log2c(G) - 1; e >= 0; --e) {
        const int b = 1 << e;
        const bool upper = (l & b) != 0;
#pragma unroll
        for (int c = 0; c < V; c += G) {
#pragma unroll
            for (int i = 0; i < G; ++i) {
                if (i & b) continue;
                const float2 send = upper ? a[c + i] : a[c + (i | b)];
                float2 got;
                got.x = __shfl_xor_sync(0xffffffffu, send.x, b);
                got.y = __shfl_xor_sync(0xffffffffu, send.y, b);
                if (upper)
                    a[c + i] = got;
                else
                    a[c + (i | b)] = got;
            }
        }
    }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The fused form's layout at each M, row i for M = 2^i (parallel/channelizer.py
// :k9_plan reads these rows): a row of M branches in G lanes of V values, P
// rows a lane; the strides in complex of the staged rows (MS), of v's tile
// (MSV) and of the output tile (TTP); the span form up to KS taps a branch
// (two spans fit in a CTA's shared memory), the direct form above.
struct Layout {
    int M, G, V, P, MS, MSV, TTP, KS;
};
constexpr Layout kLayouts[] = {
    // M, G, V, P, MS, MSV, TTP, KS
    {1, 1, 1, 1, 1, 1, 256, 32},
    {2, 1, 2, 1, 3, 3, 256, 32},
    {4, 1, 4, 1, 5, 5, 256, 32},
    {8, 2, 4, 1, 10, 10, 136, 32},
    {16, 4, 4, 1, 16, 20, 68, 32},
    {32, 4, 8, 1, 32, 36, 68, 32},
    {64, 8, 8, 2, 64, 72, 66, 32},
    {128, 8, 16, 1, 128, 136, 34, 32},
    {256, 16, 16, 1, 256, 256, 18, 25},
    {512, 16, 32, 1, 512, 512, 18, 3},
    {1024, 32, 32, 1, 1024, 1024, 10, 1},
};
constexpr int kLayoutCount = sizeof(kLayouts) / sizeof(kLayouts[0]);

// shared memory layout (float2 units): the twiddle table (M, rounded up to
// 16 bytes), the taps (K M floats, rounded up to 16 bytes), the two spans
// (span form), then the tile of v and of the output
__host__ __device__ constexpr int tw_len(int M) { return (M + 1) & ~1; }
__host__ __device__ constexpr int taps_len(int K, int M) { return ((K * M + 3) & ~3) / 2; }
__host__ __device__ constexpr int span_len(int TT, int K, int MS) {
    return ((TT + K - 1) * MS + 1) & ~1;
}
__host__ __device__ constexpr int tile_len(int TT, int M, int MSV, int TTP) {
    return ((TT * MSV > M * TTP ? TT * MSV : M * TTP) + 1) & ~1;
}
constexpr int tile_rows(const Layout& l) { return kThreads / l.G * l.P; }
constexpr int smem_bytes(const Layout& l, int K, bool staged) {
    return 8 * (tw_len(l.M) + taps_len(K, l.M) +
                (staged ? 2 * span_len(tile_rows(l), K, l.MS) : 0) +
                tile_len(tile_rows(l), l.M, l.MSV, l.TTP));
}

// Every row is a split of its M with room for its tile, and KS is the most
// taps whose two spans fit.
constexpr bool layouts_hold() {
    for (int i = 0; i < kLayoutCount; ++i) {
        const Layout& l = kLayouts[i];
        if (l.M != 1 << i || l.G * l.V != l.M || l.MS < l.M || l.MSV < l.M ||
            l.TTP < tile_rows(l) || (l.TTP & 1) || l.KS < 1 || l.KS > kMaxK ||
            smem_bytes(l, kMaxK, false) > kSmemMax || smem_bytes(l, l.KS, true) > kSmemMax ||
            (l.KS < kMaxK && smem_bytes(l, l.KS + 1, true) <= kSmemMax))
            return false;
    }
    return kLayouts[kLayoutCount - 1].M == kMaxM;
}
static_assert(layouts_hold(), "kLayouts: a row does not fit its M or its KS");

// Copy the span of the tile at xp row r0 into dst: rows [r0, r0 + TT + K - 1)
// of xp that exist, MS complex apart, in granules of W complex (16 or 8 bytes).
template <int M, int MS, int W>
__device__ __forceinline__ void stage_rows(float2* dst, const float2* __restrict__ x,
                                           const float2* __restrict__ state, int r0, int TT,
                                           int T, int K) {
    constexpr int gpr = M / W;  // granules a row
    const int nrows = min(TT + K - 1, T + K - 1 - r0);
    for (int i = threadIdx.x; i < nrows * gpr; i += kThreads) {
        const int row = i / gpr, g = (i - row * gpr) * W;
        const int r = r0 + row;
        float2* d = dst + row * MS + g;
        const float2* s = r >= K - 1 ? x + (size_t)(r - (K - 1)) * M + g
                                     : (state ? state + (size_t)r * M + g : nullptr);
        if (s == nullptr) {
            d[0] = make_float2(0.f, 0.f);
            if (W == 2) d[1] = make_float2(0.f, 0.f);
        } else if (W == 2) {
            cp_async16(d, s);
        } else {
            cp_async8(d, s);
        }
    }
}

template <int M, int MS>
__device__ __forceinline__ void stage(float2* dst, const float2* __restrict__ x,
                                      const float2* __restrict__ state, int r0, int TT, int T,
                                      int K, bool vec16) {
    if (M > 1 && vec16)
        stage_rows<M, MS, (M > 1 ? 2 : 1)>(dst, x, state, r0, TT, T, K);
    else
        stage_rows<M, MS, 1>(dst, x, state, r0, TT, T, K);
}

template <int G, int V, int P, int MS, int MSV, int TTP, bool STAGED>
__global__ void __launch_bounds__(kThreads, (V * P >= 32 ? 1 : 2))
channelize(const float2* __restrict__ x, const float2* __restrict__ state,
           const float* __restrict__ h2, const float2* __restrict__ tw,
           float2* __restrict__ y, float2* __restrict__ carry, int T, int K, int vec16) {
    constexpr int M = G * V;
    constexpr int RP = kThreads / G;                      // rows of a DFT pass
    constexpr int TT = RP * P;                            // rows a tile
    constexpr int FT = M < kThreads ? kThreads / M : 1;   // FIR threads a branch
    constexpr int BR = M > kThreads ? M / kThreads : 1;   // branches a FIR thread
    constexpr int R = TT / FT;                            // rows a FIR thread
    extern __shared__ float4 smem4[];
    float2* tw_s = reinterpret_cast<float2*>(smem4);
    float* taps = reinterpret_cast<float*>(tw_s + tw_len(M));
    float2* span0 = tw_s + tw_len(M) + taps_len(K, M);
    const int spansz = STAGED ? span_len(TT, K, MS) : 0;
    float2* vt = span0 + 2 * spansz;  // v, then the output tile

    const int ntiles = (T + TT - 1) / TT;
    for (int i = threadIdx.x; i < M; i += kThreads) tw_s[i] = tw[i];
    for (int i = threadIdx.x; i < K * M; i += kThreads) taps[i] = h2[i];

    const int fp = M < kThreads ? threadIdx.x % M : threadIdx.x;  // the FIR's branch (b = 0)
    const int fr = M < kThreads ? threadIdx.x / M * R : 0;        // the FIR's first row
    const int j = threadIdx.x & (G - 1);                          // the DFT lane within its row
    const int rw = threadIdx.x / G;                               // the DFT row of pass 0

    int tile = blockIdx.x;
    if (STAGED) {  // the first two tiles, one commit group each
        for (int t = tile, b = 0; b < 2 && t < ntiles; ++b, t += gridDim.x) {
            stage<M, MS>(span0 + b * spansz, x, state, t * TT, TT, T, K, vec16);
            cp_async_commit();
        }
    }
    for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
        float2* const span = span0 + (it & 1) * spansz;
        const int t0 = tile * TT;
        const int rows = min(TT, T - t0);
        if (STAGED) {
            if (tile + (int)gridDim.x < ntiles)
                cp_async_wait<1>();  // this tile's group; the next tile's may still fly
            else
                cp_async_wait<0>();
        }
        __syncthreads();  // the span landed (the first time: the table and the taps too)

        // row q of the tile's xp rows [t0, t0 + TT + K - 1), branch p
        auto load = [&](int q, int p) -> float2 {
            if (STAGED) return span[q * MS + p];
            const int r = t0 + q;
            if (r >= T + K - 1) return make_float2(0.f, 0.f);  // feeds only rows >= T
            if (r >= K - 1) return __ldg(x + (size_t)(r - (K - 1)) * M + p);
            return state ? __ldg(state + (size_t)r * M + p) : make_float2(0.f, 0.f);
        };

        // the FIR: v[fr + i, p] = sum_k h2[k, p] xp[t0 + fr + i + K - 1 - k, p];
        // win[i] holds xp row fr + i + K - 1 - k at step k
        if (fr < rows) {
#pragma unroll 1
            for (int b = 0; b < BR; ++b) {
                const int p = fp + b * kThreads;
                float2 acc[R], win[R];
#pragma unroll
                for (int i = 0; i < R; ++i) {
                    acc[i] = make_float2(0.f, 0.f);
                    win[i] = load(fr + i + K - 1, p);
                }
#pragma unroll
                for (int k = 0; k < kMaxK; ++k) {
                    if (k >= K) break;
                    const float h = taps[k * M + p];
#pragma unroll
                    for (int i = 0; i < R; ++i) {
                        acc[i].x = __fadd_rn(acc[i].x, __fmul_rn(h, win[i].x));
                        acc[i].y = __fadd_rn(acc[i].y, __fmul_rn(h, win[i].y));
                    }
                    if (k + 1 < K) {
#pragma unroll
                        for (int i = R - 1; i > 0; --i) win[i] = win[i - 1];
                        win[0] = load(fr + K - 2 - k, p);
                    }
                }
#pragma unroll
                for (int i = 0; i < R; ++i) vt[(fr + i) * MSV + p] = acc[i];
            }
        }
        if (tile == ntiles - 1) {  // the carry: rows [T, T + K - 1) of xp
            for (int i = threadIdx.x; i < (K - 1) * M; i += kThreads) {
                const int jr = i / M, p = i - jr * M;
                carry[i] = load(T + jr - t0, p);
            }
        }
        __syncthreads();  // v is whole; the span is read
        const int after = tile + 2 * (int)gridDim.x;
        if (STAGED && after < ntiles) {  // refill the span's buffer two tiles on
            stage<M, MS>(span, x, state, after * TT, TT, T, K, vec16);
            cp_async_commit();
        }

        // the DFT across the branches, in registers: pass s takes row s RP + rw
        float2 a[P][V];
#pragma unroll
        for (int s = 0; s < P; ++s) {
#pragma unroll
            for (int v = 0; v < V; ++v) a[s][v] = vt[(s * RP + rw) * MSV + j + G * v];
            dft<V, M>(a[s], tw_s);
            if (G > 1) {
#pragma unroll
                for (int m2 = 1; m2 < V; ++m2)
                    a[s][m2] = pycusdr::cmul(a[s][m2], pycusdr::conjf2(tw_s[j * m2]));
                transpose<G, V>(a[s], j);
#pragma unroll
                for (int c = 0; c < V; c += G) dft<G, M>(a[s] + c, tw_s);
            }
        }
        __syncthreads();  // v is read: the tile takes the output

#pragma unroll
        for (int s = 0; s < P; ++s)
#pragma unroll
            for (int c = 0; c < V; c += G)
#pragma unroll
                for (int m1 = 0; m1 < G; ++m1)
                    vt[(c + j + V * m1) * TTP + s * RP + rw] = a[s][c + m1];
        __syncthreads();

        // y[m, t0 + t], two t a thread, consecutive threads on consecutive t
        constexpr int half = TT / 2;
        const bool y16 = (T & 1) == 0;
        for (int i = threadIdx.x; i < M * half; i += kThreads) {
            const int m = i / half, t = 2 * (i - m * half);
            if (t >= rows) continue;
            const float4 v = *reinterpret_cast<const float4*>(vt + m * TTP + t);
            float2* d = y + (size_t)m * T + t0 + t;
            if (y16 && t + 1 < rows) {
                *reinterpret_cast<float4*>(d) = v;
            } else {
                d[0] = make_float2(v.x, v.y);
                if (t + 1 < rows) d[1] = make_float2(v.z, v.w);
            }
        }
        // the next tile's first barrier keeps its FIR from the tile until
        // every thread has stored it
    }
}

__global__ void __launch_bounds__(kThreads)
channelize_fir(const float2* __restrict__ x, const float2* __restrict__ state,
               const float* __restrict__ h2, float2* __restrict__ v, int T, int M, int K) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= (long long)T * M) return;
    const int t = (int)(i / M), p = (int)(i - (long long)t * M);
    float re = 0.f, im = 0.f;
    for (int k = 0; k < K; ++k) {
        const long long r = (long long)t + (K - 1 - k);  // row of xp
        float2 xv;
        if (r >= K - 1)
            xv = x[(size_t)(r - (K - 1)) * M + p];
        else
            xv = state ? state[(size_t)r * M + p] : make_float2(0.f, 0.f);
        const float h = __ldg(h2 + (size_t)k * M + p);
        re = __fadd_rn(re, __fmul_rn(h, xv.x));
        im = __fadd_rn(im, __fmul_rn(h, xv.y));
    }
    v[i] = make_float2(re, im);
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

// Launch the fused kernel at kLayouts[L]: a grid of as many CTAs as the SMs
// hold, at most one a tile.
template <int L, bool STAGED>
int run(const Args& a, cudaStream_t stream) {
    constexpr Layout l = kLayouts[L];
    constexpr int TT = tile_rows(l);
    const auto kern = channelize<l.G, l.V, l.P, l.MS, l.MSV, l.TTP, STAGED>;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    static unsigned attr_set = 0;  // a bit a device
    if (e == cudaSuccess && dev < 32 && !(attr_set & (1u << dev))) {
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (e == cudaSuccess) attr_set |= 1u << dev;
    }
    if (e != cudaSuccess) return (int)e;
    const int smem = smem_bytes(l, a.K, STAGED);
    static int occ_smem = -1, occ = 0;  // the last occupancy asked for
    if (smem != occ_smem) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, smem);
        if (e != cudaSuccess) return (int)e;
        occ_smem = smem;
    }
    const long long ntiles = ((long long)a.T + TT - 1) / TT;
    const long long grid = ntiles < (long long)occ * sms ? ntiles : (long long)occ * sms;
    const bool vec16 = l.M > 1 && !(l.MS & 1) && ((uintptr_t)a.x & 15) == 0 &&
                       ((uintptr_t)a.state & 15) == 0;
    kern<<<(unsigned)(grid > 0 ? grid : 1), kThreads, smem, stream>>>(
        a.x, a.state, a.h2, a.tw, a.y, a.carry, a.T, a.K, vec16);
    return (int)cudaGetLastError();
}

// M's row of kLayouts; the span form up to its KS taps, the direct form above
template <int L = 0>
int dispatch(const Args& a, cudaStream_t stream) {
    if constexpr (L == kLayoutCount) {
        return (int)cudaErrorInvalidValue;
    } else {
        if (a.M != kLayouts[L].M) return dispatch<L + 1>(a, stream);
        return a.K <= kLayouts[L].KS ? run<L, true>(a, stream) : run<L, false>(a, stream);
    }
}

}  // namespace

// x: (T M,) complex64; state: (K - 1, M) complex64 or NULL (zeros); h2: (K,
// M) f32; tw: (M, 2) f32; y: (M, T) complex64; carry: (K - 1, M) complex64.
// M a power of two <= 1024, 1 <= K <= 32.
PYCUSDR_API int pycusdr_channelize(const float2* x, const float2* state, const float* h2,
                                   const float2* tw, float2* y, float2* carry, int T, int M,
                                   int K, cudaStream_t stream) {
    if (!x || !h2 || !tw || !y || (K > 1 && !carry) || T <= 0 || K <= 0 || K > kMaxK)
        return (int)cudaErrorInvalidValue;
    return dispatch(Args{x, state, h2, tw, y, carry, T, M, K}, stream);
}

// The split form's FIR: v (T, M) complex64 (see channelize_fir), any power-of-two
// M and any K >= 1; the wrapper runs the DFT across the branches.
PYCUSDR_API int pycusdr_channelize_fir(const float2* x, const float2* state, const float* h2,
                                       float2* v, int T, int M, int K, cudaStream_t stream) {
    if (T <= 0 || M <= 0 || (M & (M - 1)) || K <= 0) return (int)cudaErrorInvalidValue;
    const long long n = (long long)T * M;
    if ((n + kThreads - 1) / kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    channelize_fir<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        x, state, h2, v, T, M, K);
    return (int)cudaGetLastError();
}
