// K9 channelize: the critically sampled M-channel analysis filterbank.
//
//   xp       = [state; x as (T, M) rows]            (T + K - 1, M) complex
//   v[t, p]  = sum_{k=0..K-1} h2[k, p] * xp[t + K - 1 - k, p]
//   y[m, t]  = sum_p v[t, p] * exp(-2 pi i p m / M)  (an M-point DFT per row)
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
// One CTA per tile of TT consecutive output rows across all M branches:
// the K taps sit in shared memory; each thread forms v[t, p] for a
// (t, p) with p fastest (the K reads of row t + K - 1 - k are coalesced
// 8-byte loads across p; the rows a tile shares with its neighbour come
// from L1/L2); rows of xp before the input come from `state`, so the
// concatenation never reaches HBM. The K-tap sum runs in JAX's order,
// k = 0..K-1, with __fmul_rn / __fadd_rn. The tile's rows then take a
// radix-2 Stockham FFT in shared memory (ping-pong buffers, log2 M stages
// of M/2 butterflies per row, natural order out). Rows are padded to M + 1
// entries so the transposed read of the store hits distinct banks. The
// store writes y[m, t0 .. t0 + TT) with consecutive threads on
// consecutive t: a warp writes 32 consecutive samples of one channel.
//
// Bound at the wideband shape (M = 64, K = 8, T = 2^16): the input read
// once and the output written once, 2 T M 8 = 67.1 MB, 0.0200 ms at 3.35
// TB/s; f32 work (4 K + 5 log2 M) T M = 260 MFLOP, 0.0039 ms at 67 TFLOP/s:
// bytes bound it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 1024;
constexpr int kMaxK = 32;

// rows per tile: a power of two, TT (M + 1) complex per buffer <= ~16 K
int tile_rows(int M) {
    int tt = 2048 / M;
    return tt < 1 ? 1 : (tt > 32 ? 32 : tt);
}

__global__ void __launch_bounds__(kThreads)
channelize(const float2* __restrict__ x, const float2* __restrict__ state,
           const float* __restrict__ h2, const float2* __restrict__ tw,
           float2* __restrict__ y, int T, int M, int K, int logM, int TT, int logTT) {
    extern __shared__ float smem[];
    const int n_taps = (K * M + 1) & ~1;  // keep the complex buffers 8-byte aligned
    float* taps = smem;
    const int RS = M + 1;                 // padded row stride (complex)
    float2* src = reinterpret_cast<float2*>(smem + n_taps);
    float2* dst = src + (size_t)TT * RS;

    const int t0 = blockIdx.x * TT;
    const int rows = min(TT, T - t0);
    for (int i = threadIdx.x; i < K * M; i += kThreads) taps[i] = h2[i];
    __syncthreads();

    // polyphase FIR, p fastest
    for (int i = threadIdx.x; i < TT * M; i += kThreads) {
        const int t = i >> logM, p = i & (M - 1);
        float re = 0.f, im = 0.f;
        if (t < rows) {
            for (int k = 0; k < K; ++k) {
                const long long r = (long long)t0 + t + (K - 1 - k);  // row of xp
                float2 v;
                if (r >= K - 1)
                    v = x[(size_t)(r - (K - 1)) * M + p];
                else
                    v = state ? state[(size_t)r * M + p] : make_float2(0.f, 0.f);
                const float h = taps[k * M + p];
                re = __fadd_rn(re, __fmul_rn(h, v.x));
                im = __fadd_rn(im, __fmul_rn(h, v.y));
            }
        }
        src[t * RS + p] = make_float2(re, im);
    }
    __syncthreads();

    // radix-2 Stockham across the branches of each row: stage Ns reads
    // a = s[j], b = s[j + M/2], twiddles b by exp(-2 pi i (j mod Ns) / (2 Ns))
    // and writes a + b, a - b at expand(j) = 2 (j - j mod Ns) + j mod Ns and
    // that + Ns
    const int half = M >> 1;
    for (int Ns = 1, lg = 0; Ns < M; Ns <<= 1, ++lg) {
        for (int i = threadIdx.x; i < TT * half; i += kThreads) {
            const int t = i >> (logM - 1), j = i & (half - 1);
            const float2* s = src + t * RS;
            float2* d = dst + t * RS;
            const int k = j & (Ns - 1);
            const float2 w = pycusdr::conjf2(tw[k << (logM - 1 - lg)]);
            const float2 a = s[j];
            const float2 b = pycusdr::cmul(s[j + half], w);
            const int o = ((j - k) << 1) + k;
            d[o] = pycusdr::cadd(a, b);
            d[o + Ns] = pycusdr::csub(a, b);
        }
        __syncthreads();
        float2* tmp = src;
        src = dst;
        dst = tmp;
    }

    // y[m, t0 + t], t fastest
    for (int i = threadIdx.x; i < TT * M; i += kThreads) {
        const int m = i >> logTT, t = i & (TT - 1);
        if (t < rows) y[(size_t)m * T + t0 + t] = src[t * RS + m];
    }
}

int ilog2(int v) {
    int l = 0;
    while ((1 << l) < v) ++l;
    return l;
}

}  // namespace

// x: (T M,) complex64; state: (K - 1, M) complex64 or NULL (zeros); h2: (K,
// M) f32; tw: (M, 2) f32; y: (M, T) complex64. M a power of two <= 1024,
// 1 <= K <= 32.
PYCUSDR_API int pycusdr_channelize(const float2* x, const float2* state, const float* h2,
                                   const float2* tw, float2* y, int T, int M, int K,
                                   cudaStream_t stream) {
    if (T <= 0 || M <= 0 || M > kMaxM || (M & (M - 1)) || K <= 0 || K > kMaxK)
        return (int)cudaErrorInvalidValue;
    const int TT = tile_rows(M);
    const size_t smem = sizeof(float) * ((K * M + 1) & ~1) + 2 * sizeof(float2) * TT * (M + 1);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            channelize, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int grid = (T + TT - 1) / TT;
    channelize<<<grid, kThreads, smem, stream>>>(x, state, h2, tw, y, T, M, K, ilog2(M), TT,
                                                 ilog2(TT));
    return (int)cudaGetLastError();
}
