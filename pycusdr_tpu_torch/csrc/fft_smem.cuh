// Register-radix Stockham transforms of the rows of a shared-memory tile,
// shared by K2 (mf_bank.cu) and K3 (timing_band.cu).
//
// A tile holds `rows` rows of length L = 2^logL (rows * L <= kFftElems).
// Element i of row r lives at buf[r * pitch + fft_pad(i)]: one float2 of
// padding every 16 keeps the strided exchanges of a pass off a single
// bank pair, and a pitch of 2 mod 16 float2 keeps the column-wise loads
// of a tile (one element of each row per lane) conflict-free.
//
// log2 L = 3 q + e: one radix-2^e pass (e = 1 or 2), then q radix-8
// passes. In a pass every thread loads its butterflies' R values into
// registers, the block synchronises, and each thread twiddles, runs the
// R-point DFT in registers and writes the results to their Stockham
// places in the same buffer, so a pass costs two barriers (not one per
// radix-2 stage) and the output ends in natural order. Twiddles come
// from `twL`, L entries exp(+2πi j / L) staged in shared memory from the
// float64-built table (conjugated for the forward sign). The four-step
// twiddles exp(±2πi m / N) (m < N) are the product of two staged tables
// of at most 512 entries each, indexed by the high and low bits of m;
// where N passes 2^18 (a table would pass 512 entries) they are read from
// the float64-built table in global memory instead, one rounding fewer.
// All of it lives in dynamic shared memory (FftSmem), kFftSmemBytes a
// block.
#pragma once

#include "common.cuh"

namespace pycusdr {

constexpr int kFftThreads = 256;
constexpr int kFftElems = 2048;  // complex elements of one tile
constexpr int kFftMaxRows = 32;
constexpr int kFftMaxL = 512;
constexpr int kFftEPT = kFftElems / kFftThreads;  // tile elements per thread
// float2s of a tile buffer: kFftElems padded, plus each row pitch's slack
constexpr int kFftBuf = kFftElems + kFftElems / 16 + 16 * kFftMaxRows;
constexpr int kFftSplitLog = 9;  // log2 of the entries of each four-step twiddle table
constexpr int kFftSplitMax = 1 << kFftSplitLog;
constexpr int kFftSmemBytes = 8 * (kFftBuf + kFftMaxL + 2 * kFftSplitMax);

// The carve-up of a block's dynamic shared memory.
struct FftSmem {
    float2* buf;  // the tile
    float2* twL;  // exp(+2πi j / L), the row transforms' twiddles
    float2* lo;   // exp(+2πi j / N), j < 2^split
    float2* hi;   // exp(+2πi j 2^split / N)
    int split;
    const float2* gtw;  // N > 2^18: the N-entry table in global memory (lo, hi unused)
};

// tw: the N-entry table exp(+2πi j / N) in global memory
__device__ __forceinline__ FftSmem fft_smem(float2* base, int logN, const float2* tw) {
    return {base, base + kFftBuf, base + kFftBuf + kFftMaxL,
            base + kFftBuf + kFftMaxL + kFftSplitMax, (logN + 1) / 2,
            logN > 2 * kFftSplitLog ? tw : nullptr};
}

__device__ __forceinline__ int fft_pad(int i) { return i + (i >> 4); }

// Row pitch (float2) of a tile of rows of length L.
__host__ __device__ __forceinline__ int fft_pitch(int L) {
    const int p = L + L / 16;
    return p + ((2 - p) & 15);  // the smallest pitch >= p that is 2 mod 16
}

// x * (s i): a quarter turn in the direction of the sign
template <int S>
__device__ __forceinline__ float2 mul_si(float2 a) {
    return S > 0 ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

template <int S>
__device__ __forceinline__ void dft2(float2* v) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
}

template <int S>
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2, float2& x3) {
    const float2 t0 = cadd(x0, x2), t1 = csub(x0, x2);
    const float2 t2 = cadd(x1, x3), t3 = mul_si<S>(csub(x1, x3));
    x0 = cadd(t0, t2);
    x2 = csub(t0, t2);
    x1 = cadd(t1, t3);
    x3 = csub(t1, t3);
}

// X[k] = sum_n v[n] exp(S 2πi nk / R), in place, natural order
template <int R, int S>
__device__ __forceinline__ void dft_reg(float2* v) {
    if constexpr (R == 2) {
        dft2<S>(v);
    } else if constexpr (R == 4) {
        dft4<S>(v[0], v[1], v[2], v[3]);
    } else {
        static_assert(R == 8, "radix 2, 4 or 8");
        float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
        float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
        dft4<S>(e0, e1, e2, e3);
        dft4<S>(o0, o1, o2, o3);
        const float h = 0.70710678118654752f;
        o1 = make_float2(h * (o1.x - S * o1.y), h * (o1.y + S * o1.x));   // * (1 + s i)/√2
        o2 = mul_si<S>(o2);                                                 // * s i
        o3 = make_float2(-h * (o3.x + S * o3.y), h * (S * o3.x - o3.y));  // * (-1 + s i)/√2
        v[0] = cadd(e0, o0);
        v[4] = csub(e0, o0);
        v[1] = cadd(e1, o1);
        v[5] = csub(e1, o1);
        v[2] = cadd(e2, o2);
        v[6] = csub(e2, o2);
        v[3] = cadd(e3, o3);
        v[7] = csub(e3, o3);
    }
}

// One Stockham pass of radix R over every row; Ns = the product of the
// earlier passes' radices.
template <int R, int S>
__device__ __forceinline__ void fft_pass(float2* buf, int rows, int logL, int pitch, int Ns,
                                         const float2* twL) {
    constexpr int BPT = kFftElems / (R * kFftThreads);  // butterflies per thread
    const int L = 1 << logL, nbf = L / R;
    const int logNbf = logL - (R == 2 ? 1 : R == 4 ? 2 : 3);
    const int total = rows << logNbf;
    float2 v[BPT][R];
#pragma unroll
    for (int t = 0; t < BPT; ++t) {
        const int u = threadIdx.x + t * kFftThreads;
        if (u < total) {
            const int row = u >> logNbf, j = u & (nbf - 1);
            const float2* src = buf + row * pitch;
#pragma unroll
            for (int r = 0; r < R; ++r) v[t][r] = src[fft_pad(j + r * nbf)];
        }
    }
    __syncthreads();
    const int tstep = L / (Ns * R);  // twL index of exp(2πi / (Ns R))
#pragma unroll
    for (int t = 0; t < BPT; ++t) {
        const int u = threadIdx.x + t * kFftThreads;
        if (u < total) {
            const int row = u >> logNbf, j = u & (nbf - 1);
            const int k = j & (Ns - 1);
            if (Ns > 1) {
#pragma unroll
                for (int r = 1; r < R; ++r) {
                    const float2 w = twL[r * k * tstep];
                    v[t][r] = cmul(v[t][r], S > 0 ? w : conjf2(w));
                }
            }
            dft_reg<R, S>(v[t]);
            float2* dst = buf + row * pitch;
            const int base = (j - k) * R + k;
#pragma unroll
            for (int r = 0; r < R; ++r) dst[fft_pad(base + r * Ns)] = v[t][r];
        }
    }
    __syncthreads();
}

// Stage twL[j] = tw[j * (N / L)] (tw: N entries exp(+2πi j / N)) and the
// two four-step tables; the caller synchronises before their first use.
__device__ __forceinline__ void fft_stage_twiddles(const FftSmem& sm,
                                                   const float2* __restrict__ tw, int logL,
                                                   int logN) {
    for (int j = threadIdx.x; j < (1 << logL); j += kFftThreads) sm.twL[j] = tw[j << (logN - logL)];
    if (sm.gtw) return;
    for (int j = threadIdx.x; j < (1 << sm.split); j += kFftThreads) sm.lo[j] = tw[j];
    for (int j = threadIdx.x; j < (1 << (logN - sm.split)); j += kFftThreads)
        sm.hi[j] = tw[j << sm.split];
}

// exp(S 2πi m / N), 0 <= m < N, from the two staged tables (one rounding
// more than the float64-built table itself), or (N > 2^18) from that table
template <int S>
__device__ __forceinline__ float2 fft_twiddle(const FftSmem& sm, int m) {
    const float2 w = sm.gtw ? __ldg(sm.gtw + m)
                            : cmul(sm.hi[m >> sm.split], sm.lo[m & ((1 << sm.split) - 1)]);
    return S > 0 ? w : conjf2(w);
}

// In-place transforms, sign S, of `rows` rows of length 2^logL (logL >= 1)
// in natural order; ends with a barrier.
template <int S>
__device__ __forceinline__ void fft_rows(float2* buf, int rows, int logL, int pitch,
                                         const float2* twL) {
    int Ns = 1;
    const int e = logL % 3;
    if (e == 1) {
        fft_pass<2, S>(buf, rows, logL, pitch, Ns, twL);
        Ns = 2;
    } else if (e == 2) {
        fft_pass<4, S>(buf, rows, logL, pitch, Ns, twL);
        Ns = 4;
    }
    for (; Ns < (1 << logL); Ns *= 8) fft_pass<8, S>(buf, rows, logL, pitch, Ns, twL);
}

// Let `kernel` take kFftSmemBytes of dynamic shared memory (above the 48 KB
// a launch gets by default); once per process, kernel and device (`done`:
// a bit per device ordinal).
template <typename K>
inline cudaError_t fft_allow_smem(K kernel, unsigned long long& done) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || dev >= 64) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
    if (done >> dev & 1ull) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFftSmemBytes);
    if (e == cudaSuccess) done |= 1ull << dev;
    return e;
}

}  // namespace pycusdr
