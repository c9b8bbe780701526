// K6 threshold: two-pass interference spike clipping of one block.
//
//   a = |x|, thr1 = scale * mean(a), hit1 = a > thr1, a1 = hit1 ? thr1 : a
//   thr2 = scale * mean(a1), hit2 = a1 > thr2
//   y = (x * g1) * g2, g1 = hit1 ? thr1 / a : 1, g2 = hit2 ? thr2 / a1 : 1
//
// Replaces pycusdr_tpu/ops/demod_kernels.py:threshold_input (:27-46). The
// JAX op is two full-block means and an elementwise rescale that XLA
// fused; a block is 2^17 samples (1 MB) at the STX shape, so one block
// per b would use one SM of 132. Here each block is cut into fixed
// chunks of `chunk` samples, one CTA each, over three launches:
//   pass 1: per-chunk sums of a;
//   pass 2: every CTA adds pass 1's partials in chunk order (so all get
//     the same thr1), then sums min-clipped a1 over its chunk;
//   pass 3: thr2 the same way; writes y, the hit2 bitmask (bit i of word
//     w is sample 32 w + i, one warp ballot per word) and clipped_any.
// No float atomics: sums run in a fixed order, so a block gives the same
// bits alone and in any batch (process == processMany). clipped_any is
// an integer OR (order-free). a is spelled sqrtf(re*re + im*im) and the
// gains as in the plain version, with __f*_rn (no FMA contraction), so
// the kernel differs from it only by the order of the two sums.
//
// Bound: HBM bytes (read x, write y, 16 B per sample, plus the bitmask):
// ~0.6 us per STX block at 3.35 TB/s. This design reads x three times
// (once per pass); the last two reads mostly hit the 50 MB L2 at small B.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mag(float2 v) {
    return sqrtf(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
}

// Fixed-order block sum (warp butterfly, then the warps in order); the
// total is valid in every thread.
__device__ float block_sum(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    __syncthreads();
    return s;
}

// scale * (sum of the nch partials in chunk order) / N
__device__ float threshold_of(const float* part, int nch, int N, float scale) {
    float s = 0.f;
    for (int c = 0; c < nch; ++c) s += part[c];
    return __fmul_rn(scale, __fdiv_rn(s, (float)N));
}

__global__ void __launch_bounds__(kThreads)
thr_pass1(const float2* __restrict__ x, float* __restrict__ part1, int* __restrict__ any,
          int N, int chunk, int nch) {
    __shared__ float red[kThreads / 32];
    const int c = blockIdx.x, b = blockIdx.y;
    const float2* xb = x + (size_t)b * N;
    const int k1 = min(N, (c + 1) * chunk);
    float s = 0.f;
    for (int k = c * chunk + threadIdx.x; k < k1; k += kThreads) s += mag(xb[k]);
    s = block_sum(s, red);
    if (threadIdx.x == 0) {
        part1[(size_t)b * nch + c] = s;
        if (c == 0) any[b] = 0;
    }
}

__global__ void __launch_bounds__(kThreads)
thr_pass2(const float2* __restrict__ x, const float* __restrict__ part1,
          float* __restrict__ part2, int N, int chunk, int nch, float scale) {
    __shared__ float red[kThreads / 32];
    __shared__ float t1s;
    const int c = blockIdx.x, b = blockIdx.y;
    if (threadIdx.x == 0) t1s = threshold_of(part1 + (size_t)b * nch, nch, N, scale);
    __syncthreads();
    const float t1 = t1s;
    const float2* xb = x + (size_t)b * N;
    const int k1 = min(N, (c + 1) * chunk);
    float s = 0.f;
    for (int k = c * chunk + threadIdx.x; k < k1; k += kThreads) {
        const float a = mag(xb[k]);
        s += a > t1 ? t1 : a;
    }
    s = block_sum(s, red);
    if (threadIdx.x == 0) part2[(size_t)b * nch + c] = s;
}

__global__ void __launch_bounds__(kThreads)
thr_pass3(const float2* x, float2* y,
          const float* __restrict__ part1, const float* __restrict__ part2,
          unsigned* __restrict__ hits, int* __restrict__ any, int N, int chunk, int nch,
          float scale) {
    __shared__ float ts[2];
    const int c = blockIdx.x, b = blockIdx.y;
    if (threadIdx.x == 0) {
        ts[0] = threshold_of(part1 + (size_t)b * nch, nch, N, scale);
        ts[1] = threshold_of(part2 + (size_t)b * nch, nch, N, scale);
    }
    __syncthreads();
    const float t1 = ts[0], t2 = ts[1];
    const float2* xb = x + (size_t)b * N;
    float2* yb = y + (size_t)b * N;
    unsigned* hb = hits + (size_t)b * (N / 32);
    const int k1 = min(N, (c + 1) * chunk);
    bool hit_any = false;
    // N and chunk are multiples of 32, so a warp's 32 lanes take one whole
    // word per step and all enter the ballot together
    for (int k = c * chunk + threadIdx.x; k < k1; k += kThreads) {
        const float2 v = xb[k];
        const float a = mag(v);
        const bool h1 = a > t1;
        const float a1 = h1 ? t1 : a;
        const bool h2 = a1 > t2;
        const float g1 = h1 ? __fdiv_rn(t1, a) : 1.f;
        const float g2 = h2 ? __fdiv_rn(t2, a1) : 1.f;
        yb[k] = make_float2(__fmul_rn(__fmul_rn(v.x, g1), g2), __fmul_rn(__fmul_rn(v.y, g1), g2));
        const unsigned word = __ballot_sync(0xffffffffu, h2);
        if ((threadIdx.x & 31) == 0) hb[k >> 5] = word;
        hit_any |= word != 0u;
    }
    if ((threadIdx.x & 31) == 0 && hit_any) atomicOr(any + b, 1);
}

}  // namespace

// x, y: (B, N) complex64 (y may be x: in place); part: (2, B, nch) f32
// scratch, nch = ceil(N / chunk); hits: (B, N / 32) u32; any: (B,) i32.
PYCUSDR_API int pycusdr_threshold(const float2* x, float2* y, float* part, unsigned* hits,
                                  int* any, int B, int N, int chunk, float scale,
                                  cudaStream_t stream) {
    if (B <= 0 || N <= 0 || N % 32 || chunk <= 0 || chunk % 32) return (int)cudaErrorInvalidValue;
    const int nch = (N + chunk - 1) / chunk;
    float* part1 = part;
    float* part2 = part + (size_t)B * nch;
    const dim3 grid(nch, B);
    thr_pass1<<<grid, kThreads, 0, stream>>>(x, part1, any, N, chunk, nch);
    thr_pass2<<<grid, kThreads, 0, stream>>>(x, part1, part2, N, chunk, nch, scale);
    thr_pass3<<<grid, kThreads, 0, stream>>>(x, y, part1, part2, hits, any, N, chunk, nch, scale);
    return (int)cudaGetLastError();
}
