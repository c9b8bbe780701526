// K2 mf_bank_colreduce: the best-Doppler matched-filter bank, reduced
// over the mask axis inside the inverse transform.
//
//   X_m[n]    = sum_k S[b, (k + shift_b) mod N] * masks_f[m, k] * exp(+2πi kn/N)
//   (shift_b = shift[b * shift_stride]: stride 0 gives every block the
//   one fixed shift of the no-search mode)
//   colsum[n] = sum_{m in [sum_lo, sum_hi)} |X_m[n]|^2
//   colmax[n] = max_m |X_m[n]|^2, colargmax[n] = its m (lowest mask on ties)
//
// Replaces pycusdr_tpu/ops/demod_kernels.py:apply_best_doppler_power_cols
// (:86-103) with ops/cfft.py:ifft_unnorm_power_colreduce_ri (:371-428).
// The point of that op is that the (M, N) power tensor never reaches
// HBM; here the inverse transform is written out by hand (no cuFFT) so
// the mask reductions can live in its last stage.
//
// Design: a two-pass four-step transform with N = N1 * N2, both at most
// 512 (N from 2^2 to 2^18), input index k = N2*k1 + k2, output index
// n = n1 + N1*n2, each pass a radix-2 transform in shared memory.
//   Pass 1, one block per (b, m, tile of C columns k2): loads the rolled
//     spectrum (the shift is read on the device) times masks_f[m],
//     runs C N1-point column transforms, applies the exp(+2πi k2 n1/N)
//     twiddle and writes Y[b, m, n1, k2].
//   Pass 2, one block per (b, tile of R rows n1): for m = 0..M-1 loads
//     the R rows, runs R N2-point transforms, squares, and folds the
//     power into per-thread running sum / max / argmax (strict '>', so
//     the lowest mask wins ties). Only the three N-vectors are written.
// Bound: compulsory traffic is S, masks_f and the three outputs (~5.5 MB
// at B=1, masks_f read once per call); at B=1 HBM bytes bound it, from
// B=5 the 5 N log2 N flops of the M inverse transforms do. This first
// version also writes and reads back the (B, M, N) complex intermediate
// Y (4 MB per flagship block), and pass 2's stores are runs of R outputs.
// Twiddles come from one table tw[j] = exp(+2πi j/N), built in float64.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile1 = 4096;  // complex elements per pass-1 block (32 KB)
constexpr int kTile2 = 1024;  // complex elements per pass-2 block
constexpr int kEPT2 = kTile2 / kThreads;

// In-place radix-2 transforms of `count` contiguous length-2^logL rows of
// buf, input in bit-reversed order, sign +1. tw has 2^logN entries.
__device__ void fft_shared(float2* buf, int count, int logL, const float2* __restrict__ tw,
                           int logN) {
    const int half = 1 << (logL - 1);
    const int nbf = count * half;
    for (int s = 0; s < logL; ++s) {
        const int h = 1 << s;
        __syncthreads();
        for (int t = threadIdx.x; t < nbf; t += kThreads) {
            const int tr = t >> (logL - 1);
            const int u = t & (half - 1);
            const int pos = u & (h - 1);
            const int i0 = (tr << logL) + ((u >> s) << (s + 1)) + pos;
            const int i1 = i0 + h;
            const float2 w = tw[pos << (logN - s - 1)];  // exp(+2πi pos / 2h)
            const float2 a = buf[i0];
            const float2 x = pycusdr::cmul(w, buf[i1]);
            buf[i0] = pycusdr::cadd(a, x);
            buf[i1] = pycusdr::csub(a, x);
        }
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
mf_pass1(const float2* __restrict__ S, const float2* __restrict__ masks,
         const int* __restrict__ shift, int shift_stride, const float2* __restrict__ tw,
         float2* __restrict__ Y, int logN, int M, int logN1, int logC) {
    __shared__ float2 buf[kTile1];
    const int N = 1 << logN, N2 = N >> logN1, C = 1 << logC;
    const int c0 = blockIdx.x << logC, m = blockIdx.y, b = blockIdx.z;
    const int tile = C << logN1;
    const int sh = shift[b * shift_stride] & (N - 1);
    const float2* Sb = S + ((size_t)b << logN);
    const float2* Mm = masks + ((size_t)m << logN);
    for (int e = threadIdx.x; e < tile; e += kThreads) {
        const int c = e & (C - 1), k1 = e >> logC;
        const int k = k1 * N2 + c0 + c;
        buf[(c << logN1) + pycusdr::bitrev(k1, logN1)] =
            pycusdr::cmul(Sb[(k + sh) & (N - 1)], Mm[k]);
    }
    fft_shared(buf, C, logN1, tw, logN);
    float2* Yb = Y + (((size_t)b * M + m) << logN);
    for (int e = threadIdx.x; e < tile; e += kThreads) {
        const int c = e & (C - 1), n1 = e >> logC;
        const int k2 = c0 + c;
        Yb[n1 * N2 + k2] = pycusdr::cmul(buf[(c << logN1) + n1], tw[k2 * n1]);
    }
}

__global__ void __launch_bounds__(kThreads)
mf_pass2(const float2* __restrict__ Y, const float2* __restrict__ tw,
         float* __restrict__ colsum, float* __restrict__ colmax, int* __restrict__ colarg,
         int logN, int M, int logN1, int logR, int sum_lo, int sum_hi) {
    __shared__ float2 buf[kTile2];
    const int logN2 = logN - logN1;
    const int N2 = 1 << logN2, R = 1 << logR;
    const int r0 = blockIdx.x << logR, b = blockIdx.y;
    const int tile = R << logN2;
    float sum[kEPT2], mx[kEPT2];
    int arg[kEPT2];
#pragma unroll
    for (int j = 0; j < kEPT2; ++j) {
        sum[j] = 0.f;
        mx[j] = 0.f;
        arg[j] = 0;
    }
    for (int m = 0; m < M; ++m) {
        const float2* Yr = Y + (((size_t)b * M + m) << logN) + ((size_t)r0 << logN2);
        for (int e = threadIdx.x; e < tile; e += kThreads) {
            const int r = e >> logN2, k2 = e & (N2 - 1);
            buf[(r << logN2) + pycusdr::bitrev(k2, logN2)] = Yr[e];
        }
        fft_shared(buf, R, logN2, tw, logN);
#pragma unroll
        for (int j = 0; j < kEPT2; ++j) {
            const int e = threadIdx.x + j * kThreads;
            if (e < tile) {
                const float2 v = buf[((e & (R - 1)) << logN2) + (e >> logR)];
                const float p = v.x * v.x + v.y * v.y;
                if (m >= sum_lo && m < sum_hi) sum[j] += p;
                if (m == 0 || p > mx[j]) {  // strict: the lowest mask wins ties
                    mx[j] = p;
                    arg[j] = m;
                }
            }
        }
        __syncthreads();  // buf is reloaded for the next mask
    }
    const size_t ob = (size_t)b << logN;
#pragma unroll
    for (int j = 0; j < kEPT2; ++j) {
        const int e = threadIdx.x + j * kThreads;
        if (e < tile) {
            const size_t n = ob + r0 + (e & (R - 1)) + ((size_t)(e >> logR) << logN1);
            colsum[n] = sum[j];
            colmax[n] = mx[j];
            colarg[n] = arg[j];
        }
    }
}

int ilog2_exact(int v) {
    if (v <= 0 || (v & (v - 1))) return -1;
    int l = 0;
    while ((1 << l) < v) ++l;
    return l;
}

}  // namespace

// shift: (B,) i32 with shift_stride 1, or (1,) with 0; Y: (B, M, N) complex
// scratch; colsum/colmax: (B, N) f32; colargmax: (B, N) i32.
PYCUSDR_API int pycusdr_mf_bank_colreduce(const float2* S, const float2* masks, const int* shift,
                                          int shift_stride, const float2* tw, float2* Y,
                                          float* colsum,
                                          float* colmax, int* colargmax, int B, int N, int M,
                                          int n1, int sum_lo, int sum_hi, cudaStream_t stream) {
    const int logN = ilog2_exact(N), logN1 = ilog2_exact(n1);
    if (B <= 0 || M <= 0 || logN < 2 || logN1 < 1 || logN1 >= logN) return (int)cudaErrorInvalidValue;
    const int logN2 = logN - logN1;
    if (logN1 > 9 || logN2 > 9) return (int)cudaErrorInvalidValue;
    int logC = 12 - logN1;  // kTile1 = 2^12
    if (logC > logN2) logC = logN2;
    int logR = 10 - logN2;  // kTile2 = 2^10
    if (logR > logN1) logR = logN1;
    mf_pass1<<<dim3(1 << (logN2 - logC), M, B), kThreads, 0, stream>>>(
        S, masks, shift, shift_stride, tw, Y, logN, M, logN1, logC);
    mf_pass2<<<dim3(1 << (logN1 - logR), B), kThreads, 0, stream>>>(
        Y, tw, colsum, colmax, colargmax, logN, M, logN1, logR, sum_lo, sum_hi);
    return (int)cudaGetLastError();
}
