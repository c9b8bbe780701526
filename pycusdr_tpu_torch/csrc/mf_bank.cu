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
// n = n1 + N1*n2. Above 2^18, N2 = N / N1 (N1 = 512) is itself split into
// factors of at most 512 (ops/demod_kernels.py:fft_factors), one middle
// pass (mf_mid) for each factor but the last, between passes 1 and 2: each
// runs one factor's transforms down the columns of Y's rows in place and
// applies that level's twiddle from the float64-built table, so pass 2's
// rows are the last factor's, and the middle digits of the output index
// come out reversed (mid_reverse). Each pass runs its transforms in shared memory with the
// register-radix Stockham passes of fft_smem.cuh (radix 8, one barrier
// pair per pass, twiddles staged in shared memory).
//   Pass 1, one block per (b, m, tile of C columns k2): loads the rolled
//     spectrum (the shift is read on the device) times masks_f[m] as N1
//     coalesced rows of C values, runs the C N1-point column transforms,
//     applies exp(+2πi k2 n1/N) (two staged tables) and writes
//     Y[b, m, n1, k2] in rows of C.
//   Pass 2, one block per (b, tile of R rows n1): for each group of Mg
//     masks it loads the Mg R rows (contiguous), runs their N2-point
//     transforms, squares, and folds the power into per-thread running
//     sum / max / argmax over m in increasing order (strict '>', so the
//     lowest mask wins ties). Only the three N-vectors are written, in
//     runs of R. R shrinks at small B so that B=1 still fills the SMs; the
//     plan (ops/demod_kernels.py:mf_bank_plan) never changes a result bit.
// Bound: compulsory traffic is S, masks_f and the three outputs (~5.5 MB
// at B=1, masks_f read once per call); at B=1 HBM bytes bound it, from
// B=5 the 5 N log2 N flops of the M inverse transforms do. This design
// still writes and reads back the (B, M, N) complex intermediate Y (4 MB
// per flagship block); keeping it on chip needs a thread-block cluster
// per transform (distributed shared memory), the next step.
#include "fft_smem.cuh"

namespace {

using pycusdr::kFftEPT;
using pycusdr::kFftThreads;
constexpr int kOut2 = 8;  // outputs of a pass-2 thread: R * N2 <= 8 * 256
constexpr int kLogElems = 11, kLogMaxRows = 5;  // log2 of kFftElems, kFftMaxRows
static_assert(1 << kLogElems == pycusdr::kFftElems && 1 << kLogMaxRows == pycusdr::kFftMaxRows,
              "the middle passes' tile");
// blocks per SM each pass is compiled for (registers: 65536 / (256 x this))
constexpr int kMinBlocks1 = 4, kMinBlocks2 = 3;

__global__ void __launch_bounds__(kFftThreads, kMinBlocks1)
mf_pass1(const float2* __restrict__ S, const float2* __restrict__ masks,
         const int* __restrict__ shift, int shift_stride, const float2* __restrict__ tw,
         float2* __restrict__ Y, int logN, int M, int logN1, int logC) {
    extern __shared__ float2 smem[];
    const pycusdr::FftSmem sm = pycusdr::fft_smem(smem, logN, tw);
    float2* buf = sm.buf;
    const int N = 1 << logN, logN2 = logN - logN1, C = 1 << logC;
    const int c0 = blockIdx.x << logC, m = blockIdx.y, b = blockIdx.z;
    const int pitch = pycusdr::fft_pitch(1 << logN1), tile = C << logN1;
    pycusdr::fft_stage_twiddles(sm, tw, logN1, logN);
    const int sh = shift[b * shift_stride] & (N - 1);
    const float2* Sb = S + ((size_t)b << logN);
    const float2* Mm = masks + ((size_t)m << logN);
#pragma unroll
    for (int t = 0; t < kFftEPT; ++t) {  // unrolled: the loads are in flight together
        const int e = threadIdx.x + t * kFftThreads;
        if (e < tile) {
            const int cc = e & (C - 1), k1 = e >> logC;
            const int k = (k1 << logN2) + c0 + cc;
            buf[cc * pitch + pycusdr::fft_pad(k1)] = pycusdr::cmul(Sb[(k + sh) & (N - 1)], Mm[k]);
        }
    }
    __syncthreads();
    pycusdr::fft_rows<1>(buf, C, logN1, pitch, sm.twL);
    float2* Yb = Y + (((size_t)b * M + m) << logN);
#pragma unroll
    for (int t = 0; t < kFftEPT; ++t) {
        const int e = threadIdx.x + t * kFftThreads;
        if (e < tile) {
            const int cc = e & (C - 1), n1 = e >> logC;
            const int k2 = c0 + cc;
            Yb[(n1 << logN2) + k2] = pycusdr::cmul(buf[cc * pitch + pycusdr::fft_pad(n1)],
                                                   pycusdr::fft_twiddle<1>(sm, k2 * n1));
        }
    }
}

// A middle pass (N > 2^18): over every row of F * inner elements of Y
// (rows of the (b, m) blocks of N, in order), the F-point transforms down
// its columns (element ka * inner + kb, column kb, C columns a block), each
// output na times exp(+2πi na kb / (F inner)) from the float64-built table,
// written back in place (element na * inner + kb). grid: one block per
// (row, tile of C columns), the tile fastest.
__global__ void __launch_bounds__(kFftThreads, kMinBlocks1)
mf_mid(float2* __restrict__ Y, const float2* __restrict__ tw, int logN, int logF, int logInner,
       int logC) {
    extern __shared__ float2 smem[];
    const pycusdr::FftSmem sm = pycusdr::fft_smem(smem, logN, tw);
    float2* buf = sm.buf;
    const int C = 1 << logC, tiles = 1 << (logInner - logC);
    const int c0 = (blockIdx.x & (tiles - 1)) << logC;
    float2* Yr = Y + ((size_t)(blockIdx.x >> (logInner - logC)) << (logF + logInner));
    const int pitch = pycusdr::fft_pitch(1 << logF), tile = C << logF;
    const int tsh = logN - logF - logInner;  // table index of exp(2πi / (F inner))
    pycusdr::fft_stage_twiddles(sm, tw, logF, logN);
#pragma unroll
    for (int t = 0; t < kFftEPT; ++t) {
        const int e = threadIdx.x + t * kFftThreads;
        if (e < tile) {
            const int cc = e & (C - 1), ka = e >> logC;
            buf[cc * pitch + pycusdr::fft_pad(ka)] = Yr[((size_t)ka << logInner) + c0 + cc];
        }
    }
    __syncthreads();
    pycusdr::fft_rows<1>(buf, C, logF, pitch, sm.twL);
#pragma unroll
    for (int t = 0; t < kFftEPT; ++t) {
        const int e = threadIdx.x + t * kFftThreads;
        if (e < tile) {
            const int cc = e & (C - 1), na = e >> logC;
            const int kb = c0 + cc;
            Yr[((size_t)na << logInner) + kb] = pycusdr::cmul(
                buf[cc * pitch + pycusdr::fft_pad(na)], __ldg(tw + ((size_t)(na * kb) << tsh)));
        }
    }
}

// The middle factors' logs, 4 bits each, the first factor lowest (0: none).
// Their sum.
__device__ __forceinline__ int mid_log(int mids) {
    int l = 0;
    for (; mids; mids >>= 4) l += mids & 15;
    return l;
}

// Row s of the middle digits as Y stores them (n_1 most significant, each
// n_i < 2^log_i) to its place in the output index (n_1 least significant):
// n_1 + f_1 (n_2 + f_2 (...)).
__device__ __forceinline__ int mid_reverse(int s, int mids) {
    int logs[8], q = 0;
    for (; mids; mids >>= 4) logs[q++] = mids & 15;
    int pre = 0, o = 0;
    for (int i = 0; i < q; ++i) pre += logs[i];
    for (int i = q - 1; i >= 0; --i) {  // n_q first: the lowest digit of s
        pre -= logs[i];
        o |= (s & ((1 << logs[i]) - 1)) << pre;
        s >>= logs[i];
    }
    return o;
}

__global__ void __launch_bounds__(kFftThreads, kMinBlocks2)
mf_pass2(const float2* __restrict__ Y, const float2* __restrict__ tw,
         float* __restrict__ colsum, float* __restrict__ colmax, int* __restrict__ colarg,
         int logN, int M, int logN1, int logR, int Mg, int sum_lo, int sum_hi, int mids) {
    extern __shared__ float2 smem[];
    const pycusdr::FftSmem sm = pycusdr::fft_smem(smem, logN, tw);
    float2* buf = sm.buf;
    const int logMid = mid_log(mids);
    const int logS1 = logN - logN1;  // Y's stride of n1
    const int logN2 = logS1 - logMid;  // the last transform's length
    const int N2 = 1 << logN2, R = 1 << logR;
    const int r0 = (blockIdx.x & ((1 << (logN1 - logR)) - 1)) << logR, b = blockIdx.y;
    const int smid = blockIdx.x >> (logN1 - logR);  // the middle digits, as Y stores them
    const int pitch = pycusdr::fft_pitch(N2), outs = R << logN2;
    pycusdr::fft_stage_twiddles(sm, tw, logN2, logN);
    float sum[kOut2], mx[kOut2];
    int arg[kOut2];
#pragma unroll
    for (int j = 0; j < kOut2; ++j) {
        sum[j] = 0.f;
        mx[j] = 0.f;
        arg[j] = 0;
    }
    for (int m0 = 0; m0 < M; m0 += Mg) {
        const int mg = min(Mg, M - m0), rows = mg << logR;
        const float2* Yg =
            Y + (((size_t)b * M + m0) << logN) + ((size_t)r0 << logS1) + ((size_t)smid << logN2);
#pragma unroll
        for (int t = 0; t < kFftEPT; ++t) {
            const int e = threadIdx.x + t * kFftThreads;
            if (e < (rows << logN2)) {
                const int row = e >> logN2, i = e & (N2 - 1);
                const int mm = row >> logR, r = row & (R - 1);
                buf[row * pitch + pycusdr::fft_pad(i)] =
                    Yg[((size_t)mm << logN) + ((size_t)r << logS1) + i];
            }
        }
        __syncthreads();
        pycusdr::fft_rows<1>(buf, rows, logN2, pitch, sm.twL);
#pragma unroll
        for (int j = 0; j < kOut2; ++j) {
            const int p = threadIdx.x + j * kFftThreads;
            if (p < outs) {
                const int r = p & (R - 1), n2 = p >> logR;
                for (int mm = 0; mm < mg; ++mm) {
                    const int m = m0 + mm;
                    const float2 v = buf[((mm << logR) + r) * pitch + pycusdr::fft_pad(n2)];
                    const float pw = v.x * v.x + v.y * v.y;
                    if (m >= sum_lo && m < sum_hi) sum[j] += pw;
                    if (m == 0 || pw > mx[j]) {  // strict: the lowest mask wins ties
                        mx[j] = pw;
                        arg[j] = m;
                    }
                }
            }
        }
        __syncthreads();  // buf is reloaded for the next group of masks
    }
    const size_t ob = ((size_t)b << logN) + ((size_t)mid_reverse(smid, mids) << logN1);
#pragma unroll
    for (int j = 0; j < kOut2; ++j) {
        const int p = threadIdx.x + j * kFftThreads;
        if (p < outs) {
            const size_t n = ob + r0 + (p & (R - 1)) + ((size_t)(p >> logR) << (logN1 + logMid));
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
// scratch; colsum/colmax: (B, N) f32; colargmax: (B, N) i32. The plan n1,
// C, R, Mg and the middle factors (mids: their logs, 4 bits each, the
// first lowest; 0 for none) is ops/demod_kernels.py:mf_bank_plan's.
PYCUSDR_API int pycusdr_mf_bank_colreduce(const float2* S, const float2* masks, const int* shift,
                                          int shift_stride, const float2* tw, float2* Y,
                                          float* colsum, float* colmax, int* colargmax, int B,
                                          int N, int M, int n1, int C, int R, int Mg, int sum_lo,
                                          int sum_hi, int mids, cudaStream_t stream) {
    const int logN = ilog2_exact(N), logN1 = ilog2_exact(n1);
    const int logC = ilog2_exact(C), logR = ilog2_exact(R);
    if (B <= 0 || M <= 0 || logN < 2 || logN1 < 1 || logN1 >= logN || logC < 0 || logR < 0 ||
        Mg <= 0 || mids < 0 || B > 65535 || M > 65535)
        return (int)cudaErrorInvalidValue;
    int logMid = 0;
    for (int m = mids; m; m >>= 4) {
        const int l = m & 15;
        if (l < 1 || l > 9) return (int)cudaErrorInvalidValue;  // a factor in [2, 512]
        logMid += l;
    }
    const int N2 = N >> logN1;  // pass 1's columns
    if (logN1 + logMid >= logN) return (int)cudaErrorInvalidValue;
    const int L2 = N2 >> logMid;  // pass 2's transform length
    if (n1 > pycusdr::kFftMaxL || L2 > pycusdr::kFftMaxL || C > N2 || R > n1 ||
        C > pycusdr::kFftMaxRows || Mg * R > pycusdr::kFftMaxRows ||
        C * n1 > pycusdr::kFftElems || Mg * R * L2 > pycusdr::kFftElems ||
        R * L2 > kOut2 * kFftThreads || ((long long)(n1 / R) << logMid) > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    static unsigned long long smem1 = 0, smem2 = 0, smem3 = 0;
    cudaError_t e = pycusdr::fft_allow_smem(mf_pass1, smem1);
    if (e == cudaSuccess) e = pycusdr::fft_allow_smem(mf_pass2, smem2);
    if (e == cudaSuccess && mids) e = pycusdr::fft_allow_smem(mf_mid, smem3);
    if (e != cudaSuccess) return (int)e;
    constexpr int sb = pycusdr::kFftSmemBytes;
    mf_pass1<<<dim3(N2 / C, M, B), kFftThreads, sb, stream>>>(
        S, masks, shift, shift_stride, tw, Y, logN, M, logN1, logC);
    int logInner = logN - logN1;
    for (int m = mids; m; m >>= 4) {  // the middle passes, the first factor first
        const int logF = m & 15;
        logInner -= logF;
        // columns a block: min(inner, kFftElems / F, kFftMaxRows)
        const int logCm = min(min(logInner, kLogElems - logF), kLogMaxRows);
        const long long rows = (long long)B * M << (logN - logF - logInner);
        const long long blocks = rows << (logInner - logCm);
        if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        mf_mid<<<(unsigned)blocks, kFftThreads, sb, stream>>>(Y, tw, logN, logF, logInner, logCm);
    }
    mf_pass2<<<dim3((n1 / R) << logMid, B), kFftThreads, sb, stream>>>(
        Y, tw, colsum, colmax, colargmax, logN, M, logN1, logR, Mg, sum_lo, sum_hi, mids);
    return (int)cudaGetLastError();
}
