// K5 doppler_estimate: the scalar tail of the Doppler search for one block.
//
//   top-2 grid bins of E (summed over masks, or per mask then averaged),
//   dopp_idx = (i0 v0 + i1 v1) / (v0 + v1) (0 when v0 + v1 <= 0),
//   quality  = max(v0, v1) / E[noise bin] when a noise bin leads the grid,
//              else (i0 v0 + i1 v1) / (i0 + i1); quality_db = 10 log10,
//   doppler_hz and shift interpolated between floor and ceil of dopp_idx
//   (the shift on unwrapped bins, rounded half to even, mod N),
//   snr_db   = 20 log10(mean|S| over the signal band / mean|S| over the
//              mirrored band - 1), -inf when that ratio is <= 0.
// With a runtime recentre c_b (tracking: the grid follows the ramp, the
// optional `centre` operand) the grid sits c_b bins higher, as in
// pycusdr_tpu/dsp/block.py:254-266: doppler_hz += f32(c_b) * f32(fs/N)
// after the interpolation, shift = (rint(...) + c_b) mod N, and both SNR
// bands move by c_b bins. A NULL `centre` skips all three (the results of
// the graph without a recentre, bit for bit).
//
// Replaces pycusdr_tpu/ops/doppler_search.py:find_doppler_estimate
// (:158-193), the interpolation of dsp/block.py:248-267 and
// ops/demod_kernels.py:compute_snr (:651-668). In the first port these
// were ~80 small torch ops per call; here they are one launch of one
// block per b. The f32 arithmetic follows the plain version's operation
// order with __f*_rn (no FMA contraction), the top-2 takes the first
// index on ties as jax.lax.top_k does, and the shift uses rintf (half to
// even, as torch.round). The SNR reads only the 2 x (hi - lo + 2 w) bins
// of its two bands, where the JAX op masks all N.
//
// Bound: the bytes of E (read, and copied into the packed row), the band
// bins of P and the scalars (~5 KB per flagship block): far below a
// microsecond, so the launch bounds it.
// Outputs: sc[b * sc_stride + 0..5] = dopp_idx, quality_db, doppler_hz,
// freq_offset_hz, snr_db, shift (as f32), e_out[b * e_stride + d * M + m]
// = E (when e_out is not NULL), shift_out[b] = shift (int32, read by K2);
// centre: NULL or (B,) int32 bins.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 1024;
constexpr int kMaxM = 64;

// Fixed-order block sum: warp butterfly (every lane ends with the same
// value), then the warps in order. Every thread gets the total.
__device__ float block_sum(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    __syncthreads();
    return s;
}

// Top-2 over v[0], v[stride], ... (n values) as the plain version takes
// it: i0 = first index of the maximum; i1 = first index of the maximum
// once v[i0] is replaced by -inf (i1 = i0 when n == 1).
__device__ void top2(const float* v, int stride, int n, float& v0, int& i0, float& v1,
                     int& i1) {
    v0 = v[0];
    i0 = 0;
    for (int i = 1; i < n; ++i) {
        const float x = v[i * stride];
        if (x > v0) {
            v0 = x;
            i0 = i;
        }
    }
    float best = i0 == 0 ? -INFINITY : v[0];
    i1 = 0;
    for (int i = 1; i < n; ++i) {
        const float x = i == i0 ? -INFINITY : v[i * stride];
        if (x > best) {
            best = x;
            i1 = i;
        }
    }
    v1 = v[i1 * stride];
}

// Weighted index and quality of one top-2 (noise bin = E of grid entry 0).
__device__ void weigh(float v0, int i0, float v1, int i1, int off, float noise, float& idx,
                      float& qual) {
    const float f0 = (float)(i0 + off), f1 = (float)(i1 + off);
    const float wsum = __fadd_rn(__fmul_rn(f0, v0), __fmul_rn(f1, v1));
    const float denom = __fadd_rn(v0, v1);
    idx = denom > 0.f ? __fdiv_rn(wsum, denom) : 0.f;
    if (off > 0)
        qual = __fdiv_rn(fmaxf(v0, v1), noise);
    else
        qual = denom > 0.f ? __fdiv_rn(wsum, __fadd_rn(f0, f1)) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
doppler_estimate(const float* __restrict__ E, const float* __restrict__ P,
                 const int* __restrict__ shifts, const int* __restrict__ shifts_signed,
                 const float* __restrict__ hz, float* __restrict__ sc, int sc_stride,
                 float* __restrict__ e_out, int e_stride, int* __restrict__ shift_out,
                 const int* __restrict__ centre, int N, int D, int M, int nd, int off,
                 int sum_all, int w, float if_hz, float bin_hz) {
    __shared__ float tot[kMaxD];
    __shared__ float idxs[kMaxM], quals[kMaxM];
    __shared__ float red[kThreads / 32];
    __shared__ int band[4];  // signal start, noise start, span, shift
    __shared__ float head[5];
    const int b = blockIdx.x;
    const float* Eb = E + (size_t)b * D * M;

    if (e_out)
        for (int t = threadIdx.x; t < D * M; t += kThreads) e_out[(size_t)b * e_stride + t] = Eb[t];
    if (sum_all)
        for (int d = threadIdx.x; d < D; d += kThreads) {
            float s = 0.f;
            for (int m = 0; m < M; ++m) s += Eb[d * M + m];
            tot[d] = s;
        }
    __syncthreads();

    if (!sum_all && threadIdx.x < M) {
        const int m = threadIdx.x;
        float v0, v1;
        int i0, i1;
        top2(Eb + off * M + m, M, nd, v0, i0, v1, i1);
        weigh(v0, i0, v1, i1, off, Eb[m], idxs[m], quals[m]);
    }
    __syncthreads();

    if (threadIdx.x == 0) {
        float dopp_idx, quality;
        if (sum_all) {
            float v0, v1;
            int i0, i1;
            top2(tot + off, 1, nd, v0, i0, v1, i1);
            weigh(v0, i0, v1, i1, off, tot[0], dopp_idx, quality);
        } else {
            float si = 0.f, sq = 0.f;
            for (int m = 0; m < M; ++m) {
                si = __fadd_rn(si, idxs[m]);
                sq = __fadd_rn(sq, quals[m]);
            }
            dopp_idx = __fdiv_rn(si, (float)M);
            quality = __fdiv_rn(sq, (float)M);
        }
        const float fl = floorf(dopp_idx);
        const int lo = min(max((int)fl, 0), D - 1);
        const int hi = min(max((int)ceilf(dopp_idx), 0), D - 1);
        const float frac = __fsub_rn(dopp_idx, fl);  // remainder(dopp_idx, 1), dopp_idx >= 0
        const float hz_lo = hz[lo], hz_hi = hz[hi];
        float dhz = __fadd_rn(hz_lo, __fmul_rn(__fsub_rn(hz_hi, hz_lo), frac));
        const long long c = centre ? centre[b] : 0;
        if (centre) dhz = __fadd_rn(dhz, __fmul_rn((float)c, bin_hz));
        const float sl = (float)shifts_signed[lo], sh = (float)shifts_signed[hi];
        int shift = (int)(((long long)(int)rintf(__fadd_rn(sl, __fmul_rn(__fsub_rn(sh, sl), frac)))
                           + c) % N);
        if (shift < 0) shift += N;
        head[0] = dopp_idx;
        head[1] = __fmul_rn(10.f, log10f(quality));
        head[2] = dhz;
        head[3] = __fsub_rn(dhz, if_hz);
        // circular bands [a, a + span) of the signal and of its mirror
        int a = (int)(((long long)shifts[lo] + c - w) % N);
        if (a < 0) a += N;
        int span = (int)(((long long)shifts[hi] + c + w - a) % N);
        if (span < 0) span += N;
        band[0] = a;
        band[1] = (a + N / 2) % N;
        band[2] = span;
        band[3] = shift;
    }
    __syncthreads();

    const float* Pb = P + (size_t)b * N;
    const int span = band[2];
    float s_sig = 0.f, s_noise = 0.f;
    for (int t = threadIdx.x; t < span; t += kThreads) {
        int i = band[0] + t;
        if (i >= N) i -= N;
        int j = band[1] + t;
        if (j >= N) j -= N;
        s_sig += sqrtf(Pb[i]);
        s_noise += sqrtf(Pb[j]);
    }
    s_sig = block_sum(s_sig, red);
    s_noise = block_sum(s_noise, red);

    if (threadIdx.x == 0) {
        const float cnt = (float)max(span, 1);
        const float ratio = __fsub_rn(__fdiv_rn(__fdiv_rn(s_sig, cnt), __fdiv_rn(s_noise, cnt)), 1.f);
        float* o = sc + (size_t)b * sc_stride;
        o[0] = head[0];
        o[1] = head[1];
        o[2] = head[2];
        o[3] = head[3];
        o[4] = ratio > 0.f ? __fmul_rn(20.f, log10f(ratio)) : -INFINITY;
        o[5] = (float)band[3];
        shift_out[b] = band[3];
    }
}

}  // namespace

PYCUSDR_API int pycusdr_doppler_estimate(const float* E, const float* P, const int* shifts,
                                         const int* shifts_signed, const float* hz, float* sc,
                                         int sc_stride, float* e_out, int e_stride,
                                         int* shift_out, const int* centre, int B, int N,
                                         int D, int M, int nd, int off, int sum_all,
                                         int snr_window, float if_hz, float bin_hz,
                                         cudaStream_t stream) {
    if (B <= 0 || N <= 0 || D <= 0 || D > kMaxD || M <= 0 || M > kMaxM || nd <= 0 ||
        off < 0 || off + nd > D)
        return (int)cudaErrorInvalidValue;
    doppler_estimate<<<B, kThreads, 0, stream>>>(E, P, shifts, shifts_signed, hz, sc, sc_stride,
                                                 e_out, e_stride, shift_out, centre, N, D, M, nd,
                                                 off, sum_all, snr_window, if_hz, bin_hz);
    return (int)cudaGetLastError();
}
