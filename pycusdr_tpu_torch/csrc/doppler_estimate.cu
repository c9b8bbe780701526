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
// ops/demod_kernels.py:compute_snr (:651-668): one launch of one block per
// b. The f32 arithmetic follows the plain version's operation order with
// __f*_rn (no FMA contraction), the top-2 takes the first index on ties as
// jax.lax.top_k does, and the shift uses rintf (half to even, as
// torch.round). The SNR reads only the 2 x (hi - lo + 2 w) bins of its two
// bands, where the JAX op masks all N. Any grid size D and mask count M.
//
// Bound: the bytes of E (read, and copied into the packed row), the band
// bins of P and the scalars (~5 KB per flagship block): far below a
// microsecond, so what bounds it is the chain of dependent steps inside
// the one block. The design keeps that chain short:
// - the lines of the grid tables (hz, shifts, shifts_signed) are
//   prefetched into L1 at the start, beside the loads of E, so the reads
//   of the interpolation and the band edges, once the top two are known,
//   hit L1 (staging the tables in shared memory measured slower: its loads
//   and the wait before the barrier sat on the chain);
// - the top two by warps: each thread keeps a top two of its own grid
//   entries (summing the masks of an entry in increasing m), five shuffle
//   steps merge a warp's, and three more merge the warps' in every warp
//   (the lower index wins equal values), so no thread scans the grid
//   alone; in the per-mask form a warp takes a mask, and the means over
//   masks are added in m order from shared memory, 32 masks a round;
// - every thread computes the tail from the merged top two, so nothing is
//   broadcast, with the recentre and the window taken mod N first (the
//   grid's shifts are in [0, N)), so the band edges and the shift wrap by
//   adds and compares, with no division on the chain; the outputs but the
//   SNR are stored by a thread the band rarely reaches; then the reads of
//   P, and the two band sums over warps with one barrier, the warps added
//   in order (a block gives the same bits alone and in any batch).
// Outputs: sc[b * sc_stride + 0..5] = dopp_idx, quality_db, doppler_hz,
// freq_offset_hz, snr_db, shift (as f32), e_out[b * e_stride + d * M + m]
// = E (when e_out is not NULL; 16-byte stores where the row allows),
// shift_out[b] = shift (int32, read by K2); centre: NULL or (B,) int32 bins.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // a power of two: the merge across warps shuffles
// masks whose per-mask results one round of the per-mask form holds
constexpr int kRound = 32;

// A top two under the plain version's rule: i0 = the first index of the
// maximum; i1 = the first index of the maximum once v[i0] is -inf.
struct Top2 {
    float v0, v1;
    int i0, i1;
};

__device__ __forceinline__ Top2 top2_empty() { return {-INFINITY, -INFINITY, INT_MAX, INT_MAX}; }

// Add x at index i, above every index already added.
__device__ __forceinline__ void top2_push(Top2& t, float x, int i) {
    if (x > t.v0) {
        t.v1 = t.v0;
        t.i1 = t.i0;
        t.v0 = x;
        t.i0 = i;
    } else if (x > t.v1) {
        t.v1 = x;
        t.i1 = i;
    }
}

// (va, ia) ahead of (vb, ib): the larger value, the lower index on equal values
__device__ __forceinline__ bool ahead(float va, int ia, float vb, int ib) {
    return va > vb || (va == vb && ia < ib);
}

// The top two of two disjoint sets of indices.
__device__ __forceinline__ Top2 top2_merge(const Top2& a, const Top2& b) {
    const bool af = ahead(a.v0, a.i0, b.v0, b.i0);
    Top2 r;
    r.v0 = af ? a.v0 : b.v0;
    r.i0 = af ? a.i0 : b.i0;
    const float lv = af ? b.v0 : a.v0, wv = af ? a.v1 : b.v1;
    const int li = af ? b.i0 : a.i0, wi = af ? a.i1 : b.i1;
    const bool ls = ahead(lv, li, wv, wi);
    r.v1 = ls ? lv : wv;
    r.i1 = ls ? li : wi;
    return r;
}

// Merge the lanes' top twos; every lane ends with the warp's.
__device__ __forceinline__ Top2 warp_top2(Top2 t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        Top2 u;
        u.v0 = __shfl_xor_sync(0xffffffffu, t.v0, o);
        u.v1 = __shfl_xor_sync(0xffffffffu, t.v1, o);
        u.i0 = __shfl_xor_sync(0xffffffffu, t.i0, o);
        u.i1 = __shfl_xor_sync(0xffffffffu, t.i1, o);
        t = top2_merge(t, u);
    }
    return t;
}

// The serial scan's answer where no value exceeds -inf: it keeps index 0
// (and v1 = v[0]).
__device__ __forceinline__ void top2_final(Top2& t) {
    if (t.i0 == INT_MAX) t.i0 = 0;
    if (!(t.v1 > -INFINITY)) {
        t.i1 = 0;
        t.v1 = t.i0 == 0 ? t.v0 : -INFINITY;
    }
}

// Weighted index and quality of one top-2 (noise bin = E of grid entry 0).
__device__ void weigh(const Top2& t, int off, float noise, float& idx, float& qual) {
    const float f0 = (float)(t.i0 + off), f1 = (float)(t.i1 + off);
    const float wsum = __fadd_rn(__fmul_rn(f0, t.v0), __fmul_rn(f1, t.v1));
    const float denom = __fadd_rn(t.v0, t.v1);
    idx = denom > 0.f ? __fdiv_rn(wsum, denom) : 0.f;
    if (off > 0)
        qual = __fdiv_rn(fmaxf(t.v0, t.v1), noise);
    else
        qual = denom > 0.f ? __fdiv_rn(wsum, __fadd_rn(f0, f1)) : 0.f;
}

// v mod N in [0, N), for -3N < v < 3N: no division on the chain
__device__ __forceinline__ int wrap(int v, int N) {
#pragma unroll
    for (int i = 0; i < 3; ++i) v = v < 0 ? v + N : v;
#pragma unroll
    for (int i = 0; i < 2; ++i) v = v >= N ? v - N : v;
    return v;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// E[b] into its packed row: scalar stores up to 16-byte alignment of the
// row, then float4 stores.
__device__ void copy_row(float* __restrict__ dst, const float* __restrict__ src, int n) {
    const int misalign = (int)((uintptr_t)dst & 15);  // bytes; a multiple of 4
    const int head = min(n, ((16 - misalign) & 15) / 4);
    for (int t = threadIdx.x; t < head; t += kThreads) dst[t] = src[t];
    const int nv = (n - head) >> 2;
    float4* dv = reinterpret_cast<float4*>(dst + head);
    const float* s = src + head;
    if (((uintptr_t)s & 15) == 0) {
        const float4* sv = reinterpret_cast<const float4*>(s);
        for (int t = threadIdx.x; t < nv; t += kThreads) dv[t] = sv[t];
    } else {
        for (int t = threadIdx.x; t < nv; t += kThreads)
            dv[t] = make_float4(s[4 * t], s[4 * t + 1], s[4 * t + 2], s[4 * t + 3]);
    }
    for (int t = head + 4 * nv + threadIdx.x; t < n; t += kThreads) dst[t] = src[t];
}

__global__ void __launch_bounds__(kThreads)
doppler_estimate(const float* __restrict__ E, const float* __restrict__ P,
                 const int* __restrict__ shifts, const int* __restrict__ shifts_signed,
                 const float* __restrict__ hz, float* __restrict__ sc, int sc_stride,
                 float* __restrict__ e_out, int e_stride, int* __restrict__ shift_out,
                 const int* __restrict__ centre, int N, int D, int M, int nd, int off,
                 int sum_all, int w, float if_hz, float bin_hz) {
    __shared__ Top2 wtop[kWarps];
    __shared__ float red[2][kWarps];
    __shared__ float r_idx[kRound], r_qual[kRound];
    __shared__ float noise_s;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x;
    const float* Eb = E + (size_t)b * D * M;
    const int c = centre ? centre[b] : 0;

    // the grid tables' lines into L1, independent of E: the tail reads them
    // once the top two are known
    for (int d = 32 * tid; d < D; d += 32 * kThreads) {
        prefetch_l1(hz + d);
        prefetch_l1(shifts + d);
        prefetch_l1(shifts_signed + d);
    }

    float dopp_idx, quality;
    if (sum_all) {
        Top2 t = top2_empty();
        const bool vec = (M & 3) == 0 && ((uintptr_t)E & 15) == 0;
        for (int i = tid; i < nd; i += kThreads) {
            const float* row = Eb + (size_t)(off + i) * M;
            float s = 0.f;
            if (vec) {
                for (int m = 0; m < M; m += 4) {
                    const float4 q = *reinterpret_cast<const float4*>(row + m);
                    s += q.x;
                    s += q.y;
                    s += q.z;
                    s += q.w;
                }
            } else {
                for (int m = 0; m < M; ++m) s += row[m];
            }
            top2_push(t, s, i);
        }
        t = warp_top2(t);
        if (lane == 0) wtop[warp] = t;
        if (off > 0 && tid == kThreads - 1) {  // the noise bin's mask sum
            float s = 0.f;
            for (int m = 0; m < M; ++m) s += Eb[m];
            noise_s = s;
        }
        __syncthreads();
        // each group of kWarps lanes holds the warps' top twos: three shuffle
        // steps give every lane of every warp the block's
        t = wtop[lane & (kWarps - 1)];
#pragma unroll
        for (int o = 1; o < kWarps; o <<= 1) {
            Top2 u;
            u.v0 = __shfl_xor_sync(0xffffffffu, t.v0, o);
            u.v1 = __shfl_xor_sync(0xffffffffu, t.v1, o);
            u.i0 = __shfl_xor_sync(0xffffffffu, t.i0, o);
            u.i1 = __shfl_xor_sync(0xffffffffu, t.i1, o);
            t = top2_merge(t, u);
        }
        top2_final(t);
        weigh(t, off, noise_s, dopp_idx, quality);
    } else {
        float si = 0.f, sq = 0.f;
        for (int r0 = 0; r0 < M; r0 += kRound) {
            const int r1 = min(r0 + kRound, M);
            for (int m = r0 + warp; m < r1; m += kWarps) {
                Top2 t = top2_empty();
                for (int i = lane; i < nd; i += 32) top2_push(t, Eb[(size_t)(off + i) * M + m], i);
                t = warp_top2(t);
                top2_final(t);
                if (lane == 0) weigh(t, off, Eb[m], r_idx[m - r0], r_qual[m - r0]);
            }
            __syncthreads();
            for (int m = r0; m < r1; ++m) {
                si = __fadd_rn(si, r_idx[m - r0]);
                sq = __fadd_rn(sq, r_qual[m - r0]);
            }
            if (r1 < M) __syncthreads();
        }
        dopp_idx = __fdiv_rn(si, (float)M);
        quality = __fdiv_rn(sq, (float)M);
    }

    // the tail, in every thread; the recentre and the window are taken mod N
    // first, so the band edges and the shift are 32-bit sums
    const float fl = floorf(dopp_idx);
    const int lo = min(max((int)fl, 0), D - 1);
    const int hi = min(max((int)ceilf(dopp_idx), 0), D - 1);
    const float frac = __fsub_rn(dopp_idx, fl);  // remainder(dopp_idx, 1), dopp_idx >= 0
    const int cm = c % N, wm = w % N;  // in (-N, N); the grid's shifts are in [0, N)
    // circular bands [a, a + span) of the signal and of its mirror
    const int a = wrap(shifts[lo] + cm - wm, N);
    const int span = wrap(shifts[hi] + cm + wm - a, N);
    const int a2 = wrap(a + N / 2, N);
    const float hz_lo = hz[lo], hz_hi = hz[hi];
    float dhz = __fadd_rn(hz_lo, __fmul_rn(__fsub_rn(hz_hi, hz_lo), frac));
    if (centre) dhz = __fadd_rn(dhz, __fmul_rn((float)c, bin_hz));
    const float sl = (float)shifts_signed[lo], sh = (float)shifts_signed[hi];
    const int shift = wrap((int)rintf(__fadd_rn(sl, __fmul_rn(__fsub_rn(sh, sl), frac))) + cm, N);
    float* o = sc + (size_t)b * sc_stride;
    if (tid == kThreads - 1) {  // all but the SNR, by a thread the band rarely reaches
        o[0] = dopp_idx;
        o[1] = __fmul_rn(10.f, log10f(quality));
        o[2] = dhz;
        o[3] = __fsub_rn(dhz, if_hz);
        o[5] = (float)shift;
        shift_out[b] = shift;
    }
    const float* Pb = P + (size_t)b * N;
    float s_sig = 0.f, s_noise = 0.f;
    for (int t = tid; t < span; t += kThreads) {
        int i = a + t;
        if (i >= N) i -= N;
        int j = a2 + t;
        if (j >= N) j -= N;
        s_sig += sqrtf(Pb[i]);
        s_noise += sqrtf(Pb[j]);
    }
    for (int o = 16; o > 0; o >>= 1) {
        s_sig += __shfl_xor_sync(0xffffffffu, s_sig, o);
        s_noise += __shfl_xor_sync(0xffffffffu, s_noise, o);
    }
    if (lane == 0) {
        red[0][warp] = s_sig;
        red[1][warp] = s_noise;
    }
    if (e_out) copy_row(e_out + (size_t)b * e_stride, Eb, D * M);
    __syncthreads();

    if (tid == 0) {
        float ss = 0.f, sn = 0.f;
        for (int k = 0; k < kWarps; ++k) {
            ss += red[0][k];
            sn += red[1][k];
        }
        const float cnt = (float)max(span, 1);
        const float ratio = __fsub_rn(__fdiv_rn(__fdiv_rn(ss, cnt), __fdiv_rn(sn, cnt)), 1.f);
        o[4] = ratio > 0.f ? __fmul_rn(20.f, log10f(ratio)) : -INFINITY;
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
    if (B <= 0 || N <= 0 || D <= 0 || M <= 0 || nd <= 0 || off < 0 || off + nd > D)
        return (int)cudaErrorInvalidValue;
    doppler_estimate<<<B, kThreads, 0, stream>>>(E, P, shifts, shifts_signed, hz, sc, sc_stride,
                                                 e_out, e_stride, shift_out, centre, N, D, M, nd,
                                                 off, sum_all, snr_window, if_hz, bin_hz);
    return (int)cudaGetLastError();
}
