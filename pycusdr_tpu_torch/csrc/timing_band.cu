// K3 timing_band: symbol-rate and timing estimate from the mask-summed
// matched-filter power of one block.
//
//   R[k]   = sum_n x[b, n] * exp(-2πi kn/N),  k in [lo, hi)
//   k*     = argmax_k |R[k]|^2 (first index on ties)
//   spSym  = N / k*, codeOffset = -atan2(R[k*]) / π * spSym / 2,
//            wrapped by + spSym - 1 when negative; code_val = |R[k*]|^2
//
// Replaces pycusdr_tpu/ops/cfft.py:band_dft_real (:440-473) with
// ops/demod_kernels.py:find_code_rate_and_phase_from_power (:106-124).
// Like the JAX op it is an output-pruned four-step transform, shaped for
// the SM instead of the matrix unit. With N = N1 N2, x[N2 a + c] and
// k = k1 + N1 k2:
//
//   A[k1, c] = exp(-2πi c k1 / N) sum_a x[N2 a + c] exp(-2πi a k1 / N1)
//   R[k]     = sum_c exp(-2πi c k2 / N2) A[k mod N1, c]
//
// Pass 1 (band_partial), one block per (b, group of `chunks` tiles of cw
// adjacent columns c): for each tile it loads N1 rows of cw floats
// (coalesced), packs columns 2p and 2p+1 as the real and imaginary parts
// of one complex row, runs the cw/2 row transforms in shared memory with
// the register-radix Stockham passes of fft_smem.cuh (half the transform
// work of real rows), splits each row into its two columns' spectra by
// conjugate symmetry, applies the twiddle exp(-2πi c k1 / N) (two staged
// tables; above N = 2^18 the float64-built table in global memory), and
// adds the tile's share of every band bin, nb * cw multiply-adds, to the
// group's partial in column order (kept in registers across the group's
// tiles up to 2048 bins, in device memory for a wider band, as at N >
// 2^18 where the band grows with N). The stage-2
// twiddle comes from the float64-built table, one address per warp for
// most lanes. (At N <= 512 a tile is one column, transformed unpacked.)
// Pass 2 (band_argmax), one block per b: adds the groups' partials of
// each bin in group order, takes the argmax and the scalar tail in the
// same f32 operation order as the JAX op (__f*_rn: no contraction).
// No float atomics: the plan (N1, cw, groups) depends on N alone, so a
// block gives the same bits in any batch and any run.
// Bound: the function needs one real FFT's work (2.5 N log2 N, ~2.6 MFLOP
// per flagship block) on 256 KB of input, so HBM bytes bound it; this
// design does N log2 N1 column work plus nb N2 band work per block and
// moves the input once and groups x nb partials twice.
#include "fft_smem.cuh"

namespace {

using pycusdr::kFftEPT;
using pycusdr::kFftThreads;
constexpr int kMaxCw = 4;         // columns of a tile
constexpr int kMaxGroups = 16;    // band_partial blocks per batch row
constexpr int kArgThreads = 1024;
constexpr int kBinsReg = 8;  // band bins a thread keeps in registers across the tiles
constexpr int kMinBlocks = 3;  // band_partial blocks per SM (registers: 65536 / (256 x this))

// acc plus bin k's share of the tile's cw columns c0.. (spectra A[cc][k1],
// twiddled), in column order: acc + sum_cc exp(-2πi c k2 / N2) A[cc][k mod N1]
__device__ __forceinline__ float2 tile_bin(const float2* buf, const float2* __restrict__ tw,
                                           float2 acc, int k, int c0, int cw, int pitch,
                                           int logN1, int N2) {
    const int k1 = k & ((1 << logN1) - 1), k2 = k >> logN1;
    float2 w[kMaxCw];
#pragma unroll
    for (int cc = 0; cc < kMaxCw; ++cc)
        if (cc < cw)  // unsigned: c k2 passes 2^31 where N2 does 2^16; the low bits hold
            w[cc] = __ldg(&tw[(((unsigned)(c0 + cc) * (unsigned)k2) & (N2 - 1)) << logN1]);
#pragma unroll
    for (int cc = 0; cc < kMaxCw; ++cc)
        if (cc < cw)
            acc = pycusdr::cadd(acc, pycusdr::cmul(pycusdr::conjf2(w[cc]),
                                                   buf[cc * pitch + pycusdr::fft_pad(k1)]));
    return acc;
}

__global__ void __launch_bounds__(kFftThreads, kMinBlocks)
band_partial(const float* __restrict__ x, const float2* __restrict__ tw,
             float2* __restrict__ part, int logN, int lo, int nb, int logN1, int logCw,
             int chunks) {
    extern __shared__ float2 smem[];
    const pycusdr::FftSmem sm = pycusdr::fft_smem(smem, logN, tw);
    float2* buf = sm.buf;
    const int g = blockIdx.x, b = blockIdx.y, G = gridDim.x;
    const int N1 = 1 << logN1, logN2 = logN - logN1, N2 = 1 << logN2, cw = 1 << logCw;
    const int pitch = pycusdr::fft_pitch(N1), tile = N1 << logCw;
    const int packed = cw > 1;  // two real columns in one complex row
    const bool inreg = nb <= kBinsReg * kFftThreads;  // the partial stays in registers
    float2 acc[kBinsReg];
#pragma unroll
    for (int q = 0; q < kBinsReg; ++q) acc[q] = make_float2(0.f, 0.f);
    pycusdr::fft_stage_twiddles(sm, tw, logN1, logN);
    const float* xb = x + ((size_t)b << logN);
    float2* pb = part + ((size_t)b * G + g) * nb;
    for (int ch = 0; ch < chunks; ++ch) {
        const int c0 = (g * chunks + ch) << logCw;
        // pack: row p holds columns 2p (real part) and 2p+1 (imaginary part)
        float xv[kFftEPT];  // every load in flight before the first store
#pragma unroll
        for (int t = 0; t < kFftEPT; ++t) {
            const int e = threadIdx.x + t * kFftThreads;
            xv[t] = e < tile ? xb[((e >> logCw) << logN2) + c0 + (e & (cw - 1))] : 0.f;
        }
#pragma unroll
        for (int t = 0; t < kFftEPT; ++t) {
            const int e = threadIdx.x + t * kFftThreads;
            const int cc = e & (cw - 1);
            if (e < tile) {
                float2& z = buf[(cc >> packed) * pitch + pycusdr::fft_pad(e >> logCw)];
                if (!packed) z = make_float2(xv[t], 0.f);
                else if (cc & 1) z.y = xv[t];
                else z.x = xv[t];
            }
        }
        __syncthreads();
        pycusdr::fft_rows<-1>(buf, cw >> packed, logN1, pitch, sm.twL);
        if (packed) {
            // unpack Z_p into A_2p = (Z[k1] + conj Z[-k1]) / 2 and
            // A_2p+1 = (Z[k1] - conj Z[-k1]) / 2i, each times exp(-2πi c k1 / N)
            float2 zk[kFftEPT / 2], zm[kFftEPT / 2];
#pragma unroll
            for (int t = 0; t < kFftEPT / 2; ++t) {
                const int e = threadIdx.x + t * kFftThreads;
                if (e < tile / 2) {
                    const float2* row = buf + (e >> logN1) * pitch;
                    const int k1 = e & (N1 - 1);
                    zk[t] = row[pycusdr::fft_pad(k1)];
                    zm[t] = row[pycusdr::fft_pad((N1 - k1) & (N1 - 1))];
                }
            }
            __syncthreads();
#pragma unroll
            for (int t = 0; t < kFftEPT / 2; ++t) {
                const int e = threadIdx.x + t * kFftThreads;
                if (e < tile / 2) {
                    const int p = e >> logN1, k1 = e & (N1 - 1), c = c0 + 2 * p;
                    const float2 a0 = make_float2(0.5f * (zk[t].x + zm[t].x),
                                                  0.5f * (zk[t].y - zm[t].y));
                    const float2 a1 = make_float2(0.5f * (zk[t].y + zm[t].y),
                                                  0.5f * (zm[t].x - zk[t].x));
                    buf[2 * p * pitch + pycusdr::fft_pad(k1)] =
                        pycusdr::cmul(a0, pycusdr::fft_twiddle<-1>(sm, c * k1));
                    buf[(2 * p + 1) * pitch + pycusdr::fft_pad(k1)] =
                        pycusdr::cmul(a1, pycusdr::fft_twiddle<-1>(sm, (c + 1) * k1));
                }
            }
        } else {
#pragma unroll
            for (int t = 0; t < kFftEPT; ++t) {
                const int e = threadIdx.x + t * kFftThreads;
                if (e < tile) {
                    const int cc = e >> logN1, k1 = e & (N1 - 1);
                    float2& v = buf[cc * pitch + pycusdr::fft_pad(k1)];
                    v = pycusdr::cmul(v, pycusdr::fft_twiddle<-1>(sm, (c0 + cc) * k1));
                }
            }
        }
        __syncthreads();
        if (inreg) {
#pragma unroll
            for (int q = 0; q < kBinsReg; ++q) {
                const int j = threadIdx.x + q * kFftThreads;
                if (j < nb) acc[q] = tile_bin(buf, tw, acc[q], lo + j, c0, cw, pitch, logN1, N2);
            }
        } else {  // a band wider than kBinsReg bins a thread: the partial lives in HBM
            for (int j = threadIdx.x; j < nb; j += kFftThreads)
                pb[j] = tile_bin(buf, tw, ch ? pb[j] : make_float2(0.f, 0.f), lo + j, c0, cw,
                                 pitch, logN1, N2);
        }
        __syncthreads();  // buf is reloaded for the next tile
    }
    if (inreg) {
#pragma unroll
        for (int q = 0; q < kBinsReg; ++q) {
            const int j = threadIdx.x + q * kFftThreads;
            if (j < nb) pb[j] = acc[q];
        }
    }
}

// bin j of block b: the groups' partials (all loaded at once) added in group order
__device__ __forceinline__ float2 band_bin(const float2* __restrict__ pb, int G, int nb, int j) {
    float2 v[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
        if (g < G) v[g] = pb[(size_t)g * nb + j];
    float2 s = v[0];
#pragma unroll
    for (int g = 1; g < kMaxGroups; ++g)
        if (g < G) s = pycusdr::cadd(s, v[g]);
    return s;
}

__device__ __forceinline__ void take_better(float& best, int& bi, float ob, int oi) {
    if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
    }
}

__global__ void __launch_bounds__(kArgThreads)
band_argmax(const float2* __restrict__ part, float* __restrict__ spSym,
            float* __restrict__ codeOffset, float* __restrict__ code_val, int N, int lo,
            int nbins, int G) {
    const int b = blockIdx.x;
    const float2* pb = part + (size_t)b * G * nbins;
    float best = -1.f;
    int bi = nbins;
    for (int j = threadIdx.x; j < nbins; j += kArgThreads) {
        const float2 v = band_bin(pb, G, nbins, j);
        const float p = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
        if (p > best) {  // j rises per thread: the first index is kept
            best = p;
            bi = j;
        }
    }
    for (int o = 16; o > 0; o >>= 1)
        take_better(best, bi, __shfl_down_sync(0xffffffffu, best, o),
                    __shfl_down_sync(0xffffffffu, bi, o));
    __shared__ float wbest[kArgThreads / 32];
    __shared__ int wbi[kArgThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        wbest[warp] = best;
        wbi[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kArgThreads / 32; ++w) take_better(best, bi, wbest[w], wbi[w]);
        if (bi >= nbins) bi = 0;  // NaN band: keep the first bin
        const float2 v = band_bin(pb, G, nbins, bi);
        const float phase = atan2f(v.y, v.x);
        const float sp = __fdiv_rn((float)N, (float)(lo + bi));
        float co = __fdiv_rn(__fmul_rn(__fdiv_rn(-phase, 3.14159265358979f), sp), 2.0f);
        if (co < 0.f) co = __fsub_rn(__fadd_rn(co, sp), 1.0f);
        spSym[b] = sp;
        codeOffset[b] = co;
        code_val[b] = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
    }
}

int ilog2_exact(int v) {
    if (v <= 0 || (v & (v - 1))) return -1;
    int l = 0;
    while ((1 << l) < v) ++l;
    return l;
}

}  // namespace

// tw: (N,) exp(+2πi j/N); part: (B, groups, hi - lo) complex scratch; spSym,
// codeOffset, code_val: (B,) f32. The plan n1, cw, groups is
// ops/demod_kernels.py:timing_band_plan's.
PYCUSDR_API int pycusdr_timing_band(const float* x, const float2* tw, float2* part,
                                    float* spSym, float* codeOffset, float* code_val, int B,
                                    int N, int lo, int hi, int n1, int cw, int groups,
                                    cudaStream_t stream) {
    const int logN = ilog2_exact(N), logN1 = ilog2_exact(n1), logCw = ilog2_exact(cw);
    if (B <= 0 || logN < 2 || lo < 0 || hi <= lo || hi > N / 2 + 1 || logN1 < 1 ||
        n1 > pycusdr::kFftMaxL || logN1 > logN || logCw < 0 || groups <= 0)
        return (int)cudaErrorInvalidValue;
    const int tiles = (N / n1) / cw;
    if (tiles <= 0 || tiles % groups || groups > kMaxGroups || cw > kMaxCw ||
        n1 * cw > pycusdr::kFftElems)
        return (int)cudaErrorInvalidValue;
    const int nbins = hi - lo;
    static unsigned long long smem_set = 0;
    const cudaError_t e = pycusdr::fft_allow_smem(band_partial, smem_set);
    if (e != cudaSuccess) return (int)e;
    band_partial<<<dim3(groups, B), kFftThreads, pycusdr::kFftSmemBytes, stream>>>(
        x, tw, part, logN, lo, nbins, logN1, logCw, tiles / groups);
    band_argmax<<<B, kArgThreads, 0, stream>>>(part, spSym, codeOffset, code_val, N, lo, nbins,
                                               groups);
    return (int)cudaGetLastError();
}
