// K4 symbol_detect: windowed symbol detection, bit mapping and trust;
// K4n nrzs_bits: NRZ-S bit extraction from K4's symbols (BPSK).
//
// For each slot x < numSymMax of block b, with spc = max(spSym, spsymMin):
//   A0 = trunc(x*spc - W/2 + codeOffset), A = clamp(A0, 0, N - W)
//   j  = argmax of colmax[A .. A+W) (the earliest sample wins ties)
//   symbol = colargmax[j], mag = colmax[j], bit = bitLUT[symbol] (0 when
//            the protocol has no centre-bit LUT: K4n writes the bits),
//   centre = trunc(x*spc - W/2 + (j - A)) + trunc(codeOffset) - min(A0, 0),
//   trust  = trust_normal, or -2 when a clip bitmask is given and a hit
//            lies in [j - hw, j + hw], hw = clamp(2*ceil(spc), 0, hw_max);
//   nSym = trunc(N / spc)
//
// Replaces pycusdr_tpu/ops/demod_kernels.py:find_centres (:425-584, with
// sliding_window_argmax :246, _window_scan_tree :143, _window_scan_vanherk
// :202, _blockscan_pack :296, _select_rows_onehot :332 and
// _select_rows_grouped :377), extract_bits_lut (:587-594),
// dilate_mask_dynamic (:622-648) and the trust fill of
// dsp/block.py:296-331. Every TPU route (window trees, van Herk scans,
// one-hot MXU row selects, f32-packed payloads, the prefix-count
// dilation of the whole clip mask) existed to avoid a gather; here one
// thread per slot reads its W samples directly, and tests the dilated
// clip window only where it is sampled: the OR of the <= 2*hw_max/32 + 2
// bitmask words around its winning sample.
//
// Output: typed arrays, or (row != NULL) f32 straight into the packed row
// (b * L): bits, trust, symbols, centres, mags at 0, S, .., 4S, and the
// scalars nSym, nBits, spSym, codeOffset, code_val, clipped_any at 5S + 0,
// 1, 2, 3, 4 and 11 (PACK_SCALARS order).
//
// Bound: ~7 x 4608 scattered 4-byte reads and 18 bytes written per slot
// (~0.2 MB per flagship block): far below a microsecond, so the launch
// bounds it. The slot arithmetic must round exactly as JAX's separate
// f32 multiply and add do: nvcc would contract a*b+c into one FMA and
// move a truncation boundary, so it is spelled with __f*_rn.
//
// K4n, for protocols without a centre-bit LUT (NRZ-S, bench_BPSK): bit i
// is the (symbol[i], symbol[i+1 mod S]) transition looked up in the (M, 2,
// K) symbol LUT: 1 when symbol[i+1] is one of lut[symbol[i]][0], 0 when it
// is one of lut[symbol[i]][1], else 0 with trust -1 (a -2 from the clip
// window stays); nBits = nSym - 1. It replaces
// pycusdr_tpu/ops/demod_kernels.py:extract_bits_nrzs (:597-619; its one-hot
// (n, M) x (M, K) matmul avoided a gather on the TPU) and the trust and
// nBits lines of dsp/block.py:318-331. bit i needs symbol i+1, which
// another K4 thread finds, so it is a second launch over K4's row: one
// thread per slot, the LUT (<= 16 x 2 x 4 words) in shared memory. The
// roll wraps slot S-1 onto slot 0 over the padded slots too, as jnp.roll
// does. Bound: 4 bytes read and 8 written per slot (~55 KB per flagship
// block), so the launch bounds it.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNrzsThreads = 256;
constexpr int8_t kTrustClipped = -2;

// Any bit of [lo, hi] (inclusive sample indices) set in the bitmask w?
__device__ bool any_hit(const unsigned* __restrict__ w, int lo, int hi) {
    const int w0 = lo >> 5, w1 = hi >> 5;
    for (int i = w0; i <= w1; ++i) {
        unsigned m = w[i];
        if (i == w0) m &= 0xffffffffu << (lo & 31);
        if (i == w1) m &= 0xffffffffu >> (31 - (hi & 31));
        if (m) return true;
    }
    return false;
}

__global__ void __launch_bounds__(kThreads)
symbol_detect(const float* __restrict__ colmax, const int* __restrict__ colarg,
              const float* __restrict__ spSym, const float* __restrict__ codeOffset,
              const int8_t* __restrict__ bitLUT, const unsigned* __restrict__ hits,
              const float* __restrict__ code_val, const int* __restrict__ clipped_any,
              int* __restrict__ symbols, int* __restrict__ centres, float* __restrict__ mags,
              int8_t* __restrict__ bits, int8_t* __restrict__ trust, int* __restrict__ nSym,
              float* __restrict__ row, int L, int N, int W, int spsymMin, int S,
              int trust_normal, int hw_max) {
    const int b = blockIdx.y;
    const int x = blockIdx.x * kThreads + threadIdx.x;
    const float spc = fmaxf(spSym[b], (float)spsymMin);
    const float co = codeOffset[b];
    float* r = row ? row + (size_t)b * L : nullptr;
    if (x == 0) {
        const int ns = (int)__fdiv_rn((float)N, spc);
        if (r) {
            float* sc = r + 5 * (size_t)S;
            sc[0] = (float)ns;
            sc[1] = (float)ns;
            sc[2] = spSym[b];
            sc[3] = co;
            sc[4] = code_val[b];
            sc[11] = clipped_any && clipped_any[b] ? 1.f : 0.f;
        } else {
            nSym[b] = ns;
        }
    }
    if (x >= S) return;

    const float xs = __fsub_rn(__fmul_rn((float)x, spc), (float)(W / 2));
    const int A0 = (int)truncf(__fadd_rn(xs, co));
    const int comp = (int)truncf(co) - min(A0, 0);
    const int A = min(max(A0, 0), max(N - W, 0));

    const float* v = colmax + (size_t)b * N + A;
    float best = v[0];
    int k = 0;
    for (int i = 1; i < W; ++i) {
        const float vi = v[i];
        if (vi > best) {  // strict: the earliest sample wins ties
            best = vi;
            k = i;
        }
    }
    const int j = A + k;
    const int sym = colarg[(size_t)b * N + j];
    const int centre = (int)truncf(__fadd_rn(xs, (float)k)) + comp;
    int8_t tr = (int8_t)trust_normal;
    if (hits) {
        const int hw = min(max(2 * (int)ceilf(spc), 0), hw_max);
        if (any_hit(hits + (size_t)b * (N / 32), max(j - hw, 0), min(j + hw, N - 1)))
            tr = kTrustClipped;
    }
    if (r) {
        r[x] = bitLUT ? (float)bitLUT[sym] : 0.f;
        r[S + x] = (float)tr;
        r[2 * (size_t)S + x] = (float)sym;
        r[3 * (size_t)S + x] = (float)centre;
        r[4 * (size_t)S + x] = best;
    } else {
        const size_t o = (size_t)b * S + x;
        symbols[o] = sym;
        mags[o] = best;
        centres[o] = centre;
        bits[o] = bitLUT ? bitLUT[sym] : (int8_t)0;
        trust[o] = tr;
    }
}

__global__ void __launch_bounds__(kNrzsThreads)
nrzs_bits(float* __restrict__ row, const int* __restrict__ lut, int L, int S, int M, int K) {
    extern __shared__ int tab[];  // (M, 2, K)
    for (int i = threadIdx.x; i < M * 2 * K; i += kNrzsThreads) tab[i] = lut[i];
    __syncthreads();
    float* r = row + (size_t)blockIdx.y * L;
    const int x = blockIdx.x * kNrzsThreads + threadIdx.x;
    if (x == 0) r[5 * (size_t)S + 1] = r[5 * (size_t)S] - 1.f;  // nBits = nSym - 1
    if (x >= S) return;
    const int prev = (int)r[2 * (size_t)S + x];
    const int next = (int)r[2 * (size_t)S + (x + 1 == S ? 0 : x + 1)];
    bool one = false, zero = false;
    if (prev >= 0 && prev < M) {
        const int* t = tab + prev * 2 * K;
        for (int k = 0; k < K; ++k) {
            one |= t[k] == next;
            zero |= t[K + k] == next;
        }
    } else {  // JAX's one-hot select gives all-zero tables here
        one = zero = next == 0;
    }
    const bool err = !(one || zero);
    r[x] = (!err && one) ? 1.f : 0.f;
    if (err && r[S + x] != (float)kTrustClipped) r[S + x] = -1.f;
}

}  // namespace

// colmax, colargmax: (B, N); spSym, codeOffset: (B,) f32; bitLUT: (M,) int8
// or NULL (bits 0);
// hits: (B, N/32) u32 or NULL; code_val: (B,) f32 (read only with a row);
// clipped_any: (B,) i32 or NULL (0). Either the typed outputs symbols,
// centres: (B, S) i32; mags: (B, S) f32; bits, trust: (B, S) int8; nSym:
// (B,) i32 -- or row: (B, L) f32, L >= 5 S + 12, with the typed pointers NULL.
PYCUSDR_API int pycusdr_symbol_detect(const float* colmax, const int* colargmax,
                                      const float* spSym, const float* codeOffset,
                                      const int8_t* bitLUT, const unsigned* hits,
                                      const float* code_val, const int* clipped_any,
                                      int* symbols, int* centres, float* mags, int8_t* bits,
                                      int8_t* trust, int* nSym, float* row, int L, int B,
                                      int N, int W, int spsymMin, int S, int trust_normal,
                                      int hw_max, cudaStream_t stream) {
    if (B <= 0 || N <= 0 || W <= 0 || W > N || S <= 0 || (hits && N % 32))
        return (int)cudaErrorInvalidValue;
    if (row ? (L < 5 * S + 12 || !code_val)
            : (!symbols || !centres || !mags || !bits || !trust || !nSym))
        return (int)cudaErrorInvalidValue;
    symbol_detect<<<dim3((S + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
        colmax, colargmax, spSym, codeOffset, bitLUT, hits, code_val, clipped_any, symbols,
        centres, mags, bits, trust, nSym, row, L, N, W, spsymMin, S, trust_normal, hw_max);
    return (int)cudaGetLastError();
}

// row: (B, L) f32 packed rows that K4 wrote (L >= 5 S + 12), updated in
// place; lut: (M, 2, K) int32.
PYCUSDR_API int pycusdr_nrzs_bits(float* row, const int* lut, int L, int B, int S, int M,
                                  int K, cudaStream_t stream) {
    const size_t smem = (size_t)M * 2 * K * sizeof(int);
    if (B <= 0 || S <= 0 || M <= 0 || K <= 0 || L < 5 * S + 12 || smem > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    nrzs_bits<<<dim3((S + kNrzsThreads - 1) / kNrzsThreads, B), kNrzsThreads, smem, stream>>>(
        row, lut, L, S, M, K);
    return (int)cudaGetLastError();
}
