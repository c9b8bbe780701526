// K4l symbol_detect_local and K4s shard_select: the symbol detector of
// the generic channel x dopp step, split in two around the all-gather of
// the dopp axis (the mask bank is sharded over it, Ml = M / nd masks a
// shard, the shard's first global mask m0).
//
// K4l, on each shard: for each slot x < numSymMax of block b, with
// spc = max(spSym, spsymMin):
//   A0 = trunc(x*spc - W/2 + codeOffset), A = clamp(A0, 0, N - W)
//   k  = argmax of colmax[A .. A+W) over the shard's masks (the earliest
//        sample wins ties; colmax/colargmax come from K2 over the shard)
//   val[x] = colmax[A + k], key[x] = k * M + (m0 + colargmax[A + k]).
// Replaces pycusdr_tpu/parallel/sharded_demod.py:_local_find_centres
// (:46-104: sliding_window_argmax, the f32-packed payload and the one-hot
// or gather row select existed to avoid a TPU gather; one thread per slot
// reads its W samples directly, as K4 does).
//
// K4s, after the (nd, B, S) values and keys are gathered: the largest
// value wins, and among equal values the smallest key (the earliest
// sample, then the lowest global mask), as the single-chip argmax orders
// them (sharded_demod.py:361-376). symbol = g mod M, k = g div M,
// mag = the value, centre = trunc(x*spc - W/2 + k) + trunc(codeOffset) -
// min(A0, 0); then the tail of sharded_demod.py:378-411 into the packed
// row: trust = trust_normal for x < nSym and -1 beyond, bit =
// bitLUT[symbol] (0 for NRZ-S: K4n runs after it), trust -2 when a clip
// bitmask is given and a hit lies in [j - hw, j + hw] around the winning
// sample j = A + k, hw = clamp(2*ceil(spc), 0, hw_max); the scalars nSym,
// nBits = nSym, spSym, codeOffset, code_val and clipped_any.
//
// At nd = 1 (one shard, m0 = 0) K4l then K4s give K4's symbols, centres,
// mags and bits bit for bit: the same slot arithmetic and scan, and a
// select over one candidate. Their trust differs beyond nSym: JAX's
// generic step writes -1 there and the block graph trust_normal.
//
// Bound: K4l reads the W-sample windows (at most N samples) and one
// colargmax word per slot and writes 8 bytes a slot (~0.2 MB per flagship
// block); K4s reads 8 nd bytes and writes 20 bytes a slot (~0.2 MB at
// nd = 2). Both are far below a microsecond of HBM time: the launch
// bounds them. The slot arithmetic must round as JAX's separate f32
// multiply and add do, so it is spelled with __f*_rn (no FMA contraction
// moves a truncation boundary).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
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

struct Slot {
    float xs;  // x*spc - W/2
    int A0, A;
};

__device__ __forceinline__ Slot slot_geometry(int x, float spc, float co, int N, int W) {
    Slot s;
    s.xs = __fsub_rn(__fmul_rn((float)x, spc), (float)(W / 2));
    s.A0 = (int)truncf(__fadd_rn(s.xs, co));
    s.A = min(max(s.A0, 0), max(N - W, 0));
    return s;
}

__global__ void __launch_bounds__(kThreads)
symbol_detect_local(const float* __restrict__ colmax, const int* __restrict__ colarg,
                    const float* __restrict__ spSym, const float* __restrict__ codeOffset,
                    float* __restrict__ val, int* __restrict__ key, int N, int W, int spsymMin,
                    int S, int M, int m0) {
    const int b = blockIdx.y;
    const int x = blockIdx.x * kThreads + threadIdx.x;
    if (x >= S) return;
    const float spc = fmaxf(spSym[b], (float)spsymMin);
    const Slot g = slot_geometry(x, spc, codeOffset[b], N, W);
    const float* v = colmax + (size_t)b * N + g.A;
    float best = v[0];
    int k = 0;
    for (int i = 1; i < W; ++i) {
        const float vi = v[i];
        if (vi > best) {  // strict: the earliest sample wins ties
            best = vi;
            k = i;
        }
    }
    const size_t o = (size_t)b * S + x;
    val[o] = best;
    key[o] = k * M + m0 + colarg[(size_t)b * N + g.A + k];
}

__global__ void __launch_bounds__(kThreads)
shard_select(const float* __restrict__ vals, const int* __restrict__ keys, int nd,
             const float* __restrict__ spSym, const float* __restrict__ codeOffset,
             const int8_t* __restrict__ bitLUT, const unsigned* __restrict__ hits,
             const float* __restrict__ code_val, const int* __restrict__ clipped_any,
             float* __restrict__ row, int L, int B, int N, int W, int spsymMin, int S, int M,
             int trust_normal, int hw_max) {
    const int b = blockIdx.y;
    const int x = blockIdx.x * kThreads + threadIdx.x;
    const float spc = fmaxf(spSym[b], (float)spsymMin);
    const float co = codeOffset[b];
    const int ns = (int)__fdiv_rn((float)N, spc);
    float* r = row + (size_t)b * L;
    if (x == 0) {
        float* sc = r + 5 * (size_t)S;
        sc[0] = (float)ns;
        sc[1] = (float)ns;
        sc[2] = spSym[b];
        sc[3] = co;
        sc[4] = code_val[b];
        sc[11] = clipped_any && clipped_any[b] ? 1.f : 0.f;
    }
    if (x >= S) return;

    const size_t o = (size_t)b * S + x, stride = (size_t)B * S;
    float best = vals[o];
    int gk = keys[o];
    for (int d = 1; d < nd; ++d) {
        const float v = vals[d * stride + o];
        const int k = keys[d * stride + o];
        if (v > best || (v == best && k < gk)) {
            best = v;
            gk = k;
        }
    }
    const int sym = gk % M, k = gk / M;
    const Slot g = slot_geometry(x, spc, co, N, W);
    const int centre = (int)truncf(__fadd_rn(g.xs, (float)k)) + (int)truncf(co) - min(g.A0, 0);
    int8_t tr = x < ns ? (int8_t)trust_normal : (int8_t)-1;
    if (hits) {
        const int j = min(max(g.A + k, 0), N - 1);
        const int hw = min(max(2 * (int)ceilf(spc), 0), hw_max);
        if (any_hit(hits + (size_t)b * ((N + 31) / 32), max(j - hw, 0), min(j + hw, N - 1)))
            tr = kTrustClipped;
    }
    r[x] = bitLUT ? (float)bitLUT[sym] : 0.f;
    r[S + x] = (float)tr;
    r[2 * (size_t)S + x] = (float)sym;
    r[3 * (size_t)S + x] = (float)centre;
    r[4 * (size_t)S + x] = best;
}

}  // namespace

// colmax, colargmax: (B, N) over the shard's masks; spSym, codeOffset: (B,)
// f32; val: (B, S) f32 and key: (B, S) i32 out.
PYCUSDR_API int pycusdr_symbol_detect_local(const float* colmax, const int* colargmax,
                                            const float* spSym, const float* codeOffset,
                                            float* val, int* key, int B, int N, int W,
                                            int spsymMin, int S, int M, int m0,
                                            cudaStream_t stream) {
    if (B <= 0 || N <= 0 || W <= 0 || W > N || S <= 0 || M <= 0 || m0 < 0 || m0 >= M)
        return (int)cudaErrorInvalidValue;
    symbol_detect_local<<<dim3((S + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
        colmax, colargmax, spSym, codeOffset, val, key, N, W, spsymMin, S, M, m0);
    return (int)cudaGetLastError();
}

// vals: (nd, B, S) f32 and keys: (nd, B, S) i32 from K4l on every shard;
// spSym, codeOffset, code_val: (B,) f32; bitLUT: (M,) int8 or NULL (bits
// 0); hits: (B, ceil(N/32)) u32 or NULL; clipped_any: (B,) i32 or NULL (0);
// row: (B, L) f32 packed rows, L >= 5 S + 12.
PYCUSDR_API int pycusdr_shard_select(const float* vals, const int* keys, int nd,
                                     const float* spSym, const float* codeOffset,
                                     const int8_t* bitLUT, const unsigned* hits,
                                     const float* code_val, const int* clipped_any, float* row,
                                     int L, int B, int N, int W, int spsymMin, int S, int M,
                                     int trust_normal, int hw_max, cudaStream_t stream) {
    if (nd <= 0 || B <= 0 || N <= 0 || W <= 0 || W > N || S <= 0 || M <= 0 ||
        L < 5 * S + 12 || !code_val || !row)
        return (int)cudaErrorInvalidValue;
    shard_select<<<dim3((S + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
        vals, keys, nd, spSym, codeOffset, bitLUT, hits, code_val, clipped_any, row, L, B, N, W,
        spsymMin, S, M, trust_normal, hw_max);
    return (int)cudaGetLastError();
}
