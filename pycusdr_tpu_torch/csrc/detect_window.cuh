// The symbol detector's window reader, shared by K4 (symbol_detect.cu) and
// K4l and K4s (shard_select.cu): the slot arithmetic, the scan of a slot's
// W-sample window of colmax (and colargmax), and the clip-window test on
// K6's hit bitmask. Each .cu file gets its own copy (internal linkage), as
// when the code lived in each file.
//
// The slot arithmetic must round exactly as JAX's separate f32 multiply and
// add do: nvcc would contract a*b+c into one FMA and move a truncation
// boundary, so it is spelled with __f*_rn.
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxChunkW = 9;  // windows up to this wide take 3 chunks at most
constexpr int kRegWords = 4;   // clip words a slot holds in registers
constexpr int8_t kTrustClipped = -2;

// Any bit of [lo, hi] (inclusive sample indices) set in the bitmask w?
__device__ bool any_hit(const unsigned* __restrict__ w, int lo, int hi) {
    const int w0 = lo >> 5, w1 = hi >> 5;
    for (int i = w0; i <= w1; ++i) {
        unsigned m = __ldg(w + i);
        if (i == w0) m &= 0xffffffffu << (lo & 31);
        if (i == w1) m &= 0xffffffffu >> (31 - (hi & 31));
        if (m) return true;
    }
    return false;
}

// Slot x's x * spc - W / 2 (JAX's separate f32 multiply and add, each
// rounded); the window's unclamped start is A0 = trunc(that + codeOffset).
__device__ __forceinline__ float slot_xs(int x, float spc, int W) {
    return __fsub_rn(__fmul_rn((float)x, spc), (float)(W / 2));
}

// The maximum of the window cm[a .. a + W): its value, its offset k (the
// earliest sample wins ties) and, with kArgWin, ca at it (else 0: the
// caller reads ca[a + k] once every slot's window is in). kVec: read as the
// (at most 3) 16-byte chunks that cover it (W <= kMaxChunkW, rows 16-byte
// aligned), else sample by sample.
template <bool kArgWin, bool kVec>
__device__ __forceinline__ void window_max(const float* __restrict__ cm,
                                           const int* __restrict__ ca, int a, int W,
                                           float& best, int& sym, int& k) {
    float bst = -INFINITY;
    int sy = 0, kk = -1;
    if (kVec) {
        const int q0 = a >> 2, q1 = (a + W - 1) >> 2;
        const float4* v4 = reinterpret_cast<const float4*>(cm);
        const int4* g4 = reinterpret_cast<const int4*>(ca);
#pragma unroll
        for (int qq = 0; qq < 3; ++qq) {
            const int q = q0 + qq;
            if (q > q1) break;
            const float4 f = __ldg(v4 + q);
            int4 g = make_int4(0, 0, 0, 0);
            if (kArgWin) g = __ldg(g4 + q);
            const float fv[4] = {f.x, f.y, f.z, f.w};
            const int gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // strict: the earliest sample wins ties
                const int i = 4 * q + e - a;
                const bool up = i >= 0 && i < W && (kk < 0 || fv[e] > bst);
                bst = up ? fv[e] : bst;
                sy = up ? gv[e] : sy;
                kk = up ? i : kk;
            }
        }
    } else {
#pragma unroll 4
        for (int i = 0; i < W; ++i) {
            const float vi = __ldg(cm + a + i);
            const int gi = kArgWin ? __ldg(ca + a + i) : 0;
            const bool up = i == 0 || vi > bst;
            bst = up ? vi : bst;
            sy = up ? gi : sy;
            kk = up ? i : kk;
        }
    }
    best = bst;
    sym = sy;
    k = kk;
}

// The clip words that cover [a - hw, a + W - 1 + hw] (every j - hw .. j + hw
// with j in the window) into wd, read with the window: they depend on a
// alone. Returns the first word's index, or -1 when more than kRegWords
// words cover it (hw near its clamp): then clip_hit tests global memory.
__device__ __forceinline__ int clip_words(const unsigned* __restrict__ hrow, int a, int W,
                                          int hw, int N, unsigned (&wd)[kRegWords]) {
    const int wlo = max(a - hw, 0) >> 5;
    const int nw = (min(a + W - 1 + hw, N - 1) >> 5) - wlo + 1;
#pragma unroll
    for (int u = 0; u < kRegWords; ++u)
        wd[u] = u < nw && nw <= kRegWords ? __ldg(hrow + wlo + u) : 0u;
    return nw > kRegWords ? -1 : wlo;
}

// A hit in [j - hw, j + hw] (clamped to the row), from clip_words' registers,
// or from global memory when it returned -1.
__device__ __forceinline__ bool clip_hit(const unsigned* __restrict__ hrow,
                                         const unsigned (&wd)[kRegWords], int wlo, int j, int hw,
                                         int N) {
    const int lo = max(j - hw, 0), hi = min(j + hw, N - 1);
    if (wlo < 0) return any_hit(hrow, lo, hi);
    bool hit = false;
#pragma unroll
    for (int u = 0; u < kRegWords; ++u) {
        const int wi = wlo + u;
        unsigned m = wi < (lo >> 5) || wi > (hi >> 5) ? 0u : wd[u];
        if (wi == (lo >> 5)) m &= 0xffffffffu << (lo & 31);
        if (wi == (hi >> 5)) m &= 0xffffffffu >> (31 - (hi & 31));
        hit |= m != 0;
    }
    return hit;
}

// Whether symbol next follows symbol prev in the (lutM, 2, lutK) NRZ-S LUT
// (read through L1, any size): *bit 1 when next is one of lut[prev][0], 0
// when it is one of lut[prev][1]; returns false (an error, bit 0) when it is
// neither. A prev outside [0, lutM) selects JAX's all-zero tables.
__device__ __forceinline__ bool nrzs_pair(const int* __restrict__ symLUT, int lutM, int lutK,
                                          int prev, int next, float* bit) {
    bool one = false, zero = false;
    if (prev >= 0 && prev < lutM) {
        const int* t = symLUT + (size_t)prev * 2 * lutK;
        for (int q = 0; q < lutK; ++q) {
            one |= __ldg(t + q) == next;
            zero |= __ldg(t + lutK + q) == next;
        }
    } else {  // JAX's one-hot select gives all-zero tables here
        one = zero = next == 0;
    }
    const bool ok = one || zero;
    *bit = ok && one ? 1.f : 0.f;
    return ok;
}

}  // namespace
