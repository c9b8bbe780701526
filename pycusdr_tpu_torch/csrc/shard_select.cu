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
//   pair[x] = (the bits of colmax[A + k], k * M + (m0 + colargmax[A + k])).
// Replaces pycusdr_tpu/parallel/sharded_demod.py:_local_find_centres
// (:46-104: sliding_window_argmax, the f32-packed payload and the one-hot
// or gather row select existed to avoid a TPU gather; a thread reads its
// slots' windows directly, with K4's reader).
//
// K4s, after the (nd, B, S) pairs are gathered: the largest value wins, and
// among equal values the smallest key (the earliest sample, then the lowest
// global mask), as the single-chip argmax orders them
// (sharded_demod.py:361-376). symbol = g mod M, k = g div M (keys >= 0),
// mag = the value, centre = trunc(x*spc - W/2 + k) + trunc(codeOffset) -
// min(A0, 0); then the tail of sharded_demod.py:378-411 into the packed
// row: trust = trust_normal for x < nSym and -1 beyond, bit =
// bitLUT[symbol], trust -2 when a clip bitmask is given and a hit lies in
// [j - hw, j + hw] around the winning sample j = A + k, hw =
// clamp(2*ceil(spc), 0, hw_max); the scalars nSym, nBits = nSym, spSym,
// codeOffset, code_val and clipped_any. kNrzs (no centre-bit LUT: NRZ-S,
// bench_BPSK): K4n's epilogue in the same launch, as K4's NRZ-S form has it
// (symbol_detect.cu): bit x from the (symbol[x], symbol[x + 1 mod S]) pair
// in the (lutM, 2, lutK) symbol LUT, trust -1 on a transition error where
// the clip window left no -2, nBits = nSym - 1 (sharded_demod.py:386-394
// with ops/demod_kernels.py:extract_bits_nrzs).
//
// At nd = 1 (one shard, m0 = 0) K4l then K4s give K4's symbols, centres,
// mags and bits bit for bit: the same slot arithmetic and window reader
// (detect_window.cuh), and a select over one candidate. Their trust differs
// beyond nSym: JAX's generic step writes -1 there and the block graph
// trust_normal.
//
// Bound: K4l reads the W-sample windows (at most N samples) and one
// colargmax word a slot and writes 8 bytes a slot (~0.2 MB per flagship
// block); K4s reads 8 nd bytes and writes 20 bytes a slot (~0.2 MB at nd =
// 2). Both are far below a microsecond of HBM time: the launch and the
// chain of dependent reads bound them. The design keeps that chain short:
// - K4l is K4's reader with a pair written instead of a row: the plan of
//   ops/demod_kernels.py:k4_plan (at few slots 64 threads a CTA, colargmax
//   read with the windows, one round trip after spSym and codeOffset; at
//   many 128 threads, one or two slots a thread, colargmax at the winning
//   sample), every slot's reads issued before any store, and the (value,
//   key) pair stored as one 8-byte word, so the dopp all-gather moves one
//   buffer and K4s reads one word a shard.
// - K4s issues the loads of all nd pairs of each of its slots at once
//   (ND shards a round trip, ND = nd up to 2, else 4: registers only for
//   the pairs a launch reads; more shards take more), and with a clip
//   bitmask the words that cover [A - hw, A + W - 1 + hw] with them: A is
//   known before the select, so they are tested in registers after it
//   (only a wider range, hw near its clamp, is tested in global memory).
//   ops/demod_kernels.py:k4s_plan picks 64 or 128 threads and one or two
//   slots a thread by B x S.
// - kNrzs: bit x needs the symbol of slot x + 1, which another thread
//   selects. The select is a few compares over nd pairs, not K4's window
//   search, so each thread selects slot x + 1 itself from its nd pairs,
//   loaded in the same round trip as its own (the neighbour's lines: hits in
//   L1 or L2): no shared memory, no barrier. The select is deterministic, so
//   the neighbour's symbol is bit-equal to the one its owner finds. The roll
//   wraps slot S - 1 onto slot 0 over the padded slots too, as jnp.roll does.
//   A form that took the next key from lane + 1 by __shfl_down_sync (lane 31
//   and the owner of slot S - 1 loading their next slot) measured 0.0002-
//   0.0003 ms slower at every B on one H100 (chip_ab_viterbi.py --turn shard):
//   the shuffle waits on the whole warp's select, and lane 31's predicated
//   loads still cost the warp a request; it is not kept.
#include "detect_window.cuh"

namespace {

constexpr int kMaxThreads = 128;  // threads of a CTA: 64 or 128

// grid (ceil(S / (blockDim.x * SPT)), B); pair: (B, S) (value bits, key)
template <int SPT, bool kArgWin, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
symbol_detect_local(const float* __restrict__ colmax, const int* __restrict__ colarg,
                    const float* __restrict__ spSym, const float* __restrict__ codeOffset,
                    int2* __restrict__ pair, int N, int W, int spsymMin, int S, int M, int m0) {
    const int b = blockIdx.y, T = blockDim.x, tid = threadIdx.x;
    const int x0 = blockIdx.x * T * SPT;
    const float spc = fmaxf(spSym[b], (float)spsymMin);
    const float co = codeOffset[b];
    const float* cm = colmax + (size_t)b * N;
    const int* ca = colarg + (size_t)b * N;

    // every slot's window first: the reads of all slots are in flight together
    float best[SPT];
    int sym[SPT], k[SPT], A[SPT];
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
        const int x = min(x0 + s * T + tid, S - 1);  // a slot past S reads in range
        const int A0 = (int)truncf(__fadd_rn(slot_xs(x, spc, W), co));
        A[s] = min(max(A0, 0), max(N - W, 0));
        window_max<kArgWin, kVec>(cm, ca, A[s], W, best[s], sym[s], k[s]);
    }
    if (!kArgWin) {  // the mask at each winning sample, all slots' reads together
#pragma unroll
        for (int s = 0; s < SPT; ++s) sym[s] = __ldg(ca + A[s] + k[s]);
    }
    int2* p = pair + (size_t)b * S;
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
        const int x = x0 + s * T + tid;
        if (x >= S) break;
        p[x] = make_int2(__float_as_int(best[s]), k[s] * M + m0 + sym[s]);
    }
}

// grid (ceil(S / (blockDim.x * SPT)), B); pairs: (nd, B, S) (value bits,
// key). kNrzs: the NRZ-S bits from the (lutM, 2, lutK) symLUT; candidate
// SPT + s of a thread is slot s's next, x + 1 mod S. ND: the shards' pairs
// of a slot loaded in one round trip
template <int SPT, int ND, bool kNrzs>
__global__ void __launch_bounds__(kMaxThreads)
shard_select(const int2* __restrict__ pairs, int nd, const float* __restrict__ spSym,
             const float* __restrict__ codeOffset, const int8_t* __restrict__ bitLUT,
             const unsigned* __restrict__ hits, const float* __restrict__ code_val,
             const int* __restrict__ clipped_any, float* __restrict__ row, int L, int B, int N,
             int W, int spsymMin, int S, int M, int trust_normal, int hw_max,
             const int* __restrict__ symLUT, int lutM, int lutK) {
    const int b = blockIdx.y, T = blockDim.x, tid = threadIdx.x;
    const int x0 = blockIdx.x * T * SPT;
    constexpr int NC = kNrzs ? 2 * SPT : SPT;  // slots whose select a thread runs

    // every candidate's first ND pairs first (they need nothing else),
    // then spSym and codeOffset, then every slot's clip words: two round trips
    const size_t stride = (size_t)B * S;
    const int2* pb = pairs + (size_t)b * S;
    int xc[NC];
    int2 q[NC][ND];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const int x = min(x0 + (c % SPT) * T + tid, S - 1);  // a slot past S reads in range
        xc[c] = c < SPT ? x : x + 1 < S ? x + 1 : 0;
#pragma unroll
        for (int u = 0; u < ND; ++u)
            if (u < nd) q[c][u] = __ldg(pb + u * stride + xc[c]);
    }
    const float spc = fmaxf(spSym[b], (float)spsymMin);
    const float co = codeOffset[b];
    const int ns = (int)__fdiv_rn((float)N, spc);
    const unsigned* hrow = hits ? hits + (size_t)b * ((N + 31) / 32) : nullptr;
    const int hw = hits ? min(max(2 * (int)ceilf(spc), 0), hw_max) : 0;
    float* r = row + (size_t)b * L;
    if (x0 + tid == 0) {
        float* sc = r + 5 * (size_t)S;
        sc[0] = (float)ns;
        sc[1] = kNrzs ? (float)ns - 1.f : (float)ns;  // nBits
        sc[2] = spSym[b];
        sc[3] = co;
        sc[4] = code_val[b];
        sc[11] = clipped_any && clipped_any[b] ? 1.f : 0.f;
    }
    float xs[SPT];
    int A[SPT], A0[SPT], wlo[SPT];
    unsigned wd[SPT][kRegWords];
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
        xs[s] = slot_xs(xc[s], spc, W);
        A0[s] = (int)truncf(__fadd_rn(xs[s], co));
        A[s] = min(max(A0[s], 0), max(N - W, 0));
        if (hrow) wlo[s] = clip_words(hrow, A[s], W, hw, N, wd[s]);
    }

    // the select: the largest value, among equal values the smallest key
    float best[NC];
    int gk[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        best[c] = __int_as_float(q[c][0].x);
        gk[c] = q[c][0].y;
#pragma unroll
        for (int u = 1; u < ND; ++u) {
            const float v = __int_as_float(q[c][u].x);
            const int g = q[c][u].y;
            if (u < nd && (v > best[c] || (v == best[c] && g < gk[c]))) {
                best[c] = v;
                gk[c] = g;
            }
        }
    }
    for (int d0 = ND; d0 < nd; d0 += ND) {  // nd > ND: more round trips
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int u = 0; u < ND; ++u)
                if (d0 + u < nd) q[c][u] = __ldg(pb + (d0 + u) * stride + xc[c]);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int u = 0; u < ND; ++u) {
                const float v = __int_as_float(q[c][u].x);
                const int g = q[c][u].y;
                if (d0 + u < nd && (v > best[c] || (v == best[c] && g < gk[c]))) {
                    best[c] = v;
                    gk[c] = g;
                }
            }
    }

#pragma unroll
    for (int s = 0; s < SPT; ++s) {
        const int x = x0 + s * T + tid;
        if (x >= S) break;
        const int sym = gk[s] % M, k = gk[s] / M;
        const int centre = (int)truncf(__fadd_rn(xs[s], (float)k)) + (int)truncf(co) -
                           min(A0[s], 0);
        int8_t tr = x < ns ? (int8_t)trust_normal : (int8_t)-1;
        // a winning sample outside the window (a key past W) is tested in global memory
        if (hrow && clip_hit(hrow, wd[s], k < W ? wlo[s] : -1, min(max(A[s] + k, 0), N - 1), hw,
                             N))
            tr = kTrustClipped;
        float bit;
        if constexpr (kNrzs) {
            if (!nrzs_pair(symLUT, lutM, lutK, sym, gk[SPT + s] % M, &bit) &&
                tr != kTrustClipped)
                tr = -1;
        } else {
            bit = bitLUT ? (float)bitLUT[sym] : 0.f;
        }
        r[x] = bit;
        r[S + x] = (float)tr;
        r[2 * (size_t)S + x] = (float)sym;
        r[3 * (size_t)S + x] = (float)centre;
        r[4 * (size_t)S + x] = best[s];
    }
}

}  // namespace

// colmax, colargmax: (B, N) over the shard's masks; spSym, codeOffset: (B,)
// f32; pair: (B, S, 2) int32 out (the value's f32 bits, the key), 8-byte
// aligned. threads: 64 or 128 a CTA; spt: slots a thread, 1 or 2; argwin:
// read the colargmax chunks with colmax's (1) or colargmax at the winning
// sample (0); all three from ops/demod_kernels.py:k4_plan. Windows wider
// than kMaxChunkW or rows not 16-byte aligned take one slot a thread,
// sample by sample, colargmax at the winning sample.
PYCUSDR_API int pycusdr_symbol_detect_local(const float* colmax, const int* colargmax,
                                            const float* spSym, const float* codeOffset,
                                            int* pair, int B, int N, int W, int spsymMin, int S,
                                            int M, int m0, int threads, int spt, int argwin,
                                            cudaStream_t stream) {
    if (B <= 0 || N <= 0 || W <= 0 || W > N || S <= 0 || M <= 0 || m0 < 0 || m0 >= M ||
        !(threads == 64 || threads == kMaxThreads) || !(spt == 1 || spt == 2) ||
        (argwin && spt != 1) || ((uintptr_t)pair & 7) != 0)
        return (int)cudaErrorInvalidValue;
    const bool vec = W <= kMaxChunkW && N % 4 == 0 && ((uintptr_t)colmax & 15) == 0 &&
                     ((uintptr_t)colargmax & 15) == 0;
    int2* p = reinterpret_cast<int2*>(pair);
    const dim3 grid((S + threads * spt - 1) / (threads * spt), B);
    const dim3 grid1((S + threads - 1) / threads, B);  // one slot a thread
#define K4L_ARGS colmax, colargmax, spSym, codeOffset, p, N, W, spsymMin, S, M, m0
    if (!vec)
        symbol_detect_local<1, false, false><<<grid1, threads, 0, stream>>>(K4L_ARGS);
    else if (argwin)
        symbol_detect_local<1, true, true><<<grid, threads, 0, stream>>>(K4L_ARGS);
    else if (spt == 1)
        symbol_detect_local<1, false, true><<<grid, threads, 0, stream>>>(K4L_ARGS);
    else
        symbol_detect_local<2, false, true><<<grid, threads, 0, stream>>>(K4L_ARGS);
#undef K4L_ARGS
    return (int)cudaGetLastError();
}

// pairs: (nd, B, S, 2) int32 from K4l on every shard, 8-byte aligned;
// spSym, codeOffset, code_val: (B,) f32; bitLUT: (M,) int8 or NULL (bits 0);
// symLUT: (lutM, 2, lutK) int32 or NULL: with no bitLUT, the NRZ-S bits,
// trust and nBits written in the same launch; hits: (B, ceil(N/32)) u32 or
// NULL (the bits past N zero); clipped_any: (B,) i32 or NULL (0); row: (B,
// L) f32 packed rows, L >= 5 S + 12. threads: 64 or 128 a CTA; spt: slots a
// thread, 1 or 2; both from ops/demod_kernels.py:k4s_plan.
PYCUSDR_API int pycusdr_shard_select(const int* pairs, int nd, const float* spSym,
                                     const float* codeOffset, const int8_t* bitLUT,
                                     const int* symLUT, const unsigned* hits,
                                     const float* code_val, const int* clipped_any, float* row,
                                     int L, int B, int N, int W, int spsymMin, int S, int M,
                                     int trust_normal, int hw_max, int lutM, int lutK,
                                     int threads, int spt, cudaStream_t stream) {
    if (nd <= 0 || B <= 0 || N <= 0 || W <= 0 || W > N || S <= 0 || M <= 0 ||
        L < 5 * S + 12 || !code_val || !row || !(threads == 64 || threads == kMaxThreads) ||
        !(spt == 1 || spt == 2) || ((uintptr_t)pairs & 7) != 0)
        return (int)cudaErrorInvalidValue;
    if (symLUT && (bitLUT || lutM <= 0 || lutK <= 0)) return (int)cudaErrorInvalidValue;
    const int2* p = reinterpret_cast<const int2*>(pairs);
    const dim3 grid((S + threads * spt - 1) / (threads * spt), B);
#define K4S_ARGS                                                                            \
    p, nd, spSym, codeOffset, bitLUT, hits, code_val, clipped_any, row, L, B, N, W, spsymMin, \
        S, M, trust_normal, hw_max, symLUT, lutM, lutK
#define K4S_SPT(ND, NRZS)                                                                   \
    if (spt == 1)                                                                           \
        shard_select<1, ND, NRZS><<<grid, threads, 0, stream>>>(K4S_ARGS);                 \
    else                                                                                    \
        shard_select<2, ND, NRZS><<<grid, threads, 0, stream>>>(K4S_ARGS);
#define K4S_ND(NRZS)                                                                        \
    if (nd == 1) {                                                                          \
        K4S_SPT(1, NRZS)                                                                    \
    } else if (nd == 2) {                                                                   \
        K4S_SPT(2, NRZS)                                                                    \
    } else {                                                                                \
        K4S_SPT(4, NRZS)                                                                    \
    }
    if (symLUT) {
        K4S_ND(true)
    } else {
        K4S_ND(false)
    }
#undef K4S_ND
#undef K4S_SPT
#undef K4S_ARGS
    return (int)cudaGetLastError();
}
