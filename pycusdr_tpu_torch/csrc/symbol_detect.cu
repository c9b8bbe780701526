// K4 symbol_detect: windowed symbol detection, bit mapping and trust, and
// (kNrzs) the NRZ-S bits of K4n in the same launch.
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
// dilation of the whole clip mask) existed to avoid a gather; here a
// thread reads its slot's window directly, and tests the dilated clip
// window only where it is sampled: the OR of the bitmask words around its
// winning sample.
//
// Output: typed arrays, or (row != NULL) f32 straight into the packed row
// (b * L): bits, trust, symbols, centres, mags at 0, S, .., 4S, and the
// scalars nSym, nBits, spSym, codeOffset, code_val, clipped_any at 5S + 0,
// 1, 2, 3, 4 and 11 (PACK_SCALARS order).
//
// Bound: ~7 x 4608 4-byte reads of colmax and one of colargmax per slot,
// 14 bytes written per slot (~0.3 MB per flagship block): at B=1 the chain
// of dependent reads bounds it, at B=64 the bytes and the CTAs launched.
// A thread takes SPT slots, x = CTA start + s * blockDim + thread (stores
// coalesced), and reads each window as the (at most 3) 16-byte chunks that
// cover it (a window wider than kMaxChunkW samples, or a row that is not
// 16-byte aligned, sample by sample, one slot a thread).
// ops/demod_kernels.py:k4_plan picks by B x S (the plan changes no bit):
// - few slots (B=1): 64 threads a CTA, one slot each (72 CTAs for the
//   flagship block, the parent's 36), and the colargmax chunks read with
//   colmax's, so the symbol needs no read after the winning sample is
//   known: one round trip after spSym and codeOffset;
// - many slots (B=16, 64): 128 threads, one or two slots each (fewer CTAs
//   to launch), and colargmax read at the winning sample only: the
//   windows' other colargmax sectors cost more bytes than the round trip
//   saves there. Each thread issues all its slots' reads before any store.
// With a clip mask the words covering [A - hw, A + W - 1 + hw] depend on A
// alone: up to kRegWords of them are read with the window and tested in
// registers against [j - hw, j + hw]; a wider range (hw near its clamp)
// is tested in global memory after j.
// A form that staged each CTA's span of colmax and colargmax in shared
// memory with 16-byte cp.async and scanned it there measured slower at
// every B (a stride of spc samples between threads' windows conflicts in
// the banks, the staging room capped the CTAs an SM holds, and it reads
// every sector of colargmax); it is not kept.
// The window scan, the slot arithmetic (no FMA contraction) and the clip
// test live in detect_window.cuh, which K4l and K4s (shard_select.cu) share.
//
// K4n, for protocols without a centre-bit LUT (NRZ-S, bench_BPSK): bit i
// is the (symbol[i], symbol[i+1 mod S]) transition looked up in the (M, 2,
// K) symbol LUT: 1 when symbol[i+1] is one of lut[symbol[i]][0], 0 when it
// is one of lut[symbol[i]][1], else 0 with trust -1 (a -2 from the clip
// window stays); a symbol[i] outside [0, M) selects JAX's all-zero tables
// (next == 0 counts as both); nBits = nSym - 1. It replaces
// pycusdr_tpu/ops/demod_kernels.py:extract_bits_nrzs (:597-619; its one-hot
// (n, M) x (M, K) matmul avoided a gather on the TPU) and the trust and
// nBits lines of dsp/block.py:318-331. The roll wraps slot S-1 onto slot 0
// over the padded slots too, as jnp.roll does. Bound: 4 bytes read and 8
// written per slot (~55 KB per flagship block), so the launch bounds it.
// It is fused into K4's row launch (kNrzs, the block graph's NRZ-S step):
// bit i needs symbol i+1, which another thread finds, so each CTA also runs
// the window search of the slot after its last (slot 0 for the CTA that
// holds slot S-1; every thread runs it with its own, so its reads are in
// flight with theirs, and the search is deterministic, so it finds the
// symbol the owner finds), puts its T * SPT + 1 symbols in shared memory,
// syncs once and looks each pair up in the LUT through L1 (any size). One
// launch a block where there were two: the second launch and its wrapper
// cost more than the kernel (B <= 16: the device idles). The generic step's
// NRZ-S bits are in K4s's launch (shard_select.cu).
#include "detect_window.cuh"

namespace {

constexpr int kMaxThreads = 128;  // threads of a K4 CTA: 64 or 128

// grid (ceil(S / (blockDim.x * SPT)), B); kVec: windows of at most kMaxChunkW
// samples in 16-byte aligned rows, read as chunks (else sample by sample);
// kNrzs: the NRZ-S bits from the (lutM, 2, lutK) symLUT (the row form only)
template <int SPT, bool kArgWin, bool kVec, bool kNrzs>
__global__ void __launch_bounds__(kMaxThreads)
symbol_detect(const float* __restrict__ colmax, const int* __restrict__ colarg,
              const float* __restrict__ spSym, const float* __restrict__ codeOffset,
              const int8_t* __restrict__ bitLUT, const unsigned* __restrict__ hits,
              const float* __restrict__ code_val, const int* __restrict__ clipped_any,
              int* __restrict__ symbols, int* __restrict__ centres, float* __restrict__ mags,
              int8_t* __restrict__ bits, int8_t* __restrict__ trust, int* __restrict__ nSym,
              float* __restrict__ row, int L, int N, int W, int spsymMin, int S,
              int trust_normal, int hw_max, const int* __restrict__ symLUT, int lutM,
              int lutK) {
    const int b = blockIdx.y, T = blockDim.x, tid = threadIdx.x;
    const int x0 = blockIdx.x * T * SPT;
    // kNrzs: slot NS - 1 of every thread is the slot after the CTA's last
    // (slot 0 for the CTA that holds slot S - 1), for the last pair
    constexpr int NS = kNrzs ? SPT + 1 : SPT;
    const int xe = x0 + T * SPT < S ? x0 + T * SPT : 0;
    const float spc = fmaxf(spSym[b], (float)spsymMin);
    const float co = codeOffset[b];
    const float* cm = colmax + (size_t)b * N;
    const int* ca = colarg + (size_t)b * N;
    const unsigned* hrow = hits ? hits + (size_t)b * ((N + 31) / 32) : nullptr;
    const int hw = hits ? min(max(2 * (int)ceilf(spc), 0), hw_max) : 0;
    float* r = row ? row + (size_t)b * L : nullptr;
    if (x0 + tid == 0) {
        const int ns = (int)__fdiv_rn((float)N, spc);
        if (r) {
            float* sc = r + 5 * (size_t)S;
            sc[0] = (float)ns;
            sc[1] = kNrzs ? (float)ns - 1.f : (float)ns;  // nBits
            sc[2] = spSym[b];
            sc[3] = co;
            sc[4] = code_val[b];
            sc[11] = clipped_any && clipped_any[b] ? 1.f : 0.f;
        } else {
            nSym[b] = ns;
        }
    }

    // every slot's window (and its clip words) first: the reads of all slots
    // are in flight together
    float best[NS], xs[NS];
    int sym[NS], k[NS], A[NS], A0[NS], wlo[NS];
    unsigned wd[NS][kRegWords];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        // a slot past S reads in range, stores nothing
        const int x = kNrzs && s == SPT ? xe : min(x0 + s * T + tid, S - 1);
        xs[s] = slot_xs(x, spc, W);
        A0[s] = (int)truncf(__fadd_rn(xs[s], co));
        const int a = A[s] = min(max(A0[s], 0), max(N - W, 0));
        window_max<kArgWin, kVec>(cm, ca, a, W, best[s], sym[s], k[s]);
        if (hrow && !(kNrzs && s == SPT)) wlo[s] = clip_words(hrow, a, W, hw, N, wd[s]);
    }
    if (!kArgWin) {  // the symbol at each winning sample, all slots' reads together
#pragma unroll
        for (int s = 0; s < NS; ++s) sym[s] = __ldg(ca + A[s] + k[s]);
    }
    float nbit[SPT];
    bool nerr[SPT];
    if constexpr (kNrzs) {  // each slot's pair (symbol[x], symbol[x + 1 mod S])
        __shared__ int ssym[kMaxThreads * 2 + 1];
#pragma unroll
        for (int s = 0; s < SPT; ++s) ssym[s * T + tid] = sym[s];
        if (tid == 0) ssym[T * SPT] = sym[SPT];
        __syncthreads();
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
            const int x = x0 + s * T + tid;
            const int next = ssym[x + 1 < S ? x + 1 - x0 : T * SPT];
            nerr[s] = !nrzs_pair(symLUT, lutM, lutK, sym[s], next, &nbit[s]);
        }
    }

#pragma unroll
    for (int s = 0; s < SPT; ++s) {
        const int x = x0 + s * T + tid;
        if (x >= S) break;
        const int j = A[s] + k[s];
        const int comp = (int)truncf(co) - min(A0[s], 0);
        const int centre = (int)truncf(__fadd_rn(xs[s], (float)k[s])) + comp;
        int8_t tr = (int8_t)trust_normal;
        if (hrow && clip_hit(hrow, wd[s], wlo[s], j, hw, N)) tr = kTrustClipped;
        if (kNrzs && nerr[s] && tr != kTrustClipped) tr = -1;
        if (r) {
            r[x] = kNrzs ? nbit[s] : bitLUT ? (float)bitLUT[sym[s]] : 0.f;
            r[S + x] = (float)tr;
            r[2 * (size_t)S + x] = (float)sym[s];
            r[3 * (size_t)S + x] = (float)centre;
            r[4 * (size_t)S + x] = best[s];
        } else {
            const size_t o = (size_t)b * S + x;
            symbols[o] = sym[s];
            mags[o] = best[s];
            centres[o] = centre;
            bits[o] = bitLUT ? bitLUT[sym[s]] : (int8_t)0;
            trust[o] = tr;
        }
    }
}

}  // namespace

// colmax, colargmax: (B, N); spSym, codeOffset: (B,) f32; bitLUT: (M,) int8
// or NULL (bits 0); symLUT: (lutM, 2, lutK) int32 or NULL: with a row and no
// bitLUT, the NRZ-S bits, trust and nBits written in the same launch;
// hits: (B, ceil(N/32)) u32 or NULL (the bits past N zero); code_val: (B,)
// f32 (read only with a row);
// clipped_any: (B,) i32 or NULL (0). Either the typed outputs symbols,
// centres: (B, S) i32; mags: (B, S) f32; bits, trust: (B, S) int8; nSym:
// (B,) i32 -- or row: (B, L) f32, L >= 5 S + 12, with the typed pointers NULL.
// threads: 64 or 128 a CTA; spt: slots a thread, 1 or 2; argwin: read the
// colargmax chunks with colmax's (1) or colargmax at the winning sample (0).
// All three from ops/demod_kernels.py:k4_plan. Windows wider than
// kMaxChunkW or rows not 16-byte aligned take one slot a thread, sample by
// sample, colargmax at the winning sample.
PYCUSDR_API int pycusdr_symbol_detect(const float* colmax, const int* colargmax,
                                      const float* spSym, const float* codeOffset,
                                      const int8_t* bitLUT, const int* symLUT,
                                      const unsigned* hits, const float* code_val,
                                      const int* clipped_any, int* symbols, int* centres,
                                      float* mags, int8_t* bits, int8_t* trust, int* nSym,
                                      float* row, int L, int B, int N, int W, int spsymMin,
                                      int S, int trust_normal, int hw_max, int lutM, int lutK,
                                      int threads, int spt, int argwin, cudaStream_t stream) {
    if (B <= 0 || N <= 0 || W <= 0 || W > N || S <= 0 ||
        !(threads == 64 || threads == kMaxThreads) || !(spt == 1 || spt == 2) ||
        (argwin && spt != 1))
        return (int)cudaErrorInvalidValue;
    if (row ? (L < 5 * S + 12 || !code_val)
            : (!symbols || !centres || !mags || !bits || !trust || !nSym))
        return (int)cudaErrorInvalidValue;
    if (symLUT && (!row || bitLUT || lutM <= 0 || lutK <= 0))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((S + threads * spt - 1) / (threads * spt), B);
    const bool vec = W <= kMaxChunkW && N % 4 == 0 && ((uintptr_t)colmax & 15) == 0 &&
                     ((uintptr_t)colargmax & 15) == 0;
#define K4_ARGS                                                                              \
    colmax, colargmax, spSym, codeOffset, bitLUT, hits, code_val, clipped_any, symbols,     \
        centres, mags, bits, trust, nSym, row, L, N, W, spsymMin, S, trust_normal, hw_max,  \
        symLUT, lutM, lutK
#define K4_LAUNCH(NRZS)                                                                      \
    if (!vec)                                                                                \
        symbol_detect<1, false, false, NRZS><<<grid1, threads, 0, stream>>>(K4_ARGS);        \
    else if (argwin)                                                                         \
        symbol_detect<1, true, true, NRZS><<<grid, threads, 0, stream>>>(K4_ARGS);           \
    else if (spt == 1)                                                                       \
        symbol_detect<1, false, true, NRZS><<<grid, threads, 0, stream>>>(K4_ARGS);          \
    else                                                                                     \
        symbol_detect<2, false, true, NRZS><<<grid, threads, 0, stream>>>(K4_ARGS);
    const dim3 grid1((S + threads - 1) / threads, B);  // one slot a thread
    if (symLUT) {
        K4_LAUNCH(true)
    } else {
        K4_LAUNCH(false)
    }
#undef K4_LAUNCH
#undef K4_ARGS
    return (int)cudaGetLastError();
}
