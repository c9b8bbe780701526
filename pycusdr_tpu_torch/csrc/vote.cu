// K8 vote: the trust-weighted majority vote over the C lockstep channels
// of a channel group, read straight from their packed result rows.
//
// For each bit slot s, over c = 0..C-1 in channel order:
//   trust[c][s] = -1 when s >= nBits[c] and mask_pad is set (written back
//                 into the row: a pad slot must not vote, and the rows
//                 leave with it masked); with mask_pad 0 the trust votes
//                 as it is (the generic channel x dopp step, whose K4s
//                 already wrote -1 beyond nSym, sharded_demod.py:378-379,
//                 429-434, and whose NRZ-S nBits = nSym - 1 is not masked);
//   valid       = trust >= 0; weight w = trust as f32, the master's (c =
//                 master_idx) times master_weight;
//   score      += w * (2 bit - 1)          (f32, channel order)
//   voted       = score > 0
//   agree       = #valid with bit == voted, quorum = #valid
//   trust_voted = agree + quorum / 10, or -1 when quorum == 0.
// voted and trust_voted go to out[0, s] and out[S + s] (f32): the tail of
// the group vector.
//
// Replaces pycusdr_tpu/parallel/vote.py:vote_n_device (:18-41) and the pad
// masking of runtime/channel_group_process.py:_group_graph (:308-314).
// Ties decide the vote: a master trust of 5 weighs 5 * 1.2f, which rounds
// to exactly 6.0 and ties three voters of trust 2. JAX sums the C products
// in channel order from 0 (a reduce over axis 0); so does phase 2 below,
// with __fmul_rn / __fadd_rn so that nvcc contracts nothing into an FMA.
//
// Bound: each row's bits, trust and nBits read once and the pair written,
// C S 8 + S 8 bytes (~1.2 MB at C = 16, S = 4608): bytes bound it, and at
// the group sizes (C = 2-64) the launch does.
//
// A CTA owns a tile of kTile = 32 slots (lane = slot) and all C channels:
// 144 CTAs at S = 4608 where one thread a slot made 18 walk the C rows in
// turn, one dependent round trip a channel. Phase 1: warp w takes the
// channels c = w, w + NW, ... of a chunk of at most kChunk, issues kGroup
// channels' bit, trust and nBits loads (coalesced along s) before it uses
// any, masks the pad (writing -1 only where the trust changes), and puts
// each channel's term w (2 bit - 1) (0 for an invalid voter: adding +0
// changes no sum, which is never -0) in shared memory; the agree and
// quorum counts are integers, so each warp counts its own channels
// (voters with bit 1, with bit 0, valid ones) and the counts are added in
// any order. Phase 2: warp 0 adds the chunk's terms in channel order, the
// running score in registers across chunks, so any C takes the same sum
// in the same order. agree = ones when the vote is 1, else zeros.
#include "common.cuh"

namespace {

constexpr int kTile = 32;      // slots a CTA: one a lane
constexpr int kMaxWarps = 8;   // warps a CTA (fewer when C is smaller)
constexpr int kChunk = 256;    // channels a CTA holds in shared memory at once
constexpr int kGroup = 8;      // channels a thread loads before it uses any

// grid ceil(S / kTile), block 32 min(C, kMaxWarps), dynamic shared memory
// min(C, kChunk) kTile floats
__global__ void __launch_bounds__(kTile * kMaxWarps)
vote(float* __restrict__ rows, float* __restrict__ out, int C, int L, int S, int master,
     float master_weight, int mask_pad) {
    extern __shared__ float term[];                 // (chunk channel, lane)
    __shared__ int counts[3][kMaxWarps][kTile];     // ones, zeros, quorum of each warp
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, NW = blockDim.x >> 5;
    const int s = blockIdx.x * kTile + lane;
    const bool live = s < S;
    const size_t nb_at = 5 * (size_t)S + 1;
    int ones = 0, zeros = 0, quorum = 0;
    float score = 0.f;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
        const int cn = min(kChunk, C - c0);
        if (c0) __syncthreads();  // warp 0 has added the last chunk's terms
        for (int i = w; i < cn; i += NW * kGroup) {
            float bit[kGroup], t[kGroup], nb[kGroup];
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {  // every load in flight before any use
                const int cc = i + u * NW;
                bit[u] = 0.f;
                t[u] = -1.f;
                nb[u] = 0.f;
                if (cc < cn && live) {
                    const float* r = rows + (size_t)(c0 + cc) * L;
                    bit[u] = __ldg(r + s);
                    t[u] = r[S + s];
                    if (mask_pad) nb[u] = __ldg(r + nb_at);
                }
            }
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
                const int cc = i + u * NW;
                if (cc >= cn) break;
                const int c = c0 + cc;
                float tc = t[u];
                if (live && mask_pad && (float)s >= nb[u]) {  // s >= nBits[c]
                    if (tc != -1.f) rows[(size_t)c * L + S + s] = -1.f;
                    tc = -1.f;
                }
                float v = 0.f;
                if (tc >= 0.f) {
                    const float wc = c == master ? __fmul_rn(tc, master_weight) : tc;
                    v = __fmul_rn(wc, __fsub_rn(__fmul_rn(bit[u], 2.f), 1.f));
                    ++quorum;
                    ones += bit[u] == 1.f;
                    zeros += bit[u] == 0.f;
                }
                term[cc * kTile + lane] = v;
            }
        }
        if (c0 + kChunk >= C) {
            counts[0][w][lane] = ones;
            counts[1][w][lane] = zeros;
            counts[2][w][lane] = quorum;
        }
        __syncthreads();
        if (w == 0) {
            for (int cc = 0; cc < cn; ++cc) score = __fadd_rn(score, term[cc * kTile + lane]);
        }
    }
    if (w != 0 || !live) return;
    ones = zeros = quorum = 0;
    for (int v = 0; v < NW; ++v) {
        ones += counts[0][v][lane];
        zeros += counts[1][v][lane];
        quorum += counts[2][v][lane];
    }
    const bool one = score > 0.f;
    const int agree = one ? ones : zeros;
    out[s] = one ? 1.f : 0.f;
    out[S + s] = quorum ? __fadd_rn((float)agree, __fdiv_rn((float)quorum, 10.f)) : -1.f;
}

}  // namespace

// rows: (C, L) f32 packed rows (bits at 0, trust at S, nBits at 5 S + 1),
// trust masked in place when mask_pad != 0; out: (2, S) f32; master_idx
// in [0, C).
PYCUSDR_API int pycusdr_vote(float* rows, float* out, int C, int L, int S, int master_idx,
                             float master_weight, int mask_pad, cudaStream_t stream) {
    if (C <= 0 || S <= 0 || L < 5 * S + 12 || master_idx < 0 || master_idx >= C)
        return (int)cudaErrorInvalidValue;
    const int warps = C < kMaxWarps ? C : kMaxWarps;
    const size_t smem = (size_t)(C < kChunk ? C : kChunk) * kTile * sizeof(float);
    vote<<<(S + kTile - 1) / kTile, warps * 32, smem, stream>>>(rows, out, C, L, S, master_idx,
                                                               master_weight, mask_pad);
    return (int)cudaGetLastError();
}
