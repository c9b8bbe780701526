// K8 vote: the trust-weighted majority vote over the C lockstep channels
// of a channel group, read straight from their packed result rows.
//
// For each bit slot s (one thread), over c = 0..C-1 in channel order:
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
// in channel order from 0 (a reduce over axis 0); so does this loop, with
// __fmul_rn / __fadd_rn so that nvcc contracts nothing into an FMA.
//
// Bound: each row's bits, trust and nBits read once and the pair written,
// C S 8 + S 8 bytes (~1.2 MB at C = 16, S = 4608): bytes bound it, and at
// the group sizes (C = 2-64) the launch does. Thread s reads word s of
// every row, so a warp's reads are coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vote(float* __restrict__ rows, float* __restrict__ out, int C, int L, int S, int master,
     float master_weight, int mask_pad) {
    const int s = blockIdx.x * kThreads + threadIdx.x;
    if (s >= S) return;
    float score = 0.f;
    for (int c = 0; c < C; ++c) {
        float* r = rows + (size_t)c * L;
        float t = r[S + s];
        if (mask_pad && (float)s >= r[5 * (size_t)S + 1]) {  // s >= nBits[c]
            t = -1.f;
            r[S + s] = -1.f;
        }
        if (t >= 0.f) {  // an invalid voter adds a weight-0 term: no change
            const float w = c == master ? __fmul_rn(t, master_weight) : t;
            score = __fadd_rn(score, __fmul_rn(w, __fsub_rn(__fmul_rn(r[s], 2.f), 1.f)));
        }
    }
    const float v = score > 0.f ? 1.f : 0.f;
    int agree = 0, quorum = 0;
    for (int c = 0; c < C; ++c) {
        const float* r = rows + (size_t)c * L;
        if (r[S + s] >= 0.f) {
            ++quorum;
            agree += r[s] == v;
        }
    }
    out[s] = v;
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
    vote<<<(S + kThreads - 1) / kThreads, kThreads, 0, stream>>>(rows, out, C, L, S, master_idx,
                                                                 master_weight, mask_pad);
    return (int)cudaGetLastError();
}
