// K7 viterbi: the K=7 rate-1/2 trellis sweep of S sequences, with the
// traceback on the device.
//
// Replaces pycusdr_tpu/ops/viterbi.py:viterbi_decode (:59-139): the
// lax.scan add-compare-select step (:99-109) and the host traceback
// (:128-134). For t in [0, T) and each new state ns, with predecessors
// pa = ns >> 1, pb = (ns >> 1) | 32 and input bit b = ns & 1:
//   cand_a = pm[pa] + bm[b, pa], cand_b = pm[pb] + bm[b, pb],
//   take_b = cand_b < cand_a (strict: a tie keeps pa),
//   pm'[ns] = take_b ? cand_b : cand_a, m = min pm', pm = pm' - m, tot += m;
// bm is |e0 - r0| + |e1 - r1| (hard) or -(s0 r0 + s1 r1), s = 2e - 1
// (soft), e the encoder's output bits for (state, input). The f32 order
// is the scan's, spelled with __f*_rn so that nvcc contracts nothing into
// an FMA: node sync compares these totals, so they must equal JAX's, not
// only be close. Traceback starts at state 0 (terminated) or at the first
// state of least metric (np.argmin), bits[t] = state & 1.
//
// Bound: a dependency chain of T steps, each a few shuffles deep; the
// bytes (8 B of symbols in, 1 B of bits out per step) and the f32
// operations (~330 per step) are tiny. Design: one warp per sequence,
// lane l owns states l and l + 32. The four predecessor metrics come from
// __shfl_sync (lanes l >> 1 and 16 + (l >> 1) hold them), the step's
// minimum from a 5-step __shfl_xor_sync butterfly, the two 32-bit
// decision words from __ballot_sync; no shared memory and no
// __syncthreads. Symbols are loaded 32 steps at a time (one float2 per
// lane, the next chunk in flight) and broadcast by shuffle; lane j keeps
// step j's decision words and the chunk is stored with one coalesced
// uint2 per lane into a (S, Tmax) scratch (17 KB at T = 2144, held in
// L2). The traceback walks the same chunks backwards with the words in
// registers, one shuffle per step. Sequences run in parallel, one warp
// each: a batch of streams, not one stream, is what could approach the
// card's rates.
//
// Inputs: sym (S, Tmax, 2) f32, lengths (S,) int32 <= Tmax. Outputs:
// met (S, 2) f32 = (tot, min pm); with decode, bits (S, Tmax) uint8 (0
// beyond each length) and the scratch dec (S, Tmax) uint2.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // sequences per block
constexpr int kG1 = 0171, kG2 = 0133;

// Expected encoder output bits of the branch (state, input b).
__device__ __forceinline__ float2 expected(int state, int b, int invert) {
    const int reg = (state << 1) | b;
    return make_float2((float)(__popc(reg & kG1) & 1), (float)((__popc(reg & kG2) & 1) ^ invert));
}

__device__ __forceinline__ float branch_metric(float2 e, float r0, float r1, int soft) {
    if (soft) {
        const float s0 = __fsub_rn(__fmul_rn(e.x, 2.f), 1.f);
        const float s1 = __fsub_rn(__fmul_rn(e.y, 2.f), 1.f);
        return -__fadd_rn(__fmul_rn(s0, r0), __fmul_rn(s1, r1));
    }
    return __fadd_rn(fabsf(__fsub_rn(e.x, r0)), fabsf(__fsub_rn(e.y, r1)));
}

__global__ void __launch_bounds__(32 * kWarps)
viterbi(const float2* __restrict__ sym, const int* __restrict__ lengths, uint2* __restrict__ dec,
        unsigned char* __restrict__ bits, float* __restrict__ met, int S, int Tmax, int soft,
        int terminated, int invert, int decode) {
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (s >= S) return;  // the whole warp leaves together
    const int T = lengths[s];
    const float2* x = sym + (size_t)s * Tmax;
    uint2* d = decode ? dec + (size_t)s * Tmax : nullptr;

    // new states ns = lane (lo) and lane + 32 (hi); both take input bit
    // lane & 1; the lanes src_lo, src_hi hold their predecessors' metrics
    // in (lo, hi) = (pa, pb)
    const int b = lane & 1;
    const int src_lo = lane >> 1, src_hi = 16 + (lane >> 1);
    const float2 e_a_lo = expected(src_lo, b, invert), e_b_lo = expected(src_lo | 32, b, invert);
    const float2 e_a_hi = expected(src_hi, b, invert), e_b_hi = expected(src_hi | 32, b, invert);

    float lo = terminated && lane != 0 ? 1e6f : 0.f;  // pm[lane]
    float hi = terminated ? 1e6f : 0.f;               // pm[lane + 32]
    float tot = 0.f;

    float2 nxt = lane < T ? x[lane] : make_float2(0.f, 0.f);
    for (int t0 = 0; t0 < T; t0 += 32) {
        const float2 cur = nxt;
        if (t0 + 32 + lane < T) nxt = x[t0 + 32 + lane];
        const int n = min(32, T - t0);
        unsigned k0 = 0, k1 = 0;
        for (int j = 0; j < n; ++j) {
            const float r0 = __shfl_sync(kFull, cur.x, j);
            const float r1 = __shfl_sync(kFull, cur.y, j);
            const float pa_lo = __shfl_sync(kFull, lo, src_lo);
            const float pb_lo = __shfl_sync(kFull, hi, src_lo);
            const float pa_hi = __shfl_sync(kFull, lo, src_hi);
            const float pb_hi = __shfl_sync(kFull, hi, src_hi);
            const float ca_lo = __fadd_rn(pa_lo, branch_metric(e_a_lo, r0, r1, soft));
            const float cb_lo = __fadd_rn(pb_lo, branch_metric(e_b_lo, r0, r1, soft));
            const float ca_hi = __fadd_rn(pa_hi, branch_metric(e_a_hi, r0, r1, soft));
            const float cb_hi = __fadd_rn(pb_hi, branch_metric(e_b_hi, r0, r1, soft));
            const bool tk_lo = cb_lo < ca_lo, tk_hi = cb_hi < ca_hi;
            const float n_lo = tk_lo ? cb_lo : ca_lo, n_hi = tk_hi ? cb_hi : ca_hi;
            float m = fminf(n_lo, n_hi);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, o));
            lo = __fsub_rn(n_lo, m);
            hi = __fsub_rn(n_hi, m);
            tot = __fadd_rn(tot, m);
            const unsigned w0 = __ballot_sync(kFull, tk_lo), w1 = __ballot_sync(kFull, tk_hi);
            if (lane == j) {
                k0 = w0;
                k1 = w1;
            }
        }
        if (decode && lane < n) d[t0 + lane] = make_uint2(k0, k1);
    }

    // least final metric and its first state (lower index wins ties)
    float v = lo;
    int arg = lane;
    if (hi < v) {
        v = hi;
        arg = lane + 32;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, o);
        const int oi = __shfl_xor_sync(kFull, arg, o);
        if (ov < v || (ov == v && oi < arg)) {
            v = ov;
            arg = oi;
        }
    }
    if (lane == 0) {
        met[2 * s] = tot;
        met[2 * s + 1] = v;
    }
    if (!decode) return;
    __syncwarp();  // this warp's decision words are visible to all its lanes

    unsigned char* out = bits + (size_t)s * Tmax;
    int state = terminated ? 0 : arg;
    for (int t1 = T; t1 > 0; t1 -= 32) {
        const int t0 = max(t1 - 32, 0);
        const uint2 w = t0 + lane < t1 ? d[t0 + lane] : make_uint2(0u, 0u);
        unsigned char mine = 0;
        for (int j = t1 - t0 - 1; j >= 0; --j) {
            const unsigned w0 = __shfl_sync(kFull, w.x, j), w1 = __shfl_sync(kFull, w.y, j);
            if (lane == j) mine = (unsigned char)(state & 1);
            const unsigned word = state < 32 ? w0 : w1;
            state = (word >> (state & 31)) & 1u ? (state >> 1) | 32 : state >> 1;
        }
        if (t0 + lane < t1) out[t0 + lane] = mine;
    }
    for (int t = T + lane; t < Tmax; t += 32) out[t] = 0;
}

}  // namespace

PYCUSDR_API int pycusdr_viterbi(const float* sym, const int* lengths, unsigned* dec,
                                unsigned char* bits, float* met, int S, int Tmax, int soft,
                                int terminated, int invert_g2, int decode, cudaStream_t stream) {
    if (S <= 0 || Tmax < 0 || (decode && (dec == nullptr || bits == nullptr)))
        return (int)cudaErrorInvalidValue;
    viterbi<<<(S + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
        reinterpret_cast<const float2*>(sym), lengths, reinterpret_cast<uint2*>(dec), bits, met, S,
        Tmax, soft, terminated, invert_g2, decode);
    return (int)cudaGetLastError();
}
