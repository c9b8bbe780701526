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
// Bound: a dependency chain of T steps; the bytes (8 B of symbols in, 1 B
// of bits out per step) and the f32 operations (~330 per step) are tiny.
// Sequences are independent, one warp each, so a batch of streams costs
// about what one does.
//
// Design: one warp per sequence, lane l owns states l and l + 32, four
// sequences to a block. The lanes keep their metrics un-normalised (pm =
// lo - m, hi - m, m the last step's minimum) and subtract m after the
// predecessor shuffle, which is the same f32 operation on the same
// operands, so the same value: the 4 shuffles (lanes l >> 1 and
// 16 + (l >> 1) hold pm[pa], pm[pb] of both new states) start as soon as
// the new metrics exist, and their latency hides under the key map,
// redux.sync and the inverse map. The chain of one step, from one
// minimum to the next:
//   the subtraction of m, the candidate add, fminf of the pair,
//   fminf of the lane's two, the key map (2 ops),
//   __reduce_min_sync (redux.sync) of the 32 keys, the inverse map (3 ops):
// redux.sync and 9 dependent ALU operations; 110-140 cycles a step are
// expected.
// Off the chain: the two symbol broadcasts and the four branch metrics of
// a step (they depend on the symbols alone; the full 32-step chunk is
// unrolled, so the compiler hoists them into the previous step's wait),
// the strict compares and the two __ballot_sync decision words (nothing
// on the chain reads them), and tot += m.
//
// Exactness of the shortcuts. fminf(cand_a, cand_b) is the value of the
// strict select (a tie gives equal values); the decision bit is the strict
// compare itself. The step minimum is the integer minimum of an
// order-preserving u32 key of each f32 (key = bits ^ 0x80000000 for a
// sign bit of 0, ~bits for 1; inputs are finite), mapped back: the
// minimum of f32 values is exact, so it is the same value fminf's
// butterfly gave. The keys order -0 below +0, and fminf may return
// either zero of a pair: a signed zero changes no comparison, no sum
// with a non-zero value and no decision (x - x and x + (-x) are +0, so
// neither tot nor a normalised metric ever holds -0), and torch.equal
// holds -0 == +0.
//
// Decisions: lane j keeps step j's two decision words through the
// unrolled index (a select, no branch on the chain), and the chunk is
// stored with one coalesced uint2 per lane into a (S, Tmax) scratch (17
// KB at T = 2144, held in L2); the last partial chunk runs a loop of its
// own. Symbols are loaded 32 steps at a time (one float2 per lane, the
// next chunk in flight) and broadcast by shuffle. The traceback walks
// the same chunks backwards with the words in registers, one shuffle per
// step. soft and decode are template flags: the entry point picks one of
// four instantiations.
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

template <bool kSoft>
__device__ __forceinline__ float branch_metric(float2 e, float r0, float r1) {
    if (kSoft) {
        const float s0 = __fsub_rn(__fmul_rn(e.x, 2.f), 1.f);
        const float s1 = __fsub_rn(__fmul_rn(e.y, 2.f), 1.f);
        return -__fadd_rn(__fmul_rn(s0, r0), __fmul_rn(s1, r1));
    }
    return __fadd_rn(fabsf(__fsub_rn(e.x, r0)), fabsf(__fsub_rn(e.y, r1)));
}

// Order-preserving map of a finite f32 onto u32 (a < b implies key(a) <
// key(b); -0 keys below +0), and its inverse.
__device__ __forceinline__ unsigned f32_key(float f) {
    const unsigned u = __float_as_uint(f);
    return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_f32(unsigned k) {
    return __uint_as_float(k ^ (~(unsigned)((int)k >> 31) | 0x80000000u));
}

// What a lane needs for its two new states ns = lane (lo) and lane + 32
// (hi): the lanes that hold their predecessors' metrics in (lo, hi) =
// (pa, pb), and the expected symbols of the four branches.
struct Branches {
    int src_lo, src_hi;
    float2 a_lo, b_lo, a_hi, b_hi;
};

// One trellis step on symbols (r0, r1). The lane's metrics are held
// un-normalised: pm[lane] = lo - m and pm[lane + 32] = hi - m, m the last
// step's minimum (0 before the first). Updates lo, hi, m and tot; returns
// the step's decision words (bit l of .x: state l took pb, of .y: state
// l + 32), the same in every lane.
template <bool kSoft>
__device__ __forceinline__ uint2 acs(const Branches& br, float r0, float r1, float& lo, float& hi,
                                     float& m, float& tot) {
    const float bm_a_lo = branch_metric<kSoft>(br.a_lo, r0, r1);
    const float bm_b_lo = branch_metric<kSoft>(br.b_lo, r0, r1);
    const float bm_a_hi = branch_metric<kSoft>(br.a_hi, r0, r1);
    const float bm_b_hi = branch_metric<kSoft>(br.b_hi, r0, r1);
    const float pa_lo = __fsub_rn(__shfl_sync(kFull, lo, br.src_lo), m);
    const float pb_lo = __fsub_rn(__shfl_sync(kFull, hi, br.src_lo), m);
    const float pa_hi = __fsub_rn(__shfl_sync(kFull, lo, br.src_hi), m);
    const float pb_hi = __fsub_rn(__shfl_sync(kFull, hi, br.src_hi), m);
    const float ca_lo = __fadd_rn(pa_lo, bm_a_lo), cb_lo = __fadd_rn(pb_lo, bm_b_lo);
    const float ca_hi = __fadd_rn(pa_hi, bm_a_hi), cb_hi = __fadd_rn(pb_hi, bm_b_hi);
    const uint2 w = make_uint2(__ballot_sync(kFull, cb_lo < ca_lo), __ballot_sync(kFull, cb_hi < ca_hi));
    lo = fminf(ca_lo, cb_lo);
    hi = fminf(ca_hi, cb_hi);
    m = key_f32(__reduce_min_sync(kFull, f32_key(fminf(lo, hi))));
    tot = __fadd_rn(tot, m);
    return w;
}

template <bool kSoft, bool kDecode>
__global__ void __launch_bounds__(32 * kWarps)
viterbi(const float2* __restrict__ sym, const int* __restrict__ lengths, uint2* __restrict__ dec,
        unsigned char* __restrict__ bits, float* __restrict__ met, int S, int Tmax,
        int terminated, int invert) {
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (s >= S) return;  // the whole warp leaves together
    const int T = lengths[s];
    const float2* x = sym + (size_t)s * Tmax;
    uint2* d = kDecode ? dec + (size_t)s * Tmax : nullptr;

    // both new states of the lane take input bit lane & 1
    const int b = lane & 1;
    Branches br;
    br.src_lo = lane >> 1;
    br.src_hi = 16 + (lane >> 1);
    br.a_lo = expected(br.src_lo, b, invert);
    br.b_lo = expected(br.src_lo | 32, b, invert);
    br.a_hi = expected(br.src_hi, b, invert);
    br.b_hi = expected(br.src_hi | 32, b, invert);

    float lo = terminated && lane != 0 ? 1e6f : 0.f;  // pm[lane] + m
    float hi = terminated ? 1e6f : 0.f;               // pm[lane + 32] + m
    float m = 0.f, tot = 0.f;

    float2 nxt = lane < T ? x[lane] : make_float2(0.f, 0.f);
    int t0 = 0;
    for (; t0 + 32 <= T; t0 += 32) {  // full chunks
        const float2 cur = nxt;
        if (t0 + 32 + lane < T) nxt = x[t0 + 32 + lane];
        uint2 k = make_uint2(0u, 0u);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const uint2 w = acs<kSoft>(br, __shfl_sync(kFull, cur.x, j),
                                       __shfl_sync(kFull, cur.y, j), lo, hi, m, tot);
            if (kDecode) k = lane == j ? w : k;
        }
        if (kDecode) d[t0 + lane] = k;
    }
    const int n = T - t0;  // the last partial chunk, 0 <= n < 32 steps
    if (n > 0) {
        uint2 k = make_uint2(0u, 0u);
        for (int j = 0; j < n; ++j) {
            const uint2 w = acs<kSoft>(br, __shfl_sync(kFull, nxt.x, j),
                                       __shfl_sync(kFull, nxt.y, j), lo, hi, m, tot);
            if (kDecode) k = lane == j ? w : k;
        }
        if (kDecode && lane < n) d[t0 + lane] = k;
    }

    // least final metric and its first state (lower index wins ties)
    lo = __fsub_rn(lo, m);
    hi = __fsub_rn(hi, m);
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
    if (!kDecode) return;
    __syncwarp();  // this warp's decision words are visible to all its lanes

    unsigned char* out = bits + (size_t)s * Tmax;
    int state = terminated ? 0 : arg;
    for (int t1 = T; t1 > 0; t1 -= 32) {
        const int c0 = max(t1 - 32, 0);
        const uint2 w = c0 + lane < t1 ? d[c0 + lane] : make_uint2(0u, 0u);
        unsigned char mine = 0;
        for (int j = t1 - c0 - 1; j >= 0; --j) {
            const unsigned w0 = __shfl_sync(kFull, w.x, j), w1 = __shfl_sync(kFull, w.y, j);
            if (lane == j) mine = (unsigned char)(state & 1);
            const unsigned word = state < 32 ? w0 : w1;
            state = (word >> (state & 31)) & 1u ? (state >> 1) | 32 : state >> 1;
        }
        if (c0 + lane < t1) out[c0 + lane] = mine;
    }
    for (int t = T + lane; t < Tmax; t += 32) out[t] = 0;
}

template <bool kSoft, bool kDecode>
void launch(const float* sym, const int* lengths, unsigned* dec, unsigned char* bits, float* met,
            int S, int Tmax, int terminated, int invert_g2, cudaStream_t stream) {
    viterbi<kSoft, kDecode><<<(S + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
        reinterpret_cast<const float2*>(sym), lengths, reinterpret_cast<uint2*>(dec), bits, met, S,
        Tmax, terminated, invert_g2);
}

}  // namespace

PYCUSDR_API int pycusdr_viterbi(const float* sym, const int* lengths, unsigned* dec,
                                unsigned char* bits, float* met, int S, int Tmax, int soft,
                                int terminated, int invert_g2, int decode, cudaStream_t stream) {
    // with Tmax = 0 the (S, 0) outputs may have no storage
    if (S <= 0 || Tmax < 0 || (decode && Tmax > 0 && (dec == nullptr || bits == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (soft && decode)
        launch<true, true>(sym, lengths, dec, bits, met, S, Tmax, terminated, invert_g2, stream);
    else if (soft)
        launch<true, false>(sym, lengths, dec, bits, met, S, Tmax, terminated, invert_g2, stream);
    else if (decode)
        launch<false, true>(sym, lengths, dec, bits, met, S, Tmax, terminated, invert_g2, stream);
    else
        launch<false, false>(sym, lengths, dec, bits, met, S, Tmax, terminated, invert_g2, stream);
    return (int)cudaGetLastError();
}
