// K1 doppler_energy: the Doppler-search energy matrix of a batch of blocks.
//
//   E[b, d, m] = scale * sum_k P[b, (k + s_d + c_b) mod N] * Q[m, k]
//
// P = |S|^2 (B, N) f32, Q = |masks_f|^2 (M, N) f32, s_d the D grid
// shifts, c_b an optional runtime recentre (tracking), scale = N / 2^18.
//
// Replaces pycusdr_tpu/ops/doppler_search.py:doppler_energy_corr_dft
// (:106-150, with make_qf_ri :54, make_corr_dft_F :94 and
// ops/cfft.py:fft_real_ri :317). The TPU evaluated the correlation in
// the Fourier domain (rfft of P, times conj(FFT(Q)), contracted against
// a (2, N, D) phasor matrix F of 33.5 MB at the flagship shape) because
// the shifted gather of this direct Parseval form serialises there.
//
// Bound: the cheapest form of the function is the FFT correlation, ~25
// MFLOP per flagship block in a batch; this direct form does 2 D M N (67
// MFLOP) per block, which the f32 CUDA cores cannot do within 2x of that
// bound. So the products run on the tensor cores as 3xTF32: each operand x
// is split in registers, as it is loaded into a fragment, into hi = TF32(x)
// (round to nearest, ties away) and lo = x - hi, and hi*hi, hi*lo and lo*hi
// go into three f32 accumulators (three chains, so the three
// mma.sync.m16n8k8 of a step do not wait on each other), added as hh +
// (hl + lh) at the end of the leaf; lo*lo (~2^-22
// relative) is dropped and lo enters truncated to TF32 (~2^-21). P and Q
// are powers, >= 0, so nothing cancels; one TF32 product alone misses
// 1e-4 * max|E| on a flagship block.
//
// Design (the plan, ops/doppler_search.py:doppler_energy_plan, depends on
// the grid, N and M; the launch grid, k1_grid, on B as well):
// - The mma's 16 rows are shifts, its 8 columns masks, its k the samples.
//   The grid is sorted round the circle and cut into groups of 64 shifts
//   (4 tiles of 16); within a group the shifts are dealt to the 8-row
//   halves of its tiles by their offset mod 8 from the group's first shift,
//   which the deal puts in row 0.
// - The sample axis is cut into chunks of L samples (L = 16384 / MP, MP =
//   8 ceil(M / 8); at most N rounded up to 256) and each chunk into 8
//   leaves of L / 8, one a warp. A CTA of 8 warps takes one chunk of TG
//   tiles (16, 32 or 64 shifts) for a run of bt blocks; the launch picks TG
//   and bt from B (more, smaller CTAs at B = 1; fewer, longer ones at B =
//   64, which stage Q's chunk once for bt blocks).
// - Shared memory holds Q's chunk (row pitch L + 4, 16-byte copies) and,
//   per block, the raw P window [base + c_b + k0, + arc + L) mod N, copied
//   with 16-byte cp.async, where base is the group's first shift and arc
//   the CTA's largest offset from it; a fragment row is a slice of the
//   window, so a staged sample feeds every shift of the CTA. A CTA whose arc
//   does not fit the window reads its A values from P in global memory.
// - Bank conflicts: within a 32-sample step, lane (g, t) takes samples
//   8t + j and 8t + j + 4 in sub-step j, so an A fragment load hits 32
//   banks iff the 8 rows' offsets differ mod 8 (the deal); a lane reads its
//   B values of the step as two 16-byte loads, which a pitch of L + 4 keeps
//   on distinct bank groups.
// - The summation order is fixed by N and M alone: each warp accumulates
//   its leaf from zero in k order (hh + (hl + lh)), the CTA adds its leaves
//   pairwise ((w0 + w1) + (w2 + w3)) + ((w4 + w5) + (w6 + w7)) into a chunk
//   partial, and the last CTA of a (block, row group) to arrive (an integer
//   counter, which it resets to 0) adds the chunk partials in chunk order.
//   Neither TG nor bt changes a sum, so a block alone gives its row of any
//   batch bit for bit. No float atomics; one launch per call.
#include "common.cuh"

namespace {

constexpr int kLeaves = 8;  // leaves of a chunk: one a warp
constexpr int kThreads = 32 * kLeaves;
constexpr int kRows = 16;  // shifts per tile: the m of mma.m16n8k8
constexpr int kGroupTiles = 4;  // tiles per group of the plan's deal
constexpr int kStep = 32;  // samples per warp step: four k8 products
constexpr int kCombine = 32;  // chunk partials a thread loads at once when it adds them
// dynamic shared memory a CTA may take: two CTAs an SM
constexpr int kMaxDynSmem = 112 * 1024;

struct Args {
    const float* P;       // (B, N)
    const float* Q;       // (M, N)
    const int* centre;    // (B,) or NULL
    const int2* rows;     // (T * 16,) each tile row's shift index (-1: padding) and shift mod N
    float* part;          // (B, nch, T * 16, MP) chunk partials
    int* count;           // (B * G,) CTAs arrived, 0 between launches
    float* E;             // (B, D, M)
    int B, N, D, M, L, nch, T, G, wwin, bt, vec;
    float scale;
};

// TF32 of x, round to nearest, ties away (what cvt.rna.tf32.f32 gives for a
// finite x), in two integer operations
__device__ __forceinline__ uint32_t tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi its TF32, lo = x - hi (exact in f32) passed whole; the
// tensor core reads a TF32 operand's top 19 bits, so lo enters truncated
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b, a 16x8 and b 8x8 TF32 fragments, d 16x8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ int wrap(long long v, int N) {
    const long long r = v % N;
    return (int)(r < 0 ? r + N : r);
}

// i + j mod N for 0 <= i < N and j >= 0
__device__ __forceinline__ int add_mod(int i, int j, int N) {
    int r = i + j;
    if (r >= N) r -= N;
    if (r >= N) r %= N;
    return r;
}

// Q's chunk [k0, k0 + L) into Qs at row pitch QP = L + 4 (16-byte rows),
// zero past M and past N: 16-byte copies where `vec`, else one sample a copy
template <int MP>
__device__ __forceinline__ void stage_q(const Args& a, float* Qs, int k0) {
    const int L = a.L, QP = L + 4, L4 = L >> 2;
    for (int e = threadIdx.x; e < MP * L4; e += blockDim.x) {
        const int n = e / L4, k = 4 * (e - n * L4);
        float* d = Qs + n * QP + k;
        const float* q = a.Q + (size_t)n * a.N + k0 + k;
        if (n >= a.M || k0 + k >= a.N) {
            d[0] = d[1] = d[2] = d[3] = 0.f;
        } else if (a.vec) {
            cp_async16(d, q);
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (k0 + k + u < a.N)
                    cp_async4(d + u, q + u);
                else
                    d[u] = 0.f;
        }
    }
}

// This CTA's rows, fetched before Q's chunk is staged so that the loads
// overlap: this thread's row (index, shift) and the group's first shift (row
// 0 of the group's first tile, which the deal keeps)
struct RowFetch {
    int d, s, base;
};

template <int R>
__device__ __forceinline__ RowFetch fetch_rows(const Args& a, int tile0, int ntile) {
    const int i = threadIdx.x;
    const int2 r = i < R && i < ntile * kRows ? a.rows[tile0 * kRows + i] : make_int2(-1, 0);
    return {r.x, r.y, a.rows[tile0 / kGroupTiles * kGroupTiles * kRows].y};
}

// s_off[r] = the offset of row r's shift from the group's first shift (0 for
// padding), *s_arc = the largest
template <int R>
__device__ __forceinline__ void set_rows(const RowFetch& f, int N, int* s_off, int* s_arc) {
    if (threadIdx.x == 0) *s_arc = 0;
    __syncthreads();
    if (threadIdx.x < R) {
        int off = f.d >= 0 ? f.s - f.base : 0;
        if (off < 0) off += N;
        s_off[threadIdx.x] = off;
        atomicMax(s_arc, off);
    }
}

// Copy P[b][(start + i) mod N], i < n, into W[lead + i]: 16-byte pieces from
// start rounded down to 4 where `vec` (lead = start % 4), else one sample a
// copy (lead = 0). Returns lead.
__device__ __forceinline__ int stage_window(const Args& a, float* W, const float* Pb, int start,
                                            int n) {
    const int N = a.N;
    if (!a.vec) {
        for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(W + i, Pb + add_mod(start, i, N));
        return 0;
    }
    const int lead = start & 3, s4 = start - lead, pieces = (lead + n + 3) >> 2;
    for (int q = threadIdx.x; q < pieces; q += blockDim.x)
        cp_async16(W + 4 * q, Pb + add_mod(s4, 4 * q, N));
    return lead;
}

// After the CTA's partial of (b, chunk) is in a.part: count it in, and if it
// is the last chunk of (b, row group g), add the chunk partials in chunk order
// into E and reset the counter.
template <int MP>
__device__ __forceinline__ void arrive(const Args& a, int b, int g, int tile0, int ntile,
                                       int* s_last) {
    __threadfence();
    __syncthreads();  // the CTA's partial is written; thread 0 releases it
    if (threadIdx.x == 0) {
        *s_last = atomicAdd(a.count + b * a.G + g, 1) == a.nch - 1;
        if (*s_last) __threadfence();
    }
    __syncthreads();
    if (!*s_last) return;
    const float* pb = a.part + (size_t)b * a.nch * a.T * kRows * MP;
    const size_t stride = (size_t)a.T * kRows * MP;
    for (int i = threadIdx.x; i < ntile * kRows * a.M; i += blockDim.x) {
        const int row = tile0 * kRows + i / a.M, m = i % a.M;
        const int d = a.rows[row].x;
        if (d < 0) continue;
        const float* p = pb + row * MP + m;
        float s = 0.f;
        for (int c0 = 0; c0 < a.nch; c0 += kCombine) {  // kCombine loads in flight
            float v[kCombine];
#pragma unroll
            for (int u = 0; u < kCombine; ++u)
                v[u] = c0 + u < a.nch ? __ldcg(p + (c0 + u) * stride) : 0.f;
#pragma unroll
            for (int u = 0; u < kCombine; ++u) s += v[u];
        }
        a.E[((size_t)b * a.D + d) * a.M + m] = s * a.scale;
    }
    if (threadIdx.x == 0) a.count[b * a.G + g] = 0;
}

// The four A values of this lane for tile t at sample k of the chunk: rows g
// and g + 8 at k and k + 4, through the window W (row r at W[off_r + k]) or
// from P in global memory (row r from sample r0/r1 of Pb)
template <bool WINDOW>
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4], const float* W,
                                       const float* Pb, int r0, int r1, int k, int N) {
    float x[4];
    if (WINDOW) {
        x[0] = W[r0 + k];
        x[1] = W[r1 + k];
        x[2] = W[r0 + k + 4];
        x[3] = W[r1 + k + 4];
    } else {
        x[0] = __ldg(Pb + add_mod(r0, k, N));
        x[1] = __ldg(Pb + add_mod(r1, k, N));
        x[2] = __ldg(Pb + add_mod(r0, k + 4, N));
        x[3] = __ldg(Pb + add_mod(r1, k + 4, N));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[i], ah[i], al[i]);
}

// One block's leaf of this warp (mma.sync): acc[t][n] = the 16 x 8 tile (t, n)
// over samples [kw, kw + leaf) of the chunk, as hh + (hl + lh). Q's rows
// have pitch QP = L + 4, so a lane reads its 8 B values of a 32-sample step
// (samples 8 tq .. 8 tq + 7 of mask 8 n + g) as two 16-byte loads, and the 8
// lanes of a quarter warp hit 8 distinct 16-byte bank groups.
template <int NT, int TG, bool WINDOW>
__device__ __forceinline__ void leaf_products(float (&acc)[TG][NT][4], const float* Qs, int QP,
                                              const float* W, const float* Pb, const int* r0,
                                              const int* r1, int kw, int leaf, int N) {
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    float hl[TG][NT][4], lh[TG][NT][4];
#pragma unroll
    for (int t = 0; t < TG; ++t)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[t][n][i] = hl[t][n][i] = lh[t][n][i] = 0.f;
    for (int kb = kw; kb < kw + leaf; kb += kStep) {
        float4 q[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const float4* qp = reinterpret_cast<const float4*>(Qs + (8 * n + gq) * QP + kb + 8 * tq);
            q[n][0] = qp[0];
            q[n][1] = qp[1];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int k = kb + 8 * tq + j;  // columns t and t + 4 take k and k + 4
            uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const float* x = reinterpret_cast<const float*>(q[n]);
                split(x[j], bh[n][0], bl[n][0]);
                split(x[4 + j], bh[n][1], bl[n][1]);
            }
#pragma unroll
            for (int t = 0; t < TG; ++t) {
                uint32_t ah[4], al[4];
                load_a<WINDOW>(ah, al, W, Pb, r0[t], r1[t], k, N);
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    mma(acc[t][n], ah, bh[n][0], bh[n][1]);
                    mma(hl[t][n], ah, bl[n][0], bl[n][1]);
                    mma(lh[t][n], al, bh[n][0], bh[n][1]);
                }
            }
        }
    }
#pragma unroll
    for (int t = 0; t < TG; ++t)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[t][n][i] += hl[t][n][i] + lh[t][n][i];
}

// this lane's values of acc (rows 16 t + g (+8), columns 8 n + 2 tq (+1)) to
// or from red, laid out (TG * 16, MP); tiles from ntile on are left out
template <int NT, int TG, bool ADD>
__device__ __forceinline__ void exchange(float (&acc)[TG][NT][4], float* red, int ntile = TG) {
    constexpr int MP = 8 * NT;
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int t = 0; t < TG; ++t) {
        if (t >= ntile) break;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float* r = red + (t * kRows + gq + (i >> 1) * 8) * MP + 8 * n + 2 * tq + (i & 1);
                if (ADD)
                    acc[t][n][i] += *r;  // (this warp's) + (the other's), in that order
                else
                    *r = acc[t][n][i];
            }
    }
}

template <int NT, int TG>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 2 : 1) doppler_energy_k(Args a) {
    constexpr int MP = 8 * NT, R = TG * kRows;
    extern __shared__ __align__(16) float smem[];
    __shared__ int s_off[R];
    __shared__ int s_arc, s_last;
    const int c = blockIdx.x, g = blockIdx.y;
    const int b_begin = blockIdx.z * a.bt, b_end = min(a.B, b_begin + a.bt);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2;
    const int N = a.N, L = a.L, QP = L + 4, k0 = c * L, leaf = L / kLeaves;
    const int tile0 = g * TG, ntile = min(TG, a.T - tile0);
    float* const Qs = smem;
    float* const W0 = smem + MP * QP;  // the window; after the products, the reduction

    const RowFetch rf = fetch_rows<R>(a, tile0, ntile);
    stage_q<MP>(a, Qs, k0);
    set_rows<R>(rf, N, s_off, &s_arc);
    const int base = rf.base;
    __syncthreads();
    const int nwin = s_arc + L;
    const bool window = nwin + 8 <= a.wwin;  // room for the 16-byte copies' slack

    for (int b = b_begin; b < b_end; ++b) {
        const float* Pb = a.P + (size_t)b * N;
        const int start = wrap((long long)base + (a.centre ? a.centre[b] : 0) + k0, N);
        const int lead = window ? stage_window(a, W0, Pb, start, nwin) : 0;
        cp_async_wait();  // (and, first, Q's chunk)
        __syncthreads();

        // each lane's two rows (g, g + 8) of every tile: window offset, or the
        // first sample in P (global path)
        int r0[TG], r1[TG];
#pragma unroll
        for (int t = 0; t < TG; ++t) {
            r0[t] = s_off[t * kRows + gq];
            r1[t] = s_off[t * kRows + gq + 8];
            if (!window) {
                r0[t] = add_mod(start, r0[t], N);
                r1[t] = add_mod(start, r1[t], N);
            }
        }
        float acc[TG][NT][4];
        if (window)
            leaf_products<NT, TG, true>(acc, Qs, QP, W0 + lead, Pb, r0, r1, warp * leaf, leaf, N);
        else
            leaf_products<NT, TG, false>(acc, Qs, QP, W0, Pb, r0, r1, warp * leaf, leaf, N);

        // the leaves pairwise through W0: at each level the warp on the right
        // of a pair hands over, the one on the left adds (left + right)
#pragma unroll
        for (int half = 1; half < kLeaves; half *= 2) {
            float* const slot = W0 + (warp / (2 * half)) * R * MP;
            __syncthreads();
            if (warp % (2 * half) == half) exchange<NT, TG, false>(acc, slot);
            __syncthreads();
            if (warp % (2 * half) == 0) exchange<NT, TG, true>(acc, slot);
        }
        if (warp == 0)
            exchange<NT, TG, false>(acc, a.part + ((size_t)b * a.nch + c) * a.T * kRows * MP +
                                             tile0 * kRows * MP, ntile);
        arrive<MP>(a, b, g, tile0, ntile, &s_last);
    }
}

template <typename K>
cudaError_t set_smem(K kernel, unsigned long long& done, int bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (!(done >> dev & 1ull)) {  // a bit per device: the attribute is set
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return e;
        done |= 1ull << dev;
    }
    return cudaSuccess;
}

template <int NT, int TG>
cudaError_t launch(const Args& a, int smem, cudaStream_t stream) {
    static unsigned long long done = 0;
    const cudaError_t e = set_smem(doppler_energy_k<NT, TG>, done, kMaxDynSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.nch, a.G, (a.B + a.bt - 1) / a.bt);
    doppler_energy_k<NT, TG><<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
}

template <int NT>
cudaError_t launch_tg(const Args& a, int tg, int smem, cudaStream_t stream) {
    if (tg == 1) return launch<NT, 1>(a, smem, stream);
    if (tg == 2) return launch<NT, 2>(a, smem, stream);
    return launch<NT, (NT == 4 ? 2 : 4)>(a, smem, stream);
}

}  // namespace

// rows: (T*16, 2) i32, the plan of ops/doppler_search.py:doppler_energy_plan
// (chunk L, a multiple of 128, nch = ceil(N / L), window capacity wwin);
// tg: tiles a CTA takes (1, 2 or 4; at most 2 for M > 16), bt: blocks a CTA
// takes (k1_grid); part: (B, nch, T*16, MP) f32 scratch with MP = 8 ceil(M /
// 8); count: (B * ceil(T / tg),) i32, zero before the launch and after it;
// vec: 16-byte loads and copies (N % 4 == 0, P and Q 16-byte aligned);
// E: (B, D, M).
PYCUSDR_API int pycusdr_doppler_energy(const float* P, const float* Q, const int* centre,
                                       const int* rows, float* part,
                                       int* count, float* E, int B, int N, int D, int M, int L,
                                       int T, int wwin, int tg, int bt, int vec,
                                       float scale, cudaStream_t stream) {
    const int NT = M <= 8 ? 1 : M <= 16 ? 2 : 4;
    if (B <= 0 || N <= 0 || D <= 0 || M <= 0 || M > 32 || L <= 0 || L % (kLeaves * kStep) ||
        T <= 0 || 16 * T < D || bt <= 0 || !(tg == 1 || tg == 2 || tg == 4) ||
        (NT == 4 && tg == 4))
        return (int)cudaErrorInvalidValue;
    const int MP = 8 * NT;
    if (wwin < kLeaves / 2 * tg * kRows * MP) return (int)cudaErrorInvalidValue;  // to reduce
    const long long smem = 4ll * ((L + 4ll) * MP + wwin);
    if (smem > kMaxDynSmem) return (int)cudaErrorInvalidValue;
    Args a{P, Q, centre, reinterpret_cast<const int2*>(rows), part, count, E,
           B, N, D, M, L, (N + L - 1) / L, T, (T + tg - 1) / tg, wwin, bt, vec, scale};
    cudaError_t e;
    if (NT == 1) {
        e = launch_tg<1>(a, tg, (int)smem, stream);
    } else if (NT == 2) {
        e = launch_tg<2>(a, tg, (int)smem, stream);
    } else {
        e = launch_tg<4>(a, tg, (int)smem, stream);
    }
    return (int)e;
}
