// K6 threshold: two-pass interference spike clipping of one block.
//
//   a = |x|, thr1 = scale * mean(a), hit1 = a > thr1, a1 = hit1 ? thr1 : a
//   thr2 = scale * mean(a1), hit2 = a1 > thr2
//   y = (x * g1) * g2, g1 = hit1 ? thr1 / a : 1, g2 = hit2 ? thr2 / a1 : 1
//
// Replaces pycusdr_tpu/ops/demod_kernels.py:threshold_input (:27-46). The
// JAX op is two full-block means and an elementwise rescale that XLA
// fused. Bound: HBM bytes (read x once, write y once, 16 B a sample, plus
// the bitmask): ~0.6 us per STX block (2^17 samples, 1 MB) at 3.35 TB/s.
//
// The sums. A block is cut into chunks of kChunk samples. A chunk's sum is
// taken by 256 threads, thread t adding samples t, t + 256, .. of the
// chunk in order, then the warp butterfly, then the chunk's 8 warps in
// order; the row's sum adds the chunk sums in chunk order. The order is
// fixed by N alone, so a block gives the same bits alone and in any batch
// (process == processMany), and there are no float atomics. a is spelled
// sqrtf(re*re + im*im) and the gains as in the plain version, with __f*_rn
// (no FMA contraction): the kernel differs from the plain version only in
// the order of the two sums.
//
// Cluster form (ops/demod_kernels.py:k6_plan, rows of at most
// kMaxCluster * kMaxChunks chunks: N <= 2^18), one launch: a thread-block
// cluster of G CTAs owns one row, each CTA K chunks with 256 threads a
// chunk. Each thread copies its 16 samples of x into the CTA's shared
// memory (8-byte cp.async in four groups, any N and alignment) and reads
// back only those, so x is read from HBM once; it takes their |x| once,
// group by group as the copies land, and keeps it in registers. The
// chunk's thread 0 writes its chunk sum into every CTA of the cluster
// (distributed shared memory); after a cluster barrier each CTA adds the
// row's chunk sums in chunk order from its own shared memory (thr1); the
// same again for the min-clipped sums (thr2). After that barrier no CTA
// touches another's shared memory: each writes y and the hit2 bitmask (bit
// i of word w is sample 32 w + i, one warp ballot a word), ORs its hits
// into clipped_any (an integer atomicOr; rank 0 zeroes it before the first
// barrier) and leaves. At STX (32 chunks) G = 16 CTAs of 2 chunks: 64 KB
// of shared memory and 512 threads each, two to an SM (a non-portable
// cluster size). Tried on the card and slower, so not kept (PERF.md §6):
// pulling the chunk sums after the barrier, a third barrier before
// leaving, |x| taken again in each pass, three CTAs to an SM (40
// registers: spills), 256 threads taking K chunks each, and |x| in shared
// memory with x read again from L2 in the last pass.
// Long form (longer rows), three launches, one CTA a chunk: per-chunk sums
// of a into `part`; thr1 from them (chunk order) and the min-clipped sums;
// thr2, then y, the bitmask and clipped_any (integer atomicOr). It reads x
// three times.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 4096;       // samples of a chunk (ops/demod_kernels.py:K6_CHUNK)
constexpr int kChunkThreads = 256;  // threads that sum one chunk
constexpr int kSpt = kChunk / kChunkThreads;  // samples a thread of a chunk
constexpr int kWarps = kChunkThreads / 32;
constexpr int kMaxChunks = 4;   // chunks of a cluster-form CTA
constexpr int kMaxCluster = 16;  // CTAs of a cluster (above 8: non-portable)

__device__ __forceinline__ float mag(float2 v) {
    return sqrtf(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
}

// A chunk's sum from its 256 threads' sums v: the warp butterfly, then
// the chunk's warps in order (red: the chunk's kWarps floats). Valid in
// the chunk's thread 0; every thread of the CTA must call it, and red may
// be written again only after a barrier.
__device__ float chunk_sum(float v, float* red, int t) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((t & 31) == 0) red[t >> 5] = v;
    __syncthreads();
    float s = 0.f;
    if (t == 0)
        for (int w = 0; w < kWarps; ++w) s += red[w];
    return s;
}

// scale * (the row's sum) / N, the row's sum being s, added in chunk order
__device__ __forceinline__ float threshold_from(float s, int N, float scale) {
    return __fmul_rn(scale, __fdiv_rn(s, (float)N));
}

// One sample of the last pass, a = |v|: y (written by the caller when the
// sample exists) and hit2. Every lane of the warp must call it: the
// divisions run only in a warp where some lane was clipped (most hold no
// spike), so that they are not computed and discarded for every sample.
__device__ __forceinline__ float2 clip_sample(float2 v, float a, float t1, float t2, bool& h2) {
    const bool h1 = a > t1;
    const float a1 = h1 ? t1 : a;
    h2 = a1 > t2;
    float g1 = 1.f, g2 = 1.f;
    if (__any_sync(0xffffffffu, h1 || h2)) {
        if (h1) g1 = __fdiv_rn(t1, a);
        if (h2) g2 = __fdiv_rn(t2, a1);
    }
    return make_float2(__fmul_rn(__fmul_rn(v.x, g1), g2), __fmul_rn(__fmul_rn(v.y, g1), g2));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

constexpr int kLoadGroups = 4;  // commit groups of a thread's copies

// Wait until at most `pending` of this thread's newest copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_until(int pending) {
    switch (pending) {
        case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
        case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
        case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
        default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    }
}

constexpr int kMaxSums = kMaxChunks * kMaxCluster;

// The row's sum from the chunk sums every CTA has put in this CTA's
// sums[] (zero past nch), added in chunk order; in every thread.
__device__ __forceinline__ float row_sum(const float* sums, int nch) {
    const float4* s4 = reinterpret_cast<const float4*>(sums);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSums / 4; ++q) {
        if (4 * q >= nch) break;
        const float4 v = s4[q];  // the zeros past nch add nothing to s >= 0
        s += v.x;
        s += v.y;
        s += v.z;
        s += v.w;
    }
    return s;
}

// CTAs of K chunks an SM holds at once, which leaves each thread 64
// registers: |x| of its 16 samples stays in registers (three CTAs of 512
// threads, 40 registers, spilled and measured slower)
constexpr int min_blocks(int K) { return K == 1 ? 4 : K == 2 ? 2 : 1; }

// grid (G, B), cluster (G, 1, 1), 256 K threads, 8 * min(N, K * kChunk)
// bytes of dynamic shared memory.
template <int K>
__global__ void __launch_bounds__(K * kChunkThreads, min_blocks(K))
thr_cluster(const float2* __restrict__ x, float2* __restrict__ y, unsigned* __restrict__ hits,
            int* __restrict__ any, int N, float scale) {
    extern __shared__ float2 xs[];
    __shared__ float red[K * kWarps];
    __shared__ __align__(16) float sums[2][kMaxSums];  // every chunk sum of the row, passes 1, 2
    const cg::cluster_group cluster = cg::this_cluster();
    const int grp = threadIdx.x / kChunkThreads, t = threadIdx.x % kChunkThreads;
    const int rank = (int)cluster.block_rank(), G = (int)cluster.num_blocks();
    const int b = blockIdx.y, nch = (N + kChunk - 1) / kChunk;
    const int c = rank * K + grp;  // this thread's chunk
    const int n0 = c * kChunk + t;  // its first sample
    const float2* xb = x + (size_t)b * N;
    float2* own = xs + grp * kChunk + t;  // own[256 i]: sample n0 + 256 i
    float* rd = red + grp * kWarps;

    // every CTA of the cluster must have started before another writes to its
    // shared memory: arrive now, wait before the first such write
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    // the copies in kLoadGroups groups, so that |x| of the first samples is
    // taken while the later ones are still on their way; a thread reads back
    // only its own copies, so it waits for its own groups and no one else's
#pragma unroll
    for (int i = 0; i < kSpt; ++i) {
        if (n0 + i * kChunkThreads < N)
            cp_async8(own + i * kChunkThreads, xb + n0 + i * kChunkThreads);
        if (i % (kSpt / kLoadGroups) == kSpt / kLoadGroups - 1)
            asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int j = nch + threadIdx.x; j < kMaxSums; j += blockDim.x) sums[0][j] = sums[1][j] = 0.f;
    if (rank == 0 && threadIdx.x == 0) any[b] = 0;  // before the first cluster barrier

    float a[kSpt];  // |x| of this thread's samples, taken once (0 past N)
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kLoadGroups; ++q) {
        cp_async_wait_until(kLoadGroups - 1 - q);
#pragma unroll
        for (int i = q * (kSpt / kLoadGroups); i < (q + 1) * (kSpt / kLoadGroups); ++i) {
            const bool in = n0 + i * kChunkThreads < N;
            a[i] = in ? mag(own[i * kChunkThreads]) : 0.f;
            if (in) s += a[i];
        }
    }
    s = chunk_sum(s, rd, t);
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (t == 0 && c < nch)  // into every CTA of the cluster (distributed shared memory)
        for (int r = 0; r < G; ++r) *cluster.map_shared_rank(&sums[0][c], r) = s;
    cluster.sync();
    const float t1 = threshold_from(row_sum(sums[0], nch), N, scale);

    s = 0.f;
#pragma unroll
    for (int i = 0; i < kSpt; ++i)
        if (n0 + i * kChunkThreads < N) s += a[i] > t1 ? t1 : a[i];
    s = chunk_sum(s, rd, t);
    if (t == 0 && c < nch)
        for (int r = 0; r < G; ++r) *cluster.map_shared_rank(&sums[1][c], r) = s;
    // past this barrier no CTA touches another's shared memory, so each may leave when done
    cluster.sync();
    const float t2 = threshold_from(row_sum(sums[1], nch), N, scale);

    float2* yb = y + (size_t)b * N;
    unsigned* hb = hits + (size_t)b * ((N + 31) / 32);
    bool hit_any = false;
#pragma unroll
    for (int i = 0; i < kSpt; ++i) {
        const int n = n0 + i * kChunkThreads;
        bool h2 = false;
        const float2 o = clip_sample(n < N ? own[i * kChunkThreads] : make_float2(0.f, 0.f), a[i],
                                     t1, t2, h2);
        if (n < N) yb[n] = o;
        // a warp's lanes hold 32 consecutive samples from a multiple of 32
        const unsigned word = __ballot_sync(0xffffffffu, h2);
        if ((t & 31) == 0 && n < N) hb[n >> 5] = word;
        hit_any |= word != 0u;
    }
    if (__syncthreads_or(hit_any) && threadIdx.x == 0) atomicOr(any + b, 1);
}

// ---- long form: one CTA (256 threads) a chunk, grid (nch, B)

// scale * (sum of the nch partials in chunk order) / N
__device__ float threshold_of(const float* part, int nch, int N, float scale) {
    float s = 0.f;
    for (int c = 0; c < nch; ++c) s += part[c];
    return threshold_from(s, N, scale);
}

__global__ void __launch_bounds__(kChunkThreads)
thr_pass1(const float2* __restrict__ x, float* __restrict__ part1, int* __restrict__ any, int N,
          int nch) {
    __shared__ float red[kWarps];
    const int c = blockIdx.x, b = blockIdx.y;
    const float2* xb = x + (size_t)b * N;
    const int k1 = min(N, (c + 1) * kChunk);
    float s = 0.f;
    for (int k = c * kChunk + threadIdx.x; k < k1; k += kChunkThreads) s += mag(xb[k]);
    s = chunk_sum(s, red, threadIdx.x);
    if (threadIdx.x == 0) {
        part1[(size_t)b * nch + c] = s;
        if (c == 0) any[b] = 0;
    }
}

__global__ void __launch_bounds__(kChunkThreads)
thr_pass2(const float2* __restrict__ x, const float* __restrict__ part1,
          float* __restrict__ part2, int N, int nch, float scale) {
    __shared__ float red[kWarps];
    __shared__ float t1s;
    const int c = blockIdx.x, b = blockIdx.y;
    if (threadIdx.x == 0) t1s = threshold_of(part1 + (size_t)b * nch, nch, N, scale);
    __syncthreads();
    const float t1 = t1s;
    const float2* xb = x + (size_t)b * N;
    const int k1 = min(N, (c + 1) * kChunk);
    float s = 0.f;
    for (int k = c * kChunk + threadIdx.x; k < k1; k += kChunkThreads) {
        const float a = mag(xb[k]);
        s += a > t1 ? t1 : a;
    }
    s = chunk_sum(s, red, threadIdx.x);
    if (threadIdx.x == 0) part2[(size_t)b * nch + c] = s;
}

__global__ void __launch_bounds__(kChunkThreads)
thr_pass3(const float2* x, float2* y, const float* __restrict__ part1,
          const float* __restrict__ part2, unsigned* __restrict__ hits, int* __restrict__ any,
          int N, int nch, float scale) {
    __shared__ float ts[2];
    const int c = blockIdx.x, b = blockIdx.y;
    if (threadIdx.x == 0) {
        ts[0] = threshold_of(part1 + (size_t)b * nch, nch, N, scale);
        ts[1] = threshold_of(part2 + (size_t)b * nch, nch, N, scale);
    }
    __syncthreads();
    const float t1 = ts[0], t2 = ts[1];
    const float2* xb = x + (size_t)b * N;
    float2* yb = y + (size_t)b * N;
    unsigned* hb = hits + (size_t)b * ((N + 31) / 32);
    bool hit_any = false;
    for (int i = 0; i < kSpt; ++i) {  // every lane of a warp reaches each ballot
        const int n = c * kChunk + i * kChunkThreads + threadIdx.x;
        bool h2 = false;
        const float2 v = n < N ? xb[n] : make_float2(0.f, 0.f);
        const float2 o = clip_sample(v, mag(v), t1, t2, h2);
        if (n < N) yb[n] = o;
        const unsigned word = __ballot_sync(0xffffffffu, h2);
        if ((threadIdx.x & 31) == 0 && n < N) hb[n >> 5] = word;
        hit_any |= word != 0u;
    }
    if ((threadIdx.x & 31) == 0 && hit_any) atomicOr(any + b, 1);
}

// Let thr_cluster<K> take its dynamic shared memory and a cluster of
// kMaxCluster CTAs; once per process, instantiation and device.
template <int K>
cudaError_t allow_cluster() {
    static unsigned long long done = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || dev >= 64) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
    if (done >> dev & 1ull) return cudaSuccess;
    e = cudaFuncSetAttribute(thr_cluster<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             8 * kChunk * K);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(thr_cluster<K>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) done |= 1ull << dev;
    return e;
}

// The launch of the cluster form for B rows of N samples.
bool cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int B, int N,
                    int chunks, int cluster, cudaStream_t stream) {
    if (chunks < 1 || chunks > kMaxChunks || cluster < 1 || cluster > kMaxCluster ||
        (long long)cluster * chunks * kChunk < N || (long long)(cluster - 1) * chunks * kChunk >= N)
        return false;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(cluster, B);
    cfg.blockDim = dim3(kChunkThreads * chunks);
    cfg.dynamicSmemBytes = 8 * (size_t)min(N, chunks * kChunk);
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return true;
}

// Launch (or, count != NULL, count the clusters the device holds at once
// of) thr_cluster<K>.
template <int K>
cudaError_t run_cluster(const cudaLaunchConfig_t& cfg, const float2* x, float2* y,
                        unsigned* hits, int* any, int N, float scale, int* count) {
    cudaError_t e = allow_cluster<K>();
    if (e != cudaSuccess) return e;
    if (count) return cudaOccupancyMaxActiveClusters(count, thr_cluster<K>, &cfg);
    return cudaLaunchKernelEx(&cfg, thr_cluster<K>, x, y, hits, any, N, scale);
}

cudaError_t run_cluster(int chunks, const cudaLaunchConfig_t& cfg, const float2* x, float2* y,
                        unsigned* hits, int* any, int N, float scale, int* count) {
    switch (chunks) {
        case 1: return run_cluster<1>(cfg, x, y, hits, any, N, scale, count);
        case 2: return run_cluster<2>(cfg, x, y, hits, any, N, scale, count);
        case 3: return run_cluster<3>(cfg, x, y, hits, any, N, scale, count);
        default: return run_cluster<4>(cfg, x, y, hits, any, N, scale, count);
    }
}

}  // namespace

// x, y: (B, N) complex64 (y must not overlap x); hits: (B, ceil(N / 32))
// u32, the bits past N zero; any: (B,) i32. The plan (ops/demod_kernels.py:
// k6_plan): long 0 is the cluster form, `cluster` CTAs a row of `chunks`
// chunks each (part unused, may be NULL); long 1 is the long form, part:
// (2, B, ceil(N / chunk)) f32 scratch. chunk must be kChunk.
PYCUSDR_API int pycusdr_threshold(const float2* x, float2* y, float* part, unsigned* hits,
                                  int* any, int B, int N, int chunk, float scale, int long_form,
                                  int chunks, int cluster, cudaStream_t stream) {
    if (B <= 0 || N <= 0 || chunk != kChunk || B > 65535) return (int)cudaErrorInvalidValue;
    if (long_form) {
        if (!part) return (int)cudaErrorInvalidValue;
        const int nch = (N + kChunk - 1) / kChunk;
        float* part1 = part;
        float* part2 = part + (size_t)B * nch;
        const dim3 grid(nch, B);
        thr_pass1<<<grid, kChunkThreads, 0, stream>>>(x, part1, any, N, nch);
        thr_pass2<<<grid, kChunkThreads, 0, stream>>>(x, part1, part2, N, nch, scale);
        thr_pass3<<<grid, kChunkThreads, 0, stream>>>(x, y, part1, part2, hits, any, N, nch, scale);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    if (!cluster_config(cfg, attr, B, N, chunks, cluster, stream))
        return (int)cudaErrorInvalidValue;
    const cudaError_t e = run_cluster(chunks, cfg, x, y, hits, any, N, scale, nullptr);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// How many clusters of the cluster form's launch (the plan's chunks and
// cluster at N) the current device holds at once, into *count.
PYCUSDR_API int pycusdr_threshold_clusters(int N, int chunks, int cluster, int* count) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    if (!count || !cluster_config(cfg, attr, 1, N, chunks, cluster, 0))
        return (int)cudaErrorInvalidValue;
    return (int)run_cluster(chunks, cfg, nullptr, nullptr, nullptr, nullptr, N, 0.f, count);
}
