// Deterministic segment sum of key-sorted columns.
//
// Replaces mojosplat_tpu/ops/segsum_pallas.py::segment_sum_cols (the Pallas
// kernel `_kernel`), the adjoint of the packed slot gather: per-slot
// gradient columns, sorted by gaussian id, are summed into per-gaussian
// rows. The TPU kernel walks 512-id windows and reduces each with a one-hot
// matmul on the MXU, because every TPU scatter is scalar-core bound.
//
// Here one launch does it all. A block owns a window of kThreads
// consecutive segments, one a thread, and a group of at most kGroup fields
// (F split evenly over ceil(F / kGroup) blocks of each window). Two warps
// find the window's row range [lo, hi) with one warp-wide search each over
// the sorted keys (ms_warp_upper_bound, about five dependent loads); rows
// with a key >= num_segments (or < 0) lie outside every window's range and
// are never read. The block reads the range's keys once, coalesced, and a
// row that begins or ends its key's run records that row in shared memory,
// so each segment knows its rows [first, last). Each thread then adds its
// segment's rows in row order from 0.0f, loading kBatch rows of its fields
// at once before it adds them, and writes each sum once, coalesced across
// the block (an empty segment writes 0). Each sum keeps the row order of a
// serial walk and uses no atomics, so the result is bitwise reproducible
// and equal to index_add_ on the CPU.
//
// With `perm`, sorted row i reads column perm[i] of the unsorted columns:
// the payload copy that a sort carrying the payload makes
// (cols.index_select(1, perm)) is never written.
//
// Bound on the card: memory bandwidth (every live value and key read once,
// every output written once), but the kernel is latency bound: the search,
// the run marks and each segment's serial rows are dependent loads, and the
// gather adjoint's keys are skewed (at the trained 1080p view 70% of the
// windows are empty and a busy one holds up to 3,000 rows, up to 16 a
// segment). Splitting the fields over blocks keeps 6 blocks of 256 threads
// an SM busy on the dense windows, and loading a batch of rows at once
// shortens a long segment's chain of loads; staging a window's rows in
// shared memory, walking windows in persistent blocks, blocks over row
// chunks with the empty windows zeroed apart, and one search shared by
// several field groups all measured slower (PERF.md).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // segments a block, one a thread
constexpr int kGroup = 3;      // fields a block sums, at most
constexpr int kBatch = 4;      // rows of a segment loaded at once

// Fields a block sums for F fields: F split evenly over ceil(F / kGroup)
// blocks of each window.
__host__ __device__ constexpr int group_fields(int F) {
    return (F + (F + kGroup - 1) / kGroup - 1) / ((F + kGroup - 1) / kGroup);
}

// Block w * groups + g sums fields [g G, g G + G) of window w's segments.
__global__ void __launch_bounds__(kThreads, 6)
segsum_kernel(const float* __restrict__ cols, int F, int M,
              const int64_t* __restrict__ perm, const int* __restrict__ keys, int S,
              float* __restrict__ out) {
    __shared__ int first[kThreads], last[kThreads];  // a segment's rows [first, last)
    __shared__ int range[2];
    const int G = group_fields(F);
    const int groups = (F + G - 1) / G;
    const int w = static_cast<int>(blockIdx.x) / groups;
    const int f0 = static_cast<int>(blockIdx.x) % groups * G;
    const int nf = min(G, F - f0);
    const float* base = cols + static_cast<int64_t>(f0) * M;
    float* dst = out + static_cast<int64_t>(f0) * S;
    const int tid = threadIdx.x;
    const int s0 = w * kThreads;
    const int s = s0 + tid;
    first[tid] = 0;
    last[tid] = 0;
    if (tid < 64) {
        // Warp 0: the first row with a key >= s0; warp 1: >= the window's end.
        const int bound = tid < 32 ? s0 : min(s0 + kThreads, S);
        const int r = ms_warp_upper_bound(keys, 0, M, bound - 1, tid & 31);
        if ((tid & 31) == 0) range[tid >> 5] = r;
    }
    __syncthreads();
    const int lo = range[0], hi = range[1];
    for (int i = lo + tid; i < hi; i += kThreads) {
        const int k = __ldg(keys + i);
        if (i == lo || __ldg(keys + i - 1) != k) first[k - s0] = i;
        if (i == hi - 1 || __ldg(keys + i + 1) != k) last[k - s0] = i + 1;
    }
    __syncthreads();
    if (s >= S) return;
    const int a = first[tid], b = last[tid];
    float acc[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) acc[q] = 0.0f;
    for (int i0 = a; i0 < b; i0 += kBatch) {
        // A batch of the segment's rows (the last one repeated past its
        // end): every load in flight at once, then the adds in row order.
        int64_t col[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = min(i0 + u, b - 1);
            col[u] = perm ? __ldg(perm + i) : static_cast<int64_t>(i);
        }
        float v[kBatch][kGroup];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
            for (int q = 0; q < kGroup; ++q) {
                v[u][q] = q < nf ? __ldg(base + static_cast<int64_t>(q) * M + col[u]) : 0.0f;
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            if (i0 + u < b) {
#pragma unroll
                for (int q = 0; q < kGroup; ++q) acc[q] += v[u][q];
            }
        }
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
        if (q < nf) dst[static_cast<int64_t>(q) * S + s] = acc[q];
    }
}

}  // namespace

// cols: (F, M) f32, each row in key order, or with perm (M,) int64 (may be
// null) in any order, sorted row i being column perm[i]; keys: (M,) int32
// sorted ascending; out: (F, S) f32, every value written.
extern "C" int segsum_launch(const void* cols, int F, int M, const void* perm,
                             const void* keys, int S, void* out, void* stream) {
    if (F <= 0 || S <= 0) return 0;
    const int G = group_fields(F);
    const int64_t blocks = static_cast<int64_t>(ms_blocks(S, kThreads)) * ((F + G - 1) / G);
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    segsum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cols), F, M, static_cast<const int64_t*>(perm),
        static_cast<const int*>(keys), S, static_cast<float*>(out));
    MS_RETURN_LAUNCH_STATUS();
}

// B3's launch shape into out[0..6] (ms_cluster_shape).
extern "C" int segsum_info(int* out) {
    return ms_cluster_shape(reinterpret_cast<const void*>(segsum_kernel), kThreads, 1, out);
}
