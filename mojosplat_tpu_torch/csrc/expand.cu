// Segment expansion: per-slot rows from per-gaussian rows by offset ownership.
//
// Replaces mojosplat_tpu/ops/expand_pallas.py::segment_expand_offsets (the
// Pallas kernel `_kernel`), which the binning step uses to give every
// intersection slot its owner gaussian's fields. The TPU kernel builds a
// one-hot ownership matrix per 512-slot chunk and expands with three bf16
// limb matmuls on the MXU, which bounds its exactness at 2^22. Here slot s
// belongs to w = upper_bound(offsets, s) - 1, the last gaussian whose range
// starts at or before s (zero-count gaussians share their offset with the
// next one and so are never chosen; w = -1, a zero row, where the first
// offset exceeds s), and its column is w's column of the int32 fields.
// Integers stay int32 throughout, so there is no exactness bound.
//
// Slots at or past the last gaussian's offset all belong to that gaussian;
// so the slots at or past the total read the last gaussian's row, as the
// TPU kernel's do (the binning step masks them).
//
// Bound on the card: bytes. The F * 4 bytes written per slot, coalesced
// along the slot axis, are nearly all the traffic (at 1M gaussians and 8M
// slots, 168 MB written against 21 MB read). A search per slot would cost
// about log2(N) = 20 dependent loads each, so the search is per block: a
// block of kSlots slots finds the owners of its first slot and of its last
// slot below the last offset with two warp-wide searches (32 probes a
// round, log32(N) = 4 dependent loads), stages the offsets of that owner
// range in shared memory, and each thread then searches there for the
// first slot of each of its runs of 4 and walks on to the others. Presorting
// puts the zero-count gaussians last, so on the binning path a block's range
// holds at most kSlots owners; where zero-count gaussians in the middle make
// it longer than the staging buffer, each thread searches the range in
// global memory instead. A block wholly at or past the last offset writes
// the last gaussian's row without searching. A run's 4 values of a row go
// out as one 16-byte store where the rows are 16-byte aligned, and the
// blocks alternate between the front and the back of the slot range, so
// each wave mixes blocks that search with blocks that only store (the two
// together measured faster than 4-byte stores in block order on an H100;
// PERF.md).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;                   // slots a thread: two runs of 4
constexpr int kSlots = kThreads * kPerThread;  // slots a block

// upper_bound(x[a, b), s) by one thread.
__device__ __forceinline__ int thread_upper_bound(const int* x, int a, int b, int s) {
    while (a < b) {
        const int mid = (a + b) >> 1;
        if (x[mid] <= s) a = mid + 1; else b = mid;
    }
    return a;
}

__global__ void __launch_bounds__(kThreads)
expand_offsets_kernel(const int* __restrict__ fields, int F, int N, int* __restrict__ out,
                      int M) {
    __shared__ int stage[kSlots];
    __shared__ int owner[2];  // the owners of the block's first and last searched slot
    const int tid = threadIdx.x;
    const int b = static_cast<int>(blockIdx.x);
    const int base = ((b & 1) ? static_cast<int>(gridDim.x) - 1 - (b >> 1) : (b >> 1)) * kSlots;
    const int end = static_cast<int>(min(static_cast<int64_t>(base) + kSlots,
                                         static_cast<int64_t>(M)));
    const int last = N > 0 ? __ldg(fields + N - 1) : 0;
    const int e = N > 0 ? min(end, max(last, base)) : base;  // slots [base, e) search

    int lo = 0, n = 0;
    if (e > base) {
        const int warp = tid >> 5;
        if (warp < 2) {
            const int w =
                ms_warp_upper_bound(fields, 0, N, warp == 0 ? base : e - 1, tid & 31) - 1;
            if ((tid & 31) == 0) owner[warp] = w;
        }
        __syncthreads();
        lo = max(owner[0], 0);
        n = owner[1] - lo + 1;  // 0 where no slot of the block has an owner
        if (n <= kSlots) {
            for (int i = tid; i < n; i += kThreads) stage[i] = __ldg(fields + lo + i);
        }
        __syncthreads();
    }

    const bool vec = (M & 3) == 0;  // every row starts 16-byte aligned
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
        const int s0 = base + (k * kThreads + tid) * 4;
        if (s0 >= end) break;
        int w[4];
        int pos = -1;  // the run's owners rise: search for the first, walk to the rest
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int s = s0 + q;
            w[q] = N - 1;
            if (s < e) {
                if (n <= kSlots) {
                    if (pos < 0) {
                        pos = thread_upper_bound(stage, 0, n, s);
                    } else {
                        while (pos < n && stage[pos] <= s) ++pos;
                    }
                    w[q] = lo + pos - 1;
                } else {
                    w[q] = thread_upper_bound(fields, lo, lo + n, s) - 1;
                }
            }
        }
        for (int f = 0; f < F; ++f) {
            int x[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                x[q] = w[q] >= 0 ? __ldg(fields + static_cast<int64_t>(f) * N + w[q]) : 0;
            }
            int* o = out + static_cast<int64_t>(f) * M + s0;
            if (vec && s0 + 3 < end) {
                *reinterpret_cast<int4*>(o) = make_int4(x[0], x[1], x[2], x[3]);
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    if (s0 + q < end) o[q] = x[q];
                }
            }
        }
    }
}

}  // namespace

// fields: (F, N) int32, row 0 the exclusive prefix sum of slot counts.
// out: (F, M) int32.
extern "C" int expand_offsets_launch(const void* fields, int F, int N,
                                     void* out, int M, void* stream) {
    if (M <= 0) return 0;
    expand_offsets_kernel<<<ms_blocks(M, kSlots), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(fields), F, N, static_cast<int*>(out), M);
    MS_RETURN_LAUNCH_STATUS();
}
