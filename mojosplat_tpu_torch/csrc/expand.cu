// Segment expansion: per-slot rows from per-gaussian rows by offset ownership.
//
// Replaces mojosplat_tpu/ops/expand_pallas.py::segment_expand_offsets (the
// Pallas kernel `_kernel`), which the binning step uses to give every
// intersection slot its owner gaussian's fields. The TPU kernel builds a
// one-hot ownership matrix per 512-slot chunk and expands with three bf16
// limb matmuls on the MXU, which bounds its exactness at 2^22. Here each
// thread owns one slot s, binary-searches the non-decreasing offsets row for
// its owner w = upper_bound(offsets, s) - 1 (the last gaussian whose range
// starts at or before s; zero-count gaussians share their offset with the
// next one and so are never chosen) and copies that gaussian's int32 fields.
// Integers stay int32 throughout, so there is no exactness bound.
//
// Slots at or past the total own nothing; like the TPU kernel, they read the
// last gaussian's row (the binning step masks them).
//
// Bound on the card: the search reads ~log2(N) offsets per slot from L2 (the
// 4 MB offsets row of a 1M-gaussian scene stays resident); the copy writes
// F * 4 bytes per slot, coalesced along the slot axis.

#include "common.cuh"

namespace {

__global__ void expand_offsets_kernel(const int* __restrict__ fields, int F,
                                      int N, int* __restrict__ out, int M) {
    const int64_t s = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
    if (s >= M) return;
    // upper_bound over fields[0, 0:N].
    int lo = 0, hi = N;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(fields + mid) <= s) lo = mid + 1; else hi = mid;
    }
    const int w = lo - 1;
    for (int f = 0; f < F; ++f) {
        out[static_cast<int64_t>(f) * M + s] =
            w >= 0 ? __ldg(fields + static_cast<int64_t>(f) * N + w) : 0;
    }
}

}  // namespace

// fields: (F, N) int32, row 0 the exclusive prefix sum of slot counts.
// out: (F, M) int32.
extern "C" int expand_offsets_launch(const void* fields, int F, int N,
                                     void* out, int M, void* stream) {
    if (M <= 0) return 0;
    const int threads = 256;
    expand_offsets_kernel<<<ms_blocks(M, threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(fields), F, N, static_cast<int*>(out), M);
    MS_RETURN_LAUNCH_STATUS();
}
