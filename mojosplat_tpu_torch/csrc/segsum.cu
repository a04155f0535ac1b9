// Deterministic segment sum of key-sorted columns.
//
// Replaces mojosplat_tpu/ops/segsum_pallas.py::segment_sum_cols (the Pallas
// kernel `_kernel`), the adjoint of the packed slot gather: per-slot
// gradient columns, sorted by gaussian id, are summed into per-gaussian
// rows. The TPU kernel walks 512-id windows and reduces each with a one-hot
// matmul on the MXU, because every TPU scatter is scalar-core bound. Here
// the wrapper finds each segment's row range [bounds[s], bounds[s + 1]) by
// a binary search over the sorted keys (torch.searchsorted), and one thread
// owns one (field, segment) pair and adds the segment's values in row
// order. Each sum has one fixed order and no atomics, so the result is
// bitwise reproducible; rows with a key >= num_segments lie past
// bounds[num_segments] and are never read.
//
// A thread's time is its segment's length, so a warp waits for its longest
// segment: the kernel suits keys without a heavy segment, as the gather's
// adjoint gives it (a gaussian owns at most one slot per tile it touches).
//
// Bound on the card: memory bandwidth. Every input value is read once
// (neighbouring threads own neighbouring segments, which lie next to each
// other in the sorted columns) and every output written once, coalesced.

#include "common.cuh"

namespace {

__global__ void segsum_kernel(const float* __restrict__ cols, int64_t M,
                              const int64_t* __restrict__ bounds, int S,
                              float* __restrict__ out) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= S) return;
    const int f = blockIdx.y;
    const float* row = cols + static_cast<int64_t>(f) * M;
    const int64_t lo = __ldg(bounds + s);
    const int64_t hi = __ldg(bounds + s + 1);
    float acc = 0.0f;
    for (int64_t i = lo; i < hi; ++i) acc += __ldg(row + i);
    out[static_cast<int64_t>(f) * S + s] = acc;
}

}  // namespace

// cols: (F, M) f32, each row in key order; bounds: (S + 1,) int64
// non-decreasing row offsets; out: (F, S) f32.
extern "C" int segsum_launch(const void* cols, int F, int64_t M,
                             const void* bounds, int S, void* out,
                             void* stream) {
    if (F <= 0 || S <= 0) return 0;
    if (F > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const dim3 grid(ms_blocks(S, threads), F);
    segsum_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cols), M,
        static_cast<const int64_t*>(bounds), S, static_cast<float*>(out));
    MS_RETURN_LAUNCH_STATUS();
}
