// Segment-slice gather: the dense per-tile slot table.
//
// Replaces mojosplat_tpu/ops/slice_pallas.py::segment_slice_gather (the
// Pallas kernel `_kernel`): out[t * cap + j] = src[starts[t] + j] for j < cap,
// with reads outside src giving 0 (the TPU version pads src with zeros and
// takes non-negative starts only). The TPU kernel needs one DMA per tile plus
// a lane roll to undo the 128-alignment of the DMA start; here one thread
// writes one output element, neighbouring threads on neighbouring j, so both
// the read of the sorted list and the write of the table are coalesced.
//
// Bound on the card: memory bandwidth, 8 bytes moved per output element.

#include "common.cuh"

namespace {

__global__ void slice_gather_kernel(const uint32_t* __restrict__ src, int M,
                                    const int* __restrict__ starts, int cap,
                                    uint32_t* __restrict__ out, int64_t total) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
    if (i >= total) return;
    const int64_t t = i / cap;
    const int64_t j = i - t * cap;
    const int64_t k = static_cast<int64_t>(__ldg(starts + t)) + j;
    out[i] = (k >= 0 && k < M) ? __ldg(src + k) : 0u;
}

}  // namespace

// src: (M,) of any 4-byte type; starts: (n_tiles,) int32;
// out: (n_tiles * cap,) of src's type.
extern "C" int slice_gather_launch(const void* src, int M, const void* starts,
                                   int n_tiles, int cap, void* out,
                                   void* stream) {
    const int64_t total = static_cast<int64_t>(n_tiles) * cap;
    if (total <= 0) return 0;
    const int threads = 256;
    slice_gather_kernel<<<ms_blocks(total, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(src), M, static_cast<const int*>(starts),
        cap, static_cast<uint32_t*>(out), total);
    MS_RETURN_LAUNCH_STATUS();
}
