// Segment-slice gather: the dense per-tile slot table.
//
// Replaces mojosplat_tpu/ops/slice_pallas.py::segment_slice_gather (the
// Pallas kernel `_kernel`): out[t * cap + j] = src[starts[t] + j] for j < cap,
// with reads outside src giving 0 (the TPU version pads src with zeros and
// takes non-negative starts only). The TPU kernel needs one DMA per tile plus
// a lane roll to undo the 128-alignment of the DMA start.
//
// Here the grid is 2-D: blockIdx.x is the tile, blockIdx.y a run of
// 4 * blockDim.x of its slots, so no thread divides to find its tile, and
// the tile's start is one load that the whole block shares. A thread copies
// 4 consecutive slots: 4 reads of the sorted list (a warp's reads cover 128
// consecutive entries, served from L1 after the first) and, where cap % 4
// == 0 makes every tile's row 16-byte aligned, one 16-byte store; else, and
// at a row's ragged end, 4-byte stores. Values are copied as 32-bit words,
// so any 4-byte type passes bit for bit.
//
// Bound on the card: memory bandwidth, about 8 bytes moved per output
// element; at the trained scene's 2040 x 512 table that is under 3 us, so
// the launch is a large part of a call.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kPerThread = 4;  // slots a thread

__global__ void __launch_bounds__(kMaxThreads)
slice_gather_kernel(const uint32_t* __restrict__ src, int M,
                    const int* __restrict__ starts, int cap,
                    uint32_t* __restrict__ out) {
    const int j0 = (static_cast<int>(blockIdx.y) * blockDim.x + threadIdx.x) * kPerThread;
    if (j0 >= cap) return;
    const int64_t t = blockIdx.x;
    const int64_t k0 = static_cast<int64_t>(__ldg(starts + t)) + j0;
    uint32_t x[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
        const int64_t k = k0 + q;
        x[q] = (j0 + q < cap && k >= 0 && k < M) ? __ldg(src + k) : 0u;
    }
    uint32_t* o = out + t * cap + j0;
    if ((cap & 3) == 0) {
        *reinterpret_cast<uint4*>(o) = make_uint4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
            if (j0 + q < cap) o[q] = x[q];
        }
    }
}

}  // namespace

// src: (M,) of any 4-byte type; starts: (n_tiles,) int32;
// out: (n_tiles * cap,) of src's type, 16-byte aligned.
extern "C" int slice_gather_launch(const void* src, int M, const void* starts,
                                   int n_tiles, int cap, void* out,
                                   void* stream) {
    if (n_tiles <= 0 || cap <= 0) return 0;
    const int per_tile = (cap + kPerThread - 1) / kPerThread;  // threads a tile
    const int threads = per_tile < kMaxThreads ? (per_tile + 31) / 32 * 32 : kMaxThreads;
    const unsigned runs = ms_blocks(per_tile, threads);
    if (runs > 65535u) return static_cast<int>(cudaErrorInvalidValue);
    slice_gather_kernel<<<dim3(n_tiles, runs), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(src), M, static_cast<const int*>(starts),
        cap, static_cast<uint32_t*>(out));
    MS_RETURN_LAUNCH_STATUS();
}
