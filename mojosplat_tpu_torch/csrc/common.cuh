// Shared helpers for the kernel library's plain C entry points.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Each entry point launches on the caller's stream and reports the launch
// status; the Python wrapper raises on a nonzero code.
#define MS_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())

static inline unsigned ms_blocks(int64_t n, int threads) {
    return static_cast<unsigned>((n + threads - 1) / threads);
}

// upper_bound(x[a, b), s): the first index in [a, b) whose value exceeds s,
// or b, for x non-decreasing. One whole warp calls it with the same
// arguments; each round its 32 lanes probe 32 evenly spaced values and keep
// the segment where they change from <= s to > s, so it takes log32(b - a)
// dependent loads. B4 finds a block's owners with it, B3 a window's rows.
// (An anonymous namespace, as where B4 first defined it.)
namespace {
__device__ int ms_warp_upper_bound(const int* __restrict__ x, int a, int b, int s, int lane) {
    while (b - a > 32) {
        const int step = (b - a + 31) / 32;
        const int q = a + lane * step;
        const int c = __popc(__ballot_sync(0xffffffffu, q < b && __ldg(x + q) <= s));
        if (c == 0) return a;
        b = min(a + c * step, b);
        a += (c - 1) * step + 1;
    }
    return a + __popc(__ballot_sync(0xffffffffu, a + lane < b && __ldg(x + a + lane) <= s));
}
}  // namespace

// Slots per chunk of the blend's backward residual: the forward (B1) saves
// each pixel's transmittance at the entry of every kResidChunk-slot chunk,
// and the backward (B2) replays one chunk at a time from it, saving the
// chunk's per-slot transmittance in shared memory. The surfel kernels
// (B6-B8) use the same residual format.
constexpr int kResidChunk = 16;

// One slot's alpha at one pixel, the per-pixel rule of rasterization.py:
//
//   sigma = 0.5 * (a dx^2 + c dy^2) + b dx dy,  raw = opacity * exp(-sigma)
//   alpha = min(raw, max_alpha), kept iff sigma >= 0 and alpha >= threshold
//
// B1 and B2 both call this, so the backward reconstructs the forward's
// applied set bit for bit: every product and sum is an explicit
// round-to-nearest intrinsic, which nvcc never contracts into an FMA, so
// the float operations cannot differ between the two kernels. The clamp is
// a compare rather than fminf, so a NaN sigma or alpha is skipped, as the
// reference's select skips it. Returns whether the slot is kept.
__device__ __forceinline__ bool ms_slot_alpha(float dx, float dy, float ca,
                                              float cb, float cc, float op,
                                              float alpha_threshold,
                                              float max_alpha, float& e,
                                              float& raw, float& alpha) {
    const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                 __fmul_rn(__fmul_rn(cc, dy), dy));
    const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                  __fmul_rn(__fmul_rn(cb, dx), dy));
    e = expf(-sigma);
    raw = __fmul_rn(op, e);
    alpha = raw > max_alpha ? max_alpha : raw;
    return sigma >= 0.0f && alpha >= alpha_threshold;
}

// A staged slot record: the slot's 6 + cp fields padded to a whole number of
// 16-byte words, so a warp reads a slot with a few float4 loads (one
// broadcast each) instead of one load a field.
template <int CP>
__host__ __device__ constexpr int ms_record() { return (6 + CP + 3) / 4 * 4; }

// Staged slot j's fields f[0..rec) from a record array in shared memory.
template <int CP>
__device__ __forceinline__ void ms_load_record(const float* records, int j,
                                               float (&f)[ms_record<CP>()]) {
    const float4* rec = reinterpret_cast<const float4*>(records) + j * (ms_record<CP>() / 4);
#pragma unroll
    for (int q = 0; q < ms_record<CP>() / 4; ++q) {
        const float4 g = rec[q];
        f[4 * q] = g.x;
        f[4 * q + 1] = g.y;
        f[4 * q + 2] = g.z;
        f[4 * q + 3] = g.w;
    }
}

// Rows of the warp transpose below.
constexpr int kTransposeRows = 16;

// One step of the warp transpose: a lane keeps rows [0, H) or [H, 2H) of
// its first 2H values (by lane bit 2H) and adds its partner's copy of them.
// H is a template parameter so every index is a constant and x stays in
// registers. The empty asm makes both values opaque: otherwise the compiler
// folds the selects into a load from a selected address of x, which moves x
// to local memory.
template <int H>
__device__ __forceinline__ void ms_transpose_step(float (&x)[kTransposeRows], int lane) {
    const bool up = (lane & (2 * H)) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
        float lo = x[i];
        float hi = x[i + H];
        asm("" : "+f"(lo), "+f"(hi));
        x[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, 2 * H);
    }
}

// Sum x (16 values a lane) over the warp by a transpose (reduce-scatter):
// row r's sum lands in lanes 2r and 2r + 1, after 8 + 4 + 2 + 1 + 1 = 16
// shuffles, where a butterfly per row would take 80. The blend backwards
// (B2, B8) reduce each slot's gradient rows with it.
__device__ __forceinline__ float ms_warp_transpose_sum(float (&x)[kTransposeRows], int lane) {
    ms_transpose_step<8>(x, lane);
    ms_transpose_step<4>(x, lane);
    ms_transpose_step<2>(x, lane);
    ms_transpose_step<1>(x, lane);
    return x[0] + __shfl_xor_sync(0xffffffffu, x[0], 1);
}

// The launch shape of a kernel with threads-thread blocks and smem bytes of
// dynamic shared memory, as the runtime sees it: out[0..6] = registers a
// thread, shared bytes a block (static and dynamic), local
// (spill) bytes a thread, threads a block, the cluster width (1 for a
// kernel without clusters), resident blocks per SM, and resident clusters
// on the card (for a grid of 1024 clusters; blocks for a kernel without
// clusters).
static inline int ms_cluster_shape(const void* fn, int threads, int cluster, int* out,
                                   int smem = 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0, clusters = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.requiredClusterWidth > 0) {
        cudaLaunchConfig_t config = {};
        config.gridDim = dim3(cluster * 1024);
        config.blockDim = dim3(threads);
        config.dynamicSmemBytes = smem;
        err = cudaOccupancyMaxActiveClusters(&clusters, fn, &config);
    } else {
        int device = 0, sms = 0;
        err = cudaGetDevice(&device);
        if (err == cudaSuccess) {
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        }
        clusters = blocks * sms;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes) + smem;
    out[2] = static_cast<int>(attr.localSizeBytes);
    out[3] = threads;
    out[4] = attr.requiredClusterWidth > 0 ? attr.requiredClusterWidth : 1;
    out[5] = blocks;
    out[6] = clusters;
    return 0;
}

// Transmittance after a slot of opacity alpha is applied: T * (1 - alpha).
__device__ __forceinline__ float ms_transmit(float T, float alpha) {
    return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// Whether any pixel of one pixel row may keep a slot under ms_slot_alpha:
// false only when none can. B1 and B2 skip the slots a warp's rows cannot
// keep, so both reach the applied set of the full walk, and every float
// operation on a kept slot stays ms_slot_alpha's.
//
// The row's pixel centres run from x_first to x_last at height py. The
// per-pixel rule rounds dx = mx - x and dy = my - py, and rounding is
// monotone, so every pixel's dx lies in [mx - x_last, mx - x_first] with
// this dy. Along the row sigma(dx) = 0.5 a dx^2 + b dy dx + 0.5 c dy^2 is
// convex for a > 0, so its minimum over that range is at -b dy / a clamped
// to it. Less a margin of 1e-5 (1 + the terms' magnitude), which covers the
// few ulps of f32 rounding in this sigma and the pixel's (and the exp's), it
// bounds every pixel's sigma from below; opacity * exp(-bound) below the
// threshold then means no pixel of the row keeps the slot (a negative sigma
// is never kept either). a <= 0, a NaN anywhere and a threshold <= 0 may
// apply. ops/raster_cuda.py::row_may_apply_plain mirrors each operation.
__device__ __forceinline__ bool ms_row_may_apply(float mx, float my, float ca, float cb,
                                                 float cc, float op, float x_first,
                                                 float x_last, float py,
                                                 float alpha_threshold) {
    if (!(alpha_threshold > 0.0f) || !(ca > 0.0f)) return true;
    const float dy = __fsub_rn(my, py);
    const float lo = __fsub_rn(mx, x_last);
    const float hi = __fsub_rn(mx, x_first);
    const float bdy = __fmul_rn(cb, dy);
    float t = __fdiv_rn(-bdy, ca);
    if (t != t) return true;
    t = fminf(fmaxf(t, lo), hi);
    const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, t), t), __fmul_rn(__fmul_rn(cc, dy), dy));
    const float sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(bdy, t));
    const float x = fmaxf(fabsf(lo), fabsf(hi));
    const float mag = __fadd_rn(
        __fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, x), x),
                                  __fmul_rn(__fmul_rn(fabsf(cc), dy), dy))),
        __fmul_rn(fabsf(bdy), x));
    const float low = __fsub_rn(sigma, __fmul_rn(1e-5f, __fadd_rn(mag, 1.0f)));
    return !(__fmul_rn(op, expf(-low)) < alpha_threshold);
}
