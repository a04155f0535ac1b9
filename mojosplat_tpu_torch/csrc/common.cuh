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

// Slots per chunk of the blend's backward residual: the forward (B1) saves
// each pixel's transmittance at the entry of every kResidChunk-slot chunk,
// and the backward (B2) replays one chunk at a time from it, holding the
// chunk's per-slot transmittance in registers.
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

// Transmittance after a slot of opacity alpha is applied: T * (1 - alpha).
__device__ __forceinline__ float ms_transmit(float T, float alpha) {
    return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}
