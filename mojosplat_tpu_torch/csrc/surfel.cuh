// The surfel (2DGS) response of one slot at one pixel, shared by the blend
// forward (B6/B7, surfel_fwd.cu) and its backward (B8, surfel_bwd.cu).
#pragma once

#include "common.cuh"

// Rows of the packed slot table (ops/surfel_cuda.py): primed qc (0-2), a
// (3-5), b (6-8), the projected centre (9-10), opacity (11), rgb (12-14),
// then a zero pad row (15) or, with the maps, camera-frame normals (15-17).
constexpr int kSurfelRows = 16;
constexpr int kSurfelAuxRows = 18;

// The per-(pixel, slot) terms the backward reads again.
struct MsSurfel {
    float A11, A12, A21, A22;  // the 2x2 system of the ray/disk hit
    float det;                 // its determinant, 1 where the solve fails
    float u, v, s2;            // the hit in disk coordinates, min(u^2 + v^2, 1e4)
    float g_surf, g_filt;      // the surface response and the low-pass filter
    float dx, dy;              // pixel minus projected centre
    float raw, alpha;          // opacity * max(g_surf, g_filt), min(raw, max_alpha)
    bool ok;                   // |det| > 1e-9
};

// One slot's alpha at pixel (px, py); s points at the slot's row 0 and
// rows are ld floats apart. The rule of surfel_pallas.py:90-114:
//
//   A11 = a0' - px a2   A12 = b0' - px b2   r1 = px qc2 - qc0'
//   A21 = a1' - py a2   A22 = b1' - py b2   r2 = py qc2 - qc1'
//   (u, v) = A^-1 r where |det A| > 1e-9;  s2 = min(u^2 + v^2, 1e4)
//   g_surf = exp(-s2 / 2) (0 where the solve fails)
//   g_filt = exp(-(dx^2 + dy^2) / (2 * 0.5))
//   alpha = min(opacity * max(g_surf, g_filt), max_alpha), kept iff >= threshold
//
// There is no sigma >= 0 test, unlike the 3DGS rule of ms_slot_alpha.
// Every product, sum, quotient and FMA is an explicit round-to-nearest
// intrinsic, which nvcc never contracts or splits, so the forward and the
// backward's replay compute the same bits and apply the same slots.
// The clamps are compares, so a NaN alpha is skipped. Returns whether the
// slot is kept.
__device__ __forceinline__ bool ms_surfel_alpha(const float* s, int ld, float px, float py,
                                                float alpha_threshold, float max_alpha,
                                                MsSurfel& g) {
    const float qc0 = s[0], qc1 = s[ld], qc2 = s[2 * ld];
    const float a0 = s[3 * ld], a1 = s[4 * ld], a2 = s[5 * ld];
    const float b0 = s[6 * ld], b1 = s[7 * ld], b2 = s[8 * ld];
    // The primed differences cancel where the pixel is far from the
    // principal point (a0' = fx a0 + cx a2 against px a2): one rounding,
    // an explicit FMA, keeps them as accurate as the reference's compiler
    // makes them.
    g.A11 = __fmaf_rn(-px, a2, a0);
    g.A12 = __fmaf_rn(-px, b2, b0);
    g.A21 = __fmaf_rn(-py, a2, a1);
    g.A22 = __fmaf_rn(-py, b2, b1);
    const float r1 = -__fmaf_rn(-px, qc2, qc0);
    const float r2 = -__fmaf_rn(-py, qc2, qc1);
    const float det = __fsub_rn(__fmul_rn(g.A11, g.A22), __fmul_rn(g.A12, g.A21));
    g.ok = fabsf(det) > 1e-9f;
    g.det = g.ok ? det : 1.0f;
    g.u = __fdiv_rn(__fsub_rn(__fmul_rn(r1, g.A22), __fmul_rn(r2, g.A12)), g.det);
    g.v = __fdiv_rn(__fsub_rn(__fmul_rn(g.A11, r2), __fmul_rn(g.A21, r1)), g.det);
    const float q = __fadd_rn(__fmul_rn(g.u, g.u), __fmul_rn(g.v, g.v));
    g.s2 = q < 1e4f ? q : 1e4f;
    g.g_surf = g.ok ? expf(__fmul_rn(-0.5f, g.s2)) : 0.0f;
    g.dx = __fsub_rn(px, s[9 * ld]);
    g.dy = __fsub_rn(py, s[10 * ld]);
    // 2 * 0.5 = 1: the division by the filter's doubled variance is exact.
    g.g_filt = expf(-__fadd_rn(__fmul_rn(g.dx, g.dx), __fmul_rn(g.dy, g.dy)));
    const float gm = g.g_surf >= g.g_filt ? g.g_surf : g.g_filt;
    g.raw = __fmul_rn(s[11 * ld], gm);
    g.alpha = g.raw > max_alpha ? max_alpha : g.raw;
    return g.alpha >= alpha_threshold;
}

// Whether the surface branch gives the depth: the solve held and the
// surface response is not below the filter's (a tie picks the surface).
__device__ __forceinline__ bool ms_surfel_use_surf(const MsSurfel& g) {
    return g.ok && g.g_surf >= g.g_filt;
}

// The ray/disk intersection depth z = qc2 + u a2 + v b2 on the surface
// branch, the centre depth qc2 elsewhere (surfel_pallas.py:121-122).
__device__ __forceinline__ float ms_surfel_depth(const float* s, int ld, const MsSurfel& g) {
    const float qc2 = s[2 * ld];
    if (!ms_surfel_use_surf(g)) return qc2;
    return __fadd_rn(__fadd_rn(qc2, __fmul_rn(g.u, s[5 * ld])), __fmul_rn(g.v, s[8 * ld]));
}
