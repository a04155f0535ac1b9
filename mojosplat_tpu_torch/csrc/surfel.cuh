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

// The terms of one slot's alpha that depend only on the pixel's column
// (px) or only on its row (py); the row test below takes them at a row's
// end pixels.
struct MsSurfelCol {
    float A11, A12, r1, dx;
};
struct MsSurfelRow {
    float A21, A22, r2, dy;
};

// s points at the slot's row 0 and rows are ld floats apart. The primed
// differences cancel where the pixel is far from the principal point
// (a0' = fx a0 + cx a2 against px a2): one rounding, an explicit FMA, keeps
// them as accurate as the reference's compiler makes them.
__device__ __forceinline__ MsSurfelCol ms_surfel_col(const float* s, int ld, float px) {
    return {__fmaf_rn(-px, s[5 * ld], s[3 * ld]), __fmaf_rn(-px, s[8 * ld], s[6 * ld]),
            -__fmaf_rn(-px, s[2 * ld], s[0]), __fsub_rn(px, s[9 * ld])};
}
__device__ __forceinline__ MsSurfelRow ms_surfel_row(const float* s, int ld, float py) {
    return {__fmaf_rn(-py, s[5 * ld], s[4 * ld]), __fmaf_rn(-py, s[8 * ld], s[7 * ld]),
            -__fmaf_rn(-py, s[2 * ld], s[ld]), __fsub_rn(py, s[10 * ld])};
}

// One slot's alpha at pixel (px, py). The rule of surfel_pallas.py:90-114:
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
    const MsSurfelCol c = ms_surfel_col(s, ld, px);
    const MsSurfelRow r = ms_surfel_row(s, ld, py);
    g.A11 = c.A11;
    g.A12 = c.A12;
    g.A21 = r.A21;
    g.A22 = r.A22;
    const float det = __fsub_rn(__fmul_rn(g.A11, g.A22), __fmul_rn(g.A12, g.A21));
    g.ok = fabsf(det) > 1e-9f;
    g.det = g.ok ? det : 1.0f;
    g.u = __fdiv_rn(__fsub_rn(__fmul_rn(c.r1, g.A22), __fmul_rn(r.r2, g.A12)), g.det);
    g.v = __fdiv_rn(__fsub_rn(__fmul_rn(g.A11, r.r2), __fmul_rn(g.A21, c.r1)), g.det);
    const float q = __fadd_rn(__fmul_rn(g.u, g.u), __fmul_rn(g.v, g.v));
    g.s2 = q < 1e4f ? q : 1e4f;
    g.g_surf = g.ok ? expf(__fmul_rn(-0.5f, g.s2)) : 0.0f;
    g.dx = c.dx;
    g.dy = r.dy;
    // 2 * 0.5 = 1: the division by the filter's doubled variance is exact.
    g.g_filt = expf(-__fadd_rn(__fmul_rn(g.dx, g.dx), __fmul_rn(g.dy, g.dy)));
    const float gm = g.g_surf >= g.g_filt ? g.g_surf : g.g_filt;
    g.raw = __fmul_rn(s[11 * ld], gm);
    g.alpha = g.raw > max_alpha ? max_alpha : g.raw;
    return g.alpha >= alpha_threshold;
}

// The solve's determinant and numerators at one end pixel of a row, and
// the magnitudes of their products (ms_surfel_row_may_apply).
__device__ __forceinline__ void ms_surfel_row_end(const float* s, float x, const MsSurfelRow& r,
                                                  float& det, float& nu, float& nv, float& md,
                                                  float& mn) {
    const MsSurfelCol c = ms_surfel_col(s, 1, x);
    const float p11 = __fmul_rn(c.A11, r.A22), p12 = __fmul_rn(c.A12, r.A21);
    const float pu1 = __fmul_rn(c.r1, r.A22), pu2 = __fmul_rn(r.r2, c.A12);
    const float pv1 = __fmul_rn(c.A11, r.r2), pv2 = __fmul_rn(r.A21, c.r1);
    det = __fsub_rn(p11, p12);
    nu = __fsub_rn(pu1, pu2);
    nv = __fsub_rn(pv1, pv2);
    md = fmaxf(md, __fadd_rn(fabsf(p11), fabsf(p12)));
    mn = fmaxf(mn, __fadd_rn(__fadd_rn(fabsf(pu1), fabsf(pu2)), __fadd_rn(fabsf(pv1), fabsf(pv2))));
}

// Whether any pixel of one pixel row may keep a slot under
// ms_surfel_alpha: false only when none can. B6 and B7 skip the slots a
// row cannot keep, so they apply the full walk's slots, and every float
// operation on a kept slot stays ms_surfel_alpha's.
//
// s is the slot's record (rows 0-11), the row's pixel centres run from
// x_first to x_last at height py, log_thr = ln(alpha_threshold). A pixel
// keeps the slot only if a branch reaches the threshold, opacity * g >=
// threshold, that is its exponent is at most lam = ln(opacity /
// threshold), here raised by 1e-5 (|lam| + |log_thr| + 1) for the logs'
// and the exponentials' rounding:
//
//   the filter, dx^2 + dy^2 <= lam: the pixel's rounded dx lies between
//   the end pixels' (rounding is monotone), so the row's least dx^2 + dy^2
//   bounds every pixel's;
//
//   the surface, s2 = |N|^2 / det^2 <= 2 lam, N = (u, v) det the solve's
//   numerators. Along the row, N and det are affine in px (A11, A12 and r1
//   are; A21, A22 and r2 are constants), so phi = |N|^2 - 2 lam det^2 is a
//   quadratic in px, its least value over the row at an end or at its
//   vertex. Interpolated between the end pixels' N and det (computed as the
//   kernel computes them), N and det are within 2 gamma M of each pixel's
//   own (gamma a few f32 roundings, M the sum of the products' magnitudes,
//   which is convex and so largest at an end). phi > 2 gamma' (M_N + s
//   M_det) B, s = sqrt(2 lam), B the largest |N| + s |det| at the ends,
//   then gives |N| - s |det| > 2 gamma' (M_N + s M_det) at every pixel,
//   with gamma' = 1e-5 far above gamma: every pixel's s2 exceeds 2 lam (a
//   failed solve keeps nothing by this branch).
//
// An opacity below the threshold keeps nothing. A NaN anywhere, or a
// threshold <= 0, may apply. ops/surfel_cuda.py::surfel_row_may_apply_plain
// mirrors each operation.
__device__ __forceinline__ bool ms_surfel_row_may_apply(const float* s, float x_first,
                                                        float x_last, float py, float log_thr) {
    const float l0 = __fsub_rn(logf(s[11]), log_thr);
    const float lam =
        __fadd_rn(l0, __fmul_rn(1e-5f, __fadd_rn(__fadd_rn(fabsf(l0), fabsf(log_thr)), 1.0f)));
    if (lam < 0.0f) return false;
    if (!(lam < 1e30f)) return true;  // NaN, or a threshold <= 0
    // The filter: the least |dx| over the row (0 where the centre lies in it).
    const float dy = __fsub_rn(py, s[10]);
    const float lo = __fsub_rn(x_first, s[9]);
    const float hi = __fsub_rn(x_last, s[9]);
    const float mdx = lo > 0.0f ? lo : (hi < 0.0f ? -hi : 0.0f);
    const float ef = __fadd_rn(__fmul_rn(mdx, mdx), __fmul_rn(dy, dy));
    if (!(__fmul_rn(ef, 1.0f - 1e-5f) > lam)) return true;
    // The surface: N and det at the end pixels, and their magnitudes.
    const MsSurfelRow r = ms_surfel_row(s, 1, py);
    float det0, nu0, nv0, det1, nu1, nv1, md = 0.0f, mn = 0.0f;
    ms_surfel_row_end(s, x_first, r, det0, nu0, nv0, md, mn);
    ms_surfel_row_end(s, x_last, r, det1, nu1, nv1, md, mn);
    const float s2 = __fmul_rn(2.0f, lam);
    const float sq = sqrtf(s2);
    const float n20 = __fadd_rn(__fmul_rn(nu0, nu0), __fmul_rn(nv0, nv0));
    const float n21 = __fadd_rn(__fmul_rn(nu1, nu1), __fmul_rn(nv1, nv1));
    const float phi0 = __fsub_rn(n20, __fmul_rn(s2, __fmul_rn(det0, det0)));
    const float phi1 = __fsub_rn(n21, __fmul_rn(s2, __fmul_rn(det1, det1)));
    const float b = fmaxf(fmaxf(0.0f, __fadd_rn(sqrtf(n20), __fmul_rn(sq, fabsf(det0)))),
                          __fadd_rn(sqrtf(n21), __fmul_rn(sq, fabsf(det1))));
    const float margin = __fmul_rn(__fmul_rn(2e-5f, __fadd_rn(mn, __fmul_rn(sq, md))), b);
    if (!(phi0 > margin && phi1 > margin)) return true;
    // phi(t) = qa t^2 + 2 qb t + phi0 between the ends (t in [0, 1]): its
    // vertex -qb / qa, where it lies inside.
    const float du = __fsub_rn(nu1, nu0), dv = __fsub_rn(nv1, nv0);
    const float dd = __fsub_rn(det1, det0);
    const float qa = __fsub_rn(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)),
                               __fmul_rn(s2, __fmul_rn(dd, dd)));
    const float qb = __fsub_rn(__fadd_rn(__fmul_rn(nu0, du), __fmul_rn(nv0, dv)),
                               __fmul_rn(s2, __fmul_rn(det0, dd)));
    if (qa > 0.0f && -qb > 0.0f && -qb < qa) {
        return !(__fsub_rn(phi0, __fdiv_rn(__fmul_rn(qb, qb), qa)) > margin);
    }
    return !(qa == qa && qb == qb);
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

// A staged slot record: the slot's ROWS rows padded to whole 16-byte words
// (16 floats, or 20 for the maps' 18 rows), so a warp reads a slot with a
// few float4 loads (one broadcast each) instead of one load a row.
template <int ROWS>
__host__ __device__ constexpr int ms_surfel_record() { return (ROWS + 3) / 4 * 4; }

// Words [Q0, Q1) of staged slot j's record (REC floats) into f[4 Q0, 4 Q1).
template <int REC, int Q0 = 0, int Q1 = REC / 4>
__device__ __forceinline__ void ms_surfel_load(const float* records, int j, float (&f)[REC]) {
    const float4* rec = reinterpret_cast<const float4*>(records) + j * (REC / 4);
#pragma unroll
    for (int q = Q0; q < Q1; ++q) {
        const float4 g = rec[q];
        f[4 * q] = g.x;
        f[4 * q + 1] = g.y;
        f[4 * q + 2] = g.z;
        f[4 * q + 3] = g.w;
    }
}
