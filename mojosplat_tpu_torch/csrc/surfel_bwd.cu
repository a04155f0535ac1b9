// Surfel (2DGS) tile blend backward: B8, the adjoint of B6 and B7.
//
// Replaces mojosplat_tpu/ops/surfel_pallas.py::_bwd_rule (the Pallas kernel
// `_bwd_kernel`, aux False or True). Inputs: the packed slot table pdata
// (16 or 18 rows, n_tiles * cap; surfel.cuh), counts, the output cotangent
// gout (n_tiles, 5 or 9, ts * ts) and the forward kernel's residual: tchunk,
// each pixel's T at the entry of every kResidChunk-slot chunk it reached
// alive, and stop, the slot that ended its walk. Output: d_pdata of pdata's
// shape, zero past each tile's count. Every column is written.
//
// One block owns one tile. The chunks are walked in reverse; each chunk's
// kResidChunk slots are staged in shared memory, and each pixel replays the
// chunk forward from its saved T with the forward's own float operations
// (ms_surfel_alpha, ms_transmit), so the applied set and every T_before are
// bit-equal to the forward's, holding the chunk's T_before in registers.
// It then walks the chunk backward with the sequential adjoint of the
// blend, as B2 does (raster_bwd.cu),
//
//   d alpha_j = cv_j T_j - R / (1 - alpha_j),  R += w_j cv_j,
//
// with cv = sum_c gout_c row_c (+ gout_m1 z + gout_m2 z^2 with the maps),
// and then the hand-derived adjoint of the surfel response
// (surfel_pallas.py:299-345): d raw where raw < max_alpha; the max picks
// the surface branch on a tie; the filter branch gives the centre's
// gradient; the surface branch goes through the 2x2 solve, d_r = A^-T d_q
// and d_A = -d_r q^T, with d s2 masked to the solved, unclamped pairs;
// with the maps d z reaches qc2 on both branches and u, v, a2, b2 on the
// surface branch only.
//
// Registers: a pixel holds the chunk's 16 T_before, its cotangents and up
// to 18 gradient rows, more than the 64 registers a thread may use in a
// block of 1024. So a block has at most 512 threads (128 registers each),
// and a 32x32 tile is walked as two passes over 512 pixels each; the
// second pass adds its sums to the first's.
//
// Determinism without float atomics: a slot belongs to one tile, so its
// gradient is a sum over the tile's pixels inside one block. Each warp sums
// its 32 pixels with a __shfl_xor butterfly (skipped when no pixel of the
// warp applied the slot), lane 0 parks the warp's sums in shared memory,
// and after the chunk one thread per (row, slot) adds the warps' sums in
// warp order, and then the passes in pass order. The order is fixed, so
// the result is bitwise reproducible.
//
// Bound on the card: per (pixel, slot) pair walked, the adjoint needs two
// exponentials, six divisions and about 130 other f32 operations; this
// kernel computes each alpha twice (the replay and the backward walk) to
// save registers, and adds the reduction's shuffles (5 per row, 16 or 18
// rows, per slot for each warp that applied it).

#include "surfel.cuh"

namespace {

constexpr int K = kResidChunk;
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

template <bool AUX>
__global__ void __launch_bounds__(kMaxThreads)
surfel_bwd_kernel(const float* __restrict__ pdata, int64_t stride, int cap,
                  const int* __restrict__ counts, int ts, int tw,
                  float alpha_threshold, float max_alpha,
                  const float* __restrict__ gout,
                  const float* __restrict__ tchunk,
                  const int* __restrict__ stop, int nch,
                  float* __restrict__ dpdata) {
    constexpr int kRows = AUX ? kSurfelAuxRows : kSurfelRows;
    constexpr int kCh = kRows - 12;  // rows blended as constants
    constexpr int kOut = AUX ? 9 : 5;
    __shared__ float slots[kRows * K];
    __shared__ float part[kMaxThreads / 32][K][kRows];  // per-warp sums of each slot's rows

    const int t = blockIdx.x;
    const int P = ts * ts;
    const int nwarps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int count = min(max(counts[t], 0), cap);
    const int tile_y = t / tw;
    const int tile_x = t - tile_y * tw;
    const float* tile = pdata + static_cast<int64_t>(t) * cap;
    float* dtile = dpdata + static_cast<int64_t>(t) * cap;

    for (int pass0 = 0; pass0 < P; pass0 += blockDim.x) {
        const bool first = pass0 == 0;
        const int p = pass0 + threadIdx.x;
        // The block is rounded up to whole warps; the extra threads hold no
        // pixel and contribute zeros.
        const bool real = p < P;
        const float px = static_cast<float>(tile_x * ts + p % ts) + 0.5f;
        const float py = static_cast<float>(tile_y * ts + p / ts) + 0.5f;
        const int64_t pix = static_cast<int64_t>(t) * P + p;
        const int my_stop = real ? min(stop[pix], count) : 0;
        const float* g = gout + static_cast<int64_t>(t) * kOut * P + p;
        float v[kCh];
#pragma unroll
        for (int c = 0; c < kCh; ++c) v[c] = real ? g[c * P] : 0.0f;
        const float v_z = AUX && real ? g[kCh * P] : 0.0f;
        const float v_z2 = AUX && real ? g[(kCh + 1) * P] : 0.0f;
        const float gT = real ? g[(kOut - 1) * P] : 0.0f;
        const float* tres = tchunk + static_cast<int64_t>(t) * nch * P + p;

        float R = 0.0f;
        bool started = false;
        for (int c = nch - 1; c >= 0; --c) {
            const int s0 = c * K;
            const bool active = real && s0 < my_stop;
            // Also the barrier before the shared buffers are reused.
            if (!__syncthreads_or(active)) {
                if (first) {
                    for (int i = threadIdx.x; i < kRows * K; i += blockDim.x) {
                        const int r = i / K;
                        const int j = i - r * K;
                        if (s0 + j < cap) dtile[r * stride + s0 + j] = 0.0f;
                    }
                }
                continue;
            }
            const int n = min(K, count - s0);
            for (int i = threadIdx.x; i < kRows * K; i += blockDim.x) {
                const int r = i / K;
                const int j = i - r * K;
                slots[r * K + j] = j < n ? __ldg(tile + r * stride + s0 + j) : 0.0f;
            }
            __syncthreads();

            // Replay the chunk forward: T before each slot, and T after the
            // pixel's last applied slot (= its final T) to seed R.
            float Tb[K];
            if (active) {
                float T = tres[static_cast<int64_t>(c) * P];
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    Tb[j] = T;
                    MsSurfel gs;
                    if (s0 + j < my_stop &&
                        ms_surfel_alpha(slots + j, K, px, py, alpha_threshold, max_alpha, gs)) {
                        T = ms_transmit(T, gs.alpha);
                    }
                }
                if (!started) {
                    R = gT * T;
                    started = true;
                }
            }

#pragma unroll
            for (int j = K - 1; j >= 0; --j) {
                float d[kRows];
#pragma unroll
                for (int r = 0; r < kRows; ++r) d[r] = 0.0f;
                bool applied = false;
                MsSurfel gs;
                if (active && s0 + j < my_stop &&
                    ms_surfel_alpha(slots + j, K, px, py, alpha_threshold, max_alpha, gs)) {
                    applied = true;
                    const float* s = slots + j;
                    float cv = 0.0f;
#pragma unroll
                    for (int ch = 0; ch < kCh; ++ch) cv += v[ch] * s[(12 + ch) * K];
                    float z = 0.0f;
                    if (AUX) {
                        z = ms_surfel_depth(s, K, gs);
                        cv += v_z * z + v_z2 * z * z;
                    }
                    const float w = gs.alpha * Tb[j];
                    const float d_alpha = cv * Tb[j] - R / (1.0f - gs.alpha);
                    R += w * cv;
                    const float d_raw = gs.raw < max_alpha ? d_alpha : 0.0f;
                    const bool surf_sel = gs.g_surf >= gs.g_filt;
                    const float d_gm = d_raw * s[11 * K];
                    d[11] = d_raw * (surf_sel ? gs.g_surf : gs.g_filt);
                    // The filter branch -> the projected centre (sigma^2 = 0.5).
                    const float gf = surf_sel ? 0.0f : 2.0f * d_gm * gs.g_filt;
                    d[9] = gf * gs.dx;
                    d[10] = gf * gs.dy;
                    // The surface branch -> the 2x2 solve.
                    const float d_s2 = surf_sel && gs.ok && gs.s2 < 1e4f
                                           ? -0.5f * d_gm * gs.g_surf : 0.0f;
                    float d_u = 2.0f * d_s2 * gs.u;
                    float d_v = 2.0f * d_s2 * gs.v;
                    float d_z = 0.0f, d_zs = 0.0f;
                    if (AUX) {
                        // z = qc2 + u a2 + v b2 on the surface branch, qc2 otherwise.
                        d_z = w * (v_z + 2.0f * z * v_z2);
                        d_zs = ms_surfel_use_surf(gs) ? d_z : 0.0f;
                        d_u += d_zs * s[5 * K];
                        d_v += d_zs * s[8 * K];
                    }
                    const float d_r1 = (gs.A22 * d_u - gs.A21 * d_v) / gs.det;
                    const float d_r2 = (gs.A11 * d_v - gs.A12 * d_u) / gs.det;
                    const float d_A11 = -d_r1 * gs.u;
                    const float d_A12 = -d_r1 * gs.v;
                    const float d_A21 = -d_r2 * gs.u;
                    const float d_A22 = -d_r2 * gs.v;
                    d[0] = -d_r1;
                    d[1] = -d_r2;
                    d[2] = px * d_r1 + py * d_r2;
                    d[3] = d_A11;
                    d[4] = d_A21;
                    d[5] = -px * d_A11 - py * d_A21;
                    d[6] = d_A12;
                    d[7] = d_A22;
                    d[8] = -px * d_A12 - py * d_A22;
                    if (AUX) {
                        d[2] += d_z;
                        d[5] += d_zs * gs.u;
                        d[8] += d_zs * gs.v;
                    }
#pragma unroll
                    for (int ch = 0; ch < kCh; ++ch) d[12 + ch] = v[ch] * w;
                }
                if (__any_sync(kFull, applied)) {
#pragma unroll
                    for (int r = 0; r < kRows; ++r) {
#pragma unroll
                        for (int off = 16; off > 0; off >>= 1) {
                            d[r] += __shfl_xor_sync(kFull, d[r], off);
                        }
                    }
                }
                if (lane == 0) {
#pragma unroll
                    for (int r = 0; r < kRows; ++r) part[warp][j][r] = d[r];
                }
            }
            __syncthreads();

            // Fixed-order sum over the warps, then over the passes (the
            // same thread owns the same (row, slot) in every pass); slots
            // past the count read zeros.
            for (int i = threadIdx.x; i < kRows * K; i += blockDim.x) {
                const int r = i / K;
                const int j = i - r * K;
                if (s0 + j >= cap) continue;
                float sum = 0.0f;
                for (int wp = 0; wp < nwarps; ++wp) sum += part[wp][j][r];
                float* dst = dtile + r * stride + s0 + j;
                *dst = first ? sum : *dst + sum;
            }
        }
    }
}

template <bool AUX>
void launch(const float* pdata, int n_tiles, int cap, const int* counts, int ts, int tw,
            float alpha_threshold, float max_alpha, const float* gout, const float* tchunk,
            const int* stop, float* dpdata, cudaStream_t stream) {
    const int whole_warps = (ts * ts + 31) / 32 * 32;
    const int threads = whole_warps < kMaxThreads ? whole_warps : kMaxThreads;
    surfel_bwd_kernel<AUX><<<n_tiles, threads, 0, stream>>>(
        pdata, static_cast<int64_t>(n_tiles) * cap, cap, counts, ts, tw, alpha_threshold,
        max_alpha, gout, tchunk, stop, (cap + K - 1) / K, dpdata);
}

}  // namespace

// pdata: (rows, n_tiles * cap) f32, rows 16 or 18 (the maps); counts
// (n_tiles,) int32; gout (n_tiles, 5 or 9, ts * ts) f32; tchunk and stop as
// surfel_fwd_launch wrote them; dpdata (rows, n_tiles * cap) f32.
extern "C" int surfel_bwd_launch(const void* pdata, int rows, int n_tiles, int cap,
                                 const void* counts, int ts, int tw, float alpha_threshold,
                                 float max_alpha, const void* gout, const void* tchunk,
                                 const void* stop, void* dpdata, void* stream) {
    if (n_tiles <= 0) return 0;
    if (ts <= 0 || ts * ts > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const auto* pd = static_cast<const float*>(pdata);
    const auto* ct = static_cast<const int*>(counts);
    const auto* go = static_cast<const float*>(gout);
    const auto* tc = static_cast<const float*>(tchunk);
    const auto* st = static_cast<const int*>(stop);
    auto* d = static_cast<float*>(dpdata);
    auto s = static_cast<cudaStream_t>(stream);
    switch (rows) {
        case kSurfelRows: launch<false>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, go, tc, st, d, s); break;
        case kSurfelAuxRows: launch<true>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, go, tc, st, d, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    MS_RETURN_LAUNCH_STATUS();
}
