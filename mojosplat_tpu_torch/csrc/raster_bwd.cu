// Tile blend backward: per-slot gradients of the front-to-back blend (B1).
//
// Replaces mojosplat_tpu/ops/raster_pallas.py::_raster_bwd_rule (the Pallas
// kernel `_bwd_kernel`). Inputs: the packed slot table pdata (6 + cp,
// n_tiles * cap), counts, the output cotangent gout (n_tiles, cp + 1,
// ts * ts) (channels, then final T) and B1's residual: tchunk, each pixel's
// T at the entry of every kResidChunk-slot chunk it reached alive, and stop,
// the slot that ended its walk. Output: d_pdata (6 + cp, n_tiles * cap),
// rows d x, d y, d conic a/b/c, d opacity, d channels; zero past each
// tile's count. Every column is written exactly once, so the output needs
// no initialisation.
//
// One block owns one tile and one thread one pixel, as in B1. The chunks
// are walked in reverse. For each chunk the block stages its kResidChunk
// slots in shared memory; each pixel replays the chunk forward from its
// saved T with B1's own float operations (common.cuh), so the applied set
// and every T_before are bit-equal to the forward's, and holds the chunk's
// per-slot T_before in registers. Then it walks the chunk backward with
// the sequential adjoint, carrying
//
//   R = sum over later applied slots k of w_k cv_k  +  gT * T_final
//
// (cv_k = sum_c gout_c * channel_kc, w_k = alpha_k T_k), so that
//
//   d alpha_j = cv_j T_j - R / (1 - alpha_j),  then R += w_j cv_j,
//
// the sequential form of the TPU kernel's chunked
// d_eff = cv T_before - (S + gT T_out) / (1 - eff). d raw is d alpha where
// raw < max_alpha, d sigma = -d raw * raw, d opacity = d raw * exp(-sigma),
// and the geometry gradients follow from sigma's quadratic form.
//
// Determinism without float atomics: a slot belongs to one tile, so its
// gradient is a sum over the tile's pixels inside one block. Each warp sums
// its 32 pixels with a __shfl_xor butterfly (skipped when no pixel of the
// warp applied the slot), lane 0 parks the warp's sums in shared memory,
// and after the chunk one thread per (row, slot) adds the warps' sums in
// warp order. The order is fixed, so the result is bitwise reproducible.
// The TPU kernel's moment trick (six pixel moments of d sigma on the MXU)
// saves nothing here: the direct form also reduces 6 + cp values per slot.
//
// grad_route_bf16 has no effect: this kernel always computes in f32, which
// meets that route's looser tolerance too.
//
// Bound on the card: the adjoint needs one exp and about 65 flops per
// (pixel, slot) pair walked; this kernel computes each alpha twice (in the
// replay and in the backward walk) to save registers, and adds the warp
// shuffles of the reduction (5 per row per slot for each warp that applied
// it). A 32x32 tile is one
// block of 1024 threads, so __launch_bounds__(1024) caps registers at 64.

#include "common.cuh"

namespace {

constexpr int K = kResidChunk;
constexpr unsigned kFull = 0xffffffffu;

template <int CP>
__global__ void __launch_bounds__(1024)
raster_bwd_kernel(const float* __restrict__ pdata, int64_t stride, int cap,
                  const int* __restrict__ counts, int ts, int tw,
                  float alpha_threshold, float max_alpha,
                  const float* __restrict__ gout,
                  const float* __restrict__ tchunk,
                  const int* __restrict__ stop, int nch,
                  float* __restrict__ dpdata) {
    constexpr int kRows = 6 + CP;
    __shared__ float slots[kRows * K];
    __shared__ float part[32][K][kRows];  // per-warp sums of each slot's rows

    const int t = blockIdx.x;
    const int p = threadIdx.x;
    const int P = ts * ts;
    const int nwarps = blockDim.x >> 5;
    const int warp = p >> 5;
    const int lane = p & 31;
    // The block is rounded up to whole warps; the extra threads hold no
    // pixel and contribute zeros.
    const bool real = p < P;
    const int count = min(max(counts[t], 0), cap);
    const int tile_y = t / tw;
    const int tile_x = t - tile_y * tw;
    const float px = static_cast<float>(tile_x * ts + p % ts) + 0.5f;
    const float py = static_cast<float>(tile_y * ts + p / ts) + 0.5f;

    const int64_t pix = static_cast<int64_t>(t) * P + p;
    const int my_stop = real ? min(stop[pix], count) : 0;
    float v[CP];
    const float* g = gout + static_cast<int64_t>(t) * (CP + 1) * P + p;
#pragma unroll
    for (int c = 0; c < CP; ++c) v[c] = real ? g[c * P] : 0.0f;
    const float gT = real ? g[CP * P] : 0.0f;

    float R = 0.0f;
    bool started = false;
    const float* tile = pdata + static_cast<int64_t>(t) * cap;
    float* dtile = dpdata + static_cast<int64_t>(t) * cap;
    const float* tres = tchunk + static_cast<int64_t>(t) * nch * P + p;

    for (int c = nch - 1; c >= 0; --c) {
        const int s0 = c * K;
        const bool active = real && s0 < my_stop;
        // Also the barrier before the shared buffers are reused.
        if (!__syncthreads_or(active)) {
            for (int i = p; i < kRows * K; i += blockDim.x) {
                const int r = i / K;
                const int j = i - r * K;
                if (s0 + j < cap) dtile[r * stride + s0 + j] = 0.0f;
            }
            continue;
        }
        const int n = min(K, count - s0);
        for (int i = p; i < kRows * K; i += blockDim.x) {
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
                if (s0 + j < my_stop) {
                    float e, raw, alpha;
                    if (ms_slot_alpha(slots[0 * K + j] - px, slots[1 * K + j] - py,
                                      slots[2 * K + j], slots[3 * K + j],
                                      slots[4 * K + j], slots[5 * K + j],
                                      alpha_threshold, max_alpha, e, raw, alpha)) {
                        T = ms_transmit(T, alpha);
                    }
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
            if (active && s0 + j < my_stop) {
                const float dx = slots[0 * K + j] - px;
                const float dy = slots[1 * K + j] - py;
                const float ca = slots[2 * K + j];
                const float cb = slots[3 * K + j];
                const float cc = slots[4 * K + j];
                float e, raw, alpha;
                if (ms_slot_alpha(dx, dy, ca, cb, cc, slots[5 * K + j],
                                  alpha_threshold, max_alpha, e, raw, alpha)) {
                    applied = true;
                    float cv = 0.0f;
#pragma unroll
                    for (int ch = 0; ch < CP; ++ch) cv += v[ch] * slots[(6 + ch) * K + j];
                    const float w = alpha * Tb[j];
                    const float d_alpha = cv * Tb[j] - R / (1.0f - alpha);
                    R += w * cv;
                    const float d_raw = raw < max_alpha ? d_alpha : 0.0f;
                    const float d_sigma = -d_raw * raw;
                    d[0] = d_sigma * (ca * dx + cb * dy);
                    d[1] = d_sigma * (cc * dy + cb * dx);
                    d[2] = 0.5f * d_sigma * dx * dx;
                    d[3] = d_sigma * dx * dy;
                    d[4] = 0.5f * d_sigma * dy * dy;
                    d[5] = d_raw * e;
#pragma unroll
                    for (int ch = 0; ch < CP; ++ch) d[6 + ch] = v[ch] * w;
                }
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

        // Fixed-order sum over the warps; slots past the count read zeros.
        for (int i = p; i < kRows * K; i += blockDim.x) {
            const int r = i / K;
            const int j = i - r * K;
            if (s0 + j >= cap) continue;
            float s = 0.0f;
            for (int w = 0; w < nwarps; ++w) s += part[w][j][r];
            dtile[r * stride + s0 + j] = s;
        }
    }
}

template <int CP>
void launch(const float* pdata, int n_tiles, int cap, const int* counts,
            int ts, int tw, float alpha_threshold, float max_alpha,
            const float* gout, const float* tchunk, const int* stop,
            float* dpdata, cudaStream_t stream) {
    const int threads = (ts * ts + 31) / 32 * 32;
    raster_bwd_kernel<CP><<<n_tiles, threads, 0, stream>>>(
        pdata, static_cast<int64_t>(n_tiles) * cap, cap, counts, ts, tw,
        alpha_threshold, max_alpha, gout, tchunk, stop,
        (cap + K - 1) / K, dpdata);
}

}  // namespace

// pdata: (rows, n_tiles * cap) f32, rows = 6 + cp, 4 <= cp <= 8; counts
// (n_tiles,) int32; gout (n_tiles, cp + 1, ts * ts) f32; tchunk and stop
// as raster_fwd_launch wrote them; dpdata (rows, n_tiles * cap) f32.
extern "C" int raster_bwd_launch(const void* pdata, int rows, int n_tiles,
                                 int cap, const void* counts, int ts, int tw,
                                 float alpha_threshold, float max_alpha,
                                 const void* gout, const void* tchunk,
                                 const void* stop, void* dpdata,
                                 void* stream) {
    if (n_tiles <= 0) return 0;
    if (ts <= 0 || ts * ts > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const auto* pd = static_cast<const float*>(pdata);
    const auto* ct = static_cast<const int*>(counts);
    const auto* go = static_cast<const float*>(gout);
    const auto* tc = static_cast<const float*>(tchunk);
    const auto* st = static_cast<const int*>(stop);
    auto* d = static_cast<float*>(dpdata);
    auto s = static_cast<cudaStream_t>(stream);
    switch (rows - 6) {
        case 4: launch<4>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, go, tc, st, d, s); break;
        case 5: launch<5>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, go, tc, st, d, s); break;
        case 6: launch<6>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, go, tc, st, d, s); break;
        case 7: launch<7>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, go, tc, st, d, s); break;
        case 8: launch<8>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, go, tc, st, d, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    MS_RETURN_LAUNCH_STATUS();
}
