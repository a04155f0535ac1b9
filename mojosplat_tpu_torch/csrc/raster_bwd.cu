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
// Each tile is split over a cluster of kSplit = 4 blocks, one thread per
// pixel: a 32x32 tile is 4 blocks of 256 threads, 8 pixel rows (warps) a
// block. The chunks are walked in reverse. For each chunk a block stages
// its kResidChunk slots in shared memory as 16-byte records (float4
// loads); each warp tests them against its pixel rows (the row test
// ms_row_may_apply, as B1 does), and each pixel replays only the slots its
// rows may keep, forward from its saved T, with B1's own float operations
// (common.cuh): the applied set and every T_before are bit-equal to the
// forward's. The replay saves T_before and e = exp(-sigma) of each slot the
// pixel applies in shared memory ([slot][thread], private to the thread)
// and a 16-bit applied mask; raw = opacity * e is the same product again
// and alpha its clamp, so the backward walk computes no alpha and visits
// only the slots some pixel of the warp applied. It carries
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
// gradient is a sum over the tile's pixels inside one cluster. Each warp
// sums its 32 pixels by a transpose (reduce-scatter): the 6 + cp rows are
// padded to 16, and at each xor step a lane keeps half its values and adds
// its partner's copy of them, so 8 + 4 + 2 + 1 + 1 = 16 shuffles leave row
// r's warp sum in lanes 2r and 2r + 1. Each block adds its warps' sums in
// warp order; after cluster.sync() each block adds a quarter of the chunk's
// (row, slot) sums over the four blocks in rank order, reading the others'
// shared memory (distributed shared memory), and writes them. The orders
// are fixed, so the result is bitwise reproducible. The block sums are
// double-buffered across chunks, so one cluster barrier a chunk suffices.
// The TPU kernel's moment trick (six pixel moments of d sigma on the MXU)
// saves nothing here: the direct form also reduces 6 + cp values per slot.
//
// grad_route_bf16 has no effect: this kernel always computes in f32, which
// meets that route's looser tolerance too.
//
// Bound on the card: the adjoint needs one exp and about 65 flops per
// (pixel, slot) pair walked. Measured on an H100 (PERF.md): the work is
// issued per warp and slot, about 190 instructions for each slot some pixel
// of the warp applies (replay 40, adjoint 50, transpose 60); the transpose
// is about a quarter of the time. Holding the saved values in shared memory
// rather than registers keeps a thread at 64 registers, so 4 blocks share
// an SM (32 warps); at 96 registers and 2 blocks the kernel ran slower than
// the 1024-thread design it replaces.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int K = kResidChunk;
constexpr int kSplit = 4;    // blocks per tile: one cluster
constexpr int kMaxWarps = 8;  // 1024 pixels over kSplit blocks
constexpr int kPad = kTransposeRows;
constexpr unsigned kFull = 0xffffffffu;
static_assert(K <= 32 && kPad == 16, "the walk and the transpose assume these");

template <int CP>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(256, 4)
raster_bwd_kernel(const float* __restrict__ pdata, int64_t stride, int cap,
                  const int* __restrict__ counts, int ts, int tw,
                  float alpha_threshold, float max_alpha,
                  const float* __restrict__ gout,
                  const float* __restrict__ tchunk,
                  const int* __restrict__ stop, int nch,
                  float* __restrict__ dpdata) {
    constexpr int kRows = 6 + CP;
    static_assert(kRows <= kPad, "at most 16 rows");
    constexpr int kShare = kRows * K / kSplit;  // (row, slot) sums each block writes
    static_assert(kRows * K % kSplit == 0, "the chunk's sums split evenly");
    constexpr int kRec = ms_record<CP>();
    __shared__ __align__(16) float slots[K * kRec];  // slot records
    // Each pixel's T before, and exp(-sigma) at, each slot of the chunk it
    // applies: private to the thread, so no barrier guards them.
    __shared__ float s_tb[K][kMaxWarps * 32];
    __shared__ float s_e[K][kMaxWarps * 32];
    __shared__ float part[kMaxWarps][K][kRows];  // per-warp sums of each slot's rows
    __shared__ float bsum[2][kRows * K];         // the block's sums, (row, slot)
    __shared__ int wmax[kMaxWarps];

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int t = blockIdx.x / kSplit;
    const int tid = threadIdx.x;
    const int P = ts * ts;
    const int per_block = (P + kSplit - 1) / kSplit;
    const int p0 = rank * per_block;                 // the block's first pixel
    const int p_end = min(p0 + per_block, P);
    const int p = p0 + tid;
    const int nwarps = blockDim.x >> 5;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // The block is rounded up to whole warps; the extra threads hold no
    // pixel and contribute zeros.
    const bool real = tid < per_block && p < P;
    const int count = min(max(counts[t], 0), cap);
    const int tile_y = t / tw;
    const int tile_x = t - tile_y * tw;
    const float px = static_cast<float>(tile_x * ts + p % ts) + 0.5f;
    const float py = static_cast<float>(tile_y * ts + p / ts) + 0.5f;
    // The pixel rows of this warp's real pixels (none: row_last < row_first).
    const int wp = p0 + warp * 32;
    const int row_first = wp / ts;
    const int row_last = wp < p_end ? (min(wp + 32, p_end) - 1) / ts : row_first - 1;
    const float x_first = static_cast<float>(tile_x * ts) + 0.5f;
    const float x_last = static_cast<float>(tile_x * ts + ts - 1) + 0.5f;

    const int64_t pix = static_cast<int64_t>(t) * P + p;
    const int my_stop = real ? min(stop[pix], count) : 0;
    float v[CP];
    const float* g = gout + static_cast<int64_t>(t) * (CP + 1) * P + p;
#pragma unroll
    for (int c = 0; c < CP; ++c) v[c] = real ? g[c * P] : 0.0f;
    const float gT = real ? g[CP * P] : 0.0f;

    // The tile's last stop, the same in every block of the cluster: chunks
    // from there on are zero for every pixel and need no barrier.
    int ms = 0;
    for (int i = tid; i < P; i += blockDim.x) {
        ms = max(ms, min(stop[static_cast<int64_t>(t) * P + i], count));
    }
    ms = __reduce_max_sync(kFull, ms);
    if (lane == 0) wmax[warp] = ms;
    __syncthreads();
    int tile_stop = 0;
    for (int w = 0; w < nwarps; ++w) tile_stop = max(tile_stop, wmax[w]);

    float R = 0.0f;
    bool started = false;
    const float* tile = pdata + static_cast<int64_t>(t) * cap;
    float* dtile = dpdata + static_cast<int64_t>(t) * cap;
    const float* tres = tchunk + static_cast<int64_t>(t) * nch * P + p;

    for (int c = nch - 1; c >= 0; --c) {
        const int s0 = c * K;
        if (s0 >= tile_stop) {
            for (int i = tid; i < kShare; i += blockDim.x) {
                const int e = rank * kShare + i;
                const int r = e / K;
                const int j = e - r * K;
                if (s0 + j < cap) dtile[r * stride + s0 + j] = 0.0f;
            }
            continue;
        }
        const bool active = real && s0 < my_stop;
        float* bs = bsum[c & 1];
        // Also the barrier before the shared buffers are reused.
        if (!__syncthreads_or(active)) {
            for (int i = tid; i < kRows * K; i += blockDim.x) bs[i] = 0.0f;
        } else {
            const int n = min(K, count - s0);
            for (int i = tid; i < kRows * K; i += blockDim.x) {
                const int r = i / K;
                const int j = i - r * K;
                slots[j * kRec + r] = j < n ? __ldg(tile + r * stride + s0 + j) : 0.0f;
            }
            __syncthreads();

            // The slots the warp's rows may keep; none where no pixel of
            // the warp reaches the chunk.
            unsigned may = 0u;
            if (__any_sync(kFull, active)) {
                bool m = false;
                if (lane < n) {
                    float f[kRec];
                    ms_load_record<CP>(slots, lane, f);
                    for (int r = row_first; r <= row_last && !m; ++r) {
                        const float ry = static_cast<float>(tile_y * ts + r) + 0.5f;
                        m = ms_row_may_apply(f[0], f[1], f[2], f[3], f[4], f[5], x_first,
                                             x_last, ry, alpha_threshold);
                    }
                }
                may = __ballot_sync(kFull, m);
            }

            // Replay the chunk forward over those slots: T before each
            // applied slot and its exp, and T after the pixel's last
            // applied slot (= its final T) to seed R.
            unsigned applied = 0u;
            if (active) {
                float T = tres[static_cast<int64_t>(c) * P];
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    if (((may >> j) & 1u) && s0 + j < my_stop) {
                        float f[kRec];
                        ms_load_record<CP>(slots, j, f);
                        float e, raw, alpha;
                        if (ms_slot_alpha(f[0] - px, f[1] - py, f[2], f[3], f[4], f[5],
                                          alpha_threshold, max_alpha, e, raw, alpha)) {
                            s_tb[j][tid] = T;
                            s_e[j][tid] = e;
                            applied |= 1u << j;
                            T = ms_transmit(T, alpha);
                        }
                    }
                }
                if (!started) {
                    R = gT * T;
                    started = true;
                }
            }
            const unsigned any_applied = __reduce_or_sync(kFull, applied);

            // One slot's adjoint into dd[0, kRows) where the pixel applied
            // it; carries R.
            auto adjoint = [&](int j, float* dd) {
                if (!((applied >> j) & 1u)) return;
                float f[ms_record<CP>()];
                ms_load_record<CP>(slots, j, f);
                const float dx = f[0] - px;
                const float dy = f[1] - py;
                const float ca = f[2];
                const float cb = f[3];
                const float cc = f[4];
                const float e = s_e[j][tid];
                const float tb = s_tb[j][tid];
                const float raw = __fmul_rn(f[5], e);
                const float alpha = raw > max_alpha ? max_alpha : raw;
                float cv = 0.0f;
#pragma unroll
                for (int ch = 0; ch < CP; ++ch) cv += v[ch] * f[6 + ch];
                const float w = alpha * tb;
                // 1 - alpha >= 1 - max_alpha: the fast division's 2 ulps.
                const float d_alpha = cv * tb - __fdividef(R, 1.0f - alpha);
                R += w * cv;
                const float d_raw = raw < max_alpha ? d_alpha : 0.0f;
                const float d_sigma = -d_raw * raw;
                dd[0] = d_sigma * (ca * dx + cb * dy);
                dd[1] = d_sigma * (cc * dy + cb * dx);
                dd[2] = 0.5f * d_sigma * dx * dx;
                dd[3] = d_sigma * dx * dy;
                dd[4] = 0.5f * d_sigma * dy * dy;
                dd[5] = d_raw * e;
#pragma unroll
                for (int ch = 0; ch < CP; ++ch) dd[6 + ch] = v[ch] * w;
            };
#pragma unroll
            for (int j = K - 1; j >= 0; --j) {
                float sum = 0.0f;
                if ((any_applied >> j) & 1u) {
                    float d[kPad];
#pragma unroll
                    for (int r = 0; r < kPad; ++r) d[r] = 0.0f;
                    adjoint(j, d);
                    sum = ms_warp_transpose_sum(d, lane);
                }
                if ((lane & 1) == 0 && (lane >> 1) < kRows) part[warp][j][lane >> 1] = sum;
            }
            __syncthreads();

            // The block's sums in warp order.
            for (int i = tid; i < kRows * K; i += blockDim.x) {
                const int r = i / K;
                const int j = i - r * K;
                float s = 0.0f;
                for (int w = 0; w < nwarps; ++w) s += part[w][j][r];
                bs[i] = s;
            }
        }
        cluster.sync();

        // This block's quarter of the chunk's sums: the four blocks' sums in
        // rank order; slots past the count read zeros.
        for (int i = tid; i < kShare; i += blockDim.x) {
            const int e = rank * kShare + i;
            const int r = e / K;
            const int j = e - r * K;
            if (s0 + j >= cap) continue;
            float s = 0.0f;
#pragma unroll
            for (int q = 0; q < kSplit; ++q) s += cluster.map_shared_rank(bs, q)[e];
            dtile[r * stride + s0 + j] = s;
        }
    }
    // No block leaves while another may still read its sums.
    cluster.sync();
}

// Threads of each of a tile's kSplit blocks: its share of the pixels
// rounded up to whole warps.
inline int block_threads(int ts) {
    const int per_block = (ts * ts + kSplit - 1) / kSplit;
    return (per_block + 31) / 32 * 32;
}

template <int CP>
void launch(const float* pdata, int n_tiles, int cap, const int* counts,
            int ts, int tw, float alpha_threshold, float max_alpha,
            const float* gout, const float* tchunk, const int* stop,
            float* dpdata, cudaStream_t stream) {
    raster_bwd_kernel<CP><<<n_tiles * kSplit, block_threads(ts), 0, stream>>>(
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

// B2's launch shape for cp channels and ts x ts tiles, as the runtime sees
// it: out[0..6] = registers a thread, static shared bytes, local (spill)
// bytes a thread, threads a block, the cluster width, resident blocks per
// SM, and resident clusters on the card.
extern "C" int raster_bwd_info(int cp, int ts, void* out) {
    const void* fn = nullptr;
    switch (cp) {
        case 4: fn = reinterpret_cast<const void*>(raster_bwd_kernel<4>); break;
        case 5: fn = reinterpret_cast<const void*>(raster_bwd_kernel<5>); break;
        case 6: fn = reinterpret_cast<const void*>(raster_bwd_kernel<6>); break;
        case 7: fn = reinterpret_cast<const void*>(raster_bwd_kernel<7>); break;
        case 8: fn = reinterpret_cast<const void*>(raster_bwd_kernel<8>); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (ts <= 0 || ts * ts > 1024) return static_cast<int>(cudaErrorInvalidValue);
    return ms_cluster_shape(fn, block_threads(ts), kSplit, static_cast<int*>(out));
}
