// Surfel (2DGS) tile blend backward: B8, the adjoint of B6 and B7.
//
// Replaces mojosplat_tpu/ops/surfel_pallas.py::_bwd_rule (the Pallas kernel
// `_bwd_kernel`, aux False or True). Inputs: the packed slot table pdata
// (16 or 18 rows, n_tiles * cap; surfel.cuh), counts, the output cotangent
// gout (n_tiles, 5 or 9, ts * ts) and the forward kernel's residual: tchunk,
// each pixel's T at the entry of every kResidChunk-slot chunk it reached
// alive, and stop, the slot that ended its walk. Output: d_pdata of pdata's
// shape, zero past each tile's count. Every column is written exactly once,
// so the output needs no initialisation.
//
// The design is B2's (raster_bwd.cu). Each tile is split over a cluster of
// kSplit = 4 blocks, one thread per pixel: a 32x32 tile is 4 blocks of 256
// threads. The chunks are walked in reverse, in rounds of kGroup = 2: a
// round stages its 2 x kResidChunk slots in shared memory as 16-byte records
// (4 float4 loads for 16 rows, 5 for 18 padded to 20); for each of its
// chunks, the last first, each pixel replays the chunk
// forward from its saved T with the forward's own float operations
// (ms_surfel_alpha, ms_transmit), so the applied set and every T_before are
// bit-equal to the forward's. The replay saves T_before of each slot the
// pixel applies in shared memory ([slot][thread], private to the thread)
// and a 16-bit applied mask; the backward walk visits only the slots some
// pixel of the warp applied, and recomputes the surfel terms only there. It
// carries R as B2 does,
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
// Determinism without float atomics: a slot belongs to one tile, so its
// gradient is a sum over the tile's pixels inside one cluster. Each warp
// sums its 32 pixels by the transpose of common.cuh (16 shuffles for rows
// 0-15); with the maps, rows 16 and 17 go one to each half-warp (1 shuffle)
// and are summed by a butterfly within it (4 more), 21 in all where a
// butterfly per row takes 90. Each block adds its warps' sums in warp
// order; after cluster.sync() each block adds a quarter of the round's
// (row, slot) sums over the four blocks in rank order through distributed
// shared memory, and writes them. The orders are fixed, so the result is
// bitwise reproducible; the block sums are double-buffered across rounds,
// so one cluster barrier a round suffices. The barriers, the staging and
// the sums cost about a quarter of the kernel's time on an H100 (PERF.md),
// so a round holds two chunks: half the barriers a slot of one, and still
// 4 blocks an SM.
//
// No row test yet: every walked slot is replayed. The forward's
// ms_surfel_row_may_apply (surfel.cuh) bounds both branches of the surfel
// alpha over a pixel row, conservatively under f32 rounding; B8 could skip
// the same (row, slot) pairs.
//
// Bound on the card: per (pixel, slot) pair walked, the adjoint needs two
// exponentials, six divisions and about 130 other f32 operations. Here the
// replay computes the alpha once per walked pair and the backward walk a
// second time per (warp, slot) that some pixel applied; holding T_before in
// shared memory rather than registers keeps a thread within the register
// budget of kMinBlocks resident blocks per SM. Saving more of the alpha's
// terms (u and v) needs 60 KB of shared memory a block, 3 blocks an SM,
// and measured slower.

#include <cooperative_groups.h>

#include "surfel.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int K = kResidChunk;
constexpr int kSplit = 4;     // blocks per tile: one cluster
constexpr int kMaxWarps = 8;  // 1024 pixels over kSplit blocks
constexpr int kMinBlocks = 4;  // resident blocks per SM the register budget aims at
constexpr int kGroup = 2;      // residual chunks staged and reduced per barrier round
constexpr int kPad = kTransposeRows;
constexpr unsigned kFull = 0xffffffffu;
static_assert(K <= 32, "the applied mask is one word");

// Rows 16 and 17 of the maps' variant summed over the warp: lanes below 16
// end with row 16's sum, the others with row 17's, after 1 + 4 shuffles.
__device__ __forceinline__ float warp_pair_sum(float a, float b, int lane) {
    const bool up = (lane & 16) != 0;
    asm("" : "+f"(a), "+f"(b));
    float x = (up ? b : a) + __shfl_xor_sync(kFull, up ? a : b, 16);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
    return x;
}

template <bool AUX>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kMaxWarps * 32, kMinBlocks)
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
    constexpr int kRec = ms_surfel_record<kRows>();  // a slot record: 16 or 20 floats
    constexpr int KG = K * kGroup;               // slots a round stages
    constexpr int kShare = kRows * KG / kSplit;  // (row, slot) sums each block writes a round
    static_assert(kRows * KG % kSplit == 0, "the round's sums split evenly");
    static_assert(kRows - kPad == (AUX ? 2 : 0), "rows past the transpose");
    __shared__ __align__(16) float slots[KG * kRec];  // slot records
    // Each pixel's T before each slot of the chunk it applies: private to
    // the thread, so no barrier guards it.
    __shared__ float s_tb[K][kMaxWarps * 32];
    __shared__ float part[kMaxWarps][KG][kRows];  // per-warp sums of each slot's rows
    __shared__ float bsum[2][kRows * KG];         // the block's sums, (row, slot)
    __shared__ int wmax[kMaxWarps];

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int t = blockIdx.x / kSplit;
    const int tid = threadIdx.x;
    const int P = ts * ts;
    const int per_block = (P + kSplit - 1) / kSplit;
    const int p = rank * per_block + tid;
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

    const int64_t pix = static_cast<int64_t>(t) * P + p;
    const int my_stop = real ? min(stop[pix], count) : 0;
    const float* g = gout + static_cast<int64_t>(t) * kOut * P + p;
    float v[kCh];
#pragma unroll
    for (int c = 0; c < kCh; ++c) v[c] = real ? g[c * P] : 0.0f;
    const float v_z = AUX && real ? g[kCh * P] : 0.0f;
    const float v_z2 = AUX && real ? g[(kCh + 1) * P] : 0.0f;
    const float gT = real ? g[(kOut - 1) * P] : 0.0f;

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

    const int nrounds = (nch + kGroup - 1) / kGroup;
    for (int g = nrounds - 1; g >= 0; --g) {
        const int g0 = g * KG;
        if (g0 >= tile_stop) {
            for (int i = tid; i < kShare; i += blockDim.x) {
                const int e = rank * kShare + i;
                const int r = e / KG;
                const int j = e - r * KG;
                if (g0 + j < cap) dtile[r * stride + g0 + j] = 0.0f;
            }
            continue;
        }
        float* bs = bsum[g & 1];
        // Also the barrier before the shared buffers are reused.
        if (!__syncthreads_or(real && g0 < my_stop)) {
            for (int i = tid; i < kRows * KG; i += blockDim.x) bs[i] = 0.0f;
        } else {
            const int n = min(KG, count - g0);
            for (int i = tid; i < kRows * KG; i += blockDim.x) {
                const int r = i / KG;
                const int j = i - r * KG;
                slots[j * kRec + r] = j < n ? __ldg(tile + r * stride + g0 + j) : 0.0f;
            }
            __syncthreads();

            // The round's chunks, the last first; a chunk past the table
            // (c >= nch) has no active pixel.
#pragma unroll 1
            for (int h = kGroup - 1; h >= 0; --h) {
                const int c = g * kGroup + h;
                const int s0 = c * K;
                const bool active = real && s0 < my_stop;
                const float* recs = slots + h * K * kRec;

                // Replay the chunk forward: T before each applied slot, and
                // T after the pixel's last applied slot (= its final T) to
                // seed R.
                unsigned applied = 0u;
                if (active) {
                    float T = tres[static_cast<int64_t>(c) * P];
#pragma unroll 1
                    for (int j = 0; j < K && s0 + j < my_stop; ++j) {
                        float f[kRec];
                        ms_surfel_load<kRec>(recs, j, f);
                        MsSurfel gs;
                        if (ms_surfel_alpha(f, 1, px, py, alpha_threshold, max_alpha, gs)) {
                            s_tb[j][tid] = T;
                            applied |= 1u << j;
                            T = ms_transmit(T, gs.alpha);
                        }
                    }
                    if (!started) {
                        R = gT * T;
                        started = true;
                    }
                }
                const unsigned any_applied = __reduce_or_sync(kFull, applied);

                // One slot's adjoint into d (rows 0-15) and x16, x17 (the maps'
                // rows 16-17) where the pixel applied it; carries R.
                auto adjoint = [&](int j, float (&d)[kPad], float& x16, float& x17) {
                    if (!((applied >> j) & 1u)) return;
                    float f[kRec];
                    ms_surfel_load<kRec>(recs, j, f);
                    MsSurfel gs;
                    ms_surfel_alpha(f, 1, px, py, alpha_threshold, max_alpha, gs);  // kept
                    const float tb = s_tb[j][tid];
                    float cv = 0.0f;
#pragma unroll
                    for (int ch = 0; ch < kCh; ++ch) cv += v[ch] * f[12 + ch];
                    float z = 0.0f;
                    if (AUX) {
                        z = ms_surfel_depth(f, 1, gs);
                        cv += v_z * z + v_z2 * z * z;
                    }
                    const float w = gs.alpha * tb;
                    // 1 - alpha >= 1 - max_alpha: the fast division's 2 ulps.
                    const float d_alpha = cv * tb - __fdividef(R, 1.0f - gs.alpha);
                    R += w * cv;
                    const float d_raw = gs.raw < max_alpha ? d_alpha : 0.0f;
                    const bool surf_sel = gs.g_surf >= gs.g_filt;
                    const float d_gm = d_raw * f[11];
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
                        d_u += d_zs * f[5];
                        d_v += d_zs * f[8];
                    }
                    const float rdet = __frcp_rn(gs.det);
                    const float d_r1 = (gs.A22 * d_u - gs.A21 * d_v) * rdet;
                    const float d_r2 = (gs.A11 * d_v - gs.A12 * d_u) * rdet;
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
                    for (int ch = 0; ch < 4; ++ch) d[12 + ch] = v[ch] * w;
                    if (AUX) {
                        x16 = v[4] * w;
                        x17 = v[5] * w;
                    }
                };
#pragma unroll 1
                for (int j = K - 1; j >= 0; --j) {
                    if (!((any_applied >> j) & 1u)) {
                        if (lane < kRows) part[warp][h * K + j][lane] = 0.0f;
                        continue;
                    }
                    float d[kPad];
#pragma unroll
                    for (int r = 0; r < kPad; ++r) d[r] = 0.0f;
                    float x16 = 0.0f, x17 = 0.0f;
                    adjoint(j, d, x16, x17);
                    const float sum = ms_warp_transpose_sum(d, lane);
                    if ((lane & 1) == 0) part[warp][h * K + j][lane >> 1] = sum;
                    if (AUX) {
                        const float sum2 = warp_pair_sum(x16, x17, lane);
                        if ((lane & 15) == 0) part[warp][h * K + j][kPad + (lane >> 4)] = sum2;
                    }
                }
            }
            __syncthreads();

            // The block's sums in warp order.
            for (int i = tid; i < kRows * KG; i += blockDim.x) {
                const int r = i / KG;
                const int j = i - r * KG;
                float sum = 0.0f;
                for (int w = 0; w < nwarps; ++w) sum += part[w][j][r];
                bs[i] = sum;
            }
        }
        cluster.sync();

        // This block's share of the round's sums: the four blocks' sums in
        // rank order; slots past the count read zeros.
        for (int i = tid; i < kShare; i += blockDim.x) {
            const int e = rank * kShare + i;
            const int r = e / KG;
            const int j = e - r * KG;
            if (g0 + j >= cap) continue;
            float sum = 0.0f;
#pragma unroll
            for (int q = 0; q < kSplit; ++q) sum += cluster.map_shared_rank(bs, q)[e];
            dtile[r * stride + g0 + j] = sum;
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

template <bool AUX>
void launch(const float* pdata, int n_tiles, int cap, const int* counts, int ts, int tw,
            float alpha_threshold, float max_alpha, const float* gout, const float* tchunk,
            const int* stop, float* dpdata, cudaStream_t stream) {
    surfel_bwd_kernel<AUX><<<n_tiles * kSplit, block_threads(ts), 0, stream>>>(
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

// B8's launch shape for the variant without (aux 0) or with (aux 1) the
// maps and ts x ts tiles (ms_cluster_shape's seven ints).
extern "C" int surfel_bwd_info(int aux, int ts, void* out) {
    if (ts <= 0 || ts * ts > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = aux ? reinterpret_cast<const void*>(surfel_bwd_kernel<true>)
                         : reinterpret_cast<const void*>(surfel_bwd_kernel<false>);
    return ms_cluster_shape(fn, block_threads(ts), kSplit, static_cast<int*>(out));
}
