// Surfel (2DGS) tile blend forward: B6, and B7 with the maps.
//
// Replaces mojosplat_tpu/ops/surfel_pallas.py::_fwd_call (the Pallas kernel
// `_fwd_kernel`, reached through raster_surfel_tiles_pallas; aux=False is
// B6, aux=True B7). Input is the field-major packed slot table pdata
// (rows, n_tiles * cap), rows 16, or 18 with the maps (surfel.cuh); tile t
// owns columns [t * cap, t * cap + counts[t]). Output is channel-major
// (n_tiles, oc, ts * ts): without the maps oc = 5, the blended rows 12-15
// (rgb and the zero pad) and the final transmittance T; with them oc = 9,
// rgb, normals, the intersection-depth moments m1 = sum(w z) and
// m2 = sum(w z^2), and T.
//
// The TPU kernel blends a chunk of slots at once with lane cumprods and an
// MXU product through a bf16 split. Here a block owns 256 pixels of a tile
// (a 32x32 tile is 4 blocks of 8 pixel rows; a smaller tile one block), a
// thread one pixel, and each pixel walks the slots in order:
//
//   alpha from ms_surfel_alpha (surfel.cuh); skip the slot unless kept
//   stop before the slot that would take T to <= transmittance_eps
//   w = alpha T;  acc += w * rows 12..;  with the maps m1 += w z, m2 += w z^2
//   T *= 1 - alpha
//
// Batches of slots are staged in shared memory as 16-byte records (each
// thread loads a share, coalesced along the slot axis; a warp then reads a
// slot with a few float4 broadcasts, the blended rows only where the
// pixel keeps it). A block leaves once all its pixels are done, and 4
// blocks are resident on an SM (32 warps), so a tile's slow rows hold up
// only their own block.
//
// Bound on the card: per (pixel, slot) pair two exponentials, two
// divisions and about 50 other f32 operations; the alpha arithmetic takes
// nine tenths of the time (PERF.md), and the slot table is read once per
// block. 2DGS bins without tight culling, so at the trained 1080p view no
// pixel of a row keeps 49% of the (row, slot) pairs below the counts. The
// per-row skip removes those: for each group of 32 staged slots, lane l
// tests slot l against each pixel row of the warp (ms_surfel_row_may_apply,
// surfel.cuh: closed-form bounds on both branches of the alpha over the
// row, with a margin for f32 rounding), and the warp walks only the slots
// some row may keep. The test never skips a slot some pixel would keep,
// and a kept slot's float operations are unchanged, so the output and
// residual are bit-equal to the full walk's.
//
// Two pixels a thread (B1's layout) ran 2-5% faster, but the surfel alpha
// of two pixels beside the blend's accumulators needs 68-76 registers, and
// 32 warps an SM leave 64: it spilled (PERF.md).
//
// The backward's residual, written only when the caller passes its buffers
// (a separate instantiation): each pixel's T at the entry of every
// kResidChunk-slot chunk it reaches alive, and its stop index, exactly as
// B1 writes them (raster_fwd.cu), where the TPU kernel sign-packs the done
// latch into a per-chunk T. Each pixel's float operations and their order
// do not depend on the block shape or the skip, so neither do the image,
// the maps and the residual.

#include "surfel.cuh"

namespace {

constexpr int kBlockPix = 256;  // pixels a block, one a thread: a 32x32 tile is 4 blocks
constexpr int kMinBlocks = 4;   // resident blocks per SM: 32 warps, 64 registers a thread
constexpr unsigned kWarp = 0xffffffffu;

// Threads a block (the tile's pixels up to kBlockPix, in whole warps) and
// blocks a tile.
__host__ __device__ inline int block_threads(int ts) {
    const int n = ts * ts < kBlockPix ? ts * ts : kBlockPix;
    return (n + 31) / 32 * 32;
}
__host__ __device__ inline int tile_blocks(int ts) {
    return (ts * ts + kBlockPix - 1) / kBlockPix;
}

// Shared bytes a block: its batch of slot records, a slot a thread. A
// batch in proportion to the block keeps an 8x8 tile's 64-thread blocks at
// 16 an SM.
template <bool AUX>
int batch_bytes(int ts) {
    return block_threads(ts) * ms_surfel_record<AUX ? kSurfelAuxRows : kSurfelRows>() *
           static_cast<int>(sizeof(float));
}

// walk_all and skipped serve surfel_fwd_check_launch alone; every render
// and training launch passes 0 and null. They are runtime arguments, tested
// once per 32-slot group: as template values of their own (PERF.md) the
// B7 residual instantiation spilled 8 bytes at the same 64 registers and
// ran no faster.
template <bool AUX, bool RESID>
__global__ void __launch_bounds__(kBlockPix, kMinBlocks)
surfel_fwd_kernel(const float* __restrict__ pdata, int64_t stride, int cap,
                  const int* __restrict__ counts, int ts, int tw,
                  float alpha_threshold, float max_alpha, float eps,
                  float* __restrict__ out, float* __restrict__ tchunk,
                  int* __restrict__ stop, int nch, int walk_all, int* __restrict__ skipped) {
    constexpr int kRows = AUX ? kSurfelAuxRows : kSurfelRows;
    constexpr int kCh = kRows - 12;  // rows blended as constants
    constexpr int kOut = AUX ? 9 : 5;
    constexpr int kRec = ms_surfel_record<kRows>();
    constexpr int kGeo = 3;  // record words of rows 0-11, the alpha's
    static_assert(32 % kResidChunk == 0, "chunks must tile a group of 32 slots");
    extern __shared__ float4 records[];
    float* slots = reinterpret_cast<float*>(records);  // the batch's slot records
    const int batch = blockDim.x;                      // a multiple of 32

    const int nb = tile_blocks(ts);
    const int t = blockIdx.x / nb;
    const int lane = threadIdx.x & 31;
    const int P = ts * ts;
    // This thread's pixel in the tile, and its warp's first.
    const int p = (blockIdx.x - t * nb) * kBlockPix + threadIdx.x;
    const int w0 = p - lane;
    const int count = min(max(counts[t], 0), cap);  // never past the tile
    const int tile_y = t / tw;
    const int tile_x = t - tile_y * tw;
    const float px = static_cast<float>(tile_x * ts + p % ts) + 0.5f;
    const float py = static_cast<float>(tile_y * ts + p / ts) + 0.5f;

    // A pixel past the tile starts done. The stop index is written when the
    // pixel stops, the count at the end.
    float T = 1.0f;
    bool done = p >= P;
    float acc[kCh];
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[c] = 0.0f;
    float m1 = 0.0f, m2 = 0.0f;

    const float* tile = pdata + static_cast<int64_t>(t) * cap;
    for (int b0 = 0; b0 < count; b0 += batch) {
        const int n = min(batch, count - b0);
        // Slot j's record: its rows, then zeros to the record's end.
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
            float4* rec = records + j * (kRec / 4);
#pragma unroll
            for (int q = 0; q < kRec / 4; ++q) {
                float v[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = 4 * q + e;
                    v[e] = r < kRows ? __ldg(tile + r * stride + b0 + j) : 0.0f;
                }
                rec[q] = make_float4(v[0], v[1], v[2], v[3]);
            }
        }
        __syncthreads();
        // Groups of 32 slots: lane l tests slot g + l against each of the
        // warp's pixel rows, and the warp walks, in order, the slots some
        // row may keep. T does not change over a skipped slot, so the
        // residual still gets T at the entry of every chunk the pixel
        // reaches alive.
        for (int g = 0; g < n; g += 32) {
            if (__all_sync(kWarp, done)) break;
            const int valid = min(32, n - g);
            const int row_first = w0 / ts;
            const int nrows = min((w0 + 31) / ts, ts - 1) - row_first + 1;
            unsigned may = 0u;  // bit r: row row_first + r may keep slot g + lane
            if (lane < valid) {
                const float* rec = slots + (g + lane) * kRec;
                const float x_first = static_cast<float>(tile_x * ts) + 0.5f;
                const float x_last = static_cast<float>(tile_x * ts + ts - 1) + 0.5f;
                const float log_thr = logf(alpha_threshold);
                for (int r = 0; r < nrows; ++r) {
                    const float y = static_cast<float>(tile_y * ts + row_first + r) + 0.5f;
                    if (walk_all || ms_surfel_row_may_apply(rec, x_first, x_last, y, log_thr)) {
                        may |= 1u << r;
                    }
                }
            }
            unsigned any = 0u;  // bit l: some row may keep slot g + l
            for (int r = 0; r < nrows; ++r) {
                const unsigned m = __ballot_sync(kWarp, (may >> r) & 1u);
                any |= m;
                if (skipped != nullptr && lane == 0) {
                    atomicAdd(skipped + static_cast<int64_t>(t) * (nb * blockDim.x / 32) + w0 / 32,
                              valid - __popc(m));
                }
            }
            for (int h = 0; h < valid; h += kResidChunk) {
                if (RESID && !done) {
                    tchunk[(static_cast<int64_t>(t) * nch + (b0 + g + h) / kResidChunk) * P + p] = T;
                }
                unsigned bits = (any >> h) & ((1u << kResidChunk) - 1u);
                while (bits != 0u && !done) {
                    const int j = g + h + __ffs(bits) - 1;
                    bits &= bits - 1u;
                    float f[kRec];
                    ms_surfel_load<kRec, 0, kGeo>(slots, j, f);
                    MsSurfel gs;
                    if (!ms_surfel_alpha(f, 1, px, py, alpha_threshold, max_alpha, gs)) continue;
                    const float next_T = ms_transmit(T, gs.alpha);
                    if (next_T <= eps) {
                        done = true;
                        if (RESID) stop[static_cast<int64_t>(t) * P + p] = b0 + j;
                        break;
                    }
                    ms_surfel_load<kRec, kGeo>(slots, j, f);
                    const float w = gs.alpha * T;
#pragma unroll
                    for (int c = 0; c < kCh; ++c) acc[c] += w * f[12 + c];
                    if (AUX) {
                        const float z = ms_surfel_depth(f, 1, gs);
                        const float wz = w * z;
                        m1 += wz;
                        m2 += wz * z;
                    }
                    T = next_T;
                }
            }
        }
        // A barrier too: no thread reloads the batch while another reads it.
        if (__syncthreads_count(done ? 0 : 1) == 0) break;
    }

    if (p >= P) return;
    float* o = out + static_cast<int64_t>(t) * kOut * P + p;
#pragma unroll
    for (int c = 0; c < kCh; ++c) o[c * P] = acc[c];
    if (AUX) {
        o[kCh * P] = m1;
        o[(kCh + 1) * P] = m2;
    }
    o[(kOut - 1) * P] = T;
    if (RESID && !done) stop[static_cast<int64_t>(t) * P + p] = count;
}

template <bool AUX>
void launch(const float* pdata, int n_tiles, int cap, const int* counts, int ts, int tw,
            float alpha_threshold, float max_alpha, float eps, float* out, float* tchunk,
            int* stop, int walk_all, int* skipped, cudaStream_t stream) {
    const int64_t stride = static_cast<int64_t>(n_tiles) * cap;
    const int nch = (cap + kResidChunk - 1) / kResidChunk;
    const int blocks = n_tiles * tile_blocks(ts);
    const int smem = batch_bytes<AUX>(ts);
    if (tchunk != nullptr) {
        surfel_fwd_kernel<AUX, true><<<blocks, block_threads(ts), smem, stream>>>(
            pdata, stride, cap, counts, ts, tw, alpha_threshold, max_alpha, eps, out,
            tchunk, stop, nch, walk_all, skipped);
    } else {
        surfel_fwd_kernel<AUX, false><<<blocks, block_threads(ts), smem, stream>>>(
            pdata, stride, cap, counts, ts, tw, alpha_threshold, max_alpha, eps, out,
            nullptr, nullptr, nch, walk_all, skipped);
    }
}

int launch_rows(const void* pdata, int rows, int n_tiles, int cap, const void* counts, int ts,
                int tw, float alpha_threshold, float max_alpha, float eps, void* out,
                void* tchunk, void* stop, int walk_all, void* skipped, void* stream) {
    if (n_tiles <= 0) return 0;
    if (ts <= 0 || ts * ts > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const auto* pd = static_cast<const float*>(pdata);
    const auto* ct = static_cast<const int*>(counts);
    auto* o = static_cast<float*>(out);
    auto* tc = static_cast<float*>(tchunk);
    auto* st = static_cast<int*>(stop);
    auto* sk = static_cast<int*>(skipped);
    if ((tc == nullptr) != (st == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    switch (rows) {
        case kSurfelRows: launch<false>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, walk_all, sk, s); break;
        case kSurfelAuxRows: launch<true>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, walk_all, sk, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    MS_RETURN_LAUNCH_STATUS();
}

}  // namespace

// pdata: (rows, n_tiles * cap) f32, rows 16 (B6) or 18 (B7, the maps);
// counts: (n_tiles,) int32; out: (n_tiles, 5 or 9, ts * ts) f32. tchunk
// (n_tiles, ceil(cap / kResidChunk), ts * ts) f32 and stop (n_tiles,
// ts * ts) int32 receive the backward's residual; both null for a render
// that needs no gradient.
extern "C" int surfel_fwd_launch(const void* pdata, int rows, int n_tiles, int cap,
                                 const void* counts, int ts, int tw, float alpha_threshold,
                                 float max_alpha, float eps, void* out, void* tchunk,
                                 void* stop, void* stream) {
    return launch_rows(pdata, rows, n_tiles, cap, counts, ts, tw, alpha_threshold, max_alpha,
                       eps, out, tchunk, stop, 0, nullptr, stream);
}

// The row test's check: surfel_fwd_launch with the residual, walking every
// slot below each pixel's stop if walk_all (the full walk, whose output
// and residual the row test must not change), and adding to skipped
// (n_tiles, warps a tile) int32, zeroed by the caller: each warp's count of
// the (pixel row, slot) pairs its row test skipped in the 32-slot groups it
// tested (a group is tested unless every pixel of the warp stopped before
// it).
extern "C" int surfel_fwd_check_launch(int walk_all, const void* pdata, int rows, int n_tiles,
                                       int cap, const void* counts, int ts, int tw,
                                       float alpha_threshold, float max_alpha, float eps,
                                       void* out, void* tchunk, void* stop, void* skipped,
                                       void* stream) {
    if (tchunk == nullptr || skipped == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_rows(pdata, rows, n_tiles, cap, counts, ts, tw, alpha_threshold, max_alpha,
                       eps, out, tchunk, stop, walk_all, skipped, stream);
}

// The launch shape of B6 (aux 0) or B7 (aux 1), without (resid 0) or with
// (resid 1) the residual, for ts x ts tiles (ms_cluster_shape's seven ints;
// no clusters).
extern "C" int surfel_fwd_info(int aux, int resid, int ts, void* out) {
    if (ts <= 0 || ts * ts > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const void* fn =
        aux ? (resid ? reinterpret_cast<const void*>(surfel_fwd_kernel<true, true>)
                     : reinterpret_cast<const void*>(surfel_fwd_kernel<true, false>))
            : (resid ? reinterpret_cast<const void*>(surfel_fwd_kernel<false, true>)
                     : reinterpret_cast<const void*>(surfel_fwd_kernel<false, false>));
    return ms_cluster_shape(fn, block_threads(ts), 1, static_cast<int*>(out),
                            aux ? batch_bytes<true>(ts) : batch_bytes<false>(ts));
}
