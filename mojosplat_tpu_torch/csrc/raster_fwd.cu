// Tile blend forward: front-to-back alpha compositing of each tile's slots.
//
// Replaces mojosplat_tpu/ops/raster_pallas.py::_raster_fwd_call (the Pallas
// kernel `_fwd_kernel`, reached through raster_tiles_pallas). Input is the
// field-major packed slot table pdata (6 + cp, n_tiles * cap): rows x, y,
// conic a/b/c, opacity, then cp channels; tile t owns columns
// [t * cap, t * cap + counts[t]). Output is (n_tiles, cp + 1, ts * ts),
// channel-major: the premultiplied channels, then the final transmittance T.
//
// The TPU kernel vectorises the recurrence over a chunk of slots with a lane
// cumprod and blends on the MXU through a 3-pass bf16 split. Here a block
// owns 256 pixels of a tile (a 32x32 tile is 4 blocks of 8 pixel rows; a
// smaller tile one block), a warp 64 consecutive pixels and a thread two of
// them, 32 apart (one column of two rows in a 32x32 tile: they share the
// slot's loads and dx terms, and their two serial chains overlap). Each
// pixel walks the slots in order with the per-pixel rule of
// rasterization.py:
//
//   alpha = min(opacity * exp(-sigma), max_alpha)
//   skip the slot unless sigma >= 0 and alpha >= alpha_threshold
//   stop before the slot that would take T to <= transmittance_eps
//   acc += alpha * T * channels;  T *= 1 - alpha
//
// The product runs sequentially in f32, so it differs from the TPU's chunked
// product at about 1e-6, which can flip the threshold or stop decision on a
// boundary pixel. Batches of slots are staged in shared memory as 16-byte
// records (each thread loads a share, coalesced along the slot axis, and a
// warp then reads a slot with a few float4 broadcasts). A block leaves once
// all its pixels are done.
//
// Bound on the card: the per-pixel alpha arithmetic (sigma, the exp and the
// compares; the probe B9 puts three quarters of the time there) and the
// issue of the serial walk; the slot table is read once per block. A slot
// binned to a tile often misses some of its rows: at the trained 1080p
// view no pixel of a 32-pixel row keeps 39% of the (row, slot) pairs. The
// per-row skip removes those:
// for each group of 32 staged slots, lane l tests slot l against the warp's
// rows (ms_row_may_apply, common.cuh: the closed-form minimum of sigma along
// the row, with a margin for f32 rounding), a ballot gives the warp its
// mask, and the warp walks only the set bits. The test never skips a slot
// some pixel would keep, and a kept slot's float operations are unchanged,
// so the output and residual are bit-equal to the full walk's. The skipped
// pairs were the cheap ones (no blend, no T update), so the skip saves less
// than its share; blocks of 8 rows wait at each batch's barrier only for
// their own slowest row.
//
// The backward's residual, written only when the caller passes its buffers
// (a separate instantiation, so the no-grad render runs the same code as
// without it): each pixel's transmittance at the entry of every
// kResidChunk-slot chunk it reaches alive, tchunk (n_tiles, nch, ts * ts),
// and its stop index, stop (n_tiles, ts * ts) int32: the slot whose
// transmittance test ended the pixel's walk (that slot is not applied), or
// the tile's count. The TPU kernel packs the done latch into the sign of
// its per-chunk T instead; a stop index needs no initialised buffer, since
// B2 reads a chunk's T only where the chunk starts below the stop. The
// alpha and the T update are common.cuh's, shared with B2.

// The blend-variant probe (B9) replays this kernel with one operation chain
// stripped or its blend product at bf16 precision, to attribute its time.
// It replaces scripts/dev_kernel_probe.py::run_variant (the Pallas kernel
// `_variant_kernel`). The variants are compile-time instantiations of the
// same tile body (Variant below); Variant::kFull is B1's production code,
// so the probe's "full" is B1 itself. The chunk-defined variants (nomask,
// noscan, blend, memonly) read every slot of each chunk of `chunk` slots
// that starts below the tile's count, as the TPU kernel reads every lane of
// such a chunk; their staging batch is the chunk. full, exp2, blend1 and
// blend3 take B1's per-row skip (their alpha is B1's, exp2's up to f32
// rounding); noexp, whose alpha is not an exponential, walks every slot.
#include <cuda_bf16.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBatch = 256;  // slots staged in shared memory per step
constexpr int kBlockPix = 256;  // pixels a block: a 32x32 tile is 4 blocks of 8 rows
constexpr int kPix = 2;  // pixels a thread: lane l of warp w owns pixels 64 w + l and + 32
constexpr int kWarpPix = 32 * kPix;  // pixels a warp (raster_cuda.B1_WARP_PIXELS)
constexpr unsigned kWarp = 0xffffffffu;

// Blocks of a tile, and threads a block: its pixels in whole warps.
inline int tile_blocks(int ts) { return (ts * ts + kBlockPix - 1) / kBlockPix; }
inline int block_threads(int ts) {
    return (std::min(ts * ts, kBlockPix) + kWarpPix - 1) / kWarpPix * 32;
}

// B1 (kFull) and the probe's variants of it (scripts/dev_kernel_probe.py):
//   kNoExp   e = 1 - min(sigma, 1) * 0.6 in place of exp(-sigma)
//   kExp2    e = exp2(-sigma * log2(e))
//   kNoMask  alpha = raw * 0.001: no sigma, threshold or count test
//   kNoScan  w = alpha * T at the chunk's entry; T *= 0.999 per chunk; no stop
//   kBlend   acc += opacity * channels over every slot; T stays 1
//   kMemOnly acc[c] += the sum over the field rows of the chunk's slot c
//   kBlend1  the product w * channels with both rounded to bf16
//   kBlend3  the product wh * chh + wh * bf16(cl) + bf16(wl) * chh
// (h: the bf16 rounding, l: what it leaves). Every variant but kFull gives
// a wrong image on purpose; they time the chains, and kBlend1/kBlend3 also
// give the image error of a bf16 tensor-core blend.
enum class Variant : int {
    kFull = 0, kNoExp, kExp2, kNoMask, kNoScan, kBlend, kMemOnly, kBlend1, kBlend3,
};

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// One slot's alpha under variant V: ms_slot_alpha for kFull, the same
// sigma with another e for kNoExp / kExp2, and no tests for kNoMask.
template <Variant V>
__device__ __forceinline__ bool variant_alpha(float dx, float dy, float ca, float cb,
                                              float cc, float op, float alpha_threshold,
                                              float max_alpha, float& alpha) {
    if constexpr (V == Variant::kFull || V == Variant::kBlend1 || V == Variant::kBlend3 ||
                  V == Variant::kNoScan) {
        float e, raw;
        return ms_slot_alpha(dx, dy, ca, cb, cc, op, alpha_threshold, max_alpha, e, raw,
                             alpha);
    } else {
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                     __fmul_rn(__fmul_rn(cc, dy), dy));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                      __fmul_rn(__fmul_rn(cb, dx), dy));
        float e;
        if constexpr (V == Variant::kNoExp) {
            e = __fsub_rn(1.0f, __fmul_rn(fminf(sigma, 1.0f), 0.6f));
        } else if constexpr (V == Variant::kExp2) {
            e = exp2f(__fmul_rn(sigma, -1.4426950408889634f));
        } else {
            e = expf(-sigma);
        }
        const float raw = __fmul_rn(op, e);
        if constexpr (V == Variant::kNoMask) {
            alpha = __fmul_rn(raw, 0.001f);
            return true;
        } else {
            alpha = raw > max_alpha ? max_alpha : raw;
            return sigma >= 0.0f && alpha >= alpha_threshold;
        }
    }
}

// Whether any pixel of the calling warp may keep staged slot j: the row
// test (common.cuh) over each pixel row the warp's pixels lie in (one row
// for 32-pixel tiles), each taken whole.
template <int CP>
__device__ __forceinline__ bool warp_may_apply(const float* __restrict__ slots, int j,
                                               int row_first, int row_last, int tile_x,
                                               int tile_y, int ts, float alpha_threshold) {
    float f[ms_record<CP>()];
    ms_load_record<CP>(slots, j, f);
    const float x_first = static_cast<float>(tile_x * ts) + 0.5f;
    const float x_last = static_cast<float>(tile_x * ts + ts - 1) + 0.5f;
    for (int r = row_first; r <= row_last; ++r) {
        const float py = static_cast<float>(tile_y * ts + r) + 0.5f;
        if (ms_row_may_apply(f[0], f[1], f[2], f[3], f[4], f[5], x_first, x_last, py,
                             alpha_threshold)) {
            return true;
        }
    }
    return false;
}

template <int CP, bool RESID, Variant V>
__device__ __forceinline__ void blend_tile(const float* __restrict__ pdata, int64_t stride,
                                           int cap, const int* __restrict__ counts, int ts,
                                           int tw, float alpha_threshold, float max_alpha,
                                           float eps, float* __restrict__ out,
                                           float* __restrict__ tchunk, int* __restrict__ stop,
                                           int* __restrict__ skipped, int nch, int chunk) {
    constexpr int kRows = 6 + CP;
    // Variants that read every slot of a chunk begun below the count.
    constexpr bool kWhole = V == Variant::kNoMask || V == Variant::kNoScan ||
                            V == Variant::kBlend || V == Variant::kMemOnly;
    // Variants whose alpha is ms_slot_alpha's (exp2's up to f32 rounding,
    // inside the row test's margin) walk only the slots the row test keeps.
    constexpr bool kSkip = V == Variant::kFull || V == Variant::kExp2 ||
                           V == Variant::kBlend1 || V == Variant::kBlend3;
    static_assert(kBatch % 32 == 0 && 32 % kResidChunk == 0, "chunks must tile a warp group");
    constexpr int kRec = ms_record<CP>();
    __shared__ __align__(16) float slots[kBatch * kRec];  // slot records

    const int nb = (ts * ts + kBlockPix - 1) / kBlockPix;
    const int t = blockIdx.x / nb;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int P = ts * ts;
    // The warp's first pixel in the tile; this thread owns w0 + lane + 32 k.
    const int w0 = (blockIdx.x - t * nb) * kBlockPix + (tid >> 5) * kWarpPix;
    const int count = min(max(counts[t], 0), cap);  // never past the tile
    const int tile_y = t / tw;
    const int tile_x = t - tile_y * tw;
    // The pixel rows of this warp's pixels.
    const int row_first = w0 / ts;
    const int row_last = min(w0 + kWarpPix - 1, P - 1) / ts;
    const int batch = kWhole ? chunk : kBatch;

    // Each of the thread's pixels: a pixel past the tile starts done.
    int p[kPix];
    float px[kPix], py[kPix], T[kPix];
    bool done[kPix];
    int stop_at[kPix];
    float acc[kPix][CP];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
        p[k] = w0 + lane + 32 * k;
        px[k] = static_cast<float>(tile_x * ts + p[k] % ts) + 0.5f;
        py[k] = static_cast<float>(tile_y * ts + p[k] / ts) + 0.5f;
        T[k] = 1.0f;
        done[k] = p[k] >= P;
        stop_at[k] = count;
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[k][c] = 0.0f;
    }
    float* tres = RESID ? tchunk + static_cast<int64_t>(t) * nch * P : nullptr;
    int nskip = 0;
    auto all_done = [&]() {
        bool all = true;
#pragma unroll
        for (int k = 0; k < kPix; ++k) all = all && done[k];
        return all;
    };

    const float* tile = pdata + static_cast<int64_t>(t) * cap;
    for (int b0 = 0; b0 < count; b0 += batch) {
        const int n = kWhole ? min(batch, cap - b0) : min(kBatch, count - b0);
        for (int i = tid; i < kRows * n; i += blockDim.x) {
            const int r = i / n;
            const int j = i - r * n;
            slots[j * kRec + r] = __ldg(tile + r * stride + b0 + j);
        }
        __syncthreads();
        if constexpr (V == Variant::kMemOnly) {
#pragma unroll
            for (int c = 0; c < CP; ++c) {
                float s = 0.0f;
                for (int r = 0; r < kRows; ++r) s += slots[c * kRec + r];
#pragma unroll
                for (int k = 0; k < kPix; ++k) acc[k][c] += s;
            }
        } else if constexpr (V == Variant::kBlend) {
            for (int j = 0; j < n; ++j) {
                const float op = slots[j * kRec + 5];
#pragma unroll
                for (int k = 0; k < kPix; ++k) {
#pragma unroll
                    for (int c = 0; c < CP; ++c) acc[k][c] += op * slots[j * kRec + 6 + c];
                }
            }
        } else if constexpr (V == Variant::kNoScan) {
            for (int j = 0; j < n; ++j) {
                float f[kRec];
                ms_load_record<CP>(slots, j, f);
#pragma unroll
                for (int k = 0; k < kPix; ++k) {
                    float alpha;
                    if (b0 + j >= count ||
                        !variant_alpha<V>(f[0] - px[k], f[1] - py[k], f[2], f[3], f[4], f[5],
                                          alpha_threshold, max_alpha, alpha)) {
                        continue;
                    }
                    const float w = alpha * T[k];
#pragma unroll
                    for (int c = 0; c < CP; ++c) acc[k][c] += w * f[6 + c];
                }
            }
#pragma unroll
            for (int k = 0; k < kPix; ++k) T[k] = __fmul_rn(T[k], 0.999f);
        } else {
            // Groups of 32 slots: lane l tests slot g + l against the warp's
            // rows, and the warp walks only the slots some row may keep, in
            // order. T does not change over a skipped slot, so the residual
            // still gets T at the entry of every chunk the pixel reaches
            // alive. Without the skip (noexp, nomask) every slot may apply.
            // A thread computes both pixels' alphas before either's T update,
            // so the two chains overlap.
            for (int g = 0; g < n; g += 32) {
                if (__all_sync(kWarp, all_done())) break;
                const int valid = min(32, n - g);
                bool may = lane < valid;
                if constexpr (kSkip) {
                    may = may && warp_may_apply<CP>(slots, g + lane, row_first, row_last,
                                                    tile_x, tile_y, ts, alpha_threshold);
                }
                const unsigned m = __ballot_sync(kWarp, may);
                nskip += valid - __popc(m);
#pragma unroll
                for (int h = 0; h < 32; h += kResidChunk) {
                    if (h >= valid) break;
                    if (RESID) {
                        const int64_t o = static_cast<int64_t>((b0 + g + h) / kResidChunk) * P;
#pragma unroll
                        for (int k = 0; k < kPix; ++k) {
                            if (!done[k]) tres[o + p[k]] = T[k];
                        }
                    }
                    unsigned bits = (m >> h) & (0xffffffffu >> (32 - kResidChunk));
                    while (bits != 0u) {
                        const int j = g + h + __ffs(bits) - 1;
                        bits &= bits - 1u;
                        if (all_done()) continue;
                        float f[kRec];
                        ms_load_record<CP>(slots, j, f);
                        float alpha[kPix];
                        bool keep[kPix];
#pragma unroll
                        for (int k = 0; k < kPix; ++k) {
                            const bool kept =
                                variant_alpha<V>(f[0] - px[k], f[1] - py[k], f[2], f[3], f[4],
                                                 f[5], alpha_threshold, max_alpha, alpha[k]);
                            keep[k] = kept && !done[k];
                        }
#pragma unroll
                        for (int k = 0; k < kPix; ++k) {
                            if (!keep[k]) continue;
                            const float next_T = ms_transmit(T[k], alpha[k]);
                            if (next_T <= eps) {
                                done[k] = true;
                                stop_at[k] = b0 + j;
                                continue;
                            }
                            // The bf16 variants round w = alpha * T itself
                            // (never an FMA of it into w - wh); a product of
                            // two bf16 values is exact in f32, so their sums
                            // match the plain version's bit for bit.
                            if constexpr (V == Variant::kBlend1) {
                                const float wh = bf16_round(__fmul_rn(alpha[k], T[k]));
#pragma unroll
                                for (int c = 0; c < CP; ++c) {
                                    acc[k][c] += wh * bf16_round(f[6 + c]);
                                }
                            } else if constexpr (V == Variant::kBlend3) {
                                const float wr = __fmul_rn(alpha[k], T[k]);
                                const float wh = bf16_round(wr);
                                const float wl = bf16_round(__fsub_rn(wr, wh));
#pragma unroll
                                for (int c = 0; c < CP; ++c) {
                                    const float ch = f[6 + c];
                                    const float chh = bf16_round(ch);
                                    const float cl = bf16_round(ch - chh);
                                    acc[k][c] += (wh * chh + wh * cl) + wl * chh;
                                }
                            } else {
                                const float w = alpha[k] * T[k];
#pragma unroll
                                for (int c = 0; c < CP; ++c) acc[k][c] += w * f[6 + c];
                            }
                            T[k] = next_T;
                        }
                    }
                }
            }
        }
        // A barrier too: no thread reloads the batch while another reads it.
        if (__syncthreads_count(all_done() ? 0 : 1) == 0) break;
    }

    if (skipped != nullptr && lane == 0) {
        skipped[static_cast<int64_t>(t) * ((P + kWarpPix - 1) / kWarpPix) + w0 / kWarpPix] =
            nskip;
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
        if (p[k] >= P) continue;
        float* o = out + static_cast<int64_t>(t) * (CP + 1) * P + p[k];
#pragma unroll
        for (int c = 0; c < CP; ++c) o[c * P] = acc[k][c];
        o[CP * P] = T[k];
        if (RESID) stop[static_cast<int64_t>(t) * P + p[k]] = stop_at[k];
    }
}

template <int CP, bool RESID>
__global__ void __launch_bounds__(kBlockPix / kPix, 8)
raster_fwd_kernel(const float* __restrict__ pdata, int64_t stride, int cap,
                  const int* __restrict__ counts, int ts, int tw,
                  float alpha_threshold, float max_alpha, float eps,
                  float* __restrict__ out, float* __restrict__ tchunk,
                  int* __restrict__ stop, int* __restrict__ skipped, int nch) {
    blend_tile<CP, RESID, Variant::kFull>(pdata, stride, cap, counts, ts, tw,
                                          alpha_threshold, max_alpha, eps, out, tchunk,
                                          stop, skipped, nch, kBatch);
}

template <int CP, Variant V>
__global__ void __launch_bounds__(kBlockPix / kPix, 8)
raster_probe_kernel(const float* __restrict__ pdata, int64_t stride, int cap,
                    const int* __restrict__ counts, int ts, int tw,
                    float alpha_threshold, float max_alpha, float eps,
                    float* __restrict__ out, int chunk) {
    blend_tile<CP, false, V>(pdata, stride, cap, counts, ts, tw, alpha_threshold,
                             max_alpha, eps, out, nullptr, nullptr, nullptr, 0, chunk);
}

template <int CP>
void launch(const float* pdata, int n_tiles, int cap, const int* counts,
            int ts, int tw, float alpha_threshold, float max_alpha, float eps,
            float* out, float* tchunk, int* stop, int* skipped, cudaStream_t stream) {
    const int64_t stride = static_cast<int64_t>(n_tiles) * cap;
    const int nch = (cap + kResidChunk - 1) / kResidChunk;
    if (tchunk != nullptr) {
        raster_fwd_kernel<CP, true><<<n_tiles * tile_blocks(ts), block_threads(ts), 0, stream>>>(
            pdata, stride, cap, counts, ts, tw, alpha_threshold, max_alpha, eps,
            out, tchunk, stop, skipped, nch);
    } else {
        raster_fwd_kernel<CP, false><<<n_tiles * tile_blocks(ts), block_threads(ts), 0, stream>>>(
            pdata, stride, cap, counts, ts, tw, alpha_threshold, max_alpha, eps,
            out, nullptr, nullptr, skipped, nch);
    }
}

template <Variant V>
void launch_probe(int cp, const float* pdata, int n_tiles, int cap, const int* counts,
                  int ts, int tw, float alpha_threshold, float max_alpha, float eps,
                  float* out, int chunk, cudaStream_t stream) {
    const int64_t stride = static_cast<int64_t>(n_tiles) * cap;
#define MS_PROBE_CASE(C)                                                              \
    case C:                                                                           \
        raster_probe_kernel<C, V><<<n_tiles * tile_blocks(ts), block_threads(ts), 0, stream>>>(           \
            pdata, stride, cap, counts, ts, tw, alpha_threshold, max_alpha, eps, out, \
            chunk);                                                                   \
        break;
    switch (cp) {
        MS_PROBE_CASE(4)
        MS_PROBE_CASE(5)
        MS_PROBE_CASE(6)
        MS_PROBE_CASE(7)
        MS_PROBE_CASE(8)
    }
#undef MS_PROBE_CASE
}

}  // namespace

// pdata: (rows, n_tiles * cap) f32 with rows = 6 + cp, 4 <= cp <= 8;
// counts: (n_tiles,) int32 <= cap; out: (n_tiles, cp + 1, ts * ts) f32.
// tchunk (n_tiles, ceil(cap / kResidChunk), ts * ts) f32 and stop
// (n_tiles, ts * ts) int32 receive the backward's residual; both null for
// a render that needs no gradient. skipped (n_tiles, ceil(ts * ts / 32))
// int32, or null, receives each warp's count of the slots the row test
// skipped in the 32-slot groups it tested (a group is tested unless every
// pixel of the warp stopped before it).
extern "C" int raster_fwd_launch(const void* pdata, int rows, int n_tiles,
                                 int cap, const void* counts, int ts, int tw,
                                 float alpha_threshold, float max_alpha,
                                 float eps, void* out, void* tchunk,
                                 void* stop, void* skipped, void* stream) {
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
    switch (rows - 6) {
        case 4: launch<4>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, sk, s); break;
        case 5: launch<5>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, sk, s); break;
        case 6: launch<6>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, sk, s); break;
        case 7: launch<7>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, sk, s); break;
        case 8: launch<8>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, sk, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    MS_RETURN_LAUNCH_STATUS();
}

// The probe (B9): variant 0..8 in Variant's order, chunk the slots per chunk
// of the chunk-defined variants (1..256, dividing cap), the rest as
// raster_fwd_launch without a residual.
extern "C" int raster_probe_launch(int variant, int chunk, const void* pdata, int rows,
                                   int n_tiles, int cap, const void* counts, int ts, int tw,
                                   float alpha_threshold, float max_alpha, float eps,
                                   void* out, void* stream) {
    if (n_tiles <= 0) return 0;
    if (ts <= 0 || ts * ts > 1024 || rows - 6 < 4 || rows - 6 > 8 || chunk < rows - 6 ||
        chunk > kBatch || cap % chunk != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto* pd = static_cast<const float*>(pdata);
    const auto* ct = static_cast<const int*>(counts);
    auto* o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const int cp = rows - 6;
#define MS_VARIANT_CASE(V)                                                                \
    case static_cast<int>(V):                                                             \
        launch_probe<V>(cp, pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, \
                        o, chunk, s);                                                     \
        break;
    switch (variant) {
        MS_VARIANT_CASE(Variant::kFull)
        MS_VARIANT_CASE(Variant::kNoExp)
        MS_VARIANT_CASE(Variant::kExp2)
        MS_VARIANT_CASE(Variant::kNoMask)
        MS_VARIANT_CASE(Variant::kNoScan)
        MS_VARIANT_CASE(Variant::kBlend)
        MS_VARIANT_CASE(Variant::kMemOnly)
        MS_VARIANT_CASE(Variant::kBlend1)
        MS_VARIANT_CASE(Variant::kBlend3)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef MS_VARIANT_CASE
    MS_RETURN_LAUNCH_STATUS();
}
