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
// cumprod and blends on the MXU through a 3-pass bf16 split. Here one block
// owns one tile and one thread owns one pixel, and each pixel walks the
// slots in order with the per-pixel rule of rasterization.py:
//
//   alpha = min(opacity * exp(-sigma), max_alpha)
//   skip the slot unless sigma >= 0 and alpha >= alpha_threshold
//   stop before the slot that would take T to <= transmittance_eps
//   acc += alpha * T * channels;  T *= 1 - alpha
//
// The product runs sequentially in f32, so it differs from the TPU's chunked
// product at about 1e-6, which can flip the threshold or stop decision on a
// boundary pixel. Batches of slots are staged in shared memory (each thread
// loads a share, coalesced along the slot axis, and every pixel then reads
// the same address: a broadcast). The block leaves once every pixel is done.
//
// Bound on the card: the per-pixel exp and blend arithmetic (about 25 flops
// per pixel and slot) and the latency of the serial walk; the slot table is
// read once per tile. __launch_bounds__(1024) caps registers at 64 a thread
// so a 32x32 tile (1024 threads) fits one block.
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
// such a chunk; their staging batch is the chunk.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBatch = 256;  // slots staged in shared memory per step

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

template <int CP, bool RESID, Variant V>
__device__ __forceinline__ void blend_tile(const float* __restrict__ pdata, int64_t stride,
                                           int cap, const int* __restrict__ counts, int ts,
                                           int tw, float alpha_threshold, float max_alpha,
                                           float eps, float* __restrict__ out,
                                           float* __restrict__ tchunk, int* __restrict__ stop,
                                           int nch, int chunk) {
    constexpr int kRows = 6 + CP;
    // Variants that read every slot of a chunk begun below the count.
    constexpr bool kWhole = V == Variant::kNoMask || V == Variant::kNoScan ||
                            V == Variant::kBlend || V == Variant::kMemOnly;
    __shared__ float slots[kRows * kBatch];

    const int t = blockIdx.x;
    const int p = threadIdx.x;
    const int P = blockDim.x;
    const int count = min(max(counts[t], 0), cap);  // never past the tile
    const int tile_y = t / tw;
    const int tile_x = t - tile_y * tw;
    const float px = static_cast<float>(tile_x * ts + p % ts) + 0.5f;
    const float py = static_cast<float>(tile_y * ts + p / ts) + 0.5f;
    const int batch = kWhole ? chunk : kBatch;

    float T = 1.0f;
    bool done = false;
    int stop_at = count;
    float* tres = RESID ? tchunk + static_cast<int64_t>(t) * nch * P + p : nullptr;
    float acc[CP];
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[c] = 0.0f;

    const float* tile = pdata + static_cast<int64_t>(t) * cap;
    for (int b0 = 0; b0 < count; b0 += batch) {
        const int n = kWhole ? min(batch, cap - b0) : min(kBatch, count - b0);
        for (int i = p; i < kRows * n; i += P) {
            const int r = i / n;
            const int j = i - r * n;
            slots[r * kBatch + j] = __ldg(tile + r * stride + b0 + j);
        }
        __syncthreads();
        if constexpr (V == Variant::kMemOnly) {
#pragma unroll
            for (int c = 0; c < CP; ++c) {
                float s = 0.0f;
                for (int r = 0; r < kRows; ++r) s += slots[r * kBatch + c];
                acc[c] += s;
            }
        } else if constexpr (V == Variant::kBlend) {
            for (int j = 0; j < n; ++j) {
                const float op = slots[5 * kBatch + j];
#pragma unroll
                for (int c = 0; c < CP; ++c) acc[c] += op * slots[(6 + c) * kBatch + j];
            }
        } else if constexpr (V == Variant::kNoScan) {
            for (int j = 0; j < n; ++j) {
                float alpha;
                if (b0 + j >= count ||
                    !variant_alpha<V>(slots[0 * kBatch + j] - px, slots[1 * kBatch + j] - py,
                                      slots[2 * kBatch + j], slots[3 * kBatch + j],
                                      slots[4 * kBatch + j], slots[5 * kBatch + j],
                                      alpha_threshold, max_alpha, alpha)) {
                    continue;
                }
                const float w = alpha * T;
#pragma unroll
                for (int c = 0; c < CP; ++c) acc[c] += w * slots[(6 + c) * kBatch + j];
            }
            T = __fmul_rn(T, 0.999f);
        } else if (!done) {
            for (int j = 0; j < n; ++j) {
                if (RESID && ((b0 + j) % kResidChunk) == 0) {
                    tres[static_cast<int64_t>((b0 + j) / kResidChunk) * P] = T;
                }
                const float dx = slots[0 * kBatch + j] - px;
                const float dy = slots[1 * kBatch + j] - py;
                float alpha;
                if (!variant_alpha<V>(dx, dy, slots[2 * kBatch + j], slots[3 * kBatch + j],
                                      slots[4 * kBatch + j], slots[5 * kBatch + j],
                                      alpha_threshold, max_alpha, alpha)) {
                    continue;
                }
                const float next_T = ms_transmit(T, alpha);
                if (next_T <= eps) {
                    done = true;
                    stop_at = b0 + j;
                    break;
                }
                // The bf16 variants round w = alpha * T itself (never an FMA
                // of it into w - wh); a product of two bf16 values is exact in
                // f32, so their sums match the plain version's bit for bit.
                if constexpr (V == Variant::kBlend1) {
                    const float wh = bf16_round(__fmul_rn(alpha, T));
#pragma unroll
                    for (int c = 0; c < CP; ++c) {
                        acc[c] += wh * bf16_round(slots[(6 + c) * kBatch + j]);
                    }
                } else if constexpr (V == Variant::kBlend3) {
                    const float wr = __fmul_rn(alpha, T);
                    const float wh = bf16_round(wr);
                    const float wl = bf16_round(__fsub_rn(wr, wh));
#pragma unroll
                    for (int c = 0; c < CP; ++c) {
                        const float ch = slots[(6 + c) * kBatch + j];
                        const float chh = bf16_round(ch);
                        const float cl = bf16_round(ch - chh);
                        acc[c] += (wh * chh + wh * cl) + wl * chh;
                    }
                } else {
                    const float w = alpha * T;
#pragma unroll
                    for (int c = 0; c < CP; ++c) acc[c] += w * slots[(6 + c) * kBatch + j];
                }
                T = next_T;
            }
        }
        // A barrier too: no thread reloads the batch while another reads it.
        if (__syncthreads_count(done ? 0 : 1) == 0) break;
    }

    float* o = out + static_cast<int64_t>(t) * (CP + 1) * P + p;
#pragma unroll
    for (int c = 0; c < CP; ++c) o[c * P] = acc[c];
    o[CP * P] = T;
    if (RESID) stop[static_cast<int64_t>(t) * P + p] = stop_at;
}

template <int CP, bool RESID>
__global__ void __launch_bounds__(1024)
raster_fwd_kernel(const float* __restrict__ pdata, int64_t stride, int cap,
                  const int* __restrict__ counts, int ts, int tw,
                  float alpha_threshold, float max_alpha, float eps,
                  float* __restrict__ out, float* __restrict__ tchunk,
                  int* __restrict__ stop, int nch) {
    blend_tile<CP, RESID, Variant::kFull>(pdata, stride, cap, counts, ts, tw,
                                          alpha_threshold, max_alpha, eps, out, tchunk,
                                          stop, nch, kBatch);
}

template <int CP, Variant V>
__global__ void __launch_bounds__(1024)
raster_probe_kernel(const float* __restrict__ pdata, int64_t stride, int cap,
                    const int* __restrict__ counts, int ts, int tw,
                    float alpha_threshold, float max_alpha, float eps,
                    float* __restrict__ out, int chunk) {
    blend_tile<CP, false, V>(pdata, stride, cap, counts, ts, tw, alpha_threshold,
                             max_alpha, eps, out, nullptr, nullptr, 0, chunk);
}

template <int CP>
void launch(const float* pdata, int n_tiles, int cap, const int* counts,
            int ts, int tw, float alpha_threshold, float max_alpha, float eps,
            float* out, float* tchunk, int* stop, cudaStream_t stream) {
    const int64_t stride = static_cast<int64_t>(n_tiles) * cap;
    const int nch = (cap + kResidChunk - 1) / kResidChunk;
    if (tchunk != nullptr) {
        raster_fwd_kernel<CP, true><<<n_tiles, ts * ts, 0, stream>>>(
            pdata, stride, cap, counts, ts, tw, alpha_threshold, max_alpha, eps,
            out, tchunk, stop, nch);
    } else {
        raster_fwd_kernel<CP, false><<<n_tiles, ts * ts, 0, stream>>>(
            pdata, stride, cap, counts, ts, tw, alpha_threshold, max_alpha, eps,
            out, nullptr, nullptr, nch);
    }
}

template <Variant V>
void launch_probe(int cp, const float* pdata, int n_tiles, int cap, const int* counts,
                  int ts, int tw, float alpha_threshold, float max_alpha, float eps,
                  float* out, int chunk, cudaStream_t stream) {
    const int64_t stride = static_cast<int64_t>(n_tiles) * cap;
#define MS_PROBE_CASE(C)                                                              \
    case C:                                                                           \
        raster_probe_kernel<C, V><<<n_tiles, ts * ts, 0, stream>>>(                   \
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
// a render that needs no gradient.
extern "C" int raster_fwd_launch(const void* pdata, int rows, int n_tiles,
                                 int cap, const void* counts, int ts, int tw,
                                 float alpha_threshold, float max_alpha,
                                 float eps, void* out, void* tchunk,
                                 void* stop, void* stream) {
    if (n_tiles <= 0) return 0;
    if (ts <= 0 || ts * ts > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const auto* pd = static_cast<const float*>(pdata);
    const auto* ct = static_cast<const int*>(counts);
    auto* o = static_cast<float*>(out);
    auto* tc = static_cast<float*>(tchunk);
    auto* st = static_cast<int*>(stop);
    if ((tc == nullptr) != (st == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    switch (rows - 6) {
        case 4: launch<4>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, s); break;
        case 5: launch<5>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, s); break;
        case 6: launch<6>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, s); break;
        case 7: launch<7>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, s); break;
        case 8: launch<8>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, s); break;
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
