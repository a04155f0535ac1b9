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

#include "common.cuh"

namespace {

constexpr int kBatch = 256;  // slots staged in shared memory per step

template <int CP>
__global__ void __launch_bounds__(1024)
raster_fwd_kernel(const float* __restrict__ pdata, int64_t stride, int cap,
                  const int* __restrict__ counts, int ts, int tw,
                  float alpha_threshold, float max_alpha, float eps,
                  float* __restrict__ out) {
    constexpr int kRows = 6 + CP;
    __shared__ float slots[kRows * kBatch];

    const int t = blockIdx.x;
    const int p = threadIdx.x;
    const int P = blockDim.x;
    const int count = min(max(counts[t], 0), cap);  // never past the tile
    const int tile_y = t / tw;
    const int tile_x = t - tile_y * tw;
    const float px = static_cast<float>(tile_x * ts + p % ts) + 0.5f;
    const float py = static_cast<float>(tile_y * ts + p / ts) + 0.5f;

    float T = 1.0f;
    bool done = false;
    float acc[CP];
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[c] = 0.0f;

    const float* tile = pdata + static_cast<int64_t>(t) * cap;
    for (int b0 = 0; b0 < count; b0 += kBatch) {
        const int n = min(kBatch, count - b0);
        for (int i = p; i < kRows * n; i += P) {
            const int r = i / n;
            const int j = i - r * n;
            slots[r * kBatch + j] = __ldg(tile + r * stride + b0 + j);
        }
        __syncthreads();
        if (!done) {
            for (int j = 0; j < n; ++j) {
                const float dx = slots[0 * kBatch + j] - px;
                const float dy = slots[1 * kBatch + j] - py;
                const float ca = slots[2 * kBatch + j];
                const float cb = slots[3 * kBatch + j];
                const float cc = slots[4 * kBatch + j];
                const float op = slots[5 * kBatch + j];
                const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
                const float raw = op * expf(-sigma);
                // Written so that a NaN sigma or alpha is skipped, as the
                // reference's select does.
                const float alpha = raw > max_alpha ? max_alpha : raw;
                if (!(sigma >= 0.0f) || !(alpha >= alpha_threshold)) continue;
                const float next_T = T * (1.0f - alpha);
                if (next_T <= eps) {
                    done = true;
                    break;
                }
                const float w = alpha * T;
#pragma unroll
                for (int c = 0; c < CP; ++c) acc[c] += w * slots[(6 + c) * kBatch + j];
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
}

template <int CP>
void launch(const float* pdata, int n_tiles, int cap, const int* counts,
            int ts, int tw, float alpha_threshold, float max_alpha, float eps,
            float* out, cudaStream_t stream) {
    raster_fwd_kernel<CP><<<n_tiles, ts * ts, 0, stream>>>(
        pdata, static_cast<int64_t>(n_tiles) * cap, cap, counts, ts, tw,
        alpha_threshold, max_alpha, eps, out);
}

}  // namespace

// pdata: (rows, n_tiles * cap) f32 with rows = 6 + cp, 4 <= cp <= 8;
// counts: (n_tiles,) int32 <= cap; out: (n_tiles, cp + 1, ts * ts) f32.
extern "C" int raster_fwd_launch(const void* pdata, int rows, int n_tiles,
                                 int cap, const void* counts, int ts, int tw,
                                 float alpha_threshold, float max_alpha,
                                 float eps, void* out, void* stream) {
    if (n_tiles <= 0) return 0;
    if (ts <= 0 || ts * ts > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const auto* pd = static_cast<const float*>(pdata);
    const auto* ct = static_cast<const int*>(counts);
    auto* o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (rows - 6) {
        case 4: launch<4>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, s); break;
        case 5: launch<5>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, s); break;
        case 6: launch<6>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, s); break;
        case 7: launch<7>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, s); break;
        case 8: launch<8>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    MS_RETURN_LAUNCH_STATUS();
}
