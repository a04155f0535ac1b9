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
// MXU product through a bf16 split. Here, as in B1 (raster_fwd.cu), one
// block owns one tile and one thread one pixel, and each pixel walks the
// slots in order:
//
//   alpha from ms_surfel_alpha (surfel.cuh); skip the slot unless kept
//   stop before the slot that would take T to <= transmittance_eps
//   w = alpha T;  acc += w * rows 12..;  with the maps m1 += w z, m2 += w z^2
//   T *= 1 - alpha
//
// Batches of slots are staged in shared memory (loaded coalesced along the
// slot axis; every pixel then reads one address, a broadcast). The block
// leaves once every pixel is done.
//
// Bound on the card: per (pixel, slot) pair two exponentials, two
// divisions and about 50 other f32 operations; the slot table is read once
// per tile. __launch_bounds__(1024) caps registers at 64 a thread so a 32x32
// tile fits one block.
//
// The backward's residual, written only when the caller passes its buffers
// (a separate instantiation): each pixel's T at the entry of every
// kResidChunk-slot chunk it reaches alive, and its stop index, exactly as
// B1 writes them (raster_fwd.cu), where the TPU kernel sign-packs the done
// latch into a per-chunk T.

#include "surfel.cuh"

namespace {

constexpr int kBatch = 256;  // slots staged in shared memory per step

template <bool AUX, bool RESID>
__global__ void __launch_bounds__(1024)
surfel_fwd_kernel(const float* __restrict__ pdata, int64_t stride, int cap,
                  const int* __restrict__ counts, int ts, int tw,
                  float alpha_threshold, float max_alpha, float eps,
                  float* __restrict__ out, float* __restrict__ tchunk,
                  int* __restrict__ stop, int nch) {
    constexpr int kRows = AUX ? kSurfelAuxRows : kSurfelRows;
    constexpr int kCh = kRows - 12;  // rows blended as constants
    constexpr int kOut = AUX ? 9 : 5;
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
    int stop_at = count;
    float* tres = RESID ? tchunk + static_cast<int64_t>(t) * nch * P + p : nullptr;
    float acc[kCh];
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[c] = 0.0f;
    float m1 = 0.0f, m2 = 0.0f;

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
                if (RESID && ((b0 + j) % kResidChunk) == 0) {
                    tres[static_cast<int64_t>((b0 + j) / kResidChunk) * P] = T;
                }
                MsSurfel g;
                if (!ms_surfel_alpha(slots + j, kBatch, px, py, alpha_threshold, max_alpha, g)) {
                    continue;
                }
                const float next_T = ms_transmit(T, g.alpha);
                if (next_T <= eps) {
                    done = true;
                    stop_at = b0 + j;
                    break;
                }
                const float w = g.alpha * T;
#pragma unroll
                for (int c = 0; c < kCh; ++c) acc[c] += w * slots[(12 + c) * kBatch + j];
                if (AUX) {
                    const float z = ms_surfel_depth(slots + j, kBatch, g);
                    const float wz = w * z;
                    m1 += wz;
                    m2 += wz * z;
                }
                T = next_T;
            }
        }
        // A barrier too: no thread reloads the batch while another reads it.
        if (__syncthreads_count(done ? 0 : 1) == 0) break;
    }

    float* o = out + static_cast<int64_t>(t) * kOut * P + p;
#pragma unroll
    for (int c = 0; c < kCh; ++c) o[c * P] = acc[c];
    if (AUX) {
        o[kCh * P] = m1;
        o[(kCh + 1) * P] = m2;
    }
    o[(kOut - 1) * P] = T;
    if (RESID) stop[static_cast<int64_t>(t) * P + p] = stop_at;
}

template <bool AUX>
void launch(const float* pdata, int n_tiles, int cap, const int* counts, int ts, int tw,
            float alpha_threshold, float max_alpha, float eps, float* out, float* tchunk,
            int* stop, cudaStream_t stream) {
    const int64_t stride = static_cast<int64_t>(n_tiles) * cap;
    const int nch = (cap + kResidChunk - 1) / kResidChunk;
    if (tchunk != nullptr) {
        surfel_fwd_kernel<AUX, true><<<n_tiles, ts * ts, 0, stream>>>(
            pdata, stride, cap, counts, ts, tw, alpha_threshold, max_alpha, eps, out,
            tchunk, stop, nch);
    } else {
        surfel_fwd_kernel<AUX, false><<<n_tiles, ts * ts, 0, stream>>>(
            pdata, stride, cap, counts, ts, tw, alpha_threshold, max_alpha, eps, out,
            nullptr, nullptr, nch);
    }
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
    if (n_tiles <= 0) return 0;
    if (ts <= 0 || ts * ts > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const auto* pd = static_cast<const float*>(pdata);
    const auto* ct = static_cast<const int*>(counts);
    auto* o = static_cast<float*>(out);
    auto* tc = static_cast<float*>(tchunk);
    auto* st = static_cast<int*>(stop);
    if ((tc == nullptr) != (st == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    switch (rows) {
        case kSurfelRows: launch<false>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, s); break;
        case kSurfelAuxRows: launch<true>(pd, n_tiles, cap, ct, ts, tw, alpha_threshold, max_alpha, eps, o, tc, st, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    MS_RETURN_LAUNCH_STATUS();
}
