// Shared helpers for the kernel library's plain C entry points.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Each entry point launches on the caller's stream and reports the launch
// status; the Python wrapper raises on a nonzero code.
#define MS_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())

static inline unsigned ms_blocks(int64_t n, int threads) {
    return static_cast<unsigned>((n + threads - 1) / threads);
}
