// Shared definitions of the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// barbell_tpu_torch/_build.py): device pointers and the CUDA stream come
// in as void*/typed pointers, the launch goes on the caller's stream, and
// the function returns cudaGetLastError() so a refused launch raises in
// the Python wrapper instead of vanishing.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bb {

// Key sentinel shared with the JAX package (barbell_tpu.ops.device.BIG).
constexpr int BIGK = 1 << 30;
// Valley slots per row / lane (pallas_myers.TOPK, pallas_window.VTOPK).
constexpr int TOPK = 8;

// Keep the TOPK smallest keys in ascending order (the insertion chain of
// the Pallas kernels: slots stay sorted, the largest spills out).
__device__ __forceinline__ void topk_insert(int (&tk)[TOPK], int x) {
#pragma unroll
    for (int s = 0; s < TOPK; ++s) {
        int cur = tk[s];
        tk[s] = min(x, cur);
        x = max(x, cur);
    }
}

}  // namespace bb
