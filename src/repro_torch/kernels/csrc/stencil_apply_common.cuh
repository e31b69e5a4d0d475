// Shared helpers for the generated kernels: stencil.apply (K1) and
// stencil.fused_epoch (K2).
//
// kernels/stencil_apply.py emits one .cu file per apply and shape, and
// kernels/epoch_kernel.py one per fused epoch and tile; each includes
// this header.  A generated file holds one __global__ kernel (K1: one
// thread per result point, flat 1-D grid, 64-bit index; K2: one CTA per
// tile) and one launcher with a plain C ABI that the Python wrapper calls
// through ctypes.  The launcher never synchronises: it enqueues on the stream it
// is given and returns cudaGetLastError(), which the wrapper turns into
// an exception when it is not cudaSuccess.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define K1_EXPORT extern "C" __attribute__((visibility("default")))

namespace k1 {

constexpr int kBlock = 256;

// Flat index of this thread's result point.  64-bit: a 1024^3 operand with
// its halo has more than 2^30 elements, and offsets are formed from it.
__device__ __forceinline__ int64_t flat_index() {
  return static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
}

// Blocks of a 1-D grid over n points, or 0 when n does not fit in one grid
// (the launcher then reports cudaErrorInvalidValue).
inline unsigned int blocks_for(int64_t n) {
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  return blocks > 0x7fffffffLL ? 0u : static_cast<unsigned int>(blocks);
}

// What a launcher returns: 0 on success, else the CUDA error code.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace k1
