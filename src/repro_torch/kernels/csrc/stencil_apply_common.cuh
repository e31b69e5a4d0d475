// Shared helpers for the generated kernels: stencil.apply (K1) and
// stencil.fused_epoch (K2).
//
// kernels/stencil_apply.py emits one .cu file per apply and shape, and
// kernels/epoch_kernel.py one per fused epoch and tile; each includes
// this header.  A generated file holds one __global__ kernel on a 1-D grid
// (K1: a CTA streams a tile of the minor dims along dim 0 through a
// shared-memory ring; K2: one CTA per tile of the epoch's core, one CTA
// streaming a minor tile's planes through rings of shared memory, or a
// CTA's loop over tiles with a device-memory scratch of its own), a
// launcher and an occupancy query, both with a plain C ABI that the Python
// wrapper calls through ctypes.  The launcher never synchronises: it
// enqueues on the stream it is given and returns cudaGetLastError(), which
// the wrapper turns into an exception when it is not cudaSuccess.
//
// Everything a generated file needs from CUDA beyond arithmetic goes
// through the macros below (threads per CTA, dynamic shared memory, the
// asynchronous copies, the launch), so that a header of the same name can
// stand in for this one and run the same source on a host, one thread per
// CTA, for testing.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define K1_EXPORT extern "C" __attribute__((visibility("default")))

// Threads per CTA; a host stand-in runs one.
#define K1_BLOCK_THREADS(n) (n)

// The CTA's dynamic shared memory as a float pointer, 16-byte aligned.
#define K1_DYNAMIC_SMEM(name) \
  extern __shared__ __align__(16) float k1_dynamic_smem_[]; \
  float* const name = k1_dynamic_smem_

// Asynchronous global -> shared copies of 16, 8 or 4 bytes (cp.async: the
// copy bypasses registers and runs while the CTA computes).  The 16-byte
// form skips L1 (.cg), as a copy that is read once from shared memory
// should.  A group of copies is closed by K1_CP_ASYNC_COMMIT; after
// K1_CP_ASYNC_WAIT(n) at most n groups of this thread are still in flight.
// Other threads' copies are visible after the next __syncthreads().
#define K1_CP_ASYNC(dst, src, bytes) k1::cp_async<bytes>(dst, src)
#define K1_CP_ASYNC_COMMIT() asm volatile("cp.async.commit_group;\n" ::: "memory")
#define K1_CP_ASYNC_WAIT(n) asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory")

// At the start of each tile a CTA of a K2 scratch plan takes (its CTAs
// loop over the tiles; ``scratch`` is the CTA's device-memory scratch of
// ``floats`` floats): nothing here.  A host stand-in poisons the CTA's
// scratch and shared memory, so that a point a tile reads before writing
// it cannot pass for the previous tile's value.
#define K1_SCRATCH_TILE(scratch, floats) ((void)0)

// A value each thread keeps from one iteration of a K2 streaming plan to
// the next (a register queue along dim 0), and this thread's copy of it
// (``item``: the thread's work item).  A host stand-in that runs one
// thread for the whole CTA keeps one copy per work item.
#define K1_PER_THREAD(name, items) float name = 0.0f
#define K1_MINE(name, item) name

// Launch ``kernel`` on a 1-D grid; opt in to more than 48 KB of dynamic
// shared memory; CTAs of ``kernel`` that fit on one SM at once.
#define K1_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), static_cast<cudaStream_t>(stream)>>>(__VA_ARGS__)
#define K1_OPT_IN_SMEM(kernel, bytes) \
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (bytes))
#define K1_OCCUPANCY(blocks, kernel, threads, smem) \
  cudaOccupancyMaxActiveBlocksPerMultiprocessor((blocks), kernel, (threads), (smem))

namespace k1 {

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16, "cp.async moves 4, 8 or 16 bytes");
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(kBytes)
                 : "memory");
  }
}

// What a launcher returns: 0 on success, else the CUDA error code.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace k1
