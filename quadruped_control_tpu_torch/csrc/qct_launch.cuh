// Host-side launch helpers shared by the kernels' C entries.
#pragma once

#include <cuda_runtime.h>

#include "qct_common.cuh"

// One instance per thread (K2, and the serial reference entries of K4 and
// K5). 64
// threads a block keeps the per-thread local arrays within reach of L1, and
// small batches drop to one warp a block so that they spread over more SMs.
static inline int qct_block_size(int B) { return B >= 132 * 64 ? 64 : 32; }

// Lets a kernel take more than 48 KB of dynamic shared memory a block.
static inline cudaError_t qct_allow_shared(const void* fn, int shared_bytes) {
  if (shared_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              shared_bytes);
}
