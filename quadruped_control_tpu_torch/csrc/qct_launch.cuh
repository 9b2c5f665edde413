// Host-side launch helpers shared by the kernels' C entries.
#pragma once

#include <cuda_runtime.h>

#include "qct_common.cuh"

// One QP per thread. 64 threads a block keeps the per-thread local arrays
// (up to ~10 KB with the polish scratch) within reach of L1, and small
// batches (the compacted tail slices) drop to one warp a block so that they
// spread over more SMs.
static inline int qct_block_size(int B) { return B >= 132 * 64 ? 64 : 32; }
