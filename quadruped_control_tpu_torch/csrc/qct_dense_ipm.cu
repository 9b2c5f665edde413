// K3a (dense barrier) and K3b (dense certified polish): the dense batched
// QP solve, two launches per solve.
//
// Replaces quadruped_control_tpu/solver/pallas_ipm.py::_kernel and
// ::_polish_kernel, both launched by solve_qp_ipm_pallas (the split
// pipeline's dense solve, and each restart of the xla proximal stage of
// solve_balance_qp_fused). The bodies are dense_barrier_instance and
// dense_polish_lanes in qct_dense_ipm.cuh; K3a's iteration count and tau
// are runtime arguments.
//
// What bounds them on this card: OPERATIONS, and in practice their latency.
// An instance reads 468 words of problem data (60 more for the polish) and
// writes 60 (61), and between them K3a runs ~1.3e4 float32 operations per
// iteration (the dense G^T D G alone is 78 x 24 x 3) and K3b ~6e4 per sweep
// (the 36 x 36 LDL^T, five triangular solves, the compensated residual),
// in chains that are sequential along the factorizations' pivots and the
// triangular solves, with no tensor-core work in them.
//
// K3a: one instance per thread, so that no instruction waits on another
// thread; structure-of-arrays inputs so every access of a warp is one
// 128-byte line; Q and G read from device memory at each use (the live set
// of a thread is far above 255 registers; L1 / L2 serve the re-reads).
//
// K3b: a group of QF_G = 16 lanes per QP (two QPs per warp), each lane
// owning rows of the LDL^T's trailing triangle (right-looking in shared
// memory, one sync a pivot, qct_lanes.cuh as K1), of the forward solve, of
// the refinement and compensated residuals and of the slacks, so that a
// QP's chain is that of one row, not of the whole factor; a warp waits for
// the slower of its 2 QPs, not of 32. Each QP's problem, point and factor
// live in shared memory (QDShared, 1392 words = 5,568 bytes per QP). A
// block is one warp (11,136 bytes): the QPs need from 1 to 8 sweeps, and a
// block holds its shared memory until its slowest QP is done, so the
// smallest block frees it soonest and 19 blocks (38 QPs) fit an SM at 64
// registers (blocks of 2 and 4 warps are slower: PERF.md, measured by
// scripts/torch_dense_polish_blocks.py). The block first stages its QPs'
// problems and points into shared memory and writes its outputs from
// there. The launch geometry comes from kernels.dense_launch_geometry, made
// from the build's layout (qct_dense_polish_layout).
#include "qct_dense_ipm.cuh"
#include "qct_launch.cuh"

__global__ void qct_dense_barrier_kernel(QctDenseIO io, int B, int iterations,
                                         float tau) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  dense_barrier_instance(io, B, i, iterations, tau);
}

__global__ void __launch_bounds__(QD_MAX_THREADS, QD_MIN_BLOCKS)
    qct_dense_polish_kernel(QctDenseIO io, int B) {
  extern __shared__ float4 qd_shared[];  // 16-byte aligned
  QDShared* W = reinterpret_cast<QDShared*>(qd_shared);
  const int nq = blockDim.x / QF_G;
  const int slot0 = blockIdx.x * nq;
  qd_stage_in(io, B, slot0, nq, W, threadIdx.x, blockDim.x);
  __syncthreads();
  QFLane g;
  g.lane = threadIdx.x % QF_G;
  dense_polish_lanes(W[threadIdx.x / QF_G], g);
  __syncthreads();
  qd_stage_out(io, B, slot0, nq, W, threadIdx.x, blockDim.x);
}

extern "C" const void* qct_dense_polish_fn() {
  return (const void*)qct_dense_polish_kernel;
}

extern "C" int qct_dense_barrier(const float* Q, const float* c,
                                 const float* G, const float* h, float* x,
                                 float* s, float* z, int B, int iterations,
                                 float tau, void* stream) {
  if (B <= 0) return 0;
  QctDenseIO io = {Q, c, G, h, nullptr, nullptr, nullptr, x, s, z, nullptr};
  const int block = qct_block_size(B);
  qct_dense_barrier_kernel<<<(B + block - 1) / block, block, 0,
                             (cudaStream_t)stream>>>(io, B, iterations, tau);
  return (int)cudaGetLastError();
}

extern "C" int qct_dense_polish(const float* Q, const float* c,
                                const float* G, const float* h,
                                const float* x_in, const float* s_in,
                                const float* z_in, float* x, float* s, float* z,
                                float* cert, int B, int blocks, int threads,
                                int shared_bytes, void* stream) {
  if (B <= 0) return 0;
  const int qps = threads / QF_G;
  if (threads <= 0 || threads % 32 != 0 || threads > QD_MAX_THREADS ||
      shared_bytes < qps * (int)sizeof(QDShared) ||
      (long long)blocks * qps < (long long)B)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = qct_allow_shared(qct_dense_polish_fn(), shared_bytes);
  if (e != cudaSuccess) return (int)e;
  QctDenseIO io = {Q, c, G, h, x_in, s_in, z_in, x, s, z, cert};
  qct_dense_polish_kernel<<<blocks, threads, shared_bytes,
                            (cudaStream_t)stream>>>(io, B);
  return (int)cudaGetLastError();
}

// out = [lanes per QP, threads a block at most, shared words per QP] of this
// build: what kernels.dense_launch_geometry makes K3b's launch from.
extern "C" int qct_dense_polish_layout(int* out) {
  qd_layout(out);
  return 0;
}
