// K3a (dense barrier) and K3b (dense certified polish): the dense batched
// QP solve, two launches per solve.
//
// Replaces quadruped_control_tpu/solver/pallas_ipm.py::_kernel and
// ::_polish_kernel, both launched by solve_qp_ipm_pallas (the split
// pipeline's dense solve, and each restart of the xla proximal stage of
// solve_balance_qp_fused). The per-instance bodies are
// dense_barrier_instance and dense_polish_instance in qct_dense_ipm.cuh;
// the iteration count and tau are runtime arguments.
//
// What bounds them on this card: OPERATIONS, and in practice their latency.
// An instance reads 468 words of problem data (60 more for the polish) and
// writes 60 (61), and between them K3a runs ~1.3e4 float32 operations per
// iteration (the dense G^T D G alone is 78 x 24 x 3) and K3b ~6e4 per sweep
// (the 36 x 36 LDL^T, five triangular solves, the compensated residual), as
// one dependent chain per thread with no tensor-core work in it. What the
// design does about it: one instance per thread so that no instruction
// waits on another thread; structure-of-arrays inputs so every access of a
// warp is one 128-byte line; Q and G read from device memory at each use
// (the live set of a thread, 468 problem words + M + L + the iterates, is
// far above 255 registers; L1 / L2 serve the re-reads); K3b's packed KKT
// scratch (666 + 36 + 36 words) in per-thread local memory, which the
// hardware interleaves by thread; certified lanes leave the sweep loop
// early. Not done yet (later work): several threads per instance, the M and
// L triangles in shared memory, FMA outside the compensated code.
#include "qct_dense_ipm.cuh"
#include "qct_launch.cuh"

__global__ void qct_dense_barrier_kernel(QctDenseIO io, int B, int iterations,
                                         float tau) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  dense_barrier_instance(io, B, i, iterations, tau);
}

__global__ void qct_dense_polish_kernel(QctDenseIO io, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  float K[QTRI], D[QNK], u[QNK];
  dense_polish_instance(io, B, i, K, D, u);
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
                                float* cert, int B, void* stream) {
  if (B <= 0) return 0;
  QctDenseIO io = {Q, c, G, h, x_in, s_in, z_in, x, s, z, cert};
  const int block = qct_block_size(B);
  qct_dense_polish_kernel<<<(B + block - 1) / block, block, 0,
                            (cudaStream_t)stream>>>(io, B);
  return (int)cudaGetLastError();
}
