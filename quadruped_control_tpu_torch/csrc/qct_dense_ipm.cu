// K3a (dense barrier) and K3b (dense certified polish): the dense batched
// QP solve, two launches per solve.
//
// Replaces quadruped_control_tpu/solver/pallas_ipm.py::_kernel and
// ::_polish_kernel, both launched by solve_qp_ipm_pallas (the split
// pipeline's dense solve, and each restart of the xla proximal stage of
// solve_balance_qp_fused). The bodies are dense_barrier_lanes and
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
// Both run a group of QF_G = 16 lanes per QP (two QPs per warp), so that a
// QP's chain is that of one row or one entry, not of the whole problem;
// each QP's problem, point and factor live in shared memory and the block
// stages them first (coalesced loads of its QPs' (k, B) words) and writes
// its outputs from there. The launch geometry comes from the build's layout
// (kernels.fused_launch_geometry for K3a, kernels.dense_launch_geometry).
//
// K3a: lanes own cone rows r = lane + 16 m (residuals, d, the directions'
// ds / dz and step ratios), the 78 entries of M = Q + G^T D G (5,616 of an
// iteration's 13,329 operations; five consecutive entries a lane, which lie
// in at most two rows, so that a lane reads d_r and G_ri once a row r for
// its five terms), rows of the 12 x 12 Cholesky (right-looking on
// registers, shuffles, as K1's barrier, each pivot formed by every lane
// from the last one) and rows of the forward triangular solves (faster
// than running them uniform, which also needed 72 B of stack); the backward
// solves and the 24-term sums (mu, mu_aff) are uniform. No QP leaves the fixed iteration loop early, so the warp's
// two QPs never wait for each other. QDBShared is 1072 words (4,288 bytes)
// per QP; a block is four warps (8 QPs, 34,304 bytes), 4 blocks an SM at
// <= 128 registers (128, no stack; blocks of 1 and 2 warps were a little
// slower at B = 32768 and as fast at 1024: PERF.md, measured with
// scripts/torch_dense_barrier_blocks.py).
//
// K3b: a lane owns rows of the LDL^T's trailing triangle (right-looking in
// shared memory, one sync a pivot, qct_lanes.cuh as K1), of the forward
// solve, of the refinement and compensated residuals and of the slacks; a
// warp waits for the slower of its 2 QPs, not of 32. QDShared is 1392 words
// (5,568 bytes) per QP. A block is one warp (11,136 bytes): the QPs need
// from 1 to 8 sweeps, and a block holds its shared memory until its slowest
// QP is done, so the smallest block frees it soonest and 19 blocks (38 QPs)
// fit an SM at 64 registers (blocks of 2 and 4 warps are slower: PERF.md,
// measured by scripts/torch_dense_polish_blocks.py).
#include "qct_dense_ipm.cuh"
#include "qct_launch.cuh"

__global__ void __launch_bounds__(QDB_MAX_THREADS, QDB_MIN_BLOCKS)
    qct_dense_barrier_kernel(QctDenseIO io, int B, int iterations,
                             float tau) {
  extern __shared__ float4 qdb_shared[];  // 16-byte aligned
  QDBShared* W = reinterpret_cast<QDBShared*>(qdb_shared);
  const int nq = blockDim.x / QF_G;
  const int slot0 = blockIdx.x * nq;
  qd_stage_in<QDBShared, QDB_IN>(io, B, slot0, nq, W, threadIdx.x,
                                 blockDim.x);
  __syncthreads();
  QFLane g;
  g.lane = threadIdx.x % QF_G;
  dense_barrier_lanes(W[threadIdx.x / QF_G], iterations, tau, g);
  __syncthreads();
  qd_stage_out<QDBShared, QDB_OUT>(io, B, slot0, nq, W, threadIdx.x,
                                   blockDim.x);
}

extern "C" const void* qct_dense_barrier_fn() {
  return (const void*)qct_dense_barrier_kernel;
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
                                 float tau, int blocks, int threads,
                                 int shared_bytes, void* stream) {
  if (B <= 0) return 0;
  const int qps = threads / QF_G;
  if (threads <= 0 || threads % 32 != 0 || threads > QDB_MAX_THREADS ||
      shared_bytes < qps * (int)sizeof(QDBShared) ||
      (long long)blocks * qps < (long long)B || iterations < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = qct_allow_shared(qct_dense_barrier_fn(), shared_bytes);
  if (e != cudaSuccess) return (int)e;
  QctDenseIO io = {Q, c, G, h, nullptr, nullptr, nullptr, x, s, z, nullptr};
  qct_dense_barrier_kernel<<<blocks, threads, shared_bytes,
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

#ifdef QCT_CLOCKS
extern "C" int qct_dense_barrier_clocks(unsigned long long* out) {
  return qct_clocks_read(out);
}
#endif

// out = [lanes per QP, threads a block at most, shared words per QP] of this
// build: what kernels.fused_launch_geometry makes K3a's launch from.
extern "C" int qct_dense_barrier_layout(int* out) {
  qdb_layout(out);
  return 0;
}
