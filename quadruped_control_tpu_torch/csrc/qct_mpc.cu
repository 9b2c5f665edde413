// K6: the receding-horizon SRB-MPC solve — one launch per MPC tick (and one
// per solve through the commander's unpacked entry).
//
// Replaces quadruped_control_tpu/mpc/pallas_riccati.py::_mpc_kernel, at both
// of its launch sites (solve_mpc_qp_riccati, the unpacked entry, and
// solve_mpc_qp_riccati_packed, the fused tick's); the per-instance body is
// mpc_instance in qct_mpc.cuh. One compiled kernel serves both entries and
// every configuration: N, dt, the iteration count, sigma_c, tau, tol, alpha
// and the 13 state weights are runtime arguments, the robot constants come
// from the argument struct or per instance.
//
// What bounds it on this card: OPERATIONS, and in practice their latency.
// An instance reads 25 + 17 N words (+ 64 N warm) and writes 12 N + 6 (+ 60 N
// warm), and between them runs ~1.5e4 float32 operations per horizon step
// and IPM iteration (the Riccati sweep: P B, the 12x12 LDL^T, 13 gain
// columns, the P update), ~1e6 for N = 8 and 8 iterations, as one dependent
// chain per thread. What the design does about it: one instance per thread,
// structure-of-arrays inputs and scratch (coalesced), the 13x13 sweep
// matrices in per-thread local memory, the horizon arrays and the gains in a
// (324 N, B) global scratch the wrapper allocates (no DMA to stage: the TPU
// kernel streamed its gains through HBM by hand because VMEM could not hold
// them), no padding to a tile. Not done: several threads per instance (the
// 13 gain columns and the rows of P are independent), P in shared memory.
#include "qct_launch.cuh"
#include "qct_mpc.cuh"

__global__ void qct_mpc_riccati_kernel(QctMpcIO io, int B, QctMpcParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  mpc_instance(io, B, i, p);
}

extern "C" int qct_mpc_riccati(const float* block, const float* yaw,
                               const float* phys, const float* warm_F,
                               const float* warm_sz, const float* warm_sched,
                               float* F, float* diag, float* warm_out,
                               float* scratch, int B,
                               const QctMpcParams* params, void* stream) {
  if (B <= 0) return 0;
  QctMpcIO io = {block, yaw,  phys, warm_F,   warm_sz,
                 warm_sched, F, diag, warm_out, scratch};
  const int block_size = qct_block_size(B);
  qct_mpc_riccati_kernel<<<(B + block_size - 1) / block_size, block_size, 0,
                           (cudaStream_t)stream>>>(io, B, *params);
  return (int)cudaGetLastError();
}
