// K4: the commander tick's pre-QP stage — one launch per control tick.
//
// Replaces quadruped_control_tpu/control/pallas_commander.py::_pre_kernel
// (launched there by commander_pre_pallas_packed); the per-instance body is
// commander_instance in qct_commander.cuh.
//
// With mpc_horizon = N > 0 it also writes the MPC precursor block (25 + 17 N
// words per instance) that the MPC kernel (qct_mpc.cu) consumes.
//
// What bounds it on this card: BYTES on paper (143 words in, 144 out per
// instance against ~2.5e3 float32 operations, ~60 of them sinf/cosf/atan2f
// calls), and in practice the latency of one dependent chain per thread at
// the closed-loop batch sizes (4096 instances are 128 warps on 132 SMs).
// What the design does about it: one instance per thread, structure-of-
// arrays tensors so every load and store of a warp is one coalesced line,
// the 84 trajectory coefficients streamed through one leg at a time (21 live
// values, not 84), all constants in one by-value struct in constant memory,
// and contact_gate / raibert_cmd_symmetric as branches that are uniform
// across the grid. Not done: more than one thread per instance (the four
// legs are independent after step 5).
#include "qct_commander.cuh"
#include "qct_launch.cuh"

__global__ void qct_commander_pre_kernel(QctCmdIO io, int B, QctCmdParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  commander_instance(io, B, i, p);
}

extern "C" int qct_commander_pre(const float* state, const float* carry,
                                 const float* cmd, float* r, float* b,
                                 float* st, float* mu, float* fzmin,
                                 float* fzmax, float* tau_swing,
                                 float* carry_out, float* q_ref, float* mpc,
                                 int B,
                                 const QctCmdParams* params, void* stream) {
  if (B <= 0) return 0;
  QctCmdIO io = {state, carry,     cmd,   r,  b,  st,  mu,
                 fzmin, fzmax, tau_swing, carry_out, q_ref, mpc};
  const int block = qct_block_size(B);
  qct_commander_pre_kernel<<<(B + block - 1) / block, block, 0,
                             (cudaStream_t)stream>>>(io, B, *params);
  return (int)cudaGetLastError();
}
