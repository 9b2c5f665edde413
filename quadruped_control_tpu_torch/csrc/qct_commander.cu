// K4: the commander tick's pre-QP stage — one launch per control tick.
//
// Replaces quadruped_control_tpu/control/pallas_commander.py::_pre_kernel
// (launched there by commander_pre_pallas_packed); the bodies are in
// qct_commander.cuh.
//
// With mpc_horizon = N > 0 it also writes the MPC precursor block (25 + 17 N
// words per instance) that the MPC kernel (qct_mpc.cu) consumes.
//
// What bounds it on this card: BYTES on paper (143 words in, 144 out per
// instance against ~3.4e3 float32 operations, ~60 of them sinf/cosf/atan2f
// calls), and in practice the latency of the dependent chain: at the
// closed-loop batch (4096 instances) one instance per thread is 128 warps on
// 132 SMs, one warp an SM with nothing to hide its latency.
// What the design does about it: a group of QC_G lanes per instance
// (commander_lanes), one leg a lane: a lane's chain is the leg-independent
// prefix, one leg's steps and its share of the suffix, and the grid has
// QC_G times the warps. No shared memory, no shuffle, no sync (a lane
// computes the prefix itself rather than wait for it). Structure-of-arrays
// tensors, so a warp's loads and stores of a row are a few consecutive
// sectors; the 21 trajectory coefficients of a leg stream through its lane;
// the constants in one by-value __grid_constant__ struct, a leg's read by
// selects on uniform loads (qc_pick4); contact_gate and
// raibert_cmd_symmetric as branches that are uniform across the grid; the
// IK's branch on the leg a select (qc_ik_sel). The launch geometry comes
// from kernels.commander_geometry, made from the build's layout
// (qct_commander_layout). -fmad=false and the CUDA library's
// sinf/cosf/atan2f, as everywhere in the library.
//
// qct_commander_serial launches the serial body (one instance per thread,
// the kernel's first form) only for chip_smoke.py's bitwise hold; nothing on
// the port's paths calls it.
#include "qct_commander.cuh"
#include "qct_launch.cuh"

__global__ void __launch_bounds__(QC_THREADS)
    qct_commander_pre_kernel(QctCmdIO io, int B,
                             const __grid_constant__ QctCmdParams p) {
  int slot, lane;
  qc_slot(blockIdx.x, threadIdx.x, slot, lane);
  if (slot >= B) return;  // ragged edge (no sync follows)
  commander_lanes(io, B, slot, p, lane);
}

__global__ void qct_commander_serial_kernel(QctCmdIO io, int B,
                                            QctCmdParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  commander_instance_serial(io, B, i, p);
}

extern "C" const void* qct_commander_fn() {
  return (const void*)qct_commander_pre_kernel;
}

extern "C" const void* qct_commander_serial_fn() {
  return (const void*)qct_commander_serial_kernel;
}

extern "C" int qct_commander_pre(const float* state, const float* carry,
                                 const float* cmd, float* r, float* b,
                                 float* st, float* mu, float* fzmin,
                                 float* fzmax, float* tau_swing,
                                 float* carry_out, float* q_ref, float* mpc,
                                 int B, const QctCmdParams* params,
                                 int blocks, int threads, void* stream) {
  if (B <= 0) return 0;
  if (threads != QC_THREADS ||
      (long long)blocks * (threads / QC_G) < (long long)B)
    return (int)cudaErrorInvalidValue;
  QctCmdIO io = {state, carry,     cmd,   r,  b,  st,  mu,
                 fzmin, fzmax, tau_swing, carry_out, q_ref, mpc};
  qct_commander_pre_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      io, B, *params);
  return (int)cudaGetLastError();
}

extern "C" int qct_commander_serial(const float* state, const float* carry,
                                    const float* cmd, float* r, float* b,
                                    float* st, float* mu, float* fzmin,
                                    float* fzmax, float* tau_swing,
                                    float* carry_out, float* q_ref,
                                    float* mpc, int B,
                                    const QctCmdParams* params,
                                    void* stream) {
  if (B <= 0) return 0;
  QctCmdIO io = {state, carry,     cmd,   r,  b,  st,  mu,
                 fzmin, fzmax, tau_swing, carry_out, q_ref, mpc};
  const int block = qct_block_size(B);
  qct_commander_serial_kernel<<<(B + block - 1) / block, block, 0,
                                (cudaStream_t)stream>>>(io, B, *params);
  return (int)cudaGetLastError();
}

// Threads a block of the serial body's launch for B instances.
extern "C" int qct_commander_serial_block(int B) { return qct_block_size(B); }

// out = [lanes per instance, threads a block] of this build:
// what kernels.commander_geometry makes K4's launch from.
extern "C" int qct_commander_layout(int* out) {
  qc_layout(out);
  return 0;
}

#ifdef QCT_CLOCKS
extern "C" int qct_commander_clocks(unsigned long long* out) {
  return qct_clocks_read(out);
}
#endif
