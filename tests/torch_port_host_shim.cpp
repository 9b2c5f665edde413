// Host build of the per-instance bodies of the commander-pre, substep, MPC
// and dense IPM CUDA kernels (quadruped_control_tpu_torch/csrc/
// qct_commander.cuh, qct_substep.cuh, qct_mpc.cuh and qct_dense_ipm.cuh),
// looped over the batch by a plain C++
// compiler (-ffp-contract=off), so that the kernels' arithmetic can be held
// against the plain PyTorch versions on a machine without a CUDA compiler
// (tests/test_torch_kernel_sources_host.py).
#include "qct_commander.cuh"
#include "qct_dense_ipm.cuh"
#include "qct_mpc.cuh"
#include "qct_substep.cuh"

extern "C" void host_commander_pre(const float* state, const float* carry,
                                   const float* cmd, float* r, float* b,
                                   float* st, float* mu, float* fzmin,
                                   float* fzmax, float* tau_swing,
                                   float* carry_out, float* q_ref, float* mpc,
                                   int B, const QctCmdParams* params) {
  QctCmdIO io = {state, carry,     cmd,   r,  b,  st,  mu,
                 fzmin, fzmax, tau_swing, carry_out, q_ref, mpc};
  for (int i = 0; i < B; ++i) commander_instance(io, B, i, *params);
}

extern "C" void host_substep(const float* state, const float* a,
                             const float* tau_sw, const float* st,
                             const float* factor, float* out, int B,
                             int n_substeps, float h,
                             const QctSubParams* params) {
  QctSubIO io = {state, a, tau_sw, st, factor, out};
  for (int i = 0; i < B; ++i)
    substep_instance(io, B, i, n_substeps, h, *params);
}

extern "C" void host_mpc_riccati(const float* block, const float* yaw,
                                 const float* phys, const float* warm_F,
                                 const float* warm_sz,
                                 const float* warm_sched, float* F,
                                 float* diag, float* warm_out, float* scratch,
                                 int B, const QctMpcParams* params) {
  QctMpcIO io = {block, yaw,  phys, warm_F,   warm_sz,
                 warm_sched, F, diag, warm_out, scratch};
  for (int i = 0; i < B; ++i) mpc_instance(io, B, i, *params);
}

extern "C" void host_dense_barrier(const float* Q, const float* c,
                                   const float* G, const float* h, float* x,
                                   float* s, float* z, int B, int iterations,
                                   float tau) {
  QctDenseIO io = {Q, c, G, h, nullptr, nullptr, nullptr, x, s, z, nullptr};
  for (int i = 0; i < B; ++i) dense_barrier_instance(io, B, i, iterations, tau);
}

extern "C" void host_dense_polish(const float* Q, const float* c,
                                  const float* G, const float* h,
                                  const float* x_in, const float* s_in,
                                  const float* z_in, float* x, float* s,
                                  float* z, float* cert, int B) {
  QctDenseIO io = {Q, c, G, h, x_in, s_in, z_in, x, s, z, cert};
  float K[QTRI], D[QNK], u[QNK];
  for (int i = 0; i < B; ++i) dense_polish_instance(io, B, i, K, D, u);
}
