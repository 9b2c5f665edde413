// Host build of the per-instance bodies of the commander-pre and substep
// CUDA kernels (quadruped_control_tpu_torch/csrc/qct_commander.cuh and
// qct_substep.cuh), looped over the batch by a plain C++ compiler
// (-ffp-contract=off), so that the kernels' arithmetic can be held against
// the plain PyTorch versions on a machine without a CUDA compiler
// (tests/test_torch_kernel_sources_host.py).
#include "qct_commander.cuh"
#include "qct_substep.cuh"

extern "C" void host_commander_pre(const float* state, const float* carry,
                                   const float* cmd, float* r, float* b,
                                   float* st, float* mu, float* fzmin,
                                   float* fzmax, float* tau_swing,
                                   float* carry_out, float* q_ref, int B,
                                   const QctCmdParams* params) {
  QctCmdIO io = {state, carry, cmd,       r,         b,    st,
                 mu,    fzmin, fzmax, tau_swing, carry_out, q_ref};
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
