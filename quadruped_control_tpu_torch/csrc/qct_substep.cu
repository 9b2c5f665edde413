// K5: N physics substeps of the whole-body plant — one launch per control
// tick.
//
// Replaces the kernel of
// quadruped_control_tpu/sim/pallas_substep.py::make_pallas_stepper (entry
// _kern_entry_qp / kernel); the per-instance body is substep_instance in
// qct_substep.cuh.
//
// What bounds it on this card: OPERATIONS, and in practice their latency.
// An instance reads 86 words (58 state + 12 + 12 + 4) and writes 58; between
// them it runs ~7e3 float32 operations for the factor and ~4.5e3 per substep
// (24 sinf/cosf, four 3-joint RNEA sweeps, 8 contact points, the Schur
// solve), one dependent chain per thread. What the design does about it: one
// robot per thread, structure-of-arrays tensors (coalesced), the state read
// once and written once however many substeps run, the 216-word factor built
// once and held in per-thread local memory (hardware-interleaved, L1-
// resident for a small block), the model in one by-value struct in constant
// memory so that one compiled kernel serves every model and contact
// configuration, n_substeps and h as runtime arguments. Not done: a
// shared-memory factor, FMA (the library is built with -fmad=false), more
// than one thread per robot (the four legs' RNEA sweeps are independent).
#include "qct_substep.cuh"
#include "qct_launch.cuh"

__global__ void qct_substep_kernel(QctSubIO io, int B, int n_substeps,
                                   float h, QctSubParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  substep_instance(io, B, i, n_substeps, h, p);
}

extern "C" int qct_substep(const float* state, const float* a,
                           const float* tau_sw, const float* st,
                           const float* factor, float* out, int B,
                           int n_substeps, float h,
                           const QctSubParams* params, void* stream) {
  if (B <= 0) return 0;
  QctSubIO io = {state, a, tau_sw, st, factor, out};
  const int block = qct_block_size(B);
  qct_substep_kernel<<<(B + block - 1) / block, block, 0,
                       (cudaStream_t)stream>>>(io, B, n_substeps, h, *params);
  return (int)cudaGetLastError();
}
