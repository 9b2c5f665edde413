// K1: the fused GRF-QP solve — assembly, equilibration, Mehrotra barrier,
// certified active-set polish, proximal restarts, map-back — one launch.
//
// Replaces quadruped_control_tpu/solver/pallas_fused.py::_fused_kernel
// (launched there by solve_grf_qp_fused_packed) in every mode: full,
// barrier-only (qct_fused_barrier.cu, the variant without the scratch),
// polish-only, warm-started barrier, proximal restarts, ff_refine,
// polish_multi_swap. Schedules are RUNTIME arguments (QctParams): one
// compiled kernel serves the four schedules of the two-phase path.
//
// What bounds it on this card: OPERATIONS, and in practice their latency.
// An instance reads 26 words and writes 66; between them it runs ~3e3
// float32 operations per barrier iteration and ~4e4 per polish sweep (the
// 36x36 LDL^T is ~1.6e4 multiply-subtracts), all in one dependent chain per
// thread with no tensor-core work in it. What the design does about it: one
// instance per thread so that no instruction waits on another thread;
// structure-of-arrays inputs so the few global accesses coalesce; the
// polish scratch (666 + 36 + 36 words) in PER-THREAD LOCAL arrays, which
// the hardware interleaves by thread (coalesced, L1-resident for a 64-thread
// block) at the cost of ~10 KB of local memory a thread and low occupancy;
// certified lanes leave the sweep loop early. Not done yet (later work): FMA
// outside the compensated code (the library is built with -fmad=false so
// that it follows the plain PyTorch version operation for operation),
// register-resident unrolled Cholesky, more than one thread per instance.
#include "qct_launch.cuh"

__global__ void qct_fused_polish_kernel(QctIO io, int B, QctParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  fused_instance<true>(io, B, i, p);
}

extern "C" int qct_fused_barrier_launch(QctIO io, int B, const QctParams* p,
                                        void* stream);

extern "C" int qct_fused_solve(const float* r, const float* b,
                               const float* st, const float* mu,
                               const float* fzmin, const float* fzmax,
                               const float* xw, const float* sw,
                               const float* zw, const float* stprev, float* x,
                               float* s, float* z, float* diag, int* work,
                               int B, const QctParams* params, void* stream) {
  if (B <= 0) return 0;
  QctIO io = {r, b, st, mu, fzmin, fzmax, xw, sw, zw, stprev, x, s, z, diag,
              work};
  if (!params->polish) return qct_fused_barrier_launch(io, B, params, stream);
  const int block = qct_block_size(B);
  qct_fused_polish_kernel<<<(B + block - 1) / block, block, 0,
                            (cudaStream_t)stream>>>(io, B, *params);
  return (int)cudaGetLastError();
}
