// K5: N physics substeps of the whole-body plant — one launch per control
// tick.
//
// Replaces the kernel of
// quadruped_control_tpu/sim/pallas_substep.py::make_pallas_stepper (entry
// _kern_entry_qp / kernel); the bodies are in qct_substep.cuh.
//
// What bounds it on this card: OPERATIONS, and in practice their latency.
// A robot reads 86 words (58 state + 12 + 12 + 4) and writes 58; between
// them it runs ~6e3 float32 operations for the factor and ~5e3 per substep
// (24 sinf/cosf, four 3-joint RNEA sweeps, 8 contact points, the Schur
// solve, the integration and the guard's 58-term sum).
//
// What the design does about it: a group of QS_G lanes per robot
// (substep_lanes), so that a robot's chain per substep is one leg's RNEA
// sweep, one contact point, a row of the solve and the guard's sum, not the
// whole of it, and a warp carries 32 / QS_G robots. The block (128 threads,
// 128 / QS_G robots) first stages its robots' states, torque inputs and,
// when streamed, factors into shared memory with coalesced loads
// (qs_stage_in), and its model parameters too (a leg's or a point's lanes
// index them by the lane); the tick's factor, the state and every partial
// sum stay there for all substeps, and the new states go out from there.
// The model is one by-value __grid_constant__ struct, so that one compiled
// kernel serves every model and contact configuration; n_substeps and h are
// runtime arguments. The launch geometry comes from
// kernels.substep_launch_geometry, made from the build's layout
// (qct_substep_layout). -fmad=false and the CUDA library's sinf/cosf, as
// everywhere in the library.
//
// qct_substep_serial launches the serial body (one robot per thread, the
// kernel's first form) only for chip_smoke.py's bitwise hold; nothing on
// the port's paths calls it.
#include "qct_launch.cuh"
#include "qct_substep.cuh"

__global__ void __launch_bounds__(QS_MAX_THREADS, QS_MIN_BLOCKS)
    qct_substep_kernel(QctSubIO io, int B, int n_substeps, float h,
                       const __grid_constant__ QctSubParams p) {
  extern __shared__ float4 qs_shared[];  // 16-byte aligned
  __shared__ QctSubParams P;
  QSShared* W = reinterpret_cast<QSShared*>(qs_shared);
  const int nr = blockDim.x / QS_G;
  const int slot0 = blockIdx.x * nr;
  {
    const unsigned* src = reinterpret_cast<const unsigned*>(&p);
    unsigned* dst = reinterpret_cast<unsigned*>(&P);
    for (int k = threadIdx.x; k < (int)(sizeof(P) / 4); k += blockDim.x)
      dst[k] = src[k];
  }
  qs_stage_in(io, p, B, slot0, nr, W, threadIdx.x, blockDim.x);
  __syncthreads();
  QSLane g;
  g.lane = threadIdx.x % QS_G;
  substep_lanes(W[threadIdx.x / QS_G], P, n_substeps, h, g);
  __syncthreads();
  qs_stage_out(io, B, slot0, nr, W, threadIdx.x, blockDim.x);
}

__global__ void qct_substep_serial_kernel(QctSubIO io, int B, int n_substeps,
                                          float h, QctSubParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  substep_instance_serial(io, B, i, n_substeps, h, p);
}

extern "C" const void* qct_substep_fn() {
  return (const void*)qct_substep_kernel;
}

extern "C" int qct_substep(const float* state, const float* a,
                           const float* tau_sw, const float* st,
                           const float* factor, float* out, int B,
                           int n_substeps, float h,
                           const QctSubParams* params, int blocks,
                           int threads, int shared_bytes, void* stream) {
  if (B <= 0) return 0;
  const int robots = threads / QS_G;
  if (threads <= 0 || threads % 32 != 0 || threads > QS_MAX_THREADS ||
      shared_bytes < robots * (int)sizeof(QSShared) ||
      (long long)blocks * robots < (long long)B)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = qct_allow_shared(qct_substep_fn(), shared_bytes);
  if (e != cudaSuccess) return (int)e;
  QctSubIO io = {state, a, tau_sw, st, factor, out};
  qct_substep_kernel<<<blocks, threads, shared_bytes,
                       (cudaStream_t)stream>>>(io, B, n_substeps, h, *params);
  return (int)cudaGetLastError();
}

extern "C" int qct_substep_serial(const float* state, const float* a,
                                  const float* tau_sw, const float* st,
                                  const float* factor, float* out, int B,
                                  int n_substeps, float h,
                                  const QctSubParams* params, void* stream) {
  if (B <= 0) return 0;
  QctSubIO io = {state, a, tau_sw, st, factor, out};
  const int block = qct_block_size(B);
  qct_substep_serial_kernel<<<(B + block - 1) / block, block, 0,
                              (cudaStream_t)stream>>>(io, B, n_substeps, h,
                                                      *params);
  return (int)cudaGetLastError();
}

#ifdef QCT_CLOCKS
extern "C" int qct_substep_clocks(unsigned long long* out) {
  return qct_clocks_read(out);
}
#endif

// out = [lanes per robot, threads a block at most, shared words per robot]
// of this build: what kernels.substep_launch_geometry makes K5's launch
// from.
extern "C" int qct_substep_layout(int* out) {
  qs_layout(out);
  return 0;
}
