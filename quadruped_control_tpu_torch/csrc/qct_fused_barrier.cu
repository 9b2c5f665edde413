// K1, barrier-only variant (compiled without the polish and prox stages).
//
// Replaces quadruped_control_tpu/solver/pallas_fused.py::_fused_kernel in
// its polish=False mode: assembly, equilibration, the sparse-cone Mehrotra
// loop (cold or warm-started) and the map-back with diagnostics, one QP per
// group of QF_G lanes (qct_fused.cuh). See qct_fused_polish.cu for the note
// on what bounds the kernel; qct_fused_solve there launches this one.
#include "qct_fused.cuh"
#include "qct_launch.cuh"

__global__ void __launch_bounds__(QF_MAX_THREADS, QF_MIN_BLOCKS)
    qct_fused_barrier_kernel(QctIO io, int B, QctParams p) {
  extern __shared__ float4 qf_shared[];  // 16-byte aligned
  const int grp = threadIdx.x / QF_G;
  QFLane g;
  g.lane = threadIdx.x % QF_G;
  QFShared* W = reinterpret_cast<QFShared*>(qf_shared) + grp;
  fused_lanes<false>(io, B, blockIdx.x * (blockDim.x / QF_G) + grp, p, *W,
                     g);
}

extern "C" const void* qct_fused_barrier_fn() {
  return (const void*)qct_fused_barrier_kernel;
}

extern "C" int qct_fused_barrier_launch(QctIO io, int B, int blocks,
                                        int threads, int shared_bytes,
                                        const QctParams* p, void* stream) {
  const cudaError_t e =
      qct_allow_shared(qct_fused_barrier_fn(), shared_bytes);
  if (e != cudaSuccess) return (int)e;
  qct_fused_barrier_kernel<<<blocks, threads, shared_bytes,
                             (cudaStream_t)stream>>>(io, B, *p);
  return (int)cudaGetLastError();
}
