// K1, barrier-only variant (compiled without the polish scratch).
//
// Replaces quadruped_control_tpu/solver/pallas_fused.py::_fused_kernel in
// its polish=False mode: assembly, equilibration, the sparse-cone Mehrotra
// loop (cold or warm-started) and the map-back with diagnostics. See
// qct_fused_polish.cu for the note on what bounds the kernel.
#include "qct_launch.cuh"

__global__ void qct_fused_barrier_kernel(QctIO io, int B, QctParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  fused_instance<false>(io, B, i, p);
}

extern "C" int qct_fused_barrier_launch(QctIO io, int B, const QctParams* p,
                                        void* stream) {
  const int block = qct_block_size(B);
  qct_fused_barrier_kernel<<<(B + block - 1) / block, block, 0,
                             (cudaStream_t)stream>>>(io, B, *p);
  return (int)cudaGetLastError();
}
