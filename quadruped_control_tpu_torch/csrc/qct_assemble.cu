// K2: assembly (+ optional equilibration) only, written out dense.
//
// Replaces quadruped_control_tpu/solver/pallas_fused.py::_assembly_kernel
// (launched there by assemble_qp_fused_debug). Bound on this card by BYTES:
// 26 words in and 468 words out per instance against a few hundred
// operations. One instance per thread with structure-of-arrays tensors
// (k, B), so every load and store of a warp is one coalesced 128-byte line;
// nothing is staged, each word moves once.
#include "qct_launch.cuh"

__global__ void qct_assemble_kernel(QctIO io, float* Q, float* c, float* G,
                                    float* h, int B, QctParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  assembly_instance(io, Q, c, G, h, B, i, p);
}

extern "C" int qct_assemble(const float* r, const float* b, const float* st,
                            const float* mu, const float* fzmin,
                            const float* fzmax, float* Q, float* c, float* G,
                            float* h, int B, const QctParams* params,
                            void* stream) {
  if (B <= 0) return 0;
  QctIO io = {r, b, st, mu, fzmin, fzmax, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr, nullptr, nullptr};
  const int block = qct_block_size(B);
  qct_assemble_kernel<<<(B + block - 1) / block, block, 0,
                        (cudaStream_t)stream>>>(io, Q, c, G, h, B, *params);
  return (int)cudaGetLastError();
}

extern "C" const char* qct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
