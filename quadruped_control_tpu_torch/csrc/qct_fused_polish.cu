// K1: the fused GRF-QP solve — assembly, equilibration, Mehrotra barrier,
// certified active-set polish, proximal restarts, map-back — one launch.
//
// Replaces quadruped_control_tpu/solver/pallas_fused.py::_fused_kernel
// (launched there by solve_grf_qp_fused_packed) in every mode: full,
// barrier-only (qct_fused_barrier.cu, the variant without the polish),
// polish-only, warm-started barrier with the stance-flip reset, proximal
// restarts, ff_refine on and off, polish_multi_swap. Schedules are RUNTIME
// arguments (QctParams): one compiled kernel serves every launch of the
// fused solve, the xla prox solve and the balance tick. The per-QP body is
// fused_lanes in qct_fused.cuh.
//
// What bounds it on this card: OPERATIONS, and in practice their latency
// and the instruction rate. A QP reads 26 words (+ 64 warm) and writes 66; between them it
// runs ~3e3 float32 operations per barrier iteration and ~1.6e4 to ~5e4 per
// polish sweep (the 36 x 36 LDL^T, five triangular solves, the error-free
// residuals), in chains that are sequential along the factorizations'
// pivots and the triangular solves. What the design does about it: a group
// of QF_G = 16 lanes per QP (two QPs per warp, eight per 128-thread block,
// 32 per SM in one wave of 4 blocks at <= 128 registers), each lane owning
// cone rows, rows of the barrier's 12 x 12 Cholesky (right-looking in
// registers, columns by shuffle), rows of the LDL^T's trailing triangle
// (right-looking in shared memory, one sync a pivot) and of the forward
// solve, so that a QP's chain is that of one row, not of the whole factor.
// A QP's state (the three problems, the iterates, the KKT factor) lives in
// shared memory, 1776 words = 7,104 bytes per QP, 56,832 bytes per block.
// Syncs and shuffles name the whole warp; the barrier and the polish each
// appear once in the code (the prox restarts run through the same path), so
// that the loops stay within the instruction cache. The launch geometry
// comes from kernels.fused_launch_geometry, made from the build's layout
// (qct_fused_layout).
#include "qct_fused.cuh"
#include "qct_launch.cuh"

__global__ void __launch_bounds__(QF_MAX_THREADS, QF_MIN_BLOCKS)
    qct_fused_polish_kernel(QctIO io, int B, QctParams p) {
  extern __shared__ float4 qf_shared[];  // 16-byte aligned
  const int grp = threadIdx.x / QF_G;
  QFLane g;
  g.lane = threadIdx.x % QF_G;
  QFShared* W = reinterpret_cast<QFShared*>(qf_shared) + grp;
  fused_lanes<true>(io, B, blockIdx.x * (blockDim.x / QF_G) + grp, p, *W,
                    g);
}

extern "C" const void* qct_fused_polish_fn() {
  return (const void*)qct_fused_polish_kernel;
}

extern "C" int qct_fused_barrier_launch(QctIO io, int B, int blocks,
                                        int threads, int shared_bytes,
                                        const QctParams* p, void* stream);

extern "C" int qct_fused_solve(const float* r, const float* b,
                               const float* st, const float* mu,
                               const float* fzmin, const float* fzmax,
                               const float* xw, const float* sw,
                               const float* zw, const float* stprev, float* x,
                               float* s, float* z, float* diag, int* work,
                               int B, int blocks, int threads,
                               int shared_bytes, const QctParams* params,
                               void* stream) {
  if (B <= 0) return 0;
  const int qps = threads / QF_G;
  if (threads <= 0 || threads % 32 != 0 || threads > QF_MAX_THREADS ||
      shared_bytes < qps * (int)sizeof(QFShared) ||
      (long long)blocks * qps < (long long)B)
    return (int)cudaErrorInvalidValue;
  QctIO io = {r, b, st, mu, fzmin, fzmax, xw, sw, zw, stprev, x, s, z, diag,
              work};
  if (!params->polish)
    return qct_fused_barrier_launch(io, B, blocks, threads, shared_bytes,
                                    params, stream);
  const cudaError_t e = qct_allow_shared(qct_fused_polish_fn(), shared_bytes);
  if (e != cudaSuccess) return (int)e;
  qct_fused_polish_kernel<<<blocks, threads, shared_bytes,
                            (cudaStream_t)stream>>>(io, B, *params);
  return (int)cudaGetLastError();
}

// out = [lanes per QP, threads a block at most, shared words per QP] of this
// build: what kernels.fused_launch_geometry makes the launch from.
extern "C" int qct_fused_layout(int* out) {
  qf_layout(out);
  return 0;
}
