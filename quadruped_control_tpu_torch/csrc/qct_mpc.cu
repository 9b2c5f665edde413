// K6: the receding-horizon SRB-MPC solve — one launch per MPC tick (and one
// per solve through the commander's unpacked entry).
//
// Replaces quadruped_control_tpu/mpc/pallas_riccati.py::_mpc_kernel, at both
// of its launch sites (solve_mpc_qp_riccati, the unpacked entry, and
// solve_mpc_qp_riccati_packed, the fused tick's); the per-robot body is
// mpc_instance in qct_mpc.cuh. One compiled kernel serves both entries and
// every configuration: N, dt, the iteration count, sigma_c, tau, tol, alpha
// and the 13 state weights are runtime arguments, the robot constants come
// from the argument struct or per robot.
//
// What bounds it on this card: OPERATIONS, and in practice their latency.
// A robot reads 25 + 17 N words (+ 64 N warm) and writes 12 N + 6 (+ 60 N
// warm), and between them runs ~1.6e4 float32 operations per horizon step
// and IPM iteration (the Riccati sweep: P B, the 12x12 LDL^T, 13 gain
// columns, the P update), ~1.05e6 for N = 8 and 8 iterations
// (chip_smoke.py::ops_mpc), in chains that are sequential only along the
// horizon and the LDL^T's pivots. What the design does about it: a group of
// QMPC_G = 16 lanes per robot (two robots per warp, eight per 128-thread
// block, 4096 robots in one wave of 4 blocks per SM at <= 128 registers),
// each lane owning output elements of the sweep (a column of P B, of the
// gains and of the new P, a row of P A, Lux and Luu, cone rows, horizon
// entries), so that a robot's chain is that of one column, not of the whole
// sweep. The sweep's fixed matrices (P, P A, P B, Lux, the LDL^T factor,
// p) live in shared memory, 1232 words = 4,928 bytes per robot, 39,424
// bytes per block, independent of N, in rows on 16 bytes that load four
// words at a time; the LDL^T runs on rows held in the lanes' registers,
// pivot columns exchanged by shuffle. The horizon arrays and the gains stay
// in a global scratch of 324 N words per robot slot, laid out
// robot-contiguous so that the lanes of a group touch consecutive words,
// with the next step's loads issued a step ahead. The lanes meet at
// __syncwarp() only, never at a block-wide barrier; a robot slot past the
// batch runs along on the last robot's inputs and writes nothing. The launch
// geometry comes from kernels.mpc_launch_geometry.
//
// The library also builds K6's serial body (qct_mpc_serial.cuh, one robot
// per thread, the kernel's arithmetic before the lane split) as
// qct_mpc_serial: the bitwise hold of the lane kernel, which no path of
// the port launches.
#include "qct_launch.cuh"
#include "qct_mpc.cuh"
#include "qct_mpc_serial.cuh"

__global__ void __launch_bounds__(QMPC_MAX_THREADS, QMPC_MIN_BLOCKS)
    qct_mpc_riccati_kernel(QctMpcIO io, int B, QctMpcParams p) {
  extern __shared__ float4 qmpc_shared[];  // 16-byte aligned
  const int grp = threadIdx.x / QMPC_G;
  // Robot slot; past B (the ragged edge) the group runs along without
  // output, so that the full-warp syncs see every lane.
  const int i = blockIdx.x * (blockDim.x / QMPC_G) + grp;
  QMpcLane g;
  g.lane = threadIdx.x % QMPC_G;
  QMpcShared* S = reinterpret_cast<QMpcShared*>(qmpc_shared) + grp;
  mpc_instance(io, B, i, p, *S, g);
}

extern "C" int qct_mpc_riccati(const float* block, const float* yaw,
                               const float* phys, const float* warm_F,
                               const float* warm_sz, const float* warm_sched,
                               float* F, float* diag, float* warm_out,
                               float* scratch, int B, int blocks, int threads,
                               int shared_bytes, const QctMpcParams* params,
                               void* stream) {
  if (B <= 0) return 0;
  const int robots = threads / QMPC_G;
  if (threads <= 0 || threads % QMPC_G != 0 || threads > QMPC_MAX_THREADS ||
      shared_bytes < robots * (int)sizeof(QMpcShared) ||
      (long long)blocks * robots < (long long)B)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      qct_allow_shared((const void*)qct_mpc_riccati_kernel, shared_bytes);
  if (e != cudaSuccess) return (int)e;
  QctMpcIO io = {block, yaw,  phys, warm_F,   warm_sz,
                 warm_sched, F, diag, warm_out, scratch};
  qct_mpc_riccati_kernel<<<blocks, threads, shared_bytes,
                           (cudaStream_t)stream>>>(io, B, *params);
  return (int)cudaGetLastError();
}

__global__ void qct_mpc_serial_kernel(QctMpcIO io, int B, QctMpcParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged edge
  qmpc_serial::mpc_instance(io, B, i, p);
}

// K6's serial body over B robots: the lane kernel's arguments, but a
// (324 N, B) scratch (component-major, qct_mpc_serial.cuh).
extern "C" int qct_mpc_serial(const float* block, const float* yaw,
                              const float* phys, const float* warm_F,
                              const float* warm_sz, const float* warm_sched,
                              float* F, float* diag, float* warm_out,
                              float* scratch, int B,
                              const QctMpcParams* params, void* stream) {
  if (B <= 0) return 0;
  QctMpcIO io = {block, yaw,  phys, warm_F,   warm_sz,
                 warm_sched, F, diag, warm_out, scratch};
  const int block_size = qct_block_size(B);
  qct_mpc_serial_kernel<<<(B + block_size - 1) / block_size, block_size, 0,
                          (cudaStream_t)stream>>>(io, B, *params);
  return (int)cudaGetLastError();
}

// out = [lanes per robot, threads a block at most, shared words per robot]
// of this build: what kernels.mpc_launch_geometry makes the launch from.
extern "C" int qct_mpc_layout(int* out) {
  qmpc_layout(out);
  return 0;
}

extern "C" const void* qct_mpc_fn() {
  return (const void*)qct_mpc_riccati_kernel;
}

// What the card makes of a launch of the kernel fn (qct_mpc_fn,
// qct_fused_barrier_fn, qct_fused_polish_fn) with blocks of `threads`
// threads and `shared_bytes` of dynamic shared memory: out = [resident
// blocks per SM, registers per thread, local (stack) bytes per thread].
extern "C" int qct_occupancy(const void* fn, int threads, int shared_bytes,
                             int* out) {
  cudaError_t e = qct_allow_shared(fn, shared_bytes);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    shared_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return 0;
}
