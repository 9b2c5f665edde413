// Host build of the per-instance bodies of the commander-pre, substep, MPC
// and dense IPM CUDA kernels (quadruped_control_tpu_torch/csrc/
// qct_commander.cuh, qct_substep.cuh, qct_mpc.cuh and qct_dense_ipm.cuh),
// looped over the batch (and K6's lanes over each robot) by a plain C++
// compiler (-ffp-contract=off), so that the kernels' arithmetic can be held
// against the plain PyTorch versions on a machine without a CUDA compiler
// (tests/test_torch_kernel_sources_host.py).
//
// Built with -DQMPC_LANE_PROGRAM, K6 runs instead as the card runs it
// (host_mpc_riccati_warps, tests/test_torch_mpc_lanes.py): the 32 lanes of
// a warp (two robot slots of QMPC_G lanes) are coroutines, each one call of
// mpc_instance with its own g.lane, its own lane variables and its robot's
// shared state. A sync or a shuffle hands over to the next lane, so each
// lane runs alone from one sync to the next: lane 0 first, or lane 31 first
// with -DQMPC_REVERSE_LANES. Where a sync is missing, a lane reads another
// lane's write before it is made in one order and after it in the other;
// so it does where a lane reads, inside one section, what another lane of
// that section writes. Either way the two orders give other bits. Lanes
// that do not wait at the same sync (a sync or a shuffle inside a branch on
// one robot's data) are an error of their own.
#include <string.h>

#include "qct_commander.cuh"
#include "qct_dense_ipm.cuh"
#ifdef QMPC_LANE_PROGRAM
#include <stdlib.h>
#include <ucontext.h>

static void qmpc_yield(int site);
static float qmpc_shfl(float v, int src, int site);
#define QMPC_WARP_SYNC() qmpc_yield(__LINE__)
#define QMPC_WARP_SHFL(v, src) qmpc_shfl((v), (src), __LINE__)
#elif defined(QMPC_REVERSE_LANES)
// The serial build with the lanes of each section run last lane first: a
// section in which a lane reads what another lane of the same section
// writes gives other bits in the two orders.
#define QMPC_HOST_LANES(lane) for (int lane = QMPC_G - 1; lane >= 0; --lane)
#endif
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

#ifndef QMPC_LANE_PROGRAM
extern "C" void host_mpc_riccati(const float* block, const float* yaw,
                                 const float* phys, const float* warm_F,
                                 const float* warm_sz,
                                 const float* warm_sched, float* F,
                                 float* diag, float* warm_out, float* scratch,
                                 int B, const QctMpcParams* params) {
  QctMpcIO io = {block, yaw,  phys, warm_F,   warm_sz,
                 warm_sched, F, diag, warm_out, scratch};
  QMpcShared S;
  const QMpcLane g = {0};
  for (int i = 0; i < B; ++i) {
    // Shared memory starts undefined on the card: NaN here, so that a read
    // before the first write shows.
    memset(&S, 0xff, sizeof(S));
    mpc_instance(io, B, i, *params, S, g);
  }
}
#else
#define QMPC_WARP 32
static ucontext_t qmpc_main_, qmpc_ctx_[QMPC_WARP];
static int qmpc_cur_;               // the lane running
static int qmpc_site_[QMPC_WARP];   // where each lane waits; 0: returned
static float qmpc_xch_[QMPC_WARP];  // the values a shuffle exchanges
static struct {
  const QctMpcIO* io;
  int B, slot;  // the warp's first robot slot
  const QctMpcParams* p;
  QMpcShared* S;
} qmpc_warp_;

static void qmpc_yield(int site) {
  qmpc_site_[qmpc_cur_] = site;
  swapcontext(&qmpc_ctx_[qmpc_cur_], &qmpc_main_);
}

static float qmpc_shfl(float v, int src, int site) {
  qmpc_xch_[qmpc_cur_] = v;
  qmpc_yield(site);  // every lane has given its value
  const float r = qmpc_xch_[qmpc_cur_ / QMPC_G * QMPC_G + src];
  qmpc_yield(-site);  // every lane has taken one
  return r;
}

static void qmpc_lane_main() {
  const int l = qmpc_cur_;
  QMpcLane g;
  g.lane = l % QMPC_G;
  mpc_instance(*qmpc_warp_.io, qmpc_warp_.B, qmpc_warp_.slot + l / QMPC_G,
               *qmpc_warp_.p, qmpc_warp_.S[l / QMPC_G], g);
  qmpc_site_[l] = 0;
}

// K6 over B robots, a warp (two robot slots) at a time; scratch holds
// 324 N words for each of the 2 ceil(B / 2) slots. Returns 0, or -1 where
// the lanes of a warp did not wait at the same sync.
extern "C" int host_mpc_riccati_warps(
    const float* block, const float* yaw, const float* phys,
    const float* warm_F, const float* warm_sz, const float* warm_sched,
    float* F, float* diag, float* warm_out, float* scratch, int B,
    const QctMpcParams* params) {
  QctMpcIO io = {block, yaw,  phys, warm_F,   warm_sz,
                 warm_sched, F, diag, warm_out, scratch};
  const size_t stack = (size_t)1 << 20;
  char* stacks = (char*)malloc(QMPC_WARP * stack);
  QMpcShared S[QMPC_WARP / QMPC_G];
  int rc = 0;
  for (int slot = 0; slot < B && rc == 0; slot += QMPC_WARP / QMPC_G) {
    memset(S, 0xff, sizeof(S));  // shared memory starts undefined: NaN
    qmpc_warp_.io = &io;
    qmpc_warp_.B = B;
    qmpc_warp_.slot = slot;
    qmpc_warp_.p = params;
    qmpc_warp_.S = S;
    for (int l = 0; l < QMPC_WARP; ++l) {
      getcontext(&qmpc_ctx_[l]);
      qmpc_ctx_[l].uc_stack.ss_sp = stacks + l * stack;
      qmpc_ctx_[l].uc_stack.ss_size = stack;
      qmpc_ctx_[l].uc_link = &qmpc_main_;
      makecontext(&qmpc_ctx_[l], qmpc_lane_main, 0);
    }
    for (bool running = true; running && rc == 0;) {
      for (int k = 0; k < QMPC_WARP; ++k) {
#ifdef QMPC_REVERSE_LANES
        qmpc_cur_ = QMPC_WARP - 1 - k;
#else
        qmpc_cur_ = k;
#endif
        swapcontext(&qmpc_main_, &qmpc_ctx_[qmpc_cur_]);
      }
      for (int l = 1; l < QMPC_WARP; ++l)
        if (qmpc_site_[l] != qmpc_site_[0]) rc = -1;
      running = qmpc_site_[0] != 0;
    }
  }
  free(stacks);
  return rc;
}
#endif

extern "C" void host_mpc_layout(int* out) { qmpc_layout(out); }

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
