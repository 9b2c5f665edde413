// Host build of the per-instance bodies of the CUDA kernels (quadruped_
// control_tpu_torch/csrc/: qct_commander.cuh, qct_substep.cuh, qct_mpc.cuh
// and K6's serial body qct_mpc_serial.cuh, qct_dense_ipm.cuh and the fused GRF-QP kernel's qct_fused.cuh), looped
// over the batch (and the lane-group kernels' lanes over each robot or QP)
// by a plain C++ compiler (-ffp-contract=off), so that the kernels'
// arithmetic can be held against the plain PyTorch versions on a machine
// without a CUDA compiler (tests/test_torch_kernel_sources_host.py,
// tests/test_torch_mpc_lanes.py, tests/test_torch_fused_lanes.py,
// tests/test_torch_dense_lanes.py, tests/test_torch_dense_barrier_lanes.py,
// tests/test_torch_substep_lanes.py, tests/test_torch_commander_lanes.py).
//
// Built with -DQCT_LANE_PROGRAM, the five lane-group kernels, K6 (MPC), K1
// (fused GRF-QP), K3a (dense barrier), K3b (dense polish) and K5
// (substeps), run instead as the card runs them (host_mpc_riccati_warps,
// host_fused_solve_warps, host_dense_barrier_warps, host_dense_polish_warps,
// host_substep_warps): the 32 lanes of a warp (two robot or QP slots of 16
// lanes, or 32 / QS_G robot slots of QS_G lanes) are coroutines, each one
// call of the kernel's body with its own g.lane, its own lane variables and
// its slot's shared state. A sync or a shuffle hands over to the next lane,
// so each lane runs alone from one sync to the next: lane 0 first, or lane
// 31 first with -DQCT_REVERSE_LANES.
// Where a sync is missing, a lane reads another lane's write before it is
// made in one order and after it in the other; so it does where a lane
// reads, inside one section, what another lane of that section writes.
// Either way the two orders give other bits. Lanes that do not wait at the
// same sync (the syncs of these kernels name the whole warp) are an error of
// their own.
#include <string.h>

#ifdef QCT_LANE_PROGRAM
#include <stdlib.h>
#include <ucontext.h>

static void lane_yield(int site);
static float lane_shfl(float v, int src, int width, int site);
static bool lane_all(bool pred, int site);
#define QMPC_WARP_SYNC() lane_yield(__LINE__)
#define QMPC_WARP_SHFL(v, src) lane_shfl((v), (src), QMPC_G, __LINE__)
#define QF_WARP_SYNC() lane_yield(__LINE__)
#define QF_WARP_SHFL(v, src) lane_shfl((v), (src), QF_G, __LINE__)
#define QF_WARP_ALL(pred) lane_all((pred), __LINE__)
#define QS_WARP_SYNC() lane_yield(__LINE__)
#elif defined(QCT_REVERSE_LANES)
// The serial build with the lanes of each section run last lane first: a
// section in which a lane reads what another lane of the same section
// writes gives other bits in the two orders.
#define QMPC_HOST_LANES(lane) for (int lane = QMPC_G - 1; lane >= 0; --lane)
#define QF_HOST_LANES(lane) for (int lane = QF_G - 1; lane >= 0; --lane)
#define QS_HOST_LANES(lane) for (int lane = QS_G - 1; lane >= 0; --lane)
#endif
// K4's lane body stores through QC_STORE: the shim counts the stores into
// the output slab host_commander_lanes is given (each word must have one
// writer); a store outside the slab counts in the slab's last word + 1.
static float* qc_slab_;
static long qc_slab_words_;
static int* qc_writes_;
static inline void qc_host_store(float* p, float v) {
  *p = v;
  if (qc_writes_) {
    const long k = p - qc_slab_;
    ++qc_writes_[k >= 0 && k < qc_slab_words_ ? k : qc_slab_words_];
  }
}
#define QC_STORE(p, v) qc_host_store((p), (v))
#include "qct_commander.cuh"
#include "qct_dense_ipm.cuh"
#include "qct_fused.cuh"
#include "qct_mpc.cuh"
#include "qct_mpc_serial.cuh"
#include "qct_substep.cuh"

extern "C" void host_commander_pre(const float* state, const float* carry,
                                   const float* cmd, float* r, float* b,
                                   float* st, float* mu, float* fzmin,
                                   float* fzmax, float* tau_swing,
                                   float* carry_out, float* q_ref, float* mpc,
                                   int B, const QctCmdParams* params) {
  QctCmdIO io = {state, carry,     cmd,   r,  b,  st,  mu,
                 fzmin, fzmax, tau_swing, carry_out, q_ref, mpc};
  for (int i = 0; i < B; ++i) commander_instance_serial(io, B, i, *params);
}

// K4's lane body over the threads of its launch for B instances (blocks of
// QC_THREADS, each thread's slot and lane from qc_slot, slots past B skip
// as on the card), in thread order, or last thread first with
// -DQCT_REVERSE_LANES. writes (slab_words + 1 ints, or null) counts the
// stores into the slab that holds every output.
extern "C" void host_commander_lanes(
    const float* state, const float* carry, const float* cmd, float* r,
    float* b, float* st, float* mu, float* fzmin, float* fzmax,
    float* tau_swing, float* carry_out, float* q_ref, float* mpc, int B,
    const QctCmdParams* params, float* slab, long slab_words, int* writes) {
  QctCmdIO io = {state, carry,     cmd,   r,  b,  st,  mu,
                 fzmin, fzmax, tau_swing, carry_out, q_ref, mpc};
  qc_slab_ = slab;
  qc_slab_words_ = slab_words;
  qc_writes_ = writes;
  const int per_block = QC_THREADS / QC_G;
  const long n = (long)((B + per_block - 1) / per_block) * QC_THREADS;
  for (long k = 0; k < n; ++k) {
#ifdef QCT_REVERSE_LANES
    const long th = n - 1 - k;
#else
    const long th = k;
#endif
    int slot, lane;
    qc_slot((int)(th / QC_THREADS), (int)(th % QC_THREADS), slot, lane);
    if (slot < B) commander_lanes(io, B, slot, *params, lane);
  }
  qc_writes_ = nullptr;
}

// K4's layout of this build (qc_layout): lanes, threads a block.
extern "C" void host_commander_layout(int* out) { qc_layout(out); }

// K5's serial body (one robot per thread), the reference of its lane body.
extern "C" void host_substep_serial(const float* state, const float* a,
                                    const float* tau_sw, const float* st,
                                    const float* factor, float* out, int B,
                                    int n_substeps, float h,
                                    const QctSubParams* params) {
  QctSubIO io = {state, a, tau_sw, st, factor, out};
  for (int i = 0; i < B; ++i)
    substep_instance_serial(io, B, i, n_substeps, h, *params);
}

// K6's serial body (one robot per thread), the reference of its lane body;
// scratch (324 N, B).
extern "C" void host_mpc_serial(const float* block, const float* yaw,
                                const float* phys, const float* warm_F,
                                const float* warm_sz, const float* warm_sched,
                                float* F, float* diag, float* warm_out,
                                float* scratch, int B,
                                const QctMpcParams* params) {
  QctMpcIO io = {block, yaw,  phys, warm_F,   warm_sz,
                 warm_sched, F, diag, warm_out, scratch};
  for (int i = 0; i < B; ++i) qmpc_serial::mpc_instance(io, B, i, *params);
}

#ifndef QCT_LANE_PROGRAM
// K5's lane body over B robots, the lanes of each section in a loop; shared
// state starts NaN, each robot staged and written back as one block of one
// thread would.
extern "C" void host_substep(const float* state, const float* a,
                             const float* tau_sw, const float* st,
                             const float* factor, float* out, int B,
                             int n_substeps, float h,
                             const QctSubParams* params) {
  QctSubIO io = {state, a, tau_sw, st, factor, out};
  static QSShared W;
  const QSLane g = {0};
  for (int i = 0; i < B; ++i) {
    memset(&W, 0xff, sizeof(W));
    qs_stage_in(io, *params, B, i, 1, &W, 0, 1);
    substep_lanes(W, *params, n_substeps, h, g);
    qs_stage_out(io, B, i, 1, &W, 0, 1);
  }
}

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

// K1 over B QPs, the lanes of each section in a loop; shared state starts
// NaN.
extern "C" void host_fused_solve(const float* r, const float* b,
                                 const float* st, const float* mu,
                                 const float* fzmin, const float* fzmax,
                                 const float* xw, const float* sw,
                                 const float* zw, const float* stprev,
                                 float* x, float* s, float* z, float* diag,
                                 int* work, int B, const QctParams* params) {
  QctIO io = {r, b, st, mu, fzmin, fzmax, xw, sw, zw, stprev, x, s, z, diag,
              work};
  static QFShared W;
  const QFLane g = {0};
  for (int i = 0; i < B; ++i) {
    memset(&W, 0xff, sizeof(W));
    if (params->polish)
      fused_lanes<true>(io, B, i, *params, W, g);
    else
      fused_lanes<false>(io, B, i, *params, W, g);
  }
}

// K3b over B QPs, the lanes of each section in a loop; shared state starts
// NaN, each QP staged and written back as one block of one thread would.
extern "C" void host_dense_polish(const float* Q, const float* c,
                                  const float* G, const float* h,
                                  const float* x_in, const float* s_in,
                                  const float* z_in, float* x, float* s,
                                  float* z, float* cert, int B) {
  QctDenseIO io = {Q, c, G, h, x_in, s_in, z_in, x, s, z, cert};
  static QDShared W;
  const QFLane g = {0};
  for (int i = 0; i < B; ++i) {
    memset(&W, 0xff, sizeof(W));
    qd_stage_in(io, B, i, 1, &W, 0, 1);
    dense_polish_lanes(W, g);
    qd_stage_out(io, B, i, 1, &W, 0, 1);
  }
}

// K3a's lane body over B QPs, the lanes of each section in a loop; shared
// state starts NaN, each QP staged and written back as one block of one
// thread would.
extern "C" void host_dense_barrier_lanes(const float* Q, const float* c,
                                         const float* G, const float* h,
                                         float* x, float* s, float* z, int B,
                                         int iterations, float tau) {
  QctDenseIO io = {Q, c, G, h, nullptr, nullptr, nullptr, x, s, z, nullptr};
  static QDBShared W;
  const QFLane g = {0};
  for (int i = 0; i < B; ++i) {
    memset(&W, 0xff, sizeof(W));
    qd_stage_in<QDBShared, QDB_IN>(io, B, i, 1, &W, 0, 1);
    dense_barrier_lanes(W, iterations, tau, g);
    qd_stage_out<QDBShared, QDB_OUT>(io, B, i, 1, &W, 0, 1);
  }
}
#else
// A warp's 32 lanes as coroutines: lane_run_warp calls lane_body_(l) for
// each lane l on a stack of its own and switches lanes at every sync and
// shuffle, round by round.
#define LANE_WARP 32
static ucontext_t lane_main_, lane_ctx_[LANE_WARP];
static int lane_cur_;               // the lane running
static int lane_site_[LANE_WARP];   // where each lane waits; 0: returned
static float lane_xch_[LANE_WARP];  // the values a shuffle exchanges
static void (*lane_body_)(int lane);

static void lane_yield(int site) {
  lane_site_[lane_cur_] = site;
  swapcontext(&lane_ctx_[lane_cur_], &lane_main_);
}

// Lane src (of the group of `width` lanes) of v.
static float lane_shfl(float v, int src, int width, int site) {
  lane_xch_[lane_cur_] = v;
  lane_yield(site);  // every lane has given its value
  const float r = lane_xch_[lane_cur_ / width * width + src];
  lane_yield(-site);  // every lane has taken one
  return r;
}

// pred in every lane of the warp.
static bool lane_all(bool pred, int site) {
  lane_xch_[lane_cur_] = pred ? 1.0f : 0.0f;
  lane_yield(site);  // every lane has given its value
  bool r = true;
  for (int l = 0; l < LANE_WARP; ++l) r = r && lane_xch_[l] != 0.0f;
  lane_yield(-site);  // every lane has taken them
  return r;
}

static void lane_entry() {
  const int l = lane_cur_;
  lane_body_(l);
  lane_site_[l] = 0;
}

// Runs lane_body_ on the lanes of one warp to their ends; returns -1 where
// the lanes did not wait at the same site.
static int lane_run_warp(void (*body)(int), char* stacks, size_t stack) {
  lane_body_ = body;
  for (int l = 0; l < LANE_WARP; ++l) {
    getcontext(&lane_ctx_[l]);
    lane_ctx_[l].uc_stack.ss_sp = stacks + l * stack;
    lane_ctx_[l].uc_stack.ss_size = stack;
    lane_ctx_[l].uc_link = &lane_main_;
    makecontext(&lane_ctx_[l], lane_entry, 0);
    lane_site_[l] = -1;  // not started
  }
  for (bool running = true; running;) {
    for (int k = 0; k < LANE_WARP; ++k) {
#ifdef QCT_REVERSE_LANES
      lane_cur_ = LANE_WARP - 1 - k;
#else
      lane_cur_ = k;
#endif
      if (lane_site_[lane_cur_] != 0)
        swapcontext(&lane_main_, &lane_ctx_[lane_cur_]);
    }
    running = false;
    for (int l = 0; l < LANE_WARP; ++l) {
      if (lane_site_[l] != lane_site_[0]) return -1;
      running = running || lane_site_[l] != 0;
    }
  }
  return 0;
}

static const size_t lane_stack_ = (size_t)1 << 20;

static struct {
  const QctMpcIO* io;
  int B, slot;  // the warp's first robot slot
  const QctMpcParams* p;
  QMpcShared* S;
} qmpc_warp_;

static void qmpc_lane_main(int l) {
  QMpcLane g;
  g.lane = l % QMPC_G;
  mpc_instance(*qmpc_warp_.io, qmpc_warp_.B, qmpc_warp_.slot + l / QMPC_G,
               *qmpc_warp_.p, qmpc_warp_.S[l / QMPC_G], g);
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
  char* stacks = (char*)malloc(LANE_WARP * lane_stack_);
  QMpcShared S[LANE_WARP / QMPC_G];
  int rc = 0;
  for (int slot = 0; slot < B && rc == 0; slot += LANE_WARP / QMPC_G) {
    memset(S, 0xff, sizeof(S));  // shared memory starts undefined: NaN
    qmpc_warp_.io = &io;
    qmpc_warp_.B = B;
    qmpc_warp_.slot = slot;
    qmpc_warp_.p = params;
    qmpc_warp_.S = S;
    rc = lane_run_warp(qmpc_lane_main, stacks, lane_stack_);
  }
  free(stacks);
  return rc;
}

static struct {
  const QctIO* io;
  int B, slot;  // the warp's first QP slot
  const QctParams* p;
  QFShared* W;
} qf_warp_;

static void qf_lane_main(int l) {
  QFLane g;
  g.lane = l % QF_G;
  const int k = l / QF_G;
  if (qf_warp_.p->polish)
    fused_lanes<true>(*qf_warp_.io, qf_warp_.B, qf_warp_.slot + k,
                      *qf_warp_.p, qf_warp_.W[k], g);
  else
    fused_lanes<false>(*qf_warp_.io, qf_warp_.B, qf_warp_.slot + k,
                       *qf_warp_.p, qf_warp_.W[k], g);
}

// K1 over B QPs, a warp (two QP slots) at a time. Returns 0, or -1 where
// the lanes of a warp did not wait at the same sync.
extern "C" int host_fused_solve_warps(
    const float* r, const float* b, const float* st, const float* mu,
    const float* fzmin, const float* fzmax, const float* xw, const float* sw,
    const float* zw, const float* stprev, float* x, float* s, float* z,
    float* diag, int* work, int B, const QctParams* params) {
  QctIO io = {r, b, st, mu, fzmin, fzmax, xw, sw, zw, stprev, x, s, z, diag,
              work};
  char* stacks = (char*)malloc(LANE_WARP * lane_stack_);
  static QFShared W[LANE_WARP / QF_G];
  int rc = 0;
  for (int slot = 0; slot < B && rc == 0; slot += LANE_WARP / QF_G) {
    memset(W, 0xff, sizeof(W));  // shared memory starts undefined: NaN
    qf_warp_.io = &io;
    qf_warp_.B = B;
    qf_warp_.slot = slot;
    qf_warp_.p = params;
    qf_warp_.W = W;
    rc = lane_run_warp(qf_lane_main, stacks, lane_stack_);
  }
  free(stacks);
  return rc;
}

static QDShared* qd_warp_;

static void qd_lane_main(int l) {
  QFLane g;
  g.lane = l % QF_G;
  dense_polish_lanes(qd_warp_[l / QF_G], g);
}

// K3b over B QPs, a warp (two QP slots) at a time, each pair staged and
// written back by the warp's 32 threads as on the card. Returns 0, or -1
// where the lanes of a warp did not wait at the same sync.
extern "C" int host_dense_polish_warps(const float* Q, const float* c,
                                       const float* G, const float* h,
                                       const float* x_in, const float* s_in,
                                       const float* z_in, float* x, float* s,
                                       float* z, float* cert, int B) {
  QctDenseIO io = {Q, c, G, h, x_in, s_in, z_in, x, s, z, cert};
  char* stacks = (char*)malloc(LANE_WARP * lane_stack_);
  static QDShared W[LANE_WARP / QF_G];
  const int nq = LANE_WARP / QF_G;
  int rc = 0;
  for (int slot = 0; slot < B && rc == 0; slot += nq) {
    memset(W, 0xff, sizeof(W));  // shared memory starts undefined: NaN
    for (int t = 0; t < LANE_WARP; ++t)
      qd_stage_in(io, B, slot, nq, W, t, LANE_WARP);
    qd_warp_ = W;
    rc = lane_run_warp(qd_lane_main, stacks, lane_stack_);
    for (int t = 0; t < LANE_WARP; ++t)
      qd_stage_out(io, B, slot, nq, W, t, LANE_WARP);
  }
  free(stacks);
  return rc;
}

static struct {
  int iterations;
  float tau;
  QDBShared* W;
} qdb_warp_;

static void qdb_lane_main(int l) {
  QFLane g;
  g.lane = l % QF_G;
  dense_barrier_lanes(qdb_warp_.W[l / QF_G], qdb_warp_.iterations,
                      qdb_warp_.tau, g);
}

// K3a over B QPs, a warp (two QP slots) at a time, each pair staged and
// written back by the warp's 32 threads as on the card. Returns 0, or -1
// where the lanes of a warp did not wait at the same sync.
extern "C" int host_dense_barrier_warps(const float* Q, const float* c,
                                        const float* G, const float* h,
                                        float* x, float* s, float* z, int B,
                                        int iterations, float tau) {
  QctDenseIO io = {Q, c, G, h, nullptr, nullptr, nullptr, x, s, z, nullptr};
  char* stacks = (char*)malloc(LANE_WARP * lane_stack_);
  static QDBShared W[LANE_WARP / QF_G];
  const int nq = LANE_WARP / QF_G;
  int rc = 0;
  for (int slot = 0; slot < B && rc == 0; slot += nq) {
    memset(W, 0xff, sizeof(W));  // shared memory starts undefined: NaN
    for (int t = 0; t < LANE_WARP; ++t)
      qd_stage_in<QDBShared, QDB_IN>(io, B, slot, nq, W, t, LANE_WARP);
    qdb_warp_.iterations = iterations;
    qdb_warp_.tau = tau;
    qdb_warp_.W = W;
    rc = lane_run_warp(qdb_lane_main, stacks, lane_stack_);
    for (int t = 0; t < LANE_WARP; ++t)
      qd_stage_out<QDBShared, QDB_OUT>(io, B, slot, nq, W, t, LANE_WARP);
  }
  free(stacks);
  return rc;
}

static struct {
  const QctSubParams* p;
  int n_substeps;
  float h;
  QSShared* W;
} qs_warp_;

static void qs_lane_main(int l) {
  QSLane g;
  g.lane = l % QS_G;
  substep_lanes(qs_warp_.W[l / QS_G], *qs_warp_.p, qs_warp_.n_substeps,
                qs_warp_.h, g);
}

// K5 over B robots, a warp (32 / QS_G robot slots) at a time, each warp's
// robots staged and written back by its 32 threads as on the card. Returns
// 0, or -1 where the lanes of a warp did not wait at the same sync.
extern "C" int host_substep_warps(const float* state, const float* a,
                                  const float* tau_sw, const float* st,
                                  const float* factor, float* out, int B,
                                  int n_substeps, float h,
                                  const QctSubParams* params) {
  QctSubIO io = {state, a, tau_sw, st, factor, out};
  char* stacks = (char*)malloc(LANE_WARP * lane_stack_);
  static QSShared W[LANE_WARP / QS_G];
  const int nr = LANE_WARP / QS_G;
  int rc = 0;
  for (int slot = 0; slot < B && rc == 0; slot += nr) {
    memset(W, 0xff, sizeof(W));  // shared memory starts undefined: NaN
    for (int t = 0; t < LANE_WARP; ++t)
      qs_stage_in(io, *params, B, slot, nr, W, t, LANE_WARP);
    qs_warp_.p = params;
    qs_warp_.n_substeps = n_substeps;
    qs_warp_.h = h;
    qs_warp_.W = W;
    rc = lane_run_warp(qs_lane_main, stacks, lane_stack_);
    for (int t = 0; t < LANE_WARP; ++t)
      qs_stage_out(io, B, slot, nr, W, t, LANE_WARP);
  }
  free(stacks);
  return rc;
}
#endif

extern "C" void host_mpc_layout(int* out) { qmpc_layout(out); }

extern "C" void host_fused_layout(int* out) { qf_layout(out); }

extern "C" void host_dense_layout(int* out) { qd_layout(out); }

extern "C" void host_dense_barrier_layout(int* out) { qdb_layout(out); }

extern "C" void host_substep_layout(int* out) { qs_layout(out); }

// K3a's serial body (one QP per thread), the reference of its lane body.
extern "C" void host_dense_barrier(const float* Q, const float* c,
                                   const float* G, const float* h, float* x,
                                   float* s, float* z, int B, int iterations,
                                   float tau) {
  QctDenseIO io = {Q, c, G, h, nullptr, nullptr, nullptr, x, s, z, nullptr};
  for (int i = 0; i < B; ++i) dense_barrier_instance(io, B, i, iterations, tau);
}

