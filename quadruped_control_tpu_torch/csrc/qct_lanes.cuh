// One QP on a group of QF_G = 16 lanes: the lane machinery and the 36 x 36
// quasidefinite LDL^T of the certified polish, shared by the two kernels
// that run a QP that way, K1 (qct_fused.cuh, the fused GRF-QP solve) and
// K3b (qct_dense_ipm.cuh, the dense certified polish).
//
// Lanes. Code outside a lane section is QP-uniform: every lane of the group
// runs it on the same values and takes the same branch. A lane section
// (QF_LANES) runs its body in each lane for the elements that lane owns.
// QF_PHASE is a lane section followed by a sync. Lane variables
// (QF_LANE_VAR) carry a lane's registers from one section to the next; a
// lane reads another lane's by shuffle (QF_SHFL_LV), with no sync.
//
// Rules that keep the bits: a lane never reads what another lane wrote since
// the last sync; uniform code writes no memory and reads only what no lane
// writes before the next sync; a sum over elements is formed in element
// order by one lane (or by uniform code); a maximum or minimum is reduced
// across lanes with qmax / qmin (exact, NaN kept), by a butterfly of
// shuffles (QF_REDUCE) or through per-lane partials in shared memory (a sign
// of zero that the order could flip only reaches comparisons); an argmax /
// argmin combines the lanes' first winners by value and lowest index
// (strict comparisons, a NaN row never wins, index 0 when every row loses).
// The right-looking factorizations subtract from each entry the same terms,
// in the same order, as the left-looking loops of the plain versions. A
// division runs qdiv's branch-free fast path where it is the IEEE quotient
// and "/" elsewhere (qf_div).
//
// Divergence. The syncs and shuffles name the whole warp (full-mask
// __syncwarp / __shfl_sync, which compile to plain instructions, where a
// mask of one group's half needs a collective sequence around each), so the
// two QPs of a warp meet at every sync: no sync or shuffle sits in a branch
// on one QP's data. A QP that is done before its warp-mate runs along,
// writing nothing that is read later, until both are done (QF_WARP_ALL).
//
// Host build (QCT_DEV = static inline): a lane section is a loop of the
// lanes over its body, in the order QF_HOST_LANES gives (ascending unless
// the includer defines it otherwise), a lane variable an array over the
// lanes, a shuffle a read of another lane's entry, a warp vote the QP's
// own predicate, and the syncs are empty. An includer that defines
// QF_WARP_SYNC(), QF_WARP_SHFL(v, src) and QF_WARP_ALL(pred) gets the card's
// form instead (one lane per call of the body, g.lane): the test shim
// (tests/torch_port_host_shim.cpp) runs a warp's lanes as coroutines, and
// tests/test_torch_fused_lanes.py and tests/test_torch_dense_lanes.py run
// each kernel's lanes in both orders and as the card's coroutines; a missing
// sync or a read across lanes in one section changes bits there.
#pragma once

#include "qct_common.cuh"

#define QF_G 16  // lanes per QP

// A thread's place in its group: its lane.
struct QFLane {
  int lane;
};

#ifdef __CUDACC__
#define QF_WARP_SYNC() __syncwarp()
#define QF_WARP_SHFL(v, src) __shfl_sync(0xffffffffu, (v), (src), QF_G)
#define QF_WARP_ALL(pred) __all_sync(0xffffffffu, (pred))
#endif
#ifdef QF_WARP_SYNC
#define QF_LANES(lane) \
  for (int lane = g.lane, qf_once_ = 1; qf_once_; qf_once_ = 0)
#define QF_SYNC() QF_WARP_SYNC()
#define QF_PHASE(lane)                              \
  for (int lane = g.lane, qf_once_ = 1; qf_once_; \
       qf_once_ = 0, QF_WARP_SYNC())
#define QF_LANE_VAR(type, name, n) type name[n]
#define QF_LV(name) name
// Lane src's QF_LV(name)[idx], read by every lane of the group (all 32
// lanes of the warp must run it together). Inside a section, the value read
// must not be written in that section. QF_WARP_ALL(pred): pred holds in
// every lane of the warp (in the serial host form: of this QP).
#define QF_SHFL_LV(name, idx, src) QF_WARP_SHFL(name[idx], (src))
// The same for a runtime idx < 3.
#define QF_SHFL_LV3(name, idx, src) QF_WARP_SHFL(qf_pick<3>(name, idx), (src))
// out = op over the lanes of QF_LV(name)[idx], op exact and free of order
// (qmin, qmax): a butterfly of shuffles, every lane getting the same value
// where no two lanes hold zeros of opposite signs. Uniform code only.
#define QF_REDUCE(out, name, idx, op)                        \
  do {                                                       \
    float v_ = name[idx];                                    \
    for (int o_ = QF_G / 2; o_ > 0; o_ >>= 1)                \
      v_ = op(v_, QF_WARP_SHFL(v_, g.lane ^ o_));            \
    (out) = v_;                                              \
  } while (0)
// (vout, iout) = the first winner over the lanes of the pairs (value
// QF_LV(name)[iv], row index QF_LV(name)[ii]) by better(v, i, best_v,
// best_i) (qf_first_max / qf_first_min), by a butterfly. Uniform code only.
#define QF_REDUCE_FIRST(vout, iout, name, iv, ii, better)    \
  do {                                                       \
    float v_ = name[iv];                                     \
    int i_ = (int)name[ii];                                  \
    for (int o_ = QF_G / 2; o_ > 0; o_ >>= 1) {              \
      const float ov_ = QF_WARP_SHFL(v_, g.lane ^ o_);       \
      const int oi_ = (int)QF_WARP_SHFL((float)i_, g.lane ^ o_); \
      if (better(ov_, oi_, v_, i_)) {                        \
        v_ = ov_;                                            \
        i_ = oi_;                                            \
      }                                                      \
    }                                                        \
    (vout) = v_;                                             \
    (iout) = i_;                                             \
  } while (0)
#else
#ifndef QF_HOST_LANES
#define QF_HOST_LANES(lane) for (int lane = 0; lane < QF_G; ++lane)
#endif
#define QF_LANES(lane) QF_HOST_LANES(lane)
#define QF_SYNC() ((void)0)
#define QF_WARP_ALL(pred) (pred)
#define QF_PHASE(lane) QF_HOST_LANES(lane)
#define QF_LANE_VAR(type, name, n) type name##_lanes_[QF_G][n]
#define QF_LV(name) name##_lanes_[lane]
#define QF_SHFL_LV(name, idx, src) (name##_lanes_[(src)][idx])
#define QF_SHFL_LV3(name, idx, src) (name##_lanes_[(src)][idx])
#define QF_REDUCE(out, name, idx, op)                        \
  do {                                                       \
    float v_ = name##_lanes_[0][idx];                        \
    for (int l_ = 1; l_ < QF_G; ++l_)                        \
      v_ = op(v_, name##_lanes_[l_][idx]);                   \
    (out) = v_;                                              \
  } while (0)
#define QF_REDUCE_FIRST(vout, iout, name, iv, ii, better)    \
  do {                                                       \
    float v_ = name##_lanes_[0][iv];                         \
    int i_ = (int)name##_lanes_[0][ii];                      \
    for (int l_ = 1; l_ < QF_G; ++l_) {                      \
      const float ov_ = name##_lanes_[l_][iv];               \
      const int oi_ = (int)name##_lanes_[l_][ii];            \
      if (better(ov_, oi_, v_, i_)) {                        \
        v_ = ov_;                                            \
        i_ = oi_;                                            \
      }                                                      \
    }                                                        \
    (vout) = v_;                                             \
    (iout) = i_;                                             \
  } while (0)
#endif

// The combining rules of QF_REDUCE_FIRST for the swap of the polishes: a
// lane's first winner (strict comparisons over its rows, never a NaN row;
// index 0 where no row won, its value then -Q_BIG / Q_BIG) against the best
// so far, by value and, on ties, by the lower index. Commutative and
// associative on such pairs, so the butterfly's order does not matter.
QCT_DEV bool qf_first_max(float v, int i, float best_v, int best_i) {
  return v > best_v || (v == best_v && v > -Q_BIG && i < best_i);
}
QCT_DEV bool qf_first_min(float v, int i, float best_v, int best_i) {
  return v < best_v || (v == best_v && v < Q_BIG && i < best_i);
}

// Start of column j of a packed lower triangle of order 36 stored by
// columns: entry (i, j), i >= j, at qf_col(j) + i - j.
QCT_DEV int qf_col(int j) { return j * QNK - (j * (j - 1)) / 2; }

// The KKT rows of a lane, its slot m = 0, 1, 2: 35 - lane, 4 + lane and, for
// lanes 0-3, 3 - lane (-1: none). Counted from the last row in a snake, so
// that the rows of the LDL^T's trailing triangle spread evenly at every
// pivot.
QCT_DEV int qf_kkt_row(int lane, int m) {
  return m == 0 ? QNK - 1 - lane : (m == 1 ? 4 + lane : (lane < 4 ? 3 - lane : -1));
}
// The lane and slot of KKT row k.
QCT_DEV int qf_kkt_owner(int k) {
  return k >= 20 ? QNK - 1 - k : (k >= 4 ? k - 4 : 3 - k);
}
QCT_DEV int qf_kkt_slot(int k) { return k >= 20 ? 0 : (k >= 4 ? 1 : 2); }

// a / b, the IEEE quotient: qdiv's branch-free fast path, "/" where it is
// out of its range.
QCT_DEV float qf_div(float a, float b) {
  bool ok = true;
  float q = qdiv(a, b, ok);
  if (!ok) q = a / b;
  return q;
}

// v[k] for a runtime k of a register array (selects, no local memory).
template <int n>
QCT_DEV float qf_pick(const float* v, int k) {
  float r = v[0];
#pragma unroll
  for (int j = 1; j < n; ++j) r = k == j ? v[j] : r;
  return r;
}

// LDL^T of the KKT matrix K (packed lower triangle by columns, qf_col; the
// lanes' rows as qf_kkt_row deals them), in place, pivots into D (shared):
// right-looking, at pivot k each lane takes D_k = K[k][k] (final: every
// earlier pivot has subtracted its term), subtracts (L_ik D_k) L_jk from the
// entries (i, j), k < j < i, of its rows and (L_ik L_ik) D_k from their
// diagonals, with L_ik = K[i][k] / D_k formed as the left-looking loop
// formed it, and stores column k - 1 scaled (nothing reads it at pivot k).
// A pivot of magnitude <= 1e-30 becomes NaN. One sync a pivot (the last
// one's phase scales column 34, so the factor is whole at the return).
QCT_DEV void qf_ldl_factor(float* K, float* D, const QFLane& g) {
  float dinv_prev = 0.0f;
  for (int k = 0; k < QNK; ++k) {
    const int ck = qf_col(k);
    const float kk = K[ck];
    const float dd = fabsf(kk) > 1e-30f ? kk : qnan();
    const float dinv = qf_div(1.0f, dd);
    QF_PHASE(lane) {
      if (lane == 0) D[k] = dd;
      if (k > 0) {
        const int cp = qf_col(k - 1) - (k - 1);
        for (int i = k + lane; i < QNK; i += QF_G)
          K[cp + i] = K[cp + i] * dinv_prev;
      }
      for (int m = 0; m < 3; ++m) {
        const int i = qf_kkt_row(lane, m);
        if (i <= k) continue;
        const float lik = K[ck + i - k] * dinv;
        const float likd = lik * dd;
        // Entry (i, j) at e = qf_col(j) + i - j; e(j + 1) = e(j) + 35 - j.
        int j = k + 1, e = qf_col(j) + i - j;
        for (; j + 4 <= i; j += 4) {
          const int e1 = e + QNK - 1 - j, e2 = e1 + QNK - 2 - j,
                    e3 = e2 + QNK - 3 - j;
          const float c0 = K[ck + j - k], c1 = K[ck + j + 1 - k],
                      c2 = K[ck + j + 2 - k], c3 = K[ck + j + 3 - k];
          const float v0 = K[e], v1 = K[e1], v2 = K[e2], v3 = K[e3];
          K[e] = v0 - likd * (c0 * dinv);
          K[e1] = v1 - likd * (c1 * dinv);
          K[e2] = v2 - likd * (c2 * dinv);
          K[e3] = v3 - likd * (c3 * dinv);
          e = e3 + QNK - 4 - j;
        }
        for (; j < i; ++j) {
          K[e] = K[e] - likd * (K[ck + j - k] * dinv);
          e += QNK - 1 - j;
        }
        K[e] = K[e] - lik * lik * dd;  // e = qf_col(i): the diagonal
      }
    }
    dinv_prev = dinv;
  }
}

// One solve with the factor of qf_ldl_factor (K, D): rhs(R) is the
// right-hand side of KKT row R, which the lane owning R forms (it may read
// what the lanes wrote before the last sync). The solution goes into xz
// (first) or is added to it. u (shared) takes D^-1 L^-1 rhs, then the
// solution. Forward: each lane keeps the right-hand side of its rows and,
// at step k, takes y_k from the lane of row k and subtracts L_ik y_k from
// its rows i > k (each row's terms in k order), with L_ik of the next step
// loaded a step ahead. Backward: lane 0 runs the sequential sweep on
// D^-1 y, in the original order. Ends with a sync.
template <class Rhs>
QCT_DEV void qf_ldl_solve(const float* K, const float* D, float* u, float* xz,
                          bool first, const QFLane& g, Rhs rhs) {
  QF_LANE_VAR(float, fv, 3);
  QF_LANES(lane) {
    for (int m = 0; m < 3; ++m) {
      const int R = qf_kkt_row(lane, m);
      QF_LV(fv)[m] = R >= 0 ? rhs(R) : 0.0f;
    }
  }
  QF_LANE_VAR(float, lk, 3);
  QF_LANES(lane) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int i = qf_kkt_row(lane, m);
      QF_LV(lk)[m] = i > 0 ? K[i] : 0.0f;
    }
  }
  for (int k = 0; k < QNK - 1; ++k) {
    const int cn = qf_col(k + 1) - (k + 1);
    QF_LANES(lane) {
      float lc[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int i = qf_kkt_row(lane, m);
        lc[m] = QF_LV(lk)[m];
        QF_LV(lk)[m] = i > k + 1 ? K[cn + i] : 0.0f;
      }
      const float yk = QF_SHFL_LV3(fv, qf_kkt_slot(k), qf_kkt_owner(k));
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int i = qf_kkt_row(lane, m);
        if (i > k) QF_LV(fv)[m] = QF_LV(fv)[m] - lc[m] * yk;
      }
    }
  }
  QF_PHASE(lane) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int R = qf_kkt_row(lane, m);
      if (R >= 0) u[R] = qf_div(QF_LV(fv)[m], D[R]);
    }
  }
  QF_PHASE(lane) {
    if (lane == 0) {
      float un = 0.0f;  // u[i + 1]
      for (int i = QNK - 1; i >= 0; --i) {
        const float* c = K + qf_col(i) + 1;  // L_ki, k = i + 1 ...
        const float* uk = u + i + 1;
        const int n = QNK - 1 - i;
        float v = u[i];
        int m = 0;
        if (n > 0) {
          v = v - c[0] * un;
          m = 1;
        }
        for (; m + 4 <= n; m += 4) {
          const float p0 = c[m] * uk[m], p1 = c[m + 1] * uk[m + 1],
                      p2 = c[m + 2] * uk[m + 2], p3 = c[m + 3] * uk[m + 3];
          v = v - p0;
          v = v - p1;
          v = v - p2;
          v = v - p3;
        }
        for (; m < n; ++m) v = v - c[m] * uk[m];
        u[i] = v;
        xz[i] = first ? v : xz[i] + v;
        un = v;
      }
    }
  }
}
