// K1: the whole fused GRF-QP solve, one QP per group of QF_G = 16 lanes.
//
// Replaces the TPU kernel body
// quadruped_control_tpu/solver/pallas_fused.py::_fused_kernel. What it
// computes, per QP: the closed-form assembly (qct_common.cuh's assemble, by
// lane 0) and the equilibration (qf_equilibrate), the sparse-cone Mehrotra
// barrier (qf_barrier), the certified active-set polish on the 36 x 36
// quasidefinite KKT (qf_polish), the proximal restarts and the map-back with
// its diagnostics (fused_lanes). The plain PyTorch version is
// solver/fused.py::_fused_plain; every element keeps the operation order of
// the one-QP-per-thread body this kernel replaced, which follows the plain
// version statement for statement, so the kernel is bitwise equal to it
// (with a correctly rounded reciprocal square root on the PyTorch side).
//
// Lanes (qct_lanes.cuh has the machinery and the rules that keep the bits).
// A lane owns cone rows r = lane + 16 m, rows of the barrier's 12 x 12
// matrix (lane i < 12), KKT rows (qf_kkt_row), entries of Q. Lane variables
// carry a lane's row of the 12 x 12 Cholesky and its rows of the polish's
// forward solve. The polish's backward sweep, a chain that no order-keeping
// split shortens, runs in lane 0. A QP certified before its warp-mate in the
// polish's sweep loop runs along (QF_WARP_ALL); a QP slot past the batch
// runs along on the last QP's inputs and writes nothing.
//
// Memory. Everything a QP keeps between sections sits in shared memory, one
// QFShared per QP, 1776 words (the problems P, S and the prox step's, the
// scalings, the iterates, the barrier's or the polish's scratch, the
// reduction slots; kernels.py reads its size from the build, qf_layout).
// The polish's KKT matrix is stored by columns (qf_col), so that the
// factor's pivot column and both triangular solves read contiguous words.
//
// NaN. Every max/min goes through qmax/qmin, which propagate NaN as
// torch.maximum does; a poisoned QP stays poisoned in its own group.
#pragma once

#include "qct_lanes.cuh"

#define QF_MAX_THREADS 128  // __launch_bounds__ of the kernels
#define QF_MIN_BLOCKS 4     // ... and their blocks per SM (<= 128 registers)

// The barrier's scratch.
struct QFBarrierScratch {
  float bx[QN], bs[QM], bz[QM];  // best iterate
  float r_prim[QM], r_dual[QN];
  float rc[QM], t[QM];           // centering target, (z r_prim - rc) / s
  float ds_a[QM], dz_a[QM], ds[QM], dz[QM];
  float M[QNU];                  // Q + G^T D G + delta I, packed upper
  float L[QN * QN];              // Cholesky factor by rows, diagonal 1/L_ii
};

// The polish's scratch.
struct QFPolishScratch {
  float K[QTRI];    // KKT lower triangle by columns (qf_col), becomes L
  float D[QNK];     // the LDL^T's pivots
  float u[QNK];     // a solve's D^-1 L^-1 rhs, then its solution
  float xz[QNK];    // the polished point xp | zp
  float slack[QM];
};

// One QP's state (shared memory on the card).
struct QFShared {
  QctProb P, S, Sp;  // the problem, equilibrated, the prox step's
  QctScale E, Ep;
  float st[4];
  float x[QN], s[QM], z[QM], a[QM];  // the iterate, the active set
  float xko[QN], sko[QM], zko[QM];   // prox iterate, original units
  float xq[QN], sq[QM], zq[QM];      // prox step's point
  float xo[QN], so[QM], zo[QM];      // a point in original units
  union {
    QFBarrierScratch b;
    QFPolishScratch p;
    QctProb pp;  // the prox step's regularized problem
  } w;
  float red[8][QF_G];  // per-lane partials of reductions
  float pad[22];
};
// 1776 words = 16 mod 32: the two QPs of a warp reading the same element of
// their states hit different banks.
static_assert(sizeof(QFShared) / sizeof(float) % 32 == 16,
              "a QP's state is 16 words mod 32 (banks)");

// What the launch geometry is made from (kernels.fused_launch_geometry):
// lanes per QP, threads a block at most, shared words per QP.
static inline void qf_layout(int* out) {
  out[0] = QF_G;
  out[1] = QF_MAX_THREADS;
  out[2] = (int)(sizeof(QFShared) / sizeof(float));
}

// (G x)_r with x a register array.
QCT_DEV float qf_gx_reg(const QctProb& P, const float* x, int r) {
  const int leg = r / 6, t = r - 6 * leg;
  float acc = P.g0[r] * qf_pick<QN>(x, 3 * leg + row_c0(t));
  if (t < 4) acc = acc + P.g1[r] * qf_pick<QN>(x, 3 * leg + 2);
  return acc;
}

// Address of the entry (i, j) of the packed upper Q for a runtime i and a
// compile-time j: iu(j, i) below the diagonal, rb + j on and above it, with
// rb = qf_row_base(i).
QCT_DEV int qf_iu_rt(int i, int rb, int j) {
  return j <= i ? iu(j, j) - j + i : rb + j;
}
QCT_DEV int qf_row_base(int i) { return i * (QN - 1) - (i * (i - 1)) / 2; }

// Row i of Q + G^T D G on and below the diagonal, within leg l = i / 3 (the
// cone terms of leg l's rows r0 + t in increasing t, dl[t] = d of row r0 + t,
// as the one-QP-per-thread barrier added them): e[b] = entry (i, 3l + b) for
// b <= i - 3l, given the Q entries q[b].
QCT_DEV void qf_leg_block(const QctProb& S, int r0, const float* dl, int a,
                          const float* q, float* e) {
  const float* g0 = S.g0 + r0;
  const float* g1 = S.g1 + r0;
  // (3l, i): a == 0 rows 0, 3 as g0 g0; a == 2 rows 0, 3 as g0 g1.
  const float s0 = (dl[0] * g0[0]) * (a == 0 ? g0[0] : g1[0]);
  const float s3 = (dl[3] * g0[3]) * (a == 0 ? g0[3] : g1[3]);
  e[0] = a == 1 ? q[0] : (q[0] + s0) + s3;
  // (3l + 1, i): a == 1 rows 1, 2 as g0 g0; a == 2 as g0 g1.
  const float s1 = (dl[1] * g0[1]) * (a == 1 ? g0[1] : g1[1]);
  const float s2 = (dl[2] * g0[2]) * (a == 1 ? g0[2] : g1[2]);
  e[1] = (q[1] + s1) + s2;
  // (3l + 2, 3l + 2): rows 0-3 as g1 g1, rows 4, 5 as g0 g0.
  float v = q[2];
  v = v + (dl[0] * g1[0]) * g1[0];
  v = v + (dl[1] * g1[1]) * g1[1];
  v = v + (dl[2] * g1[2]) * g1[2];
  v = v + (dl[3] * g1[3]) * g1[3];
  v = v + (dl[4] * g0[4]) * g0[4];
  v = v + (dl[5] * g0[5]) * g0[5];
  e[2] = v;
}

// L (12 x 12 by rows, diagonal 1 / L_ii) solve, uniform, in registers.
QCT_DEV void qf_chol_solve(const float* L, const float* rhs, float* u) {
  float y[QN];
#pragma unroll
  for (int i = 0; i < QN; ++i) {
    float v = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v = v - L[QN * i + k] * y[k];
    y[i] = v * L[QN * i + i];
  }
#pragma unroll
  for (int i = QN - 1; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < QN; ++k) v = v - L[QN * k + i] * u[k];
    u[i] = v * L[QN * i + i];
  }
}

// dx of the Newton direction whose t = (z r_prim - rc) / s is in T.t
// (uniform): rhs = -r_dual - G^T t, then M dx = rhs by the factor and one
// step of iterative refinement on M - delta I, whose residual lane i < 12
// forms for row i.
QCT_DEV void qf_newton_dx(const QctProb& S, const QFBarrierScratch& T,
                          float delta, float* dx, const QFLane& g) {
  float rhs[QN], v[QN], u[QN];
#pragma unroll
  for (int i = 0; i < QN; ++i) {
    rhs[i] = -T.r_dual[i] - gty(S, T.t, i);
    v[i] = rhs[i];
  }
  for (int pass = 0; pass < 2; ++pass) {
    float w[QN];
    qf_chol_solve(T.L, v, w);
    if (pass == 1) {
#pragma unroll
      for (int i = 0; i < QN; ++i) dx[i] = u[i] + w[i];
      break;
    }
#pragma unroll
    for (int i = 0; i < QN; ++i) u[i] = w[i];
    QF_LANE_VAR(float, rs, 1);
    QF_LANES(lane) {
      float r = 0.0f;
      if (lane < QN) {
        const int i = lane, rb = qf_row_base(i);
        r = qf_pick<QN>(rhs, i);
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          float mij = T.M[qf_iu_rt(i, rb, j)];
          if (j == i) mij = mij - delta;
          r = r - mij * u[j];
        }
      }
      QF_LV(rs)[0] = r;
    }
    QF_LANES(lane) {
#pragma unroll
      for (int k = 0; k < QN; ++k) v[k] = QF_SHFL_LV(rs, 0, k);
    }
  }
}

// ds, dz of the direction dx (rows of the lane) into ds / dz, and the
// lane's partial step ratios (min over its rows of -s/ds, -z/dz where
// negative; Q_BIG else).
QCT_DEV void qf_direction_rows(const QctProb& S, const QFBarrierScratch& T,
                               const float* dx, const float* s,
                               const float* z, int lane, float* ds, float* dz,
                               float& rs, float& rz, bool& fin) {
  rs = Q_BIG;
  rz = Q_BIG;
  fin = true;
  for (int r = lane; r < QM; r += QF_G) {
    const float dsr = -T.r_prim[r] - qf_gx_reg(S, dx, r);
    const float dzr = qf_div(-(T.rc[r] + z[r] * dsr), s[r]);
    ds[r] = dsr;
    dz[r] = dzr;
    bool oka = true, okb = true;
    float ra = qdiv(-s[r], dsr, oka);
    float rb = qdiv(-z[r], dzr, okb);
    if (!oka) ra = -s[r] / dsr;
    if (!okb) rb = -z[r] / dzr;
    rs = qmin(rs, dsr < 0.0f ? ra : Q_BIG);
    rz = qmin(rz, dzr < 0.0f ? rb : Q_BIG);
    fin = fin && qfinite(dsr) && qfinite(dzr);
  }
}

// Jacobi / row / cost scaling of P into S, E (qct_common.cuh's
// equilibrate, each element by the same operations): lane j < 12 the column
// scale Dv_j, then every lane its cone rows and its entries of Q (entry e =
// lane + 16 m of the packed triangle) and lane i < 12 its entry of c, kept
// unscaled by nu in registers until nu = 1 / max |c| is formed, in row
// order, from shuffles.
QCT_DEV void qf_equilibrate(const QctProb& P, QctProb& S, QctScale& E,
                            const QFLane& g) {
  QF_PHASE(lane) {
    if (lane < QN) E.Dv[lane] = qrsqrt(qmax(P.Q[iu(lane, lane)], 1e-12f));
  }
  QF_LANE_VAR(float, cq, 6);  // c_i Dv_i (lane i), then Q entries
  QF_LANES(lane) {
    QF_LV(cq)[0] = lane < QN ? P.c[lane] * E.Dv[lane] : 0.0f;
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const int e = lane + QF_G * m;
      float v = 0.0f;
      if (e < QNU) {
        int i = 0;
        while (iu(i + 1, i + 1) <= e) ++i;
        const int j = i + e - iu(i, i);
        v = P.Q[e] * E.Dv[i] * E.Dv[j];
      }
      QF_LV(cq)[1 + m] = v;
    }
    for (int r = lane; r < QM; r += QF_G) {
      const int leg = r / 6, t = r - 6 * leg;
      const float v0 = P.g0[r] * E.Dv[3 * leg + row_c0(t)];
      float v1 = 0.0f;
      float rn = fabsf(v0);
      if (t < 4) {
        v1 = P.g1[r] * E.Dv[3 * leg + 2];
        rn = qmax(rn, fabsf(v1));
      }
      const float er = qf_div(1.0f, qmax(rn, 1e-12f));
      S.g0[r] = v0 * er;
      S.g1[r] = t < 4 ? v1 * er : 0.0f;
      E.Er[r] = er;
      S.h[r] = P.h[r] * er;
    }
  }
  QF_PHASE(lane) {
    float cmax = fabsf(QF_SHFL_LV(cq, 0, 0));
#pragma unroll
    for (int i = 1; i < QN; ++i) cmax = qmax(cmax, fabsf(QF_SHFL_LV(cq, 0, i)));
    const float nu = qf_div(1.0f, qmax(cmax, 1e-12f));
    if (lane < QN) S.c[lane] = QF_LV(cq)[0] * nu;
    if (lane == 0) E.nu = nu;
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const int e = lane + QF_G * m;
      if (e < QNU) S.Q[e] = QF_LV(cq)[1 + m] * nu;
    }
  }
}

// Sparse-cone Mehrotra loop on the equilibrated problem S. x, s, z (shared)
// hold the warm start on entry when has_init, and the best iterate on
// return.
QCT_DEV void qf_barrier(QFShared& W, const QctProb& S, int iterations,
                        float tau, bool has_init, float* x, float* s,
                        float* z, const QFLane& g) {
  QFBarrierScratch& T = W.w.b;
  const float d_max = 1.0f / Q_EPS;
  QF_PHASE(lane) {
    if (!has_init) {
      for (int i = lane; i < QN; i += QF_G) x[i] = 0.0f;
      for (int r = lane; r < QM; r += QF_G) {
        s[r] = qmax(S.h[r], 1.0f);
        z[r] = 1.0f / s[r];
      }
    }
    for (int i = lane; i < QN; i += QF_G) T.bx[i] = 0.0f;
    for (int r = lane; r < QM; r += QF_G) {
      T.bs[r] = s[r];
      T.bz[r] = z[r];
    }
  }
  float obj_scale, h_scale;
  scales(S, obj_scale, h_scale);
  const float freeze_gap = (100.0f * Q_EPS) * obj_scale;
  const float freeze_pr = (50.0f * Q_EPS) * h_scale;
  const float freeze_dr = (50.0f * Q_EPS) * obj_scale;
  float bmerit = INFINITY;

  for (int it = 0; it < iterations; ++it) {
    // Residuals, the affine centering target; lane i < 12: row i of M.
    QF_LANE_VAR(float, Lr, QN);
    QF_LANE_VAR(float, dg, 1);
    QF_LANES(lane) {
      for (int r = lane; r < QM; r += QF_G) {
        const float rp = gx(S, x, r) + s[r] - S.h[r];
        const float rc = s[r] * z[r];
        T.r_prim[r] = rp;
        T.rc[r] = rc;
        T.t[r] = qf_div(z[r] * rp - rc, s[r]);
      }
      if (lane < QN) {
        const int i = lane, l = i / 3, ai = i - 3 * l, r0 = 6 * l;
        const int rb = qf_row_base(i);
        float q[QN];
#pragma unroll
        for (int j = 0; j < QN; ++j) q[j] = S.Q[qf_iu_rt(i, rb, j)];
        float v = S.c[i];
#pragma unroll
        for (int j = 0; j < QN; ++j) v = v + q[j] * x[j];
        T.r_dual[i] = v + gty(S, z, i);
        float dl[6], ql[3], e[3];
        bool ok = true;
#pragma unroll
        for (int t = 0; t < 6; ++t) dl[t] = qdiv(z[r0 + t], s[r0 + t], ok);
        if (!ok)
          for (int t = 0; t < 6; ++t) dl[t] = z[r0 + t] / s[r0 + t];
#pragma unroll
        for (int t = 0; t < 6; ++t) dl[t] = qmin(dl[t], d_max);
#pragma unroll
        for (int b = 0; b < 3; ++b) ql[b] = S.Q[iu(3 * l + b, 3 * l + b) - b + ai];
        qf_leg_block(S, r0, dl, ai, ql, e);
        float diag = 0.0f;
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          const int b = j - 3 * l;
          float m = j < 3 * l ? q[j] : (b == 0 ? e[0] : (b == 1 ? e[1] : e[2]));
          if (j > i) m = 0.0f;
          if (j == i) diag = m;
          QF_LV(Lr)[j] = m;
        }
        QF_LV(dg)[0] = diag;
      } else {
#pragma unroll
        for (int j = 0; j < QN; ++j) QF_LV(Lr)[j] = 0.0f;
        QF_LV(dg)[0] = 0.0f;
      }
    }
    // The diagonal's maximum in row order, the shift, M into shared memory.
    float delta = 0.0f;
    QF_LANES(lane) {
      float dmx = QF_SHFL_LV(dg, 0, 0);
#pragma unroll
      for (int k = 1; k < QN; ++k) dmx = qmax(dmx, QF_SHFL_LV(dg, 0, k));
      delta = (100.0f * Q_EPS) * dmx;
      if (lane < QN) {
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          if (j == lane) QF_LV(Lr)[j] = QF_LV(Lr)[j] + delta;
          if (j <= lane) T.M[iu(j, lane)] = QF_LV(Lr)[j];
        }
      }
    }
    // Cholesky, right-looking on the rows in the lanes' registers: at pivot
    // k every lane takes the pivot from lane k and column k from the lanes
    // below (scaled by 1/L_kk as lane j scales its own), lane i > k stores
    // L[i][k] and subtracts L[i][k] L[j][k] from its entries j in (k, i].
    // The shuffles need no sync; a pivot is a section of its own because it
    // reads what the last one wrote.
#pragma unroll
    for (int k = 0; k < QN; ++k) {
      QF_LANES(lane) {
        const float ddk = QF_SHFL_LV(Lr, k, k);
        const float dd = ddk > 0.0f ? ddk : qnan();
        const float inv = qf_div(1.0f, sqrtf(dd));
        float col[QN];
#pragma unroll
        for (int j = k + 1; j < QN; ++j) col[j] = QF_SHFL_LV(Lr, k, j) * inv;
        const bool act = lane > k && lane < QN;
        const float lik = QF_LV(Lr)[k] * inv;
#pragma unroll
        for (int j = k + 1; j < QN; ++j) {
          const float nv = QF_LV(Lr)[j] - lik * col[j];
          if (act && j <= lane) QF_LV(Lr)[j] = nv;
        }
        if (act) T.L[QN * lane + k] = lik;
        if (lane == k) T.L[QN * k + k] = inv;
      }
    }
    QF_SYNC();

    float mu = s[0] * z[0];
    for (int r = 1; r < QM; ++r) mu = mu + s[r] * z[r];
    mu = mu * (1.0f / QM);

    // The affine direction (dir 0: rc = s z, set above), then the corrector
    // (dir 1: rc = s z + ds_a dz_a - sigma mu), one code path. The lanes'
    // partial step ratios, residual maxima and finiteness flags reduce by
    // QF_REDUCE (all positive, or flags: no zero of either sign).
    float dx[QN];
    float sigma_mu = 0.0f, ratio_s = Q_BIG, ratio_z = Q_BIG, pr_max = 0.0f;
    bool finite = true, x_finite = true;
    for (int dir = 0; dir < 2; ++dir) {
      if (dir == 1) {
        QF_PHASE(lane) {
          for (int r = lane; r < QM; r += QF_G) {
            const float rc = s[r] * z[r] + T.ds_a[r] * T.dz_a[r] - sigma_mu;
            T.rc[r] = rc;
            T.t[r] = qf_div(z[r] * T.r_prim[r] - rc, s[r]);
          }
        }
      }
      qf_newton_dx(S, T, delta, dx, g);
      float* dsd = dir == 0 ? T.ds_a : T.ds;
      float* dzd = dir == 0 ? T.dz_a : T.dz;
      QF_LANE_VAR(float, part, 5);
      QF_PHASE(lane) {
        float rs, rz;
        bool fin;
        qf_direction_rows(S, T, dx, s, z, lane, dsd, dzd, rs, rz, fin);
        float pm = 0.0f;
        for (int r = lane; r < QM; r += QF_G)
          pm = qmax(pm, fabsf(T.r_prim[r]));
        bool fin_x = true;
        for (int i = lane; i < QN; i += QF_G) fin_x = fin_x && qfinite(x[i]);
        QF_LV(part)[0] = rs;
        QF_LV(part)[1] = rz;
        QF_LV(part)[2] = pm;
        QF_LV(part)[3] = fin ? 1.0f : 0.0f;
        QF_LV(part)[4] = fin_x ? 1.0f : 0.0f;
      }
      QF_REDUCE(ratio_s, part, 0, qmin);
      QF_REDUCE(ratio_z, part, 1, qmin);
      if (dir == 1) {
        float f, fx;
        QF_REDUCE(pr_max, part, 2, qmax);
        QF_REDUCE(f, part, 3, qmin);
        QF_REDUCE(fx, part, 4, qmin);
        finite = f == 1.0f;
        x_finite = fx == 1.0f;
      }
      if (dir == 0) {
        const float a_aff =
            qmin(qmin(1.0f * ratio_s, 1.0f), qmin(1.0f * ratio_z, 1.0f));
        float mu_aff =
            (s[0] + a_aff * T.ds_a[0]) * (z[0] + a_aff * T.dz_a[0]);
        for (int r = 1; r < QM; ++r)
          mu_aff = mu_aff +
                   (s[r] + a_aff * T.ds_a[r]) * (z[r] + a_aff * T.dz_a[r]);
        mu_aff = mu_aff * (1.0f / QM);
        const float ratio = mu_aff / qmax(mu, 1e-30f);
        sigma_mu = ratio * ratio * ratio * mu;
      }
    }
    const float alpha =
        qmin(qmin(tau * ratio_s, 1.0f), qmin(tau * ratio_z, 1.0f));
    float dr_max = fabsf(T.r_dual[0]);
    for (int i = 1; i < QN; ++i) dr_max = qmax(dr_max, fabsf(T.r_dual[i]));
    const bool done =
        (mu < freeze_gap) && (pr_max < freeze_pr) && (dr_max < freeze_dr);
    const float merit = pr_max / h_scale + dr_max / obj_scale + mu / obj_scale;
    const bool take = (merit < bmerit) && x_finite;
    if (take) bmerit = merit;
#pragma unroll
    for (int i = 0; i < QN; ++i) finite = finite && qfinite(dx[i]);
    // a == 0 with a non-finite direction gives 0 * NaN = NaN on purpose:
    // the QP is poisoned and its best iterate stands.
    const float a = (done || !finite) ? 0.0f : alpha;
    QF_PHASE(lane) {
      if (take) {
        for (int i = lane; i < QN; i += QF_G) T.bx[i] = x[i];
        for (int r = lane; r < QM; r += QF_G) {
          T.bs[r] = s[r];
          T.bz[r] = z[r];
        }
      }
      for (int i = lane; i < QN; i += QF_G)
        x[i] = x[i] + a * qf_pick<QN>(dx, i);
      for (int r = lane; r < QM; r += QF_G) {
        s[r] = qmax(s[r] + a * T.ds[r], Q_TINY);
        z[r] = qmax(z[r] + a * T.dz[r], Q_TINY);
      }
    }
  }
  QF_PHASE(lane) {
    for (int i = lane; i < QN; i += QF_G) x[i] = T.bx[i];
    for (int r = lane; r < QM; r += QF_G) {
      s[r] = T.bs[r];
      z[r] = T.bz[r];
    }
  }
}

// Compensated dual residual r1_i = rhs1_i - (Q x)_i - ((aG)^T z)_i.
QCT_DEV float qf_ff_dual(const QctProb& S, const float* a, const float* xp,
                         const float* zp, float rhs1, int i) {
  const int rb = qf_row_base(i);
  FFAcc f;
  f.init();
#pragma unroll
  for (int j = 0; j < QN; ++j) f.add(-1.0f * S.Q[qf_iu_rt(i, rb, j)], xp[j]);
  const int leg = i / 3, col = i - 3 * leg, r0 = 6 * leg;
  if (col == 0) {
    f.add(-(a[r0] * S.g0[r0]), zp[r0]);
    f.add(-(a[r0 + 3] * S.g0[r0 + 3]), zp[r0 + 3]);
  } else if (col == 1) {
    f.add(-(a[r0 + 1] * S.g0[r0 + 1]), zp[r0 + 1]);
    f.add(-(a[r0 + 2] * S.g0[r0 + 2]), zp[r0 + 2]);
  } else {
    for (int t = 0; t < 4; ++t)
      f.add(-(a[r0 + t] * S.g1[r0 + t]), zp[r0 + t]);
    f.add(-(a[r0 + 4] * S.g0[r0 + 4]), zp[r0 + 4]);
    f.add(-(a[r0 + 5] * S.g0[r0 + 5]), zp[r0 + 5]);
  }
  f.add(1.0f, rhs1);
  return f.value();
}

// Plain float32 residual of KKT row R (R < 12: dual row, else primal row R
// - 12) at (xp, zp) with the active set a.
QCT_DEV float qf_plain_residual(const QctProb& S, const float* a,
                                const float* xp, const float* zp, int R) {
  if (R < QN) {
    const int i = R, rb = qf_row_base(i);
    float v = -S.c[i];
#pragma unroll
    for (int j = 0; j < QN; ++j) v = v - S.Q[qf_iu_rt(i, rb, j)] * xp[j];
    const int leg = i / 3, col = i - 3 * leg, r0 = 6 * leg;
    if (col == 0) {
      v = v - a[r0] * S.g0[r0] * zp[r0];
      v = v - a[r0 + 3] * S.g0[r0 + 3] * zp[r0 + 3];
    } else if (col == 1) {
      v = v - a[r0 + 1] * S.g0[r0 + 1] * zp[r0 + 1];
      v = v - a[r0 + 2] * S.g0[r0 + 2] * zp[r0 + 2];
    } else {
      for (int t = 0; t < 4; ++t)
        v = v - a[r0 + t] * S.g1[r0 + t] * zp[r0 + t];
      v = v - a[r0 + 4] * S.g0[r0 + 4] * zp[r0 + 4];
      v = v - a[r0 + 5] * S.g0[r0 + 5] * zp[r0 + 5];
    }
    return v;
  }
  const int r = R - QN;
  return a[r] * S.h[r] - (1.0f - a[r]) * zp[r] - a[r] * gx(S, xp, r);
}

// The same with error-free products and a compensated sum.
QCT_DEV float qf_ff_residual(const QctProb& S, const float* a,
                             const float* xp, const float* zp, int R) {
  if (R < QN) return qf_ff_dual(S, a, xp, zp, -S.c[R], R);
  const int r = R - QN, leg = r / 6, t = r - 6 * leg;
  FFAcc f;
  f.init();
  f.add(1.0f, a[r] * S.h[r]);
  f.add(-(1.0f - a[r]), zp[r]);
  f.add(-(a[r] * S.g0[r]), xp[3 * leg + row_c0(t)]);
  if (t < 4) f.add(-(a[r] * S.g1[r]), xp[3 * leg + 2]);
  return f.value();
}

// Certified active-set polish on the equilibrated problem S. On entry x, s,
// z (shared) hold the starting point and a the active-set guess; on return
// the polished point where it certified. Returns the strict certificate
// (0/1) and adds the sweeps it ran to sweeps_run (a certified QP leaves
// early).
QCT_DEV float qf_polish(QFShared& W, const QctProb& S, int sweeps, int refine,
                        bool multi_swap, bool ff_refine, float* a, float* x,
                        float* s, float* z, const QFLane& g, int& sweeps_run) {
  QFPolishScratch& T = W.w.p;
  const float reg = 1e-4f;
  float obj_scale, h_scale;
  scales(S, obj_scale, h_scale);
  float zmax = z[0];
  for (int r = 1; r < QM; ++r) zmax = qmax(zmax, z[r]);
  const float tol6 = qmax(1e-6f, 30.0f * Q_EPS);
  const float cert_dr = (30.0f * Q_EPS) * obj_scale;
  const float feas_tol = tol6 * h_scale;
  const float z_tol = tol6 * (1.0f + zmax);
  const float* xp = T.xz;
  const float* zp = T.xz + QN;

  float cert = 0.0f;
  for (int sw = 0; sw < sweeps; ++sw) {
    // A certified QP is frozen (point, certificate and active set): it
    // runs along, writing nothing that is read later, until the other QP of
    // its warp is certified too or the sweeps run out.
    if (QF_WARP_ALL(cert > 0.5f)) break;
    const bool active = cert < 0.5f;
    if (active) ++sweeps_run;
    // K = [[Q, (aG)^T], [aG, -(reg a + (1 - a))]], lower triangle, by the
    // lane's KKT rows.
    QF_PHASE(lane) {
      for (int m = 0; m < 3; ++m) {
        const int R = qf_kkt_row(lane, m);
        if (R < 0) continue;
        if (R < QN) {
          for (int j = 0; j <= R; ++j) T.K[qf_col(j) + R - j] = qsym(S.Q, R, j);
        } else {
          const int r = R - QN, leg = r / 6;
          for (int i = 0; i < QN; ++i) {
            bool present = false;
            float gv = 0.0f;
            const int k = i - 3 * leg;
            if (k >= 0 && k < 3) gv = g_entry(S, r, k, present);
            T.K[qf_col(i) + R - i] = present ? a[r] * gv : 0.0f;
          }
          for (int rp = 0; rp < r; ++rp) T.K[qf_col(QN + rp) + R - QN - rp] = 0.0f;
          T.K[qf_col(R)] = -(reg * a[r] + (1.0f - a[r]));
        }
      }
    }
    // LDL^T in shared memory (qct_lanes.cuh), then the solve and `refine`
    // passes of iterative refinement: plain f32 residuals where ff_refine is
    // off and on the first of several passes, error-free residuals else,
    // each formed by the lane of its KKT row.
    qf_ldl_factor(T.K, T.D, g);
    for (int pass = -1; pass < refine; ++pass) {
      const bool plain = !ff_refine || (pass == 0 && refine > 1);
      qf_ldl_solve(T.K, T.D, T.u, T.xz, pass < 0, g, [&](int R) {
        if (pass < 0) return R < QN ? -S.c[R] : a[R - QN] * S.h[R - QN];
        return plain ? qf_plain_residual(S, a, xp, zp, R)
                     : qf_ff_residual(S, a, xp, zp, R);
      });
    }
    // The certificate: dual residual (error-free), slacks, signed
    // multipliers, finiteness.
    QF_PHASE(lane) {
      float drm = 0.0f, smin = INFINITY, zsg = INFINITY;
      bool fin = true;
      for (int R = lane; R < QNK; R += QF_G) {
        if (R < QN) {
          drm = qmax(drm, fabsf(qf_ff_dual(S, a, xp, zp, -S.c[R], R)));
          fin = fin && qfinite(xp[R]);
        } else {
          const int r = R - QN;
          const float sl = S.h[r] - gx(S, xp, r);
          T.slack[r] = sl;
          smin = qmin(smin, sl);
          zsg = qmin(zsg, zp[r] * a[r]);
          fin = fin && qfinite(zp[r]);
        }
      }
      W.red[0][lane] = drm;
      W.red[1][lane] = smin;
      W.red[2][lane] = zsg;
      W.red[3][lane] = fin ? 1.0f : 0.0f;
    }
    float dr_max = 0.0f, slack_min = INFINITY, z_signed = INFINITY;
    bool finite = true;
    for (int l = 0; l < QF_G; ++l) {
      dr_max = qmax(dr_max, W.red[0][l]);
      slack_min = qmin(slack_min, W.red[1][l]);
      z_signed = qmin(z_signed, W.red[2][l]);
      finite = finite && W.red[3][l] != 0.0f;
    }
    const bool ok = finite && (slack_min > -feas_tol) &&
                    (z_signed > -z_tol) && (dr_max < cert_dr);
    const bool accept = ok && active;
    if (ok) cert = 1.0f;
    QF_PHASE(lane) {
      if (accept) {
        for (int i = lane; i < QN; i += QF_G) x[i] = xp[i];
        for (int r = lane; r < QM; r += QF_G) {
          z[r] = qmax(a[r] * zp[r], 0.0f);
          s[r] = qmax(T.slack[r], 0.0f);
        }
      }
    }
    // Only a QP still uncertified swaps.
    const bool swap = cert < 0.5f;
    if (multi_swap) {
      QF_PHASE(lane) {
        for (int r = lane; r < QM && swap; r += QF_G) {
          const bool add_r = (-T.slack[r] > feas_tol) && !(a[r] > 0.5f);
          const bool drop_r = (a[r] > 0.5f) && (zp[r] < -z_tol);
          a[r] = add_r ? 1.0f : (drop_r ? 0.0f : a[r]);
        }
      }
    } else {
      // Add the most violated inactive row, else drop the most negative
      // multiplier: each lane finds the first best of its rows (strict
      // comparisons), then the lanes' winners combine by value and, on
      // ties, by lowest index.
      QF_PHASE(lane) {
        float vb = -Q_BIG, nb = Q_BIG;
        int vi = 0, ni = 0;
        for (int r = lane; r < QM; r += QF_G) {
          const float viol_r = a[r] > 0.5f ? -Q_BIG : -T.slack[r];
          if (viol_r > vb) { vb = viol_r; vi = r; }
          const float nz_r = a[r] > 0.5f ? zp[r] : Q_BIG;
          if (nz_r < nb) { nb = nz_r; ni = r; }
        }
        W.red[4][lane] = vb;
        W.red[5][lane] = (float)vi;
        W.red[6][lane] = nb;
        W.red[7][lane] = (float)ni;
      }
      float viol_best = -Q_BIG, negz_best = Q_BIG;
      int viol_idx = 0, negz_idx = 0;
      for (int l = 0; l < QF_G; ++l) {
        const float vb = W.red[4][l], nb = W.red[6][l];
        const int vi = (int)W.red[5][l], ni = (int)W.red[7][l];
        if (qf_first_max(vb, vi, viol_best, viol_idx)) {
          viol_best = vb;
          viol_idx = vi;
        }
        if (qf_first_min(nb, ni, negz_best, negz_idx)) {
          negz_best = nb;
          negz_idx = ni;
        }
      }
      const bool do_add = swap && viol_best > feas_tol;
      const bool do_drop = swap && !do_add && (negz_best < -z_tol);
      QF_PHASE(lane) {
        if (do_add && viol_idx % QF_G == lane) a[viol_idx] = 1.0f;
        else if (do_drop && negz_idx % QF_G == lane) a[negz_idx] = 0.0f;
      }
    }
  }
  return cert;
}

// Loose KKT criterion of problem P at (x, s, z) (shared) in P's units; also
// returns the residuals. Uses the reduction slots rs, rs + 1.
QCT_DEV bool qf_kkt_flags(QFShared& W, const QctProb& P, const float* x,
                          const float* s, const float* z, float tol, int rs,
                          float& pr, float& dr, float& gap,
                          const QFLane& g) {
  QF_PHASE(lane) {
    float pm = 0.0f, dm = 0.0f;
    for (int r = lane; r < QM; r += QF_G)
      pm = qmax(pm, fabsf(gx(P, x, r) + s[r] - P.h[r]));
    if (lane < QN) {
      const int i = lane, rb = qf_row_base(i);
      float v = P.c[i];
#pragma unroll
      for (int j = 0; j < QN; ++j) v = v + P.Q[qf_iu_rt(i, rb, j)] * x[j];
      // (G^T z)_i accumulated term by term onto v, rows in increasing order.
      const int leg = i / 3, col = i - 3 * leg, r0 = 6 * leg;
      if (col == 0) {
        v = v + P.g0[r0] * z[r0];
        v = v + P.g0[r0 + 3] * z[r0 + 3];
      } else if (col == 1) {
        v = v + P.g0[r0 + 1] * z[r0 + 1];
        v = v + P.g0[r0 + 2] * z[r0 + 2];
      } else {
        for (int t = 0; t < 4; ++t) v = v + P.g1[r0 + t] * z[r0 + t];
        v = v + P.g0[r0 + 4] * z[r0 + 4];
        v = v + P.g0[r0 + 5] * z[r0 + 5];
      }
      dm = fabsf(v);
    }
    W.red[rs][lane] = pm;
    W.red[rs + 1][lane] = dm;
  }
  gap = s[0] * z[0];
  for (int r = 1; r < QM; ++r) gap = gap + s[r] * z[r];
  gap = fabsf(gap) * (1.0f / QM);
  pr = 0.0f;
  dr = 0.0f;
  for (int l = 0; l < QF_G; ++l) {
    pr = qmax(pr, W.red[rs][l]);
    dr = qmax(dr, W.red[rs + 1][l]);
  }
  float cmax = fabsf(P.c[0]);
  float hmax = fabsf(P.h[0]);
  for (int i = 1; i < QN; ++i) cmax = qmax(cmax, fabsf(P.c[i]));
  for (int r = 1; r < QM; ++r) hmax = qmax(hmax, fabsf(P.h[r]));
  const float scale = 1.0f + cmax;
  return (pr < tol * (1.0f + hmax)) && (dr < tol * scale) &&
         (gap < tol * scale);
}

// The whole solve of QP slot `slot` (body of the TPU _fused_kernel). POLISH
// is the compile-time switch of the polish / prox stages. A slot past B
// runs along on QP B - 1 and writes nothing.
template <bool POLISH>
QCT_DEV void fused_lanes(const QctIO& io, int B, int slot, const QctParams& p,
                         QFShared& W, const QFLane& g) {
  const bool live = slot < B;
  const int i = live ? slot : B - 1;
  QF_PHASE(lane) {
    if (lane == 0) load_problem(io, B, i, p, W.st, W.P);
  }
  qf_equilibrate(W.P, W.S, W.E, g);

  float cert = 0.0f, acc = 0.0f, rho = 0.0f;
  int iters_run = 0, sweeps_run = 0;
  // Stage -1 is the solve proper; stages 0 .. prox_steps - 1 are the
  // proximal restarts (POLISH only), each a barrier and a polish of the
  // regularized problem Sp from the prox iterate. One code path serves all.
  const int stages = POLISH ? p.prox_steps : 0;
  for (int step = -1; step < stages; ++step) {
    const bool prox = step >= 0;
    const QctProb& Sx = prox ? W.Sp : W.S;
    float* xx = prox ? W.xq : W.x;
    float* sx = prox ? W.sq : W.s;
    float* zx = prox ? W.zq : W.z;
    const float interior = 1e-2f;
    bool has_init = false;
    if (prox) {
      // rho is UNIFORM in original units: rho = prox_rho * mean(diag
      // Q_orig), diag_i = 1 / Dv_i^2. The regularized problem, equilibrated
      // anew, and (warm) the prox iterate in its coordinates.
      QctProb& Pp = W.w.pp;
      QF_PHASE(lane) {
        for (int e = lane; e < QNU; e += QF_G) Pp.Q[e] = W.P.Q[e];
        for (int r = lane; r < QM; r += QF_G) {
          Pp.g0[r] = W.P.g0[r];
          Pp.g1[r] = W.P.g1[r];
          Pp.h[r] = W.P.h[r];
        }
      }
      QF_PHASE(lane) {
        if (lane < QN) {
          Pp.Q[iu(lane, lane)] = W.P.Q[iu(lane, lane)] + rho;
          Pp.c[lane] = W.P.c[lane] - rho * W.xko[lane];
        }
      }
      qf_equilibrate(Pp, W.Sp, W.Ep, g);
      if (!p.prox_cold) {
        QF_PHASE(lane) {
          for (int k = lane; k < QN; k += QF_G)
            W.xq[k] = W.xko[k] / W.Ep.Dv[k];
          for (int r = lane; r < QM; r += QF_G) {
            W.sq[r] = qmax(W.sko[r] * W.Ep.Er[r], interior);
            W.zq[r] =
                qmax(W.zko[r] * W.Ep.nu / W.Ep.Er[r], interior / W.sq[r]);
          }
        }
        has_init = true;
      }
    } else if (p.iterations > 0 && p.warm_mode == 4) {
      // Original units -> equilibrated coordinates, the interior shift, and
      // the cold reset of the cone rows of legs whose stance flipped.
      QF_PHASE(lane) {
        for (int k = lane; k < QN; k += QF_G)
          W.x[k] = io.xw[(size_t)k * B + i] / W.E.Dv[k];
        for (int r = lane; r < QM; r += QF_G) {
          const float sin_ = io.sw[(size_t)r * B + i];
          const float zin_ = io.zw[(size_t)r * B + i];
          const int leg = r / 6;
          const bool reset =
              fabsf(W.st[leg] - io.stprev[(size_t)leg * B + i]) > 0.5f;
          const float s_cold = qmax(W.S.h[r], 1.0f);
          W.s[r] = reset ? s_cold : qmax(sin_ * W.E.Er[r], interior);
          W.z[r] = reset ? 1.0f / s_cold
                         : qmax(zin_ * W.E.nu / W.E.Er[r], interior);
          // Previous active set (original-units z > s); -1 marks reset rows.
          W.a[r] = reset ? -1.0f : (zin_ > sin_ ? 1.0f : 0.0f);
        }
      }
      has_init = true;
    }
    if (prox || p.iterations > 0) {
      const int its = prox ? p.prox_iterations : p.iterations;
      qf_barrier(W, Sx, its, p.tau, has_init, xx, sx, zx, g);
      iters_run += its;
    } else {
      // Polish-only: the warm (x, s, z) in original units seed the polish.
      QF_PHASE(lane) {
        for (int k = lane; k < QN; k += QF_G)
          W.x[k] = io.xw[(size_t)k * B + i] / W.E.Dv[k];
        for (int r = lane; r < QM; r += QF_G) {
          W.s[r] = qmax(io.sw[(size_t)r * B + i] * W.E.Er[r], 1e-30f);
          W.z[r] =
              qmax(io.zw[(size_t)r * B + i] * W.E.nu / W.E.Er[r], 1e-30f);
        }
      }
    }
    if (!POLISH) break;

    // The active-set guess: the barrier's heuristic z > s, or (warm
    // barrier) the previous active set where its rows were not reset. The
    // prox steps polish the REGULARIZED subproblem (strongly convex: its
    // active-set search is not defeated in f32), without float-float
    // refinement.
    const bool have_a = !prox && p.iterations > 0 && p.warm_mode == 4;
    QF_PHASE(lane) {
      for (int r = lane; r < QM; r += QF_G) {
        const float heur = zx[r] > sx[r] ? 1.0f : 0.0f;
        W.a[r] = (have_a && !(W.a[r] < -0.5f)) ? W.a[r] : heur;
      }
    }
    const float cert_step = qf_polish(
        W, Sx, prox ? p.prox_sweeps : p.sweeps, p.refine, p.multi_swap != 0,
        !prox && p.ff_refine != 0, W.a, xx, sx, zx, g, sweeps_run);

    if (!prox) {
      cert = cert_step;
      if (p.prox_steps == 0) break;
      float mean_diag = 0.0f;
      for (int k = 0; k < QN; ++k)
        mean_diag = mean_diag + 1.0f / (W.E.Dv[k] * W.E.Dv[k]);
      mean_diag = mean_diag * (1.0f / QN);
      rho = p.prox_rho * mean_diag;
      QF_PHASE(lane) {
        for (int k = lane; k < QN; k += QF_G) W.xko[k] = W.x[k] * W.E.Dv[k];
        for (int r = lane; r < QM; r += QF_G) {
          W.sko[r] = W.s[r] / W.E.Er[r];
          W.zko[r] = W.z[r] * W.E.Er[r] / W.E.nu;
        }
      }
      acc = cert > 0.5f ? 1.0f : 0.0f;
      continue;
    }
    // Primed coords -> original -> the outer equilibrated coords.
    QF_PHASE(lane) {
      const float inv_nu2 = 1.0f / W.E.nu;
      for (int k = lane; k < QN; k += QF_G) {
        W.xko[k] = W.xq[k] * W.Ep.Dv[k];
        W.xq[k] = W.xko[k] / W.E.Dv[k];
        W.xo[k] = W.xq[k] * W.E.Dv[k];
      }
      for (int r = lane; r < QM; r += QF_G) {
        W.sko[r] = W.sq[r] / W.Ep.Er[r];
        W.zko[r] = W.zq[r] * W.Ep.Er[r] / W.Ep.nu;
        W.sq[r] = qmax(W.sko[r] * W.E.Er[r], 1e-30f);
        W.zq[r] = qmax(W.zko[r] * W.E.nu / W.E.Er[r], 1e-30f);
        W.zo[r] = W.zq[r] * W.E.Er[r] * inv_nu2;
        W.so[r] = W.sq[r] / W.E.Er[r];
      }
    }
    // Accept on the loose ORIGINAL-KKT criterion.
    float pr2, dr2, gap2;
    const bool take = qf_kkt_flags(W, W.P, W.xo, W.so, W.zo, p.tol, 0, pr2,
                                   dr2, gap2, g) &&
                      acc < 0.5f;
    QF_PHASE(lane) {
      if (take) {
        for (int k = lane; k < QN; k += QF_G) W.x[k] = W.xq[k];
        for (int r = lane; r < QM; r += QF_G) {
          W.s[r] = W.sq[r];
          W.z[r] = W.zq[r];
        }
      }
    }
    if (take) acc = 1.0f;
  }

  // Map back to original units, the outputs and the diagnostics.
  QF_PHASE(lane) {
    const float inv_nu = 1.0f / W.E.nu;
    for (int k = lane; k < QN; k += QF_G) {
      W.xo[k] = W.x[k] * W.E.Dv[k];
      if (live) io.x[(size_t)k * B + i] = W.xo[k];
    }
    for (int r = lane; r < QM; r += QF_G) {
      W.zo[r] = W.z[r] * W.E.Er[r] * inv_nu;
      W.so[r] = W.s[r] / W.E.Er[r];
      if (live) {
        io.s[(size_t)r * B + i] = W.so[r];
        io.z[(size_t)r * B + i] = W.zo[r];
      }
    }
  }
  float pr, dr, gap, pr_s, dr_s, gap_s;
  bool conv = qf_kkt_flags(W, W.P, W.xo, W.so, W.zo, p.tol, 0, pr, dr, gap, g);
  conv = conv || (cert > 0.5f);
  // Scaled-units criterion (the residuals the barrier actually controls).
  conv = qf_kkt_flags(W, W.S, W.x, W.s, W.z, p.tol, 2, pr_s, dr_s, gap_s, g) ||
         conv;
  QF_LANES(lane) {
    if (live && lane == 0) {
      io.diag[i] = cert;
      io.diag[(size_t)B + i] = conv ? 1.0f : 0.0f;
      io.diag[(size_t)2 * B + i] = pr;
      io.diag[(size_t)3 * B + i] = dr;
      io.diag[(size_t)4 * B + i] = gap;
      io.diag[(size_t)5 * B + i] = 0.0f;
      if (io.work != nullptr) {
        io.work[i] = iters_run;
        io.work[(size_t)B + i] = sweeps_run;
      }
    }
  }
}
