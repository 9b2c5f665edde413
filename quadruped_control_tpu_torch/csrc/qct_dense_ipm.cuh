// K3a and K3b: the dense batched QP solve (n = 12, m = 24). K3a runs one
// instance per thread; K3b one QP per group of 16 lanes (qct_lanes.cuh).
//
// Replaces the TPU kernel bodies of quadruped_control_tpu/solver/
// pallas_ipm.py: _kernel (K3a, the fixed-iteration Mehrotra barrier on the
// dense equilibrated problem) and _polish_kernel (K3b, the certified
// active-set polish). The plain PyTorch versions are
// solver/fused_ipm.py::_dense_barrier_plain and ::_dense_polish_plain: the
// same statements in the same order (no FMA contraction: the library is
// built with -fmad=false), so a kernel and its plain version agree to the
// rounding of the few library operations whose implementations differ (K3b
// has none of them: it is bitwise its plain version).
//
// Problem data (k, B), component-major: Q (144, B) row-major, c (12, B),
// G (288, B) row-major, h (24, B), all equilibrated. K3a reads Q and G
// (432 words an instance) from device memory at each use: a warp's 32
// lanes touch one 128-byte line per access, and an instance's data stays in
// L1 / L2 for the whole launch; c and h live in per-thread arrays. K3b's
// block stages its QPs' problems and points into shared memory first
// (QDShared, qd_stage_in) and writes its outputs from there.
//
// NaN. Every max/min goes through qmax/qmin (qct_common.cuh), which
// propagate NaN as torch.maximum / jnp.maximum do; a non-positive Cholesky
// pivot becomes NaN (1.0f / sqrtf of it follows), a skipped step multiplies
// it by 0 and keeps it, and the best-iterate tracking holds the last finite
// point. A poisoned QP of K3b stays poisoned in its own group of lanes.
#pragma once

#include "qct_lanes.cuh"

// Pointers of one launch (element k of instance i at ptr[k * B + i]).
struct QctDenseIO {
  const float* Q;
  const float* c;
  const float* G;
  const float* h;
  const float* x_in;  // polish only: the barrier's point
  const float* s_in;
  const float* z_in;
  float* x;
  float* s;
  float* z;
  float* cert;  // polish only (B)
};

#define QD_SWEEPS 8  // _POLISH_SWEEPS_PALLAS
#define QD_REFINE 4  // _POLISH_REFINE

// obj_scale and h_scale as the TPU kernels form them: the max starts from
// c[0] * 0 + 1, so a lane whose c[0] (h[0]) is not finite has a NaN scale.
QCT_DEV void dense_scales(const float* c, const float* h, float& obj_scale,
                          float& h_scale) {
  obj_scale = c[0] * 0.0f + 1.0f;
  for (int i = 0; i < QN; ++i) obj_scale = qmax(obj_scale, 1.0f + fabsf(c[i]));
  h_scale = h[0] * 0.0f + 1.0f;
  for (int r = 0; r < QM; ++r) h_scale = qmax(h_scale, 1.0f + fabsf(h[r]));
}

// (G v)_r accumulated over j in increasing order.
#define QD_GX(G, v, r, out)                                 \
  do {                                                      \
    float acc_ = G[(size_t)((r) * QN) * B] * (v)[0];        \
    for (int j_ = 1; j_ < QN; ++j_)                         \
      acc_ = acc_ + G[(size_t)((r) * QN + j_) * B] * (v)[j_]; \
    out = acc_;                                             \
  } while (0)

QCT_DEV_NOINLINE void dense_barrier_instance(const QctDenseIO& io, int B,
                                             int inst, int iterations,
                                             float tau) {
  const float* Q = io.Q + inst;  // Q[(i * 12 + j) * B]
  const float* G = io.G + inst;  // G[(r * 12 + j) * B]
  const float d_max = 1.0f / Q_EPS;
  float c[QN], h[QM];
  for (int i = 0; i < QN; ++i) c[i] = io.c[(size_t)i * B + inst];
  for (int r = 0; r < QM; ++r) h[r] = io.h[(size_t)r * B + inst];

  float x[QN], s[QM], z[QM];
  for (int i = 0; i < QN; ++i) x[i] = 0.0f;
  for (int r = 0; r < QM; ++r) {
    s[r] = qmax(h[r], 1.0f);
    z[r] = 1.0f / s[r];
  }
  float obj_scale, h_scale;
  dense_scales(c, h, obj_scale, h_scale);
  const float freeze_gap = (100.0f * Q_EPS) * obj_scale;
  const float freeze_pr = (50.0f * Q_EPS) * h_scale;
  const float freeze_dr = (50.0f * Q_EPS) * obj_scale;

  float bx[QN], bs[QM], bz[QM];
  float bmerit = INFINITY;
  for (int i = 0; i < QN; ++i) bx[i] = 0.0f;
  for (int r = 0; r < QM; ++r) { bs[r] = s[r]; bz[r] = z[r]; }

  float Mm[QNU];
  float L[QN][QN];
  float r_prim[QM], r_dual[QN], d[QM], rc[QM], t[QM], rhs[QN];
  float dx_a[QN], ds_a[QM], dz_a[QM], dx[QN], ds[QM], dz[QM];

  for (int it = 0; it < iterations; ++it) {
    for (int r = 0; r < QM; ++r) {
      float gx;
      QD_GX(G, x, r, gx);
      r_prim[r] = gx + s[r] - h[r];
    }
    for (int i = 0; i < QN; ++i) {
      float v = c[i];
      for (int j = 0; j < QN; ++j) v = v + Q[(size_t)(i * QN + j) * B] * x[j];
      for (int r = 0; r < QM; ++r) v = v + G[(size_t)(r * QN + i) * B] * z[r];
      r_dual[i] = v;
    }
    for (int r = 0; r < QM; ++r) d[r] = qmin(z[r] / s[r], d_max);

    // M = Q + G^T D G, upper triangle.
    for (int i = 0; i < QN; ++i) {
      for (int j = i; j < QN; ++j) {
        float v = Q[(size_t)(i * QN + j) * B];
        for (int r = 0; r < QM; ++r)
          v = v + G[(size_t)(r * QN + i) * B] * d[r]
                      * G[(size_t)(r * QN + j) * B];
        Mm[iu(i, j)] = v;
      }
    }
    float diag_max = Mm[iu(0, 0)];
    for (int i = 1; i < QN; ++i) diag_max = qmax(diag_max, Mm[iu(i, i)]);
    const float delta = (100.0f * Q_EPS) * diag_max;
    for (int i = 0; i < QN; ++i) Mm[iu(i, i)] = Mm[iu(i, i)] + delta;

    // Cholesky storing 1/L_jj on the diagonal.
    for (int j = 0; j < QN; ++j) {
      float dd = Mm[iu(j, j)];
      for (int k = 0; k < j; ++k) dd = dd - L[j][k] * L[j][k];
      dd = dd > 0.0f ? dd : qnan();
      const float inv = qrsqrt(dd);
      L[j][j] = inv;
      for (int i = j + 1; i < QN; ++i) {
        float v = Mm[iu(j, i)];
        for (int k = 0; k < j; ++k) v = v - L[i][k] * L[j][k];
        L[i][j] = v * inv;
      }
    }

    float mu = s[0] * z[0];
    for (int r = 1; r < QM; ++r) mu = mu + s[r] * z[r];
    mu = mu * (1.0f / QM);

    // The two Newton directions: the affine one (rc = s z), then the
    // corrector. kkt_solve refines once against M without delta.
    for (int pass = 0; pass < 2; ++pass) {
      float* ddx = pass == 0 ? dx_a : dx;
      float* dds = pass == 0 ? ds_a : ds;
      float* ddz = pass == 0 ? dz_a : dz;
      if (pass == 0) {
        for (int r = 0; r < QM; ++r) rc[r] = s[r] * z[r];
      } else {
        const float a_aff =
            qmin(max_step(s, ds_a, 1.0f), max_step(z, dz_a, 1.0f));
        float mu_aff = (s[0] + a_aff * ds_a[0]) * (z[0] + a_aff * dz_a[0]);
        for (int r = 1; r < QM; ++r)
          mu_aff = mu_aff + (s[r] + a_aff * ds_a[r]) * (z[r] + a_aff * dz_a[r]);
        mu_aff = mu_aff * (1.0f / QM);
        const float ratio = mu_aff / qmax(mu, 1e-30f);
        const float sigma_mu = ratio * ratio * ratio * mu;
        for (int r = 0; r < QM; ++r)
          rc[r] = s[r] * z[r] + ds_a[r] * dz_a[r] - sigma_mu;
      }
      for (int r = 0; r < QM; ++r) t[r] = (z[r] * r_prim[r] - rc[r]) / s[r];
      for (int i = 0; i < QN; ++i) {
        float v = -r_dual[i];
        for (int r = 0; r < QM; ++r) v = v - G[(size_t)(r * QN + i) * B] * t[r];
        rhs[i] = v;
      }
      kkt_solve(Mm, delta, L, rhs, ddx);
      for (int r = 0; r < QM; ++r) {
        float gdx;
        QD_GX(G, ddx, r, gdx);
        dds[r] = -r_prim[r] - gdx;
        ddz[r] = -(rc[r] + z[r] * dds[r]) / s[r];
      }
    }
    const float alpha = qmin(max_step(s, ds, tau), max_step(z, dz, tau));

    float pr_max = fabsf(r_prim[0]);
    float dr_max = fabsf(r_dual[0]);
    for (int r = 1; r < QM; ++r) pr_max = qmax(pr_max, fabsf(r_prim[r]));
    for (int i = 1; i < QN; ++i) dr_max = qmax(dr_max, fabsf(r_dual[i]));
    const bool done =
        (mu < freeze_gap) && (pr_max < freeze_pr) && (dr_max < freeze_dr);

    // Best iterate by scaled KKT merit (a NaN merit never wins).
    const float merit = pr_max / h_scale + dr_max / obj_scale + mu / obj_scale;
    bool x_finite = true;
    for (int i = 0; i < QN; ++i) x_finite = x_finite && qfinite(x[i]);
    if ((merit < bmerit) && x_finite) {
      for (int i = 0; i < QN; ++i) bx[i] = x[i];
      for (int r = 0; r < QM; ++r) { bs[r] = s[r]; bz[r] = z[r]; }
      bmerit = merit;
    }

    bool finite = true;
    for (int i = 0; i < QN; ++i) finite = finite && qfinite(dx[i]);
    for (int r = 0; r < QM; ++r)
      finite = finite && qfinite(ds[r]) && qfinite(dz[r]);
    // a == 0 with a non-finite direction gives 0 * NaN = NaN on purpose.
    const float a = (done || !finite) ? 0.0f : alpha;
    for (int i = 0; i < QN; ++i) x[i] = x[i] + a * dx[i];
    for (int r = 0; r < QM; ++r) {
      s[r] = qmax(s[r] + a * ds[r], Q_TINY);
      z[r] = qmax(z[r] + a * dz[r], Q_TINY);
    }
  }
  for (int i = 0; i < QN; ++i) io.x[(size_t)i * B + inst] = bx[i];
  for (int r = 0; r < QM; ++r) {
    io.s[(size_t)r * B + inst] = bs[r];
    io.z[(size_t)r * B + inst] = bz[r];
  }
}

// ---------------------------------------------------------------------------
// K3b: one QP on a group of QF_G = 16 lanes (qct_lanes.cuh), its state in
// shared memory.
// ---------------------------------------------------------------------------

// K3b's __launch_bounds__: a block is one warp (two QPs), 16 blocks an SM
// at <= 128 registers. Other sizes build with -D of both
// (scripts/torch_dense_polish_blocks.py times them).
#ifndef QD_MAX_THREADS
#define QD_MAX_THREADS 32
#define QD_MIN_BLOCKS 16
#endif
#define QD_LD 13    // row stride of Q and G in shared memory
#define QD_IN 528   // words a QP reads: Q 144, G 288, c 12, h 24, x, s, z 60
#define QD_OUT 61   // words a QP writes: x, s, z 60, cert

// One QP's state. Q and G by rows of 13 words: a lane per row (stride 13)
// and a lane per column (stride 1) both hit 16 different banks, and so do
// the two QPs of a warp (the state is 16 words mod 32). The KKT matrix is
// stored by columns (qf_col). c | h | bx | bs | bz | cert lie in the order
// of the launch's inputs after G and of its outputs.
struct QDShared {
  float Q[QN * QD_LD];  // Q[i][j] at i * 13 + j
  float G[QM * QD_LD];  // G[r][j] at r * 13 + j
  float c[QN], h[QM];
  float bx[QN], bs[QM], bz[QM];  // the barrier's point, then the polished
  float cert;
  float a[QM];      // the active set
  float K[QTRI];    // KKT lower triangle by columns, becomes L
  float D[QNK];     // the LDL^T's pivots
  float u[QNK];     // a refinement's residual, a solve's D^-1 L^-1 rhs
  float xz[QNK];    // the polished point xp | zp
  float slack[QM];
  float pad[5];
};
static_assert(sizeof(QDShared) / sizeof(float) % 32 == 16,
              "a QP's state is 16 words mod 32 (banks)");
static_assert(offsetof(QDShared, G) == QN * QD_LD * sizeof(float) &&
                  offsetof(QDShared, c) == (QN + QM) * QD_LD * sizeof(float) &&
                  offsetof(QDShared, cert) ==
                      offsetof(QDShared, bx) + 60 * sizeof(float),
              "inputs and outputs lie in launch order");

// What the launch geometry is made from (kernels.dense_launch_geometry):
// lanes per QP, threads a block at most, shared words per QP.
static inline void qd_layout(int* out) {
  out[0] = QF_G;
  out[1] = QD_MAX_THREADS;
  out[2] = (int)(sizeof(QDShared) / sizeof(float));
}

// Thread t of nt stages the inputs of nq QP slots from slot0 into W[0 ..
// nq) (a slot past B takes QP B - 1; nt a multiple of nq). Threads t and t +
// 1 read element k of neighbouring QPs, so a load of the block's nq QPs
// reads nq consecutive words of the (k, B) layout.
QCT_DEV void qd_stage_in(const QctDenseIO& io, int B, int slot0, int nq,
                         QDShared* W, int t, int nt) {
  const int q = t % nq, dk = nt / nq;
  const int i = slot0 + q < B ? slot0 + q : B - 1;
  float* w = reinterpret_cast<float*>(W + q);
  for (int k = t / nq; k < QD_IN; k += dk) {
    const float* src;
    int kk = k;
    if (k < 144) {
      src = io.Q;
    } else if (k < 432) {
      src = io.G;
      kk = k - 144;
    } else if (k < 444) {
      src = io.c;
      kk = k - 432;
    } else if (k < 468) {
      src = io.h;
      kk = k - 444;
    } else if (k < 480) {
      src = io.x_in;
      kk = k - 468;
    } else if (k < 504) {
      src = io.s_in;
      kk = k - 480;
    } else {
      src = io.z_in;
      kk = k - 504;
    }
    // Q and G: row k / 12 of both at 13 words a row; then c, h, x, s, z.
    const int off = k < 432 ? k + k / QN : k + QN + QM;
    w[off] = src[(size_t)kk * B + i];
  }
}

// Thread t of nt writes the outputs (x, s, z, cert) of the slots below B.
QCT_DEV void qd_stage_out(const QctDenseIO& io, int B, int slot0, int nq,
                          const QDShared* W, int t, int nt) {
  const int q = t % nq, dk = nt / nq, i = slot0 + q;
  if (i >= B) return;
  const float* w = W[q].bx;
  for (int k = t / nq; k < QD_OUT; k += dk) {
    float* dst = k < QN ? io.x + (size_t)k * B
                 : k < QN + QM ? io.s + (size_t)(k - QN) * B
                 : k < QN + 2 * QM ? io.z + (size_t)(k - QN - QM) * B
                                   : io.cert;
    dst[i] = w[k];
  }
}

// The certified polish of one QP (body of the TPU _polish_kernel) on its
// staged state W: the barrier's point in bx, bs, bz on entry, the polished
// point (where a sweep certified) and cert on return. Per sweep the EQP KKT
// K = [[Q, (aG)^T], [aG, -R]] with R = reg a + (1 - a), stored as a lower
// triangle that holds, at (i, j) with i >= j, the UPPER original K[j][i]
// (the TPU kernel's loop LDL^T reads the originals from the upper copy of
// its scratch: Q of the dense problem need not be bitwise symmetric after
// equilibration), its LDL^T, the solve and QD_REFINE refinements against
// the reg-free system (plain float32 residuals), the Dekker-compensated
// stationarity residual, the certificate, and the swap. Sections: the
// lanes' KKT rows (qf_kkt_row) build K; lane i < 12 forms dual row i of a
// residual, the compensated row i and checks xp_i, lane r % 16 primal row
// r and slack row r; reductions (the swap's argmax / argmin too) by
// butterflies. The first certified sweep is latched and the
// active set frozen: a certified QP runs along, writing nothing that is read
// later, until its warp-mate is certified too or the sweeps run out.
QCT_DEV void dense_polish_lanes(QDShared& W, const QFLane& g) {
  const float reg = 1e-4f;
  float obj_scale, h_scale;
  dense_scales(W.c, W.h, obj_scale, h_scale);
  float zmax = W.bz[0];
  for (int r = 1; r < QM; ++r) zmax = qmax(zmax, W.bz[r]);
  const float tol6 = qmax(1e-6f, 30.0f * Q_EPS);
  const float cert_dr = (30.0f * Q_EPS) * obj_scale;
  const float feas_tol = tol6 * h_scale;
  const float z_tol = tol6 * (1.0f + zmax);
  const float* Q = W.Q;
  const float* G = W.G;
  const float* a = W.a;
  const float* xp = W.xz;
  const float* zp = W.xz + QN;
  QF_PHASE(lane) {
    for (int r = lane; r < QM; r += QF_G) W.a[r] = W.bz[r] > W.bs[r] ? 1.0f : 0.0f;
  }

  float cert = 0.0f;
  for (int sw = 0; sw < QD_SWEEPS; ++sw) {
    if (QF_WARP_ALL(cert > 0.5f)) break;
    const bool active = cert < 0.5f;
    QF_PHASE(lane) {
      for (int m = 0; m < 3; ++m) {
        const int R = qf_kkt_row(lane, m);
        if (R < 0) continue;
        if (R < QN) {
          for (int j = 0; j <= R; ++j) W.K[qf_col(j) + R - j] = Q[j * QD_LD + R];
        } else {
          const int r = R - QN;
          for (int i = 0; i < QN; ++i)
            W.K[qf_col(i) + R - i] = a[r] * G[r * QD_LD + i];
          for (int rp = 0; rp < r; ++rp) W.K[qf_col(QN + rp) + R - QN - rp] = 0.0f;
          W.K[qf_col(R)] = -(reg * a[r] + (1.0f - a[r]));
        }
      }
    }
    qf_ldl_factor(W.K, W.D, g);
    for (int pass = -1; pass < QD_REFINE; ++pass) {
      if (pass >= 0) {
        // The residual of the reg-free system at xp | zp into u.
        QF_PHASE(lane) {
          if (lane < QN) {
            const int i = lane;
            float v = -W.c[i];
#pragma unroll
            for (int j = 0; j < QN; ++j) v = v - Q[i * QD_LD + j] * xp[j];
#pragma unroll
            for (int r = 0; r < QM; ++r) v = v - a[r] * G[r * QD_LD + i] * zp[r];
            W.u[i] = v;
          }
          for (int r = lane; r < QM; r += QF_G) {
            float v = a[r] * W.h[r] - (1.0f - a[r]) * zp[r];
#pragma unroll
            for (int j = 0; j < QN; ++j) v = v - a[r] * G[r * QD_LD + j] * xp[j];
            W.u[QN + r] = v;
          }
        }
      }
      qf_ldl_solve(W.K, W.D, W.u, W.xz, pass < 0, g, [&](int R) {
        if (pass < 0) return R < QN ? -W.c[R] : a[R - QN] * W.h[R - QN];
        return W.u[R];
      });
    }

    // Certification: Dekker-compensated stationarity residual, slacks,
    // signed multipliers, finiteness.
    QF_LANE_VAR(float, part, 4);
    QF_PHASE(lane) {
      float drm = 0.0f, smin = INFINITY, zsg = INFINITY;
      bool fin = true;
      if (lane < QN) {
        const int i = lane;
        FFAcc f;
        f.init();
#pragma unroll
        for (int j = 0; j < QN; ++j) f.add(-1.0f * Q[i * QD_LD + j], xp[j]);
#pragma unroll
        for (int r = 0; r < QM; ++r) f.add(-(a[r] * G[r * QD_LD + i]), zp[r]);
        f.add(1.0f, -W.c[i]);
        drm = fabsf(f.value());
        fin = qfinite(xp[i]);
      }
      for (int r = lane; r < QM; r += QF_G) {
        float v = W.h[r];
#pragma unroll
        for (int j = 0; j < QN; ++j) v = v - G[r * QD_LD + j] * xp[j];
        W.slack[r] = v;
        smin = qmin(smin, v);
        zsg = qmin(zsg, zp[r] * a[r]);
        fin = fin && qfinite(zp[r]);
      }
      QF_LV(part)[0] = drm;
      QF_LV(part)[1] = smin;
      QF_LV(part)[2] = zsg;
      QF_LV(part)[3] = fin ? 1.0f : 0.0f;
    }
    float dr_max, slack_min, z_signed, fin;
    QF_REDUCE(dr_max, part, 0, qmax);
    QF_REDUCE(slack_min, part, 1, qmin);
    QF_REDUCE(z_signed, part, 2, qmin);
    QF_REDUCE(fin, part, 3, qmin);
    const bool ok = fin == 1.0f && (slack_min > -feas_tol) &&
                    (z_signed > -z_tol) && (dr_max < cert_dr);
    const bool accept = ok && active;
    if (ok) cert = 1.0f;

    // Take the point (the first certified sweep); each lane's first
    // winners for the swap: the most violated inactive row and the most
    // negative multiplier (strict comparisons).
    QF_LANE_VAR(float, win, 4);
    QF_PHASE(lane) {
      if (accept) {
        for (int i = lane; i < QN; i += QF_G) W.bx[i] = xp[i];
        for (int r = lane; r < QM; r += QF_G) {
          W.bz[r] = qmax(a[r] * zp[r], 0.0f);
          W.bs[r] = qmax(W.slack[r], 0.0f);
        }
      }
      float vb = -Q_BIG, nb = Q_BIG;
      int vi = 0, ni = 0;
      for (int r = lane; r < QM; r += QF_G) {
        const float viol_r = a[r] > 0.5f ? -Q_BIG : -W.slack[r];
        if (viol_r > vb) { vb = viol_r; vi = r; }
        const float nz_r = a[r] > 0.5f ? zp[r] : Q_BIG;
        if (nz_r < nb) { nb = nz_r; ni = r; }
      }
      QF_LV(win)[0] = vb;
      QF_LV(win)[1] = (float)vi;
      QF_LV(win)[2] = nb;
      QF_LV(win)[3] = (float)ni;
    }
    // Add the most violated inactive row, else drop the most negative
    // multiplier: the lanes' winners by value, on ties the lowest index.
    float viol_best, negz_best;
    int viol_idx, negz_idx;
    QF_REDUCE_FIRST(viol_best, viol_idx, win, 0, 1, qf_first_max);
    QF_REDUCE_FIRST(negz_best, negz_idx, win, 2, 3, qf_first_min);
    const bool swap = cert < 0.5f;
    const bool do_add = swap && viol_best > feas_tol;
    const bool do_drop = swap && !do_add && (negz_best < -z_tol);
    QF_PHASE(lane) {
      if (do_add && viol_idx % QF_G == lane) W.a[viol_idx] = 1.0f;
      else if (do_drop && negz_idx % QF_G == lane) W.a[negz_idx] = 0.0f;
    }
  }
  QF_PHASE(lane) {
    if (lane == 0) W.cert = cert;
  }
}
