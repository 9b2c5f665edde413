// K3a and K3b: the dense batched QP solve (n = 12, m = 24), one instance per
// thread.
//
// Replaces the TPU kernel bodies of quadruped_control_tpu/solver/
// pallas_ipm.py: _kernel (K3a, the fixed-iteration Mehrotra barrier on the
// dense equilibrated problem) and _polish_kernel (K3b, the certified
// active-set polish). The plain PyTorch versions are
// solver/fused_ipm.py::_dense_barrier_plain and ::_dense_polish_plain: the
// same statements in the same order (no FMA contraction: the library is
// built with -fmad=false), so a kernel and its plain version agree to the
// rounding of the few library operations whose implementations differ.
//
// Problem data (k, B), component-major: Q (144, B) row-major, c (12, B),
// G (288, B) row-major, h (24, B), all equilibrated. Q and G (432 words an
// instance) are read from device memory at each use: a warp's 32 lanes
// touch one 128-byte line per access, and an instance's data stays in L1 /
// L2 for the whole launch. c and h live in per-thread arrays.
//
// NaN. Every max/min goes through qmax/qmin (qct_common.cuh), which
// propagate NaN as torch.maximum / jnp.maximum do; a non-positive Cholesky
// pivot becomes NaN (1.0f / sqrtf of it follows), a skipped step multiplies
// it by 0 and keeps it, and the best-iterate tracking holds the last finite
// point.
#pragma once

#include "qct_common.cuh"

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

// K3b. The EQP KKT of a sweep, K = [[Q, (aG)^T], [aG, -R]] with R = reg a +
// (1 - a), is stored as a packed lower triangle (666 words) that holds, at
// (i, j) with i >= j, the UPPER original K[j][i]: the TPU kernel's loop
// LDL^T reads the originals from the upper copy of its 36 x 36 scratch and
// writes L below it, and qct_common.cuh's ldl_factor reads each packed
// entry once, at its own elimination step, in the same operation order — so
// it serves both kernels. (Q of the dense problem need not be bitwise
// symmetric after equilibration: the upper copy is what counts.)
QCT_DEV_NOINLINE void dense_polish_instance(const QctDenseIO& io, int B,
                                            int inst, float* K, float* D,
                                            float* u) {
  const float* Q = io.Q + inst;
  const float* G = io.G + inst;
  const float reg = 1e-4f;
  float c[QN], h[QM];
  for (int i = 0; i < QN; ++i) c[i] = io.c[(size_t)i * B + inst];
  for (int r = 0; r < QM; ++r) h[r] = io.h[(size_t)r * B + inst];
  float bx[QN], bs[QM], bz[QM], a[QM];
  for (int i = 0; i < QN; ++i) bx[i] = io.x_in[(size_t)i * B + inst];
  for (int r = 0; r < QM; ++r) {
    bs[r] = io.s_in[(size_t)r * B + inst];
    bz[r] = io.z_in[(size_t)r * B + inst];
    a[r] = bz[r] > bs[r] ? 1.0f : 0.0f;
  }
  float obj_scale, h_scale;
  dense_scales(c, h, obj_scale, h_scale);
  float zmax = bz[0];
  for (int r = 1; r < QM; ++r) zmax = qmax(zmax, bz[r]);
  const float tol6 = qmax(1e-6f, 30.0f * Q_EPS);
  const float cert_dr = (30.0f * Q_EPS) * obj_scale;
  const float feas_tol = tol6 * h_scale;
  const float z_tol = tol6 * (1.0f + zmax);

  float cert = 0.0f;
  float xp[QN], zp[QM], slack[QM], r1[QN], r2[QM];
  for (int sw = 0; sw < QD_SWEEPS; ++sw) {
    for (int i = 0; i < QNK; ++i) {
      for (int j = 0; j <= i; ++j) {
        float v;
        if (i < QN) {
          v = Q[(size_t)(j * QN + i) * B];
        } else if (j < QN) {
          const int r = i - QN;
          v = a[r] * G[(size_t)(r * QN + j) * B];
        } else {
          const int r = i - QN;
          v = i == j ? -(reg * a[r] + (1.0f - a[r])) : 0.0f;
        }
        K[tri(i, j)] = v;
      }
    }
    ldl_factor(K, D);
    for (int i = 0; i < QN; ++i) u[i] = -c[i];
    for (int r = 0; r < QM; ++r) u[QN + r] = a[r] * h[r];
    ldl_solve(K, D, u);
    for (int i = 0; i < QN; ++i) xp[i] = u[i];
    for (int r = 0; r < QM; ++r) zp[r] = u[QN + r];

    // Refinement against the reg-free system (plain float32 residuals).
    for (int k = 0; k < QD_REFINE; ++k) {
      for (int i = 0; i < QN; ++i) {
        float v = -c[i];
        for (int j = 0; j < QN; ++j) v = v - Q[(size_t)(i * QN + j) * B] * xp[j];
        for (int r = 0; r < QM; ++r)
          v = v - a[r] * G[(size_t)(r * QN + i) * B] * zp[r];
        r1[i] = v;
      }
      for (int r = 0; r < QM; ++r) {
        float v = a[r] * h[r] - (1.0f - a[r]) * zp[r];
        for (int j = 0; j < QN; ++j)
          v = v - a[r] * G[(size_t)(r * QN + j) * B] * xp[j];
        r2[r] = v;
      }
      for (int i = 0; i < QN; ++i) u[i] = r1[i];
      for (int r = 0; r < QM; ++r) u[QN + r] = r2[r];
      ldl_solve(K, D, u);
      for (int i = 0; i < QN; ++i) xp[i] = xp[i] + u[i];
      for (int r = 0; r < QM; ++r) zp[r] = zp[r] + u[QN + r];
    }

    // Certification: Dekker-compensated stationarity residual.
    float dr_max = 0.0f;
    for (int i = 0; i < QN; ++i) {
      FFAcc f;
      f.init();
      for (int j = 0; j < QN; ++j)
        f.add(-1.0f * Q[(size_t)(i * QN + j) * B], xp[j]);
      for (int r = 0; r < QM; ++r)
        f.add(-(a[r] * G[(size_t)(r * QN + i) * B]), zp[r]);
      f.add(1.0f, -c[i]);
      const float v = fabsf(f.value());
      dr_max = i == 0 ? v : qmax(dr_max, v);
    }
    for (int r = 0; r < QM; ++r) {
      float v = h[r];
      for (int j = 0; j < QN; ++j) v = v - G[(size_t)(r * QN + j) * B] * xp[j];
      slack[r] = v;
    }
    float slack_min = slack[0];
    float z_signed = zp[0] * a[0];
    for (int r = 1; r < QM; ++r) {
      slack_min = qmin(slack_min, slack[r]);
      z_signed = qmin(z_signed, zp[r] * a[r]);
    }
    bool finite = true;
    for (int i = 0; i < QN; ++i) finite = finite && qfinite(xp[i]);
    for (int r = 0; r < QM; ++r) finite = finite && qfinite(zp[r]);
    const bool ok = finite && (slack_min > -feas_tol) && (z_signed > -z_tol)
                    && (dr_max < cert_dr);

    if (ok && cert < 0.5f) {
      for (int i = 0; i < QN; ++i) bx[i] = xp[i];
      for (int r = 0; r < QM; ++r) {
        bz[r] = qmax(a[r] * zp[r], 0.0f);
        bs[r] = qmax(slack[r], 0.0f);
      }
    }
    // The first certified sweep is latched and the active set frozen: the
    // remaining sweeps could change nothing, so the thread leaves the loop.
    if (ok) cert = 1.0f;
    if (cert > 0.5f) break;

    // Add the most violated inactive row, else drop the most negative
    // multiplier; strict comparisons keep the lowest index on ties.
    float viol_best = -Q_BIG, negz_best = Q_BIG;
    int viol_idx = 0, negz_idx = 0;
    for (int r = 0; r < QM; ++r) {
      const float viol_r = a[r] > 0.5f ? -Q_BIG : -slack[r];
      if (viol_r > viol_best) { viol_best = viol_r; viol_idx = r; }
      const float nz_r = a[r] > 0.5f ? zp[r] : Q_BIG;
      if (nz_r < negz_best) { negz_best = nz_r; negz_idx = r; }
    }
    const bool do_add = viol_best > feas_tol;
    const bool do_drop = !do_add && (negz_best < -z_tol);
    if (do_add) a[viol_idx] = 1.0f;
    else if (do_drop) a[negz_idx] = 0.0f;
  }
  for (int i = 0; i < QN; ++i) io.x[(size_t)i * B + inst] = bx[i];
  for (int r = 0; r < QM; ++r) {
    io.s[(size_t)r * B + inst] = bs[r];
    io.z[(size_t)r * B + inst] = bz[r];
  }
  io.cert[inst] = cert;
}
