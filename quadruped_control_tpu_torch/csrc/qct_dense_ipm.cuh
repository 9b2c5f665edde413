// K3a and K3b: the dense batched QP solve (n = 12, m = 24), each one QP per
// group of 16 lanes (qct_lanes.cuh), its state in shared memory.
//
// Replaces the TPU kernel bodies of quadruped_control_tpu/solver/
// pallas_ipm.py: _kernel (K3a, the fixed-iteration Mehrotra barrier on the
// dense equilibrated problem) and _polish_kernel (K3b, the certified
// active-set polish). The plain PyTorch versions are
// solver/fused_ipm.py::_dense_barrier_plain and ::_dense_polish_plain: the
// same statements in the same order (no FMA contraction: the library is
// built with -fmad=false), so each kernel is bitwise its plain version (K3a
// once the plain version's reciprocal square root is correctly rounded, as
// the card's 1.0f / sqrtf is).
//
// Problem data (k, B), component-major: Q (144, B) row-major, c (12, B),
// G (288, B) row-major, h (24, B), all equilibrated. A block stages its QPs'
// problems (and K3b's points) into shared memory first (qd_stage_in) and
// writes the outputs from there (qd_stage_out): QDBShared for K3a,
// QDShared for K3b. K3a's one-instance-per-thread body,
// dense_barrier_instance, stays as the serial reference of the host builds
// (tests/torch_port_host_shim.cpp); no kernel launches it.
//
// NaN. Every max/min goes through qmax/qmin (qct_common.cuh), which
// propagate NaN as torch.maximum / jnp.maximum do; a non-positive Cholesky
// pivot becomes NaN (1.0f / sqrtf of it follows), a skipped step multiplies
// it by 0 and keeps it, and the best-iterate tracking holds the last finite
// point. A poisoned QP stays poisoned in its own group of lanes.
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

// K3a's serial body: one instance in one thread, the operation order that
// dense_barrier_lanes keeps element for element. The host builds' reference
// (tests/torch_port_host_shim.cpp host_dense_barrier); no kernel runs it.
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

// Thread t of nt stages the first n_in input words (K3a: Q, G, c, h; K3b:
// those and x, s, z) of nq QP slots from slot0 into W[0 .. nq) (a slot past
// B takes QP B - 1; nt a multiple of nq). Threads t and t + 1 read element
// k of neighbouring QPs, so a load of the block's nq QPs reads nq
// consecutive words of the (k, B) layout. S: QDBShared or QDShared, whose
// inputs lie in launch order from Q on.
template <class S = QDShared, int n_in = QD_IN>
QCT_DEV void qd_stage_in(const QctDenseIO& io, int B, int slot0, int nq,
                         S* W, int t, int nt) {
  const int q = t % nq, dk = nt / nq;
  const int i = slot0 + q < B ? slot0 + q : B - 1;
  float* w = reinterpret_cast<float*>(W + q);
  for (int k = t / nq; k < n_in; k += dk) {
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

// Thread t of nt writes the first n_out outputs (x, s, z, then K3b's cert)
// of the slots below B, from S::bx on.
template <class S = QDShared, int n_out = QD_OUT>
QCT_DEV void qd_stage_out(const QctDenseIO& io, int B, int slot0, int nq,
                          const S* W, int t, int nt) {
  const int q = t % nq, dk = nt / nq, i = slot0 + q;
  if (i >= B) return;
  const float* w = W[q].bx;
  for (int k = t / nq; k < n_out; k += dk) {
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

// ---------------------------------------------------------------------------
// K3a: one QP on a group of QF_G = 16 lanes (qct_lanes.cuh), its problem,
// iterate and factor in shared memory.
// ---------------------------------------------------------------------------

// K3a's __launch_bounds__: a block is four warps (8 QPs), 4 blocks an SM at
// <= 128 registers. Other sizes build with -D of both
// (scripts/torch_dense_barrier_blocks.py times blocks of 1, 2 and 4 warps:
// the QPs of a block finish together, and 4 warps were fastest).
#ifndef QDB_MAX_THREADS
#define QDB_MAX_THREADS 128
#define QDB_MIN_BLOCKS 4
#endif
#define QDB_IN 468  // words a QP reads: Q 144, G 288, c 12, h 24
#define QDB_OUT 60  // words a QP writes: x, s, z

// One QP's state. Q, G and L by rows of 13 words (as QDShared: a lane per
// row and a lane per column both hit 16 different banks, and so do the two
// QPs of a warp, the state being 16 words mod 32). c | h | bx | bs | bz lie
// in the order of the launch's inputs after G and of its outputs.
struct QDBShared {
  float Q[QN * QD_LD];  // Q[i][j] at i * 13 + j
  float G[QM * QD_LD];  // G[r][j] at r * 13 + j
  float c[QN], h[QM];
  float bx[QN], bs[QM], bz[QM];  // the best iterate: the outputs
  float x[QN], s[QM], z[QM];     // the iterate
  float M[QNU];          // Q + G^T D G (no shift), packed upper (iu)
  float L[QN * QD_LD];   // Cholesky factor by rows, diagonal 1 / L_ii
  float r_prim[QM], r_dual[QN], d[QM];
  float rc[QM], t[QM];   // centering target, (z r_prim - rc) / s
  float ds_a[QM], dz_a[QM], ds[QM], dz[QM];
  float pad[10];
};
static_assert(sizeof(QDBShared) / sizeof(float) % 32 == 16,
              "a QP's state is 16 words mod 32 (banks)");
static_assert(offsetof(QDBShared, G) == QN * QD_LD * sizeof(float) &&
                  offsetof(QDBShared, c) == (QN + QM) * QD_LD * sizeof(float) &&
                  offsetof(QDBShared, bx) ==
                      offsetof(QDBShared, c) + (QN + QM) * sizeof(float) &&
                  offsetof(QDBShared, x) ==
                      offsetof(QDBShared, bx) + QDB_OUT * sizeof(float),
              "inputs and outputs lie in launch order");

// What K3a's launch geometry is made from (kernels.fused_launch_geometry on
// kernels.dense_barrier_layout): lanes per QP, threads a block at most,
// shared words per QP.
static inline void qdb_layout(int* out) {
  out[0] = QF_G;
  out[1] = QDB_MAX_THREADS;
  out[2] = (int)(sizeof(QDBShared) / sizeof(float));
}

// The row i of the packed upper triangle's entry e (iu(i, j) = e, j >= i).
QCT_DEV int qdb_row(int e) {
  int i = 0;
#pragma unroll
  for (int k = 1; k < QN; ++k) i += e >= iu(k, k) ? 1 : 0;
  return i;
}

// The two sweeps of chol_solve of the serial body. QDB_FORWARD: y = L^-1
// rhs (uniform on return) for the right-hand side held by lane i < 12 in
// QF_LV(a)[0], by lanes: lane k's y_k goes to every lane by shuffle at step
// k and lanes i > k subtract L_ik y_k (row i's terms in k order). A macro,
// not a function: a lane variable is an array over the lanes in the host
// build. qdb_backward: u = L^-T y, uniform, row i's terms in k = i + 1 ...
// order (u_11 is known first, so by lanes it would change the order).
#define QDB_FORWARD(a, L, y)                                              \
  do {                                                                    \
    _Pragma("unroll") for (int k_ = 0; k_ < QN; ++k_) {                   \
      const float lkk_ = (L)[k_ * QD_LD + k_];                            \
      QF_LANES(lane) {                                                    \
        const float yk_ = QF_SHFL_LV(a, 0, k_) * lkk_;                    \
        const int li_ = lane < QN ? lane : QN - 1;                        \
        const float lik_ = (L)[li_ * QD_LD + k_];                         \
        if (lane > k_ && lane < QN)                                       \
          QF_LV(a)[0] = QF_LV(a)[0] - lik_ * yk_;                         \
        (y)[k_] = yk_;                                                    \
      }                                                                   \
    }                                                                     \
  } while (0)

QCT_DEV void qdb_backward(const float* L, const float* y, float* u) {
#pragma unroll
  for (int i = QN - 1; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < QN; ++k) v = v - L[k * QD_LD + i] * u[k];
    u[i] = v * L[i * QD_LD + i];
  }
}

// dx of the Newton direction whose t = (z r_prim - rc) / s is in W.t
// (uniform on return; kkt_solve of the serial body): lane i < 12 forms
// rhs_i = -r_dual_i - sum_r G_ri t_r (r in order), the factor solves
// M dx = rhs, lane i forms row i of the residual against the unshifted M
// (its diagonal entry as the serial body forms it from the shifted one:
// (M_ii + delta) - delta), and the second solve's correction is added.
QCT_DEV void qdb_newton_dx(const QDBShared& W, float delta, float* dx,
                           const QFLane& g) {
  QF_LANE_VAR(float, a, 1);    // the solve's right-hand side
  QF_LANE_VAR(float, rhs, 1);  // rhs_i, kept for the residual
  QF_LANES(lane) {
    float v = 0.0f;
    if (lane < QN) {
      const int i = lane;
      v = -W.r_dual[i];
#pragma unroll
      for (int r = 0; r < QM; ++r) v = v - W.G[r * QD_LD + i] * W.t[r];
    }
    QF_LV(rhs)[0] = v;
    QF_LV(a)[0] = v;
  }
  QCT_CLOCK(__LINE__);  // right-hand side
  float u[QN];
  for (int pass = 0; pass < 2; ++pass) {
    float y[QN], w[QN];
    QDB_FORWARD(a, W.L, y);
    QCT_CLOCK(__LINE__);  // forward solve
    qdb_backward(W.L, y, w);
    QCT_CLOCK(__LINE__);  // backward solve
    if (pass == 1) {
#pragma unroll
      for (int i = 0; i < QN; ++i) dx[i] = u[i] + w[i];
      break;
    }
#pragma unroll
    for (int i = 0; i < QN; ++i) u[i] = w[i];
    QF_LANES(lane) {
      float v = 0.0f;
      if (lane < QN) {
        const int i = lane;
        v = QF_LV(rhs)[0];
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          const int e = j <= i ? iu(j, i) : iu(i, j);
          float mij = W.M[e];
          if (j == i) mij = (mij + delta) - delta;
          v = v - mij * u[j];
        }
      }
      QF_LV(a)[0] = v;
    }
    QCT_CLOCK(__LINE__);  // refinement residual
  }
}

// ds, dz of the direction dx on the lane's cone rows r = lane + 16 m (the
// serial body's order: (G dx)_r over j in order, ds = -r_prim - G dx, dz =
// -(rc + z ds) / s) into ds / dz, and the lane's partial step ratios (min
// over its rows of -s/ds, -z/dz where negative; Q_BIG else) and finiteness.
QCT_DEV void qdb_direction_rows(QDBShared& W, const float* dx, int lane,
                                float* ds, float* dz, float& rs, float& rz,
                                bool& fin) {
  rs = Q_BIG;
  rz = Q_BIG;
  fin = true;
  for (int r = lane; r < QM; r += QF_G) {
    const float* Gr = W.G + r * QD_LD;
    float gdx = Gr[0] * dx[0];
#pragma unroll
    for (int j = 1; j < QN; ++j) gdx = gdx + Gr[j] * dx[j];
    const float s = W.s[r], z = W.z[r];
    const float dsr = -W.r_prim[r] - gdx;
    const float dzr = qf_div(-(W.rc[r] + z * dsr), s);
    ds[r] = dsr;
    dz[r] = dzr;
    const float ra = qf_div(-s, dsr), rb = qf_div(-z, dzr);
    rs = qmin(rs, dsr < 0.0f ? ra : Q_BIG);
    rz = qmin(rz, dzr < 0.0f ? rb : Q_BIG);
    fin = fin && qfinite(dsr) && qfinite(dzr);
  }
}

// The dense Mehrotra loop of one QP (body of the TPU _kernel; the serial
// body's dense_barrier_instance, element for element) on its staged state
// W: the best iterate in bx, bs, bz on return. Per iteration, sections in
// the serial body's order: the lanes' cone rows r = lane + 16 m (r_prim
// over j in order, d, the affine rc and t) and lane i < 12's r_dual_i (c,
// then Q's row, then G's column); M = Q + G^T D G by entries, five
// consecutive ones of the packed upper triangle a lane (each entry's 24
// terms in r order); the diagonal's maximum and the shift (uniform, row
// order); the Cholesky, right-looking on the rows in the lanes' registers
// (as K1's qf_barrier); mu (uniform); the affine direction, then the
// corrector (qdb_newton_dx; mu_aff uniform between them); the merit and the
// step by rows. The step ratios and flags reduce by QF_REDUCE. No QP leaves
// early: a frozen QP (done) takes a zero step, so the two QPs of a warp
// meet at every sync.
QCT_DEV void dense_barrier_lanes(QDBShared& W, int iterations, float tau,
                                 const QFLane& g) {
  const float d_max = 1.0f / Q_EPS;
  QF_PHASE(lane) {
    for (int i = lane; i < QN; i += QF_G) {
      W.x[i] = 0.0f;
      W.bx[i] = 0.0f;
    }
    for (int r = lane; r < QM; r += QF_G) {
      const float s = qmax(W.h[r], 1.0f);
      const float z = qf_div(1.0f, s);
      W.s[r] = s;
      W.z[r] = z;
      W.bs[r] = s;
      W.bz[r] = z;
    }
  }
  float obj_scale, h_scale;
  dense_scales(W.c, W.h, obj_scale, h_scale);
  const float freeze_gap = (100.0f * Q_EPS) * obj_scale;
  const float freeze_pr = (50.0f * Q_EPS) * h_scale;
  const float freeze_dr = (50.0f * Q_EPS) * obj_scale;
  float bmerit = INFINITY;
  QCT_CLOCK(0);

  for (int it = 0; it < iterations; ++it) {
    // Residuals, d, the affine rc and t; lane i < 12: r_dual_i. The lane's
    // partials of max |r_prim| and of x's finiteness.
    QF_LANE_VAR(float, part, 2);
    QF_PHASE(lane) {
      float pm = 0.0f;
      for (int r = lane; r < QM; r += QF_G) {
        const float* Gr = W.G + r * QD_LD;
        float gx = Gr[0] * W.x[0];
#pragma unroll
        for (int j = 1; j < QN; ++j) gx = gx + Gr[j] * W.x[j];
        const float s = W.s[r], z = W.z[r];
        const float rp = gx + s - W.h[r];
        const float rc = s * z;
        W.r_prim[r] = rp;
        W.d[r] = qmin(qf_div(z, s), d_max);
        W.rc[r] = rc;
        W.t[r] = qf_div(z * rp - rc, s);
        pm = qmax(pm, fabsf(rp));
      }
      bool fin_x = true;
      if (lane < QN) {
        const int i = lane;
        float v = W.c[i];
#pragma unroll
        for (int j = 0; j < QN; ++j) v = v + W.Q[i * QD_LD + j] * W.x[j];
#pragma unroll
        for (int r = 0; r < QM; ++r) v = v + W.G[r * QD_LD + i] * W.z[r];
        W.r_dual[i] = v;
        fin_x = qfinite(W.x[i]);
      }
      QF_LV(part)[0] = pm;
      QF_LV(part)[1] = fin_x ? 1.0f : 0.0f;
    }
    QCT_CLOCK(__LINE__);  // residuals, d, rc, t
    // M = Q + G^T D G, upper triangle: lane l its entries e = 5 l ... 5 l +
    // 4 of the packed order (rows i0 = row of 5 l and i1 = row of its last
    // entry: at most two), each entry's terms in r order, G_ri d_r formed
    // once a row r for each of the two rows.
    QF_PHASE(lane) {
      const int e0 = 5 * lane, e4 = e0 + 4 < QNU ? e0 + 4 : QNU - 1;
      const int i0 = qdb_row(e0), i1 = qdb_row(e4);
      int jm[5];
      bool in0[5];
      float v[5];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        const int e = e0 + m < QNU ? e0 + m : QNU - 1;
        const int i = qdb_row(e);
        in0[m] = i == i0;
        jm[m] = i + e - iu(i, i);
        v[m] = W.Q[i * QD_LD + jm[m]];
      }
#pragma unroll
      for (int r = 0; r < QM; ++r) {
        const float* Gr = W.G + r * QD_LD;
        const float dr = W.d[r];
        const float g0 = Gr[i0] * dr, g1 = Gr[i1] * dr;
#pragma unroll
        for (int m = 0; m < 5; ++m) v[m] = v[m] + (in0[m] ? g0 : g1) * Gr[jm[m]];
      }
#pragma unroll
      for (int m = 0; m < 5; ++m)
        if (e0 + m < QNU) W.M[e0 + m] = v[m];
    }
    QCT_CLOCK(__LINE__);  // M = Q + G^T D G
    // The diagonal's maximum in row order and the shift; lane i's row of M +
    // delta I (entries j <= i) into its registers. W.M keeps M without the
    // shift (the refinement forms (M_ii + delta) - delta).
    float diag_max = W.M[iu(0, 0)];
#pragma unroll
    for (int i = 1; i < QN; ++i) diag_max = qmax(diag_max, W.M[iu(i, i)]);
    const float delta = (100.0f * Q_EPS) * diag_max;
    QF_LANE_VAR(float, Lr, QN);
    QF_LANES(lane) {
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        float m = 0.0f;
        if (lane < QN && j <= lane) m = W.M[iu(j, lane)];
        if (j == lane) m = m + delta;
        QF_LV(Lr)[j] = m;
      }
    }
    // Cholesky, right-looking on the rows in the lanes' registers: at pivot
    // k every lane takes column k from the lanes below by shuffle (entries
    // (j, k), final after pivot k - 1) and scales it by 1/L_kk as lane j
    // scales its own; lane i > k stores L[i][k] and subtracts L[i][k] L[j][k]
    // from its entries j in (k, i]: each entry's terms in k order, as the
    // serial body's left-looking loop. The next pivot, lane k + 1's diagonal
    // after this update (its entry before it, less L[k+1][k]^2, the same
    // operations as lane k + 1's), every lane forms itself, so that no
    // shuffle lies on the chain from pivot to pivot. The shuffles need no
    // sync; L is whole after the last pivot.
    float ddk = QF_SHFL_LV(Lr, 0, 0);
#pragma unroll
    for (int k = 0; k < QN; ++k) {
      float col[QN];
#pragma unroll
      for (int j = k + 1; j < QN; ++j) col[j] = QF_SHFL_LV(Lr, k, j);
      const float pre = k + 1 < QN ? QF_SHFL_LV(Lr, k + 1, k + 1) : 0.0f;
      const float dd = ddk > 0.0f ? ddk : qnan();
      const float inv = qf_div(1.0f, sqrtf(dd));
#pragma unroll
      for (int j = k + 1; j < QN; ++j) col[j] = col[j] * inv;
      QF_LANES(lane) {
        const bool act = lane > k && lane < QN;
        const float lik = QF_LV(Lr)[k] * inv;
#pragma unroll
        for (int j = k + 1; j < QN; ++j) {
          const float nv = QF_LV(Lr)[j] - lik * col[j];
          if (act && j <= lane) QF_LV(Lr)[j] = nv;
        }
        if (act) W.L[lane * QD_LD + k] = lik;
        if (lane == k) W.L[k * QD_LD + k] = inv;
      }
      if (k + 1 < QN) ddk = pre - col[k + 1] * col[k + 1];
    }
    QF_SYNC();
    QCT_CLOCK(__LINE__);  // shift, Cholesky

    // mu, its terms in row order (the affine rc_r is s_r z_r).
    float mu = W.rc[0];
#pragma unroll
    for (int r = 1; r < QM; ++r) mu = mu + W.rc[r];
    mu = mu * (1.0f / QM);

    // The affine direction (dir 0: rc = s z, set above), then the corrector
    // (dir 1: rc = s z + ds_a dz_a - sigma mu).
    float dx[QN];
    float ratio_s = Q_BIG, ratio_z = Q_BIG, finite_f = 1.0f;
    for (int dir = 0; dir < 2; ++dir) {
      if (dir == 1) {
        const float a_aff =
            qmin(qmin(1.0f * ratio_s, 1.0f), qmin(1.0f * ratio_z, 1.0f));
        float mu_aff =
            (W.s[0] + a_aff * W.ds_a[0]) * (W.z[0] + a_aff * W.dz_a[0]);
#pragma unroll
        for (int r = 1; r < QM; ++r)
          mu_aff = mu_aff +
                   (W.s[r] + a_aff * W.ds_a[r]) * (W.z[r] + a_aff * W.dz_a[r]);
        mu_aff = mu_aff * (1.0f / QM);
        const float ratio = mu_aff / qmax(mu, 1e-30f);
        const float sigma_mu = ratio * ratio * ratio * mu;
        QF_PHASE(lane) {
          for (int r = lane; r < QM; r += QF_G) {
            const float s = W.s[r], z = W.z[r];
            const float rc = s * z + W.ds_a[r] * W.dz_a[r] - sigma_mu;
            W.rc[r] = rc;
            W.t[r] = qf_div(z * W.r_prim[r] - rc, s);
          }
        }
      }
      QCT_CLOCK(__LINE__);  // mu; mu_aff, corrector rc, t
      qdb_newton_dx(W, delta, dx, g);
      QF_LANE_VAR(float, rt, 3);
      QF_PHASE(lane) {
        float rs, rz;
        bool fin;
        qdb_direction_rows(W, dx, lane, dir == 0 ? W.ds_a : W.ds,
                           dir == 0 ? W.dz_a : W.dz, rs, rz, fin);
        QF_LV(rt)[0] = rs;
        QF_LV(rt)[1] = rz;
        QF_LV(rt)[2] = fin ? 1.0f : 0.0f;
      }
      QF_REDUCE(ratio_s, rt, 0, qmin);
      QF_REDUCE(ratio_z, rt, 1, qmin);
      if (dir == 1) QF_REDUCE(finite_f, rt, 2, qmin);
      QCT_CLOCK(__LINE__);  // a direction's rows, ratios
    }
    const float alpha =
        qmin(qmin(tau * ratio_s, 1.0f), qmin(tau * ratio_z, 1.0f));
    float pr_max, fx;
    QF_REDUCE(pr_max, part, 0, qmax);
    QF_REDUCE(fx, part, 1, qmin);
    float dr_max = fabsf(W.r_dual[0]);
#pragma unroll
    for (int i = 1; i < QN; ++i) dr_max = qmax(dr_max, fabsf(W.r_dual[i]));
    const bool done =
        (mu < freeze_gap) && (pr_max < freeze_pr) && (dr_max < freeze_dr);

    // Best iterate by scaled KKT merit (a NaN merit never wins).
    const float merit = pr_max / h_scale + dr_max / obj_scale + mu / obj_scale;
    const bool take = (merit < bmerit) && fx == 1.0f;
    if (take) bmerit = merit;
    bool finite = finite_f == 1.0f;
#pragma unroll
    for (int i = 0; i < QN; ++i) finite = finite && qfinite(dx[i]);
    // a == 0 with a non-finite direction gives 0 * NaN = NaN on purpose.
    const float a = (done || !finite) ? 0.0f : alpha;
    QF_PHASE(lane) {
      if (lane < QN) {
        const int i = lane;
        if (take) W.bx[i] = W.x[i];
        W.x[i] = W.x[i] + a * qf_pick<QN>(dx, i);
      }
      for (int r = lane; r < QM; r += QF_G) {
        if (take) {
          W.bs[r] = W.s[r];
          W.bz[r] = W.z[r];
        }
        W.s[r] = qmax(W.s[r] + a * W.ds[r], Q_TINY);
        W.z[r] = qmax(W.z[r] + a * W.dz[r], Q_TINY);
      }
    }
    QCT_CLOCK(__LINE__);  // merit, best iterate, step
  }
}
